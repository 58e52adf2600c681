"""The Pasta fields: host arithmetic and device tensors.

Lazy exports (PEP 562) of the device names, as the reference's package
exports them (halo2_tpu/fields/__init__.py), but `feq`, `fselect` and
`limbs_to_int`: the port does their work with torch.eq, torch.where and
fields/device.py's digits_to_ints."""
from .host import FP, FQ, FieldSpec, batch_invert

_LAZY = dict.fromkeys((
    "DeviceField", "FP_DEV", "FQ_DEV", "NLIMBS", "LIMB_BITS", "fadd", "fsub",
    "fmul", "fsquare", "fneg", "fpow", "finv", "batch_inv", "is_zero",
    "to_mont", "from_mont", "int_to_limbs"), "device")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)
