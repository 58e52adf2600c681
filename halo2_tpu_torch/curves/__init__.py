"""The Pasta curves: host points and device point batches.

Lazy exports (PEP 562) of the point-batch API, as the reference's package
exports it (halo2_tpu/curves/__init__.py), but its Jacobian `JPoint` and
`DeviceCurve` with `PALLAS_DEV`, `VESTA_DEV`: the port's batches are
[48, L] projective tensors over a DeviceField (curves/device.py)."""
from .host import CurveSpec, PALLAS, VESTA, Point

_LAZY = dict.fromkeys(("padd", "pdouble", "pneg", "pselect",
                       "batch_scalar_mul", "normalize", "tree_sum"),
                      "device")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)
