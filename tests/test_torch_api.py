"""The port's package API against the JAX package's: every name that
halo2_tpu.{poly,fields,curves,parallel} export imports from the port's
package of the same name, but the few with no counterpart in the port,
listed here (and in ROADMAP.md, C) with the reason."""
import importlib
import types

import pytest

# reference name -> why the port has no counterpart
NO_COUNTERPART = {
    "poly": {"tree_add": "no caller in either package"},
    "fields": {"feq": "torch.eq over the digits",
               "fselect": "torch.where",
               "limbs_to_int": "fields/device.py's digits_to_ints, batched"},
    "curves": {"JPoint": "the port's batches are [48, L] projective tensors",
               "DeviceCurve": "the base field's DeviceField stands in",
               "PALLAS_DEV": "FP_DEV", "VESTA_DEV": "FQ_DEV"},
    "parallel": {},
}


def _exports(module):
    return sorted(name for name, v in vars(module).items()
                  if not name.startswith("_")
                  and not isinstance(v, types.ModuleType))


@pytest.mark.parametrize("package", sorted(NO_COUNTERPART))
def test_package_exports_match_reference(package):
    ref = importlib.import_module(f"halo2_tpu.{package}")
    port = importlib.import_module(f"halo2_tpu_torch.{package}")
    names = _exports(ref)
    missing = NO_COUNTERPART[package]
    assert set(missing) <= set(names)
    for name in names:
        if name in missing:
            assert not hasattr(port, name), name
            continue
        obj = getattr(port, name)
        assert not isinstance(obj, types.ModuleType), name
        if callable(obj):
            assert obj.__module__.startswith("halo2_tpu_torch."), name


def test_params_imports_from_the_poly_package():
    from halo2_tpu_torch.poly import Params, EvaluationDomain
    from halo2_tpu_torch.poly.commitment import Params as P
    from halo2_tpu_torch.poly.domain import EvaluationDomain as D
    assert Params is P and EvaluationDomain is D
