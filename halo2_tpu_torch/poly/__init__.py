"""Polynomials, domains, the IPA commitment and the multiopen argument.

Lazy exports (PEP 562): the reference's package names (halo2_tpu/poly/
__init__.py) but `tree_add`, which has no caller in either package,
without importing the device modules until a name is asked for."""
from .polynomial import Rotation, rotate

_LAZY = {
    "EvaluationDomain": "domain",
    **dict.fromkeys(("powers", "eval_poly", "inner_product", "kate_division",
                     "distribute_powers"), "utils"),
    **dict.fromkeys(("Params", "MSMAccumulator", "DEFAULT_BLIND",
                     "ipa_create_proof", "ipa_verify_proof", "Guard",
                     "Accumulator", "compute_b", "compute_s"), "commitment"),
    **dict.fromkeys(("ProverQuery", "VerifierQuery", "multiopen_create_proof",
                     "multiopen_verify_proof", "lagrange_interpolate"),
                    "multiopen"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)
