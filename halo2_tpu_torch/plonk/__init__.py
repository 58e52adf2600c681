"""PLONK proving system package.

Lazy exports (PEP 562) to break the import cycle between the circuit-API
package (halo2_tpu_torch.circuit) and the proving-system modules that
consume it."""

from .circuit import (Column, Selector, TableColumn, Expression, Constant,
                      SelectorExpr, FixedQuery, AdviceQuery, InstanceQuery,
                      Negated, Sum, Product, Scaled, Gate, LookupArgument,
                      PermutationArgument, ConstraintSystem, VirtualCells,
                      ADVICE, FIXED, INSTANCE)
from .assigned import Assigned, batch_evaluate_assigned

_LAZY = {
    "VerifyingKey": "keys", "ProvingKey": "keys",
    "keygen_vk": "keygen", "keygen_pk": "keygen",
    "NotEnoughRowsAvailable": "keygen",
    "create_proof": "prover",
    "verify_proof": "verifier", "SingleVerifier": "verifier",
    "AccumulatorStrategy": "verifier", "BatchVerifier": "verifier",
    "VerificationError": "verifier",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
