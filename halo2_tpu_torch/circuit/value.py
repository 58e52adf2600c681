"""Value<V>: the Option-like witness monad.

Reference: halo2_proofs/src/circuit/value.rs:16-668. A `Value` either holds
a witness (prover side) or is unknown (verifier/keygen side); arithmetic
lifts over unknowns so the same circuit code runs in both modes. Interops
with `Assigned` rationals for deferred division.

Copied unchanged from halo2_tpu/circuit/value.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ..fields.host import FieldSpec
from ..plonk.assigned import Assigned


class Value:
    __slots__ = ("_inner",)

    def __init__(self, inner: Optional[Any]):
        self._inner = inner

    @staticmethod
    def unknown() -> "Value":
        return Value(None)

    @staticmethod
    def known(v) -> "Value":
        assert v is not None
        return Value(v)

    def is_known(self) -> bool:
        return self._inner is not None

    def assign(self):
        """-> inner value or raise (Synthesis error semantics)."""
        if self._inner is None:
            raise SynthesisError("Value::unknown() assigned")
        return self._inner

    def inner(self):
        return self._inner

    def map(self, f: Callable) -> "Value":
        return Value(None if self._inner is None else f(self._inner))

    def and_then(self, f: Callable) -> "Value":
        if self._inner is None:
            return Value(None)
        out = f(self._inner)
        return out if isinstance(out, Value) else Value(out)

    def zip(self, other: "Value") -> "Value":
        if self._inner is None or other._inner is None:
            return Value(None)
        return Value((self._inner, other._inner))

    def error_if_known_and(self, pred: Callable) -> None:
        if self._inner is not None and pred(self._inner):
            raise SynthesisError("Value failed check")

    # arithmetic lifting over a field (used with int payloads)
    def add(self, other: "Value", f: FieldSpec) -> "Value":
        return self.zip(other).map(lambda ab: f.add(ab[0], ab[1]))

    def sub(self, other: "Value", f: FieldSpec) -> "Value":
        return self.zip(other).map(lambda ab: f.sub(ab[0], ab[1]))

    def mul(self, other: "Value", f: FieldSpec) -> "Value":
        return self.zip(other).map(lambda ab: f.mul(ab[0], ab[1]))

    def neg(self, f: FieldSpec) -> "Value":
        return self.map(lambda a: f.neg(a))

    def invert(self, f: FieldSpec) -> "Value":
        """Deferred inversion via Assigned."""
        return self.map(lambda a: (a.invert() if isinstance(a, Assigned)
                                   else Assigned(1, a)))

    def to_assigned(self) -> "Value":
        return self.map(lambda a: a if isinstance(a, Assigned)
                        else Assigned.trivial(a))

    def evaluate(self, f: FieldSpec) -> "Value":
        return self.map(lambda a: (a.evaluate(f) if isinstance(a, Assigned)
                                   else a))

    def __repr__(self):
        return (f"Value.known({self._inner!r})" if self._inner is not None
                else "Value.unknown()")


class SynthesisError(Exception):
    """plonk/error.rs::Error::Synthesis."""
