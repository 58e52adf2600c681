"""Key generation: keygen_vk / keygen_pk.

Port of halo2_tpu/plonk/keygen.py (halo2_proofs/src/plonk/keygen.rs:
create_domain :25-44, the Assembly sink :46-186, keygen_vk :189-244,
keygen_pk :247-337). The fixed and sigma commitments and every transform
run on the Params device (no native shortcut); the group elements are
the same either way.
"""
from __future__ import annotations

from ..poly.domain import EvaluationDomain
from ..poly.commitment import Params, DEFAULT_BLIND
from ..circuit.value import Value, SynthesisError
from ..circuit.layouter import Circuit
from .circuit import ConstraintSystem, Column, Selector
from .assigned import Assigned, batch_evaluate_assigned
from .compress_selectors import compress_selectors
from .permutation import PermutationAssembly, build_vk, build_pk
from .keys import VerifyingKey, ProvingKey

from .error import NotEnoughRowsAvailable  # noqa: F401 (re-export)


def create_domain(params: Params, circuit_cls):
    cs = ConstraintSystem()
    config = circuit_cls.configure(cs)
    domain = EvaluationDomain(params.scalar_df, cs.degree(), params.k,
                              params.device)
    return cs, domain, config


class Assembly:
    """keygen Assignment sink (keygen.rs:46-186)."""

    def __init__(self, cs: ConstraintSystem, params: Params, fs):
        self.fs = fs
        n = params.n
        self.k = params.k
        self.fixed: list[list[Assigned]] = [
            [Assigned.zero()] * n for _ in range(cs.num_fixed_columns)]
        self.permutation = PermutationAssembly(n, cs.permutation)
        self.selectors: list[list[bool]] = [
            [False] * n for _ in range(cs.num_selectors)]
        self.usable_rows = n - (cs.blinding_factors() + 1)

    # ---- Assignment interface ----
    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def enable_selector(self, annotation, selector: Selector, row: int):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self.selectors[selector.index][row] = True

    def query_instance(self, column, row: int) -> Value:
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        return Value.unknown()

    def assign_advice(self, annotation, column, row, to):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        # advice is ignored during keygen (but the closure may raise)

    def assign_fixed(self, annotation, column: Column, row: int, to):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        v = to()
        v = v if isinstance(v, Value) else Value.known(v)
        if v.is_known():
            inner = v.inner()
            self.fixed[column.index][row] = (
                inner if isinstance(inner, Assigned)
                else Assigned.trivial(inner % self.fs.modulus))

    def copy(self, left_column, left_row, right_column, right_row):
        if left_row >= self.usable_rows or right_row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self.permutation.copy(left_column, left_row, right_column, right_row)

    def fill_from_row(self, column: Column, from_row: int, value: Value):
        if from_row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        inner = value.inner() if isinstance(value, Value) else value
        if inner is None:
            raise SynthesisError("table default value unknown")
        filler = (inner if isinstance(inner, Assigned)
                  else Assigned.trivial(inner % self.fs.modulus))
        col = self.fixed[column.index]
        for row in range(from_row, self.usable_rows):
            col[row] = filler

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass

    # ---- batch synthesis extension (Layouter.assign_regions) ----
    def assign_advice_batch(self, annotation, column, rows, values):
        if rows and max(rows) >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        # advice is ignored during keygen

    def assign_fixed_batch(self, annotation, column: Column,
                           rows: list[int], values: list) -> None:
        if rows and max(rows) >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        col = self.fixed[column.index]
        p = self.fs.modulus
        for r, v in zip(rows, values):
            if isinstance(v, Value):
                if not v.is_known():
                    continue
                v = v.inner()
            col[r] = (v if isinstance(v, Assigned)
                      else Assigned.trivial(v % p))

    def enable_selector_batch(self, annotation, selector: Selector,
                              rows: list[int]) -> None:
        if rows and max(rows) >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        col = self.selectors[selector.index]
        for r in rows:
            col[r] = True

    def copy_batch(self, col_a, rows_a, col_b, rows_b) -> None:
        if ((rows_a and max(rows_a) >= self.usable_rows)
                or (rows_b and max(rows_b) >= self.usable_rows)):
            raise NotEnoughRowsAvailable(self.k)
        for ra, rb in zip(rows_a, rows_b):
            self.permutation.copy(col_a, ra, col_b, rb)


def _synthesize(circuit: Circuit, config, assembly, constants):
    from ..circuit import synthesize_circuit
    synthesize_circuit(assembly, circuit, config, constants)


def _witness_free(circuit: Circuit) -> Circuit:
    """circuit.without_witnesses(), propagating the dev.tfp tracing
    marker so keygen synthesis is traced too."""
    wf = circuit.without_witnesses()
    events = getattr(circuit, "_tfp_events", None)
    if events is not None:
        wf._tfp_events = events
    return wf


def _fixed_ints(fs, cs, assembly):
    """Compress the selectors into fixed columns; evaluate every fixed
    column to host ints."""
    cs, selector_polys = compress_selectors(cs, assembly.selectors)
    fixed_ints = [batch_evaluate_assigned(fs, col) for col in assembly.fixed]
    fixed_ints.extend([v % fs.modulus for v in poly]
                      for poly in selector_polys)
    return cs, fixed_ints


def keygen_vk(params: Params, circuit: Circuit) -> VerifyingKey:
    """keygen.rs:189-244."""
    fs = params.curve.scalar
    df = params.scalar_df
    cs, domain, config = create_domain(params, type(circuit))
    if params.n < cs.minimum_rows():
        raise NotEnoughRowsAvailable(params.k)
    assembly = Assembly(cs, params, fs)
    _synthesize(_witness_free(circuit), config, assembly, cs.constants)
    cs, fixed_ints = _fixed_ints(fs, cs, assembly)
    permutation_vk = build_vk(params, domain, assembly.permutation)
    fixed_values = [df.upload_values(col, params.device)
                    for col in fixed_ints]
    fixed_commitments = params.commit_many(
        fixed_values, [DEFAULT_BLIND] * len(fixed_values), lagrange=True)
    vk = VerifyingKey(
        curve=params.curve, domain=domain,
        fixed_commitments=fixed_commitments,
        permutation_commitments=permutation_vk,
        cs=cs, cs_degree=cs.degree(), selectors=assembly.selectors)
    # keygen_pk of the same circuit object reuses this synthesis
    vk._keygen_memo = (circuit, assembly, fixed_values)
    return vk


def keygen_pk(params: Params, vk: VerifyingKey,
              circuit: Circuit) -> ProvingKey:
    """keygen.rs:247-337 (with a fresh ConstraintSystem so queries and
    columns match the vk's post-compression layout)."""
    fs = params.curve.scalar
    df = params.scalar_df
    dev = params.device
    cs = ConstraintSystem()
    config = type(circuit).configure(cs)
    domain = vk.domain
    if params.n < cs.minimum_rows():
        raise NotEnoughRowsAvailable(params.k)
    memo = getattr(vk, "_keygen_memo", None)
    if memo is not None and memo[0] is circuit:
        assembly, fixed_values = memo[1], memo[2]
        cs, _ = compress_selectors(cs, assembly.selectors)
    else:
        assembly = Assembly(cs, params, fs)
        _synthesize(_witness_free(circuit), config, assembly,
                    cs.constants)
        cs, fixed_ints = _fixed_ints(fs, cs, assembly)
        fixed_values = [df.upload_values(col, dev) for col in fixed_ints]

    n = params.n
    blinding_factors = cs.blinding_factors()
    fixed_polys, fixed_cosets = domain.lagrange_to_coeff_extended_many(
        fixed_values)
    permutation_pk = build_pk(params, domain, assembly.permutation)

    def indicator(rows: list[int]):
        vals = [0] * n
        for r in rows:
            vals[r] = 1
        return df.upload_values(vals, dev)

    _, (l0, l_blind, l_last) = domain.lagrange_to_coeff_extended_many([
        indicator([0]),
        indicator(list(range(n - blinding_factors, n))),
        indicator([n - blinding_factors - 1])])
    return ProvingKey(
        vk=vk, l0=l0, l_blind=l_blind, l_last=l_last,
        l_active_row_info=(blinding_factors,),
        fixed_values=fixed_values, fixed_polys=fixed_polys,
        fixed_cosets=fixed_cosets, permutation=permutation_pk)
