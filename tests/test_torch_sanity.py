"""The reference's debug checks in the port (create_proof(sanity=True)),
on the CPU: the permuted lookup pair is well formed, the lookup product
starts at 1 and closes to 1, and the permutation product telescopes
(halo2_tpu/plonk/lookup.py:282-289, :372-380, permutation.py:339-345,
switched on there by HALO2_TPU_SANITY).

A valid proof's bytes are the same with the checks on, and equal to the
reference's proof made with its checks on; each check is tripped by its
tampered input: a permuted table column rolled by a row, a lookup product
or a permutation product whose first factor is doubled. The same tampered
inputs, and tampers at the rows where the checks begin and end, go
through the reference with HALO2_TPU_SANITY set: it raises where the port
raises, with the same message, and where neither raises the proofs are
byte-equal. The tampered proves stop at the check, before the quotient."""
import random

import numpy as np
import pytest
import torch

from halo2_tpu import plonk as rplonk
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.fields.device import fadd as rfadd
from halo2_tpu.plonk import lookup as rlookup, permutation as rpermutation
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu.transcript import TranscriptWrite as RTranscriptWrite

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.ops.field_kernels import fadd
from halo2_tpu_torch.plonk import lookup, permutation
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof, SingleVerifier
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

K = 4
SEED = 5
A, B = 2, 3                     # a and a * b in the table 1..TABLE


def lookup_mul_circuit_class(circuit_base, value_cls, rotation):
    """The circuit over either package's classes."""
    class LookupMulCircuit(circuit_base):
        """out = a * b copied to the instance column (a permutation), and
        a and out looked up in a table of 1..TABLE (halo2's dev_lookup
        form, a complex selector)."""
        TABLE = 8

        def without_witnesses(self):
            return LookupMulCircuit()

        @classmethod
        def configure(cls, meta):
            a = meta.advice_column()
            b = meta.advice_column()
            instance = meta.instance_column()
            s_mul = meta.selector()
            s_look = meta.complex_selector()
            table = meta.lookup_table_column()
            meta.enable_equality(a)
            meta.enable_equality(instance)

            def gate(cells):
                s = cells.query_selector(s_mul)
                return [("mul", s * (cells.query_advice(a, rotation(0))
                                     * cells.query_advice(b, rotation(0))
                                     - cells.query_advice(a, rotation(1))))]

            meta.create_gate("mul", gate)
            meta.lookup("range", lambda cells: [(
                cells.query_selector(s_look)
                * cells.query_advice(a, rotation(0))
                + (1 - cells.query_selector(s_look)), table)])
            return {"a": a, "b": b, "instance": instance, "s_mul": s_mul,
                    "s_look": s_look, "table": table}

        def synthesize(self, config, layouter):
            def fill(table):
                for row in range(self.TABLE):
                    table.assign_cell(f"row {row}", config["table"], row,
                                      lambda row=row: value_cls.known(row + 1))
            layouter.assign_table("table", fill)

            def region_fn(region):
                region.enable_selector("mul", config["s_mul"], 0)
                for row in (0, 1):
                    region.enable_selector("look", config["s_look"], row)
                region.assign_advice("a", config["a"], 0,
                                     lambda: value_cls.known(A))
                region.assign_advice("b", config["b"], 0,
                                     lambda: value_cls.known(B))
                return region.assign_advice("out", config["a"], 1,
                                            lambda: value_cls.known(A * B))

            out = layouter.assign_region("mul", region_fn)
            layouter.constrain_instance(out.cell, config["instance"], 0)

    return LookupMulCircuit


LookupMulCircuit = lookup_mul_circuit_class(Circuit, Value, Rotation)
RLookupMulCircuit = lookup_mul_circuit_class(RCircuit, RValue, RRotation)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    params = Params.new(PALLAS, K, device="cpu")
    circuit = LookupMulCircuit()
    vk = keygen_vk(params, circuit)
    return params, keygen_pk(params, vk, circuit)


def _prove(keys, sanity):
    params, pk = keys
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk, [LookupMulCircuit()], [[[A * B]]],
                 random.Random(SEED), tw, sanity=sanity)
    return tw.finalize()


def test_valid_proof_unchanged_with_the_checks_on(keys):
    params, pk = keys
    assert pk.vk.cs.lookups and pk.vk.cs.permutation.columns
    proof = _prove(keys, sanity=True)
    assert proof == _prove(keys, sanity=False)
    verify_proof(params, pk.vk, SingleVerifier(params), [[[A * B]]],
                 TranscriptRead(PALLAS, proof))


def _factor_doubled(orig, row, reference=False):
    """A running_product whose factor at `row` is doubled: every prefix
    product after it is off by a factor of 2 (in the port, or with
    `reference` in the JAX package)."""
    def tampered(df, x, axis=0):
        if reference:
            x = x.at[row].set(rfadd(df, x[row], x[row]))
        else:
            x = x.clone()
            x[row] = fadd(df, x[row], x[row])
        return orig(df, x, axis=axis)
    return tampered


def test_tampered_permuted_pair_trips_its_check(keys, monkeypatch):
    orig = lookup.permute_pair_ranks

    def rolled(df, input_mont, table_mont):
        pi, pt, ok = orig(df, input_mont, table_mont)
        return pi, torch.roll(pt, 1, dims=0), ok

    monkeypatch.setattr(lookup, "permute_pair_ranks", rolled)
    with pytest.raises(AssertionError, match="permuted pair violates"):
        _prove(keys, sanity=True)


def test_tampered_lookup_product_trips_its_check(keys, monkeypatch):
    monkeypatch.setattr(lookup, "running_product",
                        _factor_doubled(lookup.running_product, 0))
    with pytest.raises(AssertionError,
                       match="lookup grand product does not telescope"):
        _prove(keys, sanity=True)


def test_tampered_permutation_product_trips_its_check(keys, monkeypatch):
    monkeypatch.setattr(permutation, "running_product",
                        _factor_doubled(permutation.running_product, 0))
    with pytest.raises(AssertionError,
                       match="permutation grand product does not telescope"):
        _prove(keys, sanity=True)


def test_checks_on_explicit_columns():
    """The three checks on hand-made columns: z = (1, 3, 1) passes and
    (2, ...) fails at z[0]; a pair with a repeated input row passes and
    fails once its first row is changed; last_z 1 passes, 2 fails."""
    from halo2_tpu_torch.fields.device import FQ_DEV as df
    up = lambda vals: df.upload_values(vals, torch.device("cpu"))
    lookup.check_lookup_product(df, up([1, 3, 1]), 2)
    with pytest.raises(AssertionError, match=r"lookup z\[0\] != 1"):
        lookup.check_lookup_product(df, up([2, 3, 1]), 2)
    lookup.check_permuted_pair(up([4, 4, 7]), up([4, 9, 7]))
    with pytest.raises(AssertionError, match="permuted pair violates"):
        lookup.check_permuted_pair(up([4, 4, 7]), up([5, 9, 7]))
    permutation.check_permutation_product(1)
    with pytest.raises(AssertionError, match="does not telescope"):
        permutation.check_permutation_product(2)


@pytest.fixture(scope="module")
def ref_keys():
    rparams = RParams.new(R_PALLAS, K, use_cache=False)
    circuit = RLookupMulCircuit()
    rvk = rplonk.keygen_vk(rparams, circuit)
    return rparams, rplonk.keygen_pk(rparams, rvk, circuit)


def _ref_prove(ref_keys, monkeypatch):
    """The reference's proof with its debug checks on; its host lookup
    sort, since only that path holds the permuted-pair check."""
    monkeypatch.setenv("HALO2_TPU_SANITY", "1")
    monkeypatch.setenv("HALO2_TPU_DEVICE_LOOKUP_SORT", "0")
    rparams, rpk = ref_keys
    tw = RTranscriptWrite(R_PALLAS)
    rplonk.create_proof(rparams, rpk, [RLookupMulCircuit()], [[[A * B]]],
                        random.Random(SEED), tw)
    return tw.finalize()


def test_proof_with_the_checks_on_equals_the_reference(keys, ref_keys,
                                                       monkeypatch):
    assert _prove(keys, sanity=True) == _ref_prove(ref_keys, monkeypatch)


def _reference_pair_remapped(rows_map):
    """A numpy for the reference's lookup module whose permuted table
    ranks (perm_tab_ranks, made by copying the sorted input ranks and
    filling the repeated rows) are read at `rows_map` once filled, before
    the debug check sees them: the port's tamper of S', on ranks."""
    class Remapped(np.ndarray):
        def __setitem__(self, key, value):
            base = self.view(np.ndarray)
            base[key] = value
            base[:] = base[rows_map].copy()

    class Sorted(np.ndarray):
        def copy(self, *args, **kw):
            return self.view(np.ndarray).copy().view(Remapped)

    class Numpy:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def sort(a, *args, **kw):
            return np.sort(a, *args, **kw).view(Sorted)

    return Numpy()


def _rows(u, row, to):
    m = np.arange(u)
    m[row] = to
    return m


# what is tampered, how (rows_map of S' over the u usable rows, or the
# row of the product's factor that is doubled), and what the checks say
TAMPERS = {
    "pair_rolled": ("pair", lambda u: np.roll(np.arange(u), 1),
                    "permuted pair violates"),
    "pair_row_0": ("pair", lambda u: _rows(u, 0, 1),
                   "permuted pair violates"),
    "pair_last_usable_row": ("pair", lambda u: _rows(u, u - 1, 0),
                             "permuted pair violates"),
    # a repeated input row passes the pair check; S' is then no
    # permutation of S, so the lookup product does not close
    "pair_repeated_row": ("pair", lambda u: _rows(u, 1, 2),
                          "lookup grand product does not telescope"),
    "lookup_row_0": ("lookup", lambda u: 0,
                     "lookup grand product does not telescope"),
    "lookup_last_usable_row": ("lookup", lambda u: u - 1,
                               "lookup grand product does not telescope"),
    # z[u + 1:] are blinds: a factor from row u on changes no checked row
    "lookup_first_blinding_row": ("lookup", lambda u: u, None),
    "permutation_row_0": ("permutation", lambda u: 0,
                          "permutation grand product does not telescope"),
    "permutation_last_usable_row": (
        "permutation", lambda u: u - 1,
        "permutation grand product does not telescope"),
    "permutation_first_blinding_row": ("permutation", lambda u: u, None),
}


def _outcome(prove):
    try:
        return "proof", prove()
    except AssertionError as e:
        return "raised", str(e)


@pytest.mark.parametrize("name", TAMPERS)
def test_reference_checks_agree_on_tampered_input(name, keys, ref_keys,
                                                  monkeypatch):
    """The same tampered input through the port (sanity=True) and the
    reference (HALO2_TPU_SANITY): both raise the same message, or both
    finish with equal bytes."""
    stage, where, message = TAMPERS[name]
    u = keys[0].n - (keys[1].vk.cs.blinding_factors() + 1)
    at = where(u)
    with monkeypatch.context() as m:
        if stage == "pair":
            orig = lookup.permute_pair_ranks

            def remapped(df, input_mont, table_mont):
                pi, pt, ok = orig(df, input_mont, table_mont)
                return pi, pt[torch.as_tensor(at)], ok

            m.setattr(lookup, "permute_pair_ranks", remapped)
        else:
            mod = lookup if stage == "lookup" else permutation
            m.setattr(mod, "running_product",
                      _factor_doubled(mod.running_product, at))
        port = _outcome(lambda: _prove(keys, sanity=True))
    with monkeypatch.context() as m:
        if stage == "pair":
            m.setattr(rlookup, "np", _reference_pair_remapped(at))
        else:
            rmod, cache = ((rlookup, "_LOOKUP_Z_JIT") if stage == "lookup"
                           else (rpermutation, "_Z_CHUNK_JIT"))
            m.setattr(rmod, cache, {})    # traced anew with the tamper
            m.setattr(rmod, "running_product",
                      _factor_doubled(rmod.running_product, at,
                                      reference=True))
        ref = _outcome(lambda: _ref_prove(ref_keys, m))
    assert port == ref
    if message is None:
        assert port[0] == "proof"
    else:
        assert port[0] == "raised" and message in port[1]
