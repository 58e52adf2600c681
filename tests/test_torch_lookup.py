"""The port's lookup argument (halo2_tpu_torch.plonk.lookup) against the
JAX reference, on the CPU: the permuted pair against the reference's
device pipeline and its numpy formulation, the permuted and product
columns and the five h terms of a K = 4 lookup, and the scaled-down
dev_lookup circuit (K = 5) proved by both packages. Inputs are seeded;
results must be bit-equal."""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.fields.device import FQ_DEV as RDF
from halo2_tpu.transcript import (TranscriptWrite as RTranscriptWrite,
                                  TranscriptRead as RTranscriptRead)
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.domain import EvaluationDomain as RDomain
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu import plonk as rplonk
from halo2_tpu.plonk import lookup as rlookup
from halo2_tpu.plonk.circuit import (ConstraintSystem as RCS,
                                     Constant as RConstant)

from halo2_tpu_torch.bench_circuit import dev_lookup_circuit_class
from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.convert import (params_from_reference,
                                     proving_key_arrays_from_numpy,
                                     load_proving_key_arrays)
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.fields.device import FQ_DEV
from halo2_tpu_torch.plonk import lookup as plookup
from halo2_tpu_torch.plonk.circuit import ConstraintSystem, Constant
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                            VerificationError)
from halo2_tpu_torch.poly.domain import EvaluationDomain
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

from test_torch_prover import _reference_pk_arrays

FS = R_PALLAS.scalar          # Fq, the scalar field of PALLAS Params
P = FS.modulus
SEED = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mont(vals):
    """Canonical ints -> (reference uint32 array, port int32 tensor)."""
    arr = np.asarray(RDF.to_mont_np(vals))
    return arr, torch.from_numpy(arr.astype(np.int32))


def _pair_values(u, seed, missing=False):
    """`u` input and table rows: the table holds 0, p - 1, 1 and random
    values with repeats; the inputs are drawn from a few of them, so most
    input rows repeat and the table has leftovers."""
    rng = np.random.default_rng(seed)
    distinct = [0, P - 1, 1] + [int.from_bytes(rng.bytes(32), "little") % P
                                for _ in range(9)]
    table = [distinct[int(i)] for i in rng.integers(0, len(distinct), u)]
    table[:3] = [0, P - 1, 1]
    present = sorted(set(table))
    inputs = [present[int(i)] for i in rng.integers(0, 4, u)]
    inputs[5] = P - 1
    if missing:
        inputs[7] = next(v for v in range(2, 20) if v not in present)
    return inputs, table


@pytest.mark.parametrize("u,seed", [(40, 1), (64, 2), (17, 3)])
def test_permuted_pair_matches_reference(u, seed, monkeypatch):
    inputs, table = _pair_values(u, seed)
    ri, ti = _mont(inputs)
    rt, tt = _mont(table)
    pi, pt, ok = plookup.permute_pair_ranks(FQ_DEV, ti, tt)
    assert bool(ok)
    # the reference's device pipeline
    rpi, rpt, rok = rlookup._permute_pair_device_fn(RDF, u)(
        jnp.asarray(ri), jnp.asarray(rt))
    assert bool(rok)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(rpi).astype(np.int32))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rpt).astype(np.int32))
    # the port's copy of the numpy formulation
    opi, opt = plookup.permute_pair_oracle(FQ_DEV, ti.numpy(), tt.numpy())
    np.testing.assert_array_equal(pi.numpy(), opi)
    np.testing.assert_array_equal(pt.numpy(), opt)
    # the reference's numpy formulation, blinding rows included
    bf = 5
    n = u + bf + 1
    cs = SimpleNamespace(blinding_factors=lambda: bf)
    pad = [0] * (bf + 1)
    monkeypatch.setenv("HALO2_TPU_DEVICE_LOOKUP_SORT", "0")
    ra, rb = rlookup.permute_expression_pair(
        cs, SimpleNamespace(scalar_df=RDF, curve=R_PALLAS, n=n),
        random.Random(seed), jnp.asarray(_mont(inputs + pad)[0]),
        jnp.asarray(_mont(table + pad)[0]))
    a, b = plookup.permute_expression_pair(
        cs, SimpleNamespace(scalar_df=FQ_DEV, curve=PALLAS, n=n,
                            device=torch.device("cpu")),
        random.Random(seed), _mont(inputs + pad)[1], _mont(table + pad)[1])
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra).astype(np.int32))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb).astype(np.int32))


def test_permuted_pair_rejects_a_missing_input():
    inputs, table = _pair_values(30, 4, missing=True)
    ti, tt = _mont(inputs)[1], _mont(table)[1]
    assert not bool(plookup.permute_pair_ranks(FQ_DEV, ti, tt)[2])
    with pytest.raises(ValueError, match="not contained in table"):
        plookup.permute_pair_oracle(FQ_DEV, ti.numpy(), tt.numpy())


# ---------------------------------------------------------------------------
# one lookup's columns and h terms at K = 4
# ---------------------------------------------------------------------------

K4 = 4
THETA, BETA, GAMMA = 0x1234567, 0xABCDEF01, 0x5555AAAA


def _lookup_cs(cs_cls, rotation_cls, constant_cls):
    """Two lookups: (a, b) in (t0, t1), compressed with theta, and the
    constant 7 in t0 (a compressed input that broadcasts)."""
    cs = cs_cls()
    a, b = cs.advice_column(), cs.advice_column()
    t0, t1 = cs.lookup_table_column(), cs.lookup_table_column()
    cs.lookup("pair", lambda m: [(m.query_advice(a, rotation_cls(0)), t0),
                                 (m.query_advice(b, rotation_cls(0)), t1)])
    cs.lookup("const", lambda m: [(constant_cls(7), t0)])
    return cs


def _k4_columns(missing=False):
    n = 1 << K4
    rng = np.random.default_rng(8)
    t0 = [7, 7, 3] + [int(v) for v in rng.integers(0, 1 << 20, n - 3)]
    t1 = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    rows = [int(j) for j in rng.integers(0, 5, n)]
    a = [t0[j] for j in rows]
    b = [t1[j] for j in rows]
    if missing:
        a[2] = (1 << 21) + 1
    return [a, b], [t0, t1]


def _run_lookup(pkg, missing=False):
    """Permuted and product commitments and the h terms of the K = 4 lookups
    through one package: (transcript bytes, [tensors to compare])."""
    advice, fixed = _k4_columns(missing)
    rng = random.Random(SEED)
    indicators = lambda bf: [[int(i == 0) for i in range(1 << K4)],
                             [int(i >= (1 << K4) - bf)
                              for i in range(1 << K4)],
                             [int(i == (1 << K4) - bf - 1)
                              for i in range(1 << K4)]]
    if pkg == "ref":
        cs = _lookup_cs(RCS, RRotation, RConstant)
        params = _ref_params_k4()
        domain = RDomain(RDF, cs.degree(), K4)
        up = lambda v: jnp.asarray(_mont(v)[0])
        tw, lk = RTranscriptWrite(R_PALLAS), rlookup
    else:
        cs = _lookup_cs(ConstraintSystem, Rotation, Constant)
        params = _port_params_k4()
        domain = EvaluationDomain(FQ_DEV, cs.degree(), K4, "cpu")
        up = lambda v: _mont(v)[1]
        tw, lk = TranscriptWrite(PALLAS), plookup
    adv = [up(v) for v in advice]
    fix = [up(v) for v in fixed]
    _, adv_c = domain.lagrange_to_coeff_extended_many(adv)
    _, fix_c = domain.lagrange_to_coeff_extended_many(fix)
    _, (l0, l_blind, l_last) = domain.lagrange_to_coeff_extended_many(
        [up(v) for v in indicators(cs.blinding_factors())])
    out = []
    for argument in cs.lookups:
        permuted = lk.lookup_commit_permuted(argument, cs, params, domain,
                                             THETA, adv, fix, [], rng, tw)
        committed = lk.lookup_commit_product(permuted, cs, params, domain,
                                             BETA, GAMMA, rng, tw)
        out += [permuted.permuted_input, permuted.permuted_table,
                permuted.permuted_input_coset, committed.product_poly,
                committed.product_coset]
        out += lk.lookup_h_terms(committed, domain, THETA, BETA, GAMMA, adv_c,
                                 fix_c, [], l0, l_blind, l_last)
    return tw.finalize(), [np.asarray(t).astype(np.int32) for t in out]


_PARAMS: dict = {}


def _ref_params_k4():
    if "ref" not in _PARAMS:
        _PARAMS["ref"] = RParams.new(R_PALLAS, K4, use_cache=False)
    return _PARAMS["ref"]


def _port_params_k4():
    if "port" not in _PARAMS:
        r = _ref_params_k4()
        _PARAMS["port"] = params_from_reference("pallas", K4, r.g,
                                                r.g_lagrange, r.w, r.u, "cpu")
    return _PARAMS["port"]


def test_lookup_columns_and_h_terms_match_reference():
    """A', S', Z and the five h terms of two lookups (a theta-compressed
    pair and a constant input) at K = 4, with the commitments' bytes."""
    rbytes, rvals = _run_lookup("ref")
    pbytes, pvals = _run_lookup("port")
    assert pbytes == rbytes
    assert len(pvals) == len(rvals) == 2 * 10
    for got, want in zip(pvals, rvals):
        np.testing.assert_array_equal(got, want)


def test_witness_outside_the_table_is_rejected():
    with pytest.raises(ValueError, match="not contained in table"):
        _run_lookup("port", missing=True)


# ---------------------------------------------------------------------------
# the scaled-down dev_lookup circuit, proved by both packages
# ---------------------------------------------------------------------------

K5 = 5
TABLE_BITS, ROWS = 3, 16       # a 2^3 table and 16 looked-up rows
_BUILT: dict = {}


def built():
    """Keys and one proof from each prover (made once per test process)."""
    if not _BUILT:
        rcls = dev_lookup_circuit_class(RCircuit, RValue, RRotation, FS)
        cls = dev_lookup_circuit_class(Circuit, Value, Rotation,
                                       PALLAS.scalar)
        rparams = RParams.new(R_PALLAS, K5, use_cache=False)
        params = params_from_reference("pallas", K5, rparams.g,
                                       rparams.g_lagrange, rparams.w,
                                       rparams.u, "cpu")
        rcircuit, circuit = rcls(TABLE_BITS, ROWS), cls(TABLE_BITS, ROWS)
        rvk = rplonk.keygen_vk(rparams, rcircuit)
        rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
        vk = keygen_vk(params, circuit)
        pk = keygen_pk(params, vk, circuit)
        tw = RTranscriptWrite(R_PALLAS)
        rplonk.create_proof(rparams, rpk, [rcircuit], [[]],
                            random.Random(SEED), tw)
        _BUILT.update(rparams=rparams, params=params, circuit=circuit,
                      rvk=rvk, rpk=rpk, vk=vk, pk=pk, rproof=tw.finalize(),
                      proof=_prove(params, pk, circuit))
    return _BUILT


def _prove(params, pk, circuit):
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk, [circuit], [[]], random.Random(SEED), tw)
    return tw.finalize()


def test_dev_lookup_vk_matches_reference():
    b = built()
    assert b["vk"].transcript_repr() == b["rvk"].transcript_repr()
    assert b["vk"].pinned_text() == b["rvk"].pinned_text()
    assert b["vk"].fixed_commitments == b["rvk"].fixed_commitments
    assert b["vk"].domain.extended_k == b["rvk"].domain.extended_k


def test_dev_lookup_proof_bytes_match_reference():
    b = built()
    assert b["proof"] == b["rproof"]


def test_dev_lookup_proof_verifies_under_both_verifiers():
    b = built()
    verify_proof(b["params"], b["vk"], SingleVerifier(b["params"]), [[]],
                 TranscriptRead(PALLAS, b["proof"]))
    rplonk.verify_proof(b["rparams"], b["rvk"],
                        rplonk.SingleVerifier(b["rparams"]), [[]],
                        RTranscriptRead(R_PALLAS, b["proof"]))


def test_dev_lookup_corrupted_proof_rejected():
    b = built()
    bad = bytearray(b["proof"])
    bad[-64] ^= 1                  # the IPA's scalar c, off by one
    with pytest.raises(VerificationError):
        verify_proof(b["params"], b["vk"], SingleVerifier(b["params"]), [[]],
                     TranscriptRead(PALLAS, bytes(bad)))


def test_dev_lookup_proof_from_carried_proving_key():
    """A port pk whose arrays (the table column among the fixed ones) were
    carried over from the reference by convert.py proves the same bytes."""
    b = built()
    pk = keygen_pk(b["params"], b["vk"], b["circuit"])
    load_proving_key_arrays(pk, proving_key_arrays_from_numpy(
        _reference_pk_arrays(b["rpk"]), "cpu"))
    assert _prove(b["params"], pk, b["circuit"]) == b["rproof"]
