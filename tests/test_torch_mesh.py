"""The port's multi-device layer (halo2_tpu_torch/parallel/) against the
JAX package's, on the CPU.

Two spawned gloo worlds, of D = 2 and D = 4 ranks
(parallel/launch.py::run_ranks), each run once, side by side, while this
process makes the JAX package's results: every rank runs
parallel/programs.py's tasks (a module that imports only the port) on
inputs made from numpy seeds, and sends its results back. Held exactly,
with no tolerance:

  - the port's sharded_ntt (forward and inverse), sharded_inclusive_product
    and sharded_batch_inv (zeros in the input) at n = 64 against the JAX
    package's functions of the same names under make_mesh(D) of
    tests/conftest.py's virtual CPU devices;
  - the sharded commit at K = 6 against the JAX package's
    Params.commit_lagrange of the same values, and sharded_msm over
    projective bases against the JAX package's host MSM;
  - MulChainCircuit at K = 4 proved under the mesh, against the JAX
    package's proof for the same Params, circuit and random.Random seed
    (at D = 2 the ranks hold their rows; at D = 4 the permutation's link
    of 6 rows exceeds a rank's 4, so they keep whole tensors), and at
    K = 5 under D = 4, where they hold their rows; each rank's re-laid
    proving key holds its block of rows in storage of its own, and a
    proof with it after the mesh exits is the single-device one;
  - ProverMesh.roll_rows against torch.roll of the whole column;
  - the scaled-down dev_lookup circuit at K = 5 (the smallest lookup
    circuit tests/test_torch_lookup.py proves) under D = 2, against the
    JAX package's proof, which that file holds equal to the port's
    single-device proof;
  - at D = 4, a domain of 2^3 rows (D^2 does not divide n) takes the
    single-device transform, and ranks given different seeds raise.

Every rank's results must also equal its own single-device results and
every other rank's.
"""
import concurrent.futures
import random

import jax.numpy as jnp
import numpy as np
import pytest

from halo2_tpu import plonk as rplonk
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.dev.circuits import MulChainCircuit as RMulChainCircuit
from halo2_tpu.fields import FQ_DEV as R_FQ_DEV
from halo2_tpu.parallel import (make_mesh as r_make_mesh,
                                sharded_ntt as r_sharded_ntt,
                                ShardedNttPlan as RShardedNttPlan,
                                sharded_inclusive_product as r_scan,
                                sharded_batch_inv as r_batch_inv)
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu.transcript import TranscriptWrite as RTranscriptWrite

from halo2_tpu_torch.bench_circuit import dev_lookup_circuit_class
from halo2_tpu_torch.parallel import make_mesh, profiling
from halo2_tpu_torch.parallel.launch import run_ranks
from halo2_tpu_torch.parallel.programs import field_values, run

LOG_N = 6                 # the kernels' columns: n = 64
COMMIT_K = 6
K = 4                     # MulChainCircuit(7, rows=4)
K_ROWS4 = 5               # its K where 4 ranks hold their rows
LOOKUP_K, TABLE_BITS, LOOKUP_ROWS = 5, 3, 16
SEED = 77
WORLDS = (2, 4)
# run_ranks's limit on a whole world (and its collectives' timeout): the
# D = 4 world takes about 70 s alone on 8 cores and up to about 140 s
# while the suite's other workers load them
JOIN_TIMEOUT_S = 300


def _tasks(D: int) -> list:
    tasks = [
        ("ntt", "ntt", dict(log_n=LOG_N, seed=1)),
        ("intt", "ntt", dict(log_n=LOG_N, seed=1, inverse=True)),
        ("scans", "scans", dict(n=1 << LOG_N, seed=2)),
        ("msm", "msm", dict(n=16, seed=4)),
        ("commit", "commit", dict(k=COMMIT_K, seed=3, blind=5)),
        ("roll", "roll", dict(log_n=LOG_N, shifts=_shifts(D))),
        ("mulchain", "prove", dict(circuit="mulchain", k=K, seed=SEED,
                                   verify=True, after=D == 2)),
    ]
    if D == 2:
        tasks += [("lookup", "prove", dict(
            circuit="dev_lookup", k=LOOKUP_K, seed=SEED, verify=True,
            table_bits=TABLE_BITS, rows=LOOKUP_ROWS)),
            ("chunked", "prove", dict(circuit="mulchain", k=K, seed=SEED,
                                      h_chunk_nodes=8))]
    if D == 4:
        tasks += [("mulchain5", "prove", dict(circuit="mulchain", k=K_ROWS4,
                                              seed=SEED, verify=True,
                                              after=True)),
                  ("routing", "routing", dict(k=3)),
                  ("mixed", "prove", dict(circuit="mulchain", k=K,
                                          seed=SEED, rank_seed=True))]
    return tasks


def _shifts(D: int) -> list:
    """roll_rows' shifts on a column of 2^LOG_N rows: +-1, +-rot_scale
    (2, the extended domain's scale at degree 3) and the rank's whole
    block, both ways."""
    c = (1 << LOG_N) // D
    return [1, -1, 2, -2, c, -c]


def _reference() -> dict:
    """The JAX package's results on the same inputs."""
    df = R_FQ_DEV
    spec = df.spec
    n = 1 << LOG_N
    ref = {}
    x = jnp.asarray(df.to_mont_np(field_values(spec, n, 1)))
    s = jnp.asarray(df.to_mont_np(field_values(spec, n, 2)))
    omega = pow(spec.root_of_unity, 1 << (spec.s - LOG_N), spec.modulus)
    omega_inv = pow(omega, spec.modulus - 2, spec.modulus)
    for D in WORLDS:
        mesh = r_make_mesh(D)
        for name, om in (("ntt", omega), ("intt", omega_inv)):
            ref[D, name] = np.asarray(r_sharded_ntt(
                df, mesh, RShardedNttPlan(df, n, om, D), x)).astype(np.int32)
        ref[D, "product"] = np.asarray(r_scan(df, mesh, s)).astype(np.int32)
        ref[D, "inv"] = np.asarray(r_batch_inv(df, mesh, s)).astype(np.int32)
    params = RParams.new(R_PALLAS, COMMIT_K)
    ref["commit"] = params.commit_lagrange(jnp.asarray(df.to_mont_np(
        field_values(spec, 1 << COMMIT_K, 3))), 5)

    def prove(params, circuit, instances):
        vk = rplonk.keygen_vk(params, circuit)
        pk = rplonk.keygen_pk(params, vk, circuit)
        tw = RTranscriptWrite(R_PALLAS)
        rplonk.create_proof(params, pk, [circuit], instances,
                            random.Random(SEED), tw)
        return tw.finalize()

    c = RMulChainCircuit(7, 4)
    ref["mulchain"] = prove(RParams.new(R_PALLAS, K), c,
                            [[[c.expected_out()]]])
    ref["mulchain5"] = prove(RParams.new(R_PALLAS, K_ROWS4), c,
                             [[[c.expected_out()]]])
    cls = dev_lookup_circuit_class(RCircuit, RValue, RRotation,
                                   R_PALLAS.scalar)
    ref["lookup"] = prove(RParams.new(R_PALLAS, LOOKUP_K),
                          cls(TABLE_BITS, LOOKUP_ROWS), [[]])
    return ref


@pytest.fixture(scope="module")
def worlds():
    """({D: [each rank's results]}, the JAX package's results): the two
    worlds run while this process makes the reference's."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {D: pool.submit(run_ranks, run, D, "gloo", JOIN_TIMEOUT_S,
                               "cpu", _tasks(D)) for D in WORLDS}
        ref = _reference()
        return {D: f.result() for D, f in futs.items()}, ref


@pytest.mark.parametrize("D", WORLDS)
def test_every_rank_joined_the_world(worlds, D):
    ranks = worlds[0][D]
    assert [r["rank"] for r in ranks] == list(range(D))
    assert {(r["size"], r["backend"], r["device"]) for r in ranks} == {
        (D, "gloo", "cpu")}
    assert all(r["staged_bytes"] == 0 for r in ranks)   # CPU tensors


@pytest.mark.parametrize("name", ["ntt", "intt"])
@pytest.mark.parametrize("D", WORLDS)
def test_sharded_ntt_matches_reference(worlds, D, name):
    ranks, ref = worlds[0][D], worlds[1]
    for r in ranks:
        assert r[name]["single"]
        assert np.array_equal(r[name]["out"], ref[D, name])


@pytest.mark.parametrize("name", ["product", "inv"])
@pytest.mark.parametrize("D", WORLDS)
def test_sharded_scan_and_batch_inv_match_reference(worlds, D, name):
    ranks, ref = worlds[0][D], worlds[1]
    assert not ref[D, "inv"][3].any()          # a zero maps to zero
    for r in ranks:
        assert r["scans"]["single"]
        assert np.array_equal(r["scans"][name], ref[D, name])


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_msm_over_projective_bases_matches_host_msm(worlds, D):
    """sharded_msm without packed bases (the reference's sharded_msm,
    assume_affine=False): 16 bases with random Z, 16 / D rows a rank."""
    for r in worlds[0][D]:
        got = r["msm"]
        assert got["sum"] == R_PALLAS.msm(got["scalars"], got["points"])


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_commit_matches_reference(worlds, D):
    ranks, ref = worlds[0][D], worlds[1]
    for r in ranks:
        got = r["commit"]
        assert got["counts"]["sharded_msm"] == 1
        assert got["counts"]["all_gather"] == 1
        assert got["mesh"] == got["single"] == ref["commit"]


@pytest.mark.parametrize("D", WORLDS)
def test_mesh_proof_equals_reference_proof(worlds, D):
    """MulChainCircuit at K = 4 (n = 16, so D^2 | n at D = 4): every
    branch sharded, the proof the JAX package's, verified."""
    ranks, ref = worlds[0][D], worlds[1]
    for r in ranks:
        got = r["mulchain"]
        assert got["proofs"] == [ref["mulchain"]]
        assert got["verified"]
        counts = got["counts"]
        for name in ("sharded_msm", "sharded_ntt",
                     "sharded_inclusive_product", "sharded_batch_inv"):
            assert counts[name] > 0, name


def test_mesh_proof_with_ranks_holding_rows_equals_reference(worlds):
    """Where a rank's block takes the circuit's rolls (n/D >= 6 rows:
    K = 4 at D = 2, K = 5 at D = 4) the ranks hold their rows, and the
    proof is the JAX package's; at D = 4 and K = 4 they keep whole
    tensors, an explicit choice, and the proof is the same."""
    ref = worlds[1]
    for D, name, local in ((2, "mulchain", True), (4, "mulchain", False),
                           (4, "mulchain5", True)):
        for r in worlds[0][D]:
            got = r[name]
            assert got["local"] is local, (D, name)
            assert got["proofs"] == [ref[name]]
            if name == "mulchain5":
                assert got["verified"]
                assert got["counts"]["sharded_ntt"] > 0


def test_gate_chunks_under_the_mesh_equal_reference_proof(worlds):
    """create_proof(h_chunk_nodes=8) at D = 2, the ranks holding their
    rows: the gate chunks (kernel K2 on the card) run on the columns
    gathered whole, and the proof is the JAX package's."""
    for r in worlds[0][2]:
        got = r["chunked"]
        assert got["local"]
        assert got["proofs"] == [worlds[1]["mulchain"]]


def _whole_pk_rows(ranks, name):
    """The pk's tensors after the proof made with the mesh exited:
    {name: (rows, storage bytes)}."""
    return ranks[0][name]["after"]["pk_rows"]


@pytest.mark.parametrize("D,name", [(2, "mulchain"), (2, "lookup"),
                                    (4, "mulchain5")])
def test_relaid_pk_holds_the_ranks_rows(worlds, D, name):
    """Each rank's re-laid pk tensors (fixed values, polys and cosets,
    l0, l_blind, l_last, the permutation's sigma columns in each basis)
    hold 1/D of the rows, in storage of exactly that size, never a view
    of the whole tensor."""
    ranks = worlds[0][D]
    for r in ranks:
        rows = r[name]["pk_rows"]
        assert rows, name
        for key, (count, nbytes) in rows.items():
            assert nbytes == count * 16 * 4, key
            if name == "lookup":
                # n or ext_n rows, 2^5 and 2^7
                assert count * D in (1 << LOOKUP_K, 1 << (LOOKUP_K + 2))
            else:
                assert count * D == _whole_pk_rows(ranks, name)[key][0], key


@pytest.mark.parametrize("D,name", [(2, "mulchain"), (4, "mulchain5")])
def test_relaid_pk_after_the_mesh_exits(worlds, D, name):
    """A prove with the re-laid pk after the mesh has exited gathers the
    pk back whole and makes the single-device proof (the JAX
    package's); every tensor then holds all its rows."""
    ref = worlds[1]
    for r in worlds[0][D]:
        after = r[name]["after"]
        assert after["proof"] == ref[name]
        local = r[name]["pk_rows"]
        for key, (count, _) in after["pk_rows"].items():
            assert count == D * local[key][0], key


@pytest.mark.parametrize("D", WORLDS)
def test_roll_rows_matches_torch_roll(worlds, D):
    """Each rank's roll_rows by +-1, +-2 and its whole block equals its
    rows of torch.roll of the whole column."""
    for r in worlds[0][D]:
        assert r["roll"] == {s: True for s in _shifts(D)}


def test_lookup_mesh_proof_equals_reference_proof(worlds):
    """The sharded lookup product at D = 2 (dev_lookup, K = 5)."""
    ranks, ref = worlds[0][2], worlds[1]
    for r in ranks:
        got = r["lookup"]
        assert got["proofs"] == [ref["lookup"]]
        assert got["verified"]
        assert got["counts"]["sharded_inclusive_product"] >= 1


def test_indivisible_mesh_takes_single_device_transform(worlds):
    """D = 4 over 2^3 rows: 16 does not divide 8, so the domain's
    transform is the single-device one (as the reference routes it);
    a commit still shards (the reference's D | n)."""
    for r in worlds[0][4]:
        assert r["routing"] == {"domain_sharded": False,
                                "commit_sharded": True, "equal": True}


def test_ranks_given_different_seeds_raise(worlds):
    for r in worlds[0][4]:
        assert "made different proofs" in r["mixed"]["error"]
        assert not r["mixed"]["proofs"]


def test_make_mesh_needs_an_initialized_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


def test_roofline_model_uses_the_cards_constants():
    assert profiling.hbm_bandwidth_bytes_per_s() == 3.35e12
    sol = profiling.modmul_speed_of_light()
    assert sol == profiling.MULADD_PER_S / profiling.MONT_MULADDS
    assert profiling.MONT_MULADDS == 224
    assert profiling.modmul_vpu_ops_measured() == 249
    assert profiling.kernel_efficiency(sol / 4) == 0.25
    assert profiling.bandwidth_fraction(3.35e9, 2e-3) == 0.5
    assert profiling.bandwidth_fraction(0, 1.0) == 0.0
    # 2^15 products: 192 B each against 224 multiply-adds each
    ms, by = profiling.bound_ms((1 << 15) * 192, (1 << 15) * 224)
    assert by == "bytes" and ms == (1 << 15) * 192 / 3.35e12 * 1e3
    ms, by = profiling.bound_ms(0, 16.7e9)
    assert (ms, by) == (1.0, "operations")
