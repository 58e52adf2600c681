"""The prover's gate-chunk branch (halo2_tpu_torch/plonk/prover.py
`h_chunk_nodes`, kernel K2's tape and its plain interpreter,
ops/gate_kernels.py) against the JAX package's chunked h fold
(halo2_tpu/plonk/prover.py:150-261): the chunk partition, the fold of
Table16's whole gate set, and a K = 4 proof byte for byte.
"""
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.curves import VESTA as R_VESTA
from halo2_tpu.fields.device import FP_DEV as R_FP_DEV
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu.plonk import prover as rprover
from halo2_tpu.plonk.circuit import ConstraintSystem as RConstraintSystem
from halo2_tpu.plonk.compress_selectors import (
    compress_selectors as r_compress_selectors)
from halo2_tpu.poly.polynomial import Rotation as RRotation

from halo2_tpu_torch import sha256_circuits
from halo2_tpu_torch.bench_circuit import plonk_api_circuit_class
from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.curves.host import VESTA
from halo2_tpu_torch.fields.device import FP_DEV
from halo2_tpu_torch.ops import gate_kernels as gk
from halo2_tpu_torch.ops.field_kernels import fadd, fmul, fsub
from halo2_tpu_torch.plonk import prover
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.compress_selectors import compress_selectors
from halo2_tpu_torch.plonk.evaluation import compile_chunk
from halo2_tpu_torch.poly.polynomial import Rotation

from test_torch_mxu_field import k4_proofs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configured(name):
    """(reference cs, port cs) of `name` configured, not synthesized:
    plonk_api's gates or Table16's (SHA-256)."""
    if name == "plonk_api":
        rcls = plonk_api_circuit_class(RCircuit, RValue, RRotation,
                                       R_VESTA.scalar)
        cls = plonk_api_circuit_class(Circuit, Value, Rotation,
                                      VESTA.scalar)
    else:
        import importlib
        rns = sha256_circuits.namespace(
            lambda mod: importlib.import_module(f"halo2_tpu.{mod}"))
        rcls = rns.classes.Table16
        cls = sha256_circuits.port_namespace().classes.Table16
    rcs, cs = RConstraintSystem(), ConstraintSystem()
    rcls.configure(rcs)
    cls.configure(cs)
    return rcs, cs


def _reference_partition(rcs, max_nodes):
    """The reference's own chunks: its _gates_h_fold partitions the gate
    set onto the pk (prover.py:204-218) before its first chunk runs; the
    run is stopped at the chunk's call by columns it cannot take."""
    pk = types.SimpleNamespace()
    orig = rprover.H_CHUNK_NODES
    rprover.H_CHUNK_NODES = max_nodes
    try:
        with pytest.raises(TypeError):
            rprover._gates_h_fold(pk, rcs, R_FP_DEV, 1, 8, 3,
                                  R_FP_DEV.scalar(3), None, None, None, None)
    finally:
        rprover.H_CHUNK_NODES = orig
    return pk._h_gate_chunks


@pytest.mark.parametrize("name", ["plonk_api", "table16"])
def test_chunk_partition_matches_reference(name):
    rcs, cs = _configured(name)
    for max_nodes in (8, 32, 400):
        want = _reference_partition(rcs, max_nodes)
        got = prover.gate_chunks(cs, max_nodes)
        assert [len(c) for c in got] == [len(c) for c in want]
        assert ([[prover._expr_nodes(e) for e in c] for c in got]
                == [[rprover._expr_nodes(e) for e in c] for c in want])


def _rand_cols(df, count, n, seed):
    rng = np.random.default_rng(seed)
    p = df.spec.modulus
    return df.to_mont_np([[int.from_bytes(rng.bytes(32), "little") % p
                           for _ in range(n)] for _ in range(count)])


def test_table16_fold_matches_reference():
    """Table16's whole gate set (selectors compressed over 64 rows of no
    activations, in both packages) folded over random columns of 64 rows
    at rot_scale 8: the tape interpreter, one chunk of the whole set and
    chunks of 32 and of 400 nodes after an accumulator (a chunk's shared
    node is often read first by the instruction after its last visit),
    equals the JAX package's eager _gates_h_fold and the port's."""
    n, rot_scale, y = 64, 8, 0x1234567890ABCDEF
    rcs, cs = _configured("table16")
    r_compress_selectors(rcs, [[False] * n] * rcs.num_selectors)
    compress_selectors(cs, [[False] * n] * cs.num_selectors)
    tape = compile_chunk([e for g in cs.gates for e in g.polys])
    assert tape.n_slots <= gk.MAX_SLOTS
    df, rdf = FP_DEV, R_FP_DEV
    cols = [_rand_cols(df, c, n, 7 + i) for i, c in enumerate(
        (cs.num_advice_columns, cs.num_fixed_columns,
         cs.num_instance_columns))]
    adv, fix, ins = ([torch.from_numpy(c) for c in cs_] for cs_ in cols)
    adv, fix, ins = list(adv), list(fix), list(ins)
    radv, rfix, rins = ([jnp.asarray(c.astype(np.uint32)) for c in cs_]
                        for cs_ in cols)
    want = np.asarray(rprover._gates_h_fold(
        types.SimpleNamespace(), rcs, rdf, rot_scale, n, y, rdf.scalar(y),
        None, list(radv), list(rfix), list(rins))).astype(np.int32)
    y_m = df.scalar(y, "cpu")
    for nodes in (0, 1 << 20):
        got = prover._gates_h_fold(types.SimpleNamespace(), cs, df,
                                   rot_scale, n, y, y_m, None, adv, fix, ins,
                                   h_chunk_nodes=nodes)
        assert np.array_equal(got.numpy(), want), nodes
    # the plain tape on a slice of the rows (the card's checks use it)
    rows = torch.tensor([0, 1, 30, n - 2, n - 1])
    got = gk.run_chunk_plain(df, tape, None, adv, fix, ins, rot_scale, y_m,
                             df.scalar(pow(y, tape.n_polys, df.spec.modulus),
                                       "cpu"), n, rows=rows)
    assert np.array_equal(got.numpy(), want[rows.numpy()])
    # after an accumulator: h0 y^88 + the gates' fold, in chunks
    h0 = torch.from_numpy(_rand_cols(df, 1, n, 3)[0])
    want2 = np.asarray(rprover._gates_h_fold(
        types.SimpleNamespace(), rcs, rdf, rot_scale, n, y, rdf.scalar(y),
        jnp.asarray(h0.numpy().astype(np.uint32)), list(radv), list(rfix),
        list(rins))).astype(np.int32)
    for nodes in (32, 400):
        got2 = prover._gates_h_fold(types.SimpleNamespace(), cs, df,
                                    rot_scale, n, y, y_m, h0.clone(), adv,
                                    fix, ins, h_chunk_nodes=nodes)
        assert np.array_equal(got2.numpy(), want2), nodes


def test_k4_proof_with_gate_chunks(monkeypatch):
    """create_proof(h_chunk_nodes=8) against the JAX package's proof with
    its H_CHUNK_NODES at 8."""
    monkeypatch.setattr(rprover, "H_CHUNK_NODES", 8)
    runs = []
    orig = gk.run_chunk_plain

    def counted(*args, **kw):
        runs.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(gk, "run_chunk_plain", counted)
    rproof, proof = k4_proofs(h_chunk_nodes=8)
    assert runs
    assert proof == rproof


def _run_with_register_flags(df, tape, cols, rot_scale, y_m, n):
    """The tape as K2 runs it (csrc/gate_kernels.cu), on all rows at once:
    an operand flagged X_LAST / Y_LAST is read from the previous result
    and not from its slot, and a result flagged KEEP is not written to its
    slot (which holds a poison value instead), so a wrong flag shows."""
    consts = tape.on(df, "cpu")[1]
    poison = torch.full((n, 16), 0x7FFF, dtype=torch.int32)
    slots = [poison] * tape.n_slots
    acc = last = None
    for word, dst, x, y in tape.code:
        op = word & gk.OP_MASK
        a = last if word & gk.OPF_X_LAST else (
            slots[x] if op >= gk.OP_NEG else None)
        b = last if word & gk.OPF_Y_LAST else (
            slots[y] if op in (gk.OP_ADD, gk.OP_MUL) else None)
        if op == gk.OP_FOLD:
            acc = a if y else fadd(df, fmul(df, acc, y_m), a)
            continue
        if op == gk.OP_QUERY:
            col = cols[x >> 16][x & 0xFFFF]
            res = torch.roll(col, -y * rot_scale, dims=0)
        elif op == gk.OP_CONST:
            res = consts[x].expand(n, 16)
        elif op == gk.OP_NEG:
            res = fsub(df, torch.zeros_like(a), a)
        elif op == gk.OP_ADD:
            res = fadd(df, a, b)
        elif op == gk.OP_MUL:
            res = fmul(df, a, b)
        else:
            res = fmul(df, a, consts[y])
        if not word & gk.OPF_KEEP:
            slots[dst] = res
        last = res
    return acc


def test_table16_tape_order_and_register_flags():
    """compile_chunk on Table16's whole gate set and its 400-node chunks:
    the tape in Sethi-Ullman order needs at most 60 slots (61 in
    evaluation order), its register flags mark every operand that the
    previous instruction made (and a KEEP result is read by the next
    instruction alone), and the tape run with the flags honoured, as the
    kernel runs it, equals the plain interpreter over 32 random rows."""
    n, rot_scale, y = 32, 2, 0xABCDEF
    rcs, cs = _configured("table16")
    compress_selectors(cs, [[False] * 64] * cs.num_selectors)
    whole = compile_chunk([e for g in cs.gates for e in g.polys])
    assert whole.n_slots <= 60
    df = FP_DEV
    cols = [[torch.from_numpy(c) for c in _rand_cols(df, count, n, 40 + i)]
            for i, count in enumerate((cs.num_advice_columns,
                                       cs.num_fixed_columns,
                                       cs.num_instance_columns))]
    y_m = df.scalar(y, "cpu")
    tapes = [whole] + [compile_chunk(c) for c in prover.gate_chunks(cs, 400)]
    assert max(t.n_slots for t in tapes[1:]) <= 21
    flagged = 0
    for tape in tapes:
        for i, (word, dst, x, y_) in enumerate(tape.code):
            op = word & gk.OP_MASK
            assert word & ~(gk.OP_MASK | gk.OPF_KEEP | gk.OPF_X_LAST
                            | gk.OPF_Y_LAST) == 0 and op <= gk.OP_FOLD
            if word & gk.OPF_KEEP:
                nxt = tape.code[i + 1][0]
                assert op != gk.OP_FOLD and nxt & (gk.OPF_X_LAST
                                                   | gk.OPF_Y_LAST)
            flagged += bool(word & (gk.OPF_X_LAST | gk.OPF_Y_LAST))
        yk = df.scalar(pow(y, tape.n_polys, df.spec.modulus), "cpu")
        want = gk.run_chunk_plain(df, tape, None, *cols, rot_scale, y_m, yk,
                                  n)
        got = _run_with_register_flags(df, tape, cols, rot_scale, y_m, n)
        assert torch.equal(got, want)
    assert flagged >= 700
