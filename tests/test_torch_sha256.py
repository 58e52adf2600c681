"""SHA-256 in the port against the JAX package, on the CPU, bit for bit.

- the host primitives (compress_host, sha256_host and Table16's spread
  helpers) over seeded random inputs;
- Table16's bench circuit (halo2's benches/sha256.rs, 31 words) and its
  two-block circuit at K = 17, and the bit-decomposition chip's
  CompressCircuit at K = 14, synthesized by both packages' MockProver.run:
  equal advice, fixed and selector assignments, equal copies (the
  permutation mapping), equal pinned constraint systems (gates, lookups,
  selector compression) and digests equal to the host functions';
- CompressCircuit's copies are accepted and a wrong output word is
  rejected by the permutation stream, as the reference's test rejects
  it (its gates at K = 14 are checked on the card).

The reference's bench circuit is the one reference_proof_hash.py
--circuit sha256 builds and proves. No K = 17 host verify() and no
K = 17 prove: the reference's tests/test_table16.py runs the host checker
once, and the card proves the bench circuit (chip_smoke.py [sha256])
against the JAX package's recorded proof hash."""
import hashlib
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.dev import MockProver as RMockProver
from halo2_tpu.gadgets import sha256 as rsha
from halo2_tpu.gadgets.sha256 import table16 as rtable16
from halo2_tpu.plonk.pinned import (pinned_cs_node as r_pinned_cs_node,
                                    render_alternate as r_render_alternate)

from halo2_tpu_torch import sha256_circuits as sc
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.gadgets import sha256 as sha
from halo2_tpu_torch.gadgets.sha256 import table16
from halo2_tpu_torch.plonk.pinned import pinned_cs_node, render_alternate

PORT_NS = sc.port_namespace()
REF_NS = sc.namespace(
    lambda mod: importlib.import_module(f"halo2_tpu.{mod}"))
SEED = 11


def _recorder():
    """reference_proof_hash.py, the root script that records the JAX
    package's proof hash."""
    path = Path(__file__).resolve().parents[1] / "reference_proof_hash.py"
    spec = importlib.util.spec_from_file_location("reference_proof_hash",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_host_primitives_match_reference():
    rng = np.random.default_rng(SEED)
    for _ in range(8):
        state = [int(w) for w in rng.integers(0, 1 << 32, 8)]
        block = [int(w) for w in rng.integers(0, 1 << 32, 16)]
        assert sha.compress_host(state, block) == rsha.compress_host(
            state, block)
        assert (sc.compress_rounds_only(state, block)
                == _ref_rounds_only(state, block))
    for size in (0, 3, 55, 56, 64, 119, 200):
        msg = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert sha.sha256_host(msg) == rsha.sha256_host(msg)
        assert sha.sha256_host(msg) == hashlib.sha256(msg).digest()
    for x in [int(v) for v in rng.integers(0, 1 << 16, 64)] + [
            0, 127, 128, 1023, 1024, 2047, 2048, 8191, 8192, 16383, 16384,
            0xFFFF]:
        assert table16.get_tag(x) == rtable16.get_tag(x)
        s = table16.spread_int(x)
        assert s == rtable16.spread_int(x)
        for f in ("even_bits_int", "odd_bits_int"):
            assert getattr(table16, f)(s, 16) == getattr(rtable16, f)(s, 16)
        assert (table16.negate_spread_int(s, 32)
                == rtable16.negate_spread_int(s, 32))
    assert (sha.IV, sha.ROUND_CONSTANTS) == (rsha.IV, rsha.ROUND_CONSTANTS)


def _ref_rounds_only(state, block):
    """The raw rounds through the reference's own helpers: its
    compress_host less the feed-forward."""
    out = rsha.compress_host(state, block)
    return [(o - s) & 0xFFFFFFFF for o, s in zip(out, state)]


def _cells(col):
    return [v if isinstance(v, int) else (None if v is None else "poison")
            for v in col]


CIRCUITS = ["bench", "two_block", "compress"]


@pytest.fixture(scope="module", params=CIRCUITS)
def runs(request):
    """(name, port prover, port circuit, reference prover, reference
    circuit); pytest groups the tests by circuit, so one K = 17 pair is
    held at a time."""
    name = request.param
    out = [name]
    for ns, mock in ((PORT_NS, MockProver), (REF_NS, RMockProver)):
        if name == "compress":
            expected = sha.compress_host(list(sha.IV), sc.ABC_BLOCK)
            circuit = ns.classes.Compress(sc.ABC_BLOCK)
            out += [mock.run(sc.K_COMPRESS, circuit, [expected], fs=ns.FQ),
                    circuit]
        else:
            circuit = (_recorder().reference_circuit("sha256", 0)[2]
                       if ns is REF_NS and name == "bench"
                       else sc.table16_circuit(ns, name))
            out += [mock.run(sc.K_TABLE16, circuit, []), circuit]
    return tuple(out)


def test_recorder_builds_the_bench_circuit():
    """reference_proof_hash.py --circuit sha256 proves the JAX package's
    Table16 over the bench words at k = 17 over PALLAS, with no
    instance."""
    import halo2_tpu.circuit
    curve, k, circuit, instances, what = _recorder().reference_circuit(
        "sha256", 14)
    assert (curve, k, instances) == (R_PALLAS, sc.K_TABLE16, [[]])
    assert isinstance(circuit, halo2_tpu.circuit.Circuit)
    assert circuit.words == tuple(sc.table16_words("bench"))
    assert what == f"table16 words={sc.BENCH_WORDS}"


def test_assignments_match_reference(runs):
    _, port, _, ref, _ = runs
    assert port.n == ref.n and port.usable_rows == ref.usable_rows
    for attr in ("advice", "fixed"):
        got, want = getattr(port, attr), getattr(ref, attr)
        assert len(got) == len(want), attr
        for i, (a, b) in enumerate(zip(got, want)):
            assert _cells(a) == _cells(b), f"{attr}[{i}]"
    assert port.selectors == ref.selectors
    assert port.instance == ref.instance


def test_copies_match_reference(runs):
    _, port, _, ref, _ = runs
    assert ([str(c) for c in port.permutation.columns]
            == [str(c) for c in ref.permutation.columns])
    for attr in ("map_col", "map_row"):
        assert np.array_equal(getattr(port.permutation, attr),
                              getattr(ref.permutation, attr)), attr


def test_constraint_system_matches_reference(runs):
    _, port, _, ref, _ = runs
    assert (render_alternate(pinned_cs_node(port.cs))
            == r_render_alternate(r_pinned_cs_node(ref.cs)))
    assert port.cs.degree() == ref.cs.degree() == 9
    assert len(port.cs.gates) == len(ref.cs.gates)
    assert len(port.cs.lookups) == len(ref.cs.lookups)


def test_digest_matches_host_function(runs):
    """Table16: the digest words both packages assigned equal the raw
    rounds chained over the padded words; the chip: its instance (the
    output words it is constrained to) is compress_host's, whose framing
    is FIPS SHA-256."""
    name, port, circuit, ref, rcircuit = runs
    if name == "compress":
        expected = sha.compress_host(list(sha.IV), sc.ABC_BLOCK)
        assert port.instance == ref.instance == [expected]
        assert b"".join(w.to_bytes(4, "big") for w in expected) == \
            sha.sha256_host(b"abc")
    else:
        want = sc.chained_rounds(sc.table16_words(name))
        assert circuit.digest_out == rcircuit.digest_out == want


def test_raw_rounds_tie_to_fips():
    """raw("abc" block) + IV == sha256(b"abc")."""
    raw = sc.compress_rounds_only(list(sha.IV), sc.ABC_BLOCK)
    fips = sha.sha256_host(b"abc")
    assert bytes(b"".join(((r + iv) & 0xFFFFFFFF).to_bytes(4, "big")
                          for r, iv in zip(raw, sha.IV))) == fips


def test_compress_circuit_copies_accepted():
    """The permutation stream of both packages accepts the chip's
    compression of "abc" copied to its instance (its gates at K = 14 are
    checked on the card, chip_smoke.py [sha256]: the plain gate check
    takes about a minute of CPU)."""
    expected = sha.compress_host(list(sha.IV), sc.ABC_BLOCK)
    for ns, mock in ((PORT_NS, MockProver), (REF_NS, RMockProver)):
        prover = mock.run(sc.K_COMPRESS, ns.classes.Compress(sc.ABC_BLOCK),
                          [expected], fs=ns.FQ)
        assert prover.verify(streams=("permutation",)) == []


def test_compress_circuit_wrong_output_rejected():
    expected = sha.compress_host(list(sha.IV), sc.ABC_BLOCK)
    bad = [expected[0] ^ 1] + expected[1:]
    kinds = []
    for ns, mock in ((PORT_NS, MockProver), (REF_NS, RMockProver)):
        prover = mock.run(sc.K_COMPRESS, ns.classes.Compress(sc.ABC_BLOCK),
                          [bad], fs=ns.FQ)
        errors = prover.verify(streams=("permutation",))
        assert errors
        kinds.append([type(e).__name__ for e in errors])
    assert kinds[0] == kinds[1]
