"""Fiat–Shamir transcript: Blake2b-512, byte-compatible with the reference.

Reproduces halo2_proofs/src/transcript.rs exactly:
  - state: BLAKE2b, digest 64, personalization b"Halo2-Transcript" (:78,163)
  - domain-prefixes: CHALLENGE=0, POINT=1, SCALAR=2 (:13-20)
  - squeeze_challenge finalizes a *clone* of the running state (:120-126)
  - points absorbed as affine x||y 32-byte LE reprs (identity is an error,
    :128-140); scalars as 32-byte LE reprs
  - Challenge255: scalar = from_uniform_bytes(64) (:272-304)
  - proof stream: points compressed 32 bytes, scalars 32 bytes LE

The transcript is host work by design: it is O(proof size), strictly
sequential (each challenge gates the next prover phase), and must be
bit-exact — all O(n) work stays on device between squeezes.

Beside it, the algebraic transcript (PoseidonTranscriptWrite/Read): the
same wire format, challenges squeezed from a Poseidon duplex sponge over
the scalar field (gadgets/poseidon).

Copied from halo2_tpu/transcript.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import hashlib
import io

from .curves.host import CurveSpec, Point

BLAKE2B_PREFIX_CHALLENGE = b"\x00"
BLAKE2B_PREFIX_POINT = b"\x01"
BLAKE2B_PREFIX_SCALAR = b"\x02"


class TranscriptError(Exception):
    pass


class _TranscriptBase:
    def __init__(self, curve: CurveSpec):
        self.curve = curve
        self.state = hashlib.blake2b(digest_size=64,
                                     person=b"Halo2-Transcript")

    def common_point(self, point: Point) -> None:
        self.state.update(BLAKE2B_PREFIX_POINT)
        if point is None:
            raise TranscriptError(
                "cannot write points at infinity to the transcript")
        x, y = point
        self.state.update(self.curve.base.to_repr(x))
        self.state.update(self.curve.base.to_repr(y))

    def common_scalar(self, scalar: int) -> None:
        self.state.update(BLAKE2B_PREFIX_SCALAR)
        self.state.update(self.curve.scalar.to_repr(scalar))

    def squeeze_challenge(self) -> int:
        """Returns the challenge as a scalar-field int
        (Challenge255 -> get_scalar)."""
        self.state.update(BLAKE2B_PREFIX_CHALLENGE)
        digest = self.state.copy().digest()
        return self.curve.scalar.from_uniform_bytes(digest)


class TranscriptWrite(_TranscriptBase):
    """Prover-side transcript writing the proof byte stream."""

    def __init__(self, curve: CurveSpec):
        super().__init__(curve)
        self.buf = io.BytesIO()

    def write_point(self, point: Point) -> None:
        self.common_point(point)
        self.buf.write(self.curve.to_bytes(point))

    def write_scalar(self, scalar: int) -> None:
        self.common_scalar(scalar)
        self.buf.write(self.curve.scalar.to_repr(scalar))

    def finalize(self) -> bytes:
        return self.buf.getvalue()


class TranscriptRead(_TranscriptBase):
    """Verifier-side transcript replaying a proof byte stream."""

    def __init__(self, curve: CurveSpec, proof: bytes):
        super().__init__(curve)
        self.buf = io.BytesIO(proof)

    def read_point(self) -> Point:
        data = self.buf.read(32)
        if len(data) != 32:
            raise TranscriptError("proof truncated reading point")
        point = self.curve.from_bytes(data)
        if point is False:
            raise TranscriptError("invalid point encoding in proof")
        self.common_point(point)
        return point

    def read_scalar(self) -> int:
        data = self.buf.read(32)
        if len(data) != 32:
            raise TranscriptError("proof truncated reading scalar")
        scalar = self.curve.scalar.from_repr(data)
        if scalar is None:
            raise TranscriptError("invalid field element encoding in proof")
        self.common_scalar(scalar)
        return scalar

    def read_n_points(self, n: int) -> list[Point]:
        return [self.read_point() for _ in range(n)]

    def read_n_scalars(self, n: int) -> list[int]:
        return [self.read_scalar() for _ in range(n)]

    def assert_consumed(self) -> None:
        if self.buf.read(1) != b"":
            raise TranscriptError("proof has trailing bytes")


# ---------------------------------------------------------------------------
# Algebraic (Poseidon) transcript
# ---------------------------------------------------------------------------
#
# The reference transcript traits are deliberately hash-agnostic
# (halo2_proofs/src/transcript.rs:23-62) so an algebraic sponge can
# replace Blake2b — the recursion-friendly option (challenges become
# cheap to recompute inside a circuit). There is no reference byte
# oracle for a Poseidon transcript; the contract is self-consistency
# (prove/verify with the same transcript family) plus the SAME proof
# wire format as Blake2b (compressed 32-byte points, 32-byte LE
# scalars), so proof sizes are identical and only challenge derivation
# differs.
#
# Design: duplex sponge over the curve's SCALAR field with the
# P128Pow5T3 spec (width 3, rate 2, x^5). Scalars are absorbed
# directly; point coordinates (base field) are absorbed reduced mod the
# scalar modulus (the standard native-transcript embedding). Each
# squeeze adds a domain tag to the CAPACITY element (outside the
# rate-absorbed data stream, so data absorbs and squeeze boundaries
# are injectively separated), drains the pending buffer in rate-sized
# chunks through the permutation, and emits state[0] — consecutive
# squeezes stay distinct and every absorbed element gates every later
# challenge, mirroring the Blake2b ratchet structure.

_POSEIDON_CHALLENGE_TAG = 1 << 65  # > any u64 length tag


class _PoseidonTranscriptBase:
    def __init__(self, curve: CurveSpec):
        from .gadgets.poseidon.primitive import P128Pow5T3
        self.curve = curve
        self.fs = curve.scalar
        self._spec = P128Pow5T3()
        rc, mds, _ = self._spec.constants(self.fs)
        self._rc, self._mds = rc, mds
        self._rate = self._spec.rate
        self._state = [0] * self._spec.t
        self._state[self._rate] = (
            int.from_bytes(b"Halo2-Transcript", "little") % self.fs.modulus)
        self._buffer: list[int] = []

    def _drain(self):
        from .gadgets.poseidon.primitive import permute
        buf = self._buffer or [0]
        self._buffer = []
        p = self.fs.modulus
        for i in range(0, len(buf), self._rate):
            for j, v in enumerate(buf[i:i + self._rate]):
                self._state[j] = (self._state[j] + v) % p
            self._state = permute(self.fs, self._spec, self._state,
                                  self._mds, self._rc)

    def common_point(self, point: Point) -> None:
        if point is None:
            raise TranscriptError(
                "cannot write points at infinity to the transcript")
        x, y = point
        q = self.fs.modulus
        self._buffer.extend([x % q, y % q])

    def common_scalar(self, scalar: int) -> None:
        self._buffer.append(scalar % self.fs.modulus)

    def squeeze_challenge(self) -> int:
        # capacity-slot tag: squeeze boundaries never collide with any
        # rate-absorbed data element
        self._state[self._rate] = (
            self._state[self._rate] + _POSEIDON_CHALLENGE_TAG
        ) % self.fs.modulus
        self._drain()
        return self._state[0]


class PoseidonTranscriptWrite(_PoseidonTranscriptBase):
    """Prover-side algebraic transcript (same wire format as
    TranscriptWrite)."""

    def __init__(self, curve: CurveSpec):
        super().__init__(curve)
        self.buf = io.BytesIO()

    def write_point(self, point: Point) -> None:
        self.common_point(point)
        self.buf.write(self.curve.to_bytes(point))

    def write_scalar(self, scalar: int) -> None:
        self.common_scalar(scalar)
        self.buf.write(self.curve.scalar.to_repr(scalar))

    def finalize(self) -> bytes:
        return self.buf.getvalue()


class PoseidonTranscriptRead(_PoseidonTranscriptBase):
    """Verifier-side algebraic transcript."""

    def __init__(self, curve: CurveSpec, proof: bytes):
        super().__init__(curve)
        self.buf = io.BytesIO(proof)

    def read_point(self) -> Point:
        data = self.buf.read(32)
        if len(data) != 32:
            raise TranscriptError("proof truncated reading point")
        point = self.curve.from_bytes(data)
        if point is False:
            raise TranscriptError("invalid point encoding in proof")
        self.common_point(point)
        return point

    def read_scalar(self) -> int:
        data = self.buf.read(32)
        if len(data) != 32:
            raise TranscriptError("proof truncated reading scalar")
        scalar = self.curve.scalar.from_repr(data)
        if scalar is None:
            raise TranscriptError("invalid field element encoding in proof")
        self.common_scalar(scalar)
        return scalar

    def read_n_points(self, n: int) -> list[Point]:
        return [self.read_point() for _ in range(n)]

    def read_n_scalars(self, n: int) -> list[int]:
        return [self.read_scalar() for _ in range(n)]

    def assert_consumed(self) -> None:
        if self.buf.read(1) != b"":
            raise TranscriptError("proof has trailing bytes")
