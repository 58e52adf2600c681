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

Copied from halo2_tpu/transcript.py (Blake2b transcript only; the Poseidon
transcript needs the gadget package, which the port does not carry yet).
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

