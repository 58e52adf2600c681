"""Sinsemilla hash primitive (off-circuit).

Reference: the external `sinsemilla 0.1` crate used by halo2_gadgets
(re-exported as halo2_gadgets::sinsemilla::primitives), implementing the
Zcash protocol spec §5.4.1.9:

  k = 10, c = 253
  Q(D)  = GroupHash^P("z.cash:SinsemillaQ", D)
  S(j)  = GroupHash^P("z.cash:SinsemillaS", I2LEOSP_32(j))
  Acc_0 = Q(D);  Acc_{i+1} = (Acc_i ⸭ S(m_i)) ⸭ Acc_i   (incomplete adds)
  SinsemillaHashToPoint(D, M) = Acc_n ; SinsemillaHash = extract_x

GroupHash here is our derived-isogeny SSWU hash_to_curve
(curves/sswu.py; bit-parity with pasta tracked in PARITY.md).
CommitDomain: Commit_r(D, M) = HashToPoint(D||"-M", M) + [r]·R where
R = GroupHash(D||"-r", "").

Copied from halo2_tpu/gadgets/sinsemilla/primitive.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import functools

from ...curves.host import PALLAS, Point
from ...curves.sswu import hash_to_curve
from ..utilities import lebs2ip

K = 10
C = 253
Q_PERSONALIZATION = "z.cash:SinsemillaQ"
S_PERSONALIZATION = "z.cash:SinsemillaS"


class HashError(Exception):
    """Incomplete-addition exceptional case hit (probability ~2^-n)."""


def _incomplete_add(p: Point, q: Point) -> Point:
    """⸭: fails on identity operands, doubling, and inverses."""
    if p is None or q is None:
        raise HashError("identity in incomplete addition")
    if p[0] == q[0]:
        raise HashError("x collision in incomplete addition")
    return PALLAS.add(p, q)


@functools.lru_cache(maxsize=None)
def sinsemilla_s(j: int) -> Point:
    assert 0 <= j < (1 << K)
    return hash_to_curve(PALLAS, S_PERSONALIZATION,
                         int(j).to_bytes(4, "little"))


@functools.lru_cache(maxsize=None)
def sinsemilla_q(domain: str) -> Point:
    return hash_to_curve(PALLAS, Q_PERSONALIZATION, domain.encode())


def pad_bits(bits: list[bool]) -> list[bool]:
    """Zero-pad to a multiple of K bits."""
    rem = (-len(bits)) % K
    return list(bits) + [False] * rem


def bits_to_words(bits: list[bool]) -> list[int]:
    bits = pad_bits(bits)
    assert len(bits) // K <= C
    return [lebs2ip(bits[i:i + K]) for i in range(0, len(bits), K)]


def hash_to_point(domain: str, bits: list[bool]) -> Point:
    acc = sinsemilla_q(domain)
    for word in bits_to_words(bits):
        acc = _incomplete_add(_incomplete_add(acc, sinsemilla_s(word)), acc)
    return acc


def hash_value(domain: str, bits: list[bool]) -> int:
    """SinsemillaHash = extract_P_x (x-coordinate; identity -> 0)."""
    pt = hash_to_point(domain, bits)
    return 0 if pt is None else pt[0]


class HashDomain:
    def __init__(self, domain: str):
        self.domain = domain
        self.Q = sinsemilla_q(domain)

    def hash_to_point(self, bits: list[bool]) -> Point:
        return hash_to_point(self.domain, bits)

    def hash(self, bits: list[bool]) -> int:
        return hash_value(self.domain, bits)


class CommitDomain:
    """Commit_r(D, M) = HashToPoint(D||"-M", M) + [r]·GroupHash(D||"-r","")."""

    def __init__(self, domain: str):
        self.M = HashDomain(domain + "-M")
        self.R = hash_to_curve(PALLAS, domain + "-r", b"")

    def commit(self, bits: list[bool], r: int) -> Point:
        return PALLAS.add(self.M.hash_to_point(bits), PALLAS.mul(self.R, r))

    def short_commit(self, bits: list[bool], r: int) -> int:
        pt = self.commit(bits, r)
        return 0 if pt is None else pt[0]
