"""Host-side (Python int) prime-field arithmetic for the Pasta fields.

This is the orchestration-side twin of :mod:`halo2_tpu.fields.device`: the
transcript, challenge derivation, circuit synthesis and all O(1)/O(k) host
work use these exact-integer field elements, while all O(n) work runs on
device limb arrays.

Reference behavior being reproduced (structure, not code):
  - pasta_curves 0.5.1 Fp/Fq (moduli pinned in
    halo2_proofs/tests/plonk_api.rs:591-592)
  - ff::PrimeField constants: S (2-adicity), ROOT_OF_UNITY, DELTA, ZETA,
    TWO_INV used by halo2_proofs/src/poly/domain.rs:56-111 and
    plonk/permutation/keygen.rs:131.

Copied unchanged from halo2_tpu/fields/host.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

# Pasta moduli (255-bit). Fp is the Pallas base field == Vesta scalar
# field; Fq is the Vesta base field == Pallas scalar field. (Orientation
# pinned by halo2_poseidon/src/p128pow5t3.rs:156 — the Fp permutation's
# sage vector uses the 0x..094cf91b.. prime — and by the EqAffine(=Vesta)
# moduli in halo2_proofs/tests/plonk_api.rs:591-592.)
P_MOD = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
Q_MOD = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field with the ff-style constants the
    proving system needs (domain.rs:56-111, permutation/keygen.rs:131)."""

    name: str
    modulus: int
    generator: int  # multiplicative generator of F*
    s: int  # 2-adicity: modulus - 1 = t * 2^s with t odd

    @functools.cached_property
    def t_odd(self) -> int:
        return (self.modulus - 1) >> self.s

    @functools.cached_property
    def root_of_unity(self) -> int:
        # ROOT_OF_UNITY = generator^t, a primitive 2^s-th root of unity.
        return pow(self.generator, self.t_odd, self.modulus)

    @functools.cached_property
    def root_of_unity_inv(self) -> int:
        return pow(self.root_of_unity, self.modulus - 2, self.modulus)

    @functools.cached_property
    def delta(self) -> int:
        # ff convention: DELTA = generator^(2^s), generates the t-order group.
        return pow(self.generator, 1 << self.s, self.modulus)

    @functools.cached_property
    def zeta(self) -> int:
        # Cube root of unity (WithSmallOrderMulGroup<3>).  Two primitive
        # roots exist; pasta's published ZETA constants are g^(2(p-1)/3)
        # for Fp and g^((q-1)/3) for Fq.  The Fp orientation is proven by
        # the plonk_api golden vk (its lookup table commits 2834758237 *
        # Fp::ZETA; tests/test_plonk_api_parity.py), and the Fq
        # orientation then follows from the curve-endomorphism
        # consistency [Fq::ZETA]P = (Fp::ZETA * x, y) on Pallas, which
        # holds for exactly one pairing of the roots.
        e = 2 if self.name == "Fp" else 1
        z = pow(self.generator, e * (self.modulus - 1) // 3, self.modulus)
        assert pow(z, 3, self.modulus) == 1 and z != 1
        return z

    @functools.cached_property
    def two_inv(self) -> int:
        return pow(2, self.modulus - 2, self.modulus)

    # ---- scalar helpers (exact int arithmetic mod modulus) ----
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.modulus

    def neg(self, a: int) -> int:
        return (-a) % self.modulus

    def inv(self, a: int) -> int:
        if a % self.modulus == 0:
            raise ZeroDivisionError("field inversion of zero")
        return pow(a, self.modulus - 2, self.modulus)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def sqrt(self, a: int) -> int | None:
        """Tonelli–Shanks square root (s=32 makes p ≡ 1 mod 4); returns None
        if `a` is a non-residue. Deterministic: returns the root the
        algorithm produces; callers needing a canonical sign normalize."""
        p = self.modulus
        a %= p
        if a == 0:
            return 0
        if not self.is_square(a):  # Jacobi — far cheaper than Euler pow
            return None
        # Tonelli-Shanks with the field's own 2-adic generator.
        m = self.s
        c = pow(self.generator, self.t_odd, p)  # order 2^s
        t = pow(a, self.t_odd, p)
        r = pow(a, (self.t_odd + 1) // 2, p)
        while t != 1:
            # find least i, 0 < i < m, with t^(2^i) == 1
            i, t2i = 0, t
            while t2i != 1:
                t2i = t2i * t2i % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m = i
            c = b * b % p
            t = t * c % p
            r = r * b % p
        return r

    def is_square(self, a: int) -> bool:
        """Quadratic-residue test via the binary Jacobi symbol — ~100x
        faster than the Euler-criterion pow for 255-bit p (the fixed-base
        z/u search in gadgets/ecc/constants.py does ~10^5 of these per
        window)."""
        a %= self.modulus
        if a == 0:
            return True
        n = self.modulus
        t = 1
        while a != 0:
            while a % 2 == 0:
                a //= 2
                if n % 8 in (3, 5):
                    t = -t
            a, n = n, a
            if a % 4 == 3 and n % 4 == 3:
                t = -t
            a %= n
        return t == 1  # n is prime, so gcd>1 cannot occur for a != 0

    # ---- canonical 32-byte little-endian repr (ff::PrimeField::Repr) ----
    def to_repr(self, a: int) -> bytes:
        return (a % self.modulus).to_bytes(32, "little")

    def from_repr(self, data: bytes) -> int | None:
        v = int.from_bytes(data, "little")
        return v if v < self.modulus else None

    def from_uniform_bytes(self, data: bytes) -> int:
        """ff::FromUniformBytes<64>: interpret 64 LE bytes, reduce mod p.
        Used by Challenge255 (halo2_proofs/src/transcript.rs:272-304)."""
        assert len(data) == 64
        return int.from_bytes(data, "little") % self.modulus

    def rand(self, rng) -> int:
        """Sample uniformly via rejection from a python random.Random-like
        rng with getrandbits (mirrors Field::random over 512 bits)."""
        return rng.getrandbits(512) % self.modulus


# The two Pasta fields. Multiplicative generator is 5 for both (pasta_curves).
FP = FieldSpec(name="Fp", modulus=P_MOD, generator=5, s=32)
FQ = FieldSpec(name="Fq", modulus=Q_MOD, generator=5, s=32)


def batch_invert(spec: FieldSpec, values: list[int]) -> list[int]:
    """Montgomery batch inversion; zeros map to zero (matches the semantics
    of ff batch_invert used by batch_invert_assigned, poly.rs:135-162)."""
    p = spec.modulus
    prefix = []
    acc = 1
    for v in values:
        prefix.append(acc)
        if v % p != 0:
            acc = acc * v % p
    inv = pow(acc, p - 2, p)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        v = values[i] % p
        if v != 0:
            out[i] = inv * prefix[i] % p
            inv = inv * v % p
    return out
