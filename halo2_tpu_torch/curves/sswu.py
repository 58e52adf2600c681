"""Simplified-SWU hash-to-curve for the Pasta curves (host-side).

Used to generate the transparent SRS: `hash_to_curve("Halo2-Parameters")`
with 5-byte messages [0, i_le4] plus w = hash([1]), u = hash([2])
(halo2_proofs/src/poly/commitment.rs:38-114).

Construction (matching pasta_curves 0.5.1 structurally):
  1. expand_message_xmd with BLAKE2b-512 (64-byte blocks, 128-byte rate),
     DST = "{domain_prefix}-{curve_id}_XMD:BLAKE2b_SSWU_RO_", producing two
     64-byte chunks, each reduced little-endian into the base field
     (from_uniform_bytes).
  2. map_to_curve_simple_swu onto the 3-isogenous curve
     E': y^2 = x^3 + a'x + b' with Z = -13.
  3. add the two E' points, then apply the degree-3 isogeny E' -> E.

The iso-curve and isogeny are DERIVED here at import time via Velu's
formulas rather than hardcoded: a kernel x0 with x0^3 = -20 on E gives
E' = (a' = -30*x0^2, b' = 1265); the dual isogeny from E' has a unique
rational kernel and image y^2 = x^3 + 5*3^6, closed by the isomorphism
u = 1/3.  Two normalization freedoms exist and are pinned to pasta's
published choices:
  * which cube root of -20 (three kernels, all with b' = 1265 but a'
    differing by zeta_3 factors): selected so a' equals pasta's published
    iso-curve A constant (ISO_A below).
  * the sign of the closing isomorphism: u = +1/3.
With these pins the derived rational map was checked to agree with
pasta_curves' published 13 ISOGENY_CONSTANTS on both coordinates for
random E'(Fp) points (iso-Pallas), i.e. the map is byte-identical, not
merely isomorphic.

Copied unchanged from halo2_tpu/curves/sswu.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import functools
import hashlib

from ..fields.host import FieldSpec, FP, FQ
from .host import CurveSpec, PALLAS, VESTA, Point


# pasta_curves' published iso-curve A coefficients (hashtocurve constants;
# IsoEp::a / IsoEq::a).  Used only to SELECT among the three Velu kernel
# cube roots — everything else is derived.  b' = 1265 for both curves.
ISO_A = {
    "pallas": 0x18354a2eb0ea8c9c49be2d7258370742b74134581a27a59f92bb4b0b657a014b,
    "vesta": 0x267f9b2ee592271a81639c4d96f787739673928c7d01b212c515ad7242eaa6b1,
}


def _cbrt(spec: FieldSpec, v: int) -> int | None:
    p = spec.modulus
    v %= p
    if v == 0:
        return 0
    if pow(v, (p - 1) // 3, p) != 1:
        return None
    e = p - 1
    t3 = 0
    while e % 3 == 0:
        e //= 3
        t3 += 1
    k = pow(3, -1, e)
    r0 = pow(v, k, p)
    g = 2
    while pow(g, (p - 1) // 3, p) == 1:
        g += 1
    G = pow(g, e, p)
    for j in range(3 ** t3):
        r = r0 * pow(G, j, p) % p
        if pow(r, 3, p) == v:
            return r
    return None


class SswuParams:
    """Derived SSWU + isogeny constants for one Pasta curve."""

    def __init__(self, curve: CurveSpec):
        self.curve = curve
        f = curve.base
        p = f.modulus
        # --- iso-curve E' via Velu from E with kernel x0, x0^3 = -20 ---
        # Three cube roots -> three kernels; pick the one whose Velu
        # codomain A matches pasta's published constant (see ISO_A).
        x0 = _cbrt(f, -20)
        assert x0 is not None
        zeta = f.zeta
        for _ in range(3):
            if (-30 * x0 * x0) % p == ISO_A[curve.name]:
                break
            x0 = x0 * zeta % p
        t = 6 * x0 * x0 % p
        u = 4 * ((x0 ** 3 + curve.b) % p) % p
        w = (u + x0 * t) % p
        self.iso_a = (-5 * t) % p
        self.iso_b = (curve.b - 7 * w) % p
        assert self.iso_a == ISO_A[curve.name]
        assert self.iso_b == 1265  # pasta's published iso-curve constant
        # --- dual isogeny E' -> E: rational kernel root on E' ---
        x1 = self._rational_kernel_root()
        self.ker_x = x1
        y1sq = (x1 ** 3 + self.iso_a * x1 + self.iso_b) % p
        self.velu_t = 2 * (3 * x1 * x1 + self.iso_a) % p
        self.velu_u = 4 * y1sq % p
        # image curve must be y^2 = x^3 + b * 3^6; closing iso u = 1/3
        a2 = (self.iso_a - 5 * self.velu_t) % p
        b2 = (self.iso_b - 7 * (self.velu_u + x1 * self.velu_t)) % p
        assert a2 == 0 and b2 == curve.b * 729 % p
        self.inv9 = pow(9, p - 2, p)
        self.inv27 = pow(27, p - 2, p)
        # --- SSWU Z: pasta uses -13 for both curves; verify suitability ---
        self.z = (-13) % p
        assert not f.is_square(self.z)
        gzb = self._g_iso(self.iso_b * pow(self.z * self.iso_a % p, p - 2, p))
        assert f.is_square(gzb)

    def _g_iso(self, x: int) -> int:
        p = self.curve.base.modulus
        return (x * x % p * x + self.iso_a * x + self.iso_b) % p

    def _rational_kernel_root(self) -> int:
        """Unique rational root of the 3-division polynomial of E'."""
        f = self.curve.base
        p = f.modulus
        a, b = self.iso_a, self.iso_b
        psi3 = [(-a * a) % p, (12 * b) % p, (6 * a) % p, 0, 3]

        def polymod(A, B):
            A = A[:]
            db = len(B) - 1
            inv = pow(B[-1], p - 2, p)
            while len(A) - 1 >= db and any(A):
                if A[-1] == 0:
                    A.pop()
                    continue
                c = A[-1] * inv % p
                sh = len(A) - 1 - db
                for i, bc in enumerate(B):
                    A[sh + i] = (A[sh + i] - c * bc) % p
                A.pop()
            return A if any(A) else [0]

        def polymulmod(A, B, M):
            out = [0] * (len(A) + len(B) - 1)
            for i, xx in enumerate(A):
                if xx:
                    for j, yy in enumerate(B):
                        out[i + j] = (out[i + j] + xx * yy) % p
            return polymod(out, M)

        res, base, e = [1], [0, 1], p
        while e:
            if e & 1:
                res = polymulmod(res, base, psi3)
            base = polymulmod(base, base, psi3)
            e >>= 1
        while len(res) < 2:
            res.append(0)
        res[1] = (res[1] - 1) % p  # x^p - x

        A, B = [x % p for x in psi3], res
        while any(B):
            A = polymod(A, B)
            A, B = B, A
        assert len(A) == 2, "expected exactly one rational 3-torsion x on E'"
        return (-A[0]) * pow(A[1], p - 2, p) % p

    # ------------- the maps -------------
    def map_to_iso(self, u: int) -> tuple[int, int]:
        """Simplified SWU: field element -> point on E' (never identity)."""
        f = self.curve.base
        p = f.modulus
        A, B, Z = self.iso_a, self.iso_b, self.z
        tv1 = Z * u % p * u % p           # Z u^2
        tv2 = tv1 * tv1 % p               # Z^2 u^4
        den = (tv1 + tv2) % p
        if den == 0:
            x1 = B * pow(Z * A % p, p - 2, p) % p
        else:
            x1 = (-B * pow(A, p - 2, p)) % p * (1 + pow(den, p - 2, p)) % p
        gx1 = self._g_iso(x1)
        if f.is_square(gx1):
            x, y = x1, f.sqrt(gx1)
        else:
            x2 = tv1 * x1 % p
            gx2 = self._g_iso(x2)
            x, y = x2, f.sqrt(gx2)
            assert y is not None
        if (y & 1) != (u & 1):            # sgn0 match (parity)
            y = p - y
        return (x, y)

    def iso_map(self, pt: tuple[int, int] | None) -> Point:
        """Degree-3 isogeny E' -> E: Velu X-map composed with (x,y) ->
        (x/9, y/27). Normalized, so Y = y * X'(x)."""
        if pt is None:
            return None
        f = self.curve.base
        p = f.modulus
        x, y = pt
        d = (x - self.ker_x) % p
        if d == 0:
            return None  # kernel -> identity
        dinv = pow(d, p - 2, p)
        # X(x) = x + t/d + u/d^2 ; X'(x) = 1 - t/d^2 - 2u/d^3
        X = (x + self.velu_t * dinv + self.velu_u * dinv * dinv) % p
        Xp = (1 - self.velu_t * dinv % p * dinv
              - 2 * self.velu_u * pow(dinv, 3, p)) % p
        return (X * self.inv9 % p, y * Xp % p * self.inv27 % p)

    # ------------- hash to field / curve -------------
    def expand_message_xmd(self, msg: bytes, dst: bytes,
                           len_in_bytes: int) -> bytes:
        """RFC 9380 §5.3.1 expand_message_xmd with BLAKE2b-512
        (b = 64 bytes, block = 128 bytes)."""
        b_in_bytes = 64
        r_in_bytes = 128
        ell = -(-len_in_bytes // b_in_bytes)
        assert ell <= 255 and len(dst) <= 255
        dst_prime = dst + bytes([len(dst)])
        z_pad = bytes(r_in_bytes)
        l_i_b = len_in_bytes.to_bytes(2, "big")
        b0 = hashlib.blake2b(
            z_pad + msg + l_i_b + b"\x00" + dst_prime,
            digest_size=64).digest()
        bvals = []
        prev = hashlib.blake2b(b0 + b"\x01" + dst_prime,
                               digest_size=64).digest()
        bvals.append(prev)
        for i in range(2, ell + 1):
            xored = bytes(a ^ b for a, b in zip(b0, prev))
            prev = hashlib.blake2b(xored + bytes([i]) + dst_prime,
                                   digest_size=64).digest()
            bvals.append(prev)
        return b"".join(bvals)[:len_in_bytes]

    def hash_to_field(self, domain_prefix: str, msg: bytes) -> tuple[int, int]:
        """pasta quirk: each 64-byte BLAKE2b chunk is REVERSED (treated as
        big-endian) before the little-endian from_uniform_bytes reduction
        (pasta_curves hashtocurve.rs `little.reverse()`).  Verified against
        the reference's plonk_api vk commitments: with the reversal our
        Vesta w = hash([1]) equals the golden fixed commitment byte-exactly
        (tests/test_plonk_api_parity.py)."""
        dst = (domain_prefix + "-" + self.curve.name +
               "_XMD:BLAKE2b_SSWU_RO_").encode()
        uniform = self.expand_message_xmd(msg, dst, 128)
        f = self.curve.base
        return (f.from_uniform_bytes(uniform[:64][::-1]),
                f.from_uniform_bytes(uniform[64:][::-1]))

    def hash_to_curve(self, domain_prefix: str, msg: bytes) -> Point:
        u0, u1 = self.hash_to_field(domain_prefix, msg)
        q0 = self.map_to_iso(u0)
        q1 = self.map_to_iso(u1)
        # add on E' then apply the isogeny once
        s = _iso_add(self.curve.base, self.iso_a, q0, q1)
        return self.iso_map(s)


def _iso_add(f: FieldSpec, a: int, p1, p2):
    """Affine addition on E': y^2 = x^3 + a x + b."""
    p = f.modulus
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + a) * pow(2 * y1, p - 2, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


@functools.lru_cache(maxsize=None)
def sswu_params(curve_name: str) -> SswuParams:
    return SswuParams(PALLAS if curve_name == "pallas" else VESTA)


def hash_to_curve(curve: CurveSpec, domain_prefix: str, msg: bytes) -> Point:
    """Native (C++) fast path with the pure-Python map as fallback and
    behavior oracle (tests/test_native.py cross-checks the two)."""
    import os
    if not os.environ.get("HALO2_TPU_NO_NATIVE") and len(msg) <= 64:
        from . import native
        pt = native.native_hash_to_curve(curve, domain_prefix, msg)
        if pt is not False:
            return pt
    return sswu_params(curve.name).hash_to_curve(domain_prefix, msg)
