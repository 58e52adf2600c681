"""Host-side (Python int) Pasta curve arithmetic: Pallas and Vesta.

Pallas: y^2 = x^3 + 5 over Fp, scalar field Fq, generator (-1, 2).
Vesta:  y^2 = x^3 + 5 over Fq, scalar field Fp, generator (-1, 2).
(The curve cycle the reference proving system is instantiated over;
pasta_curves 0.5.1, re-exported at halo2_proofs/src/arithmetic.rs:10.)

Points are (x, y) int tuples or None for the identity. Used for
orchestration-scale work (transcript point hashing, tests, small verifier
algebra); all O(n) point work runs on device (curves/device.py).

Copied unchanged from halo2_tpu/curves/host.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from ..fields.host import FP, FQ, FieldSpec

Point = tuple[int, int] | None  # affine; None = identity


@dataclass(frozen=True)
class CurveSpec:
    name: str
    base: FieldSpec     # coordinate field
    scalar: FieldSpec   # scalar field
    b: int = 5

    @property
    def generator(self) -> Point:
        return (self.base.modulus - 1, 2)

    def is_on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        p = self.base.modulus
        return (y * y - (x * x * x + self.b)) % p == 0

    def add(self, a: Point, b: Point) -> Point:
        p = self.base.modulus
        if a is None:
            return b
        if b is None:
            return a
        x1, y1 = a
        x2, y2 = b
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            return self.double(a)
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def double(self, a: Point) -> Point:
        if a is None:
            return None
        p = self.base.modulus
        x1, y1 = a
        if y1 == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, p) % p
        x3 = (lam * lam - 2 * x1) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def neg(self, a: Point) -> Point:
        if a is None:
            return None
        return (a[0], (-a[1]) % self.base.modulus)

    # ---- Jacobian internals (no per-op inversion; X/Z², Y/Z³) ----
    # Identity is Z == 0. Used by mul/msm so the host path costs ~16
    # multiplications per group op instead of a modular inversion.
    def _jdouble(self, P):
        X1, Y1, Z1 = P
        p = self.base.modulus
        if Z1 == 0 or Y1 == 0:
            return (1, 1, 0)
        A = X1 * X1 % p
        B = Y1 * Y1 % p
        C = B * B % p
        D = 2 * ((X1 + B) * (X1 + B) - A - C) % p
        E = 3 * A % p
        F = E * E % p
        X3 = (F - 2 * D) % p
        Y3 = (E * (D - X3) - 8 * C) % p
        Z3 = 2 * Y1 * Z1 % p
        return (X3, Y3, Z3)

    def _jadd(self, P, Q):
        p = self.base.modulus
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        if Z1 == 0:
            return Q
        if Z2 == 0:
            return P
        Z1Z1 = Z1 * Z1 % p
        Z2Z2 = Z2 * Z2 % p
        U1 = X1 * Z2Z2 % p
        U2 = X2 * Z1Z1 % p
        S1 = Y1 * Z2 % p * Z2Z2 % p
        S2 = Y2 * Z1 % p * Z1Z1 % p
        H = (U2 - U1) % p
        r = (S2 - S1) % p
        if H == 0:
            if r == 0:
                return self._jdouble(P)
            return (1, 1, 0)
        HH = H * H % p
        HHH = H * HH % p
        V = U1 * HH % p
        X3 = (r * r - HHH - 2 * V) % p
        Y3 = (r * (V - X3) - S1 * HHH) % p
        Z3 = Z1 * Z2 % p * H % p
        return (X3, Y3, Z3)

    def _jmixed(self, P, Q_affine):
        """P (Jacobian) + Q (affine, not identity)."""
        p = self.base.modulus
        X1, Y1, Z1 = P
        x2, y2 = Q_affine
        if Z1 == 0:
            return (x2, y2, 1)
        Z1Z1 = Z1 * Z1 % p
        U2 = x2 * Z1Z1 % p
        S2 = y2 * Z1 % p * Z1Z1 % p
        H = (U2 - X1) % p
        r = (S2 - Y1) % p
        if H == 0:
            if r == 0:
                return self._jdouble(P)
            return (1, 1, 0)
        HH = H * H % p
        HHH = H * HH % p
        V = X1 * HH % p
        X3 = (r * r - HHH - 2 * V) % p
        Y3 = (r * (V - X3) - Y1 * HHH) % p
        Z3 = Z1 * H % p
        return (X3, Y3, Z3)

    def _jnormalize(self, P) -> Point:
        X, Y, Z = P
        if Z == 0:
            return None
        p = self.base.modulus
        zinv = pow(Z, -1, p)
        zinv2 = zinv * zinv % p
        return (X * zinv2 % p, Y * zinv2 % p * zinv % p)

    def _jmul(self, a: Point, k: int):
        """[k]a in Jacobian (no final inversion)."""
        k %= self.scalar.modulus
        if a is None or k == 0:
            return (1, 1, 0)
        acc = (1, 1, 0)
        add = (a[0], a[1], 1)
        while k:
            if k & 1:
                acc = self._jadd(acc, add)
            k >>= 1
            if k:
                add = self._jdouble(add)
        return acc

    def _jbatch_normalize(self, pts) -> list:
        """Jacobian -> affine for a whole list with ONE inversion
        (Montgomery trick; arithmetic.rs batch_normalize analogue)."""
        p = self.base.modulus
        zs = [P[2] for P in pts]
        prefix = [1] * (len(zs) + 1)
        for i, z in enumerate(zs):
            prefix[i + 1] = prefix[i] * (z if z else 1) % p
        inv = pow(prefix[-1], -1, p)
        out = [None] * len(pts)
        for i in range(len(pts) - 1, -1, -1):
            X, Y, Z = pts[i]
            if Z == 0:
                out[i] = None
                continue
            zinv = inv * prefix[i] % p
            inv = inv * Z % p
            zinv2 = zinv * zinv % p
            out[i] = (X * zinv2 % p, Y * zinv2 % p * zinv % p)
        return out

    def mul(self, a: Point, k: int) -> Point:
        return self._jnormalize(self._jmul(a, k))

    def msm(self, scalars: list[int], points: list[Point]) -> Point:
        """Pippenger bucket MSM over Jacobian accumulators with mixed
        (affine-point) bucket adds; exact same result as the naive sum
        (group ops are exact, any schedule matches bit-for-bit).

        Routes through the native C++ library (curves/native.py) when
        available — the reference's compute layer is native Rust, and
        host-side group algebra (keygen commits, verifier final MSM)
        deserves the same; set HALO2_TPU_NO_NATIVE=1 to force the
        pure-Python path (the behavior oracle)."""
        import math
        import os
        if len(points) > 8 and not os.environ.get("HALO2_TPU_NO_NATIVE"):
            from .native import native_msm
            res = native_msm(self, scalars, points)
            if res is not False:
                return res
        pairs = [(s % self.scalar.modulus, pt)
                 for s, pt in zip(scalars, points)
                 if pt is not None and s % self.scalar.modulus != 0]
        if not pairs:
            return None
        n = len(pairs)
        c = max(3, int(math.ceil(math.log(n)))) if n > 4 else 2
        windows = (255 // c) + 1
        acc = (1, 1, 0)
        for w in reversed(range(windows)):
            for _ in range(c if w != windows - 1 else 0):
                acc = self._jdouble(acc)
            buckets = [(1, 1, 0)] * ((1 << c) - 1)
            shift = c * w
            mask = (1 << c) - 1
            for s, pt in pairs:
                digit = (s >> shift) & mask
                if digit:
                    buckets[digit - 1] = self._jmixed(buckets[digit - 1],
                                                      pt)
            # suffix-sum summation by parts
            running = (1, 1, 0)
            win_sum = (1, 1, 0)
            for b in reversed(buckets):
                running = self._jadd(running, b)
                win_sum = self._jadd(win_sum, running)
            if w == windows - 1:
                acc = win_sum
            else:
                acc = self._jadd(acc, win_sum)
        return self._jnormalize(acc)

    # ---- compressed 32-byte encoding (pasta_curves format) ----
    # x in 32 LE bytes; top bit of byte 31 = parity of y; identity = zeros.
    def to_bytes(self, pt: Point) -> bytes:
        if pt is None:
            return bytes(32)
        x, y = pt
        data = bytearray(self.base.to_repr(x))
        data[31] |= (y & 1) << 7
        return bytes(data)

    def from_bytes(self, data: bytes) -> Point | False:
        """Returns a Point (possibly None=identity) or False on invalid."""
        assert len(data) == 32
        buf = bytearray(data)
        ysign = (buf[31] >> 7) & 1
        buf[31] &= 0x7F
        x = self.base.from_repr(bytes(buf))
        if x is None:
            return False
        if x == 0 and ysign == 0 and all(v == 0 for v in buf):
            return None  # identity
        y2 = (x * x * x + self.b) % self.base.modulus
        y = self.base.sqrt(y2)
        if y is None:
            return False
        if (y & 1) != ysign:
            y = self.base.modulus - y
        return (x, y)


PALLAS = CurveSpec(name="pallas", base=FP, scalar=FQ)
VESTA = CurveSpec(name="vesta", base=FQ, scalar=FP)
