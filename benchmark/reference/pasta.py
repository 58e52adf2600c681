"""The Pallas curve and its two fields in plain Python integers.

The plain reference's arithmetic: field constants, Jacobian point
arithmetic, the 32-byte point encoding, hash-to-curve (simplified SWU on
the 3-isogenous curve, then the isogeny), the transparent SRS that halo2
derives from it, an inverse NTT over the scalar field and a Pippenger
multi-scalar multiplication that can spread its windows over worker
processes. Nothing here imports torch or the program under test.

Pallas: y^2 = x^3 + 5 over Fp; its scalar field is Fq. Both fields have
2-adicity 32 and multiplicative generator 5 (pasta_curves).
"""
from __future__ import annotations

import hashlib
import os

P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
Q = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
B = 5
S = 32
GENERATOR = 5

P_T = (P - 1) >> S          # odd part of p - 1
P_ROOT = pow(GENERATOR, P_T, P)             # order 2^32 in Fp
Q_ROOT = pow(GENERATOR, (Q - 1) >> S, Q)    # ROOT_OF_UNITY of Fq
Q_DELTA = pow(GENERATOR, 1 << S, Q)         # DELTA of Fq
Q_ZETA = pow(GENERATOR, (Q - 1) // 3, Q)    # ZETA of Fq (cube root of 1)


def sqrt_fp(a: int) -> int | None:
    """Tonelli-Shanks in Fp; None for a non-residue."""
    a %= P
    if a == 0:
        return 0
    w = pow(a, (P_T - 1) // 2, P)
    r = a * w % P
    t = r * w % P              # a^T
    m, c = S, P_ROOT
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % P
            i += 1
            if i == m:
                return None
        b = c
        for _ in range(m - i - 1):
            b = b * b % P
        m, c = i, b * b % P
        t, r = t * c % P, r * b % P
    return r


# ---- points: affine (x, y) tuples, None for the identity; Jacobian
# (X, Y, Z) triples, Z == 0 for the identity.

def jac(pt):
    return (1, 1, 0) if pt is None else (pt[0], pt[1], 1)


def affine(j):
    X, Y, Z = j
    if Z == 0:
        return None
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


def jdouble(j):
    X, Y, Z = j
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    A = X * X % P
    Bb = Y * Y % P
    C = Bb * Bb % P
    D = 2 * ((X + Bb) * (X + Bb) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return (X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P)


def jadd(j1, j2):
    X1, Y1, Z1 = j1
    X2, Y2, Z2 = j2
    if Z1 == 0:
        return j2
    if Z2 == 0:
        return j1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 % P * Z2Z2 % P
    S2 = Y2 * Z1 % P * Z1Z1 % P
    H = (U2 - U1) % P
    r = 2 * (S2 - S1) % P
    if H == 0:
        return jdouble(j1) if r == 0 else (1, 1, 0)
    I = 4 * H * H % P
    J = H * I % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
    return (X3, Y3, Z3)


def jadd_affine(j1, x2, y2):
    """Jacobian plus an affine point that is not the identity."""
    X1, Y1, Z1 = j1
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1 % P * Z1Z1 % P
    H = (U2 - X1) % P
    r = 2 * (S2 - Y1) % P
    if H == 0:
        return jdouble(j1) if r == 0 else (1, 1, 0)
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    V = X1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * Y1 * J) % P
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % P
    return (X3, Y3, Z3)


def add(a, b):
    return affine(jadd(jac(a), jac(b)))


def mul(scalar: int, pt):
    """Double-and-add; for the few points that are not in an MSM."""
    acc = (1, 1, 0)
    base = jac(pt)
    for bit in bin(scalar % Q)[2:]:
        acc = jdouble(acc)
        if bit == "1":
            acc = jadd(acc, base)
    return affine(acc)


def to_bytes(pt) -> bytes:
    if pt is None:
        return bytes(32)
    data = bytearray(pt[0].to_bytes(32, "little"))
    data[31] |= (pt[1] & 1) << 7
    return bytes(data)


def from_bytes(data: bytes):
    """The point, None for the identity, or False for an invalid
    encoding."""
    buf = bytearray(data)
    sign = buf[31] >> 7
    buf[31] &= 0x7F
    x = int.from_bytes(buf, "little")
    if x >= P:
        return False
    if x == 0 and sign == 0:
        return None
    y = sqrt_fp(x * x * x + B)
    if y is None:
        return False
    if (y & 1) != sign:
        y = P - y
    return (x, y)


# ---- hash to curve (pasta_curves hashtocurve.rs): expand_message_xmd
# with BLAKE2b-512, each 64-byte block reversed before it is reduced,
# simplified SWU onto E': y^2 = x^3 + ISO_A x + 1265 with Z = -13, and
# the 3-isogeny E' -> E from Velu's formulas.

ISO_A = 0x18354A2EB0EA8C9C49BE2D7258370742B74134581A27A59F92BB4B0B657A014B
ISO_B = 1265
SSWU_Z = (-13) % P


def _polymod(a: list[int], m: list[int]) -> list[int]:
    a = a[:]
    lead = pow(m[-1], P - 2, P)
    while len(a) >= len(m):
        c = a[-1] * lead % P
        shift = len(a) - len(m)
        for i, mc in enumerate(m):
            a[shift + i] = (a[shift + i] - c * mc) % P
        a.pop()
    while len(a) > 1 and a[-1] == 0:
        a.pop()
    return a


def _polymulmod(a, b, m):
    out = [0] * (len(a) + len(b) - 1)
    for i, ac in enumerate(a):
        for j, bc in enumerate(b):
            out[i + j] = (out[i + j] + ac * bc) % P
    return _polymod(out, m)


def _iso_kernel_x() -> int:
    """The x of the rational 3-torsion point of E': the one root in Fp
    of its 3-division polynomial, from gcd(psi_3, x^p - x)."""
    psi3 = [(-ISO_A * ISO_A) % P, 12 * ISO_B % P, 6 * ISO_A % P, 0, 3]
    acc, base, e = [1], [0, 1], P
    while e:
        if e & 1:
            acc = _polymulmod(acc, base, psi3)
        base = _polymulmod(base, base, psi3)
        e >>= 1
    acc = acc + [0] * (2 - len(acc))
    acc[1] = (acc[1] - 1) % P
    a, b = psi3, _polymod(acc, psi3)
    while any(b):
        a, b = b, _polymod(a, b)
    assert len(a) == 2, "E' must have exactly one rational 3-torsion x"
    return (-a[0]) * pow(a[1], P - 2, P) % P


KER_X = _iso_kernel_x()
_VELU_T = 2 * (3 * KER_X * KER_X + ISO_A) % P
_VELU_U = 4 * (KER_X ** 3 + ISO_A * KER_X + ISO_B) % P
# Velu's image is y^2 = x^3 + 5 * 3^6; (x / 9, y / 27) takes it to Pallas
assert (ISO_A - 5 * _VELU_T) % P == 0
assert (ISO_B - 7 * (_VELU_U + KER_X * _VELU_T)) % P == B * 729 % P
_INV9, _INV27 = pow(9, P - 2, P), pow(27, P - 2, P)
_MINUS_B_OVER_A = (-ISO_B) * pow(ISO_A, P - 2, P) % P


def _g_iso(x: int) -> int:
    return (x * x * x + ISO_A * x + ISO_B) % P


def map_to_iso(u: int):
    tv1 = SSWU_Z * u % P * u % P
    den = (tv1 + tv1 * tv1) % P
    if den == 0:
        x1 = ISO_B * pow(SSWU_Z * ISO_A % P, P - 2, P) % P
    else:
        x1 = _MINUS_B_OVER_A * (1 + pow(den, P - 2, P)) % P
    x, y = x1, sqrt_fp(_g_iso(x1))
    if y is None:
        x = tv1 * x1 % P
        y = sqrt_fp(_g_iso(x))
    if (y & 1) != (u & 1):
        y = (-y) % P
    return (x, y)


def iso_map(pt):
    x, y = pt
    d = (x - KER_X) % P
    if d == 0:
        return None
    di = pow(d, P - 2, P)
    di2 = di * di % P
    X = (x + _VELU_T * di + _VELU_U * di2) % P
    Yf = (1 - _VELU_T * di2 - 2 * _VELU_U * di2 % P * di) % P
    return (X * _INV9 % P, y * Yf % P * _INV27 % P)


def hash_to_field(domain_prefix: str, msg: bytes) -> tuple[int, int]:
    dst = (domain_prefix + "-pallas_XMD:BLAKE2b_SSWU_RO_").encode()
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.blake2b(bytes(128) + msg + (128).to_bytes(2, "big")
                         + b"\x00" + dst_prime, digest_size=64).digest()
    b1 = hashlib.blake2b(b0 + b"\x01" + dst_prime, digest_size=64).digest()
    b2 = hashlib.blake2b(bytes(a ^ b for a, b in zip(b0, b1)) + b"\x02"
                         + dst_prime, digest_size=64).digest()
    return (int.from_bytes(b1[::-1], "little") % P,
            int.from_bytes(b2[::-1], "little") % P)


def hash_to_curve(domain_prefix: str, msg: bytes):
    u0, u1 = hash_to_field(domain_prefix, msg)
    return add(iso_map(map_to_iso(u0)), iso_map(map_to_iso(u1)))


def srs_g_chunk(span: tuple[int, int]) -> list:
    """g_i = hash_to_curve("Halo2-Parameters", [0] || i as 4 LE bytes)."""
    return [hash_to_curve("Halo2-Parameters", b"\x00" + i.to_bytes(4, "little"))
            for i in range(*span)]


def srs_w_u():
    return (hash_to_curve("Halo2-Parameters", b"\x01"),
            hash_to_curve("Halo2-Parameters", b"\x02"))


# ---- scalar-field transforms

def intt(values: list[int], k: int) -> list[int]:
    """Coefficients of the polynomial whose values on the 2^k-th roots of
    unity omega^i are `values` (radix-2, decimation in time)."""
    n = 1 << k
    a = [v % Q for v in values]
    j = 0
    for i in range(1, n):         # bit-reversal permutation
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    omega_inv = pow(pow(Q_ROOT, 1 << (S - k), Q), Q - 2, Q)
    length = 2
    while length <= n:
        w_len = pow(omega_inv, n // length, Q)
        half = length >> 1
        ws = [1] * half
        for i in range(1, half):
            ws[i] = ws[i - 1] * w_len % Q
        for start in range(0, n, length):
            for i in range(half):
                u = a[start + i]
                v = a[start + i + half] * ws[i] % Q
                a[start + i] = (u + v) % Q
                a[start + i + half] = (u - v) % Q
        length <<= 1
    n_inv = pow(n, Q - 2, Q)
    return [v * n_inv % Q for v in a]


# ---- multi-scalar multiplication

def _window_bits(n: int) -> int:
    return max(4, min(16, n.bit_length() - 5))


def _window_sum(scalars, xs, ys, shift: int, c: int):
    mask = (1 << c) - 1
    buckets = [None] * (mask + 1)
    for s, x, y in zip(scalars, xs, ys):
        d = (s >> shift) & mask
        if d:
            b = buckets[d]
            buckets[d] = (x, y, 1) if b is None else jadd_affine(b, x, y)
    acc = total = (1, 1, 0)
    for d in range(mask, 0, -1):
        if buckets[d] is not None:
            acc = jadd(acc, buckets[d])
        total = jadd(total, acc)
    return total


_WORKER = {}


def _worker_init(scalars_bytes: bytes, points_path: str, n: int):
    _WORKER["scalars"] = [int.from_bytes(scalars_bytes[32 * i:32 * i + 32],
                                         "little") for i in range(n)]
    _WORKER["xs"], _WORKER["ys"] = read_points(points_path, n)


def _worker_windows(job):
    shifts, c = job
    w = _WORKER
    return [_window_sum(w["scalars"], w["xs"], w["ys"], s, c) for s in shifts]


def _combine(window_sums, c: int):
    acc = (1, 1, 0)
    for ws in reversed(window_sums):
        for _ in range(c):
            acc = jdouble(acc)
        acc = jadd(acc, ws)
    return acc


def msm(scalars: list[int], points: list) -> object:
    """sum scalars[i] * points[i] in this process (affine result)."""
    xs, ys, ss = [], [], []
    for s, pt in zip(scalars, points):
        if pt is not None and s % Q:
            ss.append(s % Q)
            xs.append(pt[0])
            ys.append(pt[1])
    c = _window_bits(len(ss))
    sums = [_window_sum(ss, xs, ys, w, c) for w in range(0, 255, c)]
    return affine(_combine(sums, c))


def msm_file_points(scalars: list[int], points_path: str, workers: int):
    """sum scalars[i] * g_i over the first len(scalars) points of a
    points file, the windows spread over `workers` processes (spawned:
    the caller may hold a CUDA context or threads)."""
    import multiprocessing as mp
    n = len(scalars)
    c = _window_bits(n)
    shifts = list(range(0, 255, c))
    if workers <= 1:
        _worker_init(b"".join((s % Q).to_bytes(32, "little")
                              for s in scalars), points_path, n)
        sums = _worker_windows((shifts, c))
        _WORKER.clear()
        return affine(_combine(sums, c))
    jobs = [(shifts[i::workers], c) for i in range(workers)]
    blob = b"".join((s % Q).to_bytes(32, "little") for s in scalars)
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers, initializer=_worker_init,
                  initargs=(blob, points_path, n)) as pool:
        parts = pool.map(_worker_windows, jobs)
        pool.close()
        pool.join()
    by_shift = {}
    for (job_shifts, _), sums in zip(jobs, parts):
        by_shift.update(zip(job_shifts, sums))
    return affine(_combine([by_shift[s] for s in shifts], c))


# ---- the SRS on disk: 2^k affine points, x and y as 32 LE bytes each

def write_points(path: str, points: list) -> None:
    tmp = f"{path}.partial"
    with open(tmp, "wb") as fh:
        fh.write(b"".join(pt[0].to_bytes(32, "little")
                          + pt[1].to_bytes(32, "little") for pt in points))
    os.replace(tmp, path)


def read_points(path: str, n: int) -> tuple[list[int], list[int]]:
    with open(path, "rb") as fh:
        data = fh.read(64 * n)
    if len(data) != 64 * n:
        raise ValueError(f"{path} holds fewer than {n} points")
    xs = [int.from_bytes(data[i:i + 32], "little") for i in range(0, 64 * n, 64)]
    ys = [int.from_bytes(data[i + 32:i + 64], "little")
          for i in range(0, 64 * n, 64)]
    return xs, ys


def make_srs(path: str, k: int, workers: int) -> None:
    """Hashes g_0 .. g_{2^k - 1} and writes them to `path`."""
    import multiprocessing as mp
    n = 1 << k
    step = 2048
    spans = [(i, min(n, i + step)) for i in range(0, n, step)]
    if workers <= 1:
        chunks = [srs_g_chunk(s) for s in spans]
    else:
        with mp.get_context("spawn").Pool(workers) as pool:
            chunks = pool.map(srs_g_chunk, spans)
            pool.close()
            pool.join()
    write_points(path, [pt for chunk in chunks for pt in chunk])
