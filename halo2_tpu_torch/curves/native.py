"""ctypes bindings for the native host curve library (native/pasta.cc).

Lazily compiles libpasta.so with g++ on first use (no pybind11; plain C
ABI). All inputs/outputs are RAW (non-Montgomery) little-endian 4x64
values; the library converts to Montgomery internally. Falls back
cleanly (HAS_NATIVE=False) if no compiler is available so the pure-
Python Jacobian path in curves/host.py remains the behavior oracle.

Copied from halo2_tpu/curves/native.py; the library is built into the
port's own (gitignored) build directory halo2_tpu_torch/_build/.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "..", "native", "pasta.cc")
_BUILD = os.path.join(_DIR, "..", "_build")
_SO = os.path.join(_BUILD, "libpasta.so")

_lib = None
_configured: set = set()
HAS_NATIVE = None  # resolved on first _load()


def _load():
    global _lib, HAS_NATIVE
    if HAS_NATIVE is not None:
        return _lib
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            os.makedirs(_BUILD, exist_ok=True)
            # build under a per-process name and rename into place:
            # concurrent test workers may build at once, and none may load
            # a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                     "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True)
            except subprocess.CalledProcessError:
                # conservative fallback flags
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
    except Exception:
        HAS_NATIVE = False
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pasta_set_field.argtypes = [ctypes.c_int, u64p, ctypes.c_uint64,
                                    u64p, u64p]
    lib.pasta_msm.argtypes = [ctypes.c_int, u64p, u64p, u64p, u8p,
                              ctypes.c_size_t, u64p, u64p, u8p]
    lib.pasta_collapse.argtypes = [ctypes.c_int, u64p, u64p, u64p, u8p,
                                   u64p, u64p, u8p, ctypes.c_size_t,
                                   u64p, u64p, u8p]
    lib.pasta_ipa_begin.argtypes = [ctypes.c_int, ctypes.c_int, u64p, u64p,
                                    u64p, u64p, u8p, ctypes.c_size_t]
    lib.pasta_ipa_round.argtypes = [u64p, u64p, u8p, u64p, u64p, u8p,
                                    u64p, u64p]
    lib.pasta_ipa_fold.argtypes = [u64p, u64p]
    lib.pasta_ipa_final.argtypes = [u64p]
    lib.pasta_ntt.argtypes = [ctypes.c_int, u64p, ctypes.c_size_t, u64p]
    lib.pasta_powmul.argtypes = [ctypes.c_int, u64p, ctypes.c_size_t,
                                 u64p, u64p, ctypes.c_size_t]
    lib.pasta_sswu_init.argtypes = [ctypes.c_int] + [u64p] * 10 + [
        ctypes.c_int]
    lib.pasta_hash_to_curve.argtypes = [ctypes.c_int, u8p, ctypes.c_size_t,
                                        u8p, ctypes.c_size_t, u64p, u64p,
                                        u8p]
    lib.pasta_srs_g.argtypes = [ctypes.c_int, u8p, ctypes.c_size_t,
                                ctypes.c_size_t, u64p, u64p, u8p]
    lib.pasta_group_ntt.argtypes = [ctypes.c_int, ctypes.c_int, u64p, u64p,
                                    u8p, ctypes.c_size_t, u64p, u64p]
    lib.pasta_points_to_mont.argtypes = [ctypes.c_int, u64p, u64p,
                                         ctypes.c_size_t, u64p, u64p]
    lib.pasta_msm_many.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_size_t, u64p, ctypes.c_int,
                                   u64p, u64p, u8p, ctypes.c_size_t,
                                   u64p, u64p, u8p]
    lib.pasta_decompress_many.argtypes = [ctypes.c_int, u8p, u64p,
                                          ctypes.c_size_t, u64p, u64p, u8p]
    lib.pasta_set_endo.argtypes = [ctypes.c_int, u64p]
    lib.pasta_ipa_fold_glv.argtypes = [u64p, u64p, u64p, ctypes.c_int,
                                       u64p, ctypes.c_int]
    _lib = lib
    HAS_NATIVE = True
    return lib


def _limbs(v: int) -> np.ndarray:
    return np.frombuffer(int(v).to_bytes(32, "little"), dtype=np.uint64)


def _unlimbs(a: np.ndarray) -> int:
    return int.from_bytes(a.tobytes(), "little")


_FIELD_IDX = {"pallas": 0, "vesta": 1}


def _ensure_field(spec) -> int | None:
    lib = _load()
    if lib is None:
        return None
    idx = _FIELD_IDX.get(spec.name)
    if idx is None:
        return None
    if idx not in _configured:
        p = spec.base.modulus
        inv = (-pow(p, -1, 1 << 64)) % (1 << 64)
        r2 = pow(2, 512, p)
        one = pow(2, 256, p)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.pasta_set_field(
            idx, _limbs(p).ctypes.data_as(u64p), inv,
            _limbs(r2).ctypes.data_as(u64p),
            _limbs(one).ctypes.data_as(u64p))
        _configured.add(idx)
    return idx


def _pack_points(points) -> tuple:
    n = len(points)
    xs = np.zeros((n, 4), dtype=np.uint64)
    ys = np.zeros((n, 4), dtype=np.uint64)
    infs = np.zeros(n, dtype=np.uint8)
    for i, pt in enumerate(points):
        if pt is None:
            infs[i] = 1
        else:
            xs[i] = _limbs(pt[0])
            ys[i] = _limbs(pt[1])
    return xs, ys, infs


def native_msm(spec, scalars, points):
    """Pippenger MSM via the native library; None if unavailable."""
    idx = _ensure_field(spec)
    if idx is None:
        return False  # sentinel: caller falls back
    lib = _lib
    q = spec.scalar.modulus
    n = len(points)
    sc = np.zeros((n, 4), dtype=np.uint64)
    for i, s in enumerate(scalars):
        sc[i] = _limbs(s % q)
    xs, ys, infs = _pack_points(points)
    out_x = np.zeros(4, dtype=np.uint64)
    out_y = np.zeros(4, dtype=np.uint64)
    out_inf = np.zeros(1, dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pasta_msm(idx, sc.ctypes.data_as(u64p), xs.ctypes.data_as(u64p),
                  ys.ctypes.data_as(u64p), infs.ctypes.data_as(u8p), n,
                  out_x.ctypes.data_as(u64p), out_y.ctypes.data_as(u64p),
                  out_inf.ctypes.data_as(u8p))
    if out_inf[0]:
        return None
    return (_unlimbs(out_x), _unlimbs(out_y))


class PackedPoints:
    """A fixed point set pre-converted to Montgomery coordinates once
    (SRS g / g_lagrange vectors), reusable across native_msm_many calls."""

    __slots__ = ("idx", "n", "mx", "my", "infs")

    def __init__(self, spec, points):
        idx = _ensure_field(spec)
        assert idx is not None
        self.idx = idx
        self.n = len(points)
        xs, ys, self.infs = _pack_points(points)
        self.mx = np.zeros_like(xs)
        self.my = np.zeros_like(ys)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        _lib.pasta_points_to_mont(idx, xs.ctypes.data_as(u64p),
                                  ys.ctypes.data_as(u64p), self.n,
                                  self.mx.ctypes.data_as(u64p),
                                  self.my.ctypes.data_as(u64p))


def native_msm_many(spec, scalars_u64: np.ndarray, packed: PackedPoints,
                    scalars_mont: bool) -> list:
    """m MSMs over one packed point set. scalars_u64: (m, n, 4) u64 LE,
    raw or (scalars_mont=True) Montgomery scalar-field values. Returns a
    list of m affine points (None = identity)."""
    m, n = scalars_u64.shape[0], scalars_u64.shape[1]
    assert n == packed.n and scalars_u64.shape[2] == 4
    sidx = 1 - packed.idx  # scalar field of a pasta curve = other base
    from .host import PALLAS, VESTA
    _ensure_field(VESTA if packed.idx == 0 else PALLAS)
    sc = np.ascontiguousarray(scalars_u64, dtype=np.uint64)
    out_x = np.zeros((m, 4), np.uint64)
    out_y = np.zeros((m, 4), np.uint64)
    out_inf = np.zeros(m, np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _lib.pasta_msm_many(packed.idx, sidx, m, sc.ctypes.data_as(u64p),
                        1 if scalars_mont else 0,
                        packed.mx.ctypes.data_as(u64p),
                        packed.my.ctypes.data_as(u64p),
                        packed.infs.ctypes.data_as(u8p), n,
                        out_x.ctypes.data_as(u64p),
                        out_y.ctypes.data_as(u64p),
                        out_inf.ctypes.data_as(u8p))
    return [None if out_inf[j] else (_unlimbs(out_x[j]), _unlimbs(out_y[j]))
            for j in range(m)]


def ints_to_limbs(vals: list[int]) -> np.ndarray:
    """(n, 4) u64 LE limb array from a list of reduced python ints."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, np.uint64).reshape(len(vals), 4)


def raw_to_mont_inplace(idx: int, data_u64: np.ndarray, modulus: int
                        ) -> None:
    """Convert raw (n, 4) u64 values to Montgomery form in place:
    data[i] = fmul(data[i], R^2) = data[i] * R."""
    r2 = pow(2, 512, modulus)
    one = pow(2, 256, modulus)
    powmul_inplace(idx, data_u64, one, r2, 1)


def field_idx(fs) -> int | None:
    """Library field slot for a FieldSpec (0 = Fp = Pallas base = Vesta
    scalar; 1 = Fq = Vesta base = Pallas scalar); None if the native
    library is unavailable or the modulus is not a pasta field."""
    from .host import PALLAS, VESTA
    if fs.modulus == PALLAS.base.modulus:
        return _ensure_field(PALLAS)
    if fs.modulus == VESTA.base.modulus:
        return _ensure_field(VESTA)
    return None


def ntt_inplace(idx: int, data_u64: np.ndarray, omega_mont: int) -> None:
    """In-place radix-2 NTT over Montgomery (n, 4) u64 data."""
    if _load() is None:
        raise RuntimeError("native pasta library unavailable "
                           "(ntt_inplace requires a g++ toolchain)")
    assert data_u64.flags["C_CONTIGUOUS"]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    _lib.pasta_ntt(idx, data_u64.ctypes.data_as(u64p), data_u64.shape[0],
                   _limbs(omega_mont).ctypes.data_as(u64p))


def powmul_inplace(idx: int, data_u64: np.ndarray, base_mont: int,
                   scale_mont: int, period: int) -> None:
    """data[i] *= scale * base^(i mod period) in place (period=0: base^i)."""
    if _load() is None:
        raise RuntimeError("native pasta library unavailable "
                           "(powmul_inplace requires a g++ toolchain)")
    assert data_u64.flags["C_CONTIGUOUS"]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    _lib.pasta_powmul(idx, data_u64.ctypes.data_as(u64p),
                      data_u64.shape[0],
                      _limbs(base_mont).ctypes.data_as(u64p),
                      _limbs(scale_mont).ctypes.data_as(u64p), period)


def dev_mont_to_u64(limbs16: np.ndarray) -> np.ndarray:
    """Device-layout Montgomery array (n, 16) uint32 of LE 16-bit digits
    -> (n, 4) uint64 LE limbs. Pure numpy repack — the device's
    R = 2^256 equals this library's, so values stay in Montgomery form."""
    a = np.ascontiguousarray(limbs16.astype(np.uint16))
    return a.view(np.uint64).reshape(limbs16.shape[0], 4)


def u64_to_dev_mont(limbs4: np.ndarray) -> np.ndarray:
    """(n, 4) uint64 LE -> device (n, 16) uint32 of 16-bit digits."""
    a = np.ascontiguousarray(limbs4, dtype=np.uint64)
    return a.view(np.uint16).astype(np.uint32).reshape(limbs4.shape[0], 16)


class NativeIpaSession:
    """The IPA tail: p'/b/G' handed over once (Montgomery numpy arrays
    straight off the device), then per-round cross terms + folds run
    natively with only transcript scalars crossing the boundary
    (commitment/prover.rs:100-142)."""

    def __init__(self, spec, p_mont16: np.ndarray, b_mont16: np.ndarray,
                 gx_mont16: np.ndarray, gy_mont16: np.ndarray,
                 g_inf: np.ndarray):
        self.spec = spec
        base_idx = _ensure_field(spec)
        assert base_idx is not None
        from .host import PALLAS, VESTA
        other = VESTA if spec.name == "pallas" else PALLAS
        scalar_idx = _ensure_field(other)  # scalar field = other's base
        assert scalar_idx is not None
        lib = _lib
        n = p_mont16.shape[0]
        self._p = np.ascontiguousarray(dev_mont_to_u64(p_mont16))
        self._b = np.ascontiguousarray(dev_mont_to_u64(b_mont16))
        self._gx = np.ascontiguousarray(dev_mont_to_u64(gx_mont16))
        self._gy = np.ascontiguousarray(dev_mont_to_u64(gy_mont16))
        self._ginf = np.ascontiguousarray(g_inf, dtype=np.uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pasta_ipa_begin(base_idx, scalar_idx,
                            self._p.ctypes.data_as(u64p),
                            self._b.ctypes.data_as(u64p),
                            self._gx.ctypes.data_as(u64p),
                            self._gy.ctypes.data_as(u64p),
                            self._ginf.ctypes.data_as(u8p), n)

    def round(self):
        """-> (L_point|None, R_point|None, value_l, value_r)."""
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lx = np.zeros(4, np.uint64); ly = np.zeros(4, np.uint64)
        rx = np.zeros(4, np.uint64); ry = np.zeros(4, np.uint64)
        vl = np.zeros(4, np.uint64); vr = np.zeros(4, np.uint64)
        linf = np.zeros(1, np.uint8); rinf = np.zeros(1, np.uint8)
        _lib.pasta_ipa_round(lx.ctypes.data_as(u64p), ly.ctypes.data_as(u64p),
                             linf.ctypes.data_as(u8p),
                             rx.ctypes.data_as(u64p), ry.ctypes.data_as(u64p),
                             rinf.ctypes.data_as(u8p),
                             vl.ctypes.data_as(u64p), vr.ctypes.data_as(u64p))
        l_pt = None if linf[0] else (_unlimbs(lx), _unlimbs(ly))
        r_pt = None if rinf[0] else (_unlimbs(rx), _unlimbs(ry))
        return l_pt, r_pt, _unlimbs(vl), _unlimbs(vr)

    def fold(self, u: int, u_inv: int) -> None:
        u64p = ctypes.POINTER(ctypes.c_uint64)
        q = self.spec.scalar.modulus
        ua = _limbs(u % q)
        uia = _limbs(u_inv % q)
        glv = _glv_ctx(self.spec)
        if glv is not None:
            k1, k2 = glv.decompose(u % q)
            k1a = _limbs(abs(k1))
            k2a = _limbs(abs(k2))
            _lib.pasta_ipa_fold_glv(ua.ctypes.data_as(u64p),
                                    uia.ctypes.data_as(u64p),
                                    k1a.ctypes.data_as(u64p),
                                    1 if k1 < 0 else 0,
                                    k2a.ctypes.data_as(u64p),
                                    1 if k2 < 0 else 0)
        else:
            _lib.pasta_ipa_fold(ua.ctypes.data_as(u64p),
                                uia.ctypes.data_as(u64p))

    def final_c(self) -> int:
        u64p = ctypes.POINTER(ctypes.c_uint64)
        c = np.zeros(4, np.uint64)
        _lib.pasta_ipa_final(c.ctypes.data_as(u64p))
        return _unlimbs(c)


def native_collapse(spec, k: int, lo_points, hi_points):
    """out[i] = lo[i] + [k] hi[i] for affine point lists (IPA G'
    collapse); False if the native library is unavailable."""
    idx = _ensure_field(spec)
    if idx is None:
        return False
    lib = _lib
    n = len(lo_points)
    assert len(hi_points) == n
    k_arr = _limbs(k % spec.scalar.modulus)
    lx, ly, linf = _pack_points(lo_points)
    hx, hy, hinf = _pack_points(hi_points)
    out_x = np.zeros((n, 4), dtype=np.uint64)
    out_y = np.zeros((n, 4), dtype=np.uint64)
    out_inf = np.zeros(n, dtype=np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pasta_collapse(idx, k_arr.ctypes.data_as(u64p),
                       lx.ctypes.data_as(u64p), ly.ctypes.data_as(u64p),
                       linf.ctypes.data_as(u8p),
                       hx.ctypes.data_as(u64p), hy.ctypes.data_as(u64p),
                       hinf.ctypes.data_as(u8p), n,
                       out_x.ctypes.data_as(u64p),
                       out_y.ctypes.data_as(u64p),
                       out_inf.ctypes.data_as(u8p))
    return [None if out_inf[i] else (_unlimbs(out_x[i]), _unlimbs(out_y[i]))
            for i in range(n)]


# ---------------------------------------------------------------------------
# SSWU hash-to-curve + SRS generation (native/pasta.cc; the native twin of
# curves/sswu.py — constants are derived there and handed over raw, so the
# Python implementation remains the behavior oracle).
# ---------------------------------------------------------------------------

_sswu_configured: set = set()


def _ensure_sswu(curve_spec) -> int | None:
    idx = _ensure_field(curve_spec)
    if idx is None:
        return None
    if idx in _sswu_configured:
        return idx
    from .sswu import sswu_params
    pr = sswu_params(curve_spec.name)
    f = curve_spec.base
    t_m1_2 = (f.t_odd - 1) // 2
    u64p = ctypes.POINTER(ctypes.c_uint64)

    def lp(v):
        return _limbs(v % f.modulus).ctypes.data_as(u64p)

    _lib.pasta_sswu_init(idx, lp(pr.iso_a), lp(pr.iso_b), lp(pr.z),
                         lp(pr.ker_x), lp(pr.velu_t), lp(pr.velu_u),
                         lp(pr.inv9), lp(pr.inv27), lp(f.root_of_unity),
                         _limbs(t_m1_2).ctypes.data_as(u64p), f.s)
    _sswu_configured.add(idx)
    return idx


def _dst(curve_spec, domain_prefix: str) -> bytes:
    return (domain_prefix + "-" + curve_spec.name +
            "_XMD:BLAKE2b_SSWU_RO_").encode()


def native_hash_to_curve(curve_spec, domain_prefix: str, msg: bytes):
    """hash_to_curve via the native library; False if unavailable."""
    idx = _ensure_sswu(curve_spec)
    if idx is None or len(msg) > 64:
        return False
    dst = _dst(curve_spec, domain_prefix)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dst_a = np.frombuffer(dst, np.uint8)
    msg_a = np.frombuffer(msg, np.uint8) if msg else np.zeros(1, np.uint8)
    ox = np.zeros(4, np.uint64)
    oy = np.zeros(4, np.uint64)
    oinf = np.zeros(1, np.uint8)
    _lib.pasta_hash_to_curve(idx, dst_a.ctypes.data_as(u8p), len(dst),
                             msg_a.ctypes.data_as(u8p), len(msg),
                             ox.ctypes.data_as(u64p),
                             oy.ctypes.data_as(u64p),
                             oinf.ctypes.data_as(u8p))
    if oinf[0] == 2:
        return False
    return None if oinf[0] else (_unlimbs(ox), _unlimbs(oy))


def native_srs_g(curve_spec, domain_prefix: str, n: int):
    """The n-point SRS generator vector g[i] = hash(0x00 || LE32(i));
    list of affine points, or False if the native library is missing."""
    idx = _ensure_sswu(curve_spec)
    if idx is None:
        return False
    dst = _dst(curve_spec, domain_prefix)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dst_a = np.frombuffer(dst, np.uint8)
    ox = np.zeros((n, 4), np.uint64)
    oy = np.zeros((n, 4), np.uint64)
    oinf = np.zeros(n, np.uint8)
    _lib.pasta_srs_g(idx, dst_a.ctypes.data_as(u8p), len(dst), n,
                     ox.ctypes.data_as(u64p), oy.ctypes.data_as(u64p),
                     oinf.ctypes.data_as(u8p))
    return [None if oinf[i] else (_unlimbs(ox[i]), _unlimbs(oy[i]))
            for i in range(n)]


def native_group_ntt(curve_spec, points, omega: int, scale: int = 1):
    """In the scalar field's evaluation order: radix-2 group NTT of the
    point vector with twiddle omega, each output scaled by `scale`
    (pass omega_inv and 1/n for the inverse transform). Returns a list
    of affine points, or False if the native library is missing."""
    idx = _ensure_field(curve_spec)
    if idx is None:
        return False
    sidx = 1 - idx  # scalar field of a pasta curve = the OTHER base field
    # ensure the scalar field constants are loaded too
    from .host import PALLAS, VESTA
    _ensure_field(VESTA if idx == 0 else PALLAS)
    q = curve_spec.scalar.modulus
    xs, ys, infs = _pack_points(points)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _lib.pasta_group_ntt(idx, sidx, xs.ctypes.data_as(u64p),
                         ys.ctypes.data_as(u64p),
                         infs.ctypes.data_as(u8p), len(points),
                         _limbs(omega % q).ctypes.data_as(u64p),
                         _limbs(scale % q).ctypes.data_as(u64p))
    return [None if infs[i] else (_unlimbs(xs[i]), _unlimbs(ys[i]))
            for i in range(len(points))]


def native_decompress_many(curve_spec, data: bytes):
    """Batch-decompress n reference-encoded 32-byte points (x LE, y
    parity in the top bit). Returns a list of points (None = identity),
    raises ValueError on any invalid encoding, or returns False when the
    native library is unavailable."""
    idx = _ensure_sswu(curve_spec)
    if idx is None:
        return False
    n = len(data) // 32
    assert len(data) == 32 * n
    arr = np.frombuffer(data, np.uint8)
    out_x = np.zeros((n, 4), np.uint64)
    out_y = np.zeros((n, 4), np.uint64)
    flags = np.zeros(n, np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _lib.pasta_decompress_many(idx, arr.ctypes.data_as(u8p),
                               _limbs(curve_spec.b).ctypes.data_as(u64p), n,
                               out_x.ctypes.data_as(u64p),
                               out_y.ctypes.data_as(u64p),
                               flags.ctypes.data_as(u8p))
    if (flags == 2).any():
        raise ValueError("invalid point encoding")
    return [None if flags[i] else (_unlimbs(out_x[i]), _unlimbs(out_y[i]))
            for i in range(n)]


# ---------------------------------------------------------------------------
# GLV decomposition (cube-root endomorphism phi(x, y) = (zeta_base*x, y),
# which acts as scalar multiplication by lambda = zeta_scalar — orientation
# pinned by fields/host.py's zeta notes and verified at context build).
# ---------------------------------------------------------------------------

class _GlvCtx:
    __slots__ = ("q", "lam", "a1", "b1", "a2", "b2")

    def __init__(self, q: int, lam: int):
        self.q = q
        self.lam = lam
        # half-size lattice basis for (q, lam) via extended Euclid
        rs = [q, lam]
        ts = [0, 1]
        while rs[-1] ** 2 >= q:
            qt = rs[-2] // rs[-1]
            rs.append(rs[-2] - qt * rs[-1])
            ts.append(ts[-2] - qt * ts[-1])
        self.a1, self.b1 = rs[-1], -ts[-1]
        self.a2, self.b2 = rs[-2], -ts[-2]

    def decompose(self, k: int) -> tuple[int, int]:
        """k = k1 + k2*lambda (mod q) with |k1|, |k2| < 2^129."""
        q = self.q
        c1 = (self.b2 * k + q // 2) // q
        c2 = (-self.b1 * k + q // 2) // q
        k1 = k - c1 * self.a1 - c2 * self.a2
        k2 = -c1 * self.b1 - c2 * self.b2
        return k1, k2


_glv_cache: dict = {}


def _glv_ctx(curve_spec):
    """GLV context for the curve, registering the endo zeta with the
    native library; None if the native library is unavailable."""
    got = _glv_cache.get(curve_spec.name)
    if got is not None:
        return got
    idx = _ensure_field(curve_spec)
    if idx is None:
        return None
    bf = curve_spec.base
    sf = curve_spec.scalar
    lam = sf.zeta
    # verify endo orientation on a sample point; fall back to zeta^2
    P = curve_spec.mul(curve_spec.generator, 12345)
    endo = (bf.zeta * P[0] % bf.modulus, P[1])
    if curve_spec.mul(P, lam) != endo:
        lam = lam * lam % sf.modulus
        assert curve_spec.mul(P, lam) == endo
    ctx = _GlvCtx(sf.modulus, lam)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    _lib.pasta_set_endo(idx, _limbs(bf.zeta).ctypes.data_as(u64p))
    _glv_cache[curve_spec.name] = ctx
    return ctx
