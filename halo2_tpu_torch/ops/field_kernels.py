"""Kernel B1 (Montgomery multiply), the field add/subtract kernel and
kernel B8 (B1 on the limbs-first layout), with their plain PyTorch
versions.

Replaces halo2_tpu/ops/pallas_field.py (the Pallas `_mont_mul_kernel`,
whose limbs-first [16, N] layout only served the TPU's sublanes). Here a
field tensor keeps the reference's element layout: int32 [..., 16], the
16-bit little-endian digits of the Montgomery form (R = 2^256), so the
values equal the reference's uint32 arrays.

Each wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel (csrc/field_kernels.cu) or raises.
`LAUNCHES` counts kernel launches, nowhere else.

The plain versions compute in int64 (and exact float64 column sums): on
this PyTorch, uint32 has no add, shift, compare or gather. They compute
the reference's values (its jnp `_mont_mul`, halo2_tpu/fields/device.py:
375, and its add/sub chains) with whole-tensor carry passes instead of
its per-digit loops.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NLIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

LAUNCHES = {"fmul": 0, "faddsub": 0, "fmul_limbs_first": 0}

# column i + j of each entry of a flattened 16x16 digit product
_DIAG = (np.arange(NLIMBS)[:, None] + np.arange(NLIMBS)[None, :]).reshape(-1)
_CONSTS: dict = {}


def _norm(x: torch.Tensor):
    """Carry-normalize int64 digit columns [..., k] (any magnitude or
    sign): returns (the low k-1 columns as digits in [0, 2^16), the last
    column with every carry -- possibly negative -- added in). Carries
    move one column per pass, all columns at once; a pass repeats only
    while some carry is left (a few passes: callers never hand it a
    borrow that runs through every column)."""
    lo, top = x[..., :-1].clone(), x[..., -1].clone()
    c = lo >> LIMB_BITS                 # arithmetic shift: floor
    while bool(c.any()):
        lo &= MASK
        lo[..., 1:] += c[..., :-1]
        top += c[..., -1]
        c = lo >> LIMB_BITS
    return lo, top


def _geq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x >= y on normalized digit vectors [..., k]: the weighted sign of
    the digit differences is the sign of the most significant one."""
    k = x.shape[-1]
    w = torch.pow(2, torch.arange(k, dtype=torch.int64, device=x.device))
    return (torch.sign(x - y) * w).sum(-1) >= 0


def _with_top(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 1))


def _consts(df, device):
    """(p digits as int64, p and -p^-1 mod 2^256 digits as float64, the
    0/1 matrices summing a flattened 16x16 digit product by column i+j:
    all 31 columns, and only the 16 below 2^256) on `device`."""
    key = (df.spec.modulus, device)
    ent = _CONSTS.get(key)
    if ent is None:
        p = df.spec.modulus
        npr = (-pow(p, -1, 1 << 256)) % (1 << 256)
        digits = lambda v: [(v >> (LIMB_BITS * i)) & MASK
                            for i in range(NLIMBS)]
        full = np.zeros((NLIMBS * NLIMBS, 2 * NLIMBS - 1))
        full[np.arange(NLIMBS * NLIMBS), _DIAG] = 1
        ent = _CONSTS[key] = (
            torch.tensor(digits(p), dtype=torch.int64, device=device),
            torch.tensor(digits(p), dtype=torch.float64, device=device),
            torch.tensor(digits(npr), dtype=torch.float64, device=device),
            torch.from_numpy(full).to(device),
            torch.from_numpy(np.ascontiguousarray(full[:, :NLIMBS]))
            .to(device))
    return ent


def _cols(a: torch.Tensor, b: torch.Tensor, sel: torch.Tensor):
    """Column sums sum_{i+j=k} a_i b_j of two float64 digit vectors (each
    digit < 2^16) as int64; a sum of at most 16 products < 2^36 is exact
    in float64, and the column sums are one matrix product."""
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
    return torch.matmul(prod, sel).to(torch.int64)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fmul_plain(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p, fully reduced, with R = 2^256: T = a*b,
    m = (T mod R)(-p^-1) mod R, (T + m p)/R < 2p, one conditional
    subtract. Exact integer arithmetic, so the value equals the
    reference's word-by-word CIOS result."""
    a64, b64 = torch.broadcast_tensors(a.to(torch.float64),
                                       b.to(torch.float64))
    p, p_f, npr_f, sel, sel_lo = _consts(df, a.device)
    t = torch.nn.functional.pad(_cols(a64, b64, sel), (0, 2))   # 33 cols
    t_lo, _ = _norm(t[..., :NLIMBS + 1])                        # T mod R
    m, _ = _norm(_with_top(_cols(t_lo.to(torch.float64), npr_f, sel_lo)))
    mp = torch.nn.functional.pad(
        _cols(m.to(torch.float64), p_f.expand(m.shape), sel), (0, 2))
    u, top = _norm(t + mp)
    r = torch.cat([u[..., NLIMBS:], top.unsqueeze(-1)], dim=-1)  # < 2p
    p17 = _with_top(p)
    ge = _geq(r, p17).unsqueeze(-1)
    return _norm(torch.where(ge, r - p17, r))[0].to(torch.int32)


def fadd_plain(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    p17 = _with_top(_consts(df, a.device)[0])
    s, c = _norm(_with_top(a64 + b64))
    s = torch.cat([s, c.unsqueeze(-1)], dim=-1)                   # < 2p
    ge = _geq(s, p17).unsqueeze(-1)
    return _norm(torch.where(ge, s - p17, s))[0].to(torch.int32)


def fsub_plain(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    p = _consts(df, a.device)[0]
    ge = _geq(a64, b64).unsqueeze(-1)
    d = torch.where(ge, a64 - b64, a64 + p - b64)
    return _norm(_with_top(d))[0].to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for x in (a, b):
        if x.dtype != torch.int32 or x.shape[-1:] != (NLIMBS,):
            raise TypeError(f"field tensors are int32 [..., 16], got "
                            f"{x.dtype} {tuple(x.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def _fit(x: torch.Tensor, batch: tuple):
    """Operand for a kernel over `batch` elements: a contiguous tensor and
    the period its element index repeats with (i % period), so scalars and
    trailing-dimension broadcasts are never materialised."""
    xb = tuple(x.shape[:-1])
    while xb and xb[0] == 1:
        xb = xb[1:]
    if xb == tuple(batch[len(batch) - len(xb):]):
        x = x.reshape(xb + (NLIMBS,)).contiguous()
        return x, max(1, math.prod(xb))
    x = x.expand(tuple(batch) + (NLIMBS,)).contiguous()
    return x, max(1, math.prod(batch))


def _launch(fn_name: str, counter: str, df, a, b, *extra):
    from . import cuda_build
    batch = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    n = math.prod(batch)
    out = torch.empty(batch + (NLIMBS,), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    a_, ap = _fit(a, batch)
    b_, bp = _fit(b, batch)
    lib = cuda_build.library("field_kernels")
    rc = getattr(lib, fn_name)(df.field_id, *extra, out.data_ptr(),
                               a_.data_ptr(), b_.data_ptr(), n, ap, bp,
                               cuda_build.stream_ptr(a.device))
    cuda_build.check(rc, fn_name)
    LAUNCHES[counter] += 1
    return out


def _dispatch(a: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version
    (CPU tensors); anything else raises."""
    if a.device.type == "cuda":
        return True
    if a.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {a.device}")


def fmul(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product with broadcasting (kernel B1 on CUDA)."""
    _check(a, b)
    if not _dispatch(a):
        return fmul_plain(df, a, b)
    return _launch("h2t_fmul", "fmul", df, a, b)


def fadd(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    if not _dispatch(a):
        return fadd_plain(df, a, b)
    return _launch("h2t_faddsub", "faddsub", df, a, b, 0)


def fsub(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    if not _dispatch(a):
        return fsub_plain(df, a, b)
    return _launch("h2t_faddsub", "faddsub", df, a, b, 1)


# ---------------------------------------------------------------------------
# kernel B8: the limbs-first layout (a layout benchmark; no proving path)
# ---------------------------------------------------------------------------

def fmul_limbs_first_plain(df, a_t: torch.Tensor, b_t: torch.Tensor
                           ) -> torch.Tensor:
    """B1's product on limbs-first [16, N] digit arrays: a transpose
    around fmul_plain."""
    return fmul_plain(df, a_t.T, b_t.T).T.contiguous()


def fmul_limbs_first(df, a_t: torch.Tensor, b_t: torch.Tensor
                     ) -> torch.Tensor:
    """Montgomery product of limbs-first [16, N] int32 digit arrays (row i
    holds digit i of every element; the reference's fmul_pallas layout),
    kernel B8 on CUDA."""
    for x in (a_t, b_t):
        if (x.dtype != torch.int32 or x.dim() != 2
                or x.shape[0] != NLIMBS):
            raise TypeError(f"limbs-first operands are int32 [16, N], got "
                            f"{x.dtype} {tuple(x.shape)}")
    if a_t.shape != b_t.shape or a_t.device != b_t.device:
        raise ValueError(f"operands {tuple(a_t.shape)} on {a_t.device} and "
                         f"{tuple(b_t.shape)} on {b_t.device}")
    if not _dispatch(a_t):
        return fmul_limbs_first_plain(df, a_t, b_t)
    from . import cuda_build
    a_t, b_t = a_t.contiguous(), b_t.contiguous()
    out = torch.empty_like(a_t)
    lib = cuda_build.library("field_kernels")
    rc = lib.h2t_fmul_limbs_first(df.field_id, out.data_ptr(),
                                  a_t.data_ptr(), b_t.data_ptr(),
                                  a_t.shape[1],
                                  cuda_build.stream_ptr(a_t.device))
    cuda_build.check(rc, "h2t_fmul_limbs_first")
    LAUNCHES["fmul_limbs_first"] += 1
    return out
