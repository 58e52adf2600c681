"""Device prime-field arithmetic over [..., 16] digit tensors.

Port of halo2_tpu/fields/device.py. A field element is an int32 tensor of
shape [..., 16]: little-endian 16-bit digits of its Montgomery form
(R = 2^256) -- the same values as the reference's uint32 arrays. On CUDA
`fmul` launches kernel B1 and `fadd`/`fsub` the field add/subtract kernel
(ops/field_kernels.py); on the CPU they run the plain PyTorch versions.

The scans (`running_product`, `running_sum`) are Hillis-Steele
log-depth passes of whole-tensor multiplies; they match the reference's
values, not its TPU-shaped fori_loop structure.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .host import FieldSpec, FP, FQ
from ..ops.field_kernels import NLIMBS, LIMB_BITS, MASK, fmul, fadd, fsub

R = 1 << (NLIMBS * LIMB_BITS)  # Montgomery radix 2^256


def int_to_limbs(v: int) -> np.ndarray:
    """Python int -> int32[16] little-endian 16-bit digits (host)."""
    return np.array([(v >> (LIMB_BITS * i)) & MASK for i in range(NLIMBS)],
                    dtype=np.int32)


def ints_to_digits(values) -> np.ndarray:
    """Python ints in [0, 2^256) -> int32 [n, 16] digit array (host)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return (np.frombuffer(buf, np.uint16).astype(np.int32)
            .reshape(-1, NLIMBS))


def digits_to_ints(digits: np.ndarray) -> list:
    """int32/uint [..., 16] digit array -> flat list of Python ints."""
    buf = np.ascontiguousarray(
        np.asarray(digits).reshape(-1, NLIMBS).astype(np.uint16)).tobytes()
    return [int.from_bytes(buf[32 * i:32 * i + 32], "little")
            for i in range(len(buf) // 32)]


@dataclass(frozen=True)
class DeviceField:
    """Static per-field constants; tensors are made on the device asked."""

    spec: FieldSpec

    @functools.cached_property
    def field_id(self) -> int:
        """Kernel field index: 0 = Fp, 1 = Fq (csrc/field.cuh)."""
        return 0 if self.spec.modulus == FP.modulus else 1

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return R * R % self.spec.modulus

    # ---------- host <-> device conversion ----------
    def to_mont_np(self, values) -> np.ndarray:
        """Python ints (any nesting) -> int32 [..., 16] Montgomery digits."""
        arr = np.asarray(values, dtype=object)
        p = self.spec.modulus
        flat = [(int(v) % p) * R % p for v in arr.reshape(-1)]
        return ints_to_digits(flat).reshape(arr.shape + (NLIMBS,))

    def from_mont_np(self, limbs) -> np.ndarray:
        """Montgomery digits (tensor or array) [..., 16] -> object array of
        canonical Python ints. A tensor is converted on its own device
        (one Montgomery multiply by 1) before the readback."""
        if isinstance(limbs, torch.Tensor):
            shape = tuple(limbs.shape[:-1])
            canon = from_mont(self, limbs).cpu().numpy()
            vals = digits_to_ints(canon)
        else:
            a = np.asarray(limbs)
            shape = a.shape[:-1]
            p = self.spec.modulus
            rinv = pow(R, -1, p)
            vals = [v * rinv % p for v in digits_to_ints(a)]
        out = np.empty((len(vals),), dtype=object)
        out[:] = vals
        return out.reshape(shape)

    def scalar(self, v: int, device) -> torch.Tensor:
        """Single field element (int, NOT in Montgomery form) -> [16]."""
        p = self.spec.modulus
        return _const(tuple(int_to_limbs(v % p * R % p)),
                      torch.device(device))

    def upload_values(self, values, device) -> torch.Tensor:
        """Canonical Python ints -> [n, 16] Montgomery tensor: the 16-bit
        digits are copied over and converted by one multiply with R^2."""
        p = self.spec.modulus
        x = torch.from_numpy(ints_to_digits([int(v) % p for v in values]))
        x = x.to(device)
        return fmul(self, x, _const(tuple(int_to_limbs(self.r2_mod_p)),
                                    x.device))

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (NLIMBS,), dtype=torch.int32,
                           device=device)

    def ones(self, shape, device) -> torch.Tensor:
        return self.scalar(1, device).expand(tuple(shape) + (NLIMBS,))


_CONSTS: dict = {}


def _const(digits: tuple, device: torch.device) -> torch.Tensor:
    """[16] constant tensor, cached by digits and device (mont 1, R^2 and
    the domain constants recur in every prove)."""
    key = (digits, device)
    t = _CONSTS.get(key)
    if t is None:
        if len(_CONSTS) > 4096:
            _CONSTS.clear()
        t = _CONSTS[key] = torch.tensor(digits, dtype=torch.int32,
                                        device=device)
    return t


FP_DEV = DeviceField(FP)
FQ_DEV = DeviceField(FQ)


def fneg(df: DeviceField, a: torch.Tensor) -> torch.Tensor:
    return fsub(df, df.zeros((), a.device), a)


def fsquare(df: DeviceField, a: torch.Tensor) -> torch.Tensor:
    return fmul(df, a, a)


def fpow(df: DeviceField, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^e for a static exponent: MSB-first square-and-multiply."""
    if exponent == 0:
        return df.ones(a.shape[:-1], a.device).clone()
    acc = a
    for bit in bin(exponent)[3:]:
        acc = fsquare(df, acc)
        if bit == "1":
            acc = fmul(df, acc, a)
    return acc


def finv(df: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse, 0 -> 0. Used for a handful of elements (Kate
    divisors, batch_inv's one total), so it reads them back and inverts
    with host pow: mont(x)=xR, (xR)^-1 R^2 = mont(x^-1)."""
    p = df.spec.modulus
    vals = digits_to_ints(a.cpu().numpy())
    r2 = R * R % p
    inv = [pow(m, -1, p) * r2 % p if m else 0 for m in vals]
    out = torch.from_numpy(ints_to_digits(inv)).reshape(a.shape)
    return out.to(a.device)


def is_zero(df: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Boolean [...] mask (valid on canonical Montgomery forms)."""
    return (a == 0).all(dim=-1)


def _scan(df: DeviceField, a: torch.Tensor, axis: int, reverse: bool,
          op) -> torch.Tensor:
    """Inclusive Hillis-Steele scan along `axis`: ceil(log2 n) rounds,
    each one whole-tensor combine of x[d:] with x[:-d]."""
    n = a.shape[axis]
    if n <= 1:
        return a
    x = a.movedim(axis, 0)
    if reverse:
        x = torch.flip(x, dims=(0,))
    x = x.contiguous()
    d = 1
    while d < n:
        x = torch.cat([x[:d], op(df, x[d:], x[:-d])], dim=0)
        d *= 2
    if reverse:
        x = torch.flip(x, dims=(0,))
    return x.movedim(0, axis)


def running_product(df: DeviceField, a: torch.Tensor, axis: int = 0,
                    reverse: bool = False) -> torch.Tensor:
    """Inclusive product scan (grand products; permutation z)."""
    return _scan(df, a, axis, reverse, fmul)


def running_sum(df: DeviceField, a: torch.Tensor, axis: int = 0,
                reverse: bool = False) -> torch.Tensor:
    """Inclusive sum scan (Kate-division suffix sums)."""
    return _scan(df, a, axis, reverse, fadd)


def batch_inv(df: DeviceField, a: torch.Tensor, axis: int = 0
              ) -> torch.Tensor:
    """Batched inversion along `axis` via prefix/suffix product scans and
    one inversion of the total; zeros map to zero."""
    zero_mask = is_zero(df, a)
    one = df.scalar(1, a.device)
    clean = torch.where(zero_mask.unsqueeze(-1), one, a)
    prefix_inc = running_product(df, clean, axis=axis)
    suffix_inc = running_product(df, clean, axis=axis, reverse=True)
    x_p = prefix_inc.movedim(axis, 0)
    x_s = suffix_inc.movedim(axis, 0)
    pad = one.expand((1,) + x_p.shape[1:])
    prefix_exc = torch.cat([pad, x_p[:-1]], dim=0)
    suffix_exc = torch.cat([x_s[1:], pad], dim=0)
    total_inv = finv(df, x_p[-1:])
    out = fmul(df, fmul(df, prefix_exc, suffix_exc), total_inv)
    out = out.movedim(0, axis)
    return torch.where(zero_mask.unsqueeze(-1), torch.zeros_like(a), out)


def to_mont(df: DeviceField, a_canonical: torch.Tensor) -> torch.Tensor:
    """Canonical digits [..., 16] -> Montgomery form (mul by R^2)."""
    return fmul(df, a_canonical,
                _const(tuple(int_to_limbs(df.r2_mod_p)), a_canonical.device))


def from_mont(df: DeviceField, a_mont: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical digits (Montgomery mul by 1)."""
    return fmul(df, a_mont, _const(tuple(int_to_limbs(1)), a_mont.device))
