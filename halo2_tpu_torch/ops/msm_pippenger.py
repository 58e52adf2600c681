"""Pippenger MSM on the point kernels B2-B5.

Port of halo2_tpu/ops/msm_pallas.py (the reference's TPU Pippenger):

  1. window digits [W, n] per scalar set (signed by default: abs values
     index half as many buckets, the sign rides the free negation);
  2. a sort per window row and the bucket run starts (torch.sort /
     torch.searchsorted);
  3. bucket accumulation over [48, G*BL] lanes, one per (row, bucket):
     for affine bases such as the SRS, one launch of the bucket-run
     kernel, each lane summing its whole run with the mixed add (B2's
     formulas) and reading its own bases, signs and run bounds; for
     projective ones such as the IPA's folded G', round r adds the r-th
     member of every run at once with the complete add (B3, which gathers
     and negates its own operand); skewed inputs (few distinct digits)
     take a log-depth segmented scan (B3) instead;
  4. summation by parts: suffix sums over the bucket axis and a halving
     tree sum (B3, reading its operand at a lane offset within each
     window's row), one point per window;
  5. the window Horner combine: on the host (tiny serial group work), or
     on the device with the doubling (B5) and the complete add (B4).

The group law is exact, so any schedule gives the same affine result as
the reference; only projective representatives differ along the way.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from .field_kernels import NLIMBS
from .point_kernels import (bucket_members, ident_col, pack_affine,
                            padd_flat, padd_masked_flat, pdouble_flat,
                            pmixed_bucket_runs, points_from_proj)

# Window-size model: a round of the bucket loop costs its lane count plus
# a fixed launch-and-gather overhead, counted in lanes. The TPU value
# (msm_pallas.py:73, 8192) was calibrated on a v5e and does not carry
# over; this is an assumed GPU value (a ~10 us launch+gather against
# lanes that cost well under a nanosecond each), to be re-calibrated on
# the card. The window size c changes no result.
_ROUND_OVERHEAD_LANES = 1 << 14


def pick_c(n: int, signed: bool = True) -> int:
    """Window size minimising rounds x (lanes + overhead) for one scalar
    set of n points (lane-count model, see _ROUND_OVERHEAD_LANES)."""
    best_c, best_cost = 4, float("inf")
    for c in range(4, 17):
        W = -(-256 // c)
        BL = 1 << (c - 1) if signed else 1 << c
        per_bucket = n / BL
        maxrun = per_bucket + 3.0 * math.sqrt(per_bucket) + 4.0
        rounds = maxrun + 2 * int(math.ceil(math.log2(BL)))
        cost = rounds * (W * BL + _ROUND_OVERHEAD_LANES)
        if cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def window_digits(digits16: torch.Tensor, c: int) -> torch.Tensor:
    """Canonical digits [n, 16] -> [W, n] int64 c-bit windows (LSB
    window first)."""
    n = digits16.shape[0]
    W = -(-256 // c)
    ext = torch.cat([digits16.to(torch.int64),
                     torch.zeros((n, 1), dtype=torch.int64,
                                 device=digits16.device)], dim=1)
    mask = (1 << c) - 1
    outs = []
    for w in range(W):
        bit = c * w
        li, off = bit // 16, bit % 16
        val = ext[:, li] >> off
        if off + c > 16:
            val = val | (ext[:, li + 1] << (16 - off))
        outs.append(val & mask)
    return torch.stack(outs, dim=0)


def window_digits_signed(digits16: torch.Tensor, c: int):
    """[n, 16] canonical digits -> (abs [W, n] in [0, 2^(c-1)], sign
    [W, n] 0/1), with the carries in closed form: the carry into window w
    is bit cw-1 of the value AND (its lower cw-1 bits nonzero)."""
    d = window_digits(digits16, c)
    W = d.shape[0]
    n = digits16.shape[0]
    dig = digits16.to(torch.int64)
    full = 1 << c
    limb_nz = dig != 0
    pnz = [torch.zeros((n,), dtype=torch.bool, device=dig.device)]
    for li in range(1, 17):
        pnz.append(pnz[-1] | limb_nz[:, li - 1])
    zero = torch.zeros((n,), dtype=torch.int64, device=dig.device)

    def carry_into(w: int) -> torch.Tensor:
        t = c * w
        if t == 0 or t - 1 >= 256:
            return zero
        li, b = (t - 1) // 16, (t - 1) % 16
        bit = (dig[:, li] >> b) & 1
        low_nz = pnz[li] | ((dig[:, li] & ((1 << b) - 1)) != 0)
        return bit & low_nz.to(torch.int64)

    carries = [carry_into(w) for w in range(W + 1)]
    absd, signs = [], []
    for w in range(W):
        v = d[w] + carries[w]
        neg = carries[w + 1]
        absd.append(torch.where(neg.bool(), full - v, v))
        signs.append(neg)
    return torch.stack(absd, dim=0), torch.stack(signs, dim=0)


class BucketRuns(NamedTuple):
    """The bucket runs of m MSMs' G = m W window rows over n bases: the
    sorted digits `ds` [G, n] and their base indices `order`, the signs
    `sg` [G, n] by base index (None for unsigned digits), each bucket's
    run end `ends` and length `eff_counts` [G, BL], and each lane's run
    slice after the top-window slotting, `starts_e` and `counts_e`
    [G, BL] (S slices a top-row bucket, over L_pow live buckets; `is_top`
    marks the top rows)."""
    ds: torch.Tensor
    order: torch.Tensor
    sg: torch.Tensor | None
    ends: torch.Tensor
    eff_counts: torch.Tensor
    starts_e: torch.Tensor
    counts_e: torch.Tensor
    BL: int
    S: int
    L_pow: int
    is_top: np.ndarray


def bucket_runs(cv_spec, digits16: torch.Tensor, c: int,
                signed: bool = True) -> BucketRuns:
    """Window digits, a sort per row and the run bounds of every bucket
    lane (msm_pallas.py:196-318), for [m, n, 16] canonical scalars."""
    dev = digits16.device
    m, n = digits16.shape[0], digits16.shape[1]
    W = -(-256 // c)
    G = m * W
    if signed:
        parts = [window_digits_signed(digits16[j], c) for j in range(m)]
        d = torch.cat([p[0] for p in parts], dim=0)          # [G, n]
        sg = torch.cat([p[1] for p in parts], dim=0)
        BL, bucket0 = 1 << (c - 1), 1
    else:
        d = torch.cat([window_digits(digits16[j], c) for j in range(m)],
                      dim=0)
        sg = None
        BL, bucket0 = 1 << c, 0
    ds, order = torch.sort(d, dim=1, stable=True)               # [G, n]
    buckets = (torch.arange(BL, dtype=torch.int64, device=dev)
               + bucket0).expand(G, BL).contiguous()
    starts = torch.searchsorted(ds, buckets)                     # [G, BL]
    ends = torch.cat([starts[:, 1:],
                      torch.full((G, 1), n, dtype=starts.dtype,
                                 device=dev)], dim=1)
    counts = ends - starts
    eff_counts = counts.clone()
    if not signed:
        eff_counts[:, 0] = 0  # digit 0 contributes nothing

    # top-window in-row slotting (msm_pallas.py:282-318): the top window
    # spans only a few bits of entropy, so its dead bucket lanes each
    # take a slice of a live bucket's run
    maxv = int((cv_spec.scalar.modulus - 1) >> (c * (W - 1))) + 1
    L_pow = 1 << max(1, (maxv + 1 - bucket0).bit_length())
    S = max(1, BL // L_pow)
    is_top = np.zeros(G, dtype=bool)
    is_top[np.arange(W - 1, G, W)] = True
    if S > 1:
        lane = torch.arange(BL, device=dev)
        sb, ss = lane // S, lane % S
        g_starts = starts[:, sb]
        g_counts = eff_counts[:, sb]
        Ls = (g_counts + (S - 1)) // S
        itop = tracing.upload("msm", torch.from_numpy(is_top), dev)[:, None]
        starts_e = torch.where(itop, g_starts + ss[None, :] * Ls, starts)
        counts_e = torch.where(
            itop, torch.minimum(torch.clamp(g_counts - ss[None, :] * Ls,
                                            min=0), Ls), eff_counts)
    else:
        starts_e, counts_e = starts, eff_counts
    return BucketRuns(ds, order, sg, ends, eff_counts, starts_e, counts_e,
                      BL, S, L_pow, is_top)


def msm_window_sums_many(cv_spec, df, digits16: torch.Tensor,
                         pts: torch.Tensor, c: int | None = None,
                         signed: bool = True, affine: bool = True,
                         packed=None):
    """m MSMs over shared bases: returns ([m, 48, W] window sums, c).

    digits16: [m, n, 16] canonical scalars; pts: [48, n] projective bases.
    affine: the bases are affine in projective coding (Z in {0, mont 1},
    as the SRS bases are), so pts[:32] is the affine batch with identity
    coded (0, mont 1) whose mixed adds the bucket-run kernel runs, from
    `packed` (pack_affine(pts[:32]), made here if None); with
    affine=False (any Z, the reference's aff=None) the loop adds whole
    [48] bases with B3, which reads each lane's base by index and negates
    it by the lane's sign. signed: signed window digits
    (half the buckets) or unsigned ones.
    (Port of msm_pallas_window_sums_many, msm_pallas.py:196-543.)"""
    dev = pts.device
    m, n = digits16.shape[0], digits16.shape[1]
    if c is None:
        c = pick_c(n, signed)
    W = -(-256 // c)
    G = m * W
    (ds, order, sg, ends, eff_counts, starts_e, counts_e, BL, S, L_pow,
     is_top) = bucket_runs(cv_spec, digits16, c, signed)
    maxc = int(counts_e.max())
    maxc_full = int(eff_counts.max())
    ident = ident_col(df, dev)
    lanes = G * BL

    # serial rounds ~ maxc x lanes against scan rounds ~ log2(maxrun) x G*n
    # (the reference picks per input the same way, msm_pallas.py:489-491)
    skew_threshold = max(2 * c * ((n // BL) + 1) + 2 * c, 64)
    if maxc > skew_threshold:
        acc = _segmented_scan(df, pts, ds, order, sg, ends, eff_counts,
                              maxc_full, G, n, BL, ident)
    else:
        if affine:
            if packed is None:
                packed = pack_affine(pts[:2 * NLIMBS])
            acc = pmixed_bucket_runs(df, packed, bucket_members(order, sg),
                                     starts_e.reshape(-1),
                                     counts_e.reshape(-1), BL)
        else:
            acc = _projective_rounds(df, pts, order, sg, starts_e, counts_e,
                                     maxc, ident)
        if S > 1:
            acc = _unslot(df, acc, is_top, G, BL, S, L_pow, ident)

    # summation by parts: lane j holds bucket j + bucket0, so the sum of
    # the suffix sums is sum_b (b - bucket0 + 1) S_b
    bidx = torch.arange(BL, device=dev)
    logb = int(math.ceil(math.log2(BL)))
    for i in range(logb):
        s = 1 << i
        mask = (bidx + s < BL).expand(G, BL).reshape(-1)
        acc = padd_masked_flat(df, acc, acc, mask, width=BL, shift=-s,
                               live=G * (BL - s))
    if not signed:
        acc3 = acc.view(3 * NLIMBS, G, BL).clone()
        acc3[:, :, 0] = ident[:, None]        # drop bucket 0
        acc = acc3.reshape(3 * NLIMBS, lanes)
    for i in range(logb):
        half = BL >> (i + 1)
        mask = (bidx < half).expand(G, BL).reshape(-1)
        acc = padd_masked_flat(df, acc, acc, mask, width=BL, shift=-half,
                               live=G * half)
    wsums = acc.view(3 * NLIMBS, G, BL)[:, :, 0]                 # [48, G]
    return wsums.reshape(3 * NLIMBS, m, W).permute(1, 0, 2), c


def _round_live(counts_e: torch.Tensor, maxc: int) -> list:
    """The projective bucket loop's live lanes in each round r < maxc,
    those whose run is longer than r (B3's work), read back at once."""
    hist = torch.bincount(counts_e.reshape(-1), minlength=maxc + 1)
    return (counts_e.numel() - hist.cumsum(0)).tolist()


def _scan_live(ds: torch.Tensor, steps: list) -> list:
    """The segmented scan's live lanes in each step d, those d or more
    into a run of equal digits (B3's work), read back at once."""
    if not steps:
        return []
    return torch.stack([(ds[:, d:] == ds[:, :-d]).sum()
                        for d in steps]).tolist()


def _projective_rounds(df, pts, order, sg, starts_e, counts_e, maxc,
                       ident):
    """The bucket loop over projective bases: round r adds the r-th member
    of every lane's run with B3, which gathers each lane's base by index
    and negates it by its sign (msm_pallas.py:335-347)."""
    dev = pts.device
    G, n = order.shape
    lanes = starts_e.numel()
    BL = lanes // G
    live = _round_live(counts_e, maxc)
    acc = ident[:, None].expand(3 * NLIMBS, lanes).contiguous()
    src = pts.contiguous()
    g_off = (torch.arange(G, device=dev) * n)[:, None]
    order_flat = order.reshape(-1)
    sg_flat = sg.reshape(-1) if sg is not None else None
    # gather indices, valid bits and signs for a block of rounds at once
    # (a few large gathers instead of several small ones per round)
    block = max(1, (1 << 24) // max(1, lanes))
    for r0 in range(0, maxc, block):
        rr = torch.arange(r0, min(maxc, r0 + block), device=dev)
        idx = torch.clamp(starts_e[None] + rr[:, None, None], max=n - 1)
        gidx = order_flat[(idx + g_off[None]).reshape(-1)].view(-1, lanes)
        valid = (rr[:, None, None] < counts_e[None]).reshape(
            -1, lanes).to(torch.int32)
        sig = (sg_flat[(gidx.view(-1, G, BL) + g_off[None]).reshape(-1)]
               .view(-1, lanes).to(torch.int32)
               if sg_flat is not None else None)
        gidx = gidx.to(torch.int32)
        for j in range(rr.shape[0]):
            acc = padd_masked_flat(df, acc, src, valid[j], idx=gidx[j],
                                   sign=sig[j] if sig is not None else None,
                                   live=live[r0 + j])
    return acc


def _negate_y(df, P: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """-P where sig is set, by Y -> p - Y (the scan's starting points)."""
    from ..fields.device import fneg
    Y = P[NLIMBS:2 * NLIMBS].T
    Y = torch.where(sig.bool()[:, None], fneg(df, Y.contiguous()), Y)
    return torch.cat([P[:NLIMBS], Y.T, P[2 * NLIMBS:]], dim=0)


def _unslot(df, acc, is_top, G, BL, S, L_pow, ident):
    """Tree-add the S slices of each top-row bucket into slice 0, move
    bucket j's total from lane j*S to lane j and fill lanes >= L_pow with
    the identity (msm_pallas.py:400-434)."""
    dev = acc.device
    lane_mod = torch.arange(BL, device=dev) % S
    trow = tracing.upload("msm", torch.from_numpy(is_top), dev)[:, None]
    for i in range(int(math.log2(S))):
        h = S >> (i + 1)
        mask = (trow & (lane_mod < h)[None, :]).reshape(-1)
        acc = padd_masked_flat(df, acc, acc, mask, width=BL, shift=-h,
                               live=int(is_top.sum()) * (BL // S) * h)
    perm = np.arange(BL)
    perm[:L_pow] = np.arange(L_pow) * S
    gidx2 = np.tile(np.arange(BL), (G, 1))
    gidx2[is_top] = perm
    gflat = (np.arange(G)[:, None] * BL + gidx2).reshape(-1)
    acc = acc[:, tracing.upload("msm", torch.from_numpy(gflat), dev)]
    kill = np.zeros((G, BL), dtype=bool)
    kill[is_top] = np.arange(BL)[None, :] >= L_pow
    return torch.where(
        tracing.upload("msm", torch.from_numpy(kill.reshape(-1)), dev)[None],
        ident[:, None], acc)


def _segmented_scan(df, pts, ds, order, sg, ends, eff_counts, maxc_full,
                    G, n, BL, ident):
    """Log-depth branch for skewed digit rows (few distinct scalars): a
    Hillis-Steele segmented scan over the sorted points reduces every run
    in ceil(log2 maxrun) rounds of one [48, G*n] masked add
    (msm_pallas.py:437-484)."""
    dev = pts.device
    steps = [1 << i for i in range(max(0, maxc_full - 1).bit_length())]
    live = _scan_live(ds, steps)
    cur = pts[:, order.reshape(-1)]                             # [48, G*n]
    if sg is not None:
        cur = _negate_y(df, cur, torch.gather(sg, 1, order).reshape(-1))
    pos = torch.arange(n, device=dev)[None, :]
    for d, n_live in zip(steps, live):
        same = torch.roll(ds, d, dims=1) == ds
        mask = (same & (pos >= d)).reshape(-1)
        cur = padd_masked_flat(df, cur, cur, mask, width=n, shift=d,
                               live=n_live)
    endpos = torch.clamp(ends - 1, min=0)
    flat = (torch.arange(G, device=dev)[:, None] * n + endpos).reshape(-1)
    sums = cur[:, flat]
    nonempty = (eff_counts > 0).reshape(-1)
    return torch.where(nonempty[None, :], sums, ident[:, None])


def _host_proj_add(p, a, b):
    """RCB complete add on host int 3-tuples (X, Y, Z); a=0, b3 = 15."""
    X1, Y1, Z1 = a
    X2, Y2, Z2 = b
    t0 = X1 * X2 % p
    t1 = Y1 * Y2 % p
    t2 = Z1 * Z2 % p
    t3 = ((X1 + Y1) * (X2 + Y2) - t0 - t1) % p
    t4 = ((Y1 + Z1) * (Y2 + Z2) - t1 - t2) % p
    xz = ((X1 + Z1) * (X2 + Z2) - t0 - t2) % p
    s0 = 3 * t0 % p
    b3z = 15 * t2 % p
    z3 = (t1 + b3z) % p
    s1 = (t1 - b3z) % p
    y3 = 15 * xz % p
    X3 = (t3 * s1 - t4 * y3) % p
    Y3 = (y3 * s0 + s1 * z3) % p
    Z3 = (z3 * t4 + s0 * t3) % p
    return (X3, Y3, Z3)


def _host_proj_double(p, a):
    X, Y, Z = a
    t0 = Y * Y % p
    z3 = 8 * t0 % p
    t1 = Y * Z % p
    t2 = 15 * (Z * Z % p) % p
    X3 = t2 * z3 % p
    Y3 = t0 + t2
    Z3 = t1 * z3 % p
    t1 = 2 * t2
    t2 = (t1 + t2) % p
    t0 = (t0 - t2) % p
    Y3 = (t0 * Y3 + X3) % p
    t1 = X * Y % p
    X3 = 2 * t0 * t1 % p
    return (X3, Y3, Z3)


def host_horner_combine(spec, window_pts: list, c: int):
    """Host Horner over MSB-first window sums (msm_pallas.py:585).
    window_pts: affine host points, LSB window first."""
    p = spec.base.modulus
    acc = (0, 1, 0)
    for pt in reversed(window_pts):
        for _ in range(c):
            acc = _host_proj_double(p, acc)
        if pt is not None:
            acc = _host_proj_add(p, acc, (pt[0], pt[1], 1))
    X, Y, Z = acc
    if Z == 0:
        return None
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


def device_horner_combine(df, wsums: torch.Tensor, c: int) -> torch.Tensor:
    """Window combine on the device (msm_pallas.py:602-618): over the
    windows MSB first, c doublings (B5) and one complete add (B4).
    wsums: [48, ..., W] window sums, LSB window first -> [48, ...]
    projective sums; the middle axes are lanes of every launch."""
    W = wsums.shape[-1]
    ws = wsums.reshape(3 * NLIMBS, -1, W)
    acc = ident_col(df, wsums.device)[:, None].expand(
        3 * NLIMBS, ws.shape[1]).contiguous()
    for w in reversed(range(W)):
        for _ in range(c):
            acc = pdouble_flat(df, acc)
        acc = padd_flat(df, acc, ws[:, :, w])
    return acc.reshape(wsums.shape[:-1])


def msm_many(cv_spec, df, digits16: torch.Tensor, pts: torch.Tensor,
             c: int | None = None, signed: bool = True,
             affine: bool = True, packed=None) -> list:
    """m MSMs -> m affine host points (device window sums + host
    combine); arguments as msm_window_sums_many."""
    wsums, c = msm_window_sums_many(cv_spec, df, digits16, pts, c, signed,
                                    affine, packed)
    return horner_combine_host(cv_spec, df, wsums, c)


def horner_combine_host(cv_spec, df, wsums: torch.Tensor, c: int) -> list:
    """[m, 48, W] device window sums -> m affine host points: one
    readback, then the host Horner combine of each."""
    wnp = wsums.cpu().numpy()
    return [host_horner_combine(cv_spec, points_from_proj(df, wnp[j]), c)
            for j in range(wnp.shape[0])]
