"""The multi-device layer: sharded MSM, four-step NTT and grand products
over a torch.distributed process group. Each function takes the rank's
rows and returns the rank's rows (or, for the MSM, the same points on
every rank); parallel/context.py says which tensors the prover keeps as
rows.

Port of halo2_tpu/parallel/mesh.py. The reference shards with one
controller (`shard_map` over a 1-D `jax.sharding.Mesh`, with
`all_gather` and `all_to_all` inside); the port runs one process per
card, SPMD: every rank runs the same prover on the same inputs, and the
functions here take the rank's rows, run the device work on them and
combine the ranks with collectives:

  - MSM: each rank runs the Pippenger (ops/msm_pippenger.py) over its
    n/D rows to device window sums, the ranks all_gather them and sum
    them over ranks with B4 (curves/device.py::tree_sum), then the host
    Horner combine; the group law is exact, so any order gives the
    single-device affine points.
  - NTT: the four-step algorithm (all_to_all, a size-D DFT over C/D
    columns, twiddles, all_to_all, a local size-C NTT with C = n/D, a
    final all_to_all), each step on B7 and B1.
  - Scans: a local running product, then an all_gather of the ranks'
    totals and their exclusive prefix applied with B1.

`_all_gather` and `_all_to_all` are the only calls of torch.distributed.
Where the group's backend cannot take the tensor's device (gloo with a
CUDA tensor, which is how several ranks share one card: NCCL refuses two
ranks on one device), they copy through host memory, counted in
COUNTS["staged"] and COUNTS["staged_bytes"]. COUNTS also counts the
collectives and the calls of each sharded function.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..curves.device import tree_sum
from ..fields.device import (DeviceField, NLIMBS, batch_inv, from_mont,
                             running_product)
from ..ops.field_kernels import fmul
from ..ops.msm import _pad_pow2
from ..ops.msm_pippenger import (horner_combine_host, msm_window_sums_many,
                                 pick_c)
from ..ops.ntt import make_plan, ntt_many

AXIS = "shard"

COUNTS = {"all_gather": 0, "all_to_all": 0, "staged": 0, "staged_bytes": 0,
          "sharded_msm": 0, "sharded_ntt": 0, "sharded_inclusive_product": 0,
          "sharded_batch_inv": 0}


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over a process group: this process is rank `rank` of
    `size`, and its device work runs on `device`."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh over torch.distributed's default process group, which
    the caller has initialized (torchrun and init_process_group, or
    parallel/launch.py::run_ranks). Its device is the card
    cuda:{LOCAL_RANK % device_count} (LOCAL_RANK as torchrun sets it,
    else the rank), made the current device, unless device="cpu" is
    asked; a missing card raises. n_devices, when given, must be the
    group's size."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group first (torchrun, or "
            "halo2_tpu_torch.parallel.launch.run_ranks)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices over a process "
                         f"group of {size} ranks")
    backend = str(dist.get_backend())
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for the plain versions")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    return Mesh(group=dist.group.WORLD, rank=rank, size=size, device=dev,
                backend=backend)


# ---------------------------------------------------------------------------
# The collectives: the only calls of torch.distributed
# ---------------------------------------------------------------------------

def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return t.is_cuda and mesh.backend == "gloo"


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[D, *t.shape]: every rank's t, in rank order, on t's device."""
    t = t.contiguous()
    stage = _staged(mesh, t)
    src = t.cpu() if stage else t
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.stack(parts)
    COUNTS["all_gather"] += 1
    if stage:
        COUNTS["staged"] += 1
        COUNTS["staged_bytes"] += (src.numel() + out.numel()) * \
            src.element_size()
        out = out.to(t.device)
    return out


def _all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t [D, ...]: chunk t[d] goes to rank d; returns [D, ...] whose
    chunk s came from rank s."""
    if t.shape[0] != mesh.size:
        raise ValueError(f"all_to_all of {t.shape[0]} chunks over "
                         f"{mesh.size} ranks")
    t = t.contiguous()
    stage = _staged(mesh, t)
    src = t.cpu() if stage else t
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    COUNTS["all_to_all"] += 1
    if stage:
        COUNTS["staged"] += 1
        COUNTS["staged_bytes"] += 2 * src.numel() * src.element_size()
        out = out.to(t.device)
    return out


# ---------------------------------------------------------------------------
# Sharded MSM
# ---------------------------------------------------------------------------

def sharded_msm(curve, mesh: Mesh, digits16: torch.Tensor,
                pts: torch.Tensor, packed=None) -> list:
    """m MSMs over bases row-sharded along n: digits16 [m, n/D, 16]
    canonical scalars and pts [48, n/D] bases, this rank's rows. Each rank
    runs the Pippenger to window sums with c = pick_c(n/D) (the same on
    every rank, so the sums add up); the ranks all_gather them and sum
    them over ranks with B4, then the host Horner combine. `packed`
    (pack_affine(pts[:32])) says the bases are affine in projective coding
    (the SRS's) and hands the bucket-run kernel their packed rows; without
    it the bases may be any projective points. Returns m affine host
    points (None for the identity), the same on every rank."""
    df = DeviceField(curve.base)
    m, nl = digits16.shape[0], digits16.shape[1]
    if packed is None:
        # projective bases: padded as ops/msm.py::msm pads them
        _, pts = _pad_pow2(df, digits16[0], pts)
        if pts.shape[1] > nl:
            digits16 = torch.cat([digits16, digits16.new_zeros(
                (m, pts.shape[1] - nl, NLIMBS))], dim=1)
    c = pick_c(digits16.shape[1])
    wsums, c = msm_window_sums_many(curve, df, digits16, pts, c=c,
                                    affine=packed is not None, packed=packed)
    W = wsums.shape[2]
    g = _all_gather(mesh, wsums)                          # [D, m, 48, W]
    g = g.permute(2, 0, 1, 3).reshape(3 * NLIMBS, mesh.size, m * W)
    total = tree_sum(df, g, axis=1).view(3 * NLIMBS, m, W).permute(1, 0, 2)
    COUNTS["sharded_msm"] += 1
    return horner_combine_host(curve, df, total, c)


def sharded_msm_mont(curve, mesh: Mesh, scalars_mont: torch.Tensor,
                     pts: torch.Tensor, packed=None) -> list:
    """sharded_msm over Montgomery-form scalars [m, n/D, 16] (as
    polynomial values live on the card), converted on the rank's rows."""
    return sharded_msm(curve, mesh,
                       from_mont(DeviceField(curve.scalar), scalars_mont),
                       pts, packed)


# ---------------------------------------------------------------------------
# Four-step NTT
# ---------------------------------------------------------------------------

class ShardedNttPlan:
    """Tables for a four-step NTT of size n over D ranks: the size-D DFT
    (root omega^C) and the size-C NTT (root omega^D) plans, C = n/D, and
    each rank's twiddle block, made when that rank first asks."""

    def __init__(self, df: DeviceField, n: int, omega: int, ndev: int):
        if n % (ndev * ndev):
            raise ValueError("the four-step NTT needs D^2 | n; use the "
                             "single-device path")
        p = df.spec.modulus
        self.df = df
        self.n = n
        self.ndev = ndev
        self.C = n // ndev
        self.omega = omega
        self.plan_rows = make_plan(df, ndev, pow(omega, self.C, p))
        self.plan_cols = make_plan(df, self.C, pow(omega, ndev, p))
        self._tw: dict = {}

    def twiddle_block(self, d: int) -> np.ndarray:
        """Montgomery [D, C/D, 16] twiddles of rank d:
        tw[k_r, cl] = omega^((d C/D + cl) k_r), each row a geometric
        sequence."""
        p = self.df.spec.modulus
        D, CL = self.ndev, self.C // self.ndev
        vals = []
        for k_r in range(D):
            step = pow(self.omega, k_r, p)
            cur = pow(self.omega, d * CL * k_r, p)
            for _ in range(CL):
                vals.append(cur)
                cur = cur * step % p
        return self.df.to_mont_np(vals).reshape(D, CL, NLIMBS)

    def twiddles(self, d: int, device) -> torch.Tensor:
        """Rank d's block as [C/D, D, 16] on `device` (the layout the
        DFT's output takes), made once."""
        device = torch.device(device)
        key = (d, device)
        tw = self._tw.get(key)
        if tw is None:
            tw = self._tw[key] = torch.from_numpy(np.ascontiguousarray(
                self.twiddle_block(d).transpose(1, 0, 2))).to(device)
        return tw


def sharded_ntt(df: DeviceField, mesh: Mesh, plan: ShardedNttPlan,
                x: torch.Tensor) -> torch.Tensor:
    """Forward NTT of the rank's contiguous rows x [C, 16] (or m columns
    at once, [m, C, 16]) of n = D C: returns the rank's rows of the
    natural-order transform, as the reference's P(AXIS) sharding.

    With i = r C + c and k = k_r + D k_c, X[k] = sum_c omega_C^(c k_c)
    omega^(c k_r) sum_r omega_D^(r k_r) a[i]: rank t gathers the D rows'
    chunk c in [t CL, (t+1) CL) (CL = C/D), runs the size-D DFTs, scales
    by its twiddles, sends k_r = d to rank d, runs the size-C NTT (then
    rank d holds X[d + D k_c] for every k_c) and sends each rank its
    contiguous block."""
    D, C = mesh.size, plan.C
    if plan.ndev != D:
        raise ValueError(f"a plan for {plan.ndev} ranks on a mesh of {D}")
    single = x.dim() == 2
    if single:
        x = x.unsqueeze(0)
    m = x.shape[0]
    if x.shape[1] != C:
        raise ValueError(f"{x.shape[1]} rows on a rank, want n/D = {C}")
    CL = C // D
    # 1: chunk t of the columns to rank t -> [D(r), m, CL, 16]
    a = _all_to_all(mesh, x.view(m, D, CL, NLIMBS).transpose(0, 1))
    # 2: the size-D DFT over r of each (column, c)
    rows = a.permute(1, 2, 0, 3).reshape(m * CL, D, NLIMBS)
    dft = ntt_many(df, rows, plan.plan_rows).view(m, CL, D, NLIMBS)
    # 3: twiddles omega^(c k_r)
    t = fmul(df, dft, plan.twiddles(mesh.rank, x.device))
    # 4: k_r = d to rank d -> [D(source s), m, CL, 16], c = s CL + cl
    b = _all_to_all(mesh, t.permute(2, 0, 1, 3))
    row = b.transpose(0, 1).reshape(m, C, NLIMBS)
    # 5: the size-C NTT with root omega^D: X[d + D k_c]
    X = ntt_many(df, row, plan.plan_cols)
    # 6: k_c in [t CL, (t+1) CL) to rank t; entry [s, j] = X[s + D j] of
    # the block
    fin = _all_to_all(mesh, X.view(m, D, CL, NLIMBS).transpose(0, 1))
    out = fin.permute(1, 2, 0, 3).reshape(m, C, NLIMBS)
    COUNTS["sharded_ntt"] += 1
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Sharded scans and batched inversion
# ---------------------------------------------------------------------------

def sharded_inclusive_product(df: DeviceField, mesh: Mesh,
                              x: torch.Tensor) -> torch.Tensor:
    """Inclusive running product of the rank's rows x [n/D, 16] of a
    row-sharded column: the local scan, then the product of the earlier
    ranks' totals (an all_gather of every rank's) applied with B1. Field
    products are exact, so the rows equal the single-device scan's."""
    inc = running_product(df, x, axis=0)
    totals = _all_gather(mesh, inc[-1])                   # [D, 16]
    COUNTS["sharded_inclusive_product"] += 1
    if mesh.rank == 0:
        return inc
    excl = running_product(df, totals[:mesh.rank], axis=0)[-1]
    return fmul(df, inc, excl)


def sharded_batch_inv(df: DeviceField, mesh: Mesh,
                      x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of the rank's rows x [n/D, 16], zeros to zero:
    each rank runs the batched inversion on its own rows (an inverse
    depends on its element alone, so the rows equal a whole-column
    inversion's) and needs no collective."""
    COUNTS["sharded_batch_inv"] += 1
    return batch_inv(df, x, axis=0)
