"""Mesh context: routes the prover's device work through the sharded
multi-device layer, and the row layouts the prover's tensors take.

Port of halo2_tpu/parallel/context.py. Activating a ProverMesh makes
Params commits, EvaluationDomain transforms and the grand products of
the permutation and lookup arguments run sharded over the mesh's ranks
(parallel/mesh.py: an all_gather of MSM window sums, all_to_all
exchanges in the four-step NTT, a gathered prefix for the scans).

The prover holds its state in one of two layouts. Under a ProverMesh that
takes the circuit's rows (`takes_rows`), each rank holds only its
contiguous block of n/D (or ext_n/D) rows of every column: the proving
key once re-laid (plonk/prover.py), the instance and advice values and
everything made from them. The ProverMesh itself is then the layout: its
row methods (`roll_rows`, `put_rows`, `fetch_row`, the scans and the sum
over ranks) run on local blocks, and the branches that take a `rows`
argument treat their tensors as local. Otherwise the layout is WHOLE:
every tensor holds all its rows, and a branch called under an active mesh
with whole tensors narrows them to the rank's rows (`shard_rows`) and
gathers its result back whole (`gather_rows`), as it did before ranks
held their rows.

Field and group arithmetic are exact, so a proof made under a mesh of any
size is byte-identical to the single-device proof. Usage, one process a
card (torchrun --nproc_per_node=N):

    torch.distributed.init_process_group("nccl")
    mesh = make_mesh()
    with ProverMesh(mesh):
        create_proof(params, pk, [circuit], [inst], rng, transcript)
"""
from __future__ import annotations

import torch

from .mesh import (Mesh, _all_gather, sharded_batch_inv,
                   sharded_inclusive_product)

_ACTIVE: "ProverMesh | None" = None


class WholeRows:
    """The single-device layout: a tensor holds every row of its column.
    Its row methods are those of ProverMesh on a world of one rank,
    without a collective (the scans stay the callers' own)."""
    local = False
    rank = 0

    def key(self):
        return None

    def row_span(self, n: int) -> tuple:
        return 0, n

    def local_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    def gather_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    def roll_rows(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        return torch.roll(t, shift, dims=0) if shift else t

    def put_rows(self, t: torch.Tensor, start: int, rows: torch.Tensor
                 ) -> torch.Tensor:
        out = t.clone()
        out[start:start + rows.shape[0]] = rows
        return out

    def fetch_row(self, t: torch.Tensor, i: int) -> torch.Tensor:
        return t[i]

    def sum_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        return t


WHOLE = WholeRows()


class ProverMesh:
    """Context manager that activates sharded execution on `mesh`; as a
    row layout, this rank's contiguous block of every column."""
    local = True

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.ndev = mesh.size
        self.rank = mesh.rank
        self._prev = None

    # -- activation --
    def __enter__(self):
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False

    # -- routing --
    def divides(self, n: int) -> bool:
        """Sharded transforms need D^2 | n (four-step NTT), so D | n."""
        d = self.ndev
        return n % (d * d) == 0

    def takes_rows(self, n: int, max_shift: int) -> bool:
        """Whether the ranks can hold their rows of a circuit of n rows
        whose arguments roll a column by at most max_shift rows (of n; on
        the extended domain the shift and the block grow alike): the
        sharded transforms need D^2 | n, and roll_rows takes a shift of
        at most the rank's rows from one neighbour. Where this is false
        the prover keeps whole tensors."""
        return self.divides(n) and max_shift <= n // self.ndev

    def key(self):
        return (self.ndev, self.rank)

    # -- whole tensors under the mesh --
    def shard_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous block of t's n rows along `dim`, a view,
        when D | n; else t unchanged. For a branch given a whole tensor:
        a local block is never passed here."""
        n = t.shape[dim]
        if n % self.ndev:
            return t
        c = n // self.ndev
        return t.narrow(dim, self.rank * c, c)

    def gather_rows(self, local: torch.Tensor, dim: int = 0
                    ) -> torch.Tensor:
        """Every rank's block along `dim`, in rank order, as one whole
        tensor (an all_gather; a world of one rank holds it already)."""
        if self.ndev == 1:
            return local
        g = _all_gather(self.mesh, local)                # [D, *local.shape]
        shape = list(local.shape)
        shape[dim] *= self.ndev
        return g.movedim(0, dim).reshape(shape)

    # -- the layout of a rank's rows --
    def row_span(self, n: int) -> tuple:
        """(first row, row count) of this rank's block of n rows."""
        if n % self.ndev:
            raise ValueError(f"{n} rows over {self.ndev} ranks")
        c = n // self.ndev
        return self.rank * c, c

    def local_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of the whole tensor t along `dim`, in storage
        of its own: no view keeps the whole tensor alive."""
        start, c = self.row_span(t.shape[dim])
        return t.narrow(dim, start, c).clone()

    def roll_rows(self, local: torch.Tensor, shift: int) -> torch.Tensor:
        """This rank's rows of torch.roll(whole, shift, dims=0): a roll by
        s > 0 takes the last s rows of the rank before (the first rank
        the last rank's), s < 0 the first |s| rows of the rank after, each
        rank's edge slab in one all_gather. |shift| is at most the local
        rows (takes_rows)."""
        c = local.shape[0]
        a = abs(shift)
        if a == 0:
            return local
        if a > c:
            raise ValueError(f"a roll by {shift} rows over blocks of {c}")
        if shift > 0:
            slabs = _all_gather(self.mesh, local[c - a:])
            halo = slabs[(self.rank - 1) % self.ndev]
            return torch.cat([halo, local[:c - a]], dim=0)
        slabs = _all_gather(self.mesh, local[:a])
        halo = slabs[(self.rank + 1) % self.ndev]
        return torch.cat([local[a:], halo], dim=0)

    def put_rows(self, local: torch.Tensor, start: int, rows: torch.Tensor
                 ) -> torch.Tensor:
        """local with the whole column's rows [start, start + len(rows))
        set to `rows` where they fall in this rank's block (a copy)."""
        c = local.shape[0]
        lo = self.rank * c
        a, b = max(start, lo), min(start + rows.shape[0], lo + c)
        out = local.clone()
        if a < b:
            out[a - lo:b - lo] = rows[a - start:b - start].to(out.device)
        return out

    def fetch_row(self, local: torch.Tensor, i: int) -> torch.Tensor:
        """Row i of the whole column on every rank: an all_gather of one
        row a rank, taken from the rank that holds it."""
        c = local.shape[0]
        owner = i // c
        mine = local[i - owner * c if owner == self.rank else 0]
        return _all_gather(self.mesh, mine)[owner]

    def batch_inv(self, df, x: torch.Tensor) -> torch.Tensor:
        return sharded_batch_inv(df, self.mesh, x)

    def inclusive_product(self, df, x: torch.Tensor) -> torch.Tensor:
        return sharded_inclusive_product(df, self.mesh, x)

    def sum_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's t (an all_gather, summed in rank
        order)."""
        return _all_gather(self.mesh, t).sum(dim=0)


def active() -> "ProverMesh | None":
    return _ACTIVE


def shard_rows(t: torch.Tensor) -> torch.Tensor:
    """Module-level convenience: this rank's rows under the active mesh
    (t unchanged without one)."""
    ctx = _ACTIVE
    return t if ctx is None else ctx.shard_rows(t)


def work_rows(rows, n: int):
    """(layout, narrow) in which a grand product over columns of n rows
    laid out by `rows` runs: `rows` itself when it holds a rank's rows;
    under an active mesh whose D^2 divides n, the mesh, with narrow True
    (the whole inputs are narrowed to the rank's rows and the result
    gathered whole); else WHOLE."""
    if rows.local:
        return rows, False
    ctx = _ACTIVE
    if ctx is not None and ctx.divides(n):
        return ctx, True
    return WHOLE, False
