"""Mesh context: routes the prover's device work through the sharded
multi-device layer.

Port of halo2_tpu/parallel/context.py. Activating a ProverMesh makes
Params commits, EvaluationDomain transforms and the grand products of
the permutation and lookup arguments run sharded over the mesh's ranks
(parallel/mesh.py: an all_gather of MSM window sums, all_to_all
exchanges in the four-step NTT, a gathered prefix for the scans). Every
rank runs the same prover on the same inputs and keeps whole tensors;
each branch takes the rank's rows, runs the device work on them and
returns whole tensors through `gather_rows`.

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

from .mesh import Mesh, _all_gather

_ACTIVE: "ProverMesh | None" = None


class ProverMesh:
    """Context manager that activates sharded execution on `mesh`."""

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

    # -- helpers --
    def divides(self, n: int) -> bool:
        """Sharded transforms need D^2 | n (four-step NTT), so D | n."""
        d = self.ndev
        return n % (d * d) == 0

    def shard_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous block of t's n rows along `dim`, a view,
        when D | n; else t unchanged. The reference returns the global
        array laid out across the devices; here every rank holds whole
        tensors and takes its rows out of them."""
        n = t.shape[dim]
        if n % self.ndev:
            return t
        c = n // self.ndev
        return t.narrow(dim, self.rank * c, c)

    def gather_rows(self, local: torch.Tensor, dim: int = 0
                    ) -> torch.Tensor:
        """The inverse of shard_rows: every rank's block along `dim`, in
        rank order, as one whole tensor (an all_gather)."""
        g = _all_gather(self.mesh, local)                # [D, *local.shape]
        shape = list(local.shape)
        shape[dim] *= self.ndev
        return g.movedim(0, dim).reshape(shape)


def active() -> "ProverMesh | None":
    return _ACTIVE


def shard_rows(t: torch.Tensor) -> torch.Tensor:
    """Module-level convenience: this rank's rows under the active mesh
    (t unchanged without one)."""
    ctx = _ACTIVE
    return t if ctx is None else ctx.shard_rows(t)
