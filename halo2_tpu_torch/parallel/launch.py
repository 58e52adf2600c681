"""Spawn a world of ranks on one host: the torch counterpart of making a
mesh (the JAX package drives every device from one process and needs
none of this).

`run_ranks(fn, world, backend, timeout_s, *args)` starts `world`
processes, each of which joins a process group of `world` ranks over a
file:// store in a fresh temporary directory (so no port is taken, and
worlds started side by side never meet), calls fn(*args) and sends its
result back to the caller. fn is pickled by reference: it must live in
a module the ranks can import (this package, or a module that imports
only this package). The ranks split the host's cores: one torch thread
a rank without a card (the CPU ranks), else cpu_count // world (the
native IPA tail runs on them). The group's collectives time out after
timeout_s
seconds; the caller kills the ranks and raises if they have not all
ended after timeout_s. A card is shared over gloo (NCCL refuses two
ranks on one device); one rank a card can take nccl. `world_of_one` makes
this process alone a group, for a mesh of one rank in process.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
import time


def _init(backend: str, store: str, world: int, rank: int,
          timeout_s: float) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


@contextlib.contextmanager
def world_of_one(backend: str, timeout_s: float):
    """This process as the default process group's only rank, over a
    file:// store in a fresh temporary directory; the group is destroyed
    on exit."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory(prefix="halo2_tpu_torch_world.") as tmp:
        _init(backend, os.path.join(tmp, "store"), 1, 0, timeout_s)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank: int, fn, world: int, backend: str, timeout_s: float,
               tmp: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1 if not torch.cuda.is_available()
                          else max(1, (os.cpu_count() or 1) // world))
    _init(backend, os.path.join(tmp, "store"), world, rank, timeout_s)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def run_ranks(fn, world: int, backend: str, timeout_s: float, *args
              ) -> list:
    """fn(*args) on `world` spawned ranks of one process group; returns
    the ranks' results in rank order. A rank that raises fails the call
    with its traceback (the others are ended); ranks still running after
    timeout_s seconds are killed and TimeoutError is raised."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="halo2_tpu_torch_ranks.") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, timeout_s, tmp, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} "
                                       f"still running after {timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(10)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
