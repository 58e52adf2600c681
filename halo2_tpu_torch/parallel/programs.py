"""Rank programs: what every rank of a world spawned by
parallel/launch.py::run_ranks runs to check the mesh layer and to prove
under it. tests/test_torch_mesh.py (gloo on the CPU, held against the JAX
package in the parent), tests/test_torch_cuda.py and chip_smoke.py
(worlds that share one card over gloo) use them.

`run(device, tasks)` makes the rank's mesh and runs each task
(name, kind, keywords) in order, the same order on every rank, since the
tasks' collectives must meet. Results are plain Python values, bytes and
numpy arrays, sent back to the caller. Inputs are made on each rank from
a numpy seed (`field_values`), so every rank holds the same whole
tensors, as the prover's ranks do before they keep their rows.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from . import mesh as mesh_mod
from .context import ProverMesh
from .mesh import (ShardedNttPlan, make_mesh, sharded_batch_inv,
                   sharded_inclusive_product, sharded_ntt)

_CACHE: dict = {}     # per rank process: Params and keys, made once


def field_values(spec, n: int, seed: int, zeros=(3, 40)) -> list:
    """n canonical field elements from a numpy seed, 0 at the rows
    `zeros` (those below n)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.modulus
            for _ in range(n)]
    for z in zeros:
        if z < n:
            vals[z] = 0
    return vals


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _counts_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in mesh_mod.COUNTS.items()}


def _launches() -> dict:
    from ..ops import field_kernels as fk
    from ..ops import ntt
    from ..ops import point_kernels as pk
    return {**fk.LAUNCHES, **pk.LAUNCHES, **ntt.LAUNCHES}


def _upload(mesh, vals, df=None):
    """Canonical ints -> Montgomery digits of df (Fq by default) on the
    rank's device."""
    from ..fields.device import FQ_DEV
    df = FQ_DEV if df is None else df
    return torch.from_numpy(df.to_mont_np(vals)).to(mesh.device)


def task_ntt(mesh, log_n: int, seed: int, inverse: bool = False) -> dict:
    """sharded_ntt of one column of 2^log_n Fq elements (the rank's rows
    of it), gathered whole; "single": equal to ntt_many of the whole
    column on the rank's device."""
    from ..fields.device import FQ_DEV as df
    from ..ops.ntt import make_plan, ntt_many
    spec = df.spec
    n = 1 << log_n
    x = _upload(mesh, field_values(spec, n, seed))
    omega = pow(spec.root_of_unity, 1 << (spec.s - log_n), spec.modulus)
    if inverse:
        omega = pow(omega, spec.modulus - 2, spec.modulus)
    ctx = ProverMesh(mesh)
    plan = ShardedNttPlan(df, n, omega, mesh.size)
    got = ctx.gather_rows(sharded_ntt(df, mesh, plan, ctx.shard_rows(x)))
    want = ntt_many(df, x[None], make_plan(df, n, omega))[0]
    return {"out": got.cpu().numpy(), "single": bool(torch.equal(got, want))}


def task_scans(mesh, n: int, seed: int) -> dict:
    """sharded_inclusive_product and sharded_batch_inv of one column of n
    Fq elements with zeros in it, gathered whole; "single": both equal
    to running_product and batch_inv of the whole column."""
    from ..fields.device import FQ_DEV as df, batch_inv, running_product
    x = _upload(mesh, field_values(df.spec, n, seed))
    ctx = ProverMesh(mesh)
    prod = ctx.gather_rows(sharded_inclusive_product(df, mesh,
                                                     ctx.shard_rows(x)))
    inv = ctx.gather_rows(sharded_batch_inv(df, mesh, ctx.shard_rows(x)))
    single = (torch.equal(prod, running_product(df, x))
              and torch.equal(inv, batch_inv(df, x)))
    return {"product": prod.cpu().numpy(), "inv": inv.cpu().numpy(),
            "single": bool(single)}


def task_msm(mesh, n: int, seed: int) -> dict:
    """sharded_msm over n projective Pallas bases (the multiples
    [i + 2] of the generator, Z a random nonzero field element: the
    complete-add rounds, not the bucket-run kernel) and n random
    scalars: the affine sum, the same on every rank."""
    from ..curves.host import PALLAS
    from ..fields.device import FP_DEV, NLIMBS, ints_to_digits
    from ..ops.field_kernels import fmul
    from ..ops.point_kernels import points_to_proj
    from .mesh import sharded_msm
    rng = np.random.default_rng(seed)
    pts = [PALLAS.mul(PALLAS.generator, i + 2) for i in range(n)]
    proj = points_to_proj(FP_DEV, pts, mesh.device)
    z = _upload(mesh, [int(v) for v in rng.integers(1, 1 << 62, n)], FP_DEV)
    proj = torch.cat([fmul(FP_DEV, proj[i * NLIMBS:(i + 1) * NLIMBS].T,
                           z).T for i in range(3)])
    scalars = field_values(PALLAS.scalar, n, seed)
    digits = torch.from_numpy(ints_to_digits(scalars)).to(mesh.device)
    ctx = ProverMesh(mesh)
    got = sharded_msm(PALLAS, mesh, ctx.shard_rows(digits)[None],
                      ctx.shard_rows(proj, dim=1))
    return {"sum": got[0], "scalars": scalars, "points": pts}


def _params(k: int, device):
    """Pallas Params at 2^k rows (every circuit here is over Pallas)."""
    from ..curves.host import PALLAS
    from ..poly.commitment import Params
    key = ("params", k, device)
    if key not in _CACHE:
        _CACHE[key] = Params.new(PALLAS, k, device=device)
    return _CACHE[key]


def task_commit(mesh, k: int, seed: int, blind: int) -> dict:
    """Params.commit_lagrange of 2^k Fq values under the mesh (each rank
    commits its n/D rows, parallel/mesh.py::sharded_msm_mont) and on one
    device: the two affine points, and the mesh's counts of the first."""
    from ..fields.device import FQ_DEV as df
    params = _params(k, mesh.device)
    x = _upload(mesh, field_values(df.spec, 1 << k, seed))
    before = dict(mesh_mod.COUNTS)
    with ProverMesh(mesh):
        got = params.commit_lagrange(x, blind)
    counts = _counts_since(before)
    return {"mesh": got, "single": params.commit_lagrange(x, blind),
            "counts": counts}


def circuit_for(name: str, k: int, **kw):
    """(circuit, instances) of the Pallas circuits the mesh proves:
    "mulchain" (dev/circuits.py's MulChainCircuit, a and rows), "bench"
    (BenchCircuit filling 2^k rows) and "dev_lookup" (table_bits, rows;
    bench_circuit.py's defaults without them)."""
    from ..bench_circuit import (BenchCircuit, DevLookupCircuit, SEED_A,
                                 expected_output, regions_for_k)
    from ..curves.host import PALLAS
    if name == "mulchain":
        from ..dev.circuits import MulChainCircuit
        c = MulChainCircuit(kw.get("a", 7), kw.get("rows", 4))
        return c, [[[c.expected_out()]]]
    if name == "bench":
        regions = regions_for_k(k)
        return BenchCircuit(SEED_A, regions), [[[
            expected_output(PALLAS.scalar, SEED_A, regions)]]]
    if name == "dev_lookup":
        return DevLookupCircuit(**kw), [[]]
    raise ValueError(f"no circuit {name}")


def keys_for(name: str, k: int, device, **kw):
    """(params, vk, pk, circuit, instances), made once a process."""
    from ..plonk.keygen import keygen_pk, keygen_vk
    key = ("keys", name, k, device, tuple(sorted(kw.items())))
    if key not in _CACHE:
        circuit, instances = circuit_for(name, k, **kw)
        params = _params(k, device)
        vk = keygen_vk(params, circuit)
        pk = keygen_pk(params, vk, circuit)
        _CACHE[key] = (params, vk, pk, circuit, instances)
    return _CACHE[key]


def pk_rows(pk) -> dict:
    """{name: (row count, bytes of its storage)} of every proving-key
    tensor the prover re-lays (plonk/prover.py::pk_row_tensors), list
    entries as name[i]."""
    from ..plonk.prover import pk_row_tensors
    out = {}
    for _, name, value in pk_row_tensors(pk):
        for i, t in (enumerate(value) if isinstance(value, list)
                     else [(None, value)]):
            out[name if i is None else f"{name}[{i}]"] = (
                t.shape[0], t.untyped_storage().nbytes())
    return out


def task_prove(mesh, circuit: str, k: int, seed: int, reps: int = 1,
               rank_seed: bool = False, verify: bool = False,
               after: bool = False, h_chunk_nodes: int = 0,
               **circuit_kw) -> dict:
    """`reps` proves of the circuit under the mesh from random.Random(seed)
    (seed + rank with rank_seed, which must fail on every rank). Returns
    the proofs, their wall times (the card synchronised), the launches of
    each kernel and the mesh's counts in the last prove, the bytes staged
    through host memory and the peak of allocated card memory in it,
    with the bytes allocated at its start (0 on the CPU), "local":
    whether the ranks held their rows, "pk_rows":
    the pk's tensors after the proves (pk_rows), "verified" with verify;
    with rank_seed, "error": the message raised. With `after`, one more
    prove from the same seed with the mesh exited ("after": the proof
    and the pk's tensors then). `h_chunk_nodes` as create_proof's."""
    from ..curves.host import PALLAS as curve
    from ..plonk.prover import create_proof
    from ..plonk.verifier import SingleVerifier, verify_proof
    from ..transcript import TranscriptRead, TranscriptWrite
    params, vk, pk, c, instances = keys_for(circuit, k, mesh.device,
                                            **circuit_kw)
    cuda = mesh.device.type == "cuda"
    out = {"proofs": [], "times": []}
    for _ in range(reps):
        tw = TranscriptWrite(curve)
        before, launches = dict(mesh_mod.COUNTS), _launches()
        _sync(mesh)
        if cuda:
            torch.cuda.reset_peak_memory_stats(mesh.device)
            out["start_bytes"] = torch.cuda.memory_allocated(mesh.device)
        t = time.perf_counter()
        try:
            with ProverMesh(mesh):
                create_proof(params, pk, [c], instances,
                             random.Random(seed + (mesh.rank if rank_seed
                                                   else 0)), tw,
                             h_chunk_nodes=h_chunk_nodes)
        except RuntimeError as exc:
            if not rank_seed:
                raise
            out["error"] = str(exc)
            return out
        _sync(mesh)
        out["times"].append(time.perf_counter() - t)
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(mesh.device)
                             if cuda else 0)
        out.setdefault("start_bytes", 0)
        out["proofs"].append(tw.finalize())
        out["counts"] = _counts_since(before)
        after_launches = _launches()
        out["launches"] = {n: after_launches[n] - launches[n]
                           for n in after_launches}
    out["staged_bytes"] = out["counts"]["staged_bytes"]
    out["local"] = getattr(pk, "_rows", None) is not None and pk._rows.local
    out["pk_rows"] = pk_rows(pk)
    if verify:
        verify_proof(params, vk, SingleVerifier(params), instances,
                     TranscriptRead(curve, out["proofs"][-1]))
        out["verified"] = True
    if after:
        tw = TranscriptWrite(curve)
        create_proof(params, pk, [c], instances, random.Random(seed), tw)
        out["after"] = {"proof": tw.finalize(), "pk_rows": pk_rows(pk)}
    return out


def task_roll(mesh, log_n: int, shifts: list) -> dict:
    """ProverMesh.roll_rows of the rank's rows of one column of 2^log_n Fq
    elements by each shift, against the rank's rows of torch.roll of the
    whole column: {shift: equal}."""
    from ..fields.device import FQ_DEV as df
    x = _upload(mesh, field_values(df.spec, 1 << log_n, log_n))
    ctx = ProverMesh(mesh)
    local = ctx.local_rows(x)
    return {s: bool(torch.equal(ctx.roll_rows(local, s),
                                ctx.local_rows(torch.roll(x, s, dims=0))))
            for s in shifts}


def task_routing(mesh, k: int) -> dict:
    """At 2^k rows, where the mesh's D^2 does not divide n: whether the
    domain's transform and a commit took their sharded branches (the
    reference's rules: the domain needs D^2 | n, a commit D | n), and
    whether the transform equals the one made outside the mesh."""
    from ..fields.device import FQ_DEV as df
    from ..poly.domain import EvaluationDomain
    domain = EvaluationDomain(df, 3, k, mesh.device)
    x = _upload(mesh, field_values(df.spec, 1 << k, k))
    params = _params(k, mesh.device)
    before = dict(mesh_mod.COUNTS)
    with ProverMesh(mesh):
        got = domain.lagrange_to_coeff(x)
        ntts = _counts_since(before)["sharded_ntt"]
        params.commit_lagrange(x, 1)
    return {"domain_sharded": ntts > 0,
            "commit_sharded": _counts_since(before)["sharded_msm"] > 0,
            "equal": bool(torch.equal(got, domain.lagrange_to_coeff(x)))}


_TASKS = {"ntt": task_ntt, "scans": task_scans, "msm": task_msm,
          "commit": task_commit, "roll": task_roll,
          "prove": task_prove, "routing": task_routing}


def run(device, tasks) -> dict:
    """The rank's mesh over the spawned group (make_mesh(device=device);
    None is the card), then every task (name, kind, keywords) in order:
    {name: result}, with "rank", "size", "backend", "device" and the
    mesh's staged bytes."""
    mesh = make_mesh(device=device)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device)}
    for name, kind, kw in tasks:
        out[name] = _TASKS[kind](mesh, **kw)
    out["staged_bytes"] = mesh_mod.COUNTS["staged_bytes"]
    return out
