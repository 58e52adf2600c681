"""Carry the prover's "weights" -- the SRS and the proving-key arrays --
from the JAX reference into the port, so both provers can be fed the same
inputs. The reference's objects arrive as plain data (host point lists,
numpy arrays); nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .curves.host import PALLAS, VESTA
from .device import resolve_device
from .poly.commitment import Params

PK_ARRAYS = ("fixed_values", "fixed_polys", "fixed_cosets", "l0",
             "l_blind", "l_last", "permutation_permutations",
             "permutation_polys", "permutation_cosets")


def params_from_reference(curve_name: str, k: int, g, g_lagrange, w, u,
                          device=None) -> Params:
    """The port's Params from a reference Params' host points (lists of
    (x, y) int pairs, None for the identity)."""
    curve = {"pallas": PALLAS, "vesta": VESTA}[curve_name]
    if not len(g) == len(g_lagrange) == 1 << k:
        raise ValueError(f"expected 2^{k} points in g and g_lagrange, got "
                         f"{len(g)} and {len(g_lagrange)}")
    return Params(curve, k, list(g), list(g_lagrange), w, u, device)


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.shape[-1:] != (16,) or arr.max(initial=0) > 0xFFFF:
        raise ValueError("expected [..., 16] 16-bit Montgomery digits")
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def proving_key_arrays_from_numpy(arrays: dict, device=None) -> dict:
    """numpy copies of a reference ProvingKey's arrays -> port tensors.
    `arrays` maps the names in PK_ARRAYS to [n or ext_n, 16] uint32
    arrays (lists of them for the per-column entries); the permutation's
    sigma columns come in the Lagrange basis (`permutation_permutations`,
    which the prover's z products read), the coefficient basis and the
    extended coset."""
    device = resolve_device(device)
    out = {}
    for name in PK_ARRAYS:
        val = arrays[name]
        out[name] = ([_tensor(a, device) for a in val]
                     if isinstance(val, (list, tuple)) else
                     _tensor(val, device))
    return out


def load_proving_key_arrays(pk, tensors: dict) -> None:
    """Install proving_key_arrays_from_numpy's tensors into a port pk."""
    for name in ("fixed_values", "fixed_polys", "fixed_cosets", "l0",
                 "l_blind", "l_last"):
        setattr(pk, name, tensors[name])
    pk.permutation.permutations = tensors["permutation_permutations"]
    pk.permutation.polys = tensors["permutation_polys"]
    pk.permutation.cosets = tensors["permutation_cosets"]
