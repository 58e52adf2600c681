"""Vanishing argument: random blinder + quotient h(X) commit/eval.

Port of halo2_tpu/plonk/vanishing.py (halo2_proofs/src/plonk/vanishing/
prover.rs:38-152). The h(X) pipeline -- y-fold of all constraint tensors,
division by t(X) on the coset, iNTT, split into n-sized pieces -- is the
largest device computation of the prover. In the prover's sharded state
(`rows` a ProverMesh) the random poly and the pieces are the rank's rows:
the local inverse extension (EvaluationDomain.extended_to_coeff_pieces)
leaves each rank its rows of every piece, so the pieces need neither a
gather nor a re-layout before their commits.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import tracing
from ..ops.field_kernels import fadd, fmul
from ..parallel.context import WHOLE
from ..poly.utils import distribute_powers, eval_poly


@dataclass
class VanishingCommitted:
    random_poly: torch.Tensor
    random_blind: int


@dataclass
class VanishingConstructed:
    h_pieces: list
    h_blinds: list
    committed: VanishingCommitted


def vanishing_commit(params, domain, rng, transcript, rows=WHOLE
                     ) -> VanishingCommitted:
    """Random degree n-1 poly + blind (vanishing/prover.rs:38-60). Spans:
    "vanishing.draw" (the host draw and upload), "vanishing.commit"."""
    df = params.scalar_df
    fs = params.curve.scalar
    with tracing.span("vanishing.draw"):
        vals = [fs.rand(rng) for _ in range(params.n)]
        start, count = rows.row_span(params.n)
        random_poly = df.upload_values(vals[start:start + count],
                                       params.device, site="vanishing")
        random_blind = fs.rand(rng)
    with tracing.span("vanishing.commit"):
        (commitment,) = params.commit_many([random_poly], [random_blind],
                                           lagrange=False, rows=rows)
    transcript.write_point(commitment)
    return VanishingCommitted(random_poly=random_poly,
                              random_blind=random_blind)


def vanishing_construct(committed: VanishingCommitted, params, domain,
                        h_terms: list, y: int, rng,
                        transcript, rows=WHOLE) -> VanishingConstructed:
    """vanishing/prover.rs:65-121: y-fold, divide by t(X), iNTT, split,
    commit."""
    df = params.scalar_df
    fs = params.curve.scalar
    if not h_terms:
        # gate-less circuit: h(X) == 0
        h_terms = [df.zeros((rows.row_span(domain.extended_n)[1],),
                            params.device)]
    h = distribute_powers(df, h_terms, y)
    h = domain.divide_by_vanishing_poly(h)
    # the n-sized pieces of the coefficients, truncated to
    # n * quotient_poly_degree
    h_pieces = list(domain.extended_to_coeff_pieces(h, rows)[
        :domain.quotient_poly_degree].unbind(0))
    h_blinds = [fs.rand(rng) for _ in h_pieces]
    for pt in params.commit_many(h_pieces, h_blinds, lagrange=False,
                                 rows=rows):
        transcript.write_point(pt)
    return VanishingConstructed(h_pieces=h_pieces, h_blinds=h_blinds,
                                committed=committed)


def vanishing_evaluate(constructed: VanishingConstructed, params, x: int,
                       xn: int, transcript, eval_fn=None):
    """Fold the pieces by xn (Horner over the reversed pieces), write
    random_eval (vanishing/prover.rs:125-152). Returns (h_poly, h_blind)."""
    df = params.scalar_df
    fs = params.curve.scalar
    h_poly = None
    for piece in reversed(constructed.h_pieces):
        if h_poly is None:
            h_poly = piece
        else:
            h_poly = fadd(df, fmul(df, h_poly,
                                   df.scalar(xn, params.device)), piece)
    h_blind = 0
    for blind in reversed(constructed.h_blinds):
        h_blind = (h_blind * xn + blind) % fs.modulus
    eval_fn = eval_fn or (lambda poly, pt: eval_poly(df, poly, pt))
    transcript.write_scalar(eval_fn(constructed.committed.random_poly, x))
    return h_poly, h_blind
