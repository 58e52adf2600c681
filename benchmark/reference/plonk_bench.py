"""halo2's benches/plonk.rs circuit, plainly: StandardPlonk, three advice
columns a, b, c with equality, four fixed columns sm, sa, sb, sc, the one
gate a sa + b sb + a b sm - c sc, and set_minimum_degree(5).

Synthesis runs 2^(k-1) - 3 times {raw_multiply, raw_add, copy, copy}, as
halo2's simple floor planner lays it out: iteration i puts raw_multiply
(a, a, a^2; sa = sb = 0, sc = sm = 1) on row 2i and raw_add (a, a^2,
a + a^2; sa = sb = sc = 1, sm = 0) on row 2i + 1, then copies a on row
2i to a on row 2i + 1 and b on row 2i + 1 to c on row 2i. The copy
regions take no rows. No instance column.

Witness: a, a scalar drawn from the seed for every proof.
"""
from __future__ import annotations

from .pasta import Q

MINIMUM_DEGREE = 5
# fixed column values (sa, sb, sc, sm) of raw_multiply and raw_add
MULTIPLY = (0, 0, 1, 1)
ADD = (1, 1, 1, 0)


def iterations(cfg) -> int:
    return (1 << (cfg["k"] - 1)) - 3


def constraint_system(cfg) -> dict:
    n, m = 1 << cfg["k"], iterations(cfg)
    sa, sb, sc, sm = ([0] * n for _ in range(4))
    for i in range(m):
        for row, values in ((2 * i, MULTIPLY), (2 * i + 1, ADD)):
            sa[row], sb[row], sc[row], sm[row] = values
    copies = []
    for i in range(m):
        copies.append(((0, 2 * i), (0, 2 * i + 1)))      # a0 = a1
        copies.append(((1, 2 * i + 1), (2, 2 * i)))      # b1 = c0
    a, b, c = (("advice", i, i, 0) for i in range(3))
    # fixed columns in order of creation: sm 0, sa 1, sb 2, sc 3; queried
    # in the gate as sa, sb, sc, sm
    qsa, qsb, qsc, qsm = (("fixed", q, col, 0)
                          for q, col in enumerate((1, 2, 3, 0)))
    gate = ("sum",
            ("sum", ("sum", ("product", a, qsa), ("product", b, qsb)),
             ("product", ("product", a, b), qsm)),
            ("negated", ("product", c, qsc)))
    return {
        "k": cfg["k"], "num_fixed": 4, "num_advice": 3, "num_instance": 0,
        "num_selectors": 0, "instance_rows": 0,
        "advice_queries": [(0, 0), (1, 0), (2, 0)],
        "instance_queries": [],
        "fixed_queries": [(1, 0), (2, 0), (3, 0), (0, 0)],
        "gates": [gate], "lookups": [],
        "permutation": [("advice", 0), ("advice", 1), ("advice", 2)],
        "fixed": [sm, sa, sb, sc], "copies": copies,
        "minimum_degree": MINIMUM_DEGREE,
    }


def witness(cfg, rng) -> int:
    return rng.getrandbits(512) % Q


def instance(cfg, a: int) -> list[list[int]]:
    return []
