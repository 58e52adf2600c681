"""halo2's dev_lookup bench circuit, plainly: a table column holding
1 .. 2^table_bits, one advice column, a complex selector s on the first
`rows` rows, and the lookup of s * advice + (1 - s) into the table, so
every row of the domain is looked up.

Witness: the advice values of the `rows` selected rows, each drawn from
the seed among the table's values. The table's unused usable rows repeat
its first value (halo2's fill_from_row); the blinding rows hold 0.
"""
from __future__ import annotations

UNUSABLE_ROWS = 6      # blinding factors + 1


def constraint_system(cfg) -> dict:
    n, size = 1 << cfg["k"], 1 << cfg["table_bits"]
    table = [1] * (n - UNUSABLE_ROWS) + [0] * UNUSABLE_ROWS
    table[:size] = [v + 1 for v in range(size)]
    selector = [1] * cfg["rows"] + [0] * (n - cfg["rows"])
    s = ("fixed", 1, 1, 0)
    lookup_input = ("sum", ("product", s, ("advice", 0, 0, 0)),
                    ("sum", ("constant", 1), ("negated", s)))
    return {
        "k": cfg["k"], "num_fixed": 2, "num_advice": 1, "num_instance": 0,
        "num_selectors": 1, "instance_rows": 0,
        "advice_queries": [(0, 0)], "instance_queries": [],
        "fixed_queries": [(0, 0), (1, 0)], "gates": [],
        "lookups": [([lookup_input], [("fixed", 0, 0, 0)])],
        "permutation": [], "fixed": [table, selector], "copies": [],
    }


def witness(cfg, rng) -> list[int]:
    size = 1 << cfg["table_bits"]
    return [rng.randrange(size) + 1 for _ in range(cfg["rows"])]


def instance(cfg, values) -> list[list[int]]:
    return []
