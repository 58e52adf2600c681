"""Conditional-swap chip.

Reference: halo2_gadgets/src/utilities/cond_swap.rs:240-290 — single gate:
  a_swapped − ternary(swap, b, a); b_swapped − ternary(swap, a, b);
  bool_check(swap); all under q_swap.

Copied from halo2_tpu/gadgets/utilities/cond_swap.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...poly.polynomial import Rotation
from ...circuit.value import Value
from ...circuit.layouter import Chip
from . import bool_check, ternary


@dataclass
class CondSwapConfig:
    q_swap: object
    a: object
    b: object
    a_swapped: object
    b_swapped: object
    swap: object
    field: object


class CondSwapChip(Chip):
    def __init__(self, config: CondSwapConfig):
        self._config = config

    def config(self):
        return self._config

    @staticmethod
    def configure(meta, field, advices) -> CondSwapConfig:
        """advices: 5 advice columns."""
        a, b, a_swapped, b_swapped, swap = advices
        # Only column a is equality-enabled by this chip
        # (cond_swap.rs:246-247).
        meta.enable_equality(a)
        q_swap = meta.selector()

        def gate(cells):
            qs = cells.query_selector(q_swap)
            a_ = cells.query_advice(a, Rotation(0))
            b_ = cells.query_advice(b, Rotation(0))
            a_sw = cells.query_advice(a_swapped, Rotation(0))
            b_sw = cells.query_advice(b_swapped, Rotation(0))
            sw = cells.query_advice(swap, Rotation(0))
            return [
                ("a_check", qs * (a_sw - ternary(sw, b_, a_))),
                ("b_check", qs * (b_sw - ternary(sw, a_, b_))),
                ("swap_bool", qs * bool_check(sw)),
            ]

        meta.create_gate("cond swap", gate)
        return CondSwapConfig(q_swap=q_swap, a=a, b=b, a_swapped=a_swapped,
                              b_swapped=b_swapped, swap=swap, field=field)

    def swap(self, layouter, pair, swap_value: Value):
        """pair: (AssignedCell, Value); returns (a_swapped, b_swapped)
        cells (cond_swap.rs:77-130)."""
        cfg = self._config
        f = cfg.field

        def region_fn(region):
            region.enable_selector("q_swap", cfg.q_swap, 0)
            a_cell, b_val = pair
            a = a_cell.copy_advice("a", region, cfg.a, 0)
            b = region.assign_advice("b", cfg.b, 0, lambda: b_val)
            swap = region.assign_advice("swap", cfg.swap, 0,
                                        lambda: swap_value)

            def pick(sel, x, y):
                return sel.zip(x.zip(y)).map(
                    lambda t: t[1][0] if t[0] else t[1][1])

            a_sw_val = pick(swap_value, b.value, a.value)
            b_sw_val = pick(swap_value, a.value, b.value)
            a_sw = region.assign_advice("a_swapped", cfg.a_swapped, 0,
                                        lambda: a_sw_val)
            b_sw = region.assign_advice("b_swapped", cfg.b_swapped, 0,
                                        lambda: b_sw_val)
            return a_sw, b_sw

        return layouter.assign_region("swap", region_fn)
