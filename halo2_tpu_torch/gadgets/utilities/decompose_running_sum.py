"""Running-sum decomposition into W-bit windows with z-chaining.

Reference: halo2_gadgets/src/utilities/decompose_running_sum.rs — gate:
range_check(z_cur − 2^W·z_next, 2^W) under q_range_check; windows
k_i = z_i − 2^W·z_{i+1}; strict mode constrains the last z to zero.

Copied from halo2_tpu/gadgets/utilities/decompose_running_sum.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...poly.polynomial import Rotation
from ...circuit.value import Value
from . import range_check
from ...plonk.circuit import Constant


@dataclass
class RunningSumConfig:
    window_bits: int
    q_range_check: object
    z: object
    field: object

    @staticmethod
    def configure(meta, field, z_column, window_bits: int
                  ) -> "RunningSumConfig":
        meta.enable_equality(z_column)
        q_range_check = meta.selector()

        def gate(cells):
            q = cells.query_selector(q_range_check)
            z_cur = cells.query_advice(z_column, Rotation(0))
            z_next = cells.query_advice(z_column, Rotation(1))
            word = z_cur - z_next * Constant(1 << window_bits)
            return [("range_check", q * range_check(word,
                                                    1 << window_bits))]

        meta.create_gate("running sum range check", gate)
        return RunningSumConfig(window_bits=window_bits,
                                q_range_check=q_range_check,
                                z=z_column, field=field)

    def witness_decompose(self, layouter, value: Value, num_windows: int,
                          strict: bool):
        def region_fn(region):
            z0 = region.assign_advice("z_0", self.z, 0, lambda: value)
            return self._decompose(region, z0, num_windows, strict)
        return layouter.assign_region("decompose", region_fn)

    def copy_decompose(self, layouter, element, num_windows: int,
                       strict: bool):
        def region_fn(region):
            z0 = element.copy_advice("z_0", region, self.z, 0)
            return self._decompose(region, z0, num_windows, strict)
        return layouter.assign_region("decompose (copied)", region_fn)

    def _decompose(self, region, z0, num_windows: int, strict: bool):
        f = self.field
        w = self.window_bits
        inv_two_pow_w = pow(1 << w, f.modulus - 2, f.modulus)
        zs = [z0]
        z = z0
        for i in range(num_windows):
            region.enable_selector("q", self.q_range_check, i)
            word = z0.value.map(
                lambda v, i=i: (v >> (w * i)) & ((1 << w) - 1))
            z_val = z.value.zip(word).map(
                lambda t: (t[0] - t[1]) * inv_two_pow_w % f.modulus)
            z = region.assign_advice(f"z_{i+1}", self.z, i + 1,
                                     lambda v=z_val: v)
            zs.append(z)
        if strict:
            region.constrain_constant(zs[-1].cell, 0)
        return zs
