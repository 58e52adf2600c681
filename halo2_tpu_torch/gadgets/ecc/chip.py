"""ECC chip: in-circuit Pallas curve operations over the base field Fp,
in the reference's exact 10-advice-column layout.

Reference: halo2_gadgets/src/ecc/chip.rs (configure order:
witness_point, add_incomplete, add, mul, mul_fixed shared + full_width
+ short + base_field_elem — chip.rs:273-333) and the per-module gate
definitions cited inline.  Gate ASTs and query orders mirror the
reference exactly (int multiplications are Scaled nodes; Constant
products stay Products) so the pinned verifying key is byte-identical —
checked against vk_ecc_chip.rdata in tests/test_ecc_parity.py.

Column map (a = advices):
  witness_point: x=a0 y=a1
  add_incomplete: x_p=a0 y_p=a1 x_qr=a2 y_qr=a3
  add: + lambda=a4 alpha=a5 beta=a6 gamma=a7 delta=a8
  mul hi half: z=a9 x_a=a3 (x_p=a0 y_p=a1) l1=a4 l2=a5
  mul lo half: z=a6 x_a=a7 (x_p=a0 y_p=a1) l1=a8 l2=a2
  mul complete: z_complete=a9;  mul overflow: a6 a7 a8
  mul_fixed: window=a4 u=a5 + 8 fixed lagrange cols + fixed_z
  base_field canon advices: a6 a7 a8

Copied from halo2_tpu/gadgets/ecc/chip.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ...fields.host import FieldSpec, FP
from ...curves.host import PALLAS
from ...poly.polynomial import Rotation
from ...plonk.circuit import Constant
from ...circuit.value import Value
from ...circuit.layouter import Chip, AssignedCell
from ..utilities import bool_check, ternary, range_check, bitrange_subset
from .constants import (H, NUM_WINDOWS, NUM_WINDOWS_SHORT,
                        FIXED_BASE_WINDOW_SIZE, L_SCALAR_SHORT,
                        compute_lagrange_coeffs, find_zs_and_us)

# q = 2^254 + T_Q (Pallas scalar modulus), p = 2^254 + T_P (base modulus)
# (ecc/chip/constants.rs:29-35)
T_Q = 45560315531506369815346746415080538113
T_P = 45560315531419706090280762371685220353

NUM_COMPLETE_BITS = 3
INCOMPLETE_LEN = 255 - 1 - NUM_COMPLETE_BITS          # 251
INCOMPLETE_HI_LEN = INCOMPLETE_LEN // 2               # 125
INCOMPLETE_LO_LEN = INCOMPLETE_LEN - INCOMPLETE_HI_LEN  # 126


@dataclass
class EccPoint:
    """Affine point; identity is (0, 0) (ecc/chip.rs:36-83)."""
    x: AssignedCell
    y: AssignedCell

    def point_value(self, f: FieldSpec):
        return self.x.value.zip(self.y.value).map(
            lambda xy: None if xy == (0, 0) else xy)


@dataclass
class FixedPointBase:
    """A fixed base with its window tables (FixedPoint trait,
    chip.rs:203-230); constants via gadgets/ecc/constants.py."""
    generator: tuple
    num_windows: int

    def tables(self):
        from .constants import fixed_base_constants
        return fixed_base_constants(self.generator, self.num_windows)


_FIXED_TABLES: dict = {}


@dataclass
class EccConfig:
    advices: list
    field: FieldSpec
    b: int
    # witness_point
    q_point: object = None
    q_point_non_id: object = None
    # add_incomplete / add
    q_add_incomplete: object = None
    q_add: object = None
    # variable-base mul
    hi_q_mul: tuple = None        # (q_mul_1, q_mul_2, q_mul_3)
    lo_q_mul: tuple = None
    q_mul_decompose_var: object = None
    q_mul_overflow: object = None
    q_mul_lsb: object = None
    # mul_fixed
    q_running_sum: object = None
    lagrange_coeffs: list = None
    fixed_z: object = None
    q_mul_fixed_full: object = None
    q_mul_fixed_short: object = None
    q_mul_fixed_base_field: object = None
    lookup_config: object = None


class EccChip(Chip):
    def __init__(self, config: EccConfig):
        self._config = config

    def config(self):
        return self._config

    # ------------------------------------------------------ configure
    @staticmethod
    def configure(meta, advices, lagrange_coeffs, range_check_cfg,
                  field: FieldSpec = FP, b: int = 5) -> EccConfig:
        """chip.rs:273-333: every sub-config in reference order."""
        assert len(advices) == 10 and len(lagrange_coeffs) == H
        a = list(advices)
        cfg = EccConfig(advices=a, field=field, b=b,
                        lagrange_coeffs=list(lagrange_coeffs),
                        lookup_config=range_check_cfg)

        def curve_eqn(x, y):
            return y * y - (x * x * x) - Constant(b)

        # ---- witness_point (witness_point.rs:30-87) ----
        cfg.q_point = meta.selector()
        cfg.q_point_non_id = meta.selector()

        def witness_point(cells):
            q = cells.query_selector(cfg.q_point)
            x = cells.query_advice(a[0], Rotation(0))
            y = cells.query_advice(a[1], Rotation(0))
            # reference shape: (q * x) * curve_eqn, unparenthesized
            return [("x == 0 v on_curve", q * x * curve_eqn(x, y)),
                    ("y == 0 v on_curve", q * y * curve_eqn(x, y))]

        meta.create_gate("witness point", witness_point)

        def witness_non_id(cells):
            q = cells.query_selector(cfg.q_point_non_id)
            x = cells.query_advice(a[0], Rotation(0))
            y = cells.query_advice(a[1], Rotation(0))
            return [("on_curve", q * curve_eqn(x, y))]

        meta.create_gate("witness non-identity point", witness_non_id)

        # ---- add_incomplete (add_incomplete.rs:24-80) ----
        for col in (a[0], a[1], a[2], a[3]):
            meta.enable_equality(col)
        cfg.q_add_incomplete = meta.selector()

        def add_incomplete(cells):
            q = cells.query_selector(cfg.q_add_incomplete)
            xp = cells.query_advice(a[0], Rotation(0))
            yp = cells.query_advice(a[1], Rotation(0))
            xq = cells.query_advice(a[2], Rotation(0))
            yq = cells.query_advice(a[3], Rotation(0))
            xr = cells.query_advice(a[2], Rotation(1))
            yr = cells.query_advice(a[3], Rotation(1))
            poly1 = (xr + xq + xp) * (xp - xq) * (xp - xq) \
                - (yp - yq) * (yp - yq)
            poly2 = (yr + yq) * (xp - xq) - (yp - yq) * (xq - xr)
            return [("x_r", q * poly1), ("y_r", q * poly2)]

        meta.create_gate("incomplete addition", add_incomplete)

        # ---- add (complete; add.rs:37-190) ----
        for col in (a[0], a[1], a[2], a[3]):
            meta.enable_equality(col)
        cfg.q_add = meta.selector()

        def add_complete(cells):
            q = cells.query_selector(cfg.q_add)
            xp = cells.query_advice(a[0], Rotation(0))
            yp = cells.query_advice(a[1], Rotation(0))
            xq = cells.query_advice(a[2], Rotation(0))
            yq = cells.query_advice(a[3], Rotation(0))
            xr = cells.query_advice(a[2], Rotation(1))
            yr = cells.query_advice(a[3], Rotation(1))
            lam = cells.query_advice(a[4], Rotation(0))
            alpha = cells.query_advice(a[5], Rotation(0))
            beta = cells.query_advice(a[6], Rotation(0))
            gamma = cells.query_advice(a[7], Rotation(0))
            delta = cells.query_advice(a[8], Rotation(0))
            one = Constant(1)
            xq_m_xp = xq - xp
            xp_m_xr = xp - xr
            yq_p_yp = yq + yp
            if_alpha = xq_m_xp * alpha
            if_beta = xp * beta
            if_gamma = xq * gamma
            if_delta = yq_p_yp * delta
            poly1 = xq_m_xp * (xq_m_xp * lam - (yq - yp))
            poly2 = (one - if_alpha) * (Constant(2) * yp * lam
                                        - Constant(3) * (xp * xp))
            nonexc_xr = lam * lam - xp - xq - xr
            nonexc_yr = lam * xp_m_xr - yp - yr
            return [("1", q * poly1), ("2", q * poly2),
                    ("3a", q * (xp * xq * xq_m_xp * nonexc_xr)),
                    ("3b", q * (xp * xq * xq_m_xp * nonexc_yr)),
                    ("3c", q * (xp * xq * yq_p_yp * nonexc_xr)),
                    ("3d", q * (xp * xq * yq_p_yp * nonexc_yr)),
                    ("4a", q * ((one - if_beta) * (xr - xq))),
                    ("4b", q * ((one - if_beta) * (yr - yq))),
                    ("5a", q * ((one - if_gamma) * (xr - xp))),
                    ("5b", q * ((one - if_gamma) * (yr - yp))),
                    ("6a", q * ((one - if_alpha - if_delta) * xr)),
                    ("6b", q * ((one - if_alpha - if_delta) * yr))]

        meta.create_gate("complete addition", add_complete)

        # ---- variable-base mul (mul.rs:66-162 + mul/*.rs) ----
        two_inv = pow(2, field.modulus - 2, field.modulus)

        def incomplete_half(z_col, x_a_col, l1_col, l2_col):
            """mul/incomplete.rs:75-228 — one half's config + 3 gates."""
            meta.enable_equality(z_col)
            meta.enable_equality(l1_col)
            q1, q2, q3 = meta.selector(), meta.selector(), meta.selector()

            def x_r(cells, rot):
                xa = cells.query_advice(x_a_col, rot)
                xp = cells.query_advice(a[0], rot)
                l1 = cells.query_advice(l1_col, rot)
                return l1 * l1 - xa - xp

            def y_a(cells, rot):
                xa = cells.query_advice(x_a_col, rot)
                l1 = cells.query_advice(l1_col, rot)
                l2 = cells.query_advice(l2_col, rot)
                return ((l1 + l2) * (xa - x_r(cells, rot))) * two_inv

            def for_loop(cells, y_a_next):
                one = Constant(1)
                z_cur = cells.query_advice(z_col, Rotation(0))
                z_prev = cells.query_advice(z_col, Rotation(-1))
                x_a_cur = cells.query_advice(x_a_col, Rotation(0))
                x_a_next = cells.query_advice(x_a_col, Rotation(1))
                x_p_cur = cells.query_advice(a[0], Rotation(0))
                y_p_cur = cells.query_advice(a[1], Rotation(0))
                l1_cur = cells.query_advice(l1_col, Rotation(0))
                l2_cur = cells.query_advice(l2_col, Rotation(0))
                y_a_cur = y_a(cells, Rotation(0))
                k = z_cur - z_prev * 2
                bc = bool_check(k)
                gradient_1 = l1_cur * (x_a_cur - x_p_cur) - y_a_cur \
                    + (k * 2 - one) * y_p_cur
                secant = l2_cur * l2_cur - x_a_next \
                    - x_r(cells, Rotation(0)) - x_a_cur
                gradient_2 = l2_cur * (x_a_cur - x_a_next) - y_a_cur \
                    - y_a_next
                return [("bool_check", bc), ("gradient_1", gradient_1),
                        ("secant_line", secant),
                        ("gradient_2", gradient_2)]

            def gate_q1(cells):
                q = cells.query_selector(q1)
                y_a_next = y_a(cells, Rotation(1))
                y_a_witnessed = cells.query_advice(l1_col, Rotation(0))
                return [("init y_a", q * (y_a_witnessed - y_a_next))]

            meta.create_gate("q_mul_1 == 1 checks", gate_q1)

            def gate_q2(cells):
                q = cells.query_selector(q2)
                y_a_next = y_a(cells, Rotation(1))
                x_p_cur = cells.query_advice(a[0], Rotation(0))
                x_p_next = cells.query_advice(a[0], Rotation(1))
                y_p_cur = cells.query_advice(a[1], Rotation(0))
                y_p_next = cells.query_advice(a[1], Rotation(1))
                out = [("x_p_check", q * (x_p_cur - x_p_next)),
                       ("y_p_check", q * (y_p_cur - y_p_next))]
                out += [(n, q * e) for n, e in for_loop(cells, y_a_next)]
                return out

            meta.create_gate("q_mul_2 == 1 checks", gate_q2)

            def gate_q3(cells):
                q = cells.query_selector(q3)
                y_a_final = cells.query_advice(l1_col, Rotation(1))
                return [(n, q * e)
                        for n, e in for_loop(cells, y_a_final)]

            meta.create_gate("q_mul_3 == 1 checks", gate_q3)
            return (q1, q2, q3)

        cfg.hi_q_mul = incomplete_half(a[9], a[3], a[4], a[5])
        cfg.lo_q_mul = incomplete_half(a[6], a[7], a[8], a[2])

        # mul/complete.rs:24-81 (z_complete = a9)
        meta.enable_equality(a[9])
        cfg.q_mul_decompose_var = meta.selector()

        def decompose_var(cells):
            q = cells.query_selector(cfg.q_mul_decompose_var)
            z_prev = cells.query_advice(a[9], Rotation(-1))
            z_next = cells.query_advice(a[9], Rotation(1))
            k = z_next - Constant(2) * z_prev
            bc = bool_check(k)
            base_y = cells.query_advice(a[9], Rotation(0))
            y_p = cells.query_advice(a[1], Rotation(-1))
            y_switch = ternary(k, base_y - y_p, base_y + y_p)
            return [("bool_check", q * bc), ("y_switch", q * y_switch)]

        meta.create_gate(
            "Decompose scalar for complete bits of variable-base mul",
            decompose_var)

        # mul/overflow.rs:28-100 (advices a6, a7, a8)
        for col in (a[6], a[7], a[8]):
            meta.enable_equality(col)
        cfg.q_mul_overflow = meta.selector()

        def overflow(cells):
            q = cells.query_selector(cfg.q_mul_overflow)
            one = Constant(1)
            two_pow_124 = Constant(1 << 124)
            two_pow_130 = two_pow_124 * Constant(1 << 6)
            z_0 = cells.query_advice(a[6], Rotation(-1))
            z_130 = cells.query_advice(a[6], Rotation(0))
            eta = cells.query_advice(a[6], Rotation(1))
            k_254 = cells.query_advice(a[7], Rotation(-1))
            alpha = cells.query_advice(a[7], Rotation(0))
            s_minus_lo_130 = cells.query_advice(a[7], Rotation(1))
            s = cells.query_advice(a[8], Rotation(0))
            s_check = s - (alpha + k_254 * two_pow_130)
            recovery = z_0 - alpha - Constant(T_Q)
            lo_zero = k_254 * (z_130 - two_pow_124)
            s_minus_check = k_254 * s_minus_lo_130
            canonicity = (one - k_254) * (one - z_130 * eta) \
                * s_minus_lo_130
            return [("s_check", q * s_check), ("recovery", q * recovery),
                    ("lo_zero", q * lo_zero),
                    ("s_minus_lo_130_check", q * s_minus_check),
                    ("canonicity", q * canonicity)]

        meta.create_gate("overflow checks", overflow)

        # mul.rs:84 + 131-162: LSB gate
        cfg.q_mul_lsb = meta.selector()

        def lsb_gate(cells):
            q = cells.query_selector(cfg.q_mul_lsb)
            z_1 = cells.query_advice(a[9], Rotation(0))
            z_0 = cells.query_advice(a[9], Rotation(1))
            x_p = cells.query_advice(a[0], Rotation(0))
            y_p = cells.query_advice(a[1], Rotation(0))
            base_x = cells.query_advice(a[0], Rotation(1))
            base_y = cells.query_advice(a[1], Rotation(1))
            lsb = z_0 - z_1 * 2
            bc = bool_check(lsb)
            lsb_x = ternary(lsb, x_p, x_p - base_x)
            lsb_y = ternary(lsb, y_p, y_p + base_y)
            return [("bool_check", q * bc), ("lsb_x", q * lsb_x),
                    ("lsb_y", q * lsb_y)]

        meta.create_gate("LSB check", lsb_gate)

        # ---- mul_fixed shared (mul_fixed.rs:56-168) ----
        meta.enable_equality(a[4])   # window
        meta.enable_equality(a[5])   # u
        cfg.q_running_sum = meta.selector()
        # RunningSumConfig::configure(meta, q_running_sum, window):
        meta.enable_equality(a[4])

        def running_sum_range(cells):
            q = cells.query_selector(cfg.q_running_sum)
            z_cur = cells.query_advice(a[4], Rotation(0))
            z_next = cells.query_advice(a[4], Rotation(1))
            word = z_cur - z_next * (1 << FIXED_BASE_WINDOW_SIZE)
            return [("range check",
                     q * range_check(word, 1 << FIXED_BASE_WINDOW_SIZE))]

        meta.create_gate("range check", running_sum_range)

        cfg.fixed_z = meta.fixed_column()

        def coords_check(cells, window):
            """mul_fixed.rs:132-168."""
            y_p = cells.query_advice(a[1], Rotation(0))
            x_p = cells.query_advice(a[0], Rotation(0))
            z = cells.query_fixed(cfg.fixed_z, Rotation(0))
            u = cells.query_advice(a[5], Rotation(0))
            window_pow = []
            for pw in range(H):
                acc = Constant(1)
                for _ in range(pw):
                    acc = acc * window
                window_pow.append(acc)
            interpolated_x = Constant(0)
            for wp, coeff in zip(window_pow, cfg.lagrange_coeffs):
                interpolated_x = interpolated_x + (
                    wp * cells.query_fixed(coeff, Rotation(0)))
            x_check = interpolated_x - x_p
            y_check = u * u - y_p - z
            on_curve = y_p * y_p - (x_p * x_p) * x_p - Constant(b)
            return [("check x", x_check), ("check y", y_check),
                    ("on-curve", on_curve)]

        def running_sum_coords(cells):
            q = cells.query_selector(cfg.q_running_sum)
            z_cur = cells.query_advice(a[4], Rotation(0))
            z_next = cells.query_advice(a[4], Rotation(1))
            word = z_cur - z_next * H
            return [(n, q * e) for n, e in coords_check(cells, word)]

        meta.create_gate("Running sum coordinates check",
                         running_sum_coords)

        # full_width (mul_fixed/full_width.rs:20-51)
        cfg.q_mul_fixed_full = meta.selector()

        def full_width_gate(cells):
            q = cells.query_selector(cfg.q_mul_fixed_full)
            window = cells.query_advice(a[4], Rotation(0))
            out = [(n, q * e) for n, e in coords_check(cells, window)]
            out.append(("window range check",
                        q * range_check(window, H)))
            return out

        meta.create_gate("Full-width fixed-base scalar mul",
                         full_width_gate)

        # short (mul_fixed/short.rs:21-77)
        cfg.q_mul_fixed_short = meta.selector()

        def short_gate(cells):
            q = cells.query_selector(cfg.q_mul_fixed_short)
            y_p = cells.query_advice(a[1], Rotation(0))
            y_a = cells.query_advice(a[3], Rotation(0))
            last_window = cells.query_advice(a[5], Rotation(0))
            sign = cells.query_advice(a[4], Rotation(0))
            one = Constant(1)
            lw_check = bool_check(last_window)
            sign_check = sign * sign - one
            y_check = (y_p - y_a) * (y_p + y_a)
            negation_check = sign * y_p - y_a
            return [("last_window_check", q * lw_check),
                    ("sign_check", q * sign_check),
                    ("y_check", q * y_check),
                    ("negation_check", q * negation_check)]

        meta.create_gate("Short fixed-base mul gate", short_gate)

        # base_field_elem (mul_fixed/base_field_elem.rs:32-170)
        for col in (a[6], a[7], a[8]):
            meta.enable_equality(col)
        cfg.q_mul_fixed_base_field = meta.selector()

        def canonicity(cells):
            q = cells.query_selector(cfg.q_mul_fixed_base_field)
            alpha = cells.query_advice(a[6], Rotation(-1))
            z_84 = cells.query_advice(a[8], Rotation(-1))
            alpha_0 = alpha - z_84 * (1 << 252)
            alpha_1 = cells.query_advice(a[7], Rotation(0))
            alpha_2 = cells.query_advice(a[8], Rotation(0))
            alpha_0_prime = cells.query_advice(a[6], Rotation(0))
            z_13 = cells.query_advice(a[6], Rotation(1))
            z_44 = cells.query_advice(a[7], Rotation(1))
            z_43 = cells.query_advice(a[8], Rotation(1))
            a1_range = range_check(alpha_1, 1 << 2)
            a2_range = bool_check(alpha_2)
            z84_check = z_84 - (alpha_1 + alpha_2 * (1 << 2))
            a0_prime_check = alpha_0_prime - (alpha_0 + Constant(1 << 130)
                                              - Constant(T_P))
            alpha_0_hi_120 = z_44 - z_84 * Constant(1 << 120)
            a_43 = z_43 - z_44 * H
            return [("MSB = 1 => alpha_1 = 0", q * (alpha_2 * alpha_1)),
                    ("MSB = 1 => alpha_0_hi_120 = 0",
                     q * (alpha_2 * alpha_0_hi_120)),
                    ("MSB = 1 => a_43 = 0 or 1",
                     q * (alpha_2 * bool_check(a_43))),
                    ("MSB = 1 => z_13_alpha_0_prime = 0",
                     q * (alpha_2 * z_13)),
                    ("alpha_1_range_check", q * a1_range),
                    ("alpha_2_range_check", q * a2_range),
                    ("z_84_alpha_check", q * z84_check),
                    ("alpha_0_prime check", q * a0_prime_check)]

        meta.create_gate("Canonicity checks", canonicity)

        return cfg

    # -------------------------------------------------- basic helpers
    def load_private(self, layouter, column, value: Value):
        def region_fn(region):
            return region.assign_advice("load private", column, 0,
                                        lambda: value)
        return layouter.assign_region("load private", region_fn)

    def constrain_equal(self, layouter, p: EccPoint, q: EccPoint):
        def region_fn(region):
            region.constrain_equal(p.x.cell, q.x.cell)
            region.constrain_equal(p.y.cell, q.y.cell)
        layouter.assign_region("constrain equal", region_fn)

    def witness_point(self, layouter, value: Value) -> EccPoint:
        cfg = self._config

        def region_fn(region):
            region.enable_selector("q_point", cfg.q_point, 0)
            x = region.assign_advice("x", cfg.advices[0], 0,
                                     lambda: value.map(lambda t: t[0]))
            y = region.assign_advice("y", cfg.advices[1], 0,
                                     lambda: value.map(lambda t: t[1]))
            return EccPoint(x, y)

        return layouter.assign_region("witness point", region_fn)

    def witness_point_non_id(self, layouter, value: Value) -> EccPoint:
        cfg = self._config

        def region_fn(region):
            region.enable_selector("q_non_id", cfg.q_point_non_id, 0)
            x = region.assign_advice("x", cfg.advices[0], 0,
                                     lambda: value.map(lambda t: t[0]))
            y = region.assign_advice("y", cfg.advices[1], 0,
                                     lambda: value.map(lambda t: t[1]))
            # error AFTER assignment, like witness_point.rs:131-140
            bad = [False]
            value.map(lambda t: bad.__setitem__(0, t == (0, 0)))
            if bad[0]:
                raise ValueError("identity witnessed as NonIdentityPoint")
            return EccPoint(x, y)

        return layouter.assign_region("witness non-id point", region_fn)

    # ------------------------------------------------ point arithmetic
    def _add_incomplete_at(self, region, offset, p: EccPoint,
                           q: EccPoint) -> EccPoint:
        """add_incomplete.rs:110-190 at a given offset."""
        cfg = self._config
        f = cfg.field
        pm = f.modulus
        region.enable_selector("q_inc", cfg.q_add_incomplete, offset)
        xp = p.x.copy_advice("x_p", region, cfg.advices[0], offset)
        yp = p.y.copy_advice("y_p", region, cfg.advices[1], offset)
        xq = q.x.copy_advice("x_q", region, cfg.advices[2], offset)
        yq = q.y.copy_advice("y_q", region, cfg.advices[3], offset)

        def out(t):
            (x_p, y_p), (x_q, y_q) = t
            lam = (y_q - y_p) * pow((x_q - x_p) % pm, pm - 2, pm) % pm
            x_r = (lam * lam - x_p - x_q) % pm
            return (x_r, (lam * (x_p - x_r) - y_p) % pm)

        vals = xp.value.zip(yp.value).zip(xq.value.zip(yq.value))
        o = vals.map(out)
        xr = region.assign_advice("x_r", cfg.advices[2], offset + 1,
                                  lambda: o.map(lambda t: t[0]))
        yr = region.assign_advice("y_r", cfg.advices[3], offset + 1,
                                  lambda: o.map(lambda t: t[1]))
        return EccPoint(xr, yr)

    def add_incomplete(self, layouter, p: EccPoint, q: EccPoint):
        return layouter.assign_region(
            "incomplete point addition",
            lambda region: self._add_incomplete_at(region, 0, p, q))

    def _add_at(self, region, offset, p: EccPoint, q: EccPoint
                ) -> EccPoint:
        """add.rs:196-380 at a given offset."""
        cfg = self._config
        pm = cfg.field.modulus
        region.enable_selector("q_add", cfg.q_add, offset)
        xp = p.x.copy_advice("x_p", region, cfg.advices[0], offset)
        yp = p.y.copy_advice("y_p", region, cfg.advices[1], offset)
        xq = q.x.copy_advice("x_q", region, cfg.advices[2], offset)
        yq = q.y.copy_advice("y_q", region, cfg.advices[3], offset)
        vals = xp.value.zip(yp.value).zip(xq.value.zip(yq.value))

        def inv0(v):
            return 0 if v % pm == 0 else pow(v, pm - 2, pm)

        def hints(t):
            (x_p, y_p), (x_q, y_q) = t
            alpha = inv0(x_q - x_p)
            beta = inv0(x_p)
            gamma = inv0(x_q)
            delta = inv0(y_q + y_p) if x_q % pm == x_p % pm else 0
            if x_q % pm != x_p % pm:
                lam = (y_q - y_p) * inv0(x_q - x_p) % pm
            elif y_p % pm != 0:
                lam = 3 * x_p * x_p % pm * inv0(2 * y_p) % pm
            else:
                lam = 0
            return (lam, alpha, beta, gamma, delta)

        h = vals.map(hints)
        for i, name in enumerate(["lambda", "alpha", "beta", "gamma",
                                  "delta"]):
            region.assign_advice(
                name, cfg.advices[4 + i], offset,
                lambda i=i: h.map(lambda t: t[i] % pm))

        def result(t):
            (x_p, y_p), (x_q, y_q) = t
            p_pt = None if (x_p % pm, y_p % pm) == (0, 0) \
                else (x_p % pm, y_p % pm)
            q_pt = None if (x_q % pm, y_q % pm) == (0, 0) \
                else (x_q % pm, y_q % pm)
            r = PALLAS.add(p_pt, q_pt)
            return (0, 0) if r is None else r

        o = vals.map(result)
        xr = region.assign_advice("x_r", cfg.advices[2], offset + 1,
                                  lambda: o.map(lambda t: t[0]))
        yr = region.assign_advice("y_r", cfg.advices[3], offset + 1,
                                  lambda: o.map(lambda t: t[1]))
        return EccPoint(xr, yr)

    def add(self, layouter, p: EccPoint, q: EccPoint) -> EccPoint:
        return layouter.assign_region(
            "complete point addition",
            lambda region: self._add_at(region, 0, p, q))

    # ------------------------------------------- variable-base mul
    def mul(self, layouter, alpha_cell: AssignedCell, base: EccPoint):
        """mul.rs:164-305: full variable-base scalar mul; `alpha_cell`
        is a witnessed base-field element; returns (EccPoint, zs)."""
        cfg = self._config
        pm = cfg.field.modulus

        def bits_of(alpha_val):
            # k = alpha + t_q, unreduced; big-endian bits k_254..k_0
            return alpha_val.map(
                lambda v: [((v + T_Q) >> i) & 1
                           for i in range(254, -1, -1)])

        def mul_region(region):
            bits = bits_of(alpha_cell.value)
            base_pt = base
            # acc = [2]base via complete addition at offset 0
            acc = self._add_at(region, 0, base_pt, base_pt)
            offset = 1
            z_init = region.assign_advice_from_constant(
                "z_init = 0", cfg.advices[9], offset, 0)
            x_a, y_a_val, zs_hi = self._double_and_add(
                region, offset, cfg.hi_q_mul, cfg.advices[9],
                cfg.advices[3], cfg.advices[4], cfg.advices[5],
                base_pt, bits, 0, INCOMPLETE_HI_LEN, acc, z_init)
            x_a, y_a_val, zs_lo = self._double_and_add(
                region, offset, cfg.lo_q_mul, cfg.advices[6],
                cfg.advices[7], cfg.advices[8], cfg.advices[2],
                base_pt, bits, INCOMPLETE_HI_LEN, INCOMPLETE_LO_LEN,
                EccPoint(x_a, y_a_val), zs_hi[-1])
            offset = offset + INCOMPLETE_LO_LEN + 2
            acc2, zs_complete = self._mul_complete(
                region, offset, bits, base_pt, x_a, y_a_val, zs_lo[-1])
            offset = offset + NUM_COMPLETE_BITS * 2
            result, z_0 = self._process_lsb(region, offset, base_pt,
                                            acc2, zs_complete[-1], bits)
            zs = [z_init] + zs_hi + zs_lo + zs_complete + [z_0]
            assert len(zs) == 256
            zs.reverse()
            return result, zs

        result, zs = layouter.assign_region("variable-base scalar mul",
                                            mul_region)
        self._overflow_check(layouter, alpha_cell, zs)
        return result, zs

    def _double_and_add(self, region, offset, selectors, z_col, x_a_col,
                        l1_col, l2_col, base, bits, bit_start, num_bits,
                        acc, z_start):
        """mul/incomplete.rs:232-373."""
        cfg = self._config
        pm = cfg.field.modulus
        q1, q2, q3 = selectors
        region.enable_selector("q_mul_1", q1, offset)
        for idx in range(num_bits - 1):
            region.enable_selector("q_mul_2", q2, offset + 1 + idx)
        region.enable_selector("q_mul_3", q3, offset + num_bits)

        z = z_start.copy_advice("starting z", region, z_col, offset)
        x_a = acc.x.copy_advice("starting x_a", region, x_a_col,
                                offset + 1)
        y_a_cell = acc.y.copy_advice("starting y_a", region, l1_col,
                                     offset)
        y_a_val = y_a_cell.value
        offset += 1

        x_p_val = base.x.value
        y_p_val = base.y.value
        x_a_val = x_a.value
        zs = []
        for row in range(num_bits):
            k = bits.map(lambda b, i=bit_start + row: b[i])
            z_val = z.value.zip(k).map(lambda t: (2 * t[0] + t[1]) % pm)
            z = region.assign_advice("z", z_col, row + offset,
                                     lambda v=z_val: v)
            zs.append(z)
            region.assign_advice("x_p", cfg.advices[0], row + offset,
                                 lambda: x_p_val)
            region.assign_advice("y_p", cfg.advices[1], row + offset,
                                 lambda: y_p_val)
            y_p_signed = y_p_val.zip(k).map(
                lambda t: t[0] if t[1] else (pm - t[0]) % pm)
            lam1 = y_a_val.zip(y_p_signed).zip(
                x_a_val.zip(x_p_val)).map(
                lambda t: (t[0][0] - t[0][1])
                * pow((t[1][0] - t[1][1]) % pm, pm - 2, pm) % pm)
            region.assign_advice("lambda1", l1_col, row + offset,
                                 lambda v=lam1: v)
            x_r = lam1.zip(x_a_val.zip(x_p_val)).map(
                lambda t: (t[0] * t[0] - t[1][0] - t[1][1]) % pm)
            lam2 = lam1.zip(y_a_val).zip(x_a_val.zip(x_r)).map(
                lambda t: (2 * t[0][1]
                           * pow((t[1][0] - t[1][1]) % pm, pm - 2, pm)
                           - t[0][0]) % pm)
            region.assign_advice("lambda2", l2_col, row + offset,
                                 lambda v=lam2: v)
            x_a_new = lam2.zip(x_a_val.zip(x_r)).map(
                lambda t: (t[0] * t[0] - t[1][0] - t[1][1]) % pm)
            y_a_val = lam2.zip(x_a_val.zip(x_a_new)).zip(y_a_val).map(
                lambda t: (t[0][0] * (t[0][1][0] - t[0][1][1])
                           - t[1]) % pm)
            x_a = region.assign_advice("x_a", x_a_col,
                                       row + offset + 1,
                                       lambda v=x_a_new: v)
            x_a_val = x_a.value
        y_a = region.assign_advice("y_a", l1_col, offset + num_bits,
                                   lambda: y_a_val)
        return x_a, y_a, zs

    def _mul_complete(self, region, offset, bits, base, x_a, y_a, z):
        """mul/complete.rs:86-192."""
        cfg = self._config
        pm = cfg.field.modulus
        for it in range(NUM_COMPLETE_BITS):
            region.enable_selector("q_dec_var", cfg.q_mul_decompose_var,
                                   2 * it + offset + 1)
        acc = EccPoint(x_a, y_a)
        z = z.copy_advice("z from incomplete", region, cfg.advices[9],
                          offset)
        zs = []
        for it in range(NUM_COMPLETE_BITS):
            row = 2 * it
            k = bits.map(lambda b, i=INCOMPLETE_LEN + it: b[i])
            z_val = z.value.zip(k).map(lambda t: (2 * t[0] + t[1]) % pm)
            z = region.assign_advice("z", cfg.advices[9],
                                     row + offset + 2,
                                     lambda v=z_val: v)
            zs.append(z)
            base_y = base.y.copy_advice("copy base.y", region,
                                        cfg.advices[9],
                                        row + offset + 1)
            y_p_val = base_y.value.zip(k).map(
                lambda t: t[0] if t[1] else (pm - t[0]) % pm)
            y_p = region.assign_advice("y_p", cfg.advices[1],
                                       row + offset,
                                       lambda v=y_p_val: v)
            U = EccPoint(base.x, y_p)
            tmp = self._add_at(region, row + offset, U, acc)
            acc = self._add_at(region, row + offset + 1, acc, tmp)
        return acc, zs

    def _process_lsb(self, region, offset, base, acc, z_1, bits):
        """mul.rs:318-382."""
        cfg = self._config
        pm = cfg.field.modulus
        region.enable_selector("q_lsb", cfg.q_mul_lsb, offset)
        lsb = bits.map(lambda b: b[254])
        z_0_val = z_1.value.zip(lsb).map(lambda t: (2 * t[0] + t[1]) % pm)
        z_0 = region.assign_advice("z_0", cfg.advices[9], offset + 1,
                                   lambda: z_0_val)
        base.x.copy_advice("copy base_x", region, cfg.advices[0],
                           offset + 1)
        base.y.copy_advice("copy base_y", region, cfg.advices[1],
                           offset + 1)
        x_val = lsb.zip(base.x.value).map(
            lambda t: 0 if t[0] else t[1])
        y_val = lsb.zip(base.y.value).map(
            lambda t: 0 if t[0] else (pm - t[1]) % pm)
        x_cell = region.assign_advice("x", cfg.advices[0], offset,
                                      lambda: x_val)
        y_cell = region.assign_advice("y", cfg.advices[1], offset,
                                      lambda: y_val)
        p = EccPoint(x_cell, y_cell)
        result = self._add_at(region, offset, p, acc)
        return result, z_0

    def _overflow_check(self, layouter, alpha, zs):
        """mul/overflow.rs:102-188."""
        cfg = self._config
        pm = cfg.field.modulus
        s_val = alpha.value.zip(zs[254].value).map(
            lambda t: (t[0] + t[1] * (1 << 130)) % pm)
        s = layouter.assign_region(
            "s = alpha + k_254 * 2^130",
            lambda region: region.assign_advice(
                "s", cfg.advices[6], 0, lambda: s_val))
        zs_lookup = cfg.lookup_config.copy_check(layouter, s, 13, False)
        s_minus_lo_130 = zs_lookup[-1]

        def overflow_region(region):
            region.enable_selector("q_overflow", cfg.q_mul_overflow, 1)
            zs[0].copy_advice("z_0", region, cfg.advices[6], 0)
            z130 = zs[130].copy_advice("z_130", region, cfg.advices[6], 1)
            eta = z130.value.map(
                lambda v: 0 if v % pm == 0 else pow(v, pm - 2, pm))
            region.assign_advice("eta", cfg.advices[6], 2,
                                 lambda: eta)
            zs[254].copy_advice("k_254", region, cfg.advices[7], 0)
            alpha.copy_advice("alpha", region, cfg.advices[7], 1)
            s_minus_lo_130.copy_advice("s_minus_lo_130", region,
                                       cfg.advices[7], 2)
            s.copy_advice("s", region, cfg.advices[8], 1)

        layouter.assign_region("overflow check", overflow_region)

    # --------------------------------------------------- fixed-base mul
    def _assign_fixed_constants(self, region, offset, base, num_windows,
                                toggle):
        cfg = self._config
        lag, zs_us = base.tables()
        for w in range(num_windows):
            region.enable_selector("coords", toggle, w + offset)
            for k in range(H):
                region.assign_fixed(
                    f"lagrange w{w} k{k}", cfg.lagrange_coeffs[k],
                    w + offset, lambda w=w, k=k: Value.known(lag[w][k]))
            region.assign_fixed(
                f"z w{w}", cfg.fixed_z, w + offset,
                lambda w=w: Value.known(zs_us[w][0]))

    def _process_window(self, region, offset, w, k_val, scalar_val,
                        base, num_windows):
        """mul_fixed.rs:253-305: assign x_p, y_p = [scalar]B and u."""
        cfg = self._config
        _, zs_us = base.tables()
        mul_b = scalar_val.map(
            lambda s: PALLAS.mul(base.generator, s % PALLAS.scalar.modulus))
        x = region.assign_advice(
            f"mul_b_x w{w}", cfg.advices[0], offset + w,
            lambda: mul_b.map(lambda p: p[0]))
        y = region.assign_advice(
            f"mul_b_y w{w}", cfg.advices[1], offset + w,
            lambda: mul_b.map(lambda p: p[1]))
        u_val = k_val.map(lambda k: zs_us[w][1][k])
        region.assign_advice("u", cfg.advices[5], offset + w,
                             lambda: u_val)
        return EccPoint(x, y)

    def _mul_fixed_windows(self, region, offset, windows_vals, base,
                           num_windows, toggle):
        """mul_fixed.rs assign_region_inner: constants + init + loop +
        msb.  windows_vals: list[Value[int]] (window digits)."""
        self._assign_fixed_constants(region, offset, base, num_windows,
                                     toggle)
        q = PALLAS.scalar.modulus
        # initialize accumulator: w = 0, scalar = (k+2)
        acc = self._process_window(
            region, offset, 0, windows_vals[0],
            windows_vals[0].map(lambda k: (k + 2) % q), base,
            num_windows)
        # windows 1..num_windows-2
        for w in range(1, num_windows - 1):
            mul_b = self._process_window(
                region, offset, w, windows_vals[w],
                windows_vals[w].map(
                    lambda k, w=w: (k + 2) * pow(H, w, q) % q),
                base, num_windows)
            acc = self._add_incomplete_at(region, offset + w, mul_b, acc)
        # msb window
        off_acc = sum(1 << (FIXED_BASE_WINDOW_SIZE * j + 1)
                      for j in range(num_windows - 1)) % q
        mul_b = self._process_window(
            region, offset, num_windows - 1,
            windows_vals[num_windows - 1],
            windows_vals[num_windows - 1].map(
                lambda k: (k * pow(H, num_windows - 1, q) - off_acc) % q),
            base, num_windows)
        return acc, mul_b

    def mul_fixed(self, layouter, scalar: Value, base: FixedPointBase):
        """Full-width fixed-base mul (mul_fixed/full_width.rs:56-180).
        scalar: Value of a SCALAR-field int; witnessed lazily as 85
        3-bit windows."""
        cfg = self._config

        def region1(region):
            for idx in range(NUM_WINDOWS):
                region.enable_selector("q_full", cfg.q_mul_fixed_full,
                                       idx)
            windows = []
            for idx in range(NUM_WINDOWS):
                wv = scalar.map(lambda s, i=idx: (s >> (3 * i)) & 7)
                cell = region.assign_advice(f"k[{idx}]", cfg.advices[4],
                                            idx, lambda v=wv: v)
                windows.append(cell)
            window_vals = [c.value for c in windows]
            acc, mul_b = self._mul_fixed_windows(
                region, 0, window_vals, base, NUM_WINDOWS,
                cfg.q_mul_fixed_full)
            return acc, mul_b

        acc, mul_b = layouter.assign_region(
            "Full-width fixed-base mul (incomplete addition)", region1)
        result = layouter.assign_region(
            "Full-width fixed-base mul (last window, complete addition)",
            lambda region: self._add_at(region, 0, mul_b, acc))
        return result

    def mul_fixed_short(self, layouter, magnitude_sign, base):
        """Short signed fixed-base mul (mul_fixed/short.rs:108-245).
        magnitude_sign: (AssignedCell, AssignedCell)."""
        cfg = self._config
        magnitude, sign = magnitude_sign
        pm = cfg.field.modulus

        def region1(region):
            zs = self._decompose_running_sum(
                region, 0, magnitude, NUM_WINDOWS_SHORT, strict=True)
            window_vals = [
                zs[i].value.zip(zs[i + 1].value).map(
                    lambda t: (t[0] - t[1] * H) % pm)
                for i in range(NUM_WINDOWS_SHORT)]
            acc, mul_b = self._mul_fixed_windows(
                region, 0, window_vals, base, NUM_WINDOWS_SHORT,
                cfg.q_running_sum)
            return zs, acc, mul_b

        zs, acc, mul_b = layouter.assign_region(
            "Short fixed-base mul (incomplete addition)", region1)

        def region2(region):
            magnitude_mul = self._add_at(region, 0, mul_b, acc)
            sign_c = sign.copy_advice("sign", region, cfg.advices[4], 1)
            zs[21].copy_advice("last_window", region, cfg.advices[5], 1)
            y_val = sign_c.value.zip(magnitude_mul.y.value).map(
                lambda t: (pm - t[1]) % pm if t[0] == pm - 1 else t[1])
            region.enable_selector("q_short", cfg.q_mul_fixed_short, 1)
            y_var = region.assign_advice("y_var", cfg.advices[1], 1,
                                         lambda: y_val)
            return EccPoint(magnitude_mul.x, y_var)

        return layouter.assign_region(
            "Short fixed-base mul (most significant word)", region2)

    def _decompose_running_sum(self, region, offset, element,
                               num_windows, strict):
        """RunningSumConfig copy_decompose within an existing region
        (decompose_running_sum.rs:104-180) on the window column."""
        cfg = self._config
        pm = cfg.field.modulus
        w = FIXED_BASE_WINDOW_SIZE
        inv = pow(1 << w, pm - 2, pm)
        z = element.copy_advice("z_0", region, cfg.advices[4], offset)
        zs = [z]
        for i in range(num_windows):
            region.enable_selector("q_rs", cfg.q_running_sum, offset + i)
            word = element.value.map(
                lambda v, i=i: (v >> (w * i)) & ((1 << w) - 1))
            z_val = z.value.zip(word).map(
                lambda t: (t[0] - t[1]) * inv % pm)
            z = region.assign_advice(f"z_{i+1}", cfg.advices[4],
                                     offset + i + 1, lambda v=z_val: v)
            zs.append(z)
        if strict:
            region.constrain_constant(zs[-1].cell, 0)
        return zs

    def mul_fixed_base_field(self, layouter, scalar_cell: AssignedCell,
                             base: FixedPointBase):
        """Fixed-base mul by a base-field element
        (mul_fixed/base_field_elem.rs:170-378)."""
        cfg = self._config
        pm = cfg.field.modulus

        def region1(region):
            zs = self._decompose_running_sum(region, 0, scalar_cell,
                                             NUM_WINDOWS, strict=True)
            window_vals = [
                zs[i].value.zip(zs[i + 1].value).map(
                    lambda t: (t[0] - t[1] * H) % pm)
                for i in range(NUM_WINDOWS)]
            acc, mul_b = self._mul_fixed_windows(
                region, 0, window_vals, base, NUM_WINDOWS,
                cfg.q_running_sum)
            return zs, acc, mul_b

        zs, acc, mul_b = layouter.assign_region(
            "Base-field elem fixed-base mul (incomplete addition)",
            region1)
        result = layouter.assign_region(
            "Base-field elem fixed-base mul (complete addition)",
            lambda region: self._add_at(region, 0, mul_b, acc))

        alpha = zs[0]
        z_43, z_44, z_84 = zs[43], zs[44], zs[84]
        alpha_0_prime_val = alpha.value.zip(z_84.value).map(
            lambda t: (t[0] - t[1] * (1 << 252) + (1 << 130) - T_P) % pm)
        zs_l = cfg.lookup_config.witness_check(
            layouter, alpha_0_prime_val, 13, False)
        alpha_0_prime, z_13 = zs_l[0], zs_l[13]

        def canon_region(region):
            region.enable_selector("q_canon",
                                   cfg.q_mul_fixed_base_field, 1)
            alpha.copy_advice("alpha", region, cfg.advices[6], 0)
            z_84.copy_advice("z_84", region, cfg.advices[8], 0)
            alpha_0_prime.copy_advice("alpha_0_prime", region,
                                      cfg.advices[6], 1)
            a1 = alpha.value.map(
                lambda v: bitrange_subset(pm, v, 252, 254))
            region.assign_advice("alpha_1", cfg.advices[7], 1,
                                 lambda: a1)
            a2 = alpha.value.map(
                lambda v: bitrange_subset(pm, v, 254, 255))
            region.assign_advice("alpha_2", cfg.advices[8], 1,
                                 lambda: a2)
            z_13.copy_advice("z_13", region, cfg.advices[6], 2)
            z_44.copy_advice("z_44", region, cfg.advices[7], 2)
            z_43.copy_advice("z_43", region, cfg.advices[8], 2)

        layouter.assign_region("Canonicity checks", canon_region)
        return result

    def mul_sign(self, layouter, sign: AssignedCell, point: EccPoint):
        """mul_fixed/short.rs:247-346: [sign]P via the short gate."""
        cfg = self._config
        pm = cfg.field.modulus

        def region_fn(region):
            region.enable_selector("q_short", cfg.q_mul_fixed_short, 0)
            region.assign_advice_from_constant("u=0", cfg.advices[5], 0,
                                               0)
            sign.copy_advice("sign", region, cfg.advices[4], 0)
            point.y.copy_advice("unsigned y", region, cfg.advices[3], 0)
            signed_y_val = sign.value.zip(point.y.value).map(
                lambda t: (pm - t[1]) % pm if t[0] == pm - 1 else t[1])
            signed_y = region.assign_advice("signed y", cfg.advices[1],
                                            0, lambda: signed_y_val)
            return EccPoint(point.x, signed_y)

        return layouter.assign_region("Signed point", region_fn)
