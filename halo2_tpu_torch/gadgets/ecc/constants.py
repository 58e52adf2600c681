"""Fixed-base scalar-multiplication constants (host-side).

Reference: halo2_gadgets/src/ecc/chip/constants.rs — 3-bit windowed
tables for fixed bases: window w of the first num_windows-1 holds
[(k+2)*8^w]B for k in [0..8); the last window holds [k*8^(nw-1) - sum]B
with sum = Σ_j 2^(3j+1).  Per window we store the Lagrange-interpolated
x-coordinate coefficients, and (z, u[8]) pairs such that z + y is
square (u^2) and z - y is non-square for every window point — used by
the mul_fixed gates to prove y-coordinate correctness.

Copied from halo2_tpu/gadgets/ecc/constants.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import functools

from ...curves.host import PALLAS, CurveSpec, Point
from ...poly.multiopen import lagrange_interpolate

FIXED_BASE_WINDOW_SIZE = 3
H = 1 << FIXED_BASE_WINDOW_SIZE
# ceil(255 / 3) windows for a full-width scalar (constants.rs:18-23)
NUM_WINDOWS = (255 + FIXED_BASE_WINDOW_SIZE - 1) // FIXED_BASE_WINDOW_SIZE
L_SCALAR_SHORT = 64
NUM_WINDOWS_SHORT = (L_SCALAR_SHORT + FIXED_BASE_WINDOW_SIZE - 1) \
    // FIXED_BASE_WINDOW_SIZE


def compute_window_table(curve: CurveSpec, base: Point,
                         num_windows: int) -> list[list[Point]]:
    """constants.rs:40-83."""
    q = curve.scalar.modulus
    table = []
    for w in range(num_windows - 1):
        table.append([curve.mul(base, (k + 2) * pow(H, w, q) % q)
                      for k in range(H)])
    s = sum(1 << (FIXED_BASE_WINDOW_SIZE * j + 1)
            for j in range(num_windows - 1)) % q
    table.append([curve.mul(base,
                            (k * pow(H, num_windows - 1, q) - s) % q)
                  for k in range(H)])
    return table


def compute_lagrange_coeffs(curve: CurveSpec, base: Point,
                            num_windows: int) -> list[list[int]]:
    """Per window, coefficients of the degree-7 interpolation of x over
    k in [0..8) (constants.rs:87-109)."""
    pts = list(range(H))
    out = []
    for window in compute_window_table(curve, base, num_windows):
        xs = [p[0] for p in window]
        out.append(lagrange_interpolate(curve.base, pts, xs))
    return out


def find_zs_and_us(curve: CurveSpec, base: Point, num_windows: int
                   ) -> list[tuple[int, list[int]]]:
    """constants.rs:115-160: for each window find z with z+y square and
    z-y non-square for all 8 ys; u = sqrt(z + y)."""
    f = curve.base
    p = f.modulus
    result = []
    for window in compute_window_table(curve, base, num_windows):
        ys = [pt[1] for pt in window]
        found = None
        for z in range(1000 * (1 << (2 * H))):
            us = []
            ok = True
            for y in ys:
                if f.is_square((z - y) % p):
                    ok = False
                    break
                zy = (z + y) % p
                if not f.is_square(zy):
                    ok = False
                    break
                us.append(f.sqrt(zy))
            if ok:
                found = (z, us)
                break
        assert found is not None, "no z found for window"
        result.append(found)
    return result


@functools.lru_cache(maxsize=None)
def fixed_base_constants(base: Point, num_windows: int = NUM_WINDOWS):
    """Memoized (lagrange_coeffs, zs_and_us) for a Pallas fixed base.
    The z/u search is minutes of host work, so results are cached on
    disk under .fixed_base_cache/ keyed by (base, num_windows)."""
    import hashlib
    import json
    import os
    cache_dir = os.path.join(os.path.dirname(__file__), "..", "..",
                             "..", ".fixed_base_cache")
    key = hashlib.sha256(
        f"{base[0]:x}:{base[1]:x}:{num_windows}".encode()).hexdigest()[:24]
    path = os.path.join(cache_dir, key + ".json")
    if os.path.exists(path):
        with open(path) as fh:
            data = json.load(fh)
        return ([[int(c) for c in w] for w in data["lag"]],
                [(int(z), [int(u) for u in us])
                 for z, us in data["zs_us"]])
    lag = compute_lagrange_coeffs(PALLAS, base, num_windows)
    zs_us = find_zs_and_us(PALLAS, base, num_windows)
    os.makedirs(cache_dir, exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"lag": [[str(c) for c in w] for w in lag],
                   "zs_us": [[str(z), [str(u) for u in us]]
                             for z, us in zs_us]}, fh)
    return lag, zs_us
