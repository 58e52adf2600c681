"""device_idle_pct: the share of the traced proofs' wall time in which
no kernel or copy ran on the card: 100 (1 - busy / window), busy the
union of the device intervals."""


def read(run):
    trace = run["trace"]
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
