"""device_launches: kernels the profiler saw on the card per traced proof,
the program's and PyTorch's alike (copies and memsets not counted)."""


def read(run):
    trace = run["trace"]
    if not trace or not trace["launches"]:
        return None
    return trace["launches"] / trace["proofs"]
