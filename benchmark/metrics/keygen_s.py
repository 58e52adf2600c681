"""keygen_s: seconds of keygen_vk and keygen_pk for the cell's circuit,
on the benchmark's clock, the card synced (layer: entry points)."""


def read(run):
    return run["keygen_s"]
