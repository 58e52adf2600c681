"""dev_lookup for the program: halo2_tpu_torch's DevLookupCircuit, its
looked-up advice values taken from the witness that
benchmark/reference/dev_lookup.py draws from the seed.

The control keys and proves a circuit whose table's top entry is
2^bits + 1 instead of 2^bits, each witness value 2^bits moved with it: a
sound proof of another relation than the configuration's, which its
verifier must reject."""
from __future__ import annotations

import functools


@functools.cache
def _circuit_class():
    from halo2_tpu_torch.bench_circuit import DevLookupCircuit
    from halo2_tpu_torch.circuit import Value

    class SeededDevLookup(DevLookupCircuit):
        def __init__(self, table_bits, rows, values=None, control=False):
            super().__init__(table_bits, rows)
            self.values, self.control = values, control

        def without_witnesses(self):
            return SeededDevLookup(self.table_bits, self.rows, None,
                                   self.control)

        def synthesize(self, config, layouter):
            size = 1 << self.table_bits

            def entry(v):
                return v + 1 if self.control and v == size else v

            def fill_table(table):
                for row in range(size):
                    table.assign_cell(
                        f"row {row}", config["table"], row,
                        lambda row=row: Value.known(entry(row + 1)))
            layouter.assign_table(f"{self.table_bits}-bit table", fill_table)

            def assign(region):
                for offset in range(self.rows):
                    region.enable_selector("sel", config["selector"], offset)
                    region.assign_advice(
                        f"offset {offset}", config["advice"], offset,
                        lambda offset=offset: Value.unknown()
                        if self.values is None
                        else Value.known(entry(self.values[offset])))
            layouter.assign_region("assign values", assign)

    return SeededDevLookup


def keygen_circuit(cfg, control: bool = False):
    return _circuit_class()(cfg["table_bits"], cfg["rows"], None, control)


def circuit(cfg, values, control: bool = False):
    return _circuit_class()(cfg["table_bits"], cfg["rows"], values, control)


def instance(cfg, values, control: bool = False) -> list[list[int]]:
    return []
