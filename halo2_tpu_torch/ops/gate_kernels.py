"""Kernel K2: one chunk of gate polynomials folded into the quotient
accumulator in one launch, and its plain version.

Replaces one jitted gate chunk of halo2_tpu/plonk/prover.py:220-255 (an
XLA program traced from the chunk's expressions; no Pallas call). A
chunk is compiled once into a tape (plonk/evaluation.py::compile_chunk),
a list of instructions over numbered slots:

    QUERY dst, kind << 16 | column, rotation   a column at row r + rot
    CONST dst, i                               constant table entry i
    NEG dst, a      ADD dst, a, b      MUL dst, a, b
    SCALE dst, a, i                            slot a times constant i
    FOLD -, a, first                           acc = first ? a : acc y + a

and then h_new = h_prev y^k + acc for the chunk's k polynomials (the
reference's Horner order: its chunk folds the same way). The kernel
(csrc/gate_kernels.cu) runs the tape on every row, one thread a row,
grid-stride: every thread of a warp runs the same instruction, so the
tape is data and nothing is generated or compiled per circuit. The
tape, the constant table (Montgomery form) and the column pointers sit
in shared memory; slots are 8 x 32-bit limbs in local memory, and the
previous result stays in registers where the op word's flags say so (an
operand the previous instruction made, a result only the next one
reads, which is then never stored). Its work is bound by operations
(each MUL and SCALE a Montgomery product, the fold's two a row), unless
a chunk's queries move more bytes than that.

The plain version interprets the same tape over whole tensors with the
plain field ops (a query is a torch.roll; the flags are not needed,
since it writes every result to its slot), so the CPU tests run the tape
the card runs. `LAUNCHES` counts K2's launches, nowhere else
(tracing.launch, with a launch's work: each queried column read once and
h written once, 64 bytes a row each, and GateTape.muls() products a
row).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import tracing
from ..fields.device import DeviceField, NLIMBS, R as MONT_R, ints_to_digits
from .field_kernels import (MONT_MULADDS, fmul_plain, fadd_plain,
                            fsub_plain, _dispatch)

LAUNCHES = tracing.launch_counters("gate_chunk")

OP_QUERY, OP_CONST, OP_NEG, OP_ADD, OP_MUL, OP_SCALE, OP_FOLD = range(7)
# the op word: the opcode in its low byte, then flags that let the kernel
# keep the previous result in registers (csrc/gate_kernels.cu): the
# result is read by the next instruction alone (not written to its slot),
# operand x / y is the previous instruction's result
OP_MASK = 0xFF
OPF_KEEP, OPF_X_LAST, OPF_Y_LAST = 1 << 8, 1 << 9, 1 << 10
KIND_ADVICE, KIND_FIXED, KIND_INSTANCE = range(3)
# slots a thread holds at most (csrc/gate_kernels.cu's largest kSlots form)
MAX_SLOTS = 128


@dataclass(eq=False)
class GateTape:
    """A compiled chunk: `code` [(op, dst, x, y)], the constant table
    (plain ints), the slots it needs and the polynomials it folds. The
    device copy (instructions as int32 [I, 4], constants as Montgomery
    digits) is made once a device and field."""
    code: list
    consts: list
    n_slots: int
    n_polys: int
    _dev: dict = field(default_factory=dict, repr=False)

    def on(self, df: DeviceField, device) -> tuple:
        device = torch.device(device)
        key = (df.field_id, device)
        ent = self._dev.get(key)
        if ent is None:
            p = df.spec.modulus
            code = tracing.upload("gate_tape", torch.from_numpy(
                np.asarray(self.code, np.int32).reshape(-1, 4)), device)
            consts = tracing.upload("gate_tape", torch.from_numpy(
                ints_to_digits([v % p * MONT_R % p for v in self.consts]
                               or [0])), device)
            ent = self._dev[key] = (code, consts)
        return ent

    def muls(self) -> int:
        """Montgomery products a row: MUL, SCALE and one a FOLD after the
        first, and the chunk's h_prev y^k."""
        return (sum((op & OP_MASK) in (OP_MUL, OP_SCALE)
                    for op, *_ in self.code) + self.n_polys)


def _rot(values: torch.Tensor, rotation: int, scale: int) -> torch.Tensor:
    if rotation == 0:
        return values
    return torch.roll(values, -rotation * scale, dims=0)


def run_chunk_plain(df: DeviceField, tape: GateTape, h_prev, advice: list,
                    fixed: list, instance: list, rot_scale: int,
                    y_m: torch.Tensor, yk_m: torch.Tensor, n: int,
                    rows=None) -> torch.Tensor:
    """run_chunk's plain version on any device: the tape over whole
    [n, 16] tensors with the plain field ops (h_prev is not changed).
    Given `rows` (an index tensor), only those rows: a query reads rows
    (rows + rotation) mod n of its column, and h_prev holds those rows."""
    columns = (advice, fixed, instance)
    code, consts = tape.on(df, y_m.device)
    slots: list = [None] * tape.n_slots
    acc = None
    for word, dst, x, y in tape.code:
        op = word & OP_MASK
        if op == OP_QUERY:
            col = columns[x >> 16][x & 0xFFFF]
            slots[dst] = (_rot(col, y, rot_scale) if rows is None else
                          col.index_select(0, (rows + y * rot_scale) % n))
        elif op == OP_CONST:
            slots[dst] = consts[x]
        elif op == OP_NEG:
            slots[dst] = fsub_plain(df, torch.zeros_like(slots[x]),
                                    slots[x])
        elif op == OP_ADD:
            slots[dst] = fadd_plain(df, slots[x], slots[y])
        elif op == OP_MUL:
            slots[dst] = fmul_plain(df, slots[x], slots[y])
        elif op == OP_SCALE:
            slots[dst] = fmul_plain(df, slots[x], consts[y])
        elif op == OP_FOLD:
            acc = (slots[x] if y else
                   fadd_plain(df, fmul_plain(df, acc, y_m), slots[x]))
        else:
            raise ValueError(f"unknown tape op {op}")
    acc = acc.expand(n if rows is None else rows.shape[0], NLIMBS)
    if h_prev is None:
        return acc.clone()
    return fadd_plain(df, fmul_plain(df, h_prev, yk_m), acc)


_PTRS: dict = {}


def _pointer_table(columns: list, device) -> torch.Tensor:
    """The columns' addresses as an int64 device tensor, kept by the
    addresses themselves (a table made for the same addresses holds the
    same values), so a prove's chunks upload it once."""
    key = (device, tuple(c.data_ptr() for c in columns))
    table = _PTRS.get(key)
    if table is None:
        if len(_PTRS) >= 64:
            _PTRS.clear()
        table = _PTRS[key] = tracing.upload(
            "gate_ptrs", torch.tensor(list(key[1]) or [0],
                                      dtype=torch.int64), device)
    return table


def run_chunk(df: DeviceField, tape: GateTape, h_prev, advice: list,
              fixed: list, instance: list, rot_scale: int,
              y_m: torch.Tensor, yk_m: torch.Tensor, n: int
              ) -> torch.Tensor:
    """h_prev * y^k + (the chunk's polynomials folded by y) over n rows:
    kernel K2 on CUDA (one launch), the plain version on the CPU. h_prev
    None is no accumulator yet (the result is the chunk's own fold);
    otherwise it is int32 [n, 16] and is updated in place on CUDA."""
    every = [*advice, *fixed, *instance]
    if not _dispatch(y_m):
        return run_chunk_plain(df, tape, h_prev, advice, fixed, instance,
                               rot_scale, y_m, yk_m, n)
    if tape.n_slots > MAX_SLOTS:
        raise ValueError(f"a tape of {tape.n_slots} slots; the kernel "
                         f"holds {MAX_SLOTS}")
    if n & (n - 1):
        raise ValueError(f"{n} rows: the kernel wraps rotations modulo a "
                         f"power of two")
    for c in every + ([] if h_prev is None else [h_prev]):
        if (c.dtype != torch.int32 or tuple(c.shape) != (n, NLIMBS)
                or not c.is_contiguous() or c.device != y_m.device):
            raise TypeError(f"columns and h_prev are contiguous int32 "
                            f"[{n}, 16] on "
                            f"{y_m.device}, got {c.dtype} "
                            f"{tuple(c.shape)} on {c.device}")
    from . import cuda_build
    code, consts = tape.on(df, y_m.device)
    ptrs = _pointer_table(every, y_m.device)
    if h_prev is None:
        out, has_prev = torch.empty((n, NLIMBS), dtype=torch.int32,
                                    device=y_m.device), 0
    else:
        out, has_prev = h_prev, 1
    yy = torch.stack([y_m.reshape(NLIMBS), yk_m.reshape(NLIMBS)]).contiguous()
    lib = cuda_build.library("gate_kernels")
    rc = lib.h2t_gate_chunk(df.field_id, out.data_ptr(), has_prev,
                            code.data_ptr(), code.shape[0], tape.n_slots,
                            consts.data_ptr(), consts.shape[0],
                            ptrs.data_ptr(), len(every), len(advice),
                            len(fixed), yy.data_ptr(), n, rot_scale,
                            cuda_build.stream_ptr(y_m.device))
    cuda_build.check(rc, "h2t_gate_chunk")
    queried = len({x for op, _, x, _ in tape.code
                   if (op & OP_MASK) == OP_QUERY})
    tracing.launch("gate_chunk", n, (queried + 1) * n * NLIMBS * 4,
                   tape.muls() * n * MONT_MULADDS)
    return out
