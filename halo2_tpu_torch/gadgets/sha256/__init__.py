"""SHA-256 gadget: streaming 32-bit-word interface + host primitive.

Reference: halo2_gadgets/src/sha256.rs — `Sha256Instructions` (:25-57)
and the `Sha256` streaming wrapper (:66-150). The Table16 chip
(spread-table lookups, message schedule + compression subregions,
halo2_gadgets/src/sha256/table16/, 6,039 LoC) is scheduled for round 2
(PARITY.md); the instruction trait and digest framing here are the
complete gadget surface, and `sha256_host` is the bit-exact primitive
oracle (FIPS 180-4) used by the chip tests.

Copied from halo2_tpu/gadgets/sha256/__init__.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

BLOCK_SIZE = 16   # 32-bit words per block (sha256.rs:20)
DIGEST_SIZE = 8   # 32-bit words per digest (sha256.rs:22)

IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

ROUND_CONSTANTS = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def compress_host(state: list[int], block: list[int]) -> list[int]:
    """One SHA-256 compression (FIPS 180-4 §6.2.2); block = 16 words."""
    w = list(block) + [0] * 48
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w[i] = (w[i - 16] + s0 + w[i - 7] + s1) & 0xFFFFFFFF
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + ROUND_CONSTANTS[i] + w[i]) & 0xFFFFFFFF
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & 0xFFFFFFFF
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & 0xFFFFFFFF, c, b, a,
                                  (t1 + t2) & 0xFFFFFFFF)
    return [(x + y) & 0xFFFFFFFF for x, y in zip(state,
                                                 [a, b, c, d, e, f, g, h])]


def sha256_host(data: bytes) -> bytes:
    """Full SHA-256 over bytes (padding + framing), host oracle."""
    length = len(data) * 8
    data = data + b"\x80"
    data += b"\x00" * ((56 - len(data) % 64) % 64)
    data += struct.pack(">Q", length)
    state = list(IV)
    for off in range(0, len(data), 64):
        block = list(struct.unpack(">16I", data[off:off + 64]))
        state = compress_host(state, block)
    return struct.pack(">8I", *state)


@dataclass
class BlockWord:
    """A 32-bit word value (sha256.rs BlockWord)."""
    value: object  # Value[int]


class Sha256Instructions:
    """Instruction set the chip must implement (sha256.rs:25-57)."""

    def initialization_vector(self, layouter):
        raise NotImplementedError

    def initialization(self, layouter, init_state):
        raise NotImplementedError

    def compress(self, layouter, initialized_state, input_words):
        raise NotImplementedError

    def digest(self, layouter, state):
        raise NotImplementedError


class Sha256:
    """Streaming hasher over a Sha256Instructions chip (sha256.rs:66-150):
    buffers BlockWords, compresses per 16-word block, pads per FIPS
    framing at finalize."""

    def __init__(self, chip: Sha256Instructions, layouter):
        self.chip = chip
        self.layouter = layouter
        self.state = chip.initialization_vector(layouter)
        self.cur_block: list[BlockWord] = []
        self.length = 0  # bits

    def update(self, data: list[BlockWord]) -> None:
        self.length += len(data) * 32
        self.cur_block.extend(data)
        while len(self.cur_block) >= BLOCK_SIZE:
            block, self.cur_block = (self.cur_block[:BLOCK_SIZE],
                                     self.cur_block[BLOCK_SIZE:])
            self.state = self.chip.compress(self.layouter, self.state,
                                            block)
            self.state = self.chip.initialization(self.layouter, self.state)

    def finalize(self):
        from ...circuit.value import Value
        # FIPS padding in 32-bit words: 0x80000000, zeros, 64-bit length
        pad = [BlockWord(Value.known(0x80000000))]
        while (len(self.cur_block) + len(pad)) % BLOCK_SIZE != 14:
            pad.append(BlockWord(Value.known(0)))
        pad.append(BlockWord(Value.known((self.length >> 32) & 0xFFFFFFFF)))
        pad.append(BlockWord(Value.known(self.length & 0xFFFFFFFF)))
        self.cur_block.extend(pad)
        while len(self.cur_block) >= BLOCK_SIZE:
            block, self.cur_block = (self.cur_block[:BLOCK_SIZE],
                                     self.cur_block[BLOCK_SIZE:])
            self.state = self.chip.compress(self.layouter, self.state,
                                            block)
            if len(self.cur_block) >= BLOCK_SIZE:
                # the post-compress digest state carries only dense
                # halves; re-decompose before the next compression
                # (sha256.rs:115-123 interposes initialization before
                # every additional block)
                self.state = self.chip.initialization(self.layouter,
                                                      self.state)
        return self.chip.digest(self.layouter, self.state)
