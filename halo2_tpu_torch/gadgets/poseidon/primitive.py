"""Poseidon permutation primitive (off-circuit).

Reference: halo2_poseidon — Spec trait + permute (lib.rs:39-151), Grain
self-shrinking LFSR for round constants (grain.rs), Cauchy MDS generation
with Schechter-inverse (mds.rs), typestate sponge + ConstantLength domain
(lib.rs:185-465), P128Pow5T3 width-3 rate-2 x^5 spec (8 full + 56 partial
rounds). Constants are *generated* here via Grain/MDS exactly as the
reference's sage pipeline does (the reference hardcodes the output in
fp.rs/fq.rs; tests pin a sample of those values as the oracle).

Copied from halo2_tpu/gadgets/poseidon/primitive.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import functools

from ...fields.host import FieldSpec, FP, FQ

STATE_BITS = 80


class Grain:
    """Self-shrinking Grain LFSR (grain.rs), bit-exact."""

    def __init__(self, spec: FieldSpec, t: int, r_f: int, r_p: int,
                 sbox_tag: int = 0):
        self.spec = spec
        self.num_bits = spec.modulus.bit_length()  # F::NUM_BITS (255)
        state = [True] * STATE_BITS

        def set_bits(offset, length, value):
            for i in range(length):
                state[offset + length - 1 - i] = ((value >> i) & 1) != 0

        set_bits(0, 2, 1)          # FieldType::PrimeOrder
        set_bits(2, 4, sbox_tag)   # SboxType::Pow
        set_bits(6, 12, self.num_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)
        self.state = state
        self.next_bit = STATE_BITS
        for _ in range(20):
            self._load_next_8_bits()
            self.next_bit = STATE_BITS

    def _load_next_8_bits(self):
        s = self.state
        new_bits = 0
        for i in range(8):
            b = (s[i + 62] ^ s[i + 51] ^ s[i + 38] ^ s[i + 23]
                 ^ s[i + 13] ^ s[i])
            new_bits |= int(b) << i
        # rotate left by 8
        self.state = s[8:] + s[:8]
        self.next_bit -= 8
        for i in range(8):
            self.state[self.next_bit + i] = ((new_bits >> i) & 1) != 0

    def _get_next_bit(self) -> bool:
        if self.next_bit == STATE_BITS:
            self._load_next_8_bits()
        ret = self.state[self.next_bit]
        self.next_bit += 1
        return ret

    def next_shrunk_bit(self) -> bool:
        # self-shrinking: 1 -> output next bit; 0 -> discard next bit
        while not self._get_next_bit():
            self._get_next_bit()
        return self._get_next_bit()

    def _bits_to_int_msb(self, nbits: int) -> int:
        """Interpret nbits shrunk bits in MSB order (grain.rs:114-137)."""
        v = 0
        for _ in range(nbits):
            v = (v << 1) | int(self.next_shrunk_bit())
        return v

    def next_field_element(self) -> int:
        """Rejection-sampled (round constants)."""
        while True:
            v = self._bits_to_int_msb(self.num_bits)
            if v < self.spec.modulus:
                return v

    def next_field_element_without_rejection(self) -> int:
        """Reduce-sampled (MDS xs/ys): the MSB-ordered bits are placed in a
        64-byte LE buffer exactly as grain.rs:141-168 does, then reduced."""
        v = self._bits_to_int_msb(self.num_bits)
        # grain.rs writes bit i (MSB-first stream) to position
        # (NUM_BITS - 1 - i) of an LE byte buffer -> the integer v as-is.
        return v % self.spec.modulus


def generate_mds(spec: FieldSpec, grain: Grain, t: int, select: int):
    """mds.rs:7-120: Cauchy matrix a_ij = 1/(x_i + y_j) with the
    `select`-th secure candidate, plus its inverse via Schechter's
    Lagrange-polynomial formula."""
    p = spec.modulus
    while True:
        while True:
            vals = [grain.next_field_element_without_rejection()
                    for _ in range(2 * t)]
            if len(set(vals)) == len(vals):
                xs, ys = vals[:t], vals[t:]
                break
        if select != 0:
            select -= 1
            continue
        mds = [[pow((xs[i] + ys[j]) % p, p - 2, p) for j in range(t)]
               for i in range(t)]
        break

    # inverse: b_ij = (x_j + y_i) A_j(y_i) B_i(x_j) with negated-ys
    # adaptation (mds.rs:69-120)
    neg_ys = [(-y) % p for y in ys]

    def lagrange_eval(pts, j, x):
        # l_j(x) = prod_{m != j} (x - pts[m]) / (pts[j] - pts[m])
        num, den = 1, 1
        for m, pm in enumerate(pts):
            if m == j:
                continue
            num = num * ((x - pm) % p) % p
            den = den * ((pts[j] - pm) % p) % p
        return num * pow(den, p - 2, p) % p

    mds_inv = [[0] * t for _ in range(t)]
    for i in range(t):
        for j in range(t):
            mds_inv[i][j] = ((xs[j] + ys[i]) % p
                             * lagrange_eval(xs, j, neg_ys[i]) % p
                             * lagrange_eval(neg_ys, i, xs[j]) % p)
    return mds, mds_inv


class Spec:
    """Poseidon specification (lib.rs:39-61)."""
    t: int
    rate: int

    def full_rounds(self) -> int:
        raise NotImplementedError

    def partial_rounds(self) -> int:
        raise NotImplementedError

    def sbox(self, spec: FieldSpec, v: int) -> int:
        raise NotImplementedError

    def secure_mds(self) -> int:
        raise NotImplementedError

    def constants(self, spec: FieldSpec):
        return generate_constants(spec, self)


@functools.lru_cache(maxsize=None)
def _cached_constants(modulus: int, t: int, r_f: int, r_p: int, secure: int):
    spec = FP if modulus == FP.modulus else FQ
    grain = Grain(spec, t, r_f, r_p)
    round_constants = [[grain.next_field_element() for _ in range(t)]
                       for _ in range(r_f + r_p)]
    mds, mds_inv = generate_mds(spec, grain, t, secure)
    return round_constants, mds, mds_inv


def generate_constants(spec: FieldSpec, s: Spec):
    """lib.rs:64-91."""
    return _cached_constants(spec.modulus, s.t, s.full_rounds(),
                             s.partial_rounds(), s.secure_mds())


class P128Pow5T3(Spec):
    """Width-3, rate-2, x^5, 8 full + 56 partial rounds (p128pow5t3.rs)."""
    t = 3
    rate = 2

    def full_rounds(self) -> int:
        return 8

    def partial_rounds(self) -> int:
        return 56

    def sbox(self, spec: FieldSpec, v: int) -> int:
        return pow(v, 5, spec.modulus)

    def secure_mds(self) -> int:
        return 0


def permute(spec: FieldSpec, s: Spec, state: list[int], mds, round_constants
            ) -> list[int]:
    """lib.rs:106-151: r_f/2 full, r_p partial, r_f/2 full rounds."""
    p = spec.modulus
    t = s.t
    r_f = s.full_rounds() // 2
    r_p = s.partial_rounds()

    def apply_mds(st):
        return [sum(mds[i][j] * st[j] for j in range(t)) % p
                for i in range(t)]

    rc_iter = iter(round_constants)
    for _ in range(r_f):
        rcs = next(rc_iter)
        state = apply_mds([s.sbox(spec, (w + rc) % p)
                           for w, rc in zip(state, rcs)])
    for _ in range(r_p):
        rcs = next(rc_iter)
        state = [(w + rc) % p for w, rc in zip(state, rcs)]
        state[0] = s.sbox(spec, state[0])
        state = apply_mds(state)
    for _ in range(r_f):
        rcs = next(rc_iter)
        state = apply_mds([s.sbox(spec, (w + rc) % p)
                           for w, rc in zip(state, rcs)])
    return state


class ConstantLength:
    """Domain: capacity = length * 2^64, zero-padding to RATE multiple
    (lib.rs:389-413)."""

    def __init__(self, length: int):
        self.length = length

    def initial_capacity_element(self) -> int:
        return self.length << 64

    def padding(self, rate: int) -> list[int]:
        k = (self.length + rate - 1) // rate
        return [0] * (k * rate - self.length)


class Sponge:
    """Absorb/squeeze sponge state machine (lib.rs:185-370)."""

    def __init__(self, spec: FieldSpec, s: Spec, domain: ConstantLength):
        self.spec = spec
        self.s = s
        rc, mds, _ = s.constants(spec)
        self.rc = rc
        self.mds = mds
        self.rate = s.rate
        self.state = [0] * s.t
        self.state[self.rate] = domain.initial_capacity_element() \
            % spec.modulus
        self.buffer: list[int] = []
        self.squeeze_buffer: list[int] | None = None

    def _process(self, absorb_vals):
        for i, v in enumerate(absorb_vals):
            self.state[i] = (self.state[i] + v) % self.spec.modulus
        self.state = permute(self.spec, self.s, self.state, self.mds,
                             self.rc)
        return list(self.state[:self.rate])

    def absorb(self, value: int) -> None:
        if len(self.buffer) == self.rate:
            self._process(self.buffer)
            self.buffer = []
        self.buffer.append(value % self.spec.modulus)

    def finish_absorbing(self) -> None:
        self.squeeze_buffer = self._process(self.buffer)
        self.buffer = []

    def squeeze(self) -> int:
        if self.squeeze_buffer is None:
            self.finish_absorbing()
        if not self.squeeze_buffer:
            self.squeeze_buffer = self._process([])
        return self.squeeze_buffer.pop(0)


def poseidon_hash(spec: FieldSpec, s: Spec, message: list[int]) -> int:
    """Hash<ConstantLength<L>> (lib.rs:454-465)."""
    domain = ConstantLength(len(message))
    sponge = Sponge(spec, s, domain)
    for v in list(message) + domain.padding(s.rate):
        sponge.absorb(v)
    sponge.finish_absorbing()
    return sponge.squeeze()
