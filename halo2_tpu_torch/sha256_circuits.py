"""The SHA-256 circuits: Table16's bench and two-block preimages, and the
bit-decomposition chip's one compression.

Each circuit is built against the classes of one package, so the port
and the JAX package synthesize and prove the same circuit:

  bench       halo2's benches/sha256.rs:148-150 (the repository's
              scripts/bench_sha256.py:37-53): Table16 hashing 31 words of
              0b01111000, proved at k = 17 (the 2^16-row spread table needs
              it); the FIPS padding makes three blocks
  two_block   Table16 over 16 words of TWO_BLOCK_WORD, the FIPS padding a
              second block (halo2's table16/compression.rs:951-1003 test)
  compress    Sha256Chip, one compression of a 16-word block from the IV,
              its 8 output words constrained to the instance column, at
              K = 14 over the Pallas base field (FQ)

`namespace(import_module)` gathers what the circuits use from one
package: `import_module("gadgets.sha256")` must return that package's
module. `port_namespace()` is the port's. Table16 omits the FIPS
feed-forward between blocks (the reference gadget's own semantics), so
its digest is `chained_rounds` of the padded words, not FIPS SHA-256;
`compress_host` is the chip's oracle.
"""
from __future__ import annotations

import importlib
import struct
from types import SimpleNamespace

from .gadgets.sha256 import IV, compress_host

K_TABLE16 = 17        # Table16's size: the spread table has 2^16 rows
K_COMPRESS = 14       # the bit-decomposition chip's
BENCH_WORD = 0b01111000
BENCH_WORDS = 31
TWO_BLOCK_WORD = 0b01111000100000000000000000000000
ABC_BLOCK = list(struct.unpack(
    ">16I", b"abc" + b"\x80" + b"\x00" * 52 + struct.pack(">Q", 24)))

# (attribute, module under the package, name in that module)
_NAMES = (
    ("Circuit", "circuit", "Circuit"),
    ("Value", "circuit", "Value"),
    ("FQ", "fields.host", "FQ"),
    ("Sha256", "gadgets.sha256", "Sha256"),
    ("BlockWord", "gadgets.sha256", "BlockWord"),
    ("Table16Chip", "gadgets.sha256.table16", "Table16Chip"),
    ("Sha256Chip", "gadgets.sha256.chip", "Sha256Chip"),
)


def namespace(import_module) -> SimpleNamespace:
    """The classes the circuits use, from the package whose modules
    `import_module(relative_name)` returns."""
    ns = SimpleNamespace(**{attr: getattr(import_module(mod), name)
                            for attr, mod, name in _NAMES})
    ns.classes = _classes(ns)
    return ns


def port_namespace() -> SimpleNamespace:
    return namespace(
        lambda mod: importlib.import_module(f"{__package__}.{mod}"))


def compress_rounds_only(state: list[int], block: list[int]) -> list[int]:
    """64 SHA-256 rounds without the final feed-forward add: what one
    Table16 compression proves."""
    return [(o - s) & 0xFFFFFFFF
            for o, s in zip(compress_host(state, block), state)]


def chained_rounds(words: list[int]) -> list[int]:
    """The digest Table16's `Sha256` wrapper proves for these message
    words: FIPS-padded, each block's raw rounds chained from the IV."""
    length = 32 * len(words)
    padded = list(words) + [0x80000000]
    while len(padded) % 16 != 14:
        padded.append(0)
    padded += [length >> 32, length & 0xFFFFFFFF]
    state = list(IV)
    for i in range(0, len(padded), 16):
        state = compress_rounds_only(state, padded[i:i + 16])
    return state


def table16_words(name: str) -> list[int]:
    """The message words of the Table16 circuit `name`."""
    return {"bench": [BENCH_WORD] * BENCH_WORDS,
            "two_block": [TWO_BLOCK_WORD] * 16}[name]


def table16_circuit(ns, name: str):
    """The Table16 circuit `name` ("bench" or "two_block") with its
    witness; after synthesis `digest_out` holds the digest words it
    assigned."""
    return ns.classes.Table16(tuple(table16_words(name)))


def _classes(ns) -> SimpleNamespace:
    Circuit, Value, BlockWord = ns.Circuit, ns.Value, ns.BlockWord
    Table16Chip, Sha256Chip, Sha256 = ns.Table16Chip, ns.Sha256Chip, ns.Sha256

    class Table16Circuit(Circuit):
        """Sha256 over Table16: update with the words, then finalize."""

        def __init__(self, words=()):
            self.words = words
            self.digest_out = None

        def without_witnesses(self):
            return type(self)(self.words)

        @classmethod
        def configure(cls, meta):
            return Table16Chip.configure(meta)

        def synthesize(self, config, layouter):
            Table16Chip.load(config, layouter)
            sha = Sha256(Table16Chip(config), layouter)
            sha.update([BlockWord(Value.known(w)) for w in self.words])
            self.digest_out = [w.value.inner() for w in sha.finalize()]

    class CompressCircuit(Circuit):
        """One compression of a 16-word block from the IV; the 8 output
        state words are copied to the instance column."""

        def __init__(self, block=None):
            self.block = block

        def without_witnesses(self):
            return type(self)()

        @classmethod
        def configure(cls, meta):
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            instance = meta.instance_column()
            meta.enable_equality(instance)
            return {"sha": Sha256Chip.configure(meta, ns.FQ),
                    "instance": instance}

        def synthesize(self, config, layouter):
            chip = Sha256Chip(config["sha"])
            state = chip.initialization_vector(layouter)
            words = [BlockWord(Value.known(w) if self.block is not None
                               else Value.unknown())
                     for w in (self.block or [0] * 16)]
            out = chip.compress(layouter, state, words)
            for i, word in enumerate(out):
                layouter.constrain_instance(word.cell.cell,
                                            config["instance"], i)

    return SimpleNamespace(Table16=Table16Circuit, Compress=CompressCircuit)
