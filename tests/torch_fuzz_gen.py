"""The generators of ``tests/test_fuzz_differential.py`` for the port's
copies of those tests (``tests/test_torch_fuzz_*.py``).

``Gen(name, trial)`` reseeds exactly as that file's ``reseed`` does and
draws formats and raws with the same calls in the same order, as port
formats, so trial t of a test is the same configuration in both files.
``jfmt`` carries a port format to the JAX package; ``same_fmt`` compares a
port format with a JAX one field by field (the two packages' QFormat
classes differ).
"""

import dataclasses
import importlib
import zlib

import numpy as np

from qublas_tpu.qtensor import from_raw as jax_from_raw
from qublas_tpu_torch import port_format
from qublas_tpu_torch.qformat import OverflowMode, RoundMode, qformat

# the module (the package's ``qformat`` name is its constructor function)
_jq = importlib.import_module("qublas_tpu.qformat")


class Gen:
    def __init__(self, name: str, trial: int):
        self.rng = np.random.RandomState(
            zlib.crc32(f"{name}:{trial}".encode()) % (2**31))

    def fmt(self, max_total=24):
        rng = self.rng
        while True:
            i = int(rng.randint(-6, 20))
            f = int(rng.randint(-6, 20))
            if 0 <= i + f <= max_total:
                break
        return qformat(i, f, bool(rng.randint(0, 2)),
                       RoundMode(rng.randint(0, 7)),
                       OverflowMode(rng.randint(0, 5)))

    def wide_fmt(self):
        """A format with 33..64-bit storage (pair storage)."""
        rng = self.rng
        while True:
            i = int(rng.randint(-6, 60))
            f = int(rng.randint(-6, 60))
            if 32 <= i + f <= 63:
                break
        return qformat(i, f, bool(rng.randint(0, 2)),
                       RoundMode(rng.randint(0, 7)),
                       OverflowMode(rng.randint(0, 5)))

    def raws(self, fmt, n):
        lo = max(fmt.raw_min, -(1 << 62))
        hi = min(fmt.raw_max, (1 << 62) - 1)
        return np.array([int(self.rng.randint(lo, hi + 1)) for _ in range(n)],
                        dtype=object)


def jfmt(f):
    """The JAX package's QFormat with the fields of the port format ``f``
    (None stays None)."""
    if f is None:
        return None
    return _jq.QFormat(f.int_bits, f.frac_bits, f.signed,
                       _jq.RoundMode(int(f.round_mode)),
                       _jq.OverflowMode(int(f.overflow_mode)))


def jq(raws, f):
    """A JAX QTensor of the raws in the port format ``f``."""
    return jax_from_raw(raws, jfmt(f))


def same_fmt(port_f, jax_f) -> bool:
    return dataclasses.astuple(port_f) == \
        dataclasses.astuple(port_format(jax_f))


def flat(t):
    """The raws of a QTensor of either package as a flat list of ints."""
    return [int(v) for v in np.asarray(t.raw(), dtype=object).reshape(-1)]
