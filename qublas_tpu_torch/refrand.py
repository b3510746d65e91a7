"""Reference-identical random fill streams.

Copy of ``qublas_tpu.refrand`` (the port imports nothing of the JAX
package).  The reference seeds a global ``std::mt19937 gen(1)``
(QuBLAS.h:30) and ``fill()`` draws from ``std::uniform_int_distribution``
over the storage range (scalar ``ArbiInt<N<=64>``, QuBLAS.h:526-536) or per
64-bit limb (multiword, QuBLAS.h:799-820):

* :class:`MT19937` — the standard Mersenne Twister (init_genrand seeding,
  identical to ``std::mt19937(seed)``),
* :func:`uniform_int` — libstdc++'s ``uniform_int_distribution`` draw
  (downscale by rejection / recursive upscale), its ``__uctype``
  arithmetic done mod 2^64 as on LP64 Linux,
* :func:`fill_raw` — one reference ``fill()`` draw for a storage width,
  the multiword path's wrapped-bound partial word included,
* :func:`reference_fill` — a QTensor filled element by element in flat
  order (tensor ``fill()``, QuBLAS.h:2837-2845),
* :func:`reference_shuffle` — the tensor ``shuffle()`` permutation.

The draws are Python-int loops on the host, as in the JAX package; only
the finished raws (or the permutation) go to the device.
``tests/golden_data/fill.json`` and ``shuffle.json`` pin them to the
compiled reference.
"""

from __future__ import annotations

import numpy as np

from .qformat import QFormat

__all__ = ["MT19937", "uniform_int", "fill_raw", "reference_fill",
           "reference_permutation", "reference_shuffle", "default_gen",
           "reset"]

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


class MT19937:
    """The standard 32-bit Mersenne Twister, seeded like ``std::mt19937``
    (single-value seeding = Knuth's init_genrand, multiplier 1812433253)."""

    def __init__(self, seed: int = 1):
        mt = [seed & _M32] + [0] * 623
        for i in range(1, 624):
            prev = mt[i - 1]
            mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & _M32
        self.mt = mt
        self.idx = 624

    def _twist(self):
        mt = self.mt
        for i in range(624):
            y = (mt[i] & 0x80000000) | (mt[(i + 1) % 624] & 0x7FFFFFFF)
            v = mt[(i + 397) % 624] ^ (y >> 1)
            if y & 1:
                v ^= 0x9908B0DF
            mt[i] = v
        self.idx = 0

    def __call__(self) -> int:
        """One tempered 32-bit draw (== ``gen()`` in the reference)."""
        if self.idx >= 624:
            self._twist()
        y = self.mt[self.idx]
        self.idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y


_URNGRANGE = _M32  # mt19937: max - min = 2^32 - 1


def uniform_int(gen: MT19937, a: int, b: int) -> int:
    """libstdc++ ``uniform_int_distribution::operator()`` over [a, b].

    ``a``/``b`` are the *uctype* (uint64) images of the C++ bounds — pass
    negative C++ values already wrapped mod 2^64.  Returns the uint64
    result (``__ret + a`` mod 2^64); the caller reinterprets per the
    distribution's value type.
    """
    urange = (b - a) & _M64
    if urange < _URNGRANGE:
        # Lemire downscaling (libstdc++ >= 11 `_S_nd`, "Fast Random Integer
        # Generation in an Interval"): product = g() * (urange+1) in 64 bits,
        # reject while low half < threshold, result = product >> 32
        uerange = urange + 1
        product = gen() * uerange
        low = product & 0xFFFFFFFF
        if low < uerange:
            threshold = (1 << 32) % uerange
            while low < threshold:
                product = gen() * uerange
                low = product & 0xFFFFFFFF
        ret = product >> 32
    elif urange > _URNGRANGE:
        uerngrange = _URNGRANGE + 1
        while True:
            tmp = (uerngrange * uniform_int(gen, 0, urange // uerngrange)) \
                & _M64
            ret = (tmp + gen()) & _M64
            if ret <= urange and ret >= tmp:
                break
    else:
        ret = gen()
    return (ret + a) & _M64


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def fill_raw(gen: MT19937, storage_bits: int) -> int:
    """One reference ``ArbiInt<storage_bits>::fill()`` draw.

    * N <= 64 (QuBLAS.h:526-536): ``uniform_int_distribution<data_t>
      (minimum, maximum)`` with minimum = -2^(N-1), maximum = 2^(N-1)-1.
    * N > 64 (QuBLAS.h:799-820): full-range uint64 per complete limb
      (low limbs first) plus, when ``N % 64 != 0``, the wrapped-bound
      partial-word distribution for the top limb.
    """
    n = storage_bits
    if n <= 64:
        # the distribution guarantees a value in [minimum, maximum], so the
        # data_t store is lossless; reinterpret the uctype result as signed
        a = (-(1 << (n - 1))) & _M64
        b = (1 << (n - 1)) - 1
        return _signed(uniform_int(gen, a, b), 64)
    words = (n + 63) // 64
    limbs = []
    if n % 64 == 0:
        for _ in range(words):
            limbs.append(uniform_int(gen, 0, _M64))
    else:
        for _ in range(words - 1):
            limbs.append(uniform_int(gen, 0, _M64))
        k = n % 64
        a = (-(1 << (k - 1))) & _M64
        b = (1 << (k - 1)) - 1
        limbs.append(uniform_int(gen, a, b))
    v = 0
    for i, w in enumerate(limbs):
        v |= w << (64 * i)
    return _signed(v, n)


_default = MT19937(1)


def default_gen() -> MT19937:
    """The global generator (reference ``gen``, seeded 1 at startup)."""
    return _default


def reset(seed: int = 1) -> MT19937:
    """Re-seed the global stream (== restarting the reference program)."""
    global _default
    _default = MT19937(seed)
    return _default


def reference_fill(shape, fmt: QFormat, gen: MT19937 | None = None,
                   device="cuda"):
    """QTensor on ``device`` filled exactly like the reference's tensor
    ``fill()``: elements drawn in flat (row-major) order from the shared
    generator (QuBLAS.h:2837-2845).  Formats beyond 992 bits take host
    storage, as ``from_raw`` gives them."""
    from .qtensor import from_raw

    g = gen if gen is not None else _default
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
    n = 1
    for s in shape:
        n *= int(s)
    raws = [fill_raw(g, fmt.storage_bits) for _ in range(n)]
    return from_raw(np.array(raws, dtype=object).reshape(shape), fmt, device)


def _uniform_below(gen: MT19937, bound: int) -> int:
    """uniform_int over [0, bound-1] (uctype arithmetic)."""
    return uniform_int(gen, 0, bound - 1)


def reference_permutation(n: int, gen: MT19937 | None = None) -> list:
    """The order in which ``std::shuffle(data.begin(), data.end(), gen)``
    leaves ``n`` elements: element ``i`` of the result is the one at
    ``perm[i]`` before.  libstdc++'s algorithm (for n² <= 2^32-1): one
    pre-swap with dist{0,1} when n is even, then two swap positions per
    draw via ``__gen_two_uniform_ints`` (x = uniform(0, s(s+1)-1);
    positions x/(s+1), x%(s+1)) — /usr/include/c++/12/bits/stl_algo.h:
    3696-3759."""
    g = gen if gen is not None else _default
    perm = list(range(n))
    if n > 1:
        if n * n > _M32:
            # libstdc++ leaves the two-swap path beyond this point; a
            # replica would give another stream
            raise ValueError(
                "reference shuffle replica covers n^2 < 2^32 "
                f"(n={n}); use numpy shuffling for larger tensors")
        i = 1
        if n % 2 == 0:
            j = _uniform_below(g, 2)
            perm[i], perm[j] = perm[j], perm[i]
            i += 1
        while i < n:
            s = i + 1
            x = _uniform_below(g, s * (s + 1))
            p0, p1 = x // (s + 1), x % (s + 1)
            perm[i], perm[p0] = perm[p0], perm[i]
            i += 1
            perm[i], perm[p1] = perm[p1], perm[i]
            i += 1
    return perm


def reference_shuffle(t, gen: MT19937 | None = None, device=None):
    """Shuffle a QTensor exactly like the reference's tensor ``shuffle()``
    (QuBLAS.h:2846-2850): :func:`reference_permutation` drawn on the host,
    applied as an index on the tensor's device (or moved to ``device``)."""
    out = t.take_flat(reference_permutation(t.size, gen))
    return out if device is None else out.to(device)
