"""QTensor on torch: a raw-integer tensor plus its fixed-point format.

Port of ``qublas_tpu.qtensor`` for **lane, pair and limb storage**: formats
of at most 32 storage bits in int8/int16/int32 tensors
(:func:`~qublas_tpu_torch.ops.widths.torch_dtype_for`), formats of 33..64
bits in one int64 tensor (the JAX package's (hi, lo) ``PairArray``;
:func:`~qublas_tpu_torch.ops.widths.storage_dtype`), and formats of 65..992
bits as a :class:`~qublas_tpu_torch.ops.limbint.LimbArray` of
``limb_count(fmt)`` stacked 32-bit limbs (held in int64).  Host storage,
the object arrays that hold formats beyond 992 bits and ``fill(int)`` wart
raws beyond the storage word, is ROADMAP A4b and raises
``NotImplementedError`` here.

Constructors place their tensor on ``device``, the card unless the caller
names another.  The operators ``* + - / -x abs(x)`` are the elementwise ops
of :mod:`~qublas_tpu_torch.ops.elementwise`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import hostint
from .ops.limbint import LimbArray, limbs_from_ints
from .ops.widths import LANE_DTYPES, limb_count, storage_dtype, storage_kind
from .qformat import QFormat

__all__ = ["QTensor", "from_raw", "from_float", "from_double", "scalar",
           "zeros", "random_fill"]


def host_storage_error(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs host object storage, not yet ported (ROADMAP A4b)")


def _device_storage(fmt: QFormat) -> str:
    """The format's storage kind, "lane", "pair" or "limb"; raises for host
    storage (formats beyond 992 bits)."""
    kind = storage_kind(fmt)
    if kind is None:
        raise host_storage_error(f"{fmt}: {fmt.storage_bits}-bit storage")
    return kind


class QTensor:
    """Raw integer tensor + fixed-point format: int8/int16/int32 lanes,
    int64 for pair storage, a LimbArray for limb storage."""

    __slots__ = ("data", "fmt")

    def __init__(self, data, fmt: QFormat):
        kind = _device_storage(fmt)
        if kind == "limb":
            if not isinstance(data, LimbArray) \
                    or data.nlimbs != limb_count(fmt):
                raise TypeError(f"QTensor data of limb storage must be a "
                                f"LimbArray of {limb_count(fmt)} limbs, got "
                                f"{data!r}")
            self.data = data
            self.fmt = fmt
            return
        if isinstance(data, LimbArray):
            raise TypeError(f"{fmt} has {kind} storage, not limbs")
        dtypes = (torch.int64,) if kind == "pair" else LANE_DTYPES
        if data.dtype not in dtypes:
            raise TypeError(f"QTensor data of {kind} storage must be "
                            f"{'/'.join(str(d)[6:] for d in dtypes)}, got "
                            f"{data.dtype}")
        self.data = data
        self.fmt = fmt

    @property
    def is_pair(self) -> bool:
        """True for pair storage (33..64-bit formats) in one int64 tensor."""
        return not self.is_limb and self.data.dtype == torch.int64

    @property
    def is_limb(self) -> bool:
        """True for limb storage (65..992-bit formats): a LimbArray."""
        return isinstance(self.data, LimbArray)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def size(self) -> int:
        return self.data.numel()

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.fmt)

    def raw(self) -> np.ndarray:
        """Raw storage integers as a NumPy array: an object array of Python
        ints for limb storage."""
        if self.is_limb:
            return self.data.to_numpy_ints()
        return self.data.cpu().numpy()

    def to_double(self) -> np.ndarray:
        """Per-element double value = raw / 2^frac_bits (QuBLAS.h:2413-2416)."""
        return self.raw().astype(np.float64) * (2.0 ** -self.fmt.frac_bits)

    def astype(self, fmt: QFormat) -> "QTensor":
        """Cross-format conversion: requantize with the destination's modes
        (reference converting copy, QuBLAS.h:2758-2830)."""
        from .ops.elementwise import qcast

        return qcast(self, fmt)

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.data[idx], self.fmt)

    def __repr__(self):
        return (f"QTensor(shape={self.shape}, fmt={self.fmt}, "
                f"device={self.device})")

    # operators: the elementwise ops (QuBLAS.h expression templates)
    def _ew(self, name, other):
        from .complex import QComplexTensor

        if isinstance(other, QComplexTensor):
            # real op complex: QComplexTensor's reflected operators take it
            # (rc_mul/rc_add/rc_sub, QuBLAS.h:3600-3663)
            return NotImplemented
        from .ops import elementwise

        return getattr(elementwise, name)(self, other)

    def __mul__(self, other):
        return self._ew("qmul", other)

    def __add__(self, other):
        return self._ew("qadd", other)

    def __sub__(self, other):
        return self._ew("qsub", other)

    def __truediv__(self, other):
        return self._ew("qdiv", other)

    def __neg__(self):
        from .ops.elementwise import qneg

        return qneg(self)

    def __abs__(self):
        from .ops.elementwise import qabs

        return qabs(self)


def from_raw(values: Any, fmt: QFormat, device="cuda") -> QTensor:
    """Build a QTensor from raw storage integers (an integer array, or
    Python ints of any size) on ``device``.

    Like ``qublas_tpu.qtensor.from_raw`` (and the reference's ``fill(int)``)
    the raws are stored as given, not masked: a lane format takes the
    smallest of int8/int16/int32, no narrower than the format's own, that
    holds every value; a pair format takes int64; a limb format its
    ``limb_count`` limbs.  Raws beyond the int32 lane, beyond int64 for a
    pair format or beyond the limb word need host object storage (ROADMAP
    A4b) and raise.
    """
    kind = _device_storage(fmt)
    arr = np.asarray(values)
    if arr.dtype == object:
        flat = [int(v) for v in arr.reshape(-1)]
        vmin, vmax = (min(flat), max(flat)) if flat else (0, 0)
    elif np.issubdtype(arr.dtype, np.integer):
        vmin = int(arr.min()) if arr.size else 0
        vmax = int(arr.max()) if arr.size else 0
    else:
        raise TypeError(f"from_raw takes integer raws, got {arr.dtype}")
    if kind == "limb":
        K = limb_count(fmt)
        word = 1 << (32 * K - 1)
        if not -word <= vmin <= vmax < word:
            raise host_storage_error(
                f"raws [{vmin}, {vmax}] beyond the {32 * K}-bit limb word "
                "(the fill(int) wart)")
        return QTensor(LimbArray(limbs_from_ints(arr, K, device)), fmt)
    if kind == "pair":
        candidates = (np.int64,)
    else:
        floor = LANE_DTYPES.index(storage_dtype(fmt))
        candidates = (np.int8, np.int16, np.int32)[floor:]
    for np_dt in candidates:
        info = np.iinfo(np_dt)
        if info.min <= vmin and vmax <= info.max:
            data = torch.from_numpy(np.array(arr, dtype=np_dt, order="C"))
            return QTensor(data.to(device), fmt)
    raise host_storage_error(
        f"raws [{vmin}, {vmax}] beyond the {np.dtype(candidates[-1]).name} "
        "word (the fill(int) wart)")


def from_float(values: Any, fmt: QFormat, device="cuda") -> QTensor:
    """Exact double -> fixed conversion, element by element on the host
    (``hostint.double_to_raw``: the reference's 2400-bit-exact constructor,
    QuBLAS.h:2387-2393), placed on ``device``."""
    _device_storage(fmt)
    arr = np.asarray(values, dtype=np.float64)
    flat = [hostint.double_to_raw(float(v), fmt) for v in arr.reshape(-1)]
    return from_raw(np.array(flat, dtype=object).reshape(arr.shape), fmt,
                    device)


from_double = from_float


def scalar(value: float, fmt: QFormat, device="cuda") -> QTensor:
    return from_float(np.float64(value), fmt, device)


def zeros(shape, fmt: QFormat, device="cuda") -> QTensor:
    if _device_storage(fmt) == "limb":
        return QTensor(LimbArray(torch.zeros(
            (limb_count(fmt),) + tuple(shape), dtype=torch.int64,
            device=device)), fmt)
    return QTensor(torch.zeros(shape, dtype=storage_dtype(fmt),
                               device=device), fmt)


def random_fill(shape, fmt: QFormat, seed: int = 1,
                device="cuda") -> QTensor:
    """Deterministic uniform raw fill over the storage range from numpy's
    ``RandomState(seed)``: the same raws as ``qublas_tpu.qtensor.
    random_fill`` (capability parity with the reference's ``fill()``,
    QuBLAS.h:526-536, not its mt19937 stream): formats of 64 storage bits
    or more compose each raw from ``ceil(storage_bits / 32) + 1`` 32-bit
    draws, as the JAX package does."""
    _device_storage(fmt)
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape)) if shape else 1
    if fmt.storage_bits <= 63:
        vals = rng.randint(fmt.raw_min, fmt.raw_max + 1, size=n,
                           dtype=np.int64)
    else:
        draws = -(-fmt.storage_bits // 32) + 1
        span = fmt.raw_max - fmt.raw_min + 1
        vals = []
        for _ in range(n):
            v = 0
            for _w in range(draws):
                v = (v << 32) | int(rng.randint(0, 1 << 32, dtype=np.int64))
            vals.append(fmt.raw_min + v % span)
        vals = np.array(vals, dtype=object)
    return from_raw(vals.reshape(shape), fmt, device)
