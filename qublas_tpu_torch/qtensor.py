"""QTensor on torch: a raw-integer tensor plus its fixed-point format.

Port of ``qublas_tpu.qtensor`` for every storage kind of the JAX package:

* **lane**: formats of at most 32 storage bits in int8/int16/int32 tensors
  (:func:`~qublas_tpu_torch.ops.widths.torch_dtype_for`);
* **pair**: formats of 33..64 bits in one int64 tensor (the JAX package's
  (hi, lo) ``PairArray``; :func:`~qublas_tpu_torch.ops.widths.storage_dtype`);
* **limb**: formats of 65..992 bits as a
  :class:`~qublas_tpu_torch.ops.limbint.LimbArray` of ``limb_count(fmt)``
  stacked 32-bit limbs (held in int64);
* **host** (``is_host``): a numpy object array of Python ints, for formats
  beyond 992 bits and for ``fill(int)`` wart raws beyond the storage word
  of a lane, pair or limb format.  Host raws never live on the card: ops
  on them run the exact host model (the native engine of :mod:`.native`
  where its envelope allows, else :mod:`.hostops`).  A host tensor keeps
  the device it was built for (the card unless the caller names another);
  a host op whose result fits device storage places it on the device of
  the first operand with device storage, else on the first host operand's
  own device (:func:`result_device`).

Constructors place their tensor on ``device``, the card unless the caller
names another.  The operators ``* + - / -x abs(x)`` are the elementwise ops
of :mod:`~qublas_tpu_torch.ops.elementwise`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import hostint
from .ops.limbint import LimbArray, limbs_from_ints
from .ops.widths import LANE_DTYPES, limb_count, storage_dtype, storage_kind
from .qformat import QFormat

__all__ = ["QTensor", "from_raw", "from_float", "from_double", "scalar",
           "zeros", "random_fill", "result_device"]


def result_device(*ts) -> torch.device:
    """Where a host op's result that fits device storage goes: the device
    of the first operand with device storage, else the device of the first
    operand (a host tensor's own)."""
    for t in ts:
        if not t.is_host:
            return t.device
    return ts[0].device


class QTensor:
    """Raw integer tensor + fixed-point format: int8/int16/int32 lanes,
    int64 for pair storage, a LimbArray for limb storage, or a numpy object
    array of Python ints for host storage.  ``device`` matters for host
    storage only: where its ops' device results go (the card by default);
    device storage is on its tensor's own device."""

    __slots__ = ("data", "fmt", "_home")

    def __init__(self, data, fmt: QFormat, device=None):
        kind = storage_kind(fmt)
        self._home = None
        if isinstance(data, np.ndarray):
            if data.dtype != object:
                raise TypeError(f"host storage is an object array of Python "
                                f"ints, got {data.dtype}")
            self.data = data
            self.fmt = fmt
            self._home = torch.device("cuda" if device is None else device)
            return
        if kind is None:
            raise TypeError(f"{fmt}: {fmt.storage_bits}-bit storage is host "
                            f"storage, an object array of Python ints")
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
    def is_host(self) -> bool:
        """True for host storage: a numpy object array of Python ints
        (formats beyond 992 bits, or wart raws beyond the storage word)."""
        return self._home is not None

    @property
    def is_pair(self) -> bool:
        """True for pair storage (33..64-bit formats) in one int64 tensor."""
        return not self.is_limb and not self.is_host \
            and self.data.dtype == torch.int64

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
        return self.data.size if self.is_host else self.data.numel()

    @property
    def device(self) -> torch.device:
        """The tensor's device; for host storage, the device its ops'
        device results go to."""
        return self._home if self.is_host else self.data.device

    def to(self, device) -> "QTensor":
        """The tensor on ``device``; host raws stay on the host, with
        ``device`` as their results' device."""
        if self.is_host:
            return QTensor(self.data, self.fmt, device)
        return QTensor(self.data.to(device), self.fmt)

    def raw(self) -> np.ndarray:
        """Raw storage integers as a NumPy array: an object array of Python
        ints for limb and host storage."""
        if self.is_host:
            return self.data
        if self.is_limb:
            return self.data.to_numpy_ints()
        return self.data.cpu().numpy()

    def raw_list(self):
        return [int(v) for v in self.raw().reshape(-1)]

    def to_double(self) -> np.ndarray:
        """Per-element double value = raw / 2^frac_bits (QuBLAS.h:2413-2416);
        host raws convert exactly, one at a time."""
        if self.is_host:
            flat = [hostint.raw_to_double(int(v), self.fmt)
                    for v in self.data.reshape(-1)]
            return np.array(flat, dtype=np.float64).reshape(self.shape)
        return self.raw().astype(np.float64) * (2.0 ** -self.fmt.frac_bits)

    def to_bits(self, tensor_order=None, elem_order=None) -> str:
        from . import bitstream

        return bitstream.to_bits(self, tensor_order, elem_order)

    def display(self, name: str = "") -> str:
        """Print and return the reference display()'s content
        (QuBLAS.h:2418-2431, 2898-2909): the format, then the values."""
        lines = [f"{name} :"] if name else []
        f = self.fmt
        lines.append(f"intBits: {f.int_bits} fracBits: {f.frac_bits} "
                     f"isSigned: {int(f.signed)}")
        lines.append(str(self.to_double()))
        out = "\n".join(lines)
        print(out)
        return out

    def to_matlab(self, filename: str):
        """Text export of Qu_s::toMatlab (QuBLAS.h:2980-3036):
        whitespace-separated doubles, one matrix row per line."""
        vals = self.to_double()
        rows = vals.reshape(-1, vals.shape[-1]) if vals.ndim > 1 \
            else vals.reshape(1, -1)
        with open(filename, "w") as fh:
            for row in rows:
                fh.write(" ".join(repr(float(v)) for v in row) + "\n")

    def astype(self, fmt: QFormat) -> "QTensor":
        """Cross-format conversion: requantize with the destination's modes
        (reference converting copy, QuBLAS.h:2758-2830)."""
        from .ops.elementwise import qcast

        return qcast(self, fmt)

    def __getitem__(self, idx) -> "QTensor":
        if self.is_host:
            # a single element of an object array is a Python int
            return QTensor(np.asarray(self.data[idx], dtype=object),
                           self.fmt, self._home)
        return QTensor(self.data[idx], self.fmt)

    def shuffle(self, seed: int = 1) -> "QTensor":
        """Random permutation of the flattened elements (the reference
        tensor's ``shuffle()``, QuBLAS.h:2843-2850) from numpy's
        ``RandomState(seed).permutation``, as the JAX package draws it,
        applied as an index on the tensor's device.  For the reference's
        exact ``std::shuffle(gen)`` use :func:`~qublas_tpu_torch.refrand.
        reference_shuffle`."""
        return self.take_flat(np.random.RandomState(seed).permutation(
            self.size))

    def take_flat(self, perm) -> "QTensor":
        """The tensor whose flat element i is this one's flat element
        ``perm[i]`` (an index array of ``size`` entries), same shape,
        indexed on the tensor's own device."""
        if self.is_host:
            flat = self.data.reshape(-1)[np.asarray(perm, dtype=np.int64)]
            return QTensor(flat.reshape(self.shape), self.fmt, self._home)
        idx = torch.as_tensor(np.asarray(perm, dtype=np.int64),
                              device=self.device)
        if self.is_limb:
            limbs = self.data.limbs
            flat = limbs.reshape(limbs.shape[0], -1)[:, idx]
            return QTensor(LimbArray(flat.reshape(limbs.shape)), self.fmt)
        return QTensor(self.data.reshape(-1)[idx].reshape(self.shape),
                       self.fmt)

    def __repr__(self):
        host = ", host" if self.is_host else ""
        return (f"QTensor(shape={self.shape}, fmt={self.fmt}, "
                f"device={self.device}{host})")

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


# A pytree node, as the JAX package's QTensor is: the storage is the child
# (a LimbArray is a node of its own), the format and a host tensor's device
# are the context.  Host storage is an object array, not a tensor leaf, so
# ``torch.func.vmap`` and ``torch.compile`` refuse it, as ``jax.jit``
# refuses the JAX package's.
def _qtensor_unflatten(children, ctx) -> QTensor:
    # no checks: a leaf may be a placeholder (``vmap``'s in_dims)
    out = object.__new__(QTensor)
    out.data = children[0]
    out.fmt, out._home = ctx
    return out


pytree.register_pytree_node(
    QTensor,
    lambda t: ([t.data], (t.fmt, t._home)),
    _qtensor_unflatten,
    serialized_type_name="qublas_tpu_torch.qtensor.QTensor")


def from_raw(values: Any, fmt: QFormat, device="cuda",
             validate: bool = False) -> QTensor:
    """Build a QTensor from raw storage integers (an integer array, or
    Python ints of any size) on ``device``.

    Like ``qublas_tpu.qtensor.from_raw`` (and the reference's ``fill(int)``)
    the raws are stored as given, not masked: a lane format takes the
    smallest of int8/int16/int32, no narrower than the format's own, that
    holds every value; a pair format takes int64; a limb format its
    ``limb_count`` limbs.  Formats beyond 992 bits, and raws beyond the
    int32 lane, beyond int64 for a pair format or beyond the limb word,
    take host storage (an object array of Python ints, whose ops' device
    results go to ``device``).  ``validate=True`` raises ``ValueError``
    for raws outside the format's range instead.
    """
    kind = storage_kind(fmt)
    arr = np.asarray(values)
    if arr.dtype == object:
        if kind is None and not validate:
            # host storage: nothing to choose, so no min/max pass
            return QTensor(arr, fmt, device)
        flat = [int(v) for v in arr.reshape(-1)]
        vmin, vmax = (min(flat), max(flat)) if flat else (0, 0)
    elif np.issubdtype(arr.dtype, np.integer):
        vmin = int(arr.min()) if arr.size else 0
        vmax = int(arr.max()) if arr.size else 0
    else:
        raise TypeError(f"from_raw takes integer raws, got {arr.dtype}")
    if validate and arr.size and (vmin < fmt.raw_min or vmax > fmt.raw_max):
        raise ValueError(f"raw values [{vmin},{vmax}] exceed storage of {fmt}")
    if kind is None:
        return QTensor(_objects(arr), fmt, device)
    if kind == "limb":
        K = limb_count(fmt)
        word = 1 << (32 * K - 1)
        if not -word <= vmin <= vmax < word:
            # the fill(int) wart beyond the limb word
            return QTensor(_objects(arr), fmt, device)
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
    # the fill(int) wart beyond the storage word
    return QTensor(_objects(arr), fmt, device)


def _objects(arr: np.ndarray) -> np.ndarray:
    """``arr`` as an object array (numpy ints become Python ints)."""
    if arr.dtype == object:
        return arr
    out = np.empty(arr.shape, dtype=object)
    out.reshape(-1)[:] = arr.reshape(-1).tolist()
    return out


def from_float(values: Any, fmt: QFormat, device="cuda") -> QTensor:
    """Exact double -> fixed conversion (the reference's 2400-bit-exact
    constructor, QuBLAS.h:2387-2393), placed on ``device``: the native
    engine's ``double_to_raw`` for formats up to 64 storage bits, as the
    JAX package does, else ``hostint.double_to_raw`` element by element."""
    arr = np.asarray(values, dtype=np.float64)
    if fmt.storage_bits <= 64:
        from . import native

        raws = native.double_to_raw(arr, fmt)
        if raws is not None:
            return from_raw(raws, fmt, device)
    flat = [hostint.double_to_raw(float(v), fmt) for v in arr.reshape(-1)]
    return from_raw(np.array(flat, dtype=object).reshape(arr.shape), fmt,
                    device)


from_double = from_float


def scalar(value: float, fmt: QFormat, device="cuda") -> QTensor:
    return from_float(np.float64(value), fmt, device)


def zeros(shape, fmt: QFormat, device="cuda") -> QTensor:
    kind = storage_kind(fmt)
    if kind is None:
        return QTensor(np.zeros(shape, dtype=object), fmt, device)
    if kind == "limb":
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
