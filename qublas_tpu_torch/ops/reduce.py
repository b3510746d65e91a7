"""Tree reduction with per-layer requantization (Qreduce) on torch.

Port of ``qublas_tpu/ops/reduce.py`` (reference ``Reducer``,
QuBLAS.h:4899-5018).  Semantics:

* per layer, elements (2i, 2i+1) combine by ``Qadd`` into the layer's format
  ``TypeAt<min(layer, len-1)>``; with no formats each layer keeps the
  element format (default AddMerger inference);
* an odd tail element is copied into the next layer: a converting
  assignment (``qcast``), which leaves the raws unchanged when the formats
  are equal;
* ``axis=None`` reduces the row-major flattening; an integer ``axis``
  reduces that axis only.

Dispatch, per configuration and before any data is touched:

1. n = 1 returns the input as it is.
2. A configuration that :func:`_plan_reduce_lanes` proves on int32 lanes
   goes to :func:`qreduce_kernel`: kernel K3 (``csrc/qreduce.cu``) for a
   CUDA tensor, its plain version :func:`qreduce_plain` for a CPU tensor.
3. Any other runs the layered slice/add program of the elementwise ops, on
   int32 lanes or, where a layer needs them, on the int64 of pair storage
   or on stacked limbs (``i32``, ``pair`` and ``limb`` routes); a layer
   that needs the host resumes on the host golden model from that layer
   on, as the JAX package's path does for host layers.  K3 stays
   lane-only, as its JAX counterpart does.

A host input (``is_host``) reduces on the host golden model.  Results of
the host model take device storage where their format and raws fit one,
else host storage.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from .. import _build, hostops
from ..qformat import OverflowMode, QFormat, RoundMode, add_merge
from ..qtensor import QTensor, from_raw
from .limbint import LimbArray
from .wideint import requantize_i32
from .widths import (
    LANE_DTYPES,
    Interval,
    fmt_interval,
    requant_out_interval,
    route_addsub,
    route_requant,
    storage_kind,
    torch_dtype_for,
)

__all__ = ["qreduce", "qreduce_args", "layer_format", "qreduce_kernel",
           "qreduce_plain", "ReducePlan", "K3_MODES", "k3_modes",
           "k3_lanes", "k3_route", "reduce_format"]


def layer_format(layer_formats, layer: int):
    """Per-layer output format: ``TypeAt<min(layer, len-1)>``
    (QuBLAS.h:4913); None when no layer formats are given."""
    if not layer_formats:
        return None
    return layer_formats[min(layer, len(layer_formats) - 1)]


def _normalize(layer_formats):
    if layer_formats is None:
        return ()
    if isinstance(layer_formats, QFormat):
        return (layer_formats,)
    return tuple(layer_formats)


def qreduce_args(values, layer_formats=()) -> QTensor:
    """Variadic-entry tree reduction over scalar QTensors (reference
    ``Qreduce(q1, q2, ...)``, QuBLAS.h:4924-4957): for odd counts the
    leftover element is added to the *final* result with the current
    layer's format (QuBLAS.h:4943-4949).  An init-time convenience,
    evaluated on the host golden model; the result lies on the first
    value's device."""
    pairs = []
    for v in values:
        if v.size != 1:
            raise ValueError("qreduce_args takes scalar QTensors")
        pairs.append((int(v.raw().reshape(())), v.fmt))
    raw, fmt = hostops.qreduce_args(pairs, _normalize(layer_formats))
    return from_raw(np.array(raw, dtype=object), fmt, values[0].device)


# ---------------------------------------------------------------------------
# The lane proof (copy of qublas_tpu/ops/reduce.py:148-189)
# ---------------------------------------------------------------------------

def _plan_reduce_lanes(fmt: QFormat, layer_formats, n: int):
    """Prove the whole tree's adds, requantizes and odd-tail converting
    assignments fit int32 lanes (exact interval walk, seeded with the input
    format's storage interval).  Returns the per-layer ``(cur_fmt,
    merge_fmt, m)`` schedule and the final format, or None."""
    if storage_kind(fmt) != "lane":
        return None
    iv = fmt_interval(fmt)
    cur = fmt
    sched = []
    m = n
    layer = 0
    while m > 1:
        lf = layer_format(layer_formats, layer)
        if lf is None:
            lf = add_merge(cur, cur)
        s = iv + iv
        if not s.fits32:
            return None
        if route_requant(s, cur.frac_bits, lf) != "i32":
            return None
        pair_iv, _ = requant_out_interval(s, cur.frac_bits, lf)
        lo, hi = pair_iv.lo, pair_iv.hi
        if m % 2:
            if route_requant(iv, cur.frac_bits, lf) != "i32":
                return None
            tail_iv, _ = requant_out_interval(iv, cur.frac_bits, lf)
            lo, hi = min(lo, tail_iv.lo), max(hi, tail_iv.hi)
        iv = Interval(lo, hi)
        sched.append((cur, lf, m))
        cur = lf
        m = (m + 1) // 2
        layer += 1
    if torch_dtype_for(cur) is None:
        return None
    return sched, cur


# ---------------------------------------------------------------------------
# K3 and its plain version
# ---------------------------------------------------------------------------

class ReducePlan:
    """A proven lane reduction of ``n`` elements: the layer schedule of
    :func:`_plan_reduce_lanes`, and the same tree as K3 runs it, a
    binary-carry slot stack over blocks of ``blk`` elements (or of a warp
    kernel's chunk, :func:`k3_route`) with the tree GEMM's level formats
    and drain.  Immutable once built."""

    def __init__(self, fmt: QFormat, layer_formats, n: int, sched,
                 final_fmt: QFormat):
        from .tree_gemm import _block_size, drain_ops, level_formats

        self.n = n
        self.sched = tuple(sched)
        self.final_fmt = final_fmt
        self.levels = max(n.bit_length(), 1)
        self.level_fmts, self.merge_fmts = level_formats(fmt, layer_formats,
                                                         n)
        self.blk = _block_size(n)
        # a tail convert between equal formats is qcast's no-op: drop it
        self.drain = tuple(
            (op, l) for op, l in drain_ops(n, self.levels)
            if not (op == "convert"
                    and self.level_fmts[l] == self.merge_fmts[l]))
        self.modes = k3_modes(self)
        # per layer of sched, 1 where an odd tail converts into the layer's
        # format and 0 where the formats are equal and it is copied: with
        # kernel_params, what the plain version reads (library.reduce_plan)
        self.tails = tuple(int(cur != lf) for cur, lf, _ in self.sched)
        self._params = None

    def kernel_params(self):
        """The plan as ``csrc/qreduce.cu:qk_qreduce``'s int32 parameters,
        built on the first call and shared by every launch after it."""
        from .tree_gemm import _OPS

        if self._params is None:
            p = [self.blk.bit_length() - 1, self.levels]
            for l in range(self.levels):
                p += _build.rq_args(self.level_fmts[l].frac_bits,
                                    self.merge_fmts[l])
            p.append(len(self.drain))
            for op, l in self.drain:
                p += [_OPS[op], l]
            self._params = tuple(p)
        return self._params


# The (round, overflow) pairs that K3 has compile-time instantiations for,
# each as (tree level 0's pair, the pair of every level above it), in
# csrc/qreduce.cuh's K3_MODES order after its run-time entry 0: BASELINE
# config 2's layers, and the layered canonical GEMM's Qu<8,8,TRN::TCPL,
# SAT::ZERO> reduced with no layer formats.
K3_MODES = (
    ((RoundMode.RND_CONV, OverflowMode.SAT_ZERO),
     (RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL)),
    ((RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO),
     (RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO)),
)


def k3_modes(plan: ReducePlan) -> int:
    """K3's instantiation for ``plan``: 1 + the index in :data:`K3_MODES`
    of the entry whose level-0 pair the layer-0 merge rounds and overflows
    with and whose upper pair every merge above it does (the drain's
    converts are those merges' requantizes), or 0 (modes read at run time)
    when no entry fits."""
    pairs = [(f.round_mode, f.overflow_mode) for f in plan.merge_fmts]
    for i, (first, upper) in enumerate(K3_MODES):
        if pairs[0] == first and all(p == upper for p in pairs[1:]):
            return i + 1
    return 0


K3_LANE_BYTES = 32   # leaves a lane of the warp kernel loads, at most
K3_LOAD_BYTES = 16   # in loads of at most 16 bytes, each aligned to its size


def k3_lanes(n: int, in_bytes: int, ptr: int) -> int:
    """Leaves S a lane folds in K3's warp kernel, for rows of ``n``
    ``in_bytes`` lanes starting at address ``ptr``: the largest power of
    two with 32 S dividing n (a chunk of 32 S leaves is then one node of
    the tree), S * in_bytes <= 32 (one load a lane, or two of 16 bytes)
    and ptr a multiple of the load's size (a base off 16 bytes, e.g.
    through a storage offset, takes a narrower load); 0 when 32 does not
    divide n."""
    if n % 32:
        return 0
    s = min((n & -n) // 32, K3_LANE_BYTES // in_bytes)
    while ptr % min(s * in_bytes, K3_LOAD_BYTES):
        s //= 2
    return s


def k3_route(x: torch.Tensor, axis: int, plan: ReducePlan):
    """The K3 kernel that reduces the contiguous tensor ``x`` along
    ``axis`` (``csrc/qreduce.cu``), and its S: ``("columns", 0)`` when
    elements follow the axis (a thread an output), else ``("warp", S)``
    (a warp a row, :func:`k3_lanes`) or, when 32 does not divide n,
    ``("thread", 0)`` (a thread a row)."""
    if math.prod(x.shape[axis + 1:]) > 1:
        return "columns", 0
    s = k3_lanes(plan.n, x.element_size(), x.data_ptr())
    return ("warp", s) if s else ("thread", 0)


def plan_reduce(fmt: QFormat, layer_formats, n: int):
    """The :class:`ReducePlan` of a lane-proven configuration with n >= 2,
    else None."""
    layer_formats = _normalize(layer_formats)
    planned = _plan_reduce_lanes(fmt, layer_formats, n) if n >= 2 else None
    if planned is None:
        return None
    return ReducePlan(fmt, layer_formats, n, *planned)


def qreduce_plain(x: torch.Tensor, axis: int, plan: ReducePlan):
    """Plain-torch K3: the layered slice/add loop of
    ``qublas_tpu/ops/reduce.py:125-145`` on int32 lanes, one requantize per
    layer pair and a ``qcast`` of each odd tail."""
    cur = torch.movedim(x, axis, 0)
    for cur_fmt, lf, m in plan.sched:
        v = cur.to(torch.int32)
        s = requantize_i32(v[0:m - 1:2] + v[1:m:2], cur_fmt.frac_bits, lf)
        if m % 2:
            tail = v[m - 1:m]
            if cur_fmt != lf:
                tail = requantize_i32(tail, cur_fmt.frac_bits, lf)
            s = torch.cat([s, tail])
        cur = s
    return cur[0].to(torch_dtype_for(plan.final_fmt))


def qreduce_kernel(x: torch.Tensor, axis: int, plan: ReducePlan):
    """Reduce the lane tensor ``x`` along ``axis`` under ``plan``, stored in
    ``torch_dtype_for(plan.final_fmt)``.

    One call of the custom op ``qublas::qreduce`` (:mod:`.library`): CPU
    tensors take the plain version; CUDA tensors launch K3, the kernel of
    :func:`k3_route` with the modes of :func:`k3_modes`.
    ``qreduce_kernel.launches`` counts kernel launches,
    ``qreduce_kernel.seen`` (``_build.record``) each launch's kernel, S,
    instantiation and lane bytes and its layers' modes.
    """
    if x.dtype not in LANE_DTYPES:
        raise TypeError(f"qreduce_kernel takes int8/int16/int32 lanes, got "
                        f"{x.dtype}")
    if not 0 <= axis < x.ndim or x.shape[axis] != plan.n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} is not the "
                         f"plan's n = {plan.n}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qreduce_kernel runs on CUDA or CPU, not "
                         f"{x.device}")
    return torch.ops.qublas.qreduce(
        x, axis, plan.kernel_params(), plan.tails, plan.modes,
        torch_dtype_for(plan.final_fmt).itemsize)


qreduce_kernel.launches = 0
qreduce_kernel.seen = Counter()


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def qreduce(x: QTensor, layer_formats=(), axis=None) -> QTensor:
    """Tree-reduce a QTensor with per-layer requantization.

    ``axis=None`` reduces the row-major flattening to a scalar (the
    reference entry point, QuBLAS.h:4992-5001); an integer ``axis`` reduces
    that axis only (the batched form the GEMM's dot products use).
    """
    layer_formats = _normalize(layer_formats)
    if axis is None:
        x = QTensor(x.data.reshape(-1), x.fmt, x.device)
        axis = 0
    axis = axis % max(x.ndim, 1)
    n = x.shape[axis]
    if n == 0:
        raise ValueError("qreduce of empty axis")
    if x.is_host:
        return _qreduce_host(QTensor(np.moveaxis(x.data, axis, 0), x.fmt,
                                     x.device), layer_formats, first_layer=0)
    if n == 1:
        return QTensor(x.data.select(axis, 0), x.fmt)
    plan = plan_reduce(x.fmt, layer_formats, n)
    if plan is not None:
        return QTensor(qreduce_kernel(x.data, axis, plan), plan.final_fmt)
    return _qreduce_layered(x, layer_formats, axis)


def reduce_format(fmt: QFormat, layer_formats, n: int):
    """The format of :func:`qreduce`'s result over ``n`` values of ``fmt``
    when every layer runs on a device route (K3, or the layered program's
    ``i32``, ``pair`` and ``limb`` routes); None when the tree takes the
    host route at some layer.  The dispatch of :func:`qreduce` on formats:
    nothing is computed."""
    layer_formats = _normalize(layer_formats)
    if storage_kind(fmt) is None:
        return None
    if n <= 1:
        return fmt
    plan = plan_reduce(fmt, layer_formats, n)
    if plan is not None:
        return plan.final_fmt
    cur, m, layer = fmt, n, 0
    while m > 1:
        lf = layer_format(layer_formats, layer)
        if not _layer_on_device(cur, lf, m):
            return None
        cur = add_merge(cur, cur, lf)
        m, layer = (m + 1) // 2, layer + 1
    return cur


def _layer_on_device(cur_fmt: QFormat, fmt, m: int) -> bool:
    """Layer ``Qadd`` of two ``cur_fmt`` values into ``fmt`` (and, for odd
    m, the tail's cast) stays on the device routes of the elementwise ops:
    int32 lanes, the int64 of the pair route or stacked limbs."""
    device = ("i32", "pair", "limb")
    out = add_merge(cur_fmt, cur_fmt, fmt)
    if route_addsub(cur_fmt, cur_fmt, out, False)[0] not in device:
        return False
    return m % 2 == 0 or out == cur_fmt or \
        route_requant(fmt_interval(cur_fmt), cur_fmt.frac_bits, out) \
        in device


def _qreduce_layered(x: QTensor, layer_formats, axis: int) -> QTensor:
    """The layered slice/add program of the elementwise ops (the JAX
    package's default path, ``qublas_tpu/ops/reduce.py:125-145``)."""
    from . import elementwise as ew

    if x.is_limb:
        cur = QTensor(x.data.movedim(axis, 0), x.fmt)
    else:
        cur = QTensor(torch.movedim(x.data, axis, 0), x.fmt)
    layer = 0
    while cur.shape[0] > 1:
        m = cur.shape[0]
        fmt = layer_format(layer_formats, layer)
        if not _layer_on_device(cur.fmt, fmt, m):
            return _qreduce_host(cur, layer_formats, first_layer=layer)
        s = ew.qadd(cur[0:m - 1:2], cur[1:m:2], to=fmt)
        if m % 2:
            tail = ew.qcast(cur[m - 1:m], s.fmt)
            s = QTensor(_concat(s.data, tail.data), s.fmt)
        cur = s
        layer += 1
    return QTensor(cur.data[0], cur.fmt)


def _concat(s, tail):
    """The layer's sums and its converted odd tail (of the same format)
    along the first axis.  An unchanged lane tail may hold raws in a wider
    lane: promote, as the JAX package's concatenate does."""
    if isinstance(s, LimbArray):
        return LimbArray(torch.cat([s.limbs, tail.limbs], dim=1))
    dt = torch.promote_types(s.dtype, tail.dtype)
    return torch.cat([s.to(dt), tail.to(dt)])


def _qreduce_host(x: QTensor, layer_formats, first_layer: int) -> QTensor:
    """Exact host path: per-lane golden-model reduction of ``x`` along its
    first axis, resuming the tree at layer ``first_layer`` (TypeAt indexes
    the original layer number, so consumed formats stay consumed)."""
    if first_layer and layer_formats:
        layer_formats = tuple(
            layer_format(layer_formats, first_layer + i)
            for i in range(max(len(layer_formats) - first_layer, 1)))
    arr = np.moveaxis(x.raw(), 0, -1)
    batch_shape = arr.shape[:-1]
    out_raws, out_fmt = [], None
    for lane in arr.reshape(-1, arr.shape[-1]):
        r, out_fmt = hostops.qreduce_list([(int(v), x.fmt) for v in lane],
                                          layer_formats)
        out_raws.append(r)
    return from_raw(np.array(out_raws, dtype=object).reshape(batch_shape),
                    out_fmt, x.device)
