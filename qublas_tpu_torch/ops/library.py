"""The Hopper kernels as ``torch.library`` custom ops (``qublas::*``).

One op for each C entry point of ``_build._SIGNATURES``, so that a kernel
launch is one node that ``torch.compile`` traces and a CUDA graph captures:

==========================  ==================================  ==========
op                          C entry point                       kernel
==========================  ==================================  ==========
``fused_gemm_s8``           ``qk_fused_gemm_s8``                K1
``fused_gemm_s32``          ``qk_fused_gemm_s32``               K1
``fused_gemm_s8_grouped``   ``qk_fused_gemm_s8_grouped``        K1, grouped
``tree_gemm``               ``qk_tree_gemm``                    K2
``tree_gemm_stream``        ``qk_tree_gemm_stream``             K2′
``tree_gemm_hybrid_mma``    ``qk_tree_gemm_hybrid_mma``         K2h
``qreduce``                 ``qk_qreduce``                      K3
``chain_probe``             ``qk_chain_probe``                  P1
``moe_combine``             ``qk_moe_combine``                  C1
``mul_requant``             ``qk_mul_requant``                  G1
``rms_norm``                ``qk_rms_norm``                     N1
==========================  ==================================  ==========

An op takes tensors, ints and lists of ints only: a requantize step as the
five ints of ``_build.rq_args``, a plan as the int32 parameters its kernel
reads (``tree_gemm._kernel_params``, ``_hybrid_params``,
``ReducePlan.kernel_params``), the instantiation and the output's lane
bytes as ints.  The public wrappers (``fused_int8_gemm``, ``int_dot``,
``tree_gemm``, ``tree_gemm_stream``, ``tree_gemm_hybrid``,
``qreduce_kernel``, ``chain_probe``) turn formats and plans into these
ints, which are static under ``torch.compile``, and call the op.

Each op has three parts:

* the CUDA implementation launches the kernel through ``ctypes``.  It alone
  reads ``data_ptr()``: the operand routes (``k1_route``, ``k2s_route``,
  ``k3_route``, ``k2h_route``) and the ``ctypes`` launch run on real
  tensors at run time, never on a traced one.  It adds one to the
  wrapper's ``launches`` and, inside ``utils.profiling.launch_record``,
  notes the launch in its ``seen`` (``_build.record``);
* the CPU implementation is the kernel's plain version, on the plan read
  back from the same ints (:func:`rq_format`, :func:`tree_plan`,
  :func:`hybrid_plan`, :func:`reduce_plan`);
* the fake implementation gives the output's shape and dtype.

The ops are declared with ``torch.library.Library`` (a schema, a kernel a
device, a fake), not with ``torch.library.custom_op``, whose Python
wrapper around every call (an autograd layer and an aliasing check) costs
about 50 µs of host time a launch: no op has a gradient (its tensors are
integers), and every output is a new tensor that aliases no input, which
``torch.library.opcheck`` checks in the tests.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from .. import _build
from ..qformat import OverflowMode, QFormat, RoundMode
from ..utils.profiling import recording_launches

__all__ = ["rq_format", "tree_plan", "hybrid_plan", "reduce_plan",
           "lane_dtype", "c_ints", "OPS", "IDENTITY_RQ"]

# lane dtype by its bytes: the ops' ``out_bytes`` argument
_LANE = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def lane_dtype(out_bytes: int) -> torch.dtype:
    """The int8/int16/int32 lane of ``out_bytes`` bytes."""
    return _LANE[out_bytes]


@functools.lru_cache(maxsize=1024)
def c_ints(params: Tuple[int, ...]):
    """``params`` (a tuple) as the C int array a kernel reads, built once a
    plan (the entry points copy it into their kernel's arguments before
    they return, so a captured launch keeps no pointer to it)."""
    return (ctypes.c_int * len(params))(*params)


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# ---------------------------------------------------------------------------
# Plans read back from their kernel parameters (the CPU implementations)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def rq_format(rq: Tuple[int, ...]) -> Tuple[int, QFormat]:
    """The requantize step ``rq`` (``_build.rq_args``: shift, round mode,
    overflow mode, width, signedness) as a ``(from_frac, fmt)`` pair that
    ``requantize_i32``/``requantize_i64``/``requantize_split_mul`` read as
    the same step: they read ``from_frac - fmt.frac_bits``, the storage
    width, the signedness and the two modes, and nothing else."""
    d, rnd, ovf, width, signed = rq
    return d, QFormat(width - 1, 0, bool(signed), RoundMode(rnd),
                      OverflowMode(ovf))


def _frac(d: int) -> QFormat:
    """A format whose fraction bits are ``d``: a merge's input format as
    ``_merge`` and ``_drain`` read it (its fraction bits only)."""
    return QFormat(max(-d, 0), d)


class _Reader:
    """Reads a kernel parameter list front to back."""

    def __init__(self, params: Sequence[int]):
        self.p, self.i = params, 0

    def ints(self, n: int):
        out = self.p[self.i:self.i + n]
        self.i += n
        return out

    def int(self) -> int:
        return self.ints(1)[0]

    def steps(self, levels: int):
        """``levels`` requantize steps: their input fractions and formats."""
        st = [rq_format(self.ints(5)) for _ in range(levels)]
        return tuple(_frac(d) for d, _ in st), tuple(f for _, f in st)

    def drain(self):
        n = self.int()
        return tuple((_DRAIN_OPS[op], l) for op, l in
                     (self.ints(2) for _ in range(n)))


_DRAIN_OPS = ("seed", "convert", "add")    # tree_gemm._OPS, inverted
_ROUTES = ("i32", "split", "pair")         # tree_gemm.ROUTES, inverted


@functools.lru_cache(maxsize=1024)
def tree_plan(params: Tuple[int, ...], k: int):
    """``(plan, out_fmt)`` read back from K2's, K2′'s or P1's parameters
    (``tree_gemm._kernel_params``, a tuple): a ``TreePlan`` whose steps
    requantize as the original's do, its formats those of
    :func:`rq_format`."""
    from .tree_gemm import TreePlan

    r = _Reader(params)
    route, _log_blk = r.ints(2)
    prod_frac, mul_fmt = rq_format(r.ints(5))
    levels = r.int()
    level_fmts, merge_fmts = r.steps(levels)
    drain = r.drain()
    final_frac, out_fmt = rq_format(r.ints(5))
    plan = TreePlan(k, _ROUTES[route], prod_frac, mul_fmt, levels,
                    level_fmts, merge_fmts, drain, _frac(final_frac))
    return plan, out_fmt


@functools.lru_cache(maxsize=1024)
def hybrid_plan(params: Tuple[int, ...]):
    """``(plan, out_fmt)`` read back from K2h's parameters
    (``tree_gemm._hybrid_params``, a tuple): a ``HybridPlan`` whose tail
    levels ``level..`` requantize as the original's do (the levels below
    it are never read)."""
    from .tree_gemm import HybridPlan

    r = _Reader(params)
    level, dl, levels = r.ints(3)
    level_fmts, merge_fmts = r.steps(levels)
    r.drain()
    final_frac, out_fmt = rq_format(r.ints(5))
    pad = (QFormat(),) * level
    plan = HybridPlan(1 << level, level, dl, pad + level_fmts,
                      pad + merge_fmts, _frac(final_frac))
    return plan, out_fmt


@dataclass(frozen=True)
class _ReduceSteps:
    """The part of a ``ReducePlan`` that ``qreduce_plain`` and ``k3_route``
    read: n, the layer schedule ``(cur_fmt, merge_fmt, m)`` and the final
    format, and the merges' formats, which ``_build.record`` reads."""

    n: int
    sched: Tuple[Tuple[QFormat, QFormat, int], ...]
    final_fmt: QFormat
    merge_fmts: Tuple[QFormat, ...]


@functools.lru_cache(maxsize=1024)
def reduce_plan(params: Tuple[int, ...], tails: Tuple[int, ...], n: int,
                out_bytes: int) -> _ReduceSteps:
    """K3's plan read back from its parameters
    (``ReducePlan.kernel_params``) and ``tails`` (``ReducePlan.tails``:
    per layer, 1 where its odd tail converts, 0 where the formats are equal
    and it is copied), both tuples: the layered schedule of
    ``qreduce_plain``, where a copied tail's ``cur_fmt`` is its
    ``merge_fmt``."""
    r = _Reader(params)
    r.int()
    levels = r.int()
    st = [rq_format(r.ints(5)) for _ in range(levels)]
    sched, m = [], n
    for l, convert in enumerate(tails):
        d, lf = st[l]
        # a converting tail's format has d fraction bits and a storage
        # width unlike lf's, so that qreduce_plain sees them differ
        cur = QFormat(lf.storage_bits + max(-d, 0), d) if convert else lf
        sched.append((cur, lf, m))
        m = (m + 1) // 2
    final = QFormat(8 * out_bytes - 1, 0)
    return _ReduceSteps(n, tuple(sched), final, tuple(f for _, f in st))


# ---------------------------------------------------------------------------
# The op declarations
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("qublas", "DEF")


def _declare(schema: str, cpu, cuda, fake):
    """Declare ``qublas::<schema>`` with its CPU, CUDA and fake
    implementations; its default overload."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"qublas::{name}", fake, lib=_LIB)
    return getattr(torch.ops.qublas, name).default


def _gemm_fake(a, b, *args):
    # the output's lane bytes are every GEMM op's last argument
    return a.new_empty((a.shape[0], b.shape[1]), dtype=lane_dtype(args[-1]))


def _gemm_out(a, b, out_bytes):
    """The [M, N] output of ``a`` @ ``b`` in the lane of ``out_bytes``."""
    return torch.empty((a.shape[0], b.shape[1]), dtype=lane_dtype(out_bytes),
                       device=a.device)


# ---------------------------------------------------------------------------
# K1: fused_gemm_s8 / fused_gemm_s32
# ---------------------------------------------------------------------------

# K1's identity epilogue (int_dot): requant.cuh returns y unchanged for
# d = 0 under WRP_TCPL at a signed width of 32
IDENTITY_RQ = (0, int(RoundMode.TRN_TCPL), int(OverflowMode.WRP_TCPL), 32, 1)


# entries of K1's table epilogue, at most (csrc/fused_gemm.cu: LUT_MAX)
LUT_MAX = 256


def _lut_mask(lut: torch.Tensor, device: torch.device) -> int:
    """The index mask of K1's table ``lut``: int32 entries, a power of two
    of them up to ``LUT_MAX``, contiguous, on ``device``."""
    n = lut.numel()
    if (lut.dtype != torch.int32 or lut.ndim != 1 or not 0 < n <= LUT_MAX
            or n & (n - 1) or not lut.is_contiguous()
            or lut.device != device):
        raise ValueError(f"K1's table takes 2^w <= {LUT_MAX} contiguous "
                         f"int32 entries on {device}, got {lut.dtype} "
                         f"{tuple(lut.shape)} on {lut.device}")
    return n - 1


def _k1_plain(a, b, rq, out_bytes, lut=None):
    """K1's plain version: ``rq`` the requantize step, none for
    ``int_dot``'s identity epilogue; ``lut`` a table of 2^w entries that
    maps each result's low w bits to the value stored."""
    from .fused_gemm import int_dot_plain

    return _k1_epilogue(int_dot_plain(a, b), rq, out_bytes, lut)


def _k1_epilogue(dot, rq, out_bytes, lut=None):
    """K1's epilogue in plain torch on the int32 dots ``dot``."""
    from .wideint import requantize_i32

    raw = dot
    if rq:
        d, fmt = rq_format(tuple(rq))
        raw = requantize_i32(dot, d, fmt)
    if lut is not None:
        raw = lut[(raw & _lut_mask(lut, dot.device)).long()]
    return raw.to(lane_dtype(out_bytes))


def _k1_fake(a, b, rq, out_bytes, lut=None):
    return _gemm_fake(a, b, out_bytes)


def _k1_record(instance: str, rq, lut: bool = False):
    from .fused_gemm import fused_int8_gemm

    fused_int8_gemm.launches += 1
    if lut:
        fused_int8_gemm.lut_launches += 1
    if not recording_launches():
        return
    if rq:
        _build.record(fused_int8_gemm,
                      ("gemm+lut/" if lut else "gemm/") + instance,
                      (rq_format(tuple(rq))[1],))
    else:
        _build.record(fused_int8_gemm, "int_dot/" + instance)


def _k1_s8(a, b, rq, out_bytes, lut=None):
    from .fused_gemm import k1_operand, k1_route

    out = _gemm_out(a, b, out_bytes)
    if out.numel() == 0:
        return out
    m, k = a.shape
    mask = 0 if lut is None else _lut_mask(lut, a.device)
    ra, rb = k1_route(a), k1_route(b.t())
    a8 = k1_operand(a, ra)
    bt = k1_operand(b.t(), rb)  # [N, K]
    err = _build.lib().qk_fused_gemm_s8(
        a.device.index, a8.data_ptr(), a8.stride(0), bt.data_ptr(),
        bt.stride(0), out.data_ptr(), m, out.shape[1], k, out_bytes,
        *(rq or IDENTITY_RQ), None if lut is None else lut.data_ptr(),
        mask, _stream(a))
    _build.check(err, "fused_int8_gemm")
    _k1_record(f"s8/{ra}/{rb}", rq, lut is not None)
    return out


def _k1_s32(a, b, rq, out_bytes):
    out = _gemm_out(a, b, out_bytes)
    if out.numel() == 0:
        return out
    m, k = a.shape
    a32 = a.to(torch.int32).contiguous()
    b32 = b.to(torch.int32).contiguous()
    err = _build.lib().qk_fused_gemm_s32(
        a.device.index, a32.data_ptr(), b32.data_ptr(), out.data_ptr(), m,
        out.shape[1], k, out_bytes, *(rq or IDENTITY_RQ), _stream(a))
    _build.check(err, "fused_int8_gemm")
    _k1_record("s32", rq)
    return out


# K1's tensor-core instantiation: a [M, K] @ b [K, N] of int8 lanes,
# requantized by rq (none: int_dot's identity epilogue), then looked up in
# lut where one is given (the table instantiation)
fused_gemm_s8 = _declare(
    "fused_gemm_s8(Tensor a, Tensor b, int[] rq, int out_bytes, "
    "Tensor? lut=None) -> Tensor", _k1_plain, _k1_s8, _k1_fake)
# K1's int32 instantiation, operands of any lane widened to int32
fused_gemm_s32 = _declare(
    "fused_gemm_s32(Tensor a, Tensor b, int[] rq, int out_bytes) -> Tensor",
    _k1_plain, _k1_s32, _gemm_fake)


def _grouped_plain(a, b, offsets, rq, out_bytes, lut=None):
    """K1's plain version a group: rows ``offsets[g]`` ..
    ``offsets[g + 1] - 1`` of ``a`` times ``b[g]``."""
    from .fused_gemm import int_dot_plain

    dots = [int_dot_plain(a[s:e], b[g])
            for g, (s, e) in enumerate(zip(offsets, offsets[1:])) if e > s]
    if not dots:
        return _grouped_fake(a, b, offsets, rq, out_bytes)
    return _k1_epilogue(torch.cat(dots), rq, out_bytes, lut)


def _grouped_fake(a, b, offsets, rq, out_bytes, lut=None):
    return a.new_empty((a.shape[0], b.shape[2]), dtype=lane_dtype(out_bytes))


def _k1_s8_grouped(a, b, offsets, rq, out_bytes, lut=None):
    from .fused_gemm import k1_operand, k1_route, k1_stack

    out = torch.empty((a.shape[0], b.shape[2]), dtype=lane_dtype(out_bytes),
                      device=a.device)
    if out.numel() == 0:
        return out
    m, k = a.shape
    mask = 0 if lut is None else _lut_mask(lut, a.device)
    ra = k1_route(a)
    a8 = k1_operand(a, ra)
    rb, bt = k1_stack(b)  # [G, N, K]
    launched = ctypes.c_int(0)
    err = _build.lib().qk_fused_gemm_s8_grouped(
        a.device.index, a8.data_ptr(), a8.stride(0), bt.data_ptr(),
        bt.stride(1), out.data_ptr(), c_ints(tuple(offsets)), b.shape[0], m,
        out.shape[1], k, out_bytes, *(rq or IDENTITY_RQ),
        None if lut is None else lut.data_ptr(), mask, _stream(a),
        ctypes.byref(launched))
    _build.check(err, "fused_int8_gemm_grouped")
    for _ in range(launched.value):
        _k1_record(f"s8_grouped/{ra}/{rb}", rq, lut is not None)
    return out


# K1 over the groups of a mixture of experts: rows offsets[g] ..
# offsets[g + 1] - 1 of a [M, K] times b[g] of b [G, K, N], int8 lanes, in
# one launch of the grouped instantiation (one a 256 groups)
fused_gemm_s8_grouped = _declare(
    "fused_gemm_s8_grouped(Tensor a, Tensor b, int[] offsets, int[] rq, "
    "int out_bytes, Tensor? lut=None) -> Tensor", _grouped_plain,
    _k1_s8_grouped, _grouped_fake)


# ---------------------------------------------------------------------------
# K2 and K2′
# ---------------------------------------------------------------------------

def _tree_record(wrapper, instance: str, params, k: int):
    from .tree_gemm import _step_fmts

    wrapper.launches += 1
    if recording_launches():
        _build.record(wrapper, instance, _step_fmts(*tree_plan(params, k)))


def _k2_plain(a, b, params, modes, out_bytes):
    from .tree_gemm import tree_gemm_plain

    plan, out_fmt = tree_plan(tuple(params), a.shape[1])
    return tree_gemm_plain(a, b, plan, out_fmt).to(lane_dtype(out_bytes))


def _k2(a, b, params, modes, out_bytes):
    from . import tree_gemm as TG

    out = _gemm_out(a, b, out_bytes)
    if out.numel() == 0:
        return out
    m, k = a.shape
    params = tuple(params)
    a32 = a.to(torch.int32).contiguous()
    b32 = b.to(torch.int32).contiguous()
    err = _build.lib().qk_tree_gemm(
        a.device.index, a32.data_ptr(), b32.data_ptr(), out.data_ptr(), m,
        out.shape[1], k, out_bytes, c_ints(params), modes, _stream(a))
    _build.check(err, "tree_gemm")
    # csrc/tree_gemm_tiled.cu's instantiations: an 8-level slot stack
    # below k = 4096, 32 levels from there
    top = 8 if (k >> TG.K2_LOG_BLK).bit_length() <= 8 else 32
    _tree_record(TG.tree_gemm, f"tiled_{top}_{modes}", params, k)
    return out


def _k2s_plain(a, b, params, plan, out_bytes):
    from .tree_gemm import tree_gemm_stream_plain

    tplan, out_fmt = tree_plan(tuple(params), a.shape[1])
    return tree_gemm_stream_plain(a, b, tplan, out_fmt).to(
        lane_dtype(out_bytes))


def _k2s(a, b, params, plan, out_bytes):
    from . import tree_gemm as TG

    out = _gemm_out(a, b, out_bytes)
    if out.numel() == 0:
        return out
    m, k = a.shape
    params = tuple(params)
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    ra, rb = TG.k2s_route(a32), TG.k2s_route(b32)
    a32, lda = TG.k2s_operand(a32, ra)
    b32, ldb = TG.k2s_operand(b32, rb)
    err = _build.lib().qk_tree_gemm_stream(
        a.device.index, a32.data_ptr(), lda, b32.data_ptr(), ldb,
        out.data_ptr(), m, out.shape[1], k, out_bytes, c_ints(params), plan,
        _stream(a))
    _build.check(err, "tree_gemm_stream")
    _tree_record(TG.tree_gemm_stream, f"plan_{plan}/{ra}/{rb}", params, k)
    return out


# K2 on a [M, K] @ b [K, N] under the plan params (_kernel_params at
# K2_LOG_BLK), instantiation modes (k2_modes)
tree_gemm = _declare(
    "tree_gemm(Tensor a, Tensor b, int[] params, int modes, int out_bytes)"
    " -> Tensor", _k2_plain, _k2, _gemm_fake)
# K2′ on the same, params at 0, instantiation plan (k2s_plan)
tree_gemm_stream = _declare(
    "tree_gemm_stream(Tensor a, Tensor b, int[] params, int plan, "
    "int out_bytes) -> Tensor", _k2s_plain, _k2s, _gemm_fake)


# ---------------------------------------------------------------------------
# K2h: the tensor-core kernels (int8 lanes, and int16/int32 as byte digits)
# ---------------------------------------------------------------------------

def _k2h_plain(a, b, params, modes, out_bytes):
    """K2h's plain version as its kernels compute it: the block dots of
    the operands' byte digits (``hybrid_digit_dots_plain``), then the
    tail."""
    from .tree_gemm import _hybrid_tail, hybrid_digit_dots_plain

    plan, out_fmt = hybrid_plan(tuple(params))
    vals = hybrid_digit_dots_plain(a, b, plan.s)
    return _hybrid_tail(vals, plan, out_fmt).to(lane_dtype(out_bytes))


def _k2h_record(kind: str, instance: str, params, k: int):
    from .tree_gemm import tree_gemm_hybrid as wrapper

    setattr(wrapper, kind, getattr(wrapper, kind) + 1)
    wrapper.launches += 1
    if not recording_launches():
        return
    plan, out_fmt = hybrid_plan(params)
    levels = max((k // plan.s).bit_length(), 1)
    _build.record(wrapper, instance,
                  (*plan.merge_fmts[plan.level:plan.level + levels], out_fmt))


def _k2h_mma(a, b, params, modes, out_bytes):
    from .tree_gemm import _row_pitch, digit_lanes

    out = _gemm_out(a, b, out_bytes)
    if out.numel() == 0:
        return out
    m, k = a.shape
    params = tuple(params)
    d = digit_lanes(a, b)
    # mixed lanes: the narrower operand widened to the wider lane, a copy
    # inside the call's event-timed time
    a = a if a.element_size() == d else a.to(lane_dtype(d))
    b = b if b.element_size() == d else b.to(lane_dtype(d))
    a, lda = _row_pitch(a)
    b, ldb = _row_pitch(b)
    err = _build.lib().qk_tree_gemm_hybrid_mma(
        a.device.index, a.data_ptr(), lda, b.data_ptr(), ldb,
        out.data_ptr(), m, out.shape[1], k, out_bytes, c_ints(params),
        modes, d, _stream(a))
    _build.check(err, f"tree_gemm_hybrid ({d}-byte lanes)")
    if d == 1:
        _k2h_record("mma_launches", f"mma_{modes}", params, k)
    else:
        _k2h_record("digit_launches", f"digits{d}_{modes}", params, k)
    return out


# K2h's tensor-core kernels under the plan params (_hybrid_params),
# instantiation modes (k2h_modes): int8 x int8 lanes, or int16/int32 lanes
# as byte digits (the lane bytes read from the operands, k2h_route)
tree_gemm_hybrid_mma = _declare(
    "tree_gemm_hybrid_mma(Tensor a, Tensor b, int[] params, int modes, "
    "int out_bytes) -> Tensor", _k2h_plain, _k2h_mma, _gemm_fake)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _k3_plain(x, axis, params, tails, modes, out_bytes):
    from .reduce import qreduce_plain

    plan = reduce_plan(tuple(params), tuple(tails), x.shape[axis],
                       out_bytes)
    return qreduce_plain(x, axis, plan)


def _k3(x, axis, params, tails, modes, out_bytes):
    from .reduce import k3_route, qreduce_kernel

    shape = tuple(x.shape)
    out = torch.empty(shape[:axis] + shape[axis + 1:],
                      dtype=lane_dtype(out_bytes), device=x.device)
    if out.numel() == 0:
        return out
    params = tuple(params)
    plan = reduce_plan(params, tuple(tails), shape[axis], out_bytes)
    x = x.contiguous()  # read in place as [outer, n, inner]
    route, lanes = k3_route(x, axis, plan)
    err = _build.lib().qk_qreduce(
        x.device.index, x.data_ptr(), out.data_ptr(),
        math.prod(shape[:axis]), plan.n, math.prod(shape[axis + 1:]),
        x.element_size(), out_bytes, c_ints(params), modes, lanes,
        _stream(x))
    _build.check(err, "qreduce_kernel")
    qreduce_kernel.launches += 1
    if recording_launches():
        _build.record(qreduce_kernel,
                      f"{route}_{lanes}/modes_{modes}/{x.element_size()}",
                      plan.merge_fmts)
    return out


def _k3_fake(x, axis, params, tails, modes, out_bytes):
    shape = tuple(x.shape)
    return x.new_empty(shape[:axis] + shape[axis + 1:],
                       dtype=lane_dtype(out_bytes))


# K3: x reduced along axis under the plan params (ReducePlan.kernel_params)
# with the odd tails tails (ReducePlan.tails), instantiation modes
# (k3_modes)
qreduce = _declare(
    "qreduce(Tensor x, int axis, int[] params, int[] tails, int modes, "
    "int out_bytes) -> Tensor", _k3_plain, _k3, _k3_fake)


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

def _p1_plain(x, y, params, steps, programs, plan):
    from .chain_probe import chain_probe_plain

    tplan, _ = tree_plan(tuple(params), 1)
    out = chain_probe_plain(x, y, tplan, steps, programs)
    # no steps and one program: the plain version's result is x's own int32
    # lanes, which an op's output must not alias
    return out.clone() if steps == 0 else out


def _p1(x, y, params, steps, programs, plan):
    from . import chain_probe as CP

    out = torch.empty((programs,) + tuple(x.shape), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    params = tuple(params)
    x32 = x.to(torch.int32).contiguous()
    y32 = y.to(torch.int32).contiguous()
    err = _build.lib().qk_chain_probe(
        x.device.index, x32.data_ptr(), y32.data_ptr(), out.data_ptr(),
        x32.numel(), programs, steps, c_ints(params), plan, _stream(x))
    _build.check(err, "chain_probe")
    CP.chain_probe.launches += 1
    if recording_launches():
        tplan, _ = tree_plan(params, 1)
        _build.record(CP.chain_probe, f"plan_{plan}",
                      (tplan.mul_fmt, tplan.merge_fmts[0]))
    return out


def _p1_fake(x, y, params, steps, programs, plan):
    return x.new_empty((programs,) + tuple(x.shape), dtype=torch.int32)


# P1: steps product + layer-0 merge steps of the plan params (_kernel_params
# at 0) on the tile x against y, written programs times; instantiation plan
# (p1_plan)
chain_probe = _declare(
    "chain_probe(Tensor x, Tensor y, int[] params, int steps, int programs,"
    " int plan) -> Tensor", _p1_plain, _p1, _p1_fake)


# ---------------------------------------------------------------------------
# C1 and G1: moe_combine and mul_requant
# ---------------------------------------------------------------------------

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _trunc_steps(params):
    """The requantize steps of ``params`` (five ints each) as the four
    ints (shift, lo, hi, zero) of C1's and G1's ``Step``, or None where
    one of them rounds or wraps: a step truncates (TRN_TCPL, or no
    fraction bit dropped) and saturates (SAT_TCPL, SAT_SMGN into [lo, hi],
    SAT_ZERO to 0 outside it)."""
    out = []
    for i in range(0, len(params), 5):
        d, rnd, ovf, w, sgn = params[i:i + 5]
        sat = (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
               OverflowMode.SAT_SMGN)
        if (d > 0 and rnd != int(RoundMode.TRN_TCPL)) or d < -31 or \
                ovf not in map(int, sat):
            return None
        lo, hi = _I32_MIN, _I32_MAX
        if w <= 32:
            hi = (1 << (w - 1)) - 1
            lo = 0 if not sgn else -hi if ovf == OverflowMode.SAT_SMGN \
                else -hi - 1
        out += [d, lo, hi, int(ovf == OverflowMode.SAT_ZERO)]
    return tuple(out)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous and 16-byte aligned, else a copy that
    is (C1's and G1's 16-byte loads)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _c1_plain(shared, d, pos, w, params, out_bytes):
    """C1's plain version: the scatter-add of the pairs' requantized
    products into the rows' requantized shared outputs (int32, wrapping
    as the kernel's sum does), then the last two steps."""
    from .wideint import requantize_i32

    pair, pacc, sh, sat, fin = (rq_format(tuple(params[i:i + 5]))
                                for i in range(0, 25, 5))
    acc = requantize_i32(shared.to(torch.int32), *sh)
    rows, slots = (pos >= 0).nonzero(as_tuple=True)
    prod = w[rows, slots, None] * d[pos[rows, slots].long()].to(torch.int32)
    acc.index_add_(0, rows, requantize_i32(requantize_i32(prod, *pair),
                                           *pacc))
    return requantize_i32(requantize_i32(acc, *sat), *fin).to(
        lane_dtype(out_bytes))


def _c1_fake(shared, d, pos, w, params, out_bytes):
    return shared.new_empty(shared.shape, dtype=lane_dtype(out_bytes))


def _c1(shared, d, pos, w, params, out_bytes):
    """C1: its steps but the last truncate and saturate, its lanes are
    int16, n a multiple of 8 and at most 8 slots; other arguments raise
    ValueError (copies of strided or unaligned tensors are launched)."""
    from ..moe import combine

    steps = _trunc_steps(params[:20])
    n, k = shared.shape[1], pos.shape[1]
    if (steps is None or shared.dtype != torch.int16 or d.dtype !=
            torch.int16 or n % 8 or k > 8):
        raise ValueError(
            f"moe_combine on the card: C1 takes truncating, saturating "
            f"steps but the last, int16 lanes, n % 8 == 0 and k <= 8; got "
            f"steps "
            f"{list(params)}, {shared.dtype} and {d.dtype} lanes, n = {n}, "
            f"k = {k}")
    shared, d = _dense(shared), _dense(d)
    out = torch.empty(shared.shape, dtype=lane_dtype(out_bytes),
                      device=shared.device)
    pos, w = pos.contiguous(), w.contiguous()
    err = _build.lib().qk_moe_combine(
        shared.device.index, shared.data_ptr(), d.data_ptr(), pos.data_ptr(),
        w.data_ptr(), out.data_ptr(), shared.shape[0], n, k, out_bytes,
        c_ints(steps + tuple(params[20:])), _stream(shared))
    _build.check(err, "moe_combine")
    combine.launches += 1
    return out


# C1: a row's shared output plus its held pairs' weighted outputs, as one
# gather a row (moe.combine)
moe_combine = _declare(
    "moe_combine(Tensor shared, Tensor d, Tensor pos, Tensor w, "
    "int[] params, int out_bytes) -> Tensor", _c1_plain, _c1, _c1_fake)


def _g1_plain(a, b, params, mid_bytes, out_bytes):
    """G1's plain version: the int32 product (wrapping), its two steps, the
    first one's result stored in its lane between them."""
    from .wideint import requantize_i32

    mid, fin = (rq_format(tuple(params[i:i + 5])) for i in (0, 5))
    h = requantize_i32(a.to(torch.int32) * b.to(torch.int32), *mid)
    h = h.to(lane_dtype(mid_bytes)).to(torch.int32)
    return requantize_i32(h, *fin).to(lane_dtype(out_bytes))


def _g1_fake(a, b, params, mid_bytes, out_bytes):
    return a.new_empty(a.shape, dtype=lane_dtype(out_bytes))


def _g1(a, b, params, mid_bytes, out_bytes):
    """G1: the first step truncates and saturates (so mid's result fits
    its lane), the lanes are int8 and the elements a multiple of 16; other
    arguments raise ValueError (copies of strided or unaligned tensors
    are launched)."""
    from ..moe import gated

    steps = _trunc_steps(params[:5])
    if (steps is None or a.dtype != torch.int8 or b.dtype != torch.int8
            or out_bytes != 1 or a.numel() % 16):
        raise ValueError(
            f"mul_requant on the card: G1 takes a truncating, saturating "
            f"first step, int8 lanes in and out and a multiple of 16 "
            f"elements; "
            f"got steps {list(params)}, {a.dtype} and {b.dtype} lanes, "
            f"out_bytes {out_bytes}, {a.numel()} elements")
    a, b = _dense(a), _dense(b)
    out = torch.empty(a.shape, dtype=lane_dtype(out_bytes), device=a.device)
    err = _build.lib().qk_mul_requant(
        a.device.index, a.data_ptr(), b.data_ptr(), out.data_ptr(),
        a.numel(), c_ints(steps + tuple(params[5:])), _stream(a))
    _build.check(err, "mul_requant")
    gated.launches += 1
    return out


# G1: qcast(qmul(a, b, to=mid), fin) of same-shape lanes in one pass
# (moe.gated)
mul_requant = _declare(
    "mul_requant(Tensor a, Tensor b, int[] params, int mid_bytes, "
    "int out_bytes) -> Tensor", _g1_plain, _g1, _g1_fake)


# ---------------------------------------------------------------------------
# N1: rms_norm
# ---------------------------------------------------------------------------

def _n1_plain(x, table, gain, params):
    """N1's plain version: each row's sum of squares in int32, its ROM
    entry times ``gain`` requantized into the row's factor, and the row
    times its factor, each through its step."""
    from .wideint import requantize_i32

    cast, scale, fin = (rq_format(tuple(params[i:i + 5]))
                        for i in (0, 5, 10))
    xi = x.to(torch.int32)
    ss = (xi * xi).sum(-1, keepdim=True, dtype=torch.int32)
    rs = table[(requantize_i32(ss, *cast) & (table.numel() - 1)).long()]
    s = requantize_i32(rs * gain, *scale)
    return requantize_i32(xi * s, *fin).to(torch.int8)


def _n1_fake(x, table, gain, params):
    return x.new_empty(x.shape, dtype=torch.int8)


def _n1(x, table, gain, params):
    """N1: int8 rows [rows, n], n a multiple of 16 below 2^17, a table of
    2^w contiguous int32 entries on the card; other arguments raise
    ValueError (a copy of a strided or unaligned ``x`` is launched)."""
    from ..moe import rms_norm

    n, t = x.shape[-1], table.numel()
    if (x.dtype != torch.int8 or x.ndim != 2 or n % 16 or n >= 1 << 17
            or table.dtype != torch.int32 or table.ndim != 1 or t & (t - 1)
            or not table.is_contiguous() or table.device != x.device):
        raise ValueError(
            f"rms_norm on the card: N1 takes int8 rows of n % 16 == 0, "
            f"n < 2^17 and a table of 2^w contiguous int32 entries on "
            f"{x.device}; got {x.dtype} {tuple(x.shape)}, table "
            f"{table.dtype} {tuple(table.shape)} on {table.device}")
    x = _dense(x)
    out = torch.empty_like(x)
    err = _build.lib().qk_rms_norm(
        x.device.index, x.data_ptr(), out.data_ptr(), x.shape[0], n,
        table.data_ptr(), t - 1, gain, c_ints(tuple(params)), _stream(x))
    _build.check(err, "rms_norm")
    rms_norm.launches += 1
    return out


# N1: RMSNorm of int8 rows through a ROM of each row's sum of squares
# (moe.rms_norm)
rms_norm = _declare(
    "rms_norm(Tensor x, Tensor table, int gain, int[] params) -> Tensor",
    _n1_plain, _n1, _n1_fake)


# every op, for opcheck and the tests
OPS = (fused_gemm_s8, fused_gemm_s32, fused_gemm_s8_grouped, tree_gemm,
       tree_gemm_stream, tree_gemm_hybrid_mma, qreduce, chain_probe,
       moe_combine, mul_requant, rms_norm)
