"""K2 and K2′: the order-sensitive quantized tree GEMM on torch.

When products or tree layers round or saturate, the result depends on the
association order, so the reference's balanced-tree pairing (QuBLAS.h:
4960-4990), odd-tail converting assignments included, has to be replayed
exactly.  The planners (``TreePlan``, ``level_formats``, ``drain_ops``,
``plan_tree``) are copies of ``qublas_tpu/ops/tree_gemm.py:73-245``, pinned
to the originals by the CPU tests: the machine with the card has no JAX.

The kernels are ``csrc/tree_gemm_tiled.cu`` (K2) and
``csrc/tree_gemm_stream.cu`` (K2′), two evaluations of the same
binary-carry schedule:

* :func:`tree_gemm` (K2, counterpart of the Pallas kernel
  ``tree_gemm_blocked``): a tiled kernel; each thread owns a register
  micro-tile of outputs, operands come through shared memory in k-slices
  of 16, each slice's products folded incrementally in registers (tree
  and up).  Plans whose product and merges all round and overflow with one
  pair of :data:`K2_MODES` take an instantiation with those modes and the
  product's route (the int32 ones, or the 64-bit "pair" product) fixed at
  compile time (:func:`k2_modes`);
* :func:`tree_gemm_stream` (K2′, counterpart of ``tree_gemm_pallas``): a
  tiled kernel too, with k-slices of ``2**K2S_LOG_S`` products arriving by
  TMA, and one register stack over every tree level, every product pushed
  through it.  Plans whose product route and requantize steps are those of
  an entry of :data:`K2S_PLANS` take an instantiation with the whole steps
  compiled in (:func:`k2s_plan`); operands whose rows TMA cannot describe
  go in as pitched copies (:func:`k2s_operand`).

Their plain versions run the same schedules as Python loops on torch
tensors: products of one block, the in-block tree layers, the slot stack,
the drain, the final requantize.

The prefix-lossless hybrid (``HybridPlan``, ``plan_hybrid``, copies of
``qublas_tpu/ops/tree_gemm.py:530-617``) has a kernel of its own,
:func:`tree_gemm_hybrid` (K2h, ``csrc/tree_gemm_hybrid.cu``, counterpart of
the JAX package's ``tree_gemm_hybrid``, an XLA einsum and VPU folds): the
exact int32 dot of each block of ``s`` products, shifted by ``dl``, pushed
onto the slot stack of tree levels ``L`` and up.  Its plain version
:func:`tree_gemm_hybrid_plain` forms the block dots as one matmul a block
and folds the tail layer by layer.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import _build
from ..qformat import OverflowMode, QFormat, RoundMode, add_merge
from .reduce import layer_format
from .wideint import (
    mul_wide,
    requantize_i32,
    requantize_i64,
    requantize_split_mul,
)
from .widths import (
    LANE_DTYPES,
    Interval,
    fmt_interval,
    requant_out_interval,
    route_mul,
    route_requant,
    torch_dtype_for,
)

__all__ = ["TreePlan", "plan_tree", "level_formats", "drain_ops", "ROUTES",
           "tree_gemm", "tree_gemm_plain", "tree_gemm_stream",
           "tree_gemm_stream_plain", "K2_LOG_BLK", "K2_MODES", "k2_modes",
           "K2S_LOG_S", "K2S_PLANS", "k2s_plan", "k2s_operand", "k2s_route",
           "HybridPlan", "plan_hybrid", "tree_gemm_hybrid",
           "tree_gemm_hybrid_plain", "k2h_route", "K2H_MODES",
           "k2h_modes"]


@dataclass(frozen=True)
class TreePlan:
    """Static schedule for the streaming tree evaluation."""

    k: int
    prod_route: str          # "i32" | "split" | "pair"
    prod_frac: int
    mul_fmt: QFormat
    levels: int              # number of slot levels (floor(log2(k)) + 1)
    level_fmts: Tuple[QFormat, ...]   # format of a value at each level
    merge_fmts: Tuple[QFormat, ...]   # layer-l format (merge level l -> l+1)
    drain: Tuple[Tuple[str, int], ...]  # ("seed"|"convert"|"add", level)
    final_fmt: QFormat

    @functools.cached_property
    def _kernel_cache(self) -> dict:
        """The kernels' host-side arguments for this plan (``_kernel_params``,
        ``k2s_plan``), built on first use and shared by every launch after
        it; not a field, so equality and hashing ignore it."""
        return {}


def level_formats(value_fmt: QFormat, add_formats, k: int):
    """Per-level (value_fmt list, merge_fmt list) of the reducer tree."""
    levels = max(k.bit_length(), 1)
    level_fmts = [value_fmt]
    merge_fmts = []
    for l in range(levels):
        lf = layer_format(add_formats, l)
        if lf is None:
            lf = add_merge(level_fmts[l], level_fmts[l])
        merge_fmts.append(lf)
        level_fmts.append(lf)
    return level_fmts, merge_fmts


def drain_ops(k: int, levels: int):
    """Drain schedule (binary-carry ragged edge) — ("seed"|"convert"|"add",
    level) ops, independent of formats."""
    drain = []
    carry_active = False
    occupied = [bool(k & (1 << l)) for l in range(levels)]
    for l in range(levels):
        remaining_above = any(occupied[l + 1:])
        if occupied[l] and carry_active:
            drain.append(("add", l))
        elif occupied[l] or carry_active:
            if occupied[l]:
                drain.append(("seed", l))
            if remaining_above:
                drain.append(("convert", l))
            carry_active = True
        if not remaining_above and carry_active:
            break
    return drain


def plan_tree(fa: QFormat, fb: QFormat, mul_fmt: QFormat, add_formats,
              k: int, out_fmt: QFormat) -> Optional[TreePlan]:
    """Build the schedule and prove every step fits int32 lanes (products
    may need the 64-bit "pair" route).  None when a step needs the host."""
    if k < 1:
        return None
    prod_route, prod_iv, prod_frac = route_mul(fa, fb, mul_fmt)
    if prod_route == "host":
        return None

    def union(a: Interval, b: Interval) -> Interval:
        return Interval(min(a.lo, b.lo), max(a.hi, b.hi))

    levels = max(k.bit_length(), 1)
    level_fmts = [mul_fmt]
    merge_fmts = []
    # the actual value interval at each level (post-saturation), so the
    # route proofs are tight rather than assuming full storage ranges
    iv, _ = requant_out_interval(prod_iv, prod_frac, mul_fmt)
    level_ivs = [iv]
    for l in range(levels):
        cur = level_fmts[l]
        lf = layer_format(add_formats, l)
        if lf is None:
            lf = add_merge(cur, cur)
        merge_fmts.append(lf)
        level_fmts.append(lf)
        s = level_ivs[l] + level_ivs[l]
        if not s.fits32:
            return None
        if route_requant(s, cur.frac_bits, lf) != "i32":
            return None
        if route_requant(level_ivs[l], cur.frac_bits, lf) != "i32":
            return None  # tail converting assignment at this layer
        pair_iv, _ = requant_out_interval(s, cur.frac_bits, lf)
        tail_iv, _ = requant_out_interval(level_ivs[l], cur.frac_bits, lf)
        level_ivs.append(union(pair_iv, tail_iv))

    # route proofs over the drain schedule.  Invariant: a carry entering
    # layer l always has format level_fmts[l].
    drain = drain_ops(k, levels)
    carry_iv = None
    cur_fmt = level_fmts[0]
    for op, l in drain:
        if op == "seed":
            cur_fmt = level_fmts[l]
            carry_iv = level_ivs[l]
        elif op == "convert":
            if route_requant(carry_iv, cur_fmt.frac_bits,
                             merge_fmts[l]) != "i32":
                return None
            carry_iv, _ = requant_out_interval(carry_iv, cur_fmt.frac_bits,
                                               merge_fmts[l])
            cur_fmt = merge_fmts[l]
        else:  # add: slot l (format level_fmts[l]) merges with the carry
            s = level_ivs[l] + carry_iv
            if not s.fits32:
                return None
            if route_requant(s, level_fmts[l].frac_bits,
                             merge_fmts[l]) != "i32":
                return None
            carry_iv, _ = requant_out_interval(s, level_fmts[l].frac_bits,
                                               merge_fmts[l])
            cur_fmt = merge_fmts[l]
    final_fmt = cur_fmt
    if route_requant(carry_iv, final_fmt.frac_bits, out_fmt) != "i32":
        return None
    if torch_dtype_for(out_fmt) is None:
        return None
    return TreePlan(k, prod_route, prod_frac, mul_fmt, levels,
                    tuple(level_fmts), tuple(merge_fmts), tuple(drain),
                    final_fmt)


@dataclass(frozen=True)
class HybridPlan:
    """Proof artifact of the prefix-lossless hybrid evaluation (copy of
    ``qublas_tpu/ops/tree_gemm.py:HybridPlan``): when the product's
    requantize and the first ``level`` tree layers only shift left, the
    value at tree level ``level`` of each ``s = 2**level``-product subtree
    is the plain integer dot of that k-block shifted left by ``dl``, and
    only the tail layers round and saturate."""

    s: int                     # block size 2^L
    level: int                 # first lossy layer index (= L)
    dl: int                    # left shift from raw-product scale to level L
    level_fmts: Tuple[QFormat, ...]
    merge_fmts: Tuple[QFormat, ...]
    final_fmt: QFormat

    @functools.cached_property
    def _kernel_cache(self) -> dict:
        """K2h's parameters by (k, out_fmt), built on first use; not a
        field."""
        return {}


# K2h's least block (csrc/hybrid_tail.cuh HYB_MIN_LEVEL): the IMAD kernel
# folds whole half slices of 8 products, the tensor-core kernel half an
# m16n8k16 fragment, so a block holds at least 2**3 products
_HYB_MIN_LEVEL = 3


def plan_hybrid(fa: QFormat, fb: QFormat, mul_fmt: QFormat, add_formats,
                k: int, out_fmt: QFormat) -> Optional[HybridPlan]:
    """Prove the longest lossless tree prefix and the routes of the lossy
    tail (copy of ``qublas_tpu/ops/tree_gemm.py:plan_hybrid`` at its
    default ``min_level``).  None when the prefix is shorter than
    ``_HYB_MIN_LEVEL`` layers or any tail step needs a route other than
    int32."""
    from .gemm import _lossless_requant

    if k < 2:
        return None
    pf = fa.frac_bits + fb.frac_bits
    prod_iv = fmt_interval(fa) * fmt_interval(fb)
    iv = _lossless_requant(prod_iv, pf, mul_fmt)
    if iv is None:
        return None

    level_fmts, merge_fmts = level_formats(mul_fmt, add_formats, k)
    cur_fmt = mul_fmt
    lvl = 0
    ivs = iv
    while (1 << (lvl + 1)) <= k and k % (1 << (lvl + 1)) == 0:
        lf = merge_fmts[lvl]
        nxt = _lossless_requant(ivs + ivs, cur_fmt.frac_bits, lf)
        if nxt is None:
            break
        ivs, cur_fmt = nxt, lf
        lvl += 1
    if lvl < _HYB_MIN_LEVEL:
        return None
    s = 1 << lvl
    dl = cur_fmt.frac_bits - pf
    # the raw block dot and every partial sum must fit int32, as must the
    # shifted level-L value
    dot_iv = Interval(min(s * prod_iv.lo, prod_iv.lo),
                      max(s * prod_iv.hi, prod_iv.hi))
    if not (dot_iv.fits32 and ivs.fits32 and 0 <= dl <= 31):
        return None

    # tail proof: fold nb block values through layers lvl.. with i32 routes
    nb = k // s
    cur_iv, cur = ivs, cur_fmt
    level = lvl
    n_vals = nb
    while n_vals > 1:
        lf = merge_fmts[level]
        ssum = cur_iv + cur_iv
        if not ssum.fits32:
            return None
        if route_requant(ssum, cur.frac_bits, lf) != "i32":
            return None
        if n_vals % 2 and route_requant(cur_iv, cur.frac_bits, lf) != "i32":
            return None
        pair_iv, _ = requant_out_interval(ssum, cur.frac_bits, lf)
        tail_iv, _ = requant_out_interval(cur_iv, cur.frac_bits, lf)
        cur_iv = Interval(min(pair_iv.lo, tail_iv.lo),
                          max(pair_iv.hi, tail_iv.hi))
        cur = lf
        level += 1
        n_vals = (n_vals + 1) // 2
    if route_requant(cur_iv, cur.frac_bits, out_fmt) != "i32":
        return None
    if torch_dtype_for(out_fmt) is None:
        return None
    return HybridPlan(s, lvl, dl, tuple(level_fmts), tuple(merge_fmts), cur)


def _product(plan: TreePlan, col, row):
    """Requantized outer product (one level-0 value) of int32 tensors, as
    int32: the "pair" route multiplies in int64 and narrows the requantized
    product (which the plan's proof keeps inside int32) to its lane."""
    if plan.prod_route == "i32":
        return requantize_i32(col * row, plan.prod_frac, plan.mul_fmt)
    if plan.prod_route == "split":
        return requantize_split_mul(col, row, plan.prod_frac, plan.mul_fmt)
    return requantize_i64(mul_wide(col, row), plan.prod_frac,
                          plan.mul_fmt).to(torch.int32)


def _merge(plan: TreePlan, l: int, left, right):
    """Layer-l Qadd: align (same format, no shift), add, requantize."""
    return requantize_i32(left + right, plan.level_fmts[l].frac_bits,
                          plan.merge_fmts[l])


def _drain(plan: TreePlan, read_slot):
    """Run the drain schedule; ``read_slot(l)`` yields slot l's value."""
    carry = None
    for op, l in plan.drain:
        if op == "seed":
            carry = read_slot(l)
        elif op == "convert":
            carry = requantize_i32(carry, plan.level_fmts[l].frac_bits,
                                   plan.merge_fmts[l])
        else:  # add: slot l is the earlier (left) operand
            carry = _merge(plan, l, read_slot(l), carry)
    return carry


def _block_size(k: int) -> int:
    """Products per block: the largest power of two dividing k, capped at 16
    (``qublas_tpu/ops/tree_gemm.py:_block_size``)."""
    return min(k & (-k), 16)


def _slot_stack_plain(a: torch.Tensor, b: torch.Tensor, plan: TreePlan,
                      out_fmt: QFormat, blk: int) -> torch.Tensor:
    """The slot-stack schedule as a Python loop over k-blocks of ``blk``
    products, each block materialising its [blk, M, N] products."""
    a32 = a.to(torch.int32)
    b32 = b.to(torch.int32)
    k = a32.shape[1]
    inblk = blk.bit_length() - 1          # tree layers folded in a block
    slots = {}
    for t in range(k // blk):
        col = a32[:, t * blk:(t + 1) * blk].t()[:, :, None]   # [blk, M, 1]
        row = b32[t * blk:(t + 1) * blk, None, :]             # [blk, 1, N]
        v = _product(plan, col, row)                          # [blk, M, N]
        for l in range(inblk):
            v = _merge(plan, l, v[0::2], v[1::2])
        v = v[0]
        j = 0
        while t & (1 << j):  # one merge per trailing one-bit of t
            v = _merge(plan, inblk + j, slots.pop(j), v)
            j += 1
        slots[j] = v
    result = _drain(plan, lambda l: slots[max(l - inblk, 0)])
    raw = requantize_i32(result, plan.final_fmt.frac_bits, out_fmt)
    return raw.to(torch_dtype_for(out_fmt))


def tree_gemm_plain(a: torch.Tensor, b: torch.Tensor, plan: TreePlan,
                    out_fmt: QFormat) -> torch.Tensor:
    """Plain-torch K2: ``tree_gemm_scan``'s schedule, blocks of
    ``_block_size(k)`` products."""
    return _slot_stack_plain(a, b, plan, out_fmt, _block_size(a.shape[1]))


def tree_gemm_stream_plain(a: torch.Tensor, b: torch.Tensor, plan: TreePlan,
                           out_fmt: QFormat) -> torch.Tensor:
    """Plain-torch K2′: ``tree_gemm_pallas``'s schedule, one product per
    step pushed through the slot stack."""
    return _slot_stack_plain(a, b, plan, out_fmt, 1)


_OPS = {"seed": 0, "convert": 1, "add": 2}

# The product routes as the kernels code them (csrc/tree_gemm.cuh's Route).
ROUTES = {"i32": 0, "split": 1, "pair": 2}


def _kernel_params(plan: TreePlan, out_fmt: QFormat, log_blk: int):
    """The plan as ``csrc/tree_gemm.cuh``'s int32 parameters (``read_params``)
    with 2^log_blk products folded per block: 4 for K2, 0 for K2′ and P1.
    Built once per (out_fmt, log_blk) and kept on the plan: the kernels
    only read it."""
    key = (out_fmt, log_blk)
    if key not in plan._kernel_cache:
        plan._kernel_cache[key] = _build_params(plan, out_fmt, log_blk)
    return plan._kernel_cache[key]


def _build_params(plan: TreePlan, out_fmt: QFormat, log_blk: int):
    if plan.prod_route not in ROUTES:
        raise ValueError(f"the tree kernels take products on the routes "
                         f"{tuple(ROUTES)}, not {plan.prod_route!r}")
    p = [ROUTES[plan.prod_route], log_blk,
         *_build.rq_args(plan.prod_frac, plan.mul_fmt),
         plan.levels]
    for l in range(plan.levels):
        p += _build.rq_args(plan.level_fmts[l].frac_bits, plan.merge_fmts[l])
    p.append(len(plan.drain))
    for op, l in plan.drain:
        p += [_OPS[op], l]
    p += _build.rq_args(plan.final_fmt.frac_bits, out_fmt)
    return (ctypes.c_int * len(p))(*p)


K2_LOG_BLK = 4   # K2 folds k in slices of 2^4 products (csrc LOG_BLK)

# The (round, overflow) pairs that K2 has compile-time instantiations for.
# csrc/tree_gemm_tiled.cuh's K2_MODES has two entries for each, after its
# run-time entry 0: the pair with the int32 product routes, then with the
# 64-bit one.
K2_MODES = ((RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO),)


def k2_modes(plan: TreePlan) -> int:
    """K2's instantiation for ``plan``: for the pair of :data:`K2_MODES` at
    index i that the product and every tree merge (the drain's converts
    included) round and overflow with, 2i + 1 on the i32 and split product
    routes and 2i + 2 on the 64-bit "pair" route; 0 (modes and route read
    at run time) when they do not all share one of those pairs.  The final
    requantize into the output format always reads its modes at run time."""
    steps = (plan.mul_fmt,) + tuple(plan.merge_fmts)
    for i, (rm, om) in enumerate(K2_MODES):
        if all(f.round_mode == rm and f.overflow_mode == om for f in steps):
            return 2 * i + (2 if plan.prod_route == "pair" else 1)
    return 0


K2S_LOG_S = 5   # K2′ takes k in slices of 2^5 products (csrc K2S_LOG_S)

# The plans that K2′ and P1 have compile-time instantiations for, in
# csrc/plan_steps.cuh's K2S_PLANS order after its run-time entry 0:
# (the product route's code in ROUTES, the product's requantize step, the
# step every tree merge shares), each step as ``_build.rq_args`` gives it.
# The one entry is the canonical Qu<8,8,TRN::TCPL,SAT::ZERO> plan: split
# products 16 -> 8 fraction bits and merges shift 0, both into 17-bit
# SAT::ZERO.
K2S_PLANS = (
    (ROUTES["split"],
     (8, int(RoundMode.TRN_TCPL), int(OverflowMode.SAT_ZERO), 17, 1),
     (0, int(RoundMode.TRN_TCPL), int(OverflowMode.SAT_ZERO), 17, 1)),
)


def k2s_plan(plan: TreePlan) -> int:
    """K2′'s instantiation for ``plan``: 1 + the index in :data:`K2S_PLANS`
    of the entry whose product route and step are the plan's and whose
    merge step every tree merge (the drain's converts included) has, or 0
    (every step read at run time).  The final requantize into the output
    format always reads its step at run time."""
    route = ROUTES.get(plan.prod_route)
    prod = _build.rq_args(plan.prod_frac, plan.mul_fmt)
    merges = {_build.rq_args(plan.level_fmts[l].frac_bits, plan.merge_fmts[l])
              for l in range(plan.levels)}
    for i, (e_route, e_prod, e_merge) in enumerate(K2S_PLANS):
        if (route, prod) == (e_route, e_prod) and merges == {e_merge}:
            return i + 1
    return 0


def k2s_route(t32: torch.Tensor) -> str:
    """How K2′'s TMA reads the 2-D int32 tensor ``t32``: "direct" when its
    rows are contiguous, its pitch a multiple of 4 elements and its base
    16-byte aligned, else "pitched" (a copy, :func:`k2s_operand`)."""
    if t32.stride(1) == 1 and t32.stride(0) % 4 == 0 \
            and t32.stride(0) >= t32.shape[1] and t32.data_ptr() % 16 == 0:
        return "direct"
    return "pitched"


def k2s_operand(t: torch.Tensor, route: Optional[str] = None):
    """``(tensor, row pitch in elements)`` as K2′'s TMA reads the int32
    lanes of the 2-D ``t``: ``t`` itself where :func:`k2s_route` says
    "direct", else a copy whose pitch is rounded up to 4 ("pitched"); the
    columns past ``t``'s are zero and never read as products.  ``route``
    is ``k2s_route`` of ``t``'s int32 lanes, computed here when None."""
    t32 = t.to(torch.int32)
    rows, cols = t32.shape
    if (k2s_route(t32) if route is None else route) == "direct":
        return t32, t32.stride(0)
    pitch = -(-cols // 4) * 4
    buf = torch.zeros((rows, pitch), dtype=torch.int32, device=t.device)
    buf[:, :cols] = t32
    return buf, pitch


def _step_fmts(plan: TreePlan, out_fmt: QFormat):
    """The formats that the requantize steps of ``plan`` into ``out_fmt``
    write (the product, every tree merge, the final requantize), for
    ``_build.record``."""
    return (plan.mul_fmt, *plan.merge_fmts, out_fmt)


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, plan: TreePlan,
            out_fmt: QFormat):
    """Check the operands; None for CPU tensors, else the output of the
    kernel ``name`` launched on them and its instantiation's name."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] \
            or a.shape[1] != plan.k:
        raise ValueError(f"need [M, {plan.k}] @ [{plan.k}, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in LANE_DTYPES or b.dtype not in LANE_DTYPES:
        raise TypeError(f"operands must be int8/int16/int32 lanes, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return None
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, not {a.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch_dtype_for(out_fmt), device=a.device)
    if m == 0 or n == 0:
        return out, None
    lib = _build.lib()
    dev = a.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if name == "tree_gemm":
        a32 = a.to(torch.int32).contiguous()
        b32 = b.to(torch.int32).contiguous()
        modes = k2_modes(plan)
        err = lib.qk_tree_gemm(dev, a32.data_ptr(), b32.data_ptr(),
                               out.data_ptr(), m, n, k, out.element_size(),
                               _kernel_params(plan, out_fmt, K2_LOG_BLK),
                               modes, stream)
        # csrc/tree_gemm_tiled.cu's instantiations: an 8-level slot stack
        # below k = 4096, 32 levels from there
        top = 8 if (k >> K2_LOG_BLK).bit_length() <= 8 else 32
        instance = f"tiled_{top}_{modes}"
    else:
        a32, b32 = a.to(torch.int32), b.to(torch.int32)
        ra, rb = k2s_route(a32), k2s_route(b32)
        a32, lda = k2s_operand(a32, ra)
        b32, ldb = k2s_operand(b32, rb)
        if "k2s" not in plan._kernel_cache:
            plan._kernel_cache["k2s"] = k2s_plan(plan)
        err = lib.qk_tree_gemm_stream(dev, a32.data_ptr(), lda,
                                      b32.data_ptr(), ldb, out.data_ptr(),
                                      m, n, k, out.element_size(),
                                      _kernel_params(plan, out_fmt, 0),
                                      plan._kernel_cache["k2s"], stream)
        instance = f"plan_{plan._kernel_cache['k2s']}/{ra}/{rb}"
    _build.check(err, name)
    return out, instance


def tree_gemm(a: torch.Tensor, b: torch.Tensor, plan: TreePlan,
              out_fmt: QFormat) -> torch.Tensor:
    """The tree GEMM ``a`` [M, K] @ ``b`` [K, N] of lane tensors under
    ``plan``, stored in ``torch_dtype_for(out_fmt)``.

    CPU tensors take the plain version; CUDA tensors launch K2.
    ``tree_gemm.launches`` counts kernel launches, ``tree_gemm.seen``
    (``_build.record``) each launch's instantiation and its steps' modes.
    """
    res = _launch("tree_gemm", a, b, plan, out_fmt)
    if res is None:
        return tree_gemm_plain(a, b, plan, out_fmt)
    out, instance = res
    if instance is not None:
        tree_gemm.launches += 1
        _build.record(tree_gemm, instance, _step_fmts(plan, out_fmt))
    return out


def tree_gemm_stream(a: torch.Tensor, b: torch.Tensor, plan: TreePlan,
                     out_fmt: QFormat) -> torch.Tensor:
    """The same function as :func:`tree_gemm` on the one-pass schedule of
    ``tree_gemm_pallas``: every product pushed through the slot stack.

    CPU tensors take the plain version; CUDA tensors launch K2′, the
    instantiation of :func:`k2s_plan`.
    ``tree_gemm_stream.launches`` counts kernel launches,
    ``tree_gemm_stream.seen`` each launch's instantiation and operand
    routes (:func:`k2s_route`) and its steps' modes.
    """
    res = _launch("tree_gemm_stream", a, b, plan, out_fmt)
    if res is None:
        return tree_gemm_stream_plain(a, b, plan, out_fmt)
    out, instance = res
    if instance is not None:
        tree_gemm_stream.launches += 1
        _build.record(tree_gemm_stream, instance, _step_fmts(plan, out_fmt))
    return out


tree_gemm.launches = 0
tree_gemm.seen = Counter()
tree_gemm_stream.launches = 0
tree_gemm_stream.seen = Counter()


# ---------------------------------------------------------------------------
# K2h: the prefix-lossless hybrid
# ---------------------------------------------------------------------------

def tree_gemm_hybrid_plain(a: torch.Tensor, b: torch.Tensor, plan: HybridPlan,
                           out_fmt: QFormat) -> torch.Tensor:
    """Plain-torch K2h, ``tree_gemm_hybrid``'s evaluation: one matmul a
    k-block of ``plan.s`` products, shifted by ``dl``, then the tail layer
    by layer, odd tails converted.  The block dots run in int64 on the CPU
    (an int8 matmul would wrap in int8 there) and narrow to int32 as the
    int32 dot wraps; on the card in float64, exact while every partial sum
    stays below 2^53 (the proof keeps them inside int32 for raws inside the
    operands' formats)."""
    m, k = a.shape
    n = b.shape[1]
    s = plan.s
    dt = torch.int64 if a.device.type == "cpu" else torch.float64
    af, bf = a.to(dt), b.to(dt)
    vals = torch.empty((k // s, m, n), dtype=torch.int32, device=a.device)
    for t in range(k // s):
        dot = af[:, t * s:(t + 1) * s] @ bf[t * s:(t + 1) * s]
        vals[t] = dot.to(torch.int64).to(torch.int32)
    if plan.dl:
        vals = vals << plan.dl
    level = plan.level
    while vals.shape[0] > 1:
        cnt = vals.shape[0]
        cur, lf = plan.level_fmts[level], plan.merge_fmts[level]
        pair = requantize_i32(vals[0:cnt - 1:2] + vals[1:cnt:2],
                              cur.frac_bits, lf)
        if cnt % 2:
            tail = requantize_i32(vals[cnt - 1:], cur.frac_bits, lf)
            pair = torch.cat([pair, tail])
        vals = pair
        level += 1
    raw = requantize_i32(vals[0], plan.final_fmt.frac_bits, out_fmt)
    return raw.to(torch_dtype_for(out_fmt))


def _hybrid_params(plan: HybridPlan, k: int, out_fmt: QFormat):
    """The plan as K2h's int32 parameters (``csrc/hybrid_tail.cuh``:
    ``read_hybrid``): level, dl, then the tail over the ``k // s`` block
    values as a tree of its own (tree level ``level + j`` as its level j:
    the merges and ``drain_ops(k // s, levels)``), then the final
    requantize.  Built once per (k, out_fmt) and kept on the plan."""
    key = (k, out_fmt)
    if key not in plan._kernel_cache:
        nb = k // plan.s
        levels = max(nb.bit_length(), 1)
        p = [plan.level, plan.dl, levels]
        for j in range(levels):
            p += _build.rq_args(plan.level_fmts[plan.level + j].frac_bits,
                                plan.merge_fmts[plan.level + j])
        drain = drain_ops(nb, levels)
        p.append(len(drain))
        for op, l in drain:
            p += [_OPS[op], l]
        p += _build.rq_args(plan.final_fmt.frac_bits, out_fmt)
        plan._kernel_cache[key] = (ctypes.c_int * len(p))(*p)
    return plan._kernel_cache[key]


# The tail modes that K2h's tensor-core kernel has compiled instantiations
# for, in csrc/tree_gemm_hybrid_mma.cuh's K2H_MODES order after its
# run-time entry 0: (round mode of every tail merge, overflow mode of tree
# level L's merge, overflow mode of the merges above).  The first is the JAX
# package's hybrid configurations at k = 16t (every tail layer
# TRN::TCPL, SAT::ZERO); the second theirs at k = 8 mod 16 (s = 8: level
# L = 3 is the SAT::TCPL layer Qu<11,8>).
K2H_MODES = ((RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO,
              OverflowMode.SAT_ZERO),
             (RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL,
              OverflowMode.SAT_ZERO))


def k2h_modes(plan: HybridPlan, k: int) -> int:
    """The tensor-core K2h instantiation for ``plan`` at ``k``: 1 + the
    index in :data:`K2H_MODES` of the entry whose modes the tail's merges
    over the ``k // s`` block values have (tree level L's, then the levels
    above), or 0 (modes read at run time).  The drain's converts and the
    final requantize read their modes at run time in every
    instantiation."""
    levels = max((k // plan.s).bit_length(), 1)
    fmts = plan.merge_fmts[plan.level:plan.level + levels]
    for i, (rm, ovf0, ovf) in enumerate(K2H_MODES):
        if all(f.round_mode == rm for f in fmts) \
                and fmts[0].overflow_mode == ovf0 \
                and all(f.overflow_mode == ovf for f in fmts[1:]):
            return i + 1
    return 0


def k2h_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """Which K2h kernel takes ``a`` @ ``b`` on the card: "mma" (the
    tensor-core kernel, ``csrc/tree_gemm_hybrid_mma.cu``) for int8 x int8
    lanes, "imad" (``csrc/tree_gemm_hybrid.cu``, on int32 copies of both
    operands) when either lane is wider: the tensor cores take no s16 or
    s32 operand."""
    return "mma" if a.dtype == b.dtype == torch.int8 else "imad"


def _row_pitch(t: torch.Tensor):
    """``(tensor, row pitch in elements)`` with its rows contiguous: ``t``
    itself when they are, else a contiguous copy."""
    rows, cols = t.shape
    if (cols <= 1 or t.stride(1) == 1) and (rows <= 1
                                            or t.stride(0) >= cols):
        return t, t.stride(0) if rows > 1 else cols
    return t.contiguous(), cols


def tree_gemm_hybrid(a: torch.Tensor, b: torch.Tensor, plan: HybridPlan,
                     out_fmt: QFormat) -> torch.Tensor:
    """The hybrid tree GEMM ``a`` [M, K] @ ``b`` [K, N] of lane tensors
    under ``plan``, stored in ``torch_dtype_for(out_fmt)``: the same bits
    as :func:`tree_gemm` on ``plan_tree`` of the same configuration.

    CPU tensors take the plain version; CUDA tensors launch the K2h kernel
    of :func:`k2h_route`, and raise if it refuses them.
    ``tree_gemm_hybrid.launches`` counts launches of either kernel,
    ``tree_gemm_hybrid.mma_launches`` those of the tensor-core kernel and
    ``tree_gemm_hybrid.imad_launches`` those of the IMAD kernel;
    ``tree_gemm_hybrid.seen`` (``_build.record``) each launch's kernel and
    instantiation and its tail's modes.
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] \
            or a.shape[1] % plan.s:
        raise ValueError(f"need [M, K] @ [K, N] with {plan.s} | K, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in LANE_DTYPES or b.dtype not in LANE_DTYPES:
        raise TypeError(f"operands must be int8/int16/int32 lanes, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return tree_gemm_hybrid_plain(a, b, plan, out_fmt)
    if a.device.type != "cuda":
        raise ValueError(f"tree_gemm_hybrid runs on CUDA or CPU, not "
                         f"{a.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch_dtype_for(out_fmt), device=a.device)
    if m == 0 or n == 0:
        return out
    dev = a.device.index
    lib = _build.lib()
    params = _hybrid_params(plan, k, out_fmt)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if k2h_route(a, b) == "mma":
        a8, lda = _row_pitch(a)
        b8, ldb = _row_pitch(b)
        key = ("k2h_modes", k)
        if key not in plan._kernel_cache:
            plan._kernel_cache[key] = k2h_modes(plan, k)
        err = lib.qk_tree_gemm_hybrid_mma(
            dev, a8.data_ptr(), lda, b8.data_ptr(), ldb, out.data_ptr(), m,
            n, k, out.element_size(), params, plan._kernel_cache[key],
            stream)
        _build.check(err, "tree_gemm_hybrid (tensor-core kernel)")
        tree_gemm_hybrid.mma_launches += 1
        instance = f"mma_{plan._kernel_cache[key]}"
    else:
        # the IMAD kernel stages int32 slices: a widening copy of each
        # operand a call, inside the kernel's event-timed time
        a32 = a.to(torch.int32).contiguous()
        b32 = b.to(torch.int32).contiguous()
        err = lib.qk_tree_gemm_hybrid(
            dev, a32.data_ptr(), b32.data_ptr(), out.data_ptr(), m, n, k,
            out.element_size(), params, stream)
        _build.check(err, "tree_gemm_hybrid (IMAD kernel)")
        tree_gemm_hybrid.imad_launches += 1
        instance = "imad"
    tree_gemm_hybrid.launches += 1
    levels = max((k // plan.s).bit_length(), 1)
    _build.record(tree_gemm_hybrid, instance,
                  (*plan.merge_fmts[plan.level:plan.level + levels], out_fmt))
    return out


tree_gemm_hybrid.launches = 0
tree_gemm_hybrid.mma_launches = 0
tree_gemm_hybrid.imad_launches = 0
tree_gemm_hybrid.seen = Counter()
