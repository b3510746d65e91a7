"""K2: the order-sensitive quantized tree GEMM on torch.

When products or tree layers round or saturate, the result depends on the
association order, so the reference's balanced-tree pairing (QuBLAS.h:
4960-4990), odd-tail converting assignments included, has to be replayed
exactly.  The planners (``TreePlan``, ``level_formats``, ``drain_ops``,
``plan_tree``) are copies of ``qublas_tpu/ops/tree_gemm.py:73-245``, pinned
to the originals by the CPU tests: the machine with the card has no JAX.

:func:`tree_gemm` is the Hopper counterpart of the Pallas kernels
``tree_gemm_blocked`` and ``tree_gemm_pallas``; its CUDA source is
``csrc/tree_gemm.cu``.  :func:`tree_gemm_plain` is ``tree_gemm_scan``'s
schedule as a Python loop over k-blocks on torch tensors: products of one
block, the in-block tree layers, a binary-carry slot stack over blocks, the
drain, the final requantize.  The kernel runs the same schedule per output
element.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from qublas_tpu.ops.widths import (
    Interval,
    requant_out_interval,
    route_mul,
    route_requant,
)
from qublas_tpu.qformat import QFormat, add_merge

from .. import _build
from .reduce import layer_format
from .wideint import requantize_i32, requantize_split_mul
from .widths import LANE_DTYPES, torch_dtype_for

__all__ = ["TreePlan", "plan_tree", "level_formats", "drain_ops",
           "tree_gemm", "tree_gemm_plain"]


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


def _product(plan: TreePlan, col, row):
    """Requantized outer product (one level-0 value)."""
    if plan.prod_route == "i32":
        return requantize_i32(col * row, plan.prod_frac, plan.mul_fmt)
    if plan.prod_route == "split":
        return requantize_split_mul(col, row, plan.prod_frac, plan.mul_fmt)
    raise NotImplementedError(
        "the 64-bit 'pair' product route is not yet ported (ROADMAP item 10)")


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


def tree_gemm_plain(a: torch.Tensor, b: torch.Tensor, plan: TreePlan,
                    out_fmt: QFormat) -> torch.Tensor:
    """Plain-torch K2: ``tree_gemm_scan``'s schedule as a Python loop over
    k-blocks, each block materialising its [blk, M, N] products."""
    a32 = a.to(torch.int32)
    b32 = b.to(torch.int32)
    k = a32.shape[1]
    blk = _block_size(k)
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


_OPS = {"seed": 0, "convert": 1, "add": 2}


def _kernel_params(plan: TreePlan, out_fmt: QFormat):
    """The plan as ``csrc/tree_gemm.cu:qk_tree_gemm``'s int32 parameters."""
    p = [int(plan.prod_route == "split"),
         _block_size(plan.k).bit_length() - 1,
         *_build.rq_args(plan.prod_frac, plan.mul_fmt),
         plan.levels]
    for l in range(plan.levels):
        p += _build.rq_args(plan.level_fmts[l].frac_bits, plan.merge_fmts[l])
    p.append(len(plan.drain))
    for op, l in plan.drain:
        p += [_OPS[op], l]
    p += _build.rq_args(plan.final_fmt.frac_bits, out_fmt)
    return (ctypes.c_int * len(p))(*p)


def tree_gemm(a: torch.Tensor, b: torch.Tensor, plan: TreePlan,
              out_fmt: QFormat) -> torch.Tensor:
    """The tree GEMM ``a`` [M, K] @ ``b`` [K, N] of lane tensors under
    ``plan``, stored in ``torch_dtype_for(out_fmt)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``tree_gemm.launches`` counts kernel launches.
    """
    if plan.prod_route == "pair":
        raise NotImplementedError(
            "the 64-bit 'pair' product route is not yet ported "
            "(ROADMAP item 10)")
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
        return tree_gemm_plain(a, b, plan, out_fmt)
    if a.device.type != "cuda":
        raise ValueError(f"tree_gemm runs on CUDA or CPU, not {a.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch_dtype_for(out_fmt), device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.lib()
    a32 = a.to(torch.int32).contiguous()
    b32 = b.to(torch.int32).contiguous()
    err = lib.qk_tree_gemm(a.device.index, a32.data_ptr(), b32.data_ptr(),
                           out.data_ptr(), m, n, k, out.element_size(),
                           _kernel_params(plan, out_fmt),
                           torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "tree_gemm")
    tree_gemm.launches += 1
    return out


tree_gemm.launches = 0
