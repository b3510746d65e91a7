"""P1: the tree GEMM's per-product work as a serial chain, on the card.

Hopper counterpart of the Pallas probe ``bench.py:_measured_chain_prods``
(``build``, ``pallas_call`` at ``bench.py:418``): on one [BM, BN] tile of
int32 raws, T dependent steps of the tree GEMM's building blocks,

    p = _product(plan, v, y);  v = _merge(plan, 0, p, p)

written G times.  The CUDA kernel is ``csrc/chain_probe.cuh`` (entry point
``qk_chain_probe`` in ``csrc/tree_gemm.cu``): ``P1_CHAINS`` chains a
thread, each in a register, x and y read once and the output stored once,
16 bytes at a time where the tile allows.  Plans whose product route,
product step and layer-0 merge step are those of an entry of
``tree_gemm.K2S_PLANS`` take an instantiation with those steps compiled in
(:func:`p1_plan`); every other plan reads them at run time.
:func:`measured_chain_prods` is bench.py's two-length difference, timed
with CUDA events, which cancels the launch and the store.

The TPU ran the G programs one after another (``dimension_semantics=
("arbitrary",)``); here all G x BM x BN chains run at once, so the rate is
that of 67M independent chains each T steps deep, not of one serial chain.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import _build
from ..qformat import QFormat
from .tree_gemm import (K2S_PLANS, ROUTES, TreePlan, _kernel_params, _merge,
                        _product)
from .widths import LANE_DTYPES

__all__ = ["chain_probe", "chain_probe_plain", "measured_chain_prods",
           "probe_tile", "p1_plan", "BM", "BN", "G", "T1", "T2",
           "P1_CHAINS", "P1_THREADS"]

BM, BN, G = 128, 256, 2048     # tile and program count (bench.py:401)
T1, T2 = 128, 16               # the two chain lengths (bench.py:452)

# Chains a thread and threads a block of P1's instantiation for plan index
# 0 (steps read at run time) and each entry of K2S_PLANS after it, as
# csrc/chain_probe.cuh has them: thread t of block b owns the chains of the
# P1_CHAINS[i] flat outputs from (b P1_THREADS[i] + t) P1_CHAINS[i].
P1_CHAINS = (1, 4)
P1_THREADS = (256, 256)


def chain_probe_plain(x: torch.Tensor, y: torch.Tensor, plan: TreePlan,
                      steps: int, programs: int) -> torch.Tensor:
    """Plain-torch P1: the chain on one tile with the tree GEMM's
    ``_product`` and ``_merge``, then the tile written ``programs`` times."""
    v = x.to(torch.int32)
    yv = y.to(torch.int32)
    for _ in range(steps):
        p = _product(plan, v, yv)
        v = _merge(plan, 0, p, p)
    return v.expand((programs,) + tuple(v.shape)).contiguous()


def p1_plan(plan: TreePlan) -> int:
    """P1's instantiation for ``plan``: 1 + the index in ``K2S_PLANS`` of
    the entry whose product route and step are the plan's and whose merge
    step is layer 0's, or 0 (every step read at run time).  P1 reads no
    other level, so the upper levels' steps do not matter, as they do for
    K2′'s ``k2s_plan``."""
    route = ROUTES.get(plan.prod_route)
    prod = _build.rq_args(plan.prod_frac, plan.mul_fmt)
    merge0 = _build.rq_args(plan.level_fmts[0].frac_bits, plan.merge_fmts[0])
    for i, entry in enumerate(K2S_PLANS):
        if (route, prod, merge0) == entry:
            return i + 1
    return 0


def _launch(x: torch.Tensor, y: torch.Tensor, plan: TreePlan, steps: int,
            programs: int, instance: int) -> torch.Tensor:
    """P1's kernel on CUDA tensors, instantiation ``instance`` (``p1_plan``'s
    index, or 0 for any plan); raises if it does not launch."""
    out = torch.empty((programs,) + tuple(x.shape), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    x32 = x.to(torch.int32).contiguous()
    y32 = y.to(torch.int32).contiguous()
    dev = x.device.index
    err = _build.lib().qk_chain_probe(
        dev, x32.data_ptr(), y32.data_ptr(), out.data_ptr(), x32.numel(),
        programs, steps, _kernel_params(plan, plan.final_fmt, 0), instance,
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "chain_probe")
    return out


def chain_probe(x: torch.Tensor, y: torch.Tensor, plan: TreePlan,
                steps: int, programs: int) -> torch.Tensor:
    """``steps`` dependent product + layer-0 merge steps on the tile ``x``
    against ``y`` (same shape, lane dtypes), as a [programs, *x.shape] int32
    tensor.

    CPU tensors take the plain version; CUDA tensors launch P1, the
    instantiation of :func:`p1_plan`.
    ``chain_probe.launches`` counts kernel launches, ``chain_probe.seen``
    (``_build.record``) each launch's instantiation and its steps' modes.
    """
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    if x.dtype not in LANE_DTYPES or y.dtype not in LANE_DTYPES:
        raise TypeError(f"operands must be int8/int16/int32 lanes, got "
                        f"{x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if steps < 0 or programs < 0:
        raise ValueError(f"steps {steps} and programs {programs} must be "
                         ">= 0")
    if x.device.type == "cpu":
        return chain_probe_plain(x, y, plan, steps, programs)
    if x.device.type != "cuda":
        raise ValueError(f"chain_probe runs on CUDA or CPU, not {x.device}")
    if "p1" not in plan._kernel_cache:
        plan._kernel_cache["p1"] = p1_plan(plan)
    out = _launch(x, y, plan, steps, programs, plan._kernel_cache["p1"])
    if out.numel():
        chain_probe.launches += 1
        _build.record(chain_probe, f"plan_{plan._kernel_cache['p1']}",
                      (plan.mul_fmt, plan.merge_fmts[0]))
    return out


chain_probe.launches = 0
chain_probe.seen = Counter()


def probe_tile(fmt: QFormat, device):
    """The [BM, BN] int32 tiles x, y of ``fmt`` raws that
    :func:`measured_chain_prods` chains, from ``RandomState(2)`` as
    bench.py makes them."""
    rng = np.random.RandomState(2)
    return tuple(torch.from_numpy(rng.randint(fmt.raw_min, fmt.raw_max + 1,
                                              (BM, BN), dtype=np.int64)
                                  .astype(np.int32)).to(device)
                 for _ in range(2))


def measured_chain_prods(fmt: QFormat, plan: TreePlan, device):
    """Products per second of the tree GEMM's per-product work, measured
    with P1 on the card as ``bench.py:_measured_chain_prods`` measures it:
    x, y of ``fmt`` raws from ``RandomState(2)``, chains of T1 and T2 steps
    over G programs, the minimum of three CUDA-event timings of each after
    one warm-up call, and BM x BN x G x (T1 - T2) products over the
    difference of the two times.  None where t1 <= t2, as bench.py returns.
    Launches P1 eight times."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"measured_chain_prods times the card; got "
                         f"{device}")
    x, y = probe_tile(fmt, device)

    def timed(steps):
        chain_probe(x, y, plan, steps, G)            # warm-up
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain_probe(x, y, plan, steps, G)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        return min(times)

    t1, t2 = timed(T1), timed(T2)
    if t1 <= t2:
        return None
    return BM * BN * G * (T1 - T2) / (t1 - t2)
