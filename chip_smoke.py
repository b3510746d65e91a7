#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qublas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines:

1. build the kernels of ``qublas_tpu_torch/csrc`` (nvcc) and print the
   build time, the compiler's register/spill report and the card;
2. hold each kernel against its plain-torch version on the card, bit for
   bit (max |difference| 0), at the main paths' shapes, ragged shapes and
   every rounding x overflow mode: K1 (fused int8 GEMM, and ``int_dot``,
   its identity epilogue), K2 (tree GEMM), K2′ (tree GEMM, one-pass
   schedule: its tile edges, both product routes, both stack depths, its
   compiled and run-time instantiations, operands that take the pitched
   copy), K3 (tree reduce: any n, odd tails, int8/int16/int32 lanes,
   an out-of-range raw at the odd tail; its warp, thread and columns
   kernels, each instantiation with compiled modes, rows whose base is off
   16 bytes) and P1 (the per-product chain
   probe: its compiled and run-time instantiations, split and i32 product
   routes, 0 to 17 steps, a ragged tile off 16 bytes, and
   ``measured_chain_prods``' tile at both chain lengths over all 2048
   programs); and K2, K2′ and P1 on the 64-bit "pair" product route in
   every mode, at ragged shapes and both of K2's stack depths;
3. drive the main paths through the public entry points, each with the
   launch counts set to 0 just before it and read just after:
   a. the quantized GEMM pipeline (``QuantPipeline``: GEMM -> sqrt ROM ->
      cast -> GEMM) at 4096^3 and the canonical order-sensitive ``qgemul``
      at 2048^3: K1 twice, K2 once;
   b. ``qreduce`` of BASELINE config 2 at [4096, 1024], and the layered
      canonical GEMM at 512^3 (``qcast(qreduce(qmul(a[:, :, None],
      b[None]), (), axis=1))``) beside ``tree_gemm_stream`` and ``qgemul``
      on the same operands: K3 twice, K2′ once, K2 once; the three GEMMs
      must agree bit for bit;
   c. the elementwise ops at 4096x4096 on the card against the same ops on
      CPU copies (plain torch ops, no kernel);
   d. the complex GEMM of BASELINE config 5 (``cgemul``, TF and Basic) at
      2048^3: K1 four times each; the order-sensitive complex GEMM at 512^3
      on the layered path: K3 twice; config 5 at 256^3 equal to the
      layered path, and a 64x64 block of its output through a BitStream
      round trip;
   e. ``measured_chain_prods`` of the canonical plan (bench.py's two-length
      difference): P1 eight times, on the instantiation with the plan's
      steps compiled in;
   f. pair storage (33..64-bit formats in int64) and the 64-bit product
      route, at 2048^3: f1 ``qgemul`` on ``Qu<12,12,TRN::TCPL,SAT::ZERO>``
      (50-bit products: K2 once, K2′ on the same operands bit for bit); f2
      the lossless wide tier (``Qu<5,8>`` operands, a dot wider than int32,
      outputs in a lane and in a pair: K1's ``int_dot`` once a segment);
      f3 Q16.16 throughout and f4 full-precision ``Qu<16,16>`` products in
      int64, both on the streaming tier (plain torch); the pair elementwise
      ops and a pair ``qreduce`` at 4096x4096 against CPU copies;
   every result is checked against the plain versions, and 16x16 corners
   against the exact host golden model (``hostops``);
4. time each kernel and its plain version (CUDA events, median of 10 runs
   after warm-up) beside its bound and, where one exists, the PyTorch call
   computing the same function, and the main-path calls end to end; K2′
   and K3 also by their device time (a profiler trace) and the host's
   time to enqueue a call, K2′ beside K2 and with its instantiations'
   registers and spills; P1 by its device time too, with
   ``vs_serial_chain`` (K2's rate over P1's) and K2′'s rate over P1's, and
   its instantiations' registers; K2 and K2′ on the pair route at 2048^3,
   P1 on it at ``measured_chain_prods``' shapes, and the wall times of
   paths f1-f4.

The second-to-last line is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time
from contextlib import contextmanager

# main-path sizes
PIPE_N = 4096                     # x, W1, W2: PIPE_N x PIPE_N
TREE_N = 2048                     # canonical qgemul: TREE_N^3
REDUCE_SHAPE = (4096, 1024)       # BASELINE config 2, reduced over axis 1
REDUCE_BIG_ROWS = 131072          # K3 timed at [REDUCE_BIG_ROWS, 1024]
LAYERED_N = 512                   # layered canonical GEMM: LAYERED_N^3
EW_N = 4096                       # elementwise ops: EW_N x EW_N
CPLX_N = 2048                     # config 5 complex GEMM: CPLX_N^3
CPLX_LAYERED_N = 256              # config 5 against its layered path
BITS_BLOCK = 64                   # BitStream round trip of a 64x64 block
CORNER = 16                       # corner checked against the host model
PAIR_N = 2048                     # pair-storage paths f1-f4: PAIR_N^3

# peak rates of one H100 SXM at its 700 W limit: HBM bytes/s and int8
# tensor-core ops/s (NVIDIA's data sheet), and int32 ops/s at the rate the
# SMs issue instructions: 132 SMs x 4 schedulers x 32 lanes (one warp
# instruction a cycle each; integer multiply-adds and adds run on the
# 128-lane FMA pipe beside the 64 INT32 lanes, Hopper white paper) x 1.98
# GHz boost clock
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
INT32_OPS_S = 132 * 128 * 1.98e9


def ptxas_report(log: str):
    """The build log's per-kernel lines: each kernel's name, then ptxas's
    registers / shared memory and its stack / spill line, and each source's
    compile time."""
    lines, names = [], []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            names.append(line.split("'")[1])
            lines.append(names[-1])
        elif "registers" in line or "spill stores" in line \
                or "done at" in line:
            lines.append("  " + line.split(":", 1)[-1].strip()
                         if "registers" in line else "  " + line.strip())
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        plain = dict(zip(names, res.stdout.splitlines()))
    except (OSError, subprocess.SubprocessError):
        plain = {}
    def short(name):
        name = plain.get(name, name).replace("(anonymous namespace)::", "")
        return name.split("(")[0].replace("void ", "")

    return [short(x) if x in names else x for x in lines]


def resources(report, name):
    """ptxas's register and spill lines of the kernels in ``report``
    (``ptxas_report``'s list) whose name contains ``name``."""
    out, cur = [], None
    for line in report:
        if not line.startswith("  "):
            cur = line if name in line else None
        elif cur is not None and "done at" not in line:
            out.append(f"{cur}: {line.strip()}")
    return out


def rand_raws(rng, fmt, shape, dtype):
    return rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape).astype(dtype)


def check_launches(what, got, want):
    assert got == want, f"{what}: launches {got}, expected {want}"


class Checker:
    """Bit-exact comparisons, with the largest |difference| per kernel."""

    def __init__(self):
        self.max_err = {}

    def same(self, kernel, what, got, ref):
        import torch

        g = got.data if hasattr(got, "fmt") else got
        r = ref.data if hasattr(ref, "fmt") else ref
        if hasattr(got, "fmt") and hasattr(ref, "fmt"):
            assert got.fmt == ref.fmt, (what, got.fmt, ref.fmt)
        assert g.shape == r.shape and g.dtype == r.dtype, \
            (what, g.shape, r.shape, g.dtype, r.dtype)
        err = int((g.long() - r.long()).abs().max().item()) if g.numel() else 0
        self.max_err[kernel] = max(self.max_err.get(kernel, 0), err)
        assert torch.equal(g, r), f"{what}: max |kernel - plain| = {err}"
        print(f"  {kernel} == plain: {what}")


def formats():
    """The formats of the main paths."""
    import qublas_tpu_torch as qt

    f88z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
    f44 = qt.qformat(4, 4)
    config2 = (qt.qformat(5, 3, round_mode=qt.RoundMode.RND_CONV,
                          overflow_mode=qt.OverflowMode.SAT_ZERO),
               qt.qformat(6, 2))
    return f88z, f44, config2


def phase_kernels(dev, chk):
    """Phase 2: each kernel against its plain version on the card."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.chain_probe import _launch as p1_launch
    from qublas_tpu_torch.ops.chain_probe import (BM, BN, G, T1, T2,
                                                  chain_probe,
                                                  chain_probe_plain, p1_plan,
                                                  probe_tile)
    from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm_plain,
                                                 int_dot, int_dot_plain,
                                                 k1_route, kmajor)
    from qublas_tpu_torch.ops.reduce import (k3_route, plan_reduce,
                                             qreduce_kernel, qreduce_plain)
    from qublas_tpu_torch.ops.tree_gemm import (k2_modes, k2s_operand,
                                                k2s_plan, plan_tree,
                                                tree_gemm, tree_gemm_plain,
                                                tree_gemm_stream,
                                                tree_gemm_stream_plain)

    rng = np.random.RandomState(7)
    fa, wide, mid = qt.pipeline_formats()

    def k1_case(what, fa_, wide_, out, m, k, n, dtype):
        a = qt.from_raw(rand_raws(rng, fa_, (m, k), dtype), fa_, dev)
        b = qt.from_raw(rand_raws(rng, fa_, (k, n), dtype), fa_, dev)
        plan = qt.exact_plan(fa_, fa_, qt.mul_merge(fa_, fa_, wide_),
                             (wide_,), k)
        got = qt.qgemul(a, b, out, mul_to=wide_, add_formats=(wide_,))
        ref = qt.QTensor(fused_int8_gemm_plain(a.data, b.data, plan.prod_frac,
                                               out), out)
        chk.same("fused_int8_gemm", what, got, ref)

    n = PIPE_N
    k1_case(f"headline {n}^3", fa, wide, mid, n, n, n, np.int8)
    k1_case("ragged 1000x777x1003", fa, wide, mid, 1000, 777, 1003, np.int8)
    f16 = qt.qformat(7, 4)
    k1_case("int32-operand Qu<7,4> 300x256x300", f16, qt.qformat(24, 8),
            qt.qformat(7, 4, overflow_mode=qt.OverflowMode.SAT_ZERO),
            300, 256, 300, np.int16)
    for rm in qt.RoundMode:
        for om in qt.OverflowMode:
            for signed in (True, False):
                out = qt.qformat(3, 2, signed, rm, om)
                k1_case(f"70x96x50 -> {out}", fa, wide, out, 70, 96, 50,
                        np.int8)
    k1_case("left-shift epilogue 70x96x50 -> Qu<8,10>", fa, wide,
            qt.qformat(8, 10), 70, 96, 50, np.int8)
    # the tensor-core route's edges: one past and one short of the 128 x
    # 128 output tile, 1x1x1, K that TMA reads in place, K that takes the
    # zero-padded copy (K1's wrapper, k1_route)
    for m, k, n in ((129, 256, 127), (127, 256, 129),
                    (1, 1, 1), (130, 16, 129), (130, 32, 129),
                    (130, 48, 129), (130, 4112, 129), (130, 1, 129),
                    (130, 777, 129), (130, 1003, 129)):
        k1_case(f"tile edge {m}x{k}x{n}", fa, wide, mid, m, k, n, np.int8)

    f88z, f44, config2 = formats()
    layered = (qt.qformat(9, 6, round_mode=qt.RoundMode.RND_CONV),
               qt.qformat(10, 4))

    def k2_case(what, m, k, n, layers=()):
        a = qt.from_raw(rand_raws(rng, f88z, (m, k), np.int32), f88z, dev)
        b = qt.from_raw(rand_raws(rng, f88z, (k, n), np.int32), f88z, dev)
        plan = plan_tree(f88z, f88z, qt.mul_merge(f88z, f88z), layers, k,
                         f88z)
        got = qt.qgemul(a, b, f88z, add_formats=layers)
        ref = qt.QTensor(tree_gemm_plain(a.data, b.data, plan, f88z), f88z)
        chk.same("tree_gemm", what, got, ref)
        got = tree_gemm_stream(a.data, b.data, plan, f88z)
        ref = tree_gemm_stream_plain(a.data, b.data, plan, f88z)
        chk.same("tree_gemm_stream", what, got, ref)

    k2_case(f"canonical Qu<8,8,SAT::ZERO> {LAYERED_N}^3", LAYERED_N,
            LAYERED_N, LAYERED_N)
    k2_case("k=1000 (drain converts and adds) 200x1000x300", 200, 1000, 300)
    k2_case("ragged m, n 77x96x45", 77, 96, 45)
    k2_case("odd k 33x13x17", 33, 13, 17)
    k2_case("layered formats 128x128x128", 128, 128, 128, layered)

    # K2's tile edges (a block computes 32 x 16 outputs for k < 4096,
    # 16 x 16 beyond, a thread 2 x 1 or 1 x 1), k around its 16-deep
    # slices, both product routes, both instantiations (k2_modes)
    i32f = qt.qformat(3, 4, round_mode=qt.RoundMode.RND_CONV,
                      overflow_mode=qt.OverflowMode.WRP_TCPL)

    def k2_edge(f, layers, m, k, n):
        a = torch.from_numpy(rand_raws(rng, f, (m, k), np.int32)).to(dev)
        b = torch.from_numpy(rand_raws(rng, f, (k, n), np.int32)).to(dev)
        plan = plan_tree(f, f, qt.mul_merge(f, f), layers, k, f)
        chk.same("tree_gemm", f"{plan.prod_route} route, modes "
                 f"{k2_modes(plan)}, {'layered ' if layers else ''}"
                 f"{m}x{k}x{n}", tree_gemm(a, b, plan, f),
                 tree_gemm_plain(a, b, plan, f))

    # K2′ the same way: its 64 x 16 tile (32 x 16 for plans read at run
    # time, 16 x 16 from k = 4096), k around its 32-deep slices, both
    # product routes, both plan instantiations (k2s_plan), both stack
    # depths; k or n off a multiple of 4 and views off 16 bytes take the
    # pitched copy (k2s_operand)
    def k2s_edge(f, layers, m, k, n, view=0):
        a = torch.from_numpy(rand_raws(rng, f, (m, k + view), np.int32))
        b = torch.from_numpy(rand_raws(rng, f, (k + view, n), np.int32))
        a, b = a.to(dev)[:, view:], b.to(dev)[view:]
        plan = plan_tree(f, f, qt.mul_merge(f, f), layers, k, f)
        copies = [k2s_operand(t)[0].data_ptr() != t.data_ptr()
                  for t in (a, b)]
        chk.same("tree_gemm_stream", f"{plan.prod_route} route, plan "
                 f"{k2s_plan(plan)}, {'layered ' if layers else ''}"
                 f"{m}x{k}x{n}{f' (views at {view})' if view else ''}, "
                 f"pitched copies of A, B {copies}",
                 tree_gemm_stream(a, b, plan, f),
                 tree_gemm_stream_plain(a, b, plan, f))

    for m, n in ((1, 1), (63, 65), (65, 63), (200, 200)):
        for k in (1, 13, 16, 17, 1000, 2048):
            k2_edge(f88z, (), m, k, n)
            k2s_edge(f88z, (), m, k, n)
    # k from 4096 takes the 32-deep stack, with either instantiation
    for k in (13, 1000, 4112):
        k2_edge(i32f, (), 63, k, 65)
        k2_edge(f88z, layered, 65, k, 63)
        k2s_edge(i32f, (), 63, k, 65)
        k2s_edge(f88z, layered, 65, k, 63)
    k2_edge(f88z, (), 65, 4112, 63)
    k2s_edge(f88z, (), 65, 4112, 63)
    k2s_edge(f88z, (), 70, 256, 92, view=1)
    k2s_edge(f88z, (), 70, 256, 92, view=4)

    def k3_check(what, x, layers, fmt, axis, route):
        plan = plan_reduce(fmt, layers, x.shape[axis])
        assert plan is not None, what
        got_route = k3_route(x, axis, plan) + (plan.modes,)
        if route is not None:
            assert got_route == route, (what, got_route, route)
        got = qreduce_kernel(x, axis, plan)
        ref = qreduce_plain(x, axis, plan)
        chk.same("qreduce_kernel", f"{what}, (kernel, S, modes) {got_route}",
                 got, ref)

    def k3_case(what, fmt, layers, shape, axis, dtype, tail=None, offset=0,
                route=None):
        x = rand_raws(rng, fmt, shape, np.int64)
        if tail is not None:
            x[..., -1] = tail          # the odd tail of every row
        x = torch.from_numpy(x.astype(dtype))
        # a storage offset moves the rows' base off 16 bytes
        flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        flat[offset:] = x.reshape(-1).to(dev)
        k3_check(what, flat[offset:].view(shape), layers, fmt, axis, route)

    # (kernel, S, modes): ops.reduce.k3_route and k3_modes; the main paths'
    # shapes take the instantiations with their modes compiled in
    r0, r1 = REDUCE_SHAPE
    k3_case(f"config 2 [{r0}, {r1}] axis 1", f44, config2, REDUCE_SHAPE, 1,
            np.int8, route=("warp", 32, 1))
    k3_case(f"config 2 [{r0}, {r1}] axis 0", f44, config2, REDUCE_SHAPE, 0,
            np.int8, route=("columns", 0, 1))
    gen = torch.Generator(device=dev).manual_seed(6)
    big = torch.randint(-128, 128, (REDUCE_BIG_ROWS, r1), generator=gen,
                        device=dev, dtype=torch.int8)
    k3_check(f"config 2 [{REDUCE_BIG_ROWS}, {r1}] axis 1", big, config2, f44,
             1, ("warp", 32, 1))
    del big
    k3_case("Qu<3,4,SAT::ZERO>, no layer formats [300, 1024]",
            qt.qformat(3, 4, overflow_mode=qt.OverflowMode.SAT_ZERO), (),
            (300, 1024), 1, np.int8, route=("warp", 32, 2))
    k3_case(f"canonical Qu<8,8,SAT::ZERO> columns [8, {LAYERED_N}, 64]",
            f88z, (), (8, LAYERED_N, 64), 1, np.int32,
            route=("columns", 0, 2))
    k3_case("Qu<4,4>, no layer formats, columns [4, 512, 33] (modes read "
            "at run time)", f44, (), (4, 512, 33), 1, np.int8,
            route=("columns", 0, 0))
    for off, s in ((1, 1), (2, 2), (4, 4), (8, 8), (16, 32)):
        k3_case(f"config 2 [300, 1024], rows {off} bytes past 32", f44,
                config2, (300, 1024), 1, np.int8, offset=off,
                route=("warp", s, 1))
    k3_case("int16 lanes Qu<7,4> [40, 2048], rows 2 bytes off 16",
            qt.qformat(7, 4), config2, (40, 2048), 1, np.int16, offset=1,
            route=("warp", 1, 1))
    k3_case("int32 lanes Qu<20,8> -> Qu<26,2> [5, 1024], rows 8 bytes off "
            "16", qt.qformat(20, 8), (qt.qformat(26, 2),), (5, 1024), 1,
            np.int32, offset=2, route=("warp", 2, 0))
    k3_case("int16 lanes Qu<7,4> [40, 2048]", qt.qformat(7, 4), config2,
            (40, 2048), 1, np.int16, route=("warp", 16, 1))
    k3_case("int32 lanes Qu<20,8> -> Qu<26,2> [5, 1024]", qt.qformat(20, 8),
            (qt.qformat(26, 2),), (5, 1024), 1, np.int32,
            route=("warp", 8, 0))
    k3_case("config 2 [3, 262144] (the 32-deep stack)", f44, config2,
            (3, 1 << 18), 1, np.int8, route=("warp", 32, 1))
    for n3 in (3, 13, 1000):
        k3_case(f"config 2 n={n3} rows [300, {n3}]", f44, config2,
                (300, n3), 1, np.int8, route=("thread", 0, 1))
        k3_case(f"config 2 n={n3} columns [4, {n3}, 45]", f44, config2,
                (4, n3, 45), 1, np.int8, route=("columns", 0, 1))
    for n3, s in ((96, 1), (512, 16)):
        k3_case(f"config 2 n={n3} rows [300, {n3}]", f44, config2,
                (300, n3), 1, np.int8, route=("warp", s, 1))
    k3_case("batch 77 (not a multiple of 32) n=1000", f44, config2,
            (77, 1000), 1, np.int8)
    k3_case("int16 lanes Qu<7,4> [300, 24]", qt.qformat(7, 4), config2,
            (300, 24), 1, np.int16)
    k3_case("int32 lanes Qu<20,8> -> Qu<26,2> [5, 1000, 3]",
            qt.qformat(20, 8), (qt.qformat(26, 2),), (5, 1000, 3), 1,
            np.int32)
    k3_case("no layer formats [300, 13]", f44, (), (300, 13), 1, np.int8)
    smgn = qt.qformat(3, 4, overflow_mode=qt.OverflowMode.SAT_SMGN)
    k3_case("SAT::SMGN, raw -128 at the odd tail [64, 13]", smgn, (),
            (64, 13), 1, np.int8, tail=smgn.raw_min)
    k3_case("Qu<3,4>, raw 300 (int16 lane) at the odd tail [64, 13]",
            qt.qformat(3, 4), (), (64, 13), 1, np.int16, tail=300)
    # every mode pair on the thread kernel and on the warp kernel (read at
    # run time, or compiled in where the pair is K3_MODES')
    for rm in qt.RoundMode:
        for om in qt.OverflowMode:
            for signed in (True, False):
                lf = qt.qformat(5, 2, signed, rm, om)
                for n3, s in ((13, 0), (96, 1), (1024, 32)):
                    k3_case(f"[100, {n3}] -> {lf}", f44, (lf,), (100, n3), 1,
                            np.int8,
                            route=("warp" if s else "thread", s,
                                   2 if (rm, om) == (qt.RoundMode.TRN_TCPL,
                                                     qt.OverflowMode.SAT_ZERO)
                                   else 0))

    # P1 at each instantiation (p1_plan): the canonical plan's compiled
    # steps, a split-route and an i32-route plan read at run time; chains of
    # 0, 1, 16 and 17 steps on 4 programs (the vector path), a ragged tile
    # whose bases are off 16 bytes (the scalar path), and
    # measured_chain_prods' tile, chain lengths and G, the canonical plan
    # also through the run-time instantiation (a launch of its own, not
    # counted)
    rconv = qt.qformat(8, 8, round_mode=qt.RoundMode.RND_CONV,
                       overflow_mode=qt.OverflowMode.SAT_ZERO)
    for what, f, route, inst in (("compiled", f88z, "split", 1),
                                 ("run-time", rconv, "split", 0),
                                 ("run-time", i32f, "i32", 0)):
        plan = plan_tree(f, f, qt.mul_merge(f, f), (), TREE_N, f)
        assert (plan.prod_route, p1_plan(plan)) == (route, inst), what
        label = f"{what} (instantiation {inst}) {route} route {f}"
        x = torch.from_numpy(rand_raws(rng, f, (BM, BN), np.int32)).to(dev)
        y = torch.from_numpy(rand_raws(rng, f, (BM, BN), np.int32)).to(dev)
        for steps in (0, 1, 16, 17):
            chk.same("chain_probe", f"{label} T={steps}, 4 programs of "
                     f"[{BM}, {BN}]", chain_probe(x, y, plan, steps, 4),
                     chain_probe_plain(x, y, plan, steps, 4))
        flat = torch.from_numpy(rand_raws(rng, f, (2 * 92,), np.int32))
        flat = flat.to(dev)
        xr, yr = flat[1:92].view(13, 7), flat[93:].view(13, 7)
        chk.same("chain_probe", f"{label} T=17, 5 programs of a ragged "
                 f"[13, 7] tile, bases 4 bytes off 16",
                 chain_probe(xr, yr, plan, 17, 5),
                 chain_probe_plain(xr, yr, plan, 17, 5))
    plan = plan_tree(f88z, f88z, qt.mul_merge(f88z, f88z), (), TREE_N, f88z)
    xp, yp = probe_tile(f88z, dev)
    for steps in (T1, T2):
        want = chain_probe_plain(xp, yp, plan, steps, G)
        chk.same("chain_probe", f"measured_chain_prods' tile T={steps}, {G} "
                 f"programs of [{BM}, {BN}]", chain_probe(xp, yp, plan,
                                                          steps, G), want)
        chk.same("chain_probe", f"measured_chain_prods' tile T={steps} "
                 f"through the run-time instantiation",
                 p1_launch(xp, yp, plan, steps, G, 0), want)
        del want
    del xp, yp

    # K2, K2′ and P1 on the 64-bit "pair" product route: 25-bit by 15-bit
    # lanes, products requantized in every mode pair into a 25-bit mul
    # format, the layers saturating (WRP_TCPL_SAT layers would outgrow
    # int32); ragged shapes, K2's 8-level stack (k = 37, 1000) and 32-level
    # stack (k = 4112), its instantiation with the modes and the 64-bit
    # product compiled in where the modes are (TRN::TCPL, SAT::ZERO)
    # (k2_modes 2); K2′'s one-product slot stack at k = 4112
    # for two mode pairs (its plain version is a loop over k)
    wrap_sat = qt.OverflowMode.WRP_TCPL_SAT
    deep = ((qt.RoundMode.TRN_TCPL, qt.OverflowMode.SAT_ZERO),
            (qt.RoundMode.RND_CONV, qt.OverflowMode.WRP_TCPL))
    for rm in qt.RoundMode:
        for om in qt.OverflowMode:
            sat = qt.OverflowMode.SAT_TCPL if om == wrap_sat else om
            fa12 = qt.qformat(12, 12, round_mode=rm, overflow_mode=sat)
            fb12 = qt.qformat(2, 12, round_mode=rm, overflow_mode=sat)
            mul = qt.qformat(12, 12, round_mode=rm, overflow_mode=om)
            lay = (qt.qformat(13, 12, round_mode=rm, overflow_mode=sat),)
            out = qt.qformat(9, 5, False, rm, om)
            for m, k, n in ((33, 37, 17), (65, 1000, 63), (63, 4112, 65)):
                a = torch.from_numpy(rand_raws(rng, fa12, (m, k),
                                               np.int32)).to(dev)
                b = torch.from_numpy(rand_raws(rng, fb12, (k, n),
                                               np.int32)).to(dev)
                plan = plan_tree(fa12, fb12, mul, lay, k, out)
                assert plan.prod_route == "pair" and k2s_plan(plan) == 0
                label = (f"pair route, product {rm.name}/{om.name}, modes "
                         f"{k2_modes(plan)}, {m}x{k}x{n}")
                chk.same("tree_gemm", label, tree_gemm(a, b, plan, out),
                         tree_gemm_plain(a, b, plan, out))
                if k < 4096 or (rm, om) in deep:
                    chk.same("tree_gemm_stream", label,
                             tree_gemm_stream(a, b, plan, out),
                             tree_gemm_stream_plain(a, b, plan, out))
            x = torch.from_numpy(rand_raws(rng, fa12, (16, 33),
                                           np.int32)).to(dev)
            y = torch.from_numpy(rand_raws(rng, fb12, (16, 33),
                                           np.int32)).to(dev)
            assert p1_plan(plan) == 0
            for steps in (1, 17):
                chk.same("chain_probe", f"pair route, product {rm.name}/"
                         f"{om.name}, T={steps}, 3 programs of [16, 33]",
                         chain_probe(x, y, plan, steps, 3),
                         chain_probe_plain(x, y, plan, steps, 3))

    for what, f, dtype in (("int8", fa, np.int8),
                           ("int16 lanes Qu<7,4>", f16, np.int16)):
        a = torch.from_numpy(rand_raws(rng, f, (1000, 777), dtype)).to(dev)
        b = torch.from_numpy(rand_raws(rng, f, (777, 1003), dtype)).to(dev)
        chk.same("fused_int8_gemm", f"int_dot {what} 1000x777x1003",
                 int_dot(a, b), int_dot_plain(a, b))
    # int_dot on B row-major and K-major, and views of a wider tensor: at
    # column 16 (TMA reads them in place) and at column 1 (one byte past
    # 16-byte alignment: a K-major copy)
    a = torch.from_numpy(rand_raws(rng, fa, (300, 544), np.int8)).to(dev)
    b = torch.from_numpy(rand_raws(rng, fa, (544, 301), np.int8)).to(dev)
    bk = kmajor(b)
    for what, x, y, routes in (
            ("B row-major 300x544x301", a, b, ("direct", "copy")),
            ("B K-major 300x544x301", a, bk, ("direct", "direct")),
            ("views at column 16, 300x528x301", a[:, 16:], bk[16:],
             ("direct", "direct")),
            ("views at column 1, 300x528x301", a[:, 1:529], bk[1:529],
             ("copy", "copy")),
            ("views at column 1, 300x527x301", a[:, 1:528], bk[1:528],
             ("padded", "padded"))):
        assert (k1_route(x), k1_route(y.t())) == routes, (what, routes)
        chk.same("fused_int8_gemm", f"int_dot {what}, routes {routes}",
                 int_dot(x, y), int_dot_plain(x, y))
    torch.cuda.synchronize()


def phase_main_path(dev, chk):
    """Phase 3a: the GEMM path through the public entry points."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm,
                                                 fused_int8_gemm_plain)
    from qublas_tpu_torch.ops.tree_gemm import (plan_tree, tree_gemm,
                                                tree_gemm_plain)

    fa, wide, mid = qt.pipeline_formats()
    n = PIPE_N
    rng = np.random.RandomState(0)
    x_np = rand_raws(rng, fa, (n, n), np.int8)
    w1_np = rand_raws(rng, fa, (n, n), np.int8)
    w2_np = rand_raws(rng, fa, (n, n), np.int8)
    pipe = qt.QuantPipeline.from_numpy(w1_np, w2_np, dev)
    x = torch.from_numpy(x_np).to(dev)
    f88z = formats()[0]
    rng = np.random.RandomState(1)
    a2 = qt.from_raw(rand_raws(rng, f88z, (TREE_N, TREE_N), np.int32), f88z,
                     dev)
    b2 = qt.from_raw(rand_raws(rng, f88z, (TREE_N, TREE_N), np.int32), f88z,
                     dev)
    torch.cuda.synchronize()

    fused_int8_gemm.launches = 0
    tree_gemm.launches = 0
    t0 = time.perf_counter()
    y = pipe(x)
    c = qt.qgemul(a2, b2, f88z)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_int8_gemm": fused_int8_gemm.launches,
                "tree_gemm": tree_gemm.launches}
    print(f"main path a: pipeline {n}^3 + canonical qgemul {TREE_N}^3 in "
          f"{wall * 1e3:.3f} ms wall (first call), launches {launches}")
    check_launches("main path a", launches,
                   {"fused_int8_gemm": 2, "tree_gemm": 1})

    assert y.shape == (n, n) and y.dtype == torch.int8, (y.shape, y.dtype)
    assert int(y.min()) >= mid.raw_min and int(y.max()) <= mid.raw_max
    assert c.shape == (TREE_N, TREE_N) and c.data.dtype == torch.int32
    assert c.fmt == f88z

    # the same computation through the plain versions, on the card
    plan1 = qt.exact_plan(fa, fa, qt.mul_merge(fa, fa, wide), (wide,), n)
    h1 = qt.QTensor(fused_int8_gemm_plain(x, pipe.w1, plan1.prod_frac, mid),
                    mid)
    h = pipe.table(h1).astype(fa)
    y_ref = fused_int8_gemm_plain(h.data, pipe.w2, plan1.prod_frac, mid)
    chk.same("fused_int8_gemm", f"pipeline {n}^3 output", y, y_ref)
    tplan = plan_tree(f88z, f88z, qt.mul_merge(f88z, f88z), (), TREE_N, f88z)
    c_ref = qt.QTensor(tree_gemm_plain(a2.data, b2.data, tplan, f88z), f88z)
    chk.same("tree_gemm", f"canonical qgemul {TREE_N}^3", c, c_ref)

    # corners against the exact host golden model (hostops.qgemul)
    cn = CORNER
    xq = qt.QTensor(x, fa)
    w1q = qt.QTensor(pipe.w1, fa)
    w2q = qt.QTensor(pipe.w2, fa)
    host = qt.host_qgemul(xq[:cn], w1q[:, :cn], mid, mul_to=wide,
                          add_formats=(wide,))
    assert np.array_equal(h1.raw()[:cn, :cn], host), "GEMM 1 corner vs host"
    host = qt.host_qgemul(h[:cn], w2q[:, :cn], mid, mul_to=wide,
                          add_formats=(wide,))
    assert np.array_equal(y.cpu().numpy()[:cn, :cn], host), \
        "GEMM 2 corner vs host"
    host = qt.host_qgemul(a2[:cn], b2[:, :cn], f88z)
    assert np.array_equal(c.raw()[:cn, :cn], host), "tree corner vs host"
    print(f"main path a: {cn}x{cn} corners of both pipeline GEMMs and the "
          "canonical tree equal hostops.qgemul")
    return launches, (x, pipe, plan1, mid, a2, b2, tplan, f88z)


def phase_reduce_path(dev, chk):
    """Phase 3b: Qreduce and the layered canonical GEMM through the public
    entry points."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import hostops
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.ops.reduce import (plan_reduce, qreduce_kernel,
                                             qreduce_plain)
    from qublas_tpu_torch.ops.tree_gemm import (plan_tree, tree_gemm,
                                                tree_gemm_stream)

    f88z, f44, config2 = formats()
    rng = np.random.RandomState(2)
    # int8 lanes, as bench.py:bench_reduce feeds config 2
    x_np = rand_raws(rng, f44, REDUCE_SHAPE, np.int8)
    x = qt.QTensor(torch.from_numpy(x_np).to(dev), f44)
    ln = LAYERED_N
    a3 = qt.from_raw(rand_raws(rng, f88z, (ln, ln), np.int32), f88z, dev)
    b3 = qt.from_raw(rand_raws(rng, f88z, (ln, ln), np.int32), f88z, dev)
    splan = plan_tree(f88z, f88z, qt.mul_merge(f88z, f88z), (), ln, f88z)
    torch.cuda.synchronize()

    counters = (fused_int8_gemm, tree_gemm, tree_gemm_stream, qreduce_kernel)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    r = qt.qreduce(x, config2, axis=1)
    prod = qt.qmul(qt.QTensor(a3.data[:, :, None], f88z),
                   qt.QTensor(b3.data[None], f88z))
    layered = qt.qcast(qt.qreduce(prod, (), axis=1), f88z)
    stream = tree_gemm_stream(a3.data, b3.data, splan, f88z)
    c3 = qt.qgemul(a3, b3, f88z)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"main path b: qreduce {list(REDUCE_SHAPE)} + layered GEMM, "
          f"tree_gemm_stream and qgemul at {ln}^3 in {wall * 1e3:.3f} ms "
          f"wall (first call), launches {launches}")
    check_launches("main path b", launches,
                   {"fused_int8_gemm": 0, "tree_gemm": 1,
                    "tree_gemm_stream": 1, "qreduce_kernel": 2})

    assert r.shape == (REDUCE_SHAPE[0],) and r.fmt == config2[1]
    assert r.data.dtype == torch.int16
    r_plan = plan_reduce(f44, config2, REDUCE_SHAPE[1])
    chk.same("qreduce_kernel", f"qreduce config 2 {list(REDUCE_SHAPE)}",
             r.data, qreduce_plain(x.data, 1, r_plan))
    plan = plan_reduce(f88z, (), ln)
    chk.same("qreduce_kernel", f"layered GEMM's reduce [{ln}]*3 axis 1",
             qt.qreduce(prod, (), axis=1).data,
             qreduce_plain(prod.data, 1, plan))
    chk.same("tree_gemm_stream", f"tree_gemm_stream == qgemul {ln}^3",
             stream, c3.data)
    chk.same("qreduce_kernel", f"layered GEMM == qgemul {ln}^3", layered,
             c3)
    print(f"main path b: layered GEMM, tree_gemm_stream and qgemul agree "
          f"bit for bit at {ln}^3")

    cn = CORNER
    for i in range(cn):
        raw, fmt = hostops.qreduce_list([(int(v), f44) for v in x_np[i]],
                                        config2)
        assert fmt == r.fmt and raw == int(r.data[i]), ("qreduce row", i)
    host = qt.host_qgemul(a3[:cn], b3[:, :cn], f88z)
    assert np.array_equal(layered.raw()[:cn, :cn], host), "layered vs host"
    print(f"main path b: {cn} rows of qreduce equal hostops.qreduce_list, "
          f"the {cn}x{cn} corner of the layered GEMM hostops.qgemul")
    return launches, (x, r_plan, prod, plan, a3, b3, splan, f88z)


def phase_elementwise(dev):
    """Phase 3c: the elementwise ops on the card against CPU copies and the
    host golden model."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import hostops

    f88z = formats()[0]
    fb = qt.qformat(4, 6, round_mode=qt.RoundMode.RND_CONV)
    rng = np.random.RandomState(3)
    b_np = rand_raws(rng, fb, (EW_N, EW_N), np.int16)
    b_np[::7, ::3] = 0                       # divide by zero -> 0
    a = qt.from_raw(rand_raws(rng, f88z, (EW_N, EW_N), np.int32), f88z, dev)
    b = qt.from_raw(b_np, fb, dev)
    ac, bc = a.to("cpu"), b.to("cpu")
    cases = [
        ("qmul (i32 route)", qt.qmul, hostops.qmul, True),
        ("qmul (split route)", lambda x, y: qt.qmul(x, x),
         lambda u, v: hostops.qmul(u, u), True),
        ("qadd", qt.qadd, hostops.qadd, True),
        ("qsub", qt.qsub, hostops.qsub, True),
        ("qdiv", qt.qdiv, hostops.qdiv, True),
        ("qabs", lambda x, y: qt.qabs(y), lambda u, v: hostops.qabs(v), True),
        ("qneg", lambda x, y: qt.qneg(x), lambda u, v: hostops.qneg(u),
         True),
        ("qcmp", qt.qcmp, hostops.qcmp, False),
        ("qeq", qt.qeq, hostops.qeq, False),
        ("qcast", lambda x, y: qt.qcast(x, fb),
         lambda u, v: hostops.convert(u, fb), True),
    ]
    cn = CORNER
    ar, br = a.raw()[:cn, :cn], b.raw()[:cn, :cn]
    for what, op, host_op, is_q in cases:
        got, ref = op(a, b), op(ac, bc)
        gd, rd = (got.data, ref.data) if is_q else (got, ref)
        assert gd.device == a.device and gd.dtype == rd.dtype, what
        assert torch.equal(gd.cpu(), rd), f"{what}: card != CPU"
        corner = gd[:cn, :cn].cpu().numpy()
        for i in range(cn):
            for j in range(cn):
                h = host_op((int(ar[i, j]), a.fmt), (int(br[i, j]), b.fmt))
                if is_q:
                    assert h[1] == got.fmt and h[0] == int(corner[i, j]), \
                        (what, i, j)
                else:
                    assert int(h) == int(corner[i, j]), (what, i, j)
    torch.cuda.synchronize()
    print(f"main path c: {len(cases)} elementwise ops at {EW_N}x{EW_N} on "
          f"the card equal the CPU, their {cn}x{cn} corners hostops")


def config5():
    """BASELINE config 5 (``bench.py:598-625``): ``Qu<3,4>`` operands,
    ``Qu<5,4>`` operand sums, ``Qu<20,8>`` products, combines and layers,
    ``Qu<3,4,SAT::ZERO>`` output parts; the TF tags and the Basic tags of
    the same formats."""
    import qublas_tpu_torch as qt

    f, wide, mid = qt.qformat(3, 4), qt.qformat(20, 8), qt.qformat(5, 4)
    out = (qt.qformat(3, 4, overflow_mode=qt.OverflowMode.SAT_ZERO),) * 2
    tf = dict(ab=mid, cd=mid, ba=mid, abc=wide, cdb=wide, bad=wide, AB=wide,
              BC=wide)
    basic = dict(ac=wide, bd=wide, ad=wide, bc=wide, acbd=wide, adbc=wide)
    return f, wide, out, tf, basic


@contextmanager
def plain_dots():
    """The complex GEMM's and the wide GEMM tier's dots on ``int_dot``'s
    plain version (a float64 matmul on the card) while the block runs: the
    reference side of the K1 checks of phases 3d and 3f.  Fails if K1
    launched inside the block, so the reference cannot quietly run the
    kernel it is checking."""
    from qublas_tpu_torch.ops import cgemm, gemm
    from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm, int_dot,
                                                 int_dot_plain)

    cgemm.int_dot = gemm.int_dot = int_dot_plain
    fused_int8_gemm.launches = 0
    try:
        yield
    finally:
        cgemm.int_dot = gemm.int_dot = int_dot
    check_launches("plain-dot reference", fused_int8_gemm.launches, 0)


def host_cgemul(a, b, out, algo, add_formats, **tags):
    """Raws of the exact host golden model (``hostops.cgemul``) for the
    same complex call, as (real, imag) pairs, one Python-int product at a
    time."""
    from qublas_tpu_torch import hostops

    def rows(x):
        re, im = x.real.raw(), x.imag.raw()
        return [[((int(re[i, j]), x.real.fmt), (int(im[i, j]), x.imag.fmt))
                 for j in range(re.shape[1])] for i in range(re.shape[0])]

    c = hostops.cgemul(rows(a), rows(b), out, algo, add_formats, **tags)
    return [[(r[0], i[0]) for r, i in row] for row in c]


def phase_complex_path(dev, chk):
    """Phase 3d: the complex GEMM through the public entry points."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import bitstream
    from qublas_tpu_torch.ops import cgemm
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.ops.reduce import (plan_reduce, qreduce_kernel,
                                             qreduce_plain)
    from qublas_tpu_torch.ops.tree_gemm import tree_gemm, tree_gemm_stream

    f, wide, out, tf_kw, basic_kw = config5()
    f88z = formats()[0]
    n, ln = CPLX_N, LAYERED_N
    rng = np.random.RandomState(5)
    # int8 lanes in bench.py's order: ar, ai, br, bi
    parts = [rand_raws(rng, f, (n, n), np.int8) for _ in range(4)]
    a = qt.complex_from_raw(parts[0], parts[1], f, device=dev)
    b = qt.complex_from_raw(parts[2], parts[3], f, device=dev)
    a3 = qt.complex_from_raw(rand_raws(rng, f88z, (ln, ln), np.int32),
                             rand_raws(rng, f88z, (ln, ln), np.int32), f88z,
                             device=dev)
    b3 = qt.complex_from_raw(rand_raws(rng, f88z, (ln, ln), np.int32),
                             rand_raws(rng, f88z, (ln, ln), np.int32), f88z,
                             device=dev)
    torch.cuda.synchronize()

    calls = {
        "tf": (f"config 5 TF cgemul {n}^3", lambda x, y: qt.cgemul(
            x, y, out, algo="tf", add_formats=(wide,), **tf_kw)),
        "basic": (f"config 5 Basic cgemul {n}^3", lambda x, y: qt.cgemul(
            x, y, out, algo="basic", add_formats=(wide,), **basic_kw)),
        "ordered": (f"order-sensitive Qu<8,8,SAT::ZERO> Basic cgemul "
                    f"{ln}^3 (layered)",
                    lambda x, y: qt.cgemul(x, y, f88z, algo="basic")),
    }
    expect = {"tf": (4, 0), "basic": (4, 0), "ordered": (0, 2)}
    counters = (fused_int8_gemm, qreduce_kernel, tree_gemm, tree_gemm_stream)
    launches = {fn.__name__: 0 for fn in counters}
    res = {}
    for key, (label, call) in calls.items():
        x, y = (a3, b3) if key == "ordered" else (a, b)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        res[key] = call(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in counters}
        print(f"main path d: {label} in {wall * 1e3:.3f} ms wall (first "
              f"call), launches {got}")
        k1, k3 = expect[key]
        check_launches(f"main path d, {label}", got,
                       {"fused_int8_gemm": k1, "qreduce_kernel": k3,
                        "tree_gemm": 0, "tree_gemm_stream": 0})
        for name, v in got.items():
            launches[name] += v

    for key in ("tf", "basic"):
        c = res[key]
        assert c.shape == (n, n) and c.fmt == out, (key, c.shape, c.fmt)
        assert c.real.data.dtype == torch.int8
        with plain_dots():
            ref = calls[key][1](a, b)
        chk.same("fused_int8_gemm", f"{calls[key][0]}, real part", c.real,
                 ref.real)
        chk.same("fused_int8_gemm", f"{calls[key][0]}, imag part", c.imag,
                 ref.imag)
    c3 = res["ordered"]
    assert c3.shape == (ln, ln) and c3.fmt == (f88z, f88z)
    prod = qt.cmul(qt.complex_from_parts(
        qt.QTensor(a3.real.data[:, :, None], f88z),
        qt.QTensor(a3.imag.data[:, :, None], f88z)),
        qt.complex_from_parts(qt.QTensor(b3.real.data[None], f88z),
                              qt.QTensor(b3.imag.data[None], f88z)))
    for part in ("real", "imag"):
        x = getattr(prod, part)
        plan = plan_reduce(x.fmt, (), ln)
        ref = qt.qcast(qt.QTensor(qreduce_plain(x.data, 1, plan),
                                  plan.final_fmt), f88z)
        chk.same("qreduce_kernel", f"{calls['ordered'][0]}, {part} part",
                 getattr(c3, part), ref)
    del prod, x
    torch.cuda.empty_cache()

    m = CPLX_LAYERED_N
    fast = calls["tf"][1](a[:m, :m], b[:m, :m])
    with cgemm.force_fast_off():
        layered = calls["tf"][1](a[:m, :m], b[:m, :m])
    chk.same("fused_int8_gemm", f"config 5 TF {m}^3 == layered path, real",
             fast.real, layered.real)
    chk.same("fused_int8_gemm", f"config 5 TF {m}^3 == layered path, imag",
             fast.imag, layered.imag)

    cn = CORNER
    host = host_cgemul(a[:cn], b[:, :cn], out, "tf", (wide,), **tf_kw)
    c = res["tf"]
    re, im = c.real.raw()[:cn, :cn], c.imag.raw()[:cn, :cn]
    assert host == [[(int(re[i, j]), int(im[i, j])) for j in range(cn)]
                    for i in range(cn)], "config 5 corner vs hostops.cgemul"

    bb = BITS_BLOCK
    blk = c[:bb, :bb]
    bits = blk.to_bits()
    assert len(bits) == bb * bb * blk.width
    back = bitstream.from_bits_complex(bits, *out, shape=(bb, bb),
                                       twos_complement=True, device=dev)
    assert back.fmt == blk.fmt and back.device == blk.device
    assert torch.equal(back.real.data, blk.real.data) and \
        torch.equal(back.imag.data, blk.imag.data), "BitStream round trip"
    print(f"main path d: config 5 TF and Basic equal their plain-dot "
          f"versions, {ln}^3 order-sensitive equals plain K3, {m}^3 equals "
          f"the layered path, the {cn}x{cn} corner equals hostops.cgemul, "
          f"a {bb}x{bb} block survives to_bits -> from_bits_complex")
    return launches, (a, b, a3, b3)


def phase_chain(dev, state_a):
    """Phase 3e: P1 on the canonical tree GEMM's measurement path."""
    import torch

    from qublas_tpu_torch.ops.chain_probe import (chain_probe,
                                                  measured_chain_prods,
                                                  p1_plan)

    tplan, f88z = state_a[6], state_a[7]
    inst = p1_plan(tplan)
    print(f"main path e: p1_plan(canonical plan) = {inst} (its steps "
          f"compiled in)")
    assert inst == 1, inst
    chain_probe.launches = 0
    t0 = time.perf_counter()
    rate = measured_chain_prods(f88z, tplan, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chain_probe.launches
    print(f"main path e: measured_chain_prods (canonical plan) in "
          f"{wall * 1e3:.3f} ms wall, launches {{'chain_probe': {launches}}}")
    check_launches("main path e", launches, 8)
    assert rate is not None and rate > 0, f"measured_chain_prods: {rate}"
    return launches, rate


def pair_paths():
    """Paths f1-f4: (label, operand format, qgemul keywords, out formats,
    expected launches)."""
    import qublas_tpu_torch as qt

    sz = qt.OverflowMode.SAT_ZERO
    f12 = qt.qformat(12, 12, round_mode=qt.RoundMode.TRN_TCPL,
                     overflow_mode=sz)
    q16 = qt.qformat(15, 16, round_mode=qt.RoundMode.TRN_TCPL,
                     overflow_mode=sz)
    f58, f88 = qt.qformat(5, 8), qt.qformat(8, 8)
    segs = -(-PAIR_N // 31)     # 2^31 // 2^26: 31 products a segment
    return {
        "f1": ("K2 pair route Qu<12,12,TRN::TCPL,SAT::ZERO>", f12,
               dict(mul_to=f12, add_formats=(f12,)), (f12,),
               {"tree_gemm": 1}),
        "f2": ("lossless wide dot Qu<5,8>", f58,
               dict(mul_to=qt.qformat(11, 16),
                    add_formats=(qt.qformat(22, 16),)),
               (qt.qformat(23, 8), qt.qformat(31, 16)),
               {"fused_int8_gemm": 2 * segs}),
        "f3": ("Q16.16 Qu<15,16,TRN::TCPL,SAT::ZERO> throughout", q16,
               dict(mul_to=q16, add_formats=(q16,)), (q16,), {}),
        "f4": ("full-precision Qu<8,8> products (Qu<16,16> pairs)", f88,
               dict(mul_full_prec=True, add_formats=(qt.qformat(24, 16),)),
               (f88,), {}),
    }


def phase_pair(dev, chk):
    """Phase 3f: pair storage and the 64-bit product route through the
    public entry points."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import hostops
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.ops.reduce import qreduce_kernel
    from qublas_tpu_torch.ops.tree_gemm import (k2_modes, plan_tree,
                                                tree_gemm, tree_gemm_plain,
                                                tree_gemm_stream)

    counters = (fused_int8_gemm, tree_gemm, tree_gemm_stream, qreduce_kernel)
    n, cn = PAIR_N, CORNER
    rng = np.random.RandomState(11)
    launches = {fn.__name__: 0 for fn in counters}
    state = {}
    for key, (label, f, kw, outs, expect) in pair_paths().items():
        a = qt.from_raw(rand_raws(rng, f, (n, n), np.int64), f, dev)
        b = qt.from_raw(rand_raws(rng, f, (n, n), np.int64), f, dev)
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        res = [qt.qgemul(a, b, out, **kw) for out in outs]
        if key == "f1":
            plan = plan_tree(f, f, qt.mul_merge(f, f, kw["mul_to"]),
                             kw["add_formats"], n, outs[0])
            stream = tree_gemm_stream(a.data, b.data, plan, outs[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in counters}
        print(f"main path {key}: {label} {n}^3 in {wall * 1e3:.3f} ms wall "
              f"(first call), launches {got}")
        want = {fn.__name__: 0 for fn in counters}
        want.update(expect)
        if key == "f1":
            want["tree_gemm_stream"] = 1
        check_launches(f"main path {key}", got, want)
        for name, v in got.items():
            launches[name] += v
        for out, c in zip(outs, res):
            assert c.shape == (n, n) and c.fmt == out, (key, c.fmt)
            assert c.is_pair == (out.storage_bits > 32), (key, out)
        # against the plain versions: K2's, the wide tier on int_dot's,
        # and the streaming tier's own plain torch on CPU copies of a
        # 16-row, 16-column corner (the layered path there)
        if key == "f1":
            assert plan.prod_route == "pair" and k2_modes(plan) == 2
            ref = tree_gemm_plain(a.data, b.data, plan, outs[0])
            chk.same("tree_gemm", f"f1 pair route qgemul {n}^3", res[0].data,
                     ref)
            chk.same("tree_gemm_stream", f"f1 pair route, K2′ == K2 {n}^3",
                     stream, res[0].data)
            del ref, stream
        elif key == "f2":
            with plain_dots():
                refs = [qt.qgemul(a, b, out, **kw) for out in outs]
            for out, c, r in zip(outs, res, refs):
                chk.same("fused_int8_gemm", f"f2 wide tier {n}^3 -> {out}",
                         c, r)
            del refs
        else:
            ref = qt.qgemul(a[:cn].to("cpu"),
                            qt.QTensor(b.data[:, :cn].to("cpu"), f),
                            outs[0], **kw)
            corner = res[0].data[:cn, :cn].cpu()
            assert torch.equal(corner, ref.data), f"{key}: card != CPU"
        for out, c in zip(outs, res):
            host = qt.host_qgemul(a[:cn], qt.QTensor(b.data[:, :cn], f), out,
                                  add_formats=kw.get("add_formats", ()),
                                  mul_to=kw.get("mul_to"),
                                  mul_full_prec=kw.get("mul_full_prec",
                                                       False))
            assert np.array_equal(c.raw()[:cn, :cn], host), \
                f"{key} corner vs hostops -> {out}"
        state[key] = (a, b, kw, outs)
        del res
        torch.cuda.empty_cache()
    print(f"main path f: f1 K2 == plain == K2′, f2 == its plain dots, f3 "
          f"and f4 corners == CPU, every {cn}x{cn} corner == "
          "hostops.qgemul")

    # the pair elementwise ops on the card against CPU copies and hostops:
    # u Qu<8,8> lanes, v Q16.16 lanes, w Q16.16 with zeros (divide by zero
    # -> 0), r Qu<16,16> pairs (full-precision products, doubled)
    f88, q16 = qt.qformat(8, 8), qt.qformat(15, 16)
    u = qt.from_raw(rand_raws(rng, f88, (EW_N, EW_N), np.int32), f88, dev)
    v = qt.from_raw(rand_raws(rng, q16, (EW_N, EW_N), np.int32), q16, dev)
    w_np = rand_raws(rng, q16, (EW_N, EW_N), np.int32)
    w_np[::7, ::3] = 0
    w = qt.from_raw(w_np, q16, dev)
    r = qt.qadd(qt.qmul(u, u, full_prec=True), qt.qmul(v, u, to=qt.qformat(
        16, 16, round_mode=qt.RoundMode.RND_INF)))
    assert r.is_pair
    to20 = qt.qformat(30, 20)
    sub_to = qt.qformat(20, 16, overflow_mode=qt.OverflowMode.WRP_TCPL)
    cast_to = qt.qformat(6, 10, round_mode=qt.RoundMode.RND_CONV)
    cases = [
        ("qmul full precision (pair result)",
         lambda u, v, w, r: qt.qmul(u, u, full_prec=True),
         lambda u, v, w, r: hostops.qmul(u, u, full_prec=True), True),
        ("qmul pair x lane", lambda u, v, w, r: qt.qmul(r, u, to=to20),
         lambda u, v, w, r: hostops.qmul(r, u, to=to20), True),
        ("qadd pair + lane", lambda u, v, w, r: qt.qadd(r, v),
         lambda u, v, w, r: hostops.qadd(r, v), True),
        ("qsub", lambda u, v, w, r: qt.qsub(v, r, to=sub_to),
         lambda u, v, w, r: hostops.qsub(v, r, to=sub_to), True),
        ("qdiv (pair route)", lambda u, v, w, r: qt.qdiv(r, w),
         lambda u, v, w, r: hostops.qdiv(r, w), True),
        ("qabs", lambda u, v, w, r: qt.qabs(r),
         lambda u, v, w, r: hostops.qabs(r), True),
        ("qneg", lambda u, v, w, r: qt.qneg(r),
         lambda u, v, w, r: hostops.qneg(r), True),
        ("qcmp", lambda u, v, w, r: qt.qcmp(r, v),
         lambda u, v, w, r: hostops.qcmp(r, v), False),
        ("qeq", lambda u, v, w, r: qt.qeq(r, r),
         lambda u, v, w, r: hostops.qeq(r, r), False),
        ("qcast pair -> lane", lambda u, v, w, r: qt.qcast(r, cast_to),
         lambda u, v, w, r: hostops.convert(r, cast_to), True),
    ]
    args = (u, v, w, r)
    cargs = tuple(t.to("cpu") for t in args)
    raws = [t.raw()[:cn, :cn] for t in args]
    for what, op, host_op, is_q in cases:
        got, ref = op(*args), op(*cargs)
        gd, rd = (got.data, ref.data) if is_q else (got, ref)
        assert gd.device == r.device and gd.dtype == rd.dtype, what
        assert torch.equal(gd.cpu(), rd), f"{what}: card != CPU"
        corner = gd[:cn, :cn].cpu().numpy()
        for i in range(cn):
            for j in range(cn):
                h = host_op(*((int(r[i, j]), t.fmt)
                              for r, t in zip(raws, args)))
                if is_q:
                    assert h[1] == got.fmt and h[0] == int(corner[i, j]), \
                        (what, i, j)
                else:
                    assert int(h) == int(corner[i, j]), (what, i, j)
    layers = (qt.qformat(24, 16), qt.qformat(30, 10, round_mode=qt.RoundMode.
                                              RND_CONV))
    red = qt.qreduce(r, layers, axis=1)
    assert red.is_pair and torch.equal(
        red.data.cpu(), qt.qreduce(cargs[3], layers, axis=1).data)
    rows = r.raw()[:cn]
    for i in range(cn):
        h = hostops.qreduce_list([(int(x), r.fmt) for x in rows[i]], layers)
        assert h == (int(red.data[i]), red.fmt), ("qreduce row", i)
    torch.cuda.synchronize()
    print(f"main path f: {len(cases)} pair elementwise ops and a pair "
          f"qreduce at {EW_N}x{EW_N} on the card equal the CPU, their "
          f"{cn}x{cn} corners and {cn} rows hostops")
    return launches, state


def rq_ops(from_frac, fmt, floored=False, wide=False):
    """int32 operations of one requantize from ``from_frac`` into ``fmt``
    on the path csrc/requant.cuh takes for it: the rounding stage (none for
    a shift of 0; none beyond the floor for TRN::TCPL when the value comes
    ``floored``, as the split product's does), then the overflow stage.
    ``wide``: ``requant64`` of a 64-bit value, whose shifts, compares and
    selects each take a word pair (two operations), but for the WRP::TCPL
    wrap, which runs on the narrowed word."""
    import qublas_tpu_torch as qt

    rm, om = fmt.round_mode, fmt.overflow_mode
    d = from_frac - fmt.frac_bits
    if d == 0 or (floored and rm == qt.RoundMode.TRN_TCPL):
        rnd = 0
    elif d < 0 or rm == qt.RoundMode.TRN_TCPL:
        rnd = 1                      # shift
    elif rm == qt.RoundMode.TRN_SMGN:
        rnd = 3                      # bias select, add, shift
    else:
        rnd = 7                      # shift, mask, compares, carry, add
    ovf = 0
    if om == qt.OverflowMode.SAT_ZERO:
        ovf = 3                      # subtract, unsigned compare, select
    elif om in (qt.OverflowMode.SAT_TCPL, qt.OverflowMode.SAT_SMGN):
        ovf = 2                      # min, max
    elif om == qt.OverflowMode.WRP_TCPL:
        ovf = 4 if fmt.signed else 1
    if wide:
        return 2 * rnd + (ovf if om == qt.OverflowMode.WRP_TCPL else 2 * ovf)
    return rnd + ovf


def tree_ops(n, rqs, convert_ops):
    """int32 operations of one tree over n values: per layer, one add and
    one requantize per pair, ``convert_ops(layer)`` for an odd tail."""
    ops, m, layer = 0, n, 0
    while m > 1:
        ops += (m // 2) * (1 + rqs[layer]) + (m % 2) * convert_ops(layer)
        m = (m + 1) // 2
        layer += 1
    return ops


def bound_ms(nbytes, ops, rate):
    """The least time for the work: bytes at the HBM rate or operations at
    the peak rate of their type, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else \
        "operations"


def prod_ops(plan):
    """int32 operations of one requantized product: the i32 route's
    multiply, the split route's two multiplies and shift, which give the
    floor of the product at the step's shift (B's split into its high and
    low bits is once per element of B, shared by every row of A), or the
    pair route's 64-bit multiply, then the requantize's rounding carry and
    overflow."""
    if plan.prod_route == "split":
        return 3 + rq_ops(plan.prod_frac, plan.mul_fmt, floored=True)
    if plan.prod_route == "pair":
        # the 64-bit product (IMAD.WIDE: two words), its requantize on
        # words pairs
        return 2 + rq_ops(plan.prod_frac, plan.mul_fmt, wide=True)
    return 1 + rq_ops(plan.prod_frac, plan.mul_fmt)


def k2_bound(plan, out_fmt, m, n, k):
    """Bound of the tree GEMM: operands and output once, and per output
    element k products and the tree of merges (drain converts included)
    plus the final requantize."""
    rqs = [rq_ops(plan.level_fmts[l].frac_bits, plan.merge_fmts[l])
           for l in range(plan.levels)]
    per_out = k * prod_ops(plan) + tree_ops(k, rqs, lambda l: rqs[l]) + \
        rq_ops(plan.final_fmt.frac_bits, out_fmt)
    return bound_ms(4 * (m * k + k * n + m * n), m * n * per_out,
                    INT32_OPS_S)


def p1_bound(plan, steps, programs, elems):
    """Bound of P1: x and y once, the output once, and per element and step
    one product (its requantize and the route's multiply) and one layer-0
    merge (an add and its requantize), counted as ``k2_bound`` counts
    them."""
    merge = 1 + rq_ops(plan.level_fmts[0].frac_bits, plan.merge_fmts[0])
    return bound_ms(4 * (2 * elems + programs * elems),
                    programs * elems * steps * (prod_ops(plan) + merge),
                    INT32_OPS_S)


def k3_bound(plan, outputs, in_bytes, out_bytes):
    """Bound of the tree reduce: the input once, the output once, and per
    output the tree's adds and requantizes (a tail convert only where its
    formats differ)."""
    rqs = [rq_ops(cur.frac_bits, lf) for cur, lf, _ in plan.sched]
    per_out = tree_ops(plan.n, rqs, lambda l: rqs[l]
                       if plan.sched[l][0] != plan.sched[l][1] else 0)
    return bound_ms(outputs * (plan.n * in_bytes + out_bytes),
                    outputs * per_out, INT32_OPS_S)


def phase_times(card, state_a, state_b, state_d, chain_rate, state_f):
    """Phase 4: kernel, plain, library and main-path times."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.chain_probe import (BM, BN, G, T1,
                                                  chain_probe,
                                                  chain_probe_plain,
                                                  probe_tile)
    from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm,
                                                 fused_int8_gemm_plain,
                                                 int_dot, kmajor)
    from qublas_tpu_torch.ops.reduce import (plan_reduce, qreduce_kernel,
                                             qreduce_plain)
    from qublas_tpu_torch.ops.tree_gemm import (plan_tree, tree_gemm,
                                                tree_gemm_plain,
                                                tree_gemm_stream,
                                                tree_gemm_stream_plain)
    from qublas_tpu_torch.timing import device_us, host_us, timeit

    x, pipe, plan1, mid, a2, b2, tplan, f88z = state_a
    xr, r_plan, prod, p_plan, a3, b3, splan, _ = state_b
    f44, config2 = formats()[1:]
    n, tn, ln = PIPE_N, TREE_N, LAYERED_N
    w1 = pipe.w1                      # K-major, as the pipeline stores it
    w1_rm = w1.contiguous()           # the same B, row-major
    gen = torch.Generator(device=x.device).manual_seed(4)
    # every int8 raw is a Qu<4,4> raw: config 2's int8 lanes
    big = torch.randint(-128, 128, (REDUCE_BIG_ROWS, REDUCE_SHAPE[1]),
                        generator=gen, device=x.device, dtype=torch.int8)
    big_plan = plan_reduce(f44, config2, REDUCE_SHAPE[1])
    chk_big = torch.equal(qreduce_kernel(big, 1, big_plan),
                          qreduce_plain(big, 1, big_plan))
    assert chk_big, f"K3 != plain at [{REDUCE_BIG_ROWS}, {REDUCE_SHAPE[1]}]"
    xd = xr.data
    ca, cb, ca3, cb3 = state_d
    _, wide, out5, tf_kw, basic_kw = config5()
    ar, ai, br, bi = ca.real.data, ca.imag.data, cb.real.data, cb.imag.data
    brk, bik = kmajor(br), kmajor(bi)  # as cgemul hands them to its dots
    xp, yp = probe_tile(f88z, x.device)
    pa, pb, pkw, (f12,) = state_f["f1"]
    pplan = plan_tree(f12, f12, qt.mul_merge(f12, f12, pkw["mul_to"]),
                      pkw["add_formats"], pa.shape[1], f12)
    xq, yq = probe_tile(f12, x.device)
    t = {
        "k1": timeit(lambda: fused_int8_gemm(x, w1, plan1.prod_frac, mid)),
        "k1_rm": timeit(lambda: fused_int8_gemm(x, w1_rm, plan1.prod_frac,
                                                mid)),
        "k1_plain": timeit(lambda: fused_int8_gemm_plain(
            x, w1, plan1.prod_frac, mid)),
        "int_mm": timeit(lambda: torch._int_mm(x, w1)),
        "int_mm_rm": timeit(lambda: torch._int_mm(x, w1_rm)),
        "k2": timeit(lambda: tree_gemm(a2.data, b2.data, tplan, f88z)),
        "k2_plain": timeit(lambda: tree_gemm_plain(a2.data, b2.data, tplan,
                                                   f88z), warmup=1),
        "k2s_big": timeit(lambda: tree_gemm_stream(a2.data, b2.data, tplan,
                                                   f88z)),
        "k2s": timeit(lambda: tree_gemm_stream(a3.data, b3.data, splan,
                                               f88z)),
        "k2s_plain": timeit(lambda: tree_gemm_stream_plain(
            a3.data, b3.data, splan, f88z), warmup=1),
        "k3": timeit(lambda: qreduce_kernel(xd, 1, r_plan)),
        "k3_plain": timeit(lambda: qreduce_plain(xd, 1, r_plan)),
        "k3_sum": timeit(lambda: torch.sum(xd.to(torch.int32), 1)),
        "k3_big": timeit(lambda: qreduce_kernel(big, 1, big_plan)),
        "k3_big_plain": timeit(lambda: qreduce_plain(big, 1, big_plan),
                               warmup=1),
        "k3_big_sum": timeit(lambda: torch.sum(big.to(torch.int32), 1)),
        "k3_layered": timeit(lambda: qreduce_kernel(prod.data, 1, p_plan)),
        "pipeline": timeit(lambda: pipe(x)),
        "canonical": timeit(lambda: qt.qgemul(a2, b2, f88z)),
        "layered": timeit(lambda: qt.qcast(qt.qreduce(qt.qmul(
            qt.QTensor(a3.data[:, :, None], f88z),
            qt.QTensor(b3.data[None], f88z)), (), axis=1), f88z)),
        "qgemul_small": timeit(lambda: qt.qgemul(a3, b3, f88z)),
        "cgemul_tf": timeit(lambda: qt.cgemul(
            ca, cb, out5, algo="tf", add_formats=(wide,), **tf_kw)),
        "cgemul_basic": timeit(lambda: qt.cgemul(
            ca, cb, out5, algo="basic", add_formats=(wide,), **basic_kw)),
        "cgemul_dots": timeit(lambda: (int_dot(ar, brk), int_dot(ai, brk),
                                       int_dot(ai, bik), int_dot(ar, bik))),
        "cgemul_dots_rm": timeit(lambda: (int_dot(ar, br), int_dot(ai, br),
                                          int_dot(ai, bi), int_dot(ar, bi))),
        "cgemul_transpose": timeit(lambda: kmajor(br)),
        "int_mm4": timeit(lambda: (torch._int_mm(ar, brk),
                                   torch._int_mm(ai, brk),
                                   torch._int_mm(ai, bik),
                                   torch._int_mm(ar, bik))),
        "int_mm3": timeit(lambda: (torch._int_mm(ar, br),
                                   torch._int_mm(ai, br),
                                   torch._int_mm(ar, bi))),
        "cgemul_ordered": timeit(lambda: qt.cgemul(ca3, cb3, f88z,
                                                   algo="basic")),
        "p1": timeit(lambda: chain_probe(xp, yp, tplan, T1, G)),
        "p1_plain": timeit(lambda: chain_probe_plain(xp, yp, tplan, T1, G),
                           warmup=1),
        "k2_pair": timeit(lambda: tree_gemm(pa.data, pb.data, pplan, f12)),
        "k2_pair_plain": timeit(lambda: tree_gemm_plain(
            pa.data, pb.data, pplan, f12), runs=3, warmup=1),
        "k2s_pair": timeit(lambda: tree_gemm_stream(pa.data, pb.data, pplan,
                                                    f12), runs=5, warmup=1),
        "p1_pair": timeit(lambda: chain_probe(xq, yq, pplan, T1, G)),
    }
    for key, (a_, b_, kw_, outs_) in state_f.items():
        t[key] = timeit(lambda: [qt.qgemul(a_, b_, o, **kw_) for o in outs_],
                        runs=3, warmup=1)
    ops = 2 * n ** 3
    for key, label in (
            ("k1", "fused_int8_gemm, K-major B (the pipeline's weight)"),
            ("k1_rm", "fused_int8_gemm, row-major B (the wrapper's copy "
                      "included)"),
            ("k1_plain", "fused_int8_gemm plain (float64)"),
            ("int_mm", "torch._int_mm, K-major B (raw int8, reference)"),
            ("int_mm_rm", "torch._int_mm, row-major B (raw int8, "
                          "reference)")):
        print(f"time {label} {n}^3: {t[key]:.4f} ms, "
              f"{ops / t[key] / 1e9:.2f} TOP/s [{card}]")
    for key, label, size in (
            ("k2", "tree_gemm", tn), ("k2_plain", "tree_gemm plain", tn),
            ("k2s_big", "tree_gemm_stream", tn),
            ("k2s", "tree_gemm_stream", ln),
            ("k2s_plain", "tree_gemm_stream plain", ln)):
        print(f"time {label} {size}^3: {t[key]:.4f} ms, "
              f"{size ** 3 / t[key] / 1e6:.2f} Gprod/s [{card}]")
    for key, label, shape in (
            ("k3", "qreduce_kernel", REDUCE_SHAPE),
            ("k3_plain", "qreduce plain", REDUCE_SHAPE),
            ("k3_sum", "torch.sum(x.to(int32), 1) (context: another "
                       "function)", REDUCE_SHAPE),
            ("k3_big", "qreduce_kernel", (REDUCE_BIG_ROWS, REDUCE_SHAPE[1])),
            ("k3_big_plain", "qreduce plain",
             (REDUCE_BIG_ROWS, REDUCE_SHAPE[1])),
            ("k3_big_sum", "torch.sum(x.to(int32), 1) (context: another "
                           "function)", (REDUCE_BIG_ROWS, REDUCE_SHAPE[1])),
            ("k3_layered", "qreduce_kernel (layered GEMM's, axis 1)",
             (ln, ln, ln))):
        elems = 1
        for d in shape:
            elems *= d
        print(f"time {label} {list(shape)}: {t[key]:.4f} ms, "
              f"{elems / t[key] / 1e6:.2f} Gelem/s [{card}]")
    # K3 alone on the device (a profiler trace), and the host's time to
    # enqueue a call: at config 2 the event time above is mostly the host's
    for key, fn, shape in (
            ("k3", lambda: qreduce_kernel(xd, 1, r_plan), REDUCE_SHAPE),
            ("k3_big", lambda: qreduce_kernel(big, 1, big_plan),
             (REDUCE_BIG_ROWS, REDUCE_SHAPE[1])),
            ("k3_layered", lambda: qreduce_kernel(prod.data, 1, p_plan),
             (ln, ln, ln))):
        dev_us = device_us(fn)
        print(f"time qreduce_kernel {list(shape)}: event {t[key] * 1e3:.2f} "
              f"us, device us per call {dev_us}, host us per call "
              f"{host_us(fn):.2f} [{card}]")
    # K2′ the same way, beside K2 on the same plan at 2048^3
    for key, fn, size in (
            ("k2s", lambda: tree_gemm_stream(a3.data, b3.data, splan, f88z),
             ln),
            ("k2s_big", lambda: tree_gemm_stream(a2.data, b2.data, tplan,
                                                 f88z), tn)):
        dev_us = device_us(fn)
        print(f"time tree_gemm_stream {size}^3: event {t[key] * 1e3:.2f} "
              f"us, device us per call {dev_us}, host us per call "
              f"{host_us(fn, runs=20):.2f} [{card}]")
    print(f"time tree_gemm_stream / tree_gemm at {tn}^3 (canonical plan): "
          f"{t['k2s_big'] / t['k2']:.4f} [{card}]")
    print(f"time main path: QuantPipeline forward {n}^3 {t['pipeline']:.4f}"
          f" ms ({2 * ops / t['pipeline'] / 1e9:.2f} TOP/s over its two "
          f"GEMMs), canonical qgemul {tn}^3 {t['canonical']:.4f} ms, "
          f"layered GEMM {ln}^3 {t['layered']:.4f} ms against qgemul "
          f"{ln}^3 {t['qgemul_small']:.4f} ms [{card}]")

    cn = CPLX_N
    print(f"time config 5: TF cgemul {cn}^3 {t['cgemul_tf']:.4f} ms, its "
          f"four int_dots alone on K-major B {t['cgemul_dots']:.4f} ms "
          f"against four raw torch._int_mm on the same B "
          f"{t['int_mm4']:.4f} ms (reference); on row-major B "
          f"{t['cgemul_dots_rm']:.4f} ms (a copy of B per dot); the K-major "
          f"copy of one {cn}^2 int8 B that cgemul makes twice a call: "
          f"{t['cgemul_transpose']:.4f} ms; three raw torch._int_mm on "
          f"row-major B (bench.py's vs_3xint8 arm, reference) "
          f"{t['int_mm3']:.4f} ms ({t['int_mm3'] / t['cgemul_tf']:.4f} of "
          f"the TF call's time), Basic cgemul {t['cgemul_basic']:.4f} ms "
          f"[{card}]")
    print(f"time order-sensitive complex GEMM {ln}^3 (layered, Basic): "
          f"{t['cgemul_ordered']:.4f} ms, {ln ** 3 / t['cgemul_ordered'] / 1e6:.2f}"
          f" Gprod/s [{card}]")
    prods = BM * BN * G * T1
    p1_us = device_us(lambda: chain_probe(xp, yp, tplan, T1, G))
    print(f"time chain_probe T={T1} x {G} programs of [{BM}, {BN}]: "
          f"{t['p1']:.4f} ms, {prods / t['p1'] / 1e6:.2f} Gstep/s, device us "
          f"per call {p1_us}; plain {t['p1_plain']:.4f} ms [{card}]")
    canon_rate = tn ** 3 / (t["canonical"] / 1e3)
    k2s_rate = tn ** 3 / (t["k2s_big"] / 1e3)
    print(f"P1: measured_chain_prods (canonical plan) {chain_rate / 1e9:.2f} "
          f"Gprod/s; canonical qgemul (K2) {tn}^3 {canon_rate / 1e9:.2f} "
          f"Gprod/s, vs_serial_chain {canon_rate / chain_rate:.4f}; "
          f"tree_gemm_stream (K2′) {tn}^3 {k2s_rate / 1e9:.2f} Gprod/s, "
          f"{k2s_rate / chain_rate:.4f} of P1's rate [{card}]")

    pn = pa.shape[1]
    print(f"time tree_gemm pair route (f1, Qu<12,12,TRN::TCPL,SAT::ZERO>, "
          f"modes and route compiled in) {pn}^3: {t['k2_pair']:.4f} ms, "
          f"{pn ** 3 / t['k2_pair'] / 1e6:.2f} Gprod/s, over the canonical "
          f"plan's {t['k2_pair'] / t['k2']:.4f}; plain "
          f"{t['k2_pair_plain']:.4f} ms [{card}]")
    dev_us = device_us(lambda: tree_gemm_stream(pa.data, pb.data, pplan,
                                                f12), runs=3)
    print(f"time tree_gemm_stream pair route (run-time plan) {pn}^3: "
          f"{t['k2s_pair']:.4f} ms, device us per call {dev_us} [{card}]")
    p1_us = device_us(lambda: chain_probe(xq, yq, pplan, T1, G))
    print(f"time chain_probe pair route (f1's plan, run-time instantiation) "
          f"T={T1} x {G} programs of [{BM}, {BN}]: {t['p1_pair']:.4f} ms, "
          f"device us per call {p1_us} [{card}]")
    for key, (label, *_rest) in pair_paths().items():
        print(f"time main path {key} ({label}) {pn}^3: {t[key]:.4f} ms "
              f"[{card}]")

    rows, cols = REDUCE_SHAPE
    bounds = {
        "k1": bound_ms(3 * n * n, ops, INT8_OPS_S),
        "k1_rm": bound_ms(3 * n * n, ops, INT8_OPS_S),
        "k2": k2_bound(tplan, f88z, tn, tn, tn),
        "k2s": k2_bound(splan, f88z, ln, ln, ln),
        "k2s_big": k2_bound(tplan, f88z, tn, tn, tn),
        "k3": k3_bound(r_plan, rows, 1, 2),
        "k3_big": k3_bound(big_plan, REDUCE_BIG_ROWS, 1, 2),
        "k3_layered": k3_bound(p_plan, ln * ln, 4, 4),
        "p1": p1_bound(tplan, T1, G, BM * BN),
        "k2_pair": k2_bound(pplan, f12, pn, pn, pn),
        "k2s_pair": k2_bound(pplan, f12, pn, pn, pn),
        "p1_pair": p1_bound(pplan, T1, G, BM * BN),
        "cgemul_dots": bound_ms(4 * cn * cn + 4 * 4 * cn * cn,
                                4 * 2 * cn ** 3, INT8_OPS_S),
    }
    for key, (ms, by) in bounds.items():
        print(f"bound {key}: {ms:.4f} ms ({by}); measured {t[key]:.4f} ms, "
              f"{ms / t[key] * 100:.1f}% of the bound [{card}]")
    return t, bounds


def main() -> int:
    import torch

    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from qublas_tpu_torch import _build
    from qublas_tpu_torch.timing import card_line

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    so = _build.lib()._name
    print(f"build: {time.perf_counter() - t0:.2f} s, nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'}"
          f" s -> {so}")
    report = ptxas_report(_build.library_path().with_suffix(".log")
                          .read_text())
    for line in report:
        print("  " + line)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    chk = Checker()
    phase_kernels(dev, chk)
    launches_a, state_a = phase_main_path(dev, chk)
    launches_b, state_b = phase_reduce_path(dev, chk)
    phase_elementwise(dev)
    launches_d, state_d = phase_complex_path(dev, chk)
    launches_e, chain_rate = phase_chain(dev, state_a)
    launches_f, state_f = phase_pair(dev, chk)
    t, bounds = phase_times(card, state_a, state_b, state_d, chain_rate,
                            state_f)
    for line in resources(report, "tree_gemm_tiled_kernel") + \
            resources(report, "tree_gemm_stream_kernel") + \
            resources(report, "chain_probe_kernel"):
        print(f"registers {line}")
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "qublas_tpu" or m.startswith("qublas_tpu.")]
    assert not bad, f"the port imported {bad}"

    def row(name, source, replaces, launches, key, plain_key, library_key):
        ms, by = bounds[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": chk.max_err[name], "ms": t[key],
                "plain_ms": t[plain_key], "bound_ms": ms, "bound_by": by,
                "library_ms": t[library_key] if library_key else None}

    kernels = [
        row("fused_int8_gemm", "qublas_tpu_torch/csrc/fused_gemm.cu",
            "qublas_tpu/ops/pallas_gemm.py:83",
            launches_a["fused_int8_gemm"] + launches_d["fused_int8_gemm"]
            + launches_f["fused_int8_gemm"], "k1", "k1_plain", "int_mm"),
        row("tree_gemm", "qublas_tpu_torch/csrc/tree_gemm_tiled.cu",
            "qublas_tpu/ops/tree_gemm.py:362",
            launches_a["tree_gemm"] + launches_f["tree_gemm"], "k2",
            "k2_plain", None),
        row("tree_gemm_stream",
            "qublas_tpu_torch/csrc/tree_gemm_stream.cuh",
            "qublas_tpu/ops/tree_gemm.py:457",
            launches_b["tree_gemm_stream"] + launches_f["tree_gemm_stream"],
            "k2s", "k2s_plain", None),
        row("qreduce_kernel", "qublas_tpu_torch/csrc/qreduce.cu",
            "qublas_tpu/ops/reduce.py:192",
            launches_b["qreduce_kernel"] + launches_d["qreduce_kernel"],
            "k3", "k3_plain", None),
        row("chain_probe", "qublas_tpu_torch/csrc/chain_probe.cuh",
            "bench.py:408", launches_e, "p1", "p1_plain", None),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
