#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qublas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py moe    # phases 1 and 3n alone

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
      cast -> GEMM, the ROM and the cast in the first K1's epilogue) at
      4096^3 and the canonical order-sensitive ``qgemul`` at 2048^3: K1
      twice (once with its table), K2′ once (the route of
      ``ops.tree_gemm.takes_k2s``); then the canonical ``qgemul`` at the
      tree cells' GEMMs (``TREE_CELLS``), K2′ once each, fc1 in its depth-12
      and fc2 in its depth-14 instantiation, equal to the plain version;
   b. ``qreduce`` of BASELINE config 2 at [4096, 1024], and the layered
      canonical GEMM at 512^3 (``qcast(qreduce(qmul(a[:, :, None],
      b[None]), (), axis=1))``) beside ``tree_gemm_stream`` and ``qgemul``
      on the same operands: K3 twice, K2′ twice; the three GEMMs
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
   g. limb storage (65..992-bit formats) and the balanced-digit wide dot on
      K1 (paths g1-g6);
   h. lane completion: h1 the pipeline input as a [16, 256, 4096] batch
      against the 2-D first weight, folded into ONE K1 launch equal to the
      2-D GEMM 1, and a [4, 4096, 4096] batch of B against the 2-D x (four
      launches); h2 the canonical tree's a2 as [8, 256, 2048] against b2,
      one K2′ launch equal to K2 on the 2-D tree; h3 a ``qgemv`` of 64 vectors
      against [4096, 4096], one K1 launch; h4 ``qpoly``/``qapprox`` at
      4096^2 on lane, pair and limb storage; h5 the bitwise ops, a
      checkpoint round trip, ``requant_stats`` and the reference's
      ``fill()``/``shuffle()`` streams;
   i. the last two tiers of ``qgemul``: i1 the hybrid tier (the JAX
      package's prefix-lossless configuration, ``Qu<3,4>`` operands,
      products ``Qu<7,8>``, four lossless layers and a ``SAT::ZERO`` tail)
      at 2048^3, one launch of K2h's tensor-core kernel (int8 lanes),
      against K2 on ``plan_tree``, K2h's digit kernels on int16 and int32
      copies of the operands, the plain version on the card, the CPU on a
      row block and ``hostops`` on a corner; again at k = 2040 (blocks of
      8), k = 176 (an odd block count), with a shift dl > 0 (s = 8, 256
      block values) and as a folded [8, 256, 2048] batch; the same datapath
      on ``Qu<5,6>`` operands in int16 lanes at 2048^3, one launch of the
      digit kernel (int16 lanes as u8/s8 byte digits); the digit kernels on
      raws over the whole int16 and int32 lanes (outside the format, the
      block dots wrapping) against the plain version;
      i2 host storage: the native engine built and
      loaded, ``from_float`` at 4096^2 through it against the Python loop
      on a row block, a ``Qu<600,600>`` (1,201-bit) tensor through
      ``qmul``/``qadd``/``qdiv``/``qcast``, ``qreduce``, a ``QTable``
      into it and a checkpoint round trip against ``hostops``, and the
      host GEMM (wart raws of a 32-bit lane format at 256^3 on the
      native engine, ``Qu<600,600>`` and 8,401-bit products) against
      ``host_qgemul``; host results that fit a lane land on the card;
   j. the sharded surface (``qublas_tpu_torch.parallel``) in worlds of
      ranks spawned by this script: j1 the dry-run sequence (the port of
      ``__graft_entry__.dryrun_multichip``) in a world of 1 on NCCL; j2 the
      same in a Gloo world of 4 ranks that share the card (meshes (2, 2)
      and (1, 4)); j3 in that world at full width: the pipeline's first
      GEMM at 4096^3 by ``sharded_qgemul_k`` (psum, reduce-scatter) and
      its ring (one K1 launch a rank, four for the ring), the canonical
      tree at 2048^3 by mn on (2, 2) and by k_tree on (1, 4) with and
      without the butterfly (one K2′ launch a rank, and K3 for the
      gathered top fold), config 2's ``qreduce`` batch-sharded (K3 a
      rank), the hybrid configuration i1 through ``shard_qgemul(auto)``,
      2-D and as a batch (one K2h launch a rank); each case equal to the
      single-device call on every rank and held to the launches it must
      make on every rank, its collective bytes and rank 0's wall time
      beside the single-device time (Gloo through host memory: not an
      NVLink figure); no rank may import JAX; then, in worlds of their
      own, the strategies' compiled programs (Inductor,
      ``make_mesh(..., programs=...)``): j1 the dry run with every
      strategy compiled, in the default mode and as CUDA graphs replayed
      on fresh operands, in a world of 1 on NCCL, and j3's nine cases
      compiled in a Gloo world of 4, each call Δ=0 to the eager call and
      the single-device call, j3's launches and collective bytes equal to
      the eager cases', with compile, first-call and median times;
   k. the card differential (``qublas_tpu_torch.fuzz``, the port of the
      JAX package's ``tools/deep_fuzz.py`` and ``tools/tpu_differential.py``):
      every family at the trial counts of ``DIFF_TRIALS``, each trial held
      to the host oracle and each kernel launch of the kernel families
      (K1, K2, K2′, K2h, K3, P1 at random lossless, tree, hybrid and reduce
      plans, every mode pair, each instantiation, shapes to the tile edges
      and transposed, strided and offset views) to its plain version on
      CPU copies; the coverage gate (every kernel row launched at least 20
      times, K2's six and K2′'s five instantiations, 10 mode pairs on K1's
      epilogue, K2's
      run-time instantiations and K3); the three examples'
      ``main("cuda")``; its launches on a line of their own, in no row of
      the kernels line;
   l. the paths as compiled programs: Inductor builds each program with
      ``fullgraph=True`` and ``dynamic=False``, in the default mode and in
      ``"reduce-overhead"`` (CUDA graphs): the pipeline at 4096^3 (K1
      twice), the canonical ``qgemul`` at 2048^3 (K2′) with a ``qreduce``
      of its rows and K2 on its operands, config 2's ``qreduce``, i1 on int8 and
      int16 lanes (K2h's int8 and digit kernels), config 5's TF
      ``cgemul`` (K1 four times), P1 at ``measured_chain_prods``' shapes,
      and the lane (with ``qapprox``), pair and limb elementwise chains at
      4096^2; each compiled call equal to eager, eager to the plain
      versions and to ``hostops`` on a corner, its launches counted (every
      kernel row launches from inside a compiled graph; these launches
      count in no row of the kernels line); each CUDA graph replayed on
      fresh inputs equal to eager, with no counted launch (a replay runs
      no Python); the compile seconds and the eager, compiled and replayed
      times;
   m. ``utils.profiling`` on the card: ``device_busy`` of one forward of
      the pipeline at 4096^3, eager and compiled, each inside a
      ``record_function`` range: busy and span seconds, the range's device
      span, the busy share and the top five device rows (K1 twice a
      forward); the traces under ``chiprun_out/traces``; and
      ``roofline_report`` of ``qgemul`` at 4096^3 against
      ``torch._int_mm``;
   n. one DeepSeek-V3 layer of the benchmark's ``dsv3_moe_int8`` at the
      published widths and its cell's batch of 32,768 rows
      (``QuantRMSNorm`` then ``QuantMoE``, the 32 experts of routing group
      0 held): N1 once, K1 seven times (the router, the shared expert's
      three projections, one grouped launch a held projection; the SiLU
      table in both gate projections' epilogue), G1 twice and C1 once,
      equal to the benchmark's plain reference; each of those launches'
      own arguments, recorded from that run, through its kernel and its
      plain version on the card (Δ=0), and N1, K1's grouped launches, G1
      and C1 timed beside their plain versions and their bounds;
   every result is checked against the plain versions, and 16x16 corners
   against the exact host golden model (``hostops``);
4. time each kernel and its plain version (CUDA events, median of 10 runs
   after warm-up) beside its bound and, where one exists, the PyTorch call
   computing the same function, and the main-path calls end to end; K1
   with the pipeline's table and without it, and K1 followed by the ROM
   and the cast in plain torch, at the FFN's first GEMM (``FFN_GEMM``) in
   turns; K2 and K2′ at the tree cells' GEMMs (``TREE_CELLS``) beside
   ``qgemul``; K2′
   and K3 also by their device time (a profiler trace) and the host's
   time to enqueue a call, K2′ beside K2 and with its instantiations'
   registers and spills; P1 by its device time too, with
   ``vs_serial_chain`` (K2's rate over P1's) and K2′'s rate over P1's, and
   its instantiations' registers; K2 and K2′ on the pair route at 2048^3,
   P1 on it at ``measured_chain_prods``' shapes, the wall times of
   paths f1-f4 and g1-g6, path h beside the 2-D calls of the same
   size, and K2h's tensor-core kernel on int8 lanes and its digit kernels
   on int16 and int32 copies of the same operands in turns (event and
   device time, registers and spills) beside K2 and K2′.

The second-to-last line is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

# main-path sizes
PIPE_N = 4096                     # x, W1, W2: PIPE_N x PIPE_N
FFN_GEMM = (24576, 1024, 4096)    # BERT-Large's first FFN GEMM (m, k, n)
TREE_N = 2048                     # canonical qgemul: TREE_N^3
# the tree cells' GEMMs (m, k, n): gpubench's bertl_fc_tree16 fc1 and fc2
TREE_CELLS = {"fc1": (1536, 1024, 4096), "fc2": (1536, 4096, 1024)}
REDUCE_SHAPE = (4096, 1024)       # BASELINE config 2, reduced over axis 1
REDUCE_BIG_ROWS = 131072          # K3 timed at [REDUCE_BIG_ROWS, 1024]
LAYERED_N = 512                   # layered canonical GEMM: LAYERED_N^3
EW_N = 4096                       # elementwise ops: EW_N x EW_N
CPLX_N = 2048                     # config 5 complex GEMM: CPLX_N^3
CPLX_LAYERED_N = 256              # config 5 against its layered path
BITS_BLOCK = 64                   # BitStream round trip of a 64x64 block
CORNER = 16                       # corner checked against the host model
PAIR_N = 2048                     # pair-storage paths f1-f4: PAIR_N^3
LIMB_N = 2048                     # limb paths g1, g2, g6: LIMB_N^3
LIMB_G3 = (1024, 2048, 1024)      # g3 (m, k, n): the digit-dot envelope
LIMB_STREAM = (256, 2048, 256)    # g5's streaming GEMM (m, k, n)
LIMB_CORNER = 4                   # corners at k = 2048 against hostops
LANE_BATCH = 16                   # h1: x as [LANE_BATCH, PIPE_N / it, PIPE_N]
LANE_B_BATCH = 4                  # h1: [LANE_B_BATCH, PIPE_N, PIPE_N] B
TREE_BATCH = 8                    # h2: a2 as [TREE_BATCH, TREE_N / it, TREE_N]
GEMV_VECS = 64                    # h3: [GEMV_VECS, PIPE_N] vectors
LANE_BLOCK = 64                   # h2-h5: rows held against the CPU
CKPT_LIMB_ROWS = 512              # h5: rows of the limb tensor saved
HYB_N = 2048                      # i1: the hybrid tier at HYB_N^3
HYB_BATCH = 8                     # i1: A as [HYB_BATCH, HYB_N / it, HYB_N]
HYB_FULL_ROWS = 256               # i1: full-range int32 raws, checked on the CPU
HOST_N = 64                       # i2: Qu<600,600> tensors HOST_N x HOST_N
HOST_PY_ROWS = 256                # i2: rows of from_float's Python loop
HOST_GEMM = (256, 256, 256)       # i2: the native host GEMM (m, k, n)
HOST_WIDE_GEMM = (8, 16, 8)       # i2: Qu<600,600> on the host GEMM
SHARD_WORLD = 4                   # j2, j3: ranks of the Gloo world
SHARD_PIPE_N = 4096               # j3: the pipeline's first GEMM, N^3
SHARD_TREE_N = 2048               # j3: canonical and hybrid GEMMs, N^3
SHARD_TIMEOUT = 400               # seconds a world may take, spawn included
SHARD_COMPILE_TIMEOUT = 600       # the same for the worlds of compiled programs
# phase k: the card differential's trials a family (qublas_tpu_torch.fuzz)
DIFF_TRIALS = {"routes": 1, "routes_sharded": 1, "elementwise": 120,
               "cast": 200, "reduce": 100, "gemm": 100, "gemm_limbwide": 60,
               "complex": 100, "cgemul": 60, "anus": 60, "bitstream": 200,
               "bitwise": 60, "sharded": 30, "sharded_ktree": 30, "k1": 48,
               "k2": 48, "k2s": 48, "k2h": 48, "k3": 48, "p1": 48}

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
                                                tree_gemm_plain,
                                                tree_gemm_stream)

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

    fused_int8_gemm.launches = fused_int8_gemm.lut_launches = 0
    tree_gemm.launches = tree_gemm_stream.launches = 0
    t0 = time.perf_counter()
    y = pipe(x)
    c = qt.qgemul(a2, b2, f88z)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_int8_gemm": fused_int8_gemm.launches,
                "tree_gemm": tree_gemm.launches,
                "tree_gemm_stream": tree_gemm_stream.launches}
    print(f"main path a: pipeline {n}^3 + canonical qgemul {TREE_N}^3 in "
          f"{wall * 1e3:.3f} ms wall (first call), launches {launches}, "
          f"K1 with a table {fused_int8_gemm.lut_launches}")
    # the canonical tree takes K2′ (ops.tree_gemm.takes_k2s)
    check_launches("main path a", launches,
                   {"fused_int8_gemm": 2, "tree_gemm": 0,
                    "tree_gemm_stream": 1})
    check_launches("main path a: K1 with a table",
                   fused_int8_gemm.lut_launches, 1)

    assert y.shape == (n, n) and y.dtype == torch.int8, (y.shape, y.dtype)
    assert int(y.min()) >= mid.raw_min and int(y.max()) <= mid.raw_max
    assert c.shape == (TREE_N, TREE_N) and c.data.dtype == torch.int32
    assert c.fmt == f88z

    # the same computation through the plain versions, on the card
    plan1 = qt.exact_plan(fa, fa, qt.mul_merge(fa, fa, wide), (wide,), n)
    h1 = qt.QTensor(fused_int8_gemm_plain(x, pipe.w1, plan1.prod_frac, mid),
                    mid)
    h = qt.build_table(qt.sqrt_func, mid)(h1).astype(fa)
    y_ref = fused_int8_gemm_plain(h.data, pipe.w2, plan1.prod_frac, mid)
    chk.same("fused_int8_gemm", f"pipeline {n}^3 output", y, y_ref)
    tplan = plan_tree(f88z, f88z, qt.mul_merge(f88z, f88z), (), TREE_N, f88z)
    c_ref = qt.QTensor(tree_gemm_plain(a2.data, b2.data, tplan, f88z), f88z)
    chk.same("tree_gemm_stream", f"canonical qgemul {TREE_N}^3", c, c_ref)

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
    launches["tree_gemm_stream"] += tree_cells_path(dev, chk, f88z)
    return launches, (x, pipe, plan1, mid, a2, b2, tplan, f88z)


def tree_cells_path(dev, chk, f88z):
    """Path a at the tree cells' GEMMs (``TREE_CELLS``): the canonical
    ``qgemul`` launches K2′ once a cell, in the instantiation whose stack
    holds the cell's k (``k2s_top``: depth 12 for fc1's k = 1024, 14 for
    fc2's k = 4096), equal to the plain version on the card.  Returns the
    launches."""
    import numpy as np

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.tree_gemm import (k2s_top, plan_tree,
                                                tree_gemm, tree_gemm_plain,
                                                tree_gemm_stream)
    from qublas_tpu_torch.utils.profiling import launch_record

    rng = np.random.RandomState(24)
    total = 0
    for cell, (m, k, n) in TREE_CELLS.items():
        a = qt.from_raw(rand_raws(rng, f88z, (m, k), np.int32), f88z, dev)
        b = qt.from_raw(rand_raws(rng, f88z, (k, n), np.int32), f88z, dev)
        tree_gemm.launches = tree_gemm_stream.launches = 0
        tree_gemm_stream.seen.clear()
        with launch_record():
            c = qt.qgemul(a, b, f88z)
        launches = {"tree_gemm": tree_gemm.launches,
                    "tree_gemm_stream": tree_gemm_stream.launches}
        seen = sorted({inst.split("/")[0]
                       for inst, _ in tree_gemm_stream.seen})
        print(f"main path a, {cell}: canonical qgemul [{m}, {k}] @ [{k}, "
              f"{n}], launches {launches}, instantiations {seen}")
        check_launches(f"main path a, {cell}", launches,
                       {"tree_gemm": 0, "tree_gemm_stream": 1})
        want = [f"stream_{k2s_top(k, 1)}_1"]
        assert seen == want, (cell, seen, want)
        plan = plan_tree(f88z, f88z, qt.mul_merge(f88z, f88z), (), k, f88z)
        chk.same("tree_gemm_stream", f"canonical qgemul {cell} [{m}, {k}] @ "
                 f"[{k}, {n}] ({want[0]})", c, qt.QTensor(
                     tree_gemm_plain(a.data, b.data, plan, f88z), f88z))
        total += launches["tree_gemm_stream"]
    return total


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
                   {"fused_int8_gemm": 0, "tree_gemm": 0,
                    "tree_gemm_stream": 2, "qreduce_kernel": 2})

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
    """The complex GEMM's, the wide GEMM tier's and the limb tier's digit
    dots on ``int_dot``'s plain version (a float64 matmul on the card) while the block runs: the
    reference side of the K1 checks of phases 3d and 3f.  Fails if K1
    launched inside the block, so the reference cannot quietly run the
    kernel it is checking."""
    from qublas_tpu_torch.ops import cgemm, gemm, limbdot
    from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm, int_dot,
                                                 int_dot_plain)

    cgemm.int_dot = gemm.int_dot = limbdot.int_dot = int_dot_plain
    fused_int8_gemm.launches = 0
    try:
        yield
    finally:
        cgemm.int_dot = gemm.int_dot = limbdot.int_dot = int_dot
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
    expected launches).  f2 runs with the limb tier off
    (:func:`pair_tier`), so that it takes the int64 tier; path g2 runs the
    same config on the limb tier."""
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
        "f2": ("lossless wide dot Qu<5,8>, int64 tier (limb tier off)", f58,
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


def pair_tier(key):
    """The context in which path ``key`` of :func:`pair_paths` runs: f2
    with the limb tier off, the others as they are."""
    from contextlib import nullcontext

    from qublas_tpu_torch.ops.gemm import force_tiers_off

    return force_tiers_off("limb") if key == "f2" else nullcontext()


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
        with pair_tier(key):
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
            with plain_dots(), pair_tier(key):
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


def rand_limbs(gen, fmt, shape, dev):
    """Uniform raws over a limb format's storage range, made on the card:
    the low limbs whole, the top limb the sign-extended top bits."""
    import torch

    from qublas_tpu_torch.ops.limbint import LimbArray
    from qublas_tpu_torch.ops.widths import limb_count

    K = limb_count(fmt)
    top = fmt.storage_bits - 32 * (K - 1)
    low = torch.randint(0, 1 << 32, (K - 1,) + shape, generator=gen,
                        device=dev, dtype=torch.int64)
    hi = torch.randint(-(1 << (top - 1)), 1 << (top - 1), (1,) + shape,
                       generator=gen, device=dev, dtype=torch.int64)
    return LimbArray(torch.cat([low, hi & 0xFFFFFFFF]))


class Driver:
    """Drives one main-path call at a time: every launch count set to 0
    just before it and read just after, held to what the call must launch,
    and summed over the phase in ``launches``."""

    def __init__(self, counters):
        # a wrapper, counted by its ``launches`` under its name, or a
        # (name, owner, attribute) triple: a count of one kernel of a
        # wrapper that launches two
        self.counters = [c if isinstance(c, tuple) else
                         (c.__name__, c, "launches") for c in counters]
        self.launches = {name: 0 for name, _, _ in self.counters}

    def __call__(self, key, label, fn, expect):
        import torch

        torch.cuda.synchronize()
        for _, owner, attr in self.counters:
            setattr(owner, attr, 0)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: getattr(owner, attr)
               for name, owner, attr in self.counters}
        print(f"main path {key}: {label} in {wall * 1e3:.3f} ms wall (first "
              f"call), launches {got}")
        want = {name: 0 for name, _, _ in self.counters}
        want.update(expect)
        check_launches(f"main path {key}", got, want)
        for name, v in got.items():
            self.launches[name] += v
        return res


def same_q(what, got, ref):
    """A card QTensor equals a reference QTensor (format, storage kind and
    raws), or a card tensor equals a reference tensor."""
    import torch

    if hasattr(ref, "fmt"):
        assert got.fmt == ref.fmt, (what, got.fmt, ref.fmt)
        assert got.is_limb == ref.is_limb, what
        g = got.data.limbs if got.is_limb else got.data
        r = ref.data.limbs if ref.is_limb else ref.data
    else:
        g, r = got, ref
    assert g.shape == r.shape and g.dtype == r.dtype, \
        (what, g.shape, r.shape, g.dtype, r.dtype)
    assert torch.equal(g.cpu(), r.cpu()), f"{what}: card != reference"


@contextmanager
def checked_digit_dots(chk, what):
    """Every digit-dot K1 launch in the block held against ``int_dot_plain``
    on the same planes (a float64 matmul on the card, exact: the segment
    bound keeps every partial sum inside int32)."""
    from qublas_tpu_torch.ops import limbdot
    from qublas_tpu_torch.ops.fused_gemm import int_dot, int_dot_plain

    def dot(a, b):
        out = int_dot(a, b)
        chk.same("fused_int8_gemm", f"{what}: digit dot "
                 f"{list(a.shape)} @ {list(b.shape)}", out,
                 int_dot_plain(a, b))
        return out

    limbdot.int_dot = dot
    try:
        yield
    finally:
        limbdot.int_dot = int_dot


def limb_paths():
    """Paths g1-g3, g6: (label, operand format, qgemul keywords, out
    formats, (m, k, n), expected K1 launches)."""
    import qublas_tpu_torch as qt

    f31, f70 = qt.qformat(31, 8), qt.qformat(70, 10)
    g1 = dict(mul_to=qt.qformat(63, 16), add_formats=(qt.qformat(74, 16),))
    n = LIMB_N
    return {
        "g1": ("Qu<31,8> pair operands, 80-bit limb products", f31, g1,
               (qt.qformat(74, 16), qt.qformat(40, 8)), (n, n, n), 2),
        "g2": ("f2 (Qu<5,8>) on the limb tier", qt.qformat(5, 8),
               dict(mul_to=qt.qformat(11, 16),
                    add_formats=(qt.qformat(22, 16),)),
               (qt.qformat(23, 8), qt.qformat(31, 16)), (n, n, n), 2),
        "g3": ("Qu<70,10> limb operands", f70,
               dict(mul_to=qt.qformat(141, 20),
                    add_formats=(qt.qformat(152, 20),)),
               (qt.qformat(152, 20),), LIMB_G3, 1),
    }


def g6_config():
    """Path g6: the Basic complex GEMM of ``Qu<31,8>`` parts in the limb
    domain (80-bit products, 81-bit part sums, 93-bit layers holding 2048
    of them, a limb output)."""
    import qublas_tpu_torch as qt

    w = qt.qformat(63, 16)
    tags = dict(ac=w, bd=w, ad=w, bc=w, acbd=qt.qformat(64, 16),
                adbc=qt.qformat(64, 16))
    return qt.qformat(31, 8), tags, (qt.qformat(76, 16),), \
        qt.qformat(76, 16)


def phase_limb(dev, chk):
    """Phase 3g: limb storage (65..992-bit formats, stacked 32-bit limbs in
    int64) and the balanced-digit wide dot on K1, through the public entry
    points."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import hostint, hostops
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.ops.gemm import exact_plan, limb_dot_plan
    from qublas_tpu_torch.ops.reduce import qreduce_kernel
    from qublas_tpu_torch.ops.tree_gemm import tree_gemm, tree_gemm_stream
    from qublas_tpu_torch.ops.widths import route_div

    gen = torch.Generator(device=dev).manual_seed(12)
    rng = np.random.RandomState(12)
    cn, hc = CORNER, LIMB_CORNER
    drive = Driver((fused_int8_gemm, tree_gemm, tree_gemm_stream,
                    qreduce_kernel))
    launches = drive.launches
    state = {}

    def operand(f, shape):
        if f.storage_bits > 64:
            return qt.QTensor(rand_limbs(gen, f, shape, dev), f)
        return qt.from_raw(rand_raws(rng, f, shape, np.int64), f, dev)

    # g1-g3: qgemul's limb tier, one digit dot (one K1 launch) an output
    for key, (label, f, kw, outs, (m, k, n), nl) in limb_paths().items():
        a, b = operand(f, (m, k)), operand(f, (k, n))
        mul = qt.mul_merge(f, f, kw["mul_to"])
        plan = exact_plan(f, f, mul, kw["add_formats"], k)
        kws = [limb_dot_plan(f, f, o, plan, k, m, n) for o in outs]
        print(f"main path {key}: {label}, [{m}, {k}] @ [{k}, {n}], "
              f"working limbs {kws}")
        res = drive(key, f"{label} {m}x{k}x{n}", lambda: [
            qt.qgemul(a, b, o, **kw) for o in outs], {"fused_int8_gemm": nl})
        with checked_digit_dots(chk, f"{key} {m}x{k}x{n}"):
            again = [qt.qgemul(a, b, o, **kw) for o in outs]
        ca, cb = a[:cn].to("cpu"), qt.QTensor(b.data[:, :cn], f).to("cpu")
        for o, c, r in zip(outs, res, again):
            assert c.shape == (m, n) and c.fmt == o
            assert c.is_limb == (o.storage_bits > 64), (key, o)
            same_q(f"{key} -> {o}: again under the plain-dot check", c, r)
            same_q(f"{key} -> {o}: {cn}x{cn} corner against the CPU",
                   qt.QTensor(c.data[:cn, :cn], o),
                   qt.qgemul(ca, cb, o, **kw))
            host = qt.host_qgemul(a[:hc], qt.QTensor(b.data[:, :hc], f), o,
                                  **kw)
            assert np.array_equal(c[:hc, :hc].raw(), host), \
                f"{key} corner vs hostops -> {o}"
        state[key] = (a, b, kw, outs)
        del res, again
        torch.cuda.empty_cache()
    print(f"main path g1-g3: every digit dot == int_dot_plain, {cn}x{cn} "
          f"corners == CPU, {hc}x{hc} corners == hostops.qgemul")

    # g4: the limb elementwise ops at EW_N^2 against CPU rows and hostops
    f70, f20 = qt.qformat(70, 10, round_mode=qt.RoundMode.RND_CONV), \
        qt.qformat(20, 9)
    x = qt.QTensor(rand_limbs(gen, f70, (EW_N, EW_N), dev), f70)
    y = qt.QTensor(rand_limbs(gen, f70, (EW_N, EW_N), dev), f70)
    z_np = rand_raws(rng, f20, (EW_N, EW_N), np.int32)
    z_np[::5, ::3] = 0
    z = qt.from_raw(z_np, f20, dev)
    div_to = qt.qformat(80, 10)
    assert route_div(f70, f20, qt.add_merge(f70, f20, div_to))[0] == "limb"
    sz = qt.OverflowMode.SAT_ZERO
    cases = {
        "qmul limb x lane": (lambda x, y, z: qt.qmul(x, z, to=qt.qformat(
            95, 19)), lambda x, y, z: hostops.qmul(x, z, to=qt.qformat(
                95, 19))),
        "qmul limb x limb": (lambda x, y, z: qt.qmul(x, y, to=qt.qformat(
            141, 20)), lambda x, y, z: hostops.qmul(x, y, to=qt.qformat(
                141, 20))),
        "qadd": (lambda x, y, z: qt.qadd(x, y),
                 lambda x, y, z: hostops.qadd(x, y)),
        "qsub into a pair": (lambda x, y, z: qt.qsub(x, z, to=qt.qformat(
            40, 12, overflow_mode=qt.OverflowMode.WRP_TCPL)),
            lambda x, y, z: hostops.qsub(x, z, to=qt.qformat(
                40, 12, overflow_mode=qt.OverflowMode.WRP_TCPL))),
        "qcast out of a limb": (lambda x, y, z: qt.qcast(x, qt.qformat(
            20, 5, round_mode=qt.RoundMode.RND_INF, overflow_mode=sz)),
            lambda x, y, z: hostops.convert(x, qt.qformat(
                20, 5, round_mode=qt.RoundMode.RND_INF, overflow_mode=sz))),
        "qcast into a limb": (lambda x, y, z: qt.qcast(z, qt.qformat(
            100, 40)), lambda x, y, z: hostops.convert(z, qt.qformat(
                100, 40))),
        "qabs": (lambda x, y, z: qt.qabs(x), lambda x, y, z: hostops.qabs(x)),
        "qneg": (lambda x, y, z: qt.qneg(y), lambda x, y, z: hostops.qneg(y)),
        "qcmp": (lambda x, y, z: qt.qcmp(x, z),
                 lambda x, y, z: hostops.qcmp(x, z)),
        "qeq": (lambda x, y, z: qt.qeq(x, y), lambda x, y, z: hostops.qeq(
            x, y)),
        "qdiv (bit-serial)": (lambda x, y, z: qt.qdiv(x, z, to=div_to),
                              lambda x, y, z: hostops.qdiv(x, z, to=div_to)),
    }
    args = (x, y, z)
    rows = tuple(t[:cn].to("cpu") for t in args)
    raws = [t[:cn, :cn].raw() for t in args]
    ew_wall = {}
    for what, (op, host_op) in cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = op(*args)
        torch.cuda.synchronize()
        ew_wall[what] = time.perf_counter() - t0
        is_q = hasattr(got, "fmt")
        head = qt.QTensor(got.data[:cn], got.fmt) if is_q else got[:cn]
        same_q(f"g4 {what}: {cn} rows against the CPU", head, op(*rows))
        corner = head.raw()[:, :cn] if is_q else head[:, :cn].cpu().numpy()
        for i in range(cn):
            for j in range(cn):
                h = host_op(*((int(r[i, j]), t.fmt)
                              for r, t in zip(raws, args)))
                if is_q:
                    assert h == (int(corner[i, j]), got.fmt), (what, i, j)
                else:
                    assert int(h) == int(corner[i, j]), (what, i, j)
        del got
    print(f"main path g4: {len(cases)} limb elementwise ops at {EW_N}x{EW_N}"
          f" on the card equal the CPU on {cn} rows and hostops on "
          f"{cn}x{cn} corners; qdiv, bit-serial, ran at {EW_N}x{EW_N} in "
          f"{ew_wall['qdiv (bit-serial)']:.3f} s, inside a minute, so at "
          "the other ops' size")

    # g5: qreduce and a ROM into limb formats, the streaming tier in limbs
    fr = qt.qformat(31, 8)
    r = qt.from_raw(rand_raws(rng, fr, REDUCE_SHAPE, np.int64), fr, dev)
    layers = (qt.qformat(70, 8), qt.qformat(90, 8,
                                            round_mode=qt.RoundMode.RND_CONV))
    red = drive("g5", f"qreduce of Qu<31,8> pairs into limb layers "
                f"{list(REDUCE_SHAPE)}", lambda: qt.qreduce(r, layers, axis=1),
                {})
    assert red.is_limb
    same_q("g5 qreduce rows against the CPU", qt.QTensor(red.data[:cn],
                                                        red.fmt),
           qt.qreduce(r[:cn].to("cpu"), layers, axis=1))
    rr, rh = r[:cn].raw(), red[:cn].raw()
    for i in range(cn):
        h = hostops.qreduce_list([(int(v), fr) for v in rr[i]], layers)
        assert h == (int(rh[i]), red.fmt), ("g5 qreduce row", i)
    f34, rom_out = qt.qformat(3, 4), qt.qformat(90, 40)
    table = qt.QTable(qt.sqrt_func, f34, rom_out)
    xs = qt.from_raw(rand_raws(rng, f34, (EW_N, EW_N), np.int8), f34, dev)
    rom = drive("g5", f"sqrt ROM into Qu<90,40> limbs {EW_N}x{EW_N}",
                lambda: table(xs), {})
    same_q("g5 ROM rows against the CPU", qt.QTensor(rom.data[:cn],
                                                     rom_out),
           table(xs[:cn].to("cpu")))
    rx, ro = xs[:cn, :cn].raw(), rom[:cn, :cn].raw()
    for i in range(cn):
        for j in range(cn):
            v = hostint.raw_to_double(int(rx[i, j]), f34)
            want = hostint.double_to_raw(qt.sqrt_func(v), rom_out)
            assert int(ro[i, j]) == want, ("g5 ROM", i, j)
    fs = qt.qformat(70, 10, round_mode=qt.RoundMode.TRN_TCPL,
                    overflow_mode=sz)
    m, k, n = LIMB_STREAM
    sa, sb = operand(fs, (m, k)), operand(fs, (k, n))
    skw = dict(mul_to=fs, add_formats=(fs,))
    print(f"main path g5: the streaming GEMM at {m}x{k}x{n}, not "
          f"{LIMB_N}^3: its [m, 64, n] chunks of {fs.storage_bits}-bit "
          "products (6 working limbs, 12 16-bit digits in int64) would "
          "take tens of GiB a chunk and minutes at 2048^3")
    st = drive("g5", f"streaming tier Qu<70,10,TRN::TCPL,SAT::ZERO> "
               f"{m}x{k}x{n}", lambda: qt.qgemul(sa, sb, fs, **skw), {})
    from qublas_tpu_torch.ops.gemm import stream_gate
    with stream_gate(0):
        ref = qt.qgemul(sa[:2].to("cpu"), sb.to("cpu"), fs, **skw)
    same_q("g5 streaming GEMM 2 rows against the CPU",
           qt.QTensor(st.data[:2], fs), ref)
    host = qt.host_qgemul(sa[:hc], qt.QTensor(sb.data[:, :hc], fs), fs,
                          **skw)
    assert np.array_equal(st[:hc, :hc].raw(), host), "g5 streaming corner"
    state["g5"] = (r, layers, table, xs, sa, sb, skw)
    print(f"main path g5: qreduce and the ROM into limb formats and the "
          f"streaming GEMM in limb values equal the CPU on {cn} rows (2 for "
          f"the GEMM) and hostops on rows and corners")

    # g6: cgemul in the limb domain, four digit dots (four K1 launches)
    from qublas_tpu_torch.ops import cgemm

    f, tags, cl, out = g6_config()
    n = LIMB_N
    ca = qt.complex_from_parts(operand(f, (n, n)), operand(f, (n, n)))
    cb = qt.complex_from_parts(operand(f, (n, n)), operand(f, (n, n)))
    info = {}
    c = drive("g6", f"Basic cgemul, Qu<31,8> parts, {n}^3",
              lambda: cgemm._fast_cgemul(ca, cb, out, out, "basic", cl, cl,
                                         tags, info=info),
              {"fused_int8_gemm": 4})
    assert info == {"domain": "limb"}, info
    with checked_digit_dots(chk, f"g6 {n}^3"):
        again = qt.cgemul(ca, cb, out, algo="basic", add_formats=cl, **tags)
    rows_c = qt.cgemul(qt.complex_from_parts(ca.real[:cn], ca.imag[:cn])
                       .to("cpu"), cb.to("cpu"), out, algo="basic",
                       add_formats=cl, **tags)
    for part, p2, p3 in ((c.real, again.real, rows_c.real),
                         (c.imag, again.imag, rows_c.imag)):
        assert part.is_limb and part.shape == (n, n)
        same_q("g6 again under the plain-dot check", part, p2)
        same_q(f"g6 {cn} rows against the CPU",
               qt.QTensor(part.data[:cn], out), p3)
    host = host_cgemul(qt.complex_from_parts(ca.real[:hc], ca.imag[:hc]),
                       qt.complex_from_parts(
                           qt.QTensor(cb.real.data[:, :hc], f),
                           qt.QTensor(cb.imag.data[:, :hc], f)),
                       out, "basic", cl, **tags)
    cr, ci = c.real[:hc, :hc].raw(), c.imag[:hc, :hc].raw()
    for i in range(hc):
        for j in range(hc):
            assert host[i][j] == (int(cr[i, j]), int(ci[i, j])), \
                ("g6 corner vs hostops", i, j)
    state["g6"] = (ca, cb)
    del c, again
    torch.cuda.empty_cache()
    print(f"main path g6: the limb-domain cgemul equals its plain digit dots, "
          f"the CPU on {cn} rows and hostops on a {hc}x{hc} corner")
    return launches, {"gemms": {k: state[k] for k in ("g1", "g2", "g3")},
                      "ew": (args, cases), "g5": state["g5"],
                      "g6": state["g6"]}



def anus_cases():
    """Path h4: the x format and the coefficient format of each storage
    kind."""
    import qublas_tpu_torch as qt

    return {"lane": (qt.qformat(3, 4), qt.qformat(6, 6)),
            "pair": (qt.qformat(31, 8), qt.qformat(20, 12)),
            "limb": (qt.qformat(80, 40), qt.qformat(90, 30))}


def anus_segments(fc, dev):
    """Path h4's segments: a constant below -1, a line below 1, a quadratic
    above (coefficients from doubles, on ``dev``)."""
    import qublas_tpu_torch as qt

    c = [qt.scalar(v, fc, dev) for v in (0.75, -1.5, 0.25)]
    return [qt.Segment(-1.0, c[:1]), qt.Segment(1.0, c[:2]),
            qt.Segment(2.0, c)]


def host_qapprox(raw, fx, segs):
    """The reference's ``Qapprox`` of one raw on the host golden model:
    the segment by the raw's double value, the Horner recursion
    (QuBLAS.h:4836-4884), the result converted into x's format."""
    from qublas_tpu_torch import hostint, hostops

    val = hostint.raw_to_double(raw, fx)
    seg = next((s for s in segs if val < s.breakpoint), segs[-1])
    coeffs = [(int(c.raw()), c.fmt) for c in seg.coeffs]
    acc = coeffs[-1]
    for a in reversed(coeffs[:-1]):
        acc = hostops.qadd(a, hostops.qmul((raw, fx), acc, to=a[1]), to=a[1])
    return hostops.convert(acc, fx)[0]


def phase_lanes(dev, chk, state_a):
    """Phase 3h: lane completion through the public entry points: broadcast
    batches folded into one K1 or K2 launch, a batch of vectors in one
    ``qgemv``, ``qpoly``/``qapprox`` on lane, pair and limb storage, and the
    auxiliaries (``bitwise``, ``checkpoint``, ``diagnostics``, ``refrand``)
    at EW_N^2."""
    import os
    import tempfile

    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import bitwise
    from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm,
                                                 fused_int8_gemm_plain)
    from qublas_tpu_torch.ops.reduce import qreduce_kernel
    from qublas_tpu_torch.ops.tree_gemm import (tree_gemm, tree_gemm_plain,
                                                tree_gemm_stream)
    from qublas_tpu_torch.ops.widths import storage_dtype
    from qublas_tpu_torch.refrand import MT19937

    x, pipe, plan1, mid, a2, b2, tplan, f88z = state_a
    fa, wide, _ = qt.pipeline_formats()
    kw = dict(mul_to=wide, add_formats=(wide,))
    n, tn, en, rb, cn = PIPE_N, TREE_N, EW_N, LANE_BLOCK, CORNER
    gen = torch.Generator(device=dev).manual_seed(13)
    drive = Driver((fused_int8_gemm, tree_gemm, tree_gemm_stream,
                    qreduce_kernel))
    state = {}

    # h1: a [LANE_BATCH, n / LANE_BATCH, n] activation against the 2-D
    # first weight (K-major, as the pipeline keeps it): one K1 launch on
    # the folded rows, no copy
    x3 = qt.QTensor(x.reshape(LANE_BATCH, n // LANE_BATCH, n), fa)
    w1 = qt.QTensor(pipe.w1, fa)
    h = drive("h1", f"qgemul {list(x3.shape)} @ [{n}, {n}] (a folded "
              f"broadcast batch)", lambda: qt.qgemul(x3, w1, mid, **kw),
              {"fused_int8_gemm": 1})
    assert h.shape == x3.shape[:2] + (n,) and h.fmt == mid
    ref = fused_int8_gemm_plain(x, pipe.w1, plan1.prod_frac, mid)
    chk.same("fused_int8_gemm", f"h1 folded {list(x3.shape)} batch == plain "
             "on the folded operands", h.data.reshape(n, n), ref)
    chk.same("fused_int8_gemm", "h1 folded batch == the 2-D GEMM 1 of path "
             "a", h.data.reshape(n, n), fused_int8_gemm(x, pipe.w1,
                                                        plan1.prod_frac, mid))
    # a batch of LANE_B_BATCH weights against the 2-D x: one launch each
    bb = qt.QTensor(torch.randint(fa.raw_min, fa.raw_max + 1,
                                  (LANE_B_BATCH, n, n), generator=gen,
                                  device=dev, dtype=torch.int8), fa)
    xq = qt.QTensor(x, fa)
    hb = drive("h1", f"qgemul [{n}, {n}] @ {list(bb.shape)} (a 2-D A "
               "against a batched B)", lambda: qt.qgemul(xq, bb, mid, **kw),
               {"fused_int8_gemm": LANE_B_BATCH})
    for i in range(LANE_B_BATCH):
        chk.same("fused_int8_gemm", f"h1 batch {i} of [{n}, {n}] @ "
                 f"{list(bb.shape)} == plain on its 2-D operands", hb.data[i],
                 fused_int8_gemm_plain(x, bb.data[i], plan1.prod_frac, mid))
    state["h1"] = (x3, w1, xq, bb, kw, mid)

    # h2: the canonical tree's a2 as [TREE_BATCH, tn / TREE_BATCH, tn]
    # against the 2-D b2: one K2′ launch
    a3 = qt.QTensor(a2.data.reshape(TREE_BATCH, tn // TREE_BATCH, tn), f88z)
    c3 = drive("h2", f"canonical qgemul {list(a3.shape)} @ [{tn}, {tn}] (a "
               "folded broadcast batch)", lambda: qt.qgemul(a3, b2, f88z),
               {"tree_gemm_stream": 1})
    chk.same("tree_gemm_stream", "h2 folded batch == K2 on the 2-D operands "
             "of path a", c3.data.reshape(tn, tn),
             tree_gemm(a2.data, b2.data, tplan, f88z))
    chk.same("tree_gemm_stream", f"h2 folded batch, rows 0..{rb} == plain",
             c3.data[0, :rb], tree_gemm_plain(a2.data[:rb], b2.data, tplan,
                                               f88z))
    state["h2"] = (a3, b2, f88z)

    # h3: GEMV_VECS vectors against x: the vectors are the columns of one
    # GEMM, one K1 launch
    xv = qt.QTensor(torch.randint(fa.raw_min, fa.raw_max + 1, (GEMV_VECS, n),
                                  generator=gen, device=dev,
                                  dtype=torch.int8), fa)
    y = drive("h3", f"qgemv [{n}, {n}] @ {list(xv.shape)} (a batch of "
              "vectors)", lambda: qt.qgemv(xq, xv, mid, **kw),
              {"fused_int8_gemm": 1})
    assert y.shape == (GEMV_VECS, n)
    chk.same("fused_int8_gemm", f"h3 batched qgemv, rows 0..{rb} == plain",
             y.data[:, :rb], fused_int8_gemm_plain(
                 x[:rb], xv.data.t(), plan1.prod_frac, mid).t())
    state["h3"] = (xq, xv, kw, mid)

    # h4: qpoly and qapprox at EW_N^2 on each storage kind, against the
    # CPU on a row block and hostops on a corner
    xs = {}
    for kind, (fx, fc) in anus_cases().items():
        if kind == "limb":
            xk = qt.QTensor(rand_limbs(gen, fx, (en, en), dev), fx)
        else:
            xk = qt.QTensor(torch.randint(
                fx.raw_min, fx.raw_max + 1, (en, en), generator=gen,
                device=dev, dtype=storage_dtype(fx)), fx)
        xs[kind] = xk
        segs = anus_segments(fc, dev)
        segs_cpu = anus_segments(fc, "cpu")
        poly = drive("h4", f"qpoly of {fx} ({kind}), 3 coefficients, "
                     f"{en}x{en}", lambda: qt.qpoly(xk, segs[-1].coeffs), {})
        ap = drive("h4", f"qapprox of {fx} ({kind}), 3 segments, {en}x{en}",
                   lambda: qt.qapprox(xk, segs), {})
        blk = xk[:rb].to("cpu")
        same_q(f"h4 qpoly {kind}, rows 0..{rb}, card == CPU", poly[:rb],
               qt.qpoly(blk, segs_cpu[-1].coeffs))
        same_q(f"h4 qapprox {kind}, rows 0..{rb}, card == CPU", ap[:rb],
               qt.qapprox(blk, segs_cpu))
        corner = xk[:cn, :cn].raw()
        host = np.array([[host_qapprox(int(r), fx, segs_cpu) for r in row]
                         for row in corner], dtype=object)
        assert np.array_equal(ap[:cn, :cn].raw().astype(object), host), \
            f"h4 qapprox {kind} corner vs hostops"
        state["h4 " + kind] = (xk, segs)
    print(f"main path h4: qpoly/qapprox rows 0..{rb} equal the CPU and "
          f"{cn}x{cn} corners of qapprox equal hostops, each storage kind")

    # h5: the bitwise ops (lane x pair, pair x limb, qnot on each), a
    # checkpoint round trip, requant_stats and the reference's fill() and
    # shuffle() streams
    lane, pair, limb = xs["lane"], xs["pair"], xs["limb"]
    ops = {"qand": bitwise.qand, "qor": bitwise.qor, "qxor": bitwise.qxor}
    for name, op in ops.items():
        for xa, xb, what in ((lane, pair, "lane x pair"),
                             (pair, limb, "pair x limb")):
            got = drive("h5", f"{name} {what} {en}x{en}",
                        lambda: op(xa, xb), {})
            same_q(f"h5 {name} {what}, rows 0..{rb}, card == CPU", got[:rb],
                   op(xa[:rb].to("cpu"), xb[:rb].to("cpu")))
    for kind, xk in xs.items():
        got = drive("h5", f"qnot {kind} {en}x{en}", lambda: bitwise.qnot(xk),
                    {})
        same_q(f"h5 qnot {kind}, rows 0..{rb}, card == CPU", got[:rb],
               bitwise.qnot(xk[:rb].to("cpu")))
        if kind == "limb":
            limbs = got.data.limbs
            assert int(limbs.min()) >= 0 and int(limbs.max()) <= 0xFFFFFFFF
    tree = {"lane": lane, "pair": pair, "limb": limb[:CKPT_LIMB_ROWS]}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lanes.npz")
        back = drive("h5", f"checkpoint save/load: lane and pair {en}x{en}, "
                     f"limb [{CKPT_LIMB_ROWS}, {en}]",
                     lambda: (qt.save(path, tree), qt.load(path, dev))[1],
                     {})
    for key, t in tree.items():
        assert back[key].device == t.device, key
        same_q(f"h5 checkpoint round trip {key}", back[key], t)
    dst = qt.qformat(2, 2, overflow_mode=qt.OverflowMode.SAT_ZERO)
    st = drive("h5", f"requant_stats {lane.fmt} -> {dst} {en}x{en}",
               lambda: qt.requant_stats(lane, dst), {})
    st_cpu = qt.requant_stats(lane.to("cpu"), dst)
    assert st == st_cpu, (st, st_cpu)
    print(f"main path h5: requant_stats on the card {tuple(st)} == CPU")
    f88 = qt.qformat(8, 8)
    fill = drive("h5", "reference_fill (64, 64) Qu<8,8> and its "
                 "reference_shuffle",
                 lambda: qt.reference_shuffle(qt.reference_fill(
                     (64, 64), f88, MT19937(1), dev), MT19937(2)), {})
    want = qt.reference_shuffle(qt.reference_fill((64, 64), f88, MT19937(1),
                                                  "cpu"), MT19937(2))
    same_q("h5 reference_fill + reference_shuffle, card == CPU", fill, want)
    state["h5"] = (lane, pair, limb, tree, dst)
    return drive.launches, state


def lane_times(card, state_h, t):
    """Phase 4, path h: the broadcast GEMMs beside the 2-D calls of the same
    size, the batched qgemv, qpoly/qapprox and the auxiliaries."""
    import os
    import tempfile

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import bitwise
    from qublas_tpu_torch.refrand import MT19937
    from qublas_tpu_torch.timing import device_us, host_us, timeit

    x3, w1, xq, bb, kw, mid = state_h["h1"]
    a3, b2, f88z = state_h["h2"]
    a2 = qt.QTensor(a3.data.reshape(-1, a3.shape[-1]), f88z)
    calls = {"h1": lambda: qt.qgemul(x3, w1, mid, **kw),
             "h1_2d": lambda: qt.qgemul(xq, w1, mid, **kw),
             "h2": lambda: qt.qgemul(a3, b2, f88z),
             "h2_2d": lambda: qt.qgemul(a2, b2, f88z)}
    # each folded call and the 2-D call on the same bytes, in turns (2-D,
    # folded, folded, 2-D); the mean of each one's two medians
    for flat, fold, runs in (("h1_2d", "h1", 10), ("h2_2d", "h2", 3)):
        ms = {flat: [], fold: []}
        for key in (flat, fold, fold, flat):
            ms[key].append(timeit(calls[key], runs=runs, warmup=1))
        for key, v in ms.items():
            t[key] = sum(v) / len(v)
    hus = {key: host_us(calls[key]) for key in ("h1", "h1_2d")}
    # the kernels each call runs on the card, by name (a copy made by the
    # fold would show as a kernel of its own)
    dus = {key: device_us(calls[key]) for key in ("h1", "h1_2d")}
    t["h1_b"] = timeit(lambda: qt.qgemul(xq, bb, mid, **kw), runs=5)
    xq, xv, kw, mid = state_h["h3"]
    t["h3"] = timeit(lambda: qt.qgemv(xq, xv, mid, **kw))
    n, tn, en = PIPE_N, TREE_N, EW_N
    print(f"time h1 qgemul {list(x3.shape)} @ [{n}, {n}] (one K1 launch): "
          f"{t['h1']:.4f} ms, host {hus['h1']:.2f} us a call; the 2-D "
          f"qgemul [{n}, {n}] @ [{n}, {n}] {t['h1_2d']:.4f} ms, host "
          f"{hus['h1_2d']:.2f} us a call; K1 alone at {n}^3 {t['k1']:.4f} ms "
          f"[{card}]")
    for key in ("h1", "h1_2d"):
        print(f"time {key} device us per call by kernel: {dus[key]} "
              f"[{card}]")
    print(f"time h1 qgemul [{n}, {n}] @ {list(bb.shape)} ({LANE_B_BATCH} K1 "
          f"launches on row-major B): {t['h1_b']:.4f} ms; {LANE_B_BATCH} x "
          f"2-D K1 on a row-major B {LANE_B_BATCH * t['k1_rm']:.4f} ms "
          f"[{card}]")
    print(f"time h2 canonical qgemul {list(a3.shape)} @ [{tn}, {tn}] (one K2 "
          f"launch): {t['h2']:.4f} ms; the 2-D qgemul [{tn}, {tn}] @ [{tn}, "
          f"{tn}] {t['h2_2d']:.4f} ms; K2 alone at {tn}^3 {t['k2']:.4f} ms "
          f"[{card}]")
    print(f"time h3 qgemv [{n}, {n}] @ {list(xv.shape)} (one K1 launch): "
          f"{t['h3']:.4f} ms [{card}]")
    for kind in anus_cases():
        xk, segs = state_h["h4 " + kind]
        t["h4 qpoly " + kind] = timeit(lambda: qt.qpoly(xk, segs[-1].coeffs),
                                       runs=3, warmup=1)
        t["h4 qapprox " + kind] = timeit(lambda: qt.qapprox(xk, segs),
                                         runs=3, warmup=1)
        print(f"time h4 {kind} {xk.fmt} {en}x{en}: qpoly (3 coefficients) "
              f"{t['h4 qpoly ' + kind]:.4f} ms, qapprox (3 segments) "
              f"{t['h4 qapprox ' + kind]:.4f} ms [{card}]")
    lane, pair, limb, tree, dst = state_h["h5"]
    for name in ("qand", "qor", "qxor"):
        op = getattr(bitwise, name)
        for xa, xb, what in ((lane, pair, "lane x pair"),
                             (pair, limb, "pair x limb")):
            key = f"h5 {name} {what}"
            t[key] = timeit(lambda: op(xa, xb))
    for kind, xk in (("lane", lane), ("pair", pair), ("limb", limb)):
        t["h5 qnot " + kind] = timeit(lambda: bitwise.qnot(xk))
    t["h5 requant_stats"] = timeit(lambda: qt.requant_stats(lane, dst))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lanes.npz")
        t["h5 save"] = timeit(lambda: qt.save(path, tree), runs=1, warmup=0)
        t["h5 load"] = timeit(lambda: qt.load(path, lane.device), runs=1,
                              warmup=0)
    f88 = qt.qformat(8, 8)
    t["h5 fill"] = timeit(lambda: qt.reference_shuffle(qt.reference_fill(
        (64, 64), f88, MT19937(1), lane.device), MT19937(2)), runs=3,
        warmup=1)
    for key in [k for k in t if k.startswith("h5 q")]:
        print(f"time {key} {en}x{en}: {t[key]:.4f} ms [{card}]")
    print(f"time h5 requant_stats {lane.fmt} -> {dst} {en}x{en}: "
          f"{t['h5 requant_stats']:.4f} ms; checkpoint save "
          f"{t['h5 save']:.4f} ms, load {t['h5 load']:.4f} ms (lane and pair "
          f"{en}x{en}, limb [{CKPT_LIMB_ROWS}, {en}]); reference_fill + "
          f"reference_shuffle (64, 64) {t['h5 fill']:.4f} ms [{card}]")


def hybrid_config(kind="base"):
    """The hybrid configurations: the JAX package's own
    (``tests/test_tree_gemm.py:136-145``; ``dl``: ``:172-181``, whose
    lossless prefix shifts) on int8 lanes, and ``int16``, the same datapath
    shape on ``Qu<5,6>`` operands in int16 lanes, which take the digit
    kernel: (operand format, mul_to, layers, out)."""
    import qublas_tpu_torch as qt

    sz = qt.OverflowMode.SAT_ZERO
    if kind == "dl":
        return (qt.qformat(3, 4), qt.qformat(7, 10),
                (qt.qformat(8, 11), qt.qformat(9, 12), qt.qformat(10, 12),
                 qt.qformat(5, 6, overflow_mode=sz)), qt.qformat(5, 5))
    if kind == "int16":
        return (qt.qformat(5, 6), qt.qformat(11, 12),
                (qt.qformat(12, 12), qt.qformat(13, 12), qt.qformat(14, 12),
                 qt.qformat(15, 12), qt.qformat(10, 6, overflow_mode=sz)),
                qt.qformat(7, 6))
    return (qt.qformat(3, 4), qt.qformat(7, 8),
            (qt.qformat(8, 8), qt.qformat(9, 8), qt.qformat(10, 8),
             qt.qformat(11, 8), qt.qformat(6, 4, overflow_mode=sz)),
            qt.qformat(5, 4))


def phase_hybrid(dev, chk):
    """Phase 3i1: the hybrid tier through ``qgemul``: on int8 lanes one
    launch of K2h's tensor-core kernel a call, held to K2 on ``plan_tree``
    of the same configuration, to the digit kernels on int16 and int32
    copies of the same operands, to the plain version on the card, to the
    CPU on a row block and to hostops on a corner; on int16 lanes one
    launch of the digit kernel, held the same way; the digit kernels on
    raws over the whole int16 and int32 lanes, where the block dots wrap,
    against the plain version."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.ops.reduce import qreduce_kernel
    from qublas_tpu_torch.ops.tree_gemm import (k2_modes, k2h_route,
                                                plan_hybrid, plan_tree,
                                                tree_gemm, tree_gemm_hybrid,
                                                tree_gemm_hybrid_plain,
                                                tree_gemm_stream)

    n, rb, cn = HYB_N, LANE_BLOCK, LIMB_CORNER
    gen = torch.Generator(device=dev).manual_seed(21)
    drive = Driver((fused_int8_gemm, tree_gemm, tree_gemm_stream,
                    qreduce_kernel,
                    ("tree_gemm_hybrid_digits", tree_gemm_hybrid,
                     "digit_launches"),
                    ("tree_gemm_hybrid_mma", tree_gemm_hybrid,
                     "mma_launches")))
    state = {}
    for key, k, kind in (("i1", n, "base"), ("i1 k2040", n - 8, "base"),
                         ("i1 k176", 176, "base"), ("i1 dl", n, "dl"),
                         ("i1 int16", n, "int16")):
        fa, mul, layers, out = hybrid_config(kind)
        dt = torch.int16 if kind == "int16" else torch.int8
        a = qt.QTensor(torch.randint(fa.raw_min, fa.raw_max + 1, (n, k),
                                     generator=gen, device=dev, dtype=dt),
                       fa)
        b = qt.QTensor(torch.randint(fa.raw_min, fa.raw_max + 1, (k, n),
                                     generator=gen, device=dev, dtype=dt),
                       fa)
        mul_fmt = qt.mul_merge(fa, fa, mul)
        hp = plan_hybrid(fa, fa, mul_fmt, layers, k, out)
        tp = plan_tree(fa, fa, mul_fmt, layers, k, out)
        assert hp is not None and tp is not None, key
        route = k2h_route(a.data, b.data)
        assert route == ("digits" if kind == "int16" else "mma"), key
        name = f"tree_gemm_hybrid_{route}"
        c = drive(key, f"hybrid qgemul [{n}, {k}] @ [{k}, {n}] (s = {hp.s}, "
                  f"L = {hp.level}, dl = {hp.dl}, {k // hp.s} block values, "
                  f"{dt} lanes: the {route} kernel)",
                  lambda: qt.qgemul(a, b, out, mul_to=mul,
                                    add_formats=layers),
                  {name: 1})
        assert c.fmt == out and c.shape == (n, n)
        plain = tree_gemm_hybrid_plain(a.data, b.data, hp, out)
        chk.same(name, f"{key} == K2 on plan_tree (k2_modes {k2_modes(tp)})",
                 c.data, tree_gemm(a.data, b.data, tp, out))
        chk.same(name, f"{key} == tree_gemm_hybrid_plain on the card",
                 c.data, plain)
        if route == "mma":
            # the digit kernels on int16 and int32 copies of the operands
            for lane in (torch.int16, torch.int32):
                dig = tree_gemm_hybrid(a.data.to(lane), b.data.to(lane), hp,
                                       out)
                chk.same("tree_gemm_hybrid_digits", f"{key}: the digit "
                         f"kernel on {lane} copies == "
                         "tree_gemm_hybrid_plain", dig, plain)
        same_q(f"{key} rows 0..{rb}, card == CPU", c[:rb],
               qt.qgemul(a[:rb].to("cpu"), b.to("cpu"), out, mul_to=mul,
                         add_formats=layers))
        host = qt.host_qgemul(a[:cn], qt.QTensor(b.data[:, :cn], fa), out,
                              mul_to=mul, add_formats=layers)
        assert np.array_equal(c.raw()[:cn, :cn], host), \
            f"{key} corner vs hostops"
        print(f"main path {key}: rows 0..{rb} equal the CPU, the {cn}x{cn} "
              "corner equals hostops.qgemul")
        state[key] = (a, b, hp, tp, out, mul, layers)

    # the activation batch against the 2-D weight: one launch
    a, b, hp, tp, out, mul, layers = state["i1"]
    a3 = qt.QTensor(a.data.reshape(HYB_BATCH, n // HYB_BATCH, n), a.fmt)
    c3 = drive("i1 batch", f"hybrid qgemul {list(a3.shape)} @ [{n}, {n}] "
               "(a folded broadcast batch)",
               lambda: qt.qgemul(a3, b, out, mul_to=mul, add_formats=layers),
               {"tree_gemm_hybrid_mma": 1})
    chk.same("tree_gemm_hybrid_mma", "i1 folded batch == the 2-D hybrid "
             "qgemul", c3.data.reshape(n, n), tree_gemm_hybrid(
                 a.data, b.data, hp, out))
    hybrid_full_range(dev, chk, state)
    return drive.launches, state


def hybrid_full_range(dev, chk, state):
    """The digit kernels on raws over their whole lanes, outside the
    formats (int16: -32768 and 32767 included), where the block dots wrap
    mod 2^32 as the plain version's int32 dots do: i1 int16's plan at
    2048^3 against ``tree_gemm_hybrid_plain`` on the card (its float64
    block dots exact: each below 2^35), and i1's plan on int32 lanes
    against the plain version on the CPU (int64, wrapping) over a
    [HYB_FULL_ROWS, 2048] @ [2048, HYB_FULL_ROWS] block."""
    import torch

    from qublas_tpu_torch.ops.tree_gemm import (tree_gemm_hybrid,
                                                tree_gemm_hybrid_plain)

    gen = torch.Generator(device=dev).manual_seed(23)
    for key, lane, rows in (("i1 int16", torch.int16, HYB_N),
                            ("i1", torch.int32, HYB_FULL_ROWS)):
        a, b, hp, _, out, _, _ = state[key]
        info = torch.iinfo(lane)
        k = a.shape[1]
        x = torch.randint(info.min, info.max + 1, (rows, k), generator=gen,
                          device=dev, dtype=lane)
        y = torch.randint(info.min, info.max + 1, (k, rows), generator=gen,
                          device=dev, dtype=lane)
        x[0, :8] = y[:8, 0] = info.min
        x[1, :8] = y[:8, 1] = info.max
        got = tree_gemm_hybrid(x, y, hp, out)
        if lane == torch.int16:
            ref = tree_gemm_hybrid_plain(x, y, hp, out)
        else:
            ref = tree_gemm_hybrid_plain(x.cpu(), y.cpu(), hp, out).to(dev)
        chk.same("tree_gemm_hybrid_digits", f"{key} plan on full-range "
                 f"{lane} raws [{rows}, {k}] @ [{k}, {rows}] == "
                 "tree_gemm_hybrid_plain", got, ref)


def phase_host(dev):
    """Phase 3i2: host storage on the card's machine: the native engine, a
    1,201-bit format through the elementwise ops, ``qreduce``, a ``QTable``
    and a checkpoint, and the host GEMM, against ``hostops``; host results
    that fit a lane land on the card."""
    import os
    import tempfile

    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import hostint, hostops, native
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.ops.reduce import qreduce_kernel
    from qublas_tpu_torch.ops.tree_gemm import (tree_gemm, tree_gemm_hybrid,
                                                tree_gemm_stream)

    assert native.available(), "the native host engine did not build"
    fl = native.get_fastlimbs()
    print(f"host: native engine {native.get_lib()._name}; marshalling by "
          + (f"the C extension {fl.__file__}" if fl is not None else
             "Python's int.to_bytes loops (no C extension)"))
    drive = Driver((fused_int8_gemm, tree_gemm, tree_gemm_stream,
                    qreduce_kernel, tree_gemm_hybrid))
    rng = np.random.RandomState(22)

    # from_float through the native engine, against the Python loop it
    # replaces on a row block
    fa = qt.qformat(3, 4)
    vals = rng.randn(EW_N, EW_N) * 4
    t0 = time.perf_counter()
    xf = drive("i2", f"from_float {fa} {EW_N}x{EW_N} (native double_to_raw)",
               lambda: qt.from_float(vals, fa, dev), {})
    t_native = time.perf_counter() - t0
    blk = vals[:HOST_PY_ROWS].reshape(-1)
    t0 = time.perf_counter()
    py = [hostint.double_to_raw(float(v), fa) for v in blk]
    t_py = time.perf_counter() - t0
    assert xf.device == dev and not xf.is_host
    assert xf.raw()[:HOST_PY_ROWS].reshape(-1).tolist() == py, \
        "from_float: the engine != the Python loop"
    print(f"time i2 from_float {EW_N}x{EW_N}: {t_native * 1e3:.2f} ms wall "
          f"on the engine ({EW_N * EW_N / t_native / 1e6:.2f} Melem/s); the "
          f"Python loop on rows 0..{HOST_PY_ROWS} {t_py * 1e3:.2f} ms "
          f"({blk.size / t_py / 1e6:.3f} Melem/s), equal there")

    # a 1,201-bit format through the elementwise ops, qreduce and a QTable
    fh = qt.qformat(600, 600)
    fo = qt.qformat(20, 8)
    h1 = qt.random_fill((HOST_N, HOST_N), fh, seed=23, device=dev)
    h2 = qt.random_fill((HOST_N, HOST_N), fh, seed=24, device=dev)
    assert h1.is_host and h1.device == dev
    r1 = h1.raw().reshape(-1)
    r2 = h2.raw().reshape(-1)
    cases = {
        "qmul": (lambda: qt.qmul(h1, h2), lambda x, y: hostops.qmul(x, y)),
        "qmul full precision": (lambda: qt.qmul(h1, h2, full_prec=True),
                                lambda x, y: hostops.qmul(x, y,
                                                          full_prec=True)),
        "qadd": (lambda: qt.qadd(h1, h2), lambda x, y: hostops.qadd(x, y)),
        "qdiv": (lambda: qt.qdiv(h1, h2), lambda x, y: hostops.qdiv(x, y)),
        f"qcast into {fo}": (lambda: qt.qcast(h1, fo),
                             lambda x, y: hostops.convert(x, fo)),
    }
    for name, (fn, ref) in cases.items():
        got = drive("i2", f"{name} of {fh} {HOST_N}x{HOST_N}", fn, {})
        want = [ref((int(x), fh), (int(y), fh)) for x, y in zip(r1, r2)]
        assert got.fmt == want[0][1], (name, got.fmt)
        assert [int(v) for v in got.raw().reshape(-1)] == \
            [w[0] for w in want], f"i2 {name} vs hostops"
        assert got.is_host == (got.fmt.storage_bits > 992), name
        if not got.is_host:
            assert got.device == dev, f"i2 {name}: a lane result off the card"
    red = drive("i2", f"qreduce of {fh} {HOST_N}x{HOST_N} along axis 1",
                lambda: qt.qreduce(h1, (), axis=1), {})
    want = [hostops.qreduce_list([(int(v), fh) for v in row], ())[0]
            for row in h1.raw()]
    assert red.is_host and [int(v) for v in red.raw()] == want, \
        "i2 qreduce vs hostops"
    table = qt.QTable(qt.sqrt_func, fa, fh)
    xb = qt.QTensor(xf.data[:HOST_N, :HOST_N], fa)
    tab = drive("i2", f"QTable sqrt {fa} -> {fh} on {HOST_N}x{HOST_N} lanes",
                lambda: table(xb), {})
    want = [hostint.double_to_raw(qt.sqrt_func(hostint.raw_to_double(
        int(r), fa)), fh) for r in xb.raw().reshape(-1)]
    assert tab.is_host and [int(v) for v in tab.raw().reshape(-1)] == want, \
        "i2 QTable vs hostint"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "host.npz")
        back = drive("i2", f"checkpoint save/load of {fh} {HOST_N}x{HOST_N}",
                     lambda: (qt.save(path, {"h": h1}),
                              qt.load(path, dev))[1]["h"], {})
    assert back.is_host and back.device == dev and back.fmt == fh
    assert back.raw_list() == h1.raw_list(), "i2 checkpoint round trip"
    print(f"main path i2: {fh} {HOST_N}x{HOST_N} through qmul, qadd, qdiv, "
          "qcast (onto the card), qreduce, a QTable and a checkpoint equals "
          "hostops")

    # the host GEMM: wart raws of a 32-bit lane format (beyond its int32
    # word) against a lane operand on the card, on the native engine
    m, k, n = HOST_GEMM
    f31 = qt.qformat(31, 0)
    w62 = qt.qformat(62, 0)
    ar = rng.randint(f31.raw_min, f31.raw_max + 1, (m, k)).astype(object)
    ar[::7] += 1 << 40
    a = qt.from_raw(ar, f31, dev)
    b = qt.from_raw(rng.randint(f31.raw_min, f31.raw_max + 1, (k, n)), f31,
                    dev)
    assert a.is_host and not b.is_host
    g = drive("i2", f"host qgemul [{m}, {k}] @ [{k}, {n}] ({f31} wart raws "
              "against card lanes, the native engine)",
              lambda: qt.qgemul(a, b, w62, mul_to=w62, add_formats=(w62,)),
              {})
    assert g.device == dev and g.is_pair, "i2 host GEMM: no pair on the card"
    nat = native.tree_gemm_host(a.raw(), b.raw(), f31, f31, w62, (w62,), w62)
    assert nat is not None and np.array_equal(g.raw(), nat)
    cn = LIMB_CORNER
    host = qt.host_qgemul(a[:cn], qt.QTensor(b.data[:, :cn], f31), w62,
                          mul_to=w62, add_formats=(w62,))
    assert np.array_equal(g.raw()[:cn, :cn], host), "i2 host GEMM corner"
    m, k, n = HOST_WIDE_GEMM
    f4200 = qt.qformat(4200, 0)
    wides = {"Qu<600,600>": (h1[:m, :k], h2[:k, :n], fh, {}),
             "8,401-bit products": (
                 qt.random_fill((m // 2, k // 2), f4200, 25, dev),
                 qt.random_fill((k // 2, n // 2), f4200, 26, dev), fh,
                 {"mul_full_prec": True})}
    for name, (x, y, out, kw) in wides.items():
        got = drive("i2", f"host qgemul {list(x.shape)} @ {list(y.shape)} "
                    f"({name})", lambda: qt.qgemul(x, y, out, **kw), {})
        mul = qt.mul_merge(x.fmt, y.fmt, None, kw.get("mul_full_prec", False))
        route = "the native multiword engine" if native.tree_gemm_host(
            x.raw(), y.raw(), x.fmt, y.fmt, mul, (), out) is not None \
            else "the Python model"
        assert np.array_equal(got.raw(), qt.host_qgemul(x, y, out, **kw)), \
            f"i2 host GEMM {name}"
        print(f"main path i2: host qgemul {name} on {route} equals "
              "host_qgemul")
    return drive.launches


# ---------------------------------------------------------------------------
# path j: the sharded surface (qublas_tpu_torch.parallel) in worlds of ranks
# ---------------------------------------------------------------------------

MULTI_RANK = ("Gloo through host memory, 4 ranks on one card: not an "
              "NVLink figure")


def j_counters():
    """(name, owner, attribute) of each kernel's launch count."""
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.ops.reduce import qreduce_kernel
    from qublas_tpu_torch.ops.tree_gemm import (tree_gemm, tree_gemm_hybrid,
                                                tree_gemm_stream)

    return (("K1", fused_int8_gemm, "launches"),
            ("K2", tree_gemm, "launches"),
            ("K2'", tree_gemm_stream, "launches"),
            ("K2h", tree_gemm_hybrid, "mma_launches"),
            ("K2h digits", tree_gemm_hybrid, "digit_launches"),
            ("K3", qreduce_kernel, "launches"))


def j_operands(dev, sizes):
    """j3's global operands, the same on every rank (a seeded generator on
    the device): the pipeline's first GEMM at n^3, the canonical tree and
    the hybrid configuration at tn^3, config 2's qreduce input (``sizes``:
    n, tn, the reduce shape, the hybrid batch)."""
    import torch

    import qublas_tpu_torch as qt

    fa, wide, mid = qt.pipeline_formats()
    f88z, f44, config2 = formats()
    hfa, hmul, hlayers, hout = hybrid_config()
    gen = torch.Generator(device=dev).manual_seed(31)

    def lanes(fmt, shape, dtype):
        # raws of the format that the lane holds (config 2's int8 lanes
        # hold Qu<4,4> raws in [-128, 127], as bench.py feeds them)
        info = torch.iinfo(dtype)
        return qt.QTensor(torch.randint(max(fmt.raw_min, info.min),
                                        min(fmt.raw_max, info.max) + 1,
                                        shape, generator=gen, device=dev,
                                        dtype=dtype), fmt)

    n, tn, reduce_shape, _ = sizes
    return {"a": lanes(fa, (n, n), torch.int8),
            "b": lanes(fa, (n, n), torch.int8),
            "a2": lanes(f88z, (tn, tn), torch.int32),
            "b2": lanes(f88z, (tn, tn), torch.int32),
            "x": lanes(f44, reduce_shape, torch.int8),
            "ah": lanes(hfa, (tn, tn), torch.int8),
            "bh": lanes(hfa, (tn, tn), torch.int8),
            "gemm": (mid, dict(mul_to=wide, add_formats=(wide,))),
            "tree": f88z, "config2": config2,
            "hybrid": (hout, dict(mul_to=hmul, add_formats=hlayers))}


def sharded_rank(world: int, device: str, sizes, programs="eager") -> dict:
    """Path j on one rank of a world (every rank runs it), its meshes'
    strategies run as ``programs`` says (``make_mesh``'s).  Eagerly: the
    dry-run sequence on each mesh of the world, then, given ``sizes`` (see
    ``j_operands``), j3's cases at those sizes, each held Δ=0 to the
    single-device call and, on the card, to the launches it must make on
    this rank.  Compiled: j3's cases only, each also held Δ=0 to the same
    call on an eager mesh of its shape, its launches counted inside the
    compiled programs.  Returns this rank's record."""
    import statistics

    import torch
    import torch.distributed as dist

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.parallel import (choose_strategy, make_mesh,
                                           shard_qgemul,
                                           sharded_qgemul_k,
                                           sharded_qgemul_k_pipelined,
                                           sharded_qgemul_k_tree,
                                           sharded_qgemul_mn,
                                           sharded_qreduce)
    from qublas_tpu_torch.parallel.dryrun import dryrun_rank
    from qublas_tpu_torch.parallel.sharding import _k_tree_split
    from qublas_tpu_torch.timing import timeit

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev.index or 0)
    rank = dist.get_rank()

    def sync():
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()

    shapes = [(1, 1)] if world == 1 else [(2, 2), (1, 4)]
    meshes = {s: make_mesh(s[0], s[1], dev, programs) for s in shapes}
    compiled = programs != "eager"
    eager = {s: make_mesh(s[0], s[1], dev, "eager") for s in shapes} \
        if compiled else meshes
    rec = {"rank": rank, "backend": dist.get_backend(), "dry": [],
           "cases": [], "launches": {}}
    for shape, mesh in meshes.items():
        if compiled:
            break
        sync()
        t0 = time.perf_counter()
        names = dryrun_rank(mesh)
        sync()
        rec["dry"].append((shape, len(names), time.perf_counter() - t0))
    counters = j_counters()
    rec["launches"] = {name: 0 for name, _, _ in counters}
    if sizes:
        m22, m14 = meshes[(2, 2)], meshes[(1, 4)]
        e22, e14 = eager[(2, 2)], eager[(1, 4)]
        o = j_operands(dev, sizes)
        a, b, a2, b2, x, ah, bh = (o[k] for k in ("a", "b", "a2", "b2", "x",
                                                  "ah", "bh"))
        mid, gk = o["gemm"]
        f88z, config2 = o["tree"], o["config2"]
        hout, hk = o["hybrid"]
        ah3 = qt.QTensor(ah.data.reshape(sizes[3], -1, ah.shape[1]),
                         ah.fmt)
        picks = {"i1 auto": choose_strategy(ah, bh, hout, m22, **hk),
                 "i1 batch auto": choose_strategy(ah3, bh, hout, m22, **hk)}
        rec["picks"] = picks
        single = {
            "gemm": lambda: qt.qgemul(a, b, mid, **gk),
            "tree": lambda: qt.qgemul(a2, b2, f88z),
            "reduce": lambda: qt.qreduce(x, config2, axis=1),
            "hybrid": lambda: qt.qgemul(ah, bh, hout, **hk),
            "hybrid batch": lambda: qt.qgemul(ah3, bh, hout, **hk)}
        refs = {k: f() for k, f in single.items()}
        n, tn, reduce_shape, _ = sizes
        # each case's call, given the (1, 4) and (2, 2) meshes
        cases = [
            ("k psum", f"sharded_qgemul_k (1, 4), {n}^3", "gemm",
             lambda m14, m22: sharded_qgemul_k(a, b, mid, m14, **gk),
             {"K1": 1}),
            ("k reduce-scatter", f"sharded_qgemul_k reduce_scatter (1, 4), "
             f"{n}^3", "gemm", lambda m14, m22: sharded_qgemul_k(
                 a, b, mid, m14, reduce_scatter=True, **gk), {"K1": 1}),
            ("k pipelined", f"sharded_qgemul_k_pipelined (1, 4), {n}^3",
             "gemm", lambda m14, m22: sharded_qgemul_k_pipelined(
                 a, b, mid, m14, **gk), {"K1": 4}),
            ("mn canonical", f"sharded_qgemul_mn (2, 2), {tn}^3", "tree",
             lambda m14, m22: sharded_qgemul_mn(a2, b2, f88z, m22),
             {"K2'": 1}),
            ("k_tree butterfly", f"sharded_qgemul_k_tree (1, 4), {tn}^3, "
             f"s = {_k_tree_split(tn, 4)[0]}, two butterfly rounds", "tree",
             lambda m14, m22: sharded_qgemul_k_tree(a2, b2, f88z, m14),
             {"K2'": 1}),
            ("k_tree gather", f"sharded_qgemul_k_tree butterfly=False "
             f"(1, 4), {tn}^3", "tree",
             lambda m14, m22: sharded_qgemul_k_tree(
                 a2, b2, f88z, m14, butterfly=False), {"K2'": 1, "K3": 1}),
            ("qreduce", f"sharded_qreduce config 2 {list(reduce_shape)} "
             "(2, 2)", "reduce", lambda m14, m22: sharded_qreduce(
                 x, config2, axis=1, mesh=m22), {"K3": 1}),
            ("hybrid auto", f"shard_qgemul(auto) i1 (2, 2), {tn}^3, chose "
             f"{picks['i1 auto']}", "hybrid",
             lambda m14, m22: shard_qgemul(ah, bh, hout, m22, **hk),
             {"K2h": 1}),
            ("hybrid batch auto", f"shard_qgemul(auto) i1 "
             f"{list(ah3.shape)} (2, 2), chose {picks['i1 batch auto']}",
             "hybrid batch",
             lambda m14, m22: shard_qgemul(ah3, bh, hout, m22, **hk),
             {"K2h": 1}),
        ]
        for key, label, ref_key, call, expect in cases:
            def fn(call=call):
                return call(m14, m22)
            sync()
            for _, owner, attr in counters:
                setattr(owner, attr, 0)
            moved = m14.stats["bytes"] + m22.stats["bytes"]
            t0 = time.perf_counter()
            got = fn()
            sync()
            first = time.perf_counter() - t0
            moved = m14.stats["bytes"] + m22.stats["bytes"] - moved
            launches = {name: getattr(owner, attr)
                        for name, owner, attr in counters}
            want = {name: 0 for name, _, _ in counters}
            want.update(expect)
            if on_card:
                check_launches(f"path j3 {key} rank {rank}", launches, want)
            for name, v in launches.items():
                rec["launches"][name] += v
            ref = refs[ref_key]
            assert got.fmt == ref.fmt and got.shape == ref.shape, key
            assert torch.equal(got.data, ref.data), \
                f"path j3 {key}: rank {rank} != the single-device call"
            if compiled:
                ref = call(e14, e22)
                assert got.fmt == ref.fmt and torch.equal(got.data,
                                                          ref.data), \
                    f"path j3 {key}: rank {rank} compiled != eager"
            walls = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                walls.append(time.perf_counter() - t0)
            sync()
            single_ms = timeit(single[ref_key], runs=5, warmup=1) \
                if rank == 0 and on_card and not compiled else None
            sync()
            rec["cases"].append({
                "key": key, "label": label, "launches": launches,
                "first_ms": first * 1e3,
                "ms": statistics.median(walls) * 1e3,
                "single_ms": single_ms, "bytes": moved})
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "qublas_tpu" or m.startswith("qublas_tpu.")]
    assert not bad, f"rank {rank} imported {bad}"
    return rec


def compiled_dry_rank(device: str, backend: str, mode: str) -> tuple:
    """Path j1's compiled programs, in a world of 1 on NCCL: the dry-run
    sequence with the first call of each strategy (every strategy, one
    program each) compiled by ``backend`` in ``mode``: the default mode or
    CUDA graphs (``"reduce-overhead"``), held Δ=0 to the same call on an
    eager mesh, and every call to the single-device call.  In CUDA graphs
    the sequence runs three times on its first operands (warm-up, record,
    replay), then on two fresh draws of operands of the same shapes, each
    compiled call a replay.  Returns (mode, calls checked, seconds a run,
    programs cached)."""
    import torch

    from qublas_tpu_torch.parallel import make_mesh
    from qublas_tpu_torch.parallel import sharding as S
    from qublas_tpu_torch.parallel.dryrun import dryrun_rank

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev.index or 0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    eager = make_mesh(1, 1, dev, "eager")
    programs = {"backend": backend}
    if mode != "default":
        programs["mode"] = mode
    mesh = make_mesh(1, 1, dev, programs)
    runs = []
    for seed in ((1,) if mode == "default" else (1, 1, 1, 2, 3)):
        sync()
        t0 = time.perf_counter()
        names = dryrun_rank(mesh, seed=seed, eager=eager)
        sync()
        runs.append(time.perf_counter() - t0)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                          "qublas_tpu")]
    assert not bad, f"the rank imported {bad}"
    return mode, len(names), runs, len(S._PROGRAM_CACHE)


def phase_sharded(card):
    """Phase 3j: ``qublas_tpu_torch.parallel`` on the card: j1 the dry-run
    sequence in a world of 1 on NCCL (mesh (1, 1)); j2 the same in a Gloo
    world of 4 ranks sharing the card (meshes (2, 2) and (1, 4), the
    butterfly at tp = 4); j3 in that world at full width (the pipeline's
    first GEMM at SHARD_PIPE_N^3 by k, its reduce-scatter and its ring;
    the canonical tree at SHARD_TREE_N^3 by mn and k_tree with and without
    the butterfly; config 2's qreduce batch-sharded; the hybrid
    configuration through shard_qgemul(auto), 2-D and batched), each Δ=0
    to the single-device call, each rank's K1, K2, K2h and K3 launches
    held to what the case must launch.  A failed rank, a mismatch or a
    timeout fails the run."""
    from qublas_tpu_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    (r1,) = run_world(1, "nccl", sharded_rank, (1, "cuda", None),
                      timeout=SHARD_TIMEOUT)
    t1 = time.perf_counter()
    for shape, count, sec in r1["dry"]:
        print(f"path j1: dry run on a world of 1 ({r1['backend']}), mesh "
              f"{shape}: {count} calls equal to the single-device port, "
              f"{sec:.3f} s [{card}]")
    print(f"path j1: the world of 1 in {t1 - t0:.1f} s wall, spawn "
          f"included [{card}]")
    sizes = (SHARD_PIPE_N, SHARD_TREE_N, REDUCE_SHAPE, HYB_BATCH)
    ranks = run_world(SHARD_WORLD, "gloo", sharded_rank,
                      (SHARD_WORLD, "cuda", sizes), timeout=SHARD_TIMEOUT)
    t2 = time.perf_counter()
    for r in ranks:
        for shape, count, sec in r["dry"]:
            assert count == ranks[0]["dry"][0][1], (r["rank"], shape, count)
    for shape, count, sec in ranks[0]["dry"]:
        print(f"path j2: dry run on a world of {SHARD_WORLD} "
              f"({ranks[0]['backend']}, every rank on cuda:0), mesh {shape}:"
              f" {count} calls equal to the single-device port on every "
              f"rank, {sec:.3f} s on rank 0 [{MULTI_RANK}] [{card}]")
    print(f"path j3: shard_qgemul(auto) chose {ranks[0]['picks']}")
    for i, c in enumerate(ranks[0]["cases"]):
        print(f"path j3 {c['key']}: {c['label']}: Δ=0 to the single-device "
              f"call on all {SHARD_WORLD} ranks; rank 0 "
              f"{c['ms']:.3f} ms a call (median of 3, first call "
              f"{c['first_ms']:.3f} ms), single-device "
              f"{c['single_ms']:.4f} ms; {c['bytes']} collective bytes a "
              f"rank; launches a rank "
              f"{[r['cases'][i]['launches'] for r in ranks]} [{MULTI_RANK}]"
              f" [{card}]")
    for r in ranks:
        print(f"path j launches rank {r['rank']}: {r['launches']}")
    for name in ("K1", "K2'", "K2h", "K3"):
        assert all(r["launches"][name] > 0 for r in ranks), name
    print(f"path j: the world of {SHARD_WORLD} in {t2 - t1:.1f} s wall, "
          f"spawn included; no rank imported JAX [{MULTI_RANK}] [{card}]")
    phase_sharded_compiled(card, ranks, sizes)
    return ranks


def phase_sharded_compiled(card, eager_ranks, sizes):
    """Path j's compiled programs, in worlds of their own: j1 every
    strategy's program compiled by Inductor, default mode and CUDA graphs,
    in a world of 1 on NCCL (``compiled_dry_rank``); j3's cases compiled
    (default mode) in a Gloo world of 4, each Δ=0 to the eager call and to
    the single-device call on every rank and held to the eager case's
    launches, counted inside the compiled programs."""
    from qublas_tpu_torch.parallel.launch import run_world, start_world

    t0 = time.perf_counter()
    # the two modes in two worlds of 1 at once (their compiles share the
    # host's cores)
    worlds = [start_world(1, "nccl", compiled_dry_rank,
                          ("cuda", COMPILE_BACKEND, mode),
                          timeout=SHARD_COMPILE_TIMEOUT)
              for mode in COMPILE_MODES]
    try:
        r1 = [w.join()[0] for w in worlds]
    finally:
        for w in worlds:
            w.stop()
    t1 = time.perf_counter()
    for mode, count, runs, cached in r1:
        print(f"path j1 compiled ({COMPILE_BACKEND}, {mode}): the dry run's "
              f"{count} calls Δ=0 to the single-device call, the first "
              f"call of each strategy compiled ({cached} programs) and Δ=0 "
              f"to the eager call; first run {runs[0]:.1f} s (compiles "
              f"included), later runs "
              f"{', '.join(f'{r:.3f}' for r in runs[1:]) or 'none'} s"
              + ("; runs 4-5 on fresh operands, every compiled call a "
                 "CUDA-graph replay" if len(runs) > 1 else "")
              + f" [{card}]")
    print(f"path j1 compiled: both worlds of 1 in {t1 - t0:.1f} s wall, "
          f"spawns included [{card}]")
    ranks = run_world(SHARD_WORLD, "gloo", sharded_rank,
                      (SHARD_WORLD, "cuda", sizes,
                       {"backend": COMPILE_BACKEND}),
                      timeout=SHARD_COMPILE_TIMEOUT)
    t2 = time.perf_counter()
    for i, c in enumerate(ranks[0]["cases"]):
        e = eager_ranks[0]["cases"][i]
        assert c["key"] == e["key"]
        for r, er in zip(ranks, eager_ranks):
            assert r["cases"][i]["launches"] == er["cases"][i]["launches"], \
                (c["key"], r["rank"])
        print(f"path j3 compiled {c['key']}: {c['label']}: Δ=0 to the "
              f"eager and the single-device call on all {SHARD_WORLD} "
              f"ranks, the eager launches on each; rank 0 first call "
              f"{c['first_ms'] / 1e3:.1f} s (compile included), then "
              f"{c['ms']:.3f} ms a call (median of 3); eager first call "
              f"{e['first_ms']:.3f} ms, {e['ms']:.3f} ms a call; "
              f"{c['bytes']} collective bytes a rank (eager {e['bytes']}) "
              f"[{MULTI_RANK}] [{card}]")
        assert c["bytes"] == e["bytes"], c["key"]
    print(f"path j3 compiled: the world of {SHARD_WORLD} in {t2 - t1:.1f} s "
          f"wall, spawn included [{MULTI_RANK}] [{card}]")


def phase_differential(card):
    """Phase 3k: the card differential (``qublas_tpu_torch.fuzz``): every
    family at ``DIFF_TRIALS`` trials, the curated route cases and the
    sharded families in a spawned Gloo world of 2, each trial held to the
    host oracle and, in the kernel families, each kernel launch to its
    plain version on CPU copies; then the coverage gate (each of the seven
    kernel rows launched at least ``fuzz.MIN_LAUNCHES`` times, K2's six and
    K2′'s five instantiations launched, ``fuzz.MIN_PAIRS`` mode pairs on K1's
    epilogue, K2's run-time instantiations and K3), and the three examples'
    ``main("cuda")``.  A mismatch, a crash or a gate finding fails the
    run; these launches count in no row of the kernels line."""
    from qublas_tpu_torch import _build, fuzz
    from qublas_tpu_torch.examples import (asic_datapath_sim,
                                           sharded_deployment,
                                           wide_formats_and_sharding)

    t0 = time.perf_counter()
    res = fuzz.run(DIFF_TRIALS, "cuda")  # a line a family and a kernel
    print("path k launches " + json.dumps(
        {r["name"]: {"launches": r["launches"],
                     "mode_pairs": r["mode_pairs"]}
         for r in res["kernels"]}))
    assert res["fails"] == 0, f"path k: {res['fails']} mismatches"
    assert not res["gate"], f"path k gate: {res['gate']}"
    t1 = time.perf_counter()
    ckpt = _build.BUILD_DIR / "examples"
    ckpt.mkdir(parents=True, exist_ok=True)
    asic_datapath_sim.main("cuda", str(ckpt / "datapath_ckpt.npz"))
    wide_formats_and_sharding.main("cuda")
    sharded_deployment.main("cuda", str(ckpt / "deployment_ckpt.npz"))
    t2 = time.perf_counter()
    print(f"path k: the examples on the card in {t2 - t1:.1f} s wall, "
          f"their worlds' spawns included [{card}]")
    print(f"path k: {res['trials']} trials, 0 mismatches, the gate met, "
          f"{t2 - t0:.1f} s wall [{card}]")


COMPILE_BACKEND = "inductor"     # l: rehearse on the CPU with "aot_eager"
COMPILE_MODES = ("default", "reduce-overhead")


def l_programs(dev, state_a, state_b):
    """Path l's programs, each ``(name, fn, args, fresh, expect, check)``:
    ``fn`` the function compiled, ``args`` its inputs, ``fresh(seed)`` new
    inputs of the same shapes for the CUDA graph's replays, ``expect`` the
    launches one compiled call must make, ``check(out, args)`` the plain
    versions and the host corners that hold the eager result on ``args``."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import bitwise, hostops
    from qublas_tpu_torch.ops.chain_probe import (G, T1, chain_probe,
                                                  chain_probe_plain,
                                                  probe_tile)
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm_plain
    from qublas_tpu_torch.ops.reduce import qreduce_plain
    from qublas_tpu_torch.ops.tree_gemm import (plan_hybrid,
                                                tree_gemm_hybrid_plain,
                                                tree_gemm_plain)

    cn = CORNER
    gen = torch.Generator(device=dev).manual_seed(31)

    def rand(fmt, shape, dtype, seed=None):
        g = gen if seed is None else \
            torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(max(fmt.raw_min, torch.iinfo(dtype).min),
                             min(fmt.raw_max, torch.iinfo(dtype).max) + 1,
                             shape, generator=g, device=dev, dtype=dtype)

    def host_corner(what, got, a, b, out, **kw):
        host = qt.host_qgemul(a[:cn], qt.QTensor(b.data[:, :cn], b.fmt),
                              out, **kw)
        assert np.array_equal(got.cpu().numpy()[:cn, :cn].astype(object),
                              host), f"path l {what}: corner vs hostops"

    progs = []

    # the pipeline at the main path's full width: K1 twice
    x, pipe, plan1, mid = state_a[:4]
    fa, wide = pipe.fa, pipe.wide

    def pipe_check(y, args):
        h1 = qt.QTensor(fused_int8_gemm_plain(args[0], pipe.w1,
                                              plan1.prod_frac, mid), mid)
        h = qt.build_table(qt.sqrt_func, mid)(h1).astype(fa)
        same_q("path l pipeline == plain", y, fused_int8_gemm_plain(
            h.data, pipe.w2, plan1.prod_frac, mid))
        host_corner("pipeline", y, h, qt.QTensor(pipe.w2, fa), mid,
                    mul_to=wide, add_formats=(wide,))
    progs.append((f"pipeline {PIPE_N}^3", pipe, (x,),
                  lambda s: (rand(fa, (PIPE_N, PIPE_N), torch.int8, s),),
                  {"fused_int8_gemm": 2}, pipe_check))

    # the canonical tree at 2048^3 (on K2′), qreduce of its rows, K2 on
    # the same operands: K2′, K3 and K2 once each
    a2, b2, tplan, f88z = state_a[4:8]
    lay = (qt.qformat(10, 6),)
    r_plan = qt.ops.reduce.plan_reduce(f88z, lay, TREE_N)

    def tree(a, b):
        c = qt.qgemul(qt.QTensor(a, f88z), qt.QTensor(b, f88z), f88z)
        return (c.data, qt.qreduce(c, lay, axis=1).data,
                qt.ops.tree_gemm.tree_gemm(a, b, tplan, f88z))

    def tree_check(out, args):
        c = tree_gemm_plain(args[0], args[1], tplan, f88z)
        same_q("path l canonical qgemul == plain", out[0], c)
        same_q("path l qreduce of its rows == plain", out[1],
               qreduce_plain(c, 1, r_plan))
        same_q("path l K2 == plain", out[2], c)
        host_corner("canonical", out[0], qt.QTensor(args[0], f88z),
                    qt.QTensor(args[1], f88z), f88z)
    progs.append((f"canonical qgemul {TREE_N}^3, qreduce, K2", tree,
                  (a2.data, b2.data),
                  lambda s: (rand(f88z, (TREE_N, TREE_N), torch.int32, s),
                             rand(f88z, (TREE_N, TREE_N), torch.int32,
                                  s + 100)),
                  {"tree_gemm": 1, "qreduce_kernel": 1,
                   "tree_gemm_stream": 1}, tree_check))

    # BASELINE config 2's qreduce: K3 once
    xr, c2_plan = state_b[:2]
    f44, config2 = formats()[1:]

    def reduce2(x):
        return qt.qreduce(qt.QTensor(x, f44), config2, axis=1).data

    def reduce_check(r, args):
        same_q("path l config 2 qreduce == plain", r,
               qreduce_plain(args[0], 1, c2_plan))
        rows = args[0][:cn].cpu().numpy()
        for i in range(cn):
            raw, _ = hostops.qreduce_list([(int(v), f44) for v in rows[i]],
                                          config2)
            assert raw == int(r[i]), ("path l config 2 row", i)
    progs.append((f"config 2 qreduce {list(REDUCE_SHAPE)}", reduce2,
                  (xr.data,),
                  lambda s: (rand(f44, REDUCE_SHAPE, torch.int8, s),),
                  {"qreduce_kernel": 1}, reduce_check))

    # i1 on both K2h routes: int8 lanes (tensor cores), int16 (the digit
    # kernel)
    hfa, hmul, hlay, hout = hybrid_config()
    hp = plan_hybrid(hfa, hfa, qt.mul_merge(hfa, hfa, hmul), hlay, HYB_N,
                     hout)

    def hybrid(a, b):
        def one(x, y):
            return qt.qgemul(qt.QTensor(x, hfa), qt.QTensor(y, hfa), hout,
                             mul_to=hmul, add_formats=hlay).data
        return one(a, b), one(a.to(torch.int16), b.to(torch.int16))

    def hybrid_check(out, args):
        plain = tree_gemm_hybrid_plain(args[0], args[1], hp, hout)
        same_q("path l i1 (tensor-core kernel) == plain", out[0], plain)
        same_q("path l i1 (digit kernel) == plain", out[1], plain)
        host_corner("i1", out[0], qt.QTensor(args[0], hfa),
                    qt.QTensor(args[1], hfa), hout, mul_to=hmul,
                    add_formats=hlay)

    def hybrid_args(s):
        return (rand(hfa, (HYB_N, HYB_N), torch.int8, s),
                rand(hfa, (HYB_N, HYB_N), torch.int8, s + 100))
    progs.append((f"i1 hybrid qgemul {HYB_N}^3, int8 and int16 lanes",
                  hybrid, hybrid_args(41), hybrid_args,
                  {"tree_gemm_hybrid_mma": 1, "tree_gemm_hybrid_digits": 1},
                  hybrid_check))

    # config 5's TF cgemul: K1 four times
    cf, cwide, cout, tf_kw, _ = config5()

    def cgemul(ar, ai, br, bi):
        c = qt.cgemul(qt.complex_from_parts(qt.QTensor(ar, cf),
                                            qt.QTensor(ai, cf)),
                      qt.complex_from_parts(qt.QTensor(br, cf),
                                            qt.QTensor(bi, cf)),
                      cout, algo="tf", add_formats=(cwide,), **tf_kw)
        return c.real.data, c.imag.data

    def cgemul_check(out, args):
        with plain_dots():
            ref = cgemul(*args)
        same_q("path l config 5 real == plain dots", out[0], ref[0])
        same_q("path l config 5 imag == plain dots", out[1], ref[1])

    def cgemul_args(s):
        return tuple(rand(cf, (CPLX_N, CPLX_N), torch.int8, s + i)
                     for i in range(4))
    progs.append((f"config 5 TF cgemul {CPLX_N}^3", cgemul,
                  cgemul_args(51), cgemul_args, {"fused_int8_gemm": 4},
                  cgemul_check))

    # P1 at measured_chain_prods' shapes: one launch
    xp, yp = probe_tile(f88z, dev)

    def probe(x, y):
        return chain_probe(x, y, tplan, T1, G)

    def probe_check(out, args):
        same_q("path l P1 == plain", out,
               chain_probe_plain(args[0], args[1], tplan, T1, G))
    progs.append((f"P1 T={T1}, {G} programs", probe, (xp, yp),
                  lambda s: (rand(f88z, xp.shape, torch.int32, s),
                             rand(f88z, xp.shape, torch.int32, s + 100)),
                  {"chain_probe": 1}, probe_check))

    n = EW_N
    # the lane chain and qapprox on lanes (phase h4's segments)
    fx, fc = anus_cases()["lane"]
    segs = anus_segments(fc, dev)
    to53 = qt.qformat(5, 3)

    def lanes(a, b):
        x, y = qt.QTensor(a, fx), qt.QTensor(b, fx)
        return (qt.qadd(qt.qmul(x, y), x, to=to53).data,
                qt.qapprox(x, segs).data)

    def lanes_check(out, args):
        a, b = (t[:cn, :cn].cpu().numpy() for t in args)
        for i in range(cn):
            for j in range(cn):
                u, v = (int(a[i, j]), fx), (int(b[i, j]), fx)
                want = hostops.qadd(hostops.qmul(u, v), u, to=to53)[0]
                assert want == int(out[0][i, j]), ("path l lanes", i, j)
                assert host_qapprox(int(a[i, j]), fx, segs) == \
                    int(out[1][i, j]), ("path l qapprox", i, j)
    progs.append((f"lane chain and qapprox {n}^2", lanes,
                  (rand(fx, (n, n), torch.int8, 61),
                   rand(fx, (n, n), torch.int8, 62)),
                  lambda s: (rand(fx, (n, n), torch.int8, s),
                             rand(fx, (n, n), torch.int8, s + 100)),
                  {}, lanes_check))

    # pair storage: qadd, qxor with an int32 lane, qdiv
    f40, f32 = qt.qformat(30, 9), qt.qformat(15, 10)
    to_add, to_div = qt.qformat(44, 12), qt.qformat(33, 4)

    def pairs(p, q, w):
        x, y = qt.QTensor(p, f40), qt.QTensor(q, f40)
        return (qt.qadd(x, y, to=to_add).data,
                bitwise.qxor(x, qt.QTensor(w, f32)).data,
                qt.qdiv(x, y, to=to_div).data)

    def pair_args(s):
        return (rand(f40, (n, n), torch.int64, s),
                rand(f40, (n, n), torch.int64, s + 100),
                rand(f32, (n, n), torch.int32, s + 200))

    def pairs_check(out, args):
        p, q, w = (t[:cn, :cn].cpu().numpy() for t in args)
        for i in range(cn):
            for j in range(cn):
                u, v = (int(p[i, j]), f40), (int(q[i, j]), f40)
                assert hostops.qadd(u, v, to=to_add)[0] == \
                    int(out[0][i, j]), ("path l pair qadd", i, j)
                assert int(p[i, j]) ^ int(w[i, j]) == int(out[1][i, j]), \
                    ("path l pair qxor", i, j)
                assert hostops.qdiv(u, v, to=to_div)[0] == \
                    int(out[2][i, j]), ("path l pair qdiv", i, j)
    progs.append((f"pair chain {n}^2", pairs, pair_args(71), pair_args, {},
                  pairs_check))

    # limb storage: qmul and qadd on three limbs (121- and 91-bit operands
    # took 47 s a compile; the bit-serial qdiv's graph is left to the CPU
    # tests: PERF.md)
    fl1, fl2, to_l = qt.qformat(50, 29), qt.qformat(40, 30), \
        qt.qformat(60, 30)

    def limbs(a, b):
        x = qt.QTensor(qt.ops.limbint.LimbArray(a), fl1)
        y = qt.QTensor(qt.ops.limbint.LimbArray(b), fl2)
        return (qt.qmul(x, y, to=to_l).data.limbs,
                qt.qadd(x, y, to=to_l).data.limbs)

    def limb_args(s):
        return tuple(rand_limbs(torch.Generator(device=dev).manual_seed(
            s + i), f, (n, n), dev).limbs
            for i, f in enumerate((fl1, fl2)))

    def limbs_check(out, args):
        from qublas_tpu_torch.ops.limbint import ints_from_limbs

        a, b = (ints_from_limbs(t[:, :cn, :cn].cpu()) for t in args)
        got = [ints_from_limbs(t[:, :cn, :cn].cpu()) for t in out]
        for i in range(cn):
            for j in range(cn):
                u, v = (int(a[i, j]), fl1), (int(b[i, j]), fl2)
                assert hostops.qmul(u, v, to=to_l)[0] == int(got[0][i, j]), \
                    ("path l limb qmul", i, j)
                assert hostops.qadd(u, v, to=to_l)[0] == int(got[1][i, j]), \
                    ("path l limb qadd", i, j)
    progs.append((f"limb chain {n}^2", limbs, limb_args(81), limb_args, {},
                  limbs_check))
    return progs


def phase_compiled(dev, card, state_a, state_b):
    """Phase 3l: the port's paths as compiled programs.  Each program of
    :func:`l_programs` is compiled by Inductor (``fullgraph=True``,
    ``dynamic=False``) in the default mode and in ``"reduce-overhead"``
    (CUDA graphs).  The default-mode graph's call is held Δ=0 to the eager
    call, which is held to the plain versions and to hostops on a corner,
    and its launches are counted: every kernel of the program launches
    from inside the graph.  The CUDA graph is replayed on fresh inputs,
    copied into its static inputs, and held Δ=0 to eager on them; a replay
    runs no Python, so it launches no counted kernel.  Prints each
    program's compile seconds and the CUDA-event medians of its eager,
    compiled and replayed calls.  Returns the launches from compiled graphs
    by kernel row; they count in no row of the kernels line."""
    import torch

    from qublas_tpu_torch.ops.chain_probe import chain_probe
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.ops.reduce import qreduce_kernel
    from qublas_tpu_torch.ops.tree_gemm import (tree_gemm, tree_gemm_hybrid,
                                                tree_gemm_stream)
    from qublas_tpu_torch.timing import timeit

    counters = (fused_int8_gemm, tree_gemm, tree_gemm_stream, qreduce_kernel,
                chain_probe,
                ("tree_gemm_hybrid_digits", tree_gemm_hybrid,
                 "digit_launches"),
                ("tree_gemm_hybrid_mma", tree_gemm_hybrid, "mma_launches"))
    drive = Driver(counters)
    flat = torch.utils._pytree.tree_leaves

    def same_out(what, got, ref):
        for i, (g, r) in enumerate(zip(flat(got), flat(ref), strict=True)):
            same_q(f"{what} [{i}]", g, r)

    def counts():
        return {name: getattr(owner, attr)
                for name, owner, attr in drive.counters}

    t_phase = time.perf_counter()
    for name, fn, args, fresh, expect, check in l_programs(dev, state_a,
                                                           state_b):
        torch._dynamo.reset()
        eager = fn(*args)
        check(eager, args)
        secs, ms = {}, {"eager": timeit(lambda: fn(*args))}
        for mode in COMPILE_MODES:
            cf = torch.compile(fn, fullgraph=True, dynamic=False,
                               backend=COMPILE_BACKEND,
                               mode=None if mode == "default" else mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cf(*args)
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
            if mode == "default":
                out = drive(f"l {name}", f"{name}, compiled",
                            lambda: cf(*args), expect)
                same_out(f"path l {name}: compiled == eager", out, eager)
                ms["compiled"] = timeit(lambda: cf(*args))
                continue
            for _ in range(3):          # warm-up, record, replay
                cf(*args)
            for seed in (1001, 1002):
                new = fresh(seed)
                torch.cuda.synchronize()
                before = counts()
                got = [t.clone() for t in flat(cf(*new))]
                torch.cuda.synchronize()
                assert counts() == before, \
                    f"path l {name}: a replay ran Python (re-recorded?)"
                same_out(f"path l {name}: replay on fresh inputs == eager",
                         got, fn(*new))
            ms["replayed"] = timeit(lambda: cf(*args))
            del cf
        print(f"path l {name}: compile {secs['default']:.1f} s (default), "
              f"{secs['reduce-overhead']:.1f} s (reduce-overhead); eager "
              f"{ms['eager']:.4f} ms, compiled {ms['compiled']:.4f} ms, "
              f"CUDA graph replayed {ms['replayed']:.4f} ms [{card}]")
    torch._dynamo.reset()
    launched = {k: v for k, v in drive.launches.items()}
    print("path l launches from compiled graphs " + json.dumps(launched))
    idle = [k for k, v in launched.items() if not v]
    assert not idle, f"path l: no launch from a compiled graph of {idle}"
    print(f"path l: {time.perf_counter() - t_phase:.1f} s wall, every "
          f"kernel row launched from a compiled graph, every CUDA graph "
          f"replay on fresh inputs equal to eager [{card}]")
    return launched


def inductor_caches():
    """Inductor's and Triton's caches inside the checkout (the spawned
    worlds inherit them)."""
    from qublas_tpu_torch import _build

    cache = _build.BUILD_DIR.parent / "inductor"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


K1_SYMBOL = "fused_gemm_s8_kernel"   # K1's tensor-core kernel in a trace
# phase m's traces, for Perfetto, inside the checkout
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "chiprun_out", "traces")


def phase_profile(card, state_a):
    """Phase 3m: ``utils.profiling`` on the card.  ``device_busy`` traces
    one forward of the pipeline at PIPE_N^3, eagerly and as phase l's
    compiled program (Inductor, default mode), each call inside a
    ``record_function`` range: the device's busy seconds, the span from its
    first kernel to its last, the range's device span (``module_s``), the
    busy share and the five device rows that took longest.  Each trace
    must have 0 < busy <= span, rows that sum to busy, and K1's kernel
    twice (one a GEMM).  Then ``roofline_report`` of ``qgemul`` at
    PIPE_N^3 against ``torch._int_mm`` on the same operands."""
    import glob

    import torch
    from torch.profiler import record_function

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.utils.profiling import device_busy, roofline_report

    x, pipe, plan1, mid = state_a[:4]
    fa, wide = pipe.fa, pipe.wide
    compiled = torch.compile(pipe, fullgraph=True, dynamic=False,
                             backend=COMPILE_BACKEND)
    want = pipe(x)
    assert torch.equal(compiled(x), want), "path m: compiled != eager"
    torch.cuda.synchronize()
    for name, fn in (("eager", pipe), ("compiled", compiled)):
        logdir = os.path.join(TRACE_DIR, f"pipeline_{name}")

        def run(fn=fn, name=name):
            with record_function(f"pipeline {name}"):
                fn(x)
        got = device_busy(run, logdir)
        assert got is not None, f"path m {name}: no device rows in the trace"
        with open(max(glob.glob(os.path.join(logdir, "*.pt.trace.json")),
                      key=os.path.getmtime)) as f:
            events = json.load(f)["traceEvents"]
        k1 = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "kernel" and K1_SYMBOL in e["name"]]
        busy, span = got["busy_s"], got["span_s"]
        top = sorted(got["ops"].items(), key=lambda kv: -kv[1])[:5]
        print(f"path m {name}: pipeline {PIPE_N}^3 forward: busy "
              f"{busy * 1e3:.4f} ms, span {span * 1e3:.4f} ms, busy share "
              f"{busy / span:.4f}, module_s "
              f"{got['module_s'] * 1e3 if got['module_s'] else None} ms; "
              f"{len(got['ops'])} device rows, {len(k1)} K1 launches; trace "
              f"{logdir} [{card}]")
        for op, sec in top:
            print(f"path m {name}:   {sec * 1e6:10.1f} us  {op[:100]}")
        assert 0 < busy <= span, (name, busy, span)
        assert abs(sum(got["ops"].values()) - busy) <= 1e-9 * max(busy, 1),             name
        assert any(K1_SYMBOL in op for op in got["ops"]), name
        assert len(k1) == 2, (name, len(k1))

    b = pipe.w1                        # K-major, as the pipeline stores it

    def gemm(a, b):
        return qt.qgemul(qt.QTensor(a, fa), qt.QTensor(b, fa), mid,
                         mul_to=wide, add_formats=(wide,)).data

    def int_mm(a, b):
        # the stream runs its kernels in order: the loop needs no data
        # dependence to time them, and a's dtype must stay int8
        torch._int_mm(a, b)
        return a
    rep = roofline_report(gemm, x, b, 2 * PIPE_N ** 3, baseline_fn=int_mm)
    print(f"path m: roofline_report qgemul {PIPE_N}^3 (K1) against "
          f"torch._int_mm: {rep['gops']:.1f} GOP/s, baseline "
          f"{rep['baseline_gops']:.1f} GOP/s, fraction_of_roofline "
          f"{rep['fraction_of_roofline']:.4f} (interleaved best of 2, 64 "
          f"chained calls a side) [{card}]")
    assert rep["gops"] > 0 and rep["fraction_of_roofline"] > 0


def hybrid_tail_ops(hp, out_fmt, k, classes=1):
    """int32 operations of K2h's tail for one output element as its
    tensor-core kernels run it: the tail's tree of merges over the k / s
    block values (drain converts included) and the final requantize.  Each
    pair of blocks sums in the MMAs' accumulators, so tree level L's merges
    are their requantizes alone (the adds are among the dot operations),
    and a pair, or an odd last block, is shifted once (dl > 0); on digit
    lanes its ``classes`` shift classes' accumulators are summed there, one
    shift-and-add (an IMAD or LEA) for each class past the first."""
    nb = k // hp.s
    rqs = [rq_ops(hp.level_fmts[hp.level + j].frac_bits,
                  hp.merge_fmts[hp.level + j])
           for j in range(max(nb.bit_length(), 1))]
    ops = tree_ops(nb, rqs, lambda l: rqs[l]) + \
        rq_ops(hp.final_fmt.frac_bits, out_fmt)
    sums = (nb + 1) // 2
    return ops - nb // 2 + (sums if hp.dl else 0) + (classes - 1) * sums


# K2h's tensor-core kernels by lane bytes: (MMAs a k16 step and n8 tile,
# shift classes), csrc/tree_gemm_hybrid_mma.cuh's mma_digits and Lanes
K2H_DIGITS = {1: (1, 1), 2: (4, 3), 4: (10, 4)}


def hybrid_mma_bound(hp, out_fmt, m, n, k, out_bytes, lane_bytes=1):
    """Bound of K2h's tensor-core kernel on ``lane_bytes``-byte lanes, the
    largest of three times: the operands in their lanes and the output
    once at the HBM rate, the block dots (2 m n k int8 operations times
    the digit MMAs a product: 1 on int8 lanes, 4 on int16, 10 on int32) at
    the int8 tensor-core rate, and the tail (per output element,
    ``hybrid_tail_ops`` with the lanes' shift classes) at the int32
    rate."""
    mmas, classes = K2H_DIGITS[lane_bytes]
    t_bytes = (lane_bytes * (m * k + k * n) + out_bytes * m * n) / \
        HBM_BYTES_S
    t_dots = mmas * 2 * m * n * k / INT8_OPS_S
    t_tail = m * n * hybrid_tail_ops(hp, out_fmt, k, classes) / INT32_OPS_S
    worst = max(t_bytes, t_dots, t_tail)
    by = "bytes" if worst == t_bytes else "operations"
    return worst * 1e3, by


def hybrid_times(card, state_i, t, bounds, report):
    """Phase 4, path i: K2h's tensor-core kernel on the int8 lanes and its
    digit kernels on int16 and int32 copies of the same operands, in turns
    (int8, int16, int32, int32, int16, int8), by CUDA events and device
    time, beside K2 and K2′ and the plain versions, and ``qgemul`` end to
    end."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.tree_gemm import (_hybrid_tail, k2s_plan,
                                                hybrid_digit_dots_plain,
                                                tree_gemm, tree_gemm_hybrid,
                                                tree_gemm_hybrid_plain,
                                                tree_gemm_stream)
    from qublas_tpu_torch.ops.widths import torch_dtype_for
    from qublas_tpu_torch.timing import device_us, timeit

    lanes = (("k2h", torch.int8), ("k2h_digits", torch.int16),
             ("k2h_digits32", torch.int32))
    for key, suffix in (("i1", ""), ("i1 k2040", "_k2040"),
                        ("i1 k176", "_k176"), ("i1 dl", "_dl")):
        a, b, hp, tp, out, mul, layers = state_i[key]
        m, k = a.shape
        n = b.shape[1]
        ob = torch_dtype_for(out).itemsize
        calls = {}
        for name, lane in lanes:
            x, y = a.data.to(lane), b.data.to(lane)
            calls[name] = (lambda x=x, y=y: tree_gemm_hybrid(x, y, hp, out))
            bounds[name + suffix] = hybrid_mma_bound(hp, out, m, n, k, ob,
                                                     lane.itemsize)
        order = [name for name, _ in lanes]
        turns = {name: [] for name in order}
        for name in order + order[::-1]:
            turns[name].append(timeit(calls[name]))
        us = {}
        for name in order:
            t[name + suffix] = sum(turns[name]) / 2
            us[name] = device_us(calls[name])
        print(f"time tree_gemm_hybrid [{m}, {k}] @ [{k}, {n}] (s = {hp.s}, "
              f"dl = {hp.dl}), in turns: tensor-core kernel (int8) "
              f"{turns['k2h'][0]:.4f}, {turns['k2h'][1]:.4f} ms, "
              f"{m * n * k / t['k2h' + suffix] / 1e6:.2f} Gprod/s, device "
              f"us per call {us['k2h']}; digit kernel on int16 copies "
              f"{turns['k2h_digits'][0]:.4f}, {turns['k2h_digits'][1]:.4f} "
              f"ms, device us per call {us['k2h_digits']}; on int32 copies "
              f"{turns['k2h_digits32'][0]:.4f}, "
              f"{turns['k2h_digits32'][1]:.4f} ms, device us per call "
              f"{us['k2h_digits32']}; int16 / int8 "
              f"{t['k2h_digits' + suffix] / t['k2h' + suffix]:.4f}, "
              f"int32 / int8 "
              f"{t['k2h_digits32' + suffix] / t['k2h' + suffix]:.4f} "
              f"[{card}]")
        if key != "i1":
            continue
        t["k2h_plain"] = timeit(lambda: tree_gemm_hybrid_plain(
            a.data, b.data, hp, out), runs=3, warmup=1)
        a16, b16 = a.data.to(torch.int16), b.data.to(torch.int16)
        t["k2h_digits_plain"] = timeit(lambda: _hybrid_tail(
            hybrid_digit_dots_plain(a16, b16, hp.s), hp, out), runs=3,
            warmup=1)
        t["k2h_qgemul"] = timeit(lambda: qt.qgemul(a, b, out, mul_to=mul,
                                                   add_formats=layers))
        t["k2h_k2"] = timeit(lambda: tree_gemm(a.data, b.data, tp, out),
                             runs=3, warmup=1)
        t["k2h_k2s"] = timeit(lambda: tree_gemm_stream(a.data, b.data, tp,
                                                       out), runs=3, warmup=1)
        k2_us = device_us(lambda: tree_gemm(a.data, b.data, tp, out), runs=3)
        k2s_us = device_us(lambda: tree_gemm_stream(a.data, b.data, tp, out),
                           runs=3)
        print(f"time i1 at {k}^3 on the same operands: K2h "
              f"{t['k2h']:.4f} ms; K2 (plan_tree, modes read at run time) "
              f"{t['k2h_k2']:.4f} ms, device us per call {k2_us}; K2′ "
              f"(k2s_plan {k2s_plan(tp)}, every step read at run time) "
              f"{t['k2h_k2s']:.4f} ms, device us per call {k2s_us}; K2h "
              f"plain (float64 block matmuls, the tail in torch) "
              f"{t['k2h_plain']:.4f} ms, the digit kernels' plain version "
              f"on int16 copies (float64 digit-plane matmuls) "
              f"{t['k2h_digits_plain']:.4f} ms; hybrid qgemul "
              f"{t['k2h_qgemul']:.4f} ms; K2h / K2 "
              f"{t['k2h'] / t['k2h_k2']:.4f} [{card}]")
    a, b, hp, tp, out, mul, layers = state_i["i1 int16"]
    t["k2h_int16_qgemul"] = timeit(lambda: qt.qgemul(
        a, b, out, mul_to=mul, add_formats=layers))
    print(f"time i1 int16: hybrid qgemul {list(a.shape)} @ {list(b.shape)} "
          f"on int16 lanes (the digit kernel) {t['k2h_int16_qgemul']:.4f} ms "
          f"[{card}]")
    for line in resources(report, "tree_gemm_hybrid_mma_kernel"):
        print(f"registers {line}")
    for key in [name + suffix for name, _ in lanes
                for suffix in ("", "_k2040", "_k176", "_dl")]:
        ms, by = bounds[key]
        print(f"bound {key}: {ms:.4f} ms ({by}); measured {t[key]:.4f} ms, "
              f"{ms / t[key] * 100:.1f}% of the bound [{card}]")


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


def limb_times(card, state_g, t, bounds):
    """Phase 4, path g: the limb tier's GEMMs (and f2 on both tiers), g1's
    digit dot beside ``torch._int_mm`` on the same stacked planes, the limb
    elementwise ops, ``qreduce``, the ROM, the streaming GEMM and the
    limb-domain ``cgemul``."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops import cgemm
    from qublas_tpu_torch.ops.fused_gemm import int_dot
    from qublas_tpu_torch.ops.limbdot import balanced_digits, digits_needed
    from qublas_tpu_torch.ops.widths import fmt_interval
    from qublas_tpu_torch.timing import timeit

    gemms, ew_args, ew_cases = state_g["gemms"], *state_g["ew"]
    for key, (a_, b_, kw_, outs_) in gemms.items():
        t[key] = timeit(lambda: [qt.qgemul(a_, b_, o, **kw_) for o in outs_],
                        runs=3, warmup=1)
    a, b, _, _ = gemms["g1"]
    nd = digits_needed(fmt_interval(a.fmt))
    n = a.shape[0]
    ad = balanced_digits(a.data, nd).reshape(nd * n, n)
    bd = balanced_digits(b.data.t(), nd).reshape(nd * n, n).t()
    t["g1_dot"] = timeit(lambda: int_dot(ad, bd), runs=5, warmup=1)
    t["g1_int_mm"] = timeit(lambda: torch._int_mm(ad, bd), runs=5, warmup=1)
    t["g1_digits"] = timeit(lambda: (balanced_digits(a.data, nd),
                                     balanced_digits(b.data.t(), nd)))
    bounds["g1_dot"] = bound_ms(2 * nd * n * n + 4 * (nd * n) ** 2,
                                2 * (nd * n) ** 2 * n, INT8_OPS_S)
    del ad, bd
    for what, (op, _) in ew_cases.items():
        runs = 1 if what.startswith("qdiv") else 3
        t["g4 " + what] = timeit(lambda: op(*ew_args), runs=runs,
                                 warmup=runs - 1)
    r, layers, table, xs, sa, sb, skw = state_g["g5"]
    t["g5 qreduce"] = timeit(lambda: qt.qreduce(r, layers, axis=1))
    t["g5 rom"] = timeit(lambda: table(xs))
    t["g5 stream"] = timeit(lambda: qt.qgemul(sa, sb, sa.fmt, **skw), runs=1,
                            warmup=0)
    ca, cb = state_g["g6"]
    f, tags, cl, out = g6_config()
    t["g6"] = timeit(lambda: qt.cgemul(ca, cb, out, algo="basic",
                                       add_formats=cl, **tags), runs=3,
                     warmup=1)
    for key, (label, _f, _kw, _outs, (m, k, n_), nl) in limb_paths().items():
        print(f"time main path {key} ({label}) {m}x{k}x{n_}: {t[key]:.4f} "
              f"ms for {len(_outs)} output(s), {nl} K1 launch(es) [{card}]")
    print(f"time f2 on its two tiers {PAIR_N}^3, two outputs: limb tier (g2, "
          f"2 K1 launches) {t['g2']:.4f} ms, int64 tier (f2, 134 K1 "
          f"launches) {t['f2']:.4f} ms, limb/int64 {t['g2'] / t['f2']:.4f} "
          f"[{card}]")
    ms, by = bounds["g1_dot"]
    print(f"time g1 digit dot int_dot [{nd * n}, {n}] @ [{n}, {nd * n}] "
          f"(K1, one launch): {t['g1_dot']:.4f} ms, torch._int_mm on the "
          f"same planes {t['g1_int_mm']:.4f} ms (reference), bound {ms:.4f} "
          f"ms ({by}); the digit planes of A and B {t['g1_digits']:.4f} ms "
          f"[{card}]")
    for what in ew_cases:
        print(f"time g4 {what} {EW_N}x{EW_N}: {t['g4 ' + what]:.4f} ms "
              f"[{card}]")
    m, k, n_ = LIMB_STREAM
    print(f"time g5 qreduce of Qu<31,8> pairs into limb layers "
          f"{list(REDUCE_SHAPE)}: {t['g5 qreduce']:.4f} ms; sqrt ROM into "
          f"Qu<90,40> limbs {EW_N}x{EW_N}: {t['g5 rom']:.4f} ms; streaming "
          f"GEMM in limb values {m}x{k}x{n_}: {t['g5 stream']:.4f} ms "
          f"[{card}]")
    print(f"time g6 limb-domain Basic cgemul {LIMB_N}^3 (4 K1 launches): "
          f"{t['g6']:.4f} ms [{card}]")


def ffn_times(card, pipe):
    """Phase 4: K1 at the FFN's first GEMM (``FFN_GEMM``) plain, with the
    pipeline's table in its epilogue, and plain followed by the ROM and
    the cast in plain torch (the glue the table replaces), in turns on the
    same operands; the table's output held to the glue's."""
    import statistics

    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm, kmajor
    from qublas_tpu_torch.timing import timeit

    fa, wide, mid = pipe.fa, pipe.wide, pipe.out_fmt
    m, k, n = FFN_GEMM
    dev = pipe.w1.device
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = kmajor(torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                             dtype=torch.int8))
    pf = qt.exact_plan(fa, fa, qt.mul_merge(fa, fa, wide), (wide,),
                       k).prod_frac
    rom = qt.build_table(qt.sqrt_func, mid)
    entries = rom.table.to(dev)
    calls = {
        "plain": lambda: fused_int8_gemm(x, w, pf, mid),
        "table": lambda: fused_int8_gemm(x, w, pf, mid, pipe.rom, fa),
        "glue": lambda: rom(qt.QTensor(fused_int8_gemm(x, w, pf, mid), mid),
                            entries).astype(fa).data,
    }
    assert torch.equal(calls["table"](), calls["glue"]()), \
        "K1's table != K1, the ROM and the cast"
    got = {key: [] for key in calls}
    for key in list(calls) + list(calls)[::-1]:
        got[key].append(timeit(calls[key]))
    ms = {key: statistics.median(v) for key, v in got.items()}
    bound = max(2 * m * k * n / INT8_OPS_S,
                (m * k + k * n + m * n) / HBM_BYTES_S) * 1e3
    print(f"time fused_int8_gemm {list(FFN_GEMM)} (m, k, n): plain "
          f"{ms['plain']:.4f} ms, with the pipeline's table "
          f"{ms['table']:.4f} ms ({ms['table'] / ms['plain']:.4f} of "
          f"plain), plain then the ROM and the cast in plain torch "
          f"{ms['glue']:.4f} ms; bound {bound:.4f} ms (operations) [{card}]")
    return ms


# phase n: the MoE layer's seed (the cell's draws at one layer)
MOE_SEED = 2 ** 31 + 23
# its ops by name: the plain version of each (ops/library.py) and the
# kernel's row in the kernels line
MOE_OPS = {"rms_norm": ("_n1_plain", "rms_norm",
                        "qublas_tpu_torch/csrc/rms_norm.cu"),
           "fused_gemm_s8": ("_k1_plain", None, None),
           "fused_gemm_s8_grouped": (
               "_grouped_plain", "fused_int8_gemm_grouped",
               "qublas_tpu_torch/csrc/fused_gemm.cu"),
           "mul_requant": ("_g1_plain", "mul_requant",
                           "qublas_tpu_torch/csrc/mul_requant.cu"),
           "moe_combine": ("_c1_plain", "moe_combine",
                           "qublas_tpu_torch/csrc/moe_combine.cu")}


@contextmanager
def recorded_ops(names):
    """Inside: every call of the custom ops ``torch.ops.qublas.<name>``
    made through the namespace (as the port's wrappers call them) is
    recorded in the yielded dict, name -> [args], and then made."""
    import torch

    ns = torch.ops.qublas
    calls = {name: [] for name in names}
    ops = {name: getattr(ns, name) for name in names}

    def recorder(name):
        def call(*args):
            calls[name].append(args)
            return ops[name](*args)
        return call

    for name in names:
        setattr(ns, name, recorder(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(ns, name, ops[name])


def moe_bound(name, args):
    """(ms, by) of one call of the MoE layer's op ``name``: K1 grouped by
    its operations or its operands' and output's bytes, the others by
    their bytes read and written once."""
    a = args[0]
    if name == "fused_gemm_s8_grouped":
        b, out_bytes = args[1], args[4]
        m, k, n = a.shape[0], a.shape[1], b.shape[2]
        return bound_ms(m * k + b.numel() + m * n * out_bytes,
                        2 * m * k * n, INT8_OPS_S)
    if name == "rms_norm":
        return bound_ms(2 * a.numel(), 0, INT8_OPS_S)
    if name == "mul_requant":
        return bound_ms(2 * a.numel() + a.numel() * args[4], 0, INT8_OPS_S)
    shared, d, pos, w, _, out_bytes = args
    return bound_ms(2 * (shared.numel() + d.numel()) + 4 * (pos.numel()
                    + w.numel()) + out_bytes * shared.numel(), 0,
                    INT8_OPS_S)


def phase_moe(dev, chk, card):
    """Phase 3n and its times (module docstring).  Returns the kernels
    line's rows of N1, K1's grouped instantiation, G1 and C1."""
    import torch

    import qublas_tpu_torch as qt
    from gpubench import inputs
    from gpubench.reference import moe_ffn as ref
    from qublas_tpu_torch import moe
    from qublas_tpu_torch.ops import library
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
    from qublas_tpu_torch.timing import timeit

    root = Path(__file__).resolve().parent / "gpubench"
    cfg = json.loads((root / "configs" / "dsv3_moe_int8.json").read_text())
    traffic = json.loads((root / "traffic" / "prefill.json").read_text())
    cfg["num_hidden_layers"] = 1
    w, pool = inputs.make(ref, cfg, dict(traffic, pool=1), MOE_SEED, dev)
    x = pool[0]
    norm = qt.QuantRMSNorm(cfg["hidden_size"], cfg["norm_rms"], dev)
    layer = qt.QuantMoE(
        w["wr"][0].t(), w["bias"][0], w["wg"][0].transpose(1, 2),
        w["wu"][0].transpose(1, 2), w["wd"][0].transpose(1, 2),
        w["sg"][0].t(), w["su"][0].t(), w["sd"][0].t(),
        (cfg["held_first"], cfg["n_routed_experts"]), cfg["n_group"],
        cfg["topk_group"], cfg["num_experts_per_tok"],
        cfg["routed_scaling_factor"])
    print(f"phase n: one dsv3_moe_int8 layer on {tuple(x.shape)} rows, "
          f"experts {layer.first}-{layer.first + layer.count - 1} held")
    counters = ((fused_int8_gemm, "launches"),
                (fused_int8_gemm, "lut_launches"), (moe.rms_norm, "launches"),
                (moe.gated, "launches"), (moe.combine, "launches"))
    for obj, attr in counters:
        setattr(obj, attr, 0)
    with recorded_ops(MOE_OPS) as calls:
        y = layer(norm(x))
        torch.cuda.synchronize()
    check_launches("n rms_norm", moe.rms_norm.launches, 1)
    check_launches("n fused_int8_gemm", fused_int8_gemm.launches, 1 + 3 + 3)
    check_launches("n fused_int8_gemm (table)",
                   fused_int8_gemm.lut_launches, 2)
    check_launches("n mul_requant", moe.gated.launches, 2)
    check_launches("n moe_combine", moe.combine.launches, 1)
    check_launches("n host syncs", layer.syncs, 1)
    print(f"  pairs routed here {layer.pairs} ({layer.pairs / x.shape[0]:.4f}"
          f" a row), held experts empty {layer.empty}, largest group "
          f"{layer.largest} rows")
    want = ref.forward(x, w, cfg)
    chk.same("quant_moe", "the layer against the plain reference",
             y.long(), want)
    launches = {name: len(v) for name, v in calls.items()}
    rows, t = [], {}
    for name, args_list in calls.items():
        plain_name, row_name, source = MOE_OPS[name]
        plain = getattr(library, plain_name)
        op = getattr(torch.ops.qublas, name)
        for i, args in enumerate(args_list):
            chk.same(row_name or "fused_int8_gemm",
                     f"{name} call {i} of the layer, its own arguments",
                     op(*args), plain(*args))
            if row_name is None:
                continue
            ms = timeit(lambda: op(*args))
            plain_ms = timeit(lambda: plain(*args), runs=3, warmup=1)
            bound, by = moe_bound(name, args)
            t.setdefault(row_name, []).append((ms, plain_ms, bound, by))
            print(f"time {name} call {i} "
                  f"{[tuple(a.shape) for a in args if hasattr(a, 'shape')]}"
                  f": {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of it "
                  f"[{card}]")
    for name, (plain_name, row_name, source) in MOE_OPS.items():
        if row_name is None:
            continue
        ms, plain_ms, bound, _ = (sum(v) for v in zip(*[
            (m, p, b, 0) for m, p, b, _ in t[row_name]]))
        by = "operations" if any(b == "operations" for *_, b in
                                 t[row_name]) else "bytes"
        rows.append({"name": row_name, "route": "cuda", "source": source,
                     "replaces": None, "launches": launches[name],
                     "max_abs_err": chk.max_err[row_name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": None})
    return rows


def tree_cell_times(card, f88z):
    """Phase 4: K2 and K2′ on the canonical plan at the tree cells' GEMMs
    (``TREE_CELLS``), each instantiation that ``qk_tree_gemm`` and
    ``qk_tree_gemm_stream`` pick there, and ``qgemul`` on its route, by
    events and device time, Δ=0 to each other."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.tree_gemm import (K2_LOG_BLK, k2s_top,
                                                plan_tree, tree_gemm,
                                                tree_gemm_stream)
    from qublas_tpu_torch.timing import device_us, timeit

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(24)
    for cell, (m, k, n) in TREE_CELLS.items():
        a, b = (torch.randint(f88z.raw_min, f88z.raw_max + 1, shape,
                              generator=gen, device=dev, dtype=torch.int32)
                for shape in ((m, k), (k, n)))
        plan = plan_tree(f88z, f88z, qt.mul_merge(f88z, f88z), (), k, f88z)
        qa, qb = qt.QTensor(a, f88z), qt.QTensor(b, f88z)
        k2 = tree_gemm(a, b, plan, f88z)
        assert torch.equal(tree_gemm_stream(a, b, plan, f88z), k2), cell
        assert torch.equal(qt.qgemul(qa, qb, f88z).data, k2), cell
        k2_top = 8 if (k >> K2_LOG_BLK).bit_length() <= 8 else 32
        for label, fn in (
                (f"tree_gemm (K2, depth {k2_top})",
                 lambda: tree_gemm(a, b, plan, f88z)),
                (f"tree_gemm_stream (K2′, depth {k2s_top(k, 1)})",
                 lambda: tree_gemm_stream(a, b, plan, f88z)),
                ("canonical qgemul", lambda: qt.qgemul(qa, qb, f88z))):
            ms = timeit(fn)
            # the profiler's trace can come back without device rows: once
            # more, then none
            dus = (sum(device_us(fn, runs=10).values())
                   or sum(device_us(fn, runs=10).values()))
            on_dev = (f"device {dus:.2f} us per call, "
                      f"{m * k * n / dus / 1e3:.2f} Gprod/s on the device"
                      if dus else
                      "device time not measured (no device rows traced)")
            print(f"time {cell} [{m}, {k}] @ [{k}, {n}] {label}: event "
                  f"{ms:.4f} ms, {on_dev}; Δ=0 to K2 [{card}]")


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
        with pair_tier(key):
            t[key] = timeit(lambda: [qt.qgemul(a_, b_, o, **kw_)
                                     for o in outs_], runs=3, warmup=1)
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
    ffn_times(card, pipe)
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
    tree_cell_times(card, f88z)
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
    inductor_caches()

    chk = Checker()
    if sys.argv[1:] == ["moe"]:
        print(card)
        print(json.dumps({"kernels": phase_moe(dev, chk, card)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    phase_kernels(dev, chk)
    launches_a, state_a = phase_main_path(dev, chk)
    launches_b, state_b = phase_reduce_path(dev, chk)
    phase_elementwise(dev)
    launches_d, state_d = phase_complex_path(dev, chk)
    launches_e, chain_rate = phase_chain(dev, state_a)
    launches_f, state_f = phase_pair(dev, chk)
    launches_g, state_g = phase_limb(dev, chk)
    launches_h, state_h = phase_lanes(dev, chk, state_a)
    launches_i, state_i = phase_hybrid(dev, chk)
    phase_host(dev)
    phase_sharded(card)
    phase_differential(card)
    phase_compiled(dev, card, state_a, state_b)
    phase_profile(card, state_a)
    t, bounds = phase_times(card, state_a, state_b, state_d, chain_rate,
                            state_f)
    limb_times(card, state_g, t, bounds)
    lane_times(card, state_h, t)
    hybrid_times(card, state_i, t, bounds, report)
    moe_rows = phase_moe(dev, chk, card)
    for line in resources(report, "fused_gemm_s8_kernel") + \
            resources(report, "tree_gemm_tiled_kernel") + \
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
            + launches_f["fused_int8_gemm"] + launches_g["fused_int8_gemm"]
            + launches_h["fused_int8_gemm"], "k1", "k1_plain", "int_mm"),
        row("tree_gemm", "qublas_tpu_torch/csrc/tree_gemm_tiled.cu",
            "qublas_tpu/ops/tree_gemm.py:362",
            launches_f["tree_gemm"], "k2", "k2_plain", None),
        row("tree_gemm_stream",
            "qublas_tpu_torch/csrc/tree_gemm_stream.cuh",
            "qublas_tpu/ops/tree_gemm.py:457",
            launches_a["tree_gemm_stream"] + launches_b["tree_gemm_stream"]
            + launches_f["tree_gemm_stream"] + launches_h["tree_gemm_stream"],
            "k2s", "k2s_plain", None),
        row("qreduce_kernel", "qublas_tpu_torch/csrc/qreduce.cu",
            "qublas_tpu/ops/reduce.py:192",
            launches_b["qreduce_kernel"] + launches_d["qreduce_kernel"],
            "k3", "k3_plain", None),
        row("chain_probe", "qublas_tpu_torch/csrc/chain_probe.cuh",
            "bench.py:408", launches_e, "p1", "p1_plain", None),
        row("tree_gemm_hybrid_mma",
            "qublas_tpu_torch/csrc/tree_gemm_hybrid_mma.cu",
            "qublas_tpu/ops/tree_gemm.py:620",
            launches_i["tree_gemm_hybrid_mma"], "k2h", "k2h_plain", None),
        row("tree_gemm_hybrid_digits",
            "qublas_tpu_torch/csrc/tree_gemm_hybrid_mma.cuh",
            "qublas_tpu/ops/tree_gemm.py:620",
            launches_i["tree_gemm_hybrid_digits"], "k2h_digits",
            "k2h_digits_plain", None),
    ] + moe_rows
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
