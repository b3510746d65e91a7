#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qublas_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines:

1. build the kernels of ``qublas_tpu_torch/csrc`` (nvcc) and print the
   build time, the compiler's register/spill report and the card;
2. hold each kernel against its plain-torch version on the card, bit for
   bit (max |difference| 0), at the main path's shapes, ragged shapes and
   every rounding x overflow mode of the fused epilogue;
3. drive the main path through the public entry points: the quantized GEMM
   pipeline (``QuantPipeline``: GEMM -> sqrt ROM -> cast -> GEMM) at 4096^3
   and the canonical order-sensitive ``qgemul`` at 2048^3, from seeded
   random raws; check that K1 launched twice and K2 once, that the results
   equal the plain versions, and that 16x16 corners equal the exact host
   golden model;
4. time each kernel and its plain version (CUDA events, median of 10 runs
   after warm-up), with torch._int_mm at 4096^3 as the raw int8 reference,
   and the two main-path calls end to end.

The second-to-last line is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

# main-path sizes
PIPE_N = 4096                     # x, W1, W2: PIPE_N x PIPE_N
TREE_N = 2048                     # canonical qgemul: TREE_N^3
CORNER = 16                       # corner checked against the host model
TIMED_RUNS = 10


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def timeit(fn, runs=TIMED_RUNS, warmup=2):
    """Median milliseconds of ``runs`` calls of ``fn``, each between two
    CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rand_raws(rng, fmt, shape, dtype):
    import numpy as np

    return rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape).astype(dtype)


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


def phase_kernels(dev, chk):
    """Phase 2: each kernel against its plain version on the card."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm_plain
    from qublas_tpu_torch.ops.tree_gemm import plan_tree, tree_gemm_plain

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

    f88z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)

    def k2_case(what, m, k, n, layers=()):
        a = qt.from_raw(rand_raws(rng, f88z, (m, k), np.int32), f88z, dev)
        b = qt.from_raw(rand_raws(rng, f88z, (k, n), np.int32), f88z, dev)
        plan = plan_tree(f88z, f88z, qt.mul_merge(f88z, f88z), layers, k,
                         f88z)
        got = qt.qgemul(a, b, f88z, add_formats=layers)
        ref = qt.QTensor(tree_gemm_plain(a.data, b.data, plan, f88z), f88z)
        chk.same("tree_gemm", what, got, ref)

    k2_case("canonical Qu<8,8,SAT::ZERO> 512^3", 512, 512, 512)
    k2_case("k=1000 (drain converts and adds) 200x1000x300", 200, 1000, 300)
    k2_case("ragged m, n 77x96x45", 77, 96, 45)
    k2_case("odd k 33x13x17", 33, 13, 17)
    k2_case("layered formats 128x128x128", 128, 128, 128,
            (qt.qformat(9, 6, round_mode=qt.RoundMode.RND_CONV),
             qt.qformat(10, 4)))
    torch.cuda.synchronize()


def phase_main_path(dev, chk):
    """Phase 3: the main path through the public entry points."""
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
    f88z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
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
    print(f"main path: pipeline {n}^3 + canonical qgemul {TREE_N}^3 in "
          f"{wall * 1e3:.3f} ms wall (first call), launches {launches}")
    assert launches == {"fused_int8_gemm": 2, "tree_gemm": 1}, launches

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
    print(f"main path: {cn}x{cn} corners of both pipeline GEMMs and the "
          "canonical tree equal hostops.qgemul")
    return launches, (x, pipe, plan1, mid, a2, b2, tplan, f88z)


def phase_times(card, state):
    """Phase 4: kernel, plain, torch._int_mm and main-path times."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm,
                                                 fused_int8_gemm_plain)
    from qublas_tpu_torch.ops.tree_gemm import tree_gemm, tree_gemm_plain

    x, pipe, plan1, mid, a2, b2, tplan, f88z = state
    n, tn = PIPE_N, TREE_N
    w1 = pipe.w1
    w1_cm = w1.t().contiguous().t()   # the same B, column-major
    t = {
        "k1": timeit(lambda: fused_int8_gemm(x, w1, plan1.prod_frac, mid)),
        "k1_plain": timeit(lambda: fused_int8_gemm_plain(
            x, w1, plan1.prod_frac, mid)),
        "int_mm": timeit(lambda: torch._int_mm(x, w1)),
        "int_mm_cm": timeit(lambda: torch._int_mm(x, w1_cm)),
        "k2": timeit(lambda: tree_gemm(a2.data, b2.data, tplan, f88z)),
        "k2_plain": timeit(lambda: tree_gemm_plain(a2.data, b2.data, tplan,
                                                   f88z), warmup=1),
        "pipeline": timeit(lambda: pipe(x)),
        "canonical": timeit(lambda: qt.qgemul(a2, b2, f88z)),
    }
    ops = 2 * n ** 3
    prods = tn ** 3
    for key, label in (
            ("k1", "fused_int8_gemm"),
            ("k1_plain", "fused_int8_gemm plain (float64)"),
            ("int_mm", "torch._int_mm, row-major B (raw int8, reference)"),
            ("int_mm_cm", "torch._int_mm, column-major B (raw int8, "
                          "reference)")):
        print(f"time {label} {n}^3: {t[key]:.4f} ms, "
              f"{ops / t[key] / 1e9:.2f} TOP/s [{card}]")
    for key, label in (("k2", "tree_gemm"), ("k2_plain", "tree_gemm plain")):
        print(f"time {label} {tn}^3: {t[key]:.4f} ms, "
              f"{prods / t[key] / 1e6:.2f} Gprod/s [{card}]")
    print(f"time main path: QuantPipeline forward {n}^3 {t['pipeline']:.4f}"
          f" ms ({2 * ops / t['pipeline'] / 1e9:.2f} TOP/s over its two "
          f"GEMMs), canonical qgemul {tn}^3 {t['canonical']:.4f} ms [{card}]")
    return t


def main() -> int:
    import torch

    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from qublas_tpu_torch import _build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    so = _build.lib()._name
    print(f"build: {time.perf_counter() - t0:.2f} s, nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'}"
          f" s -> {so}")
    for line in _build.library_path().with_suffix(".log").read_text() \
            .splitlines():
        if "registers" in line or "spill stores" in line or "done at" in line:
            print("  " + line.split(":", 1)[-1].strip())
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    chk = Checker()
    phase_kernels(dev, chk)
    launches, state = phase_main_path(dev, chk)
    t = phase_times(card, state)
    assert "jax" not in sys.modules, "the port imported JAX"

    kernels = [
        {"name": "fused_int8_gemm", "route": "cuda",
         "source": "qublas_tpu_torch/csrc/fused_gemm.cu",
         "replaces": "qublas_tpu/ops/pallas_gemm.py:83",
         "launches": launches["fused_int8_gemm"],
         "max_abs_err": chk.max_err["fused_int8_gemm"],
         "ms": t["k1"], "plain_ms": t["k1_plain"]},
        {"name": "tree_gemm", "route": "cuda",
         "source": "qublas_tpu_torch/csrc/tree_gemm.cu",
         "replaces": "qublas_tpu/ops/tree_gemm.py:362",
         "launches": launches["tree_gemm"],
         "max_abs_err": chk.max_err["tree_gemm"],
         "ms": t["k2"], "plain_ms": t["k2_plain"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
