"""Design measurements for K1, K2, K2′, K3, P1 and K2h on the card (not
imported by the package).

    python3 -m qublas_tpu_torch.experiments.kernel_sweeps [PART]
    python3 -m qublas_tpu_torch.experiments.kernel_sweeps k2s OTHER_CHECKOUT
    python3 -m qublas_tpu_torch.experiments.kernel_sweeps k2s-cells [small]
    python3 -m qublas_tpu_torch.experiments.kernel_sweeps k3 OTHER_CHECKOUT
    python3 -m qublas_tpu_torch.experiments.kernel_sweeps p1 OTHER_CHECKOUT
    python3 -m qublas_tpu_torch.experiments.kernel_sweeps main OTHER_CHECKOUT
    python3 -m qublas_tpu_torch.experiments.kernel_sweeps k2h OTHER_CHECKOUT

PART is one of k1, k2, k2s, k3, p1 and k2h; all of them when left out.

Run on a machine with a CUDA card.  Each part runs in its own process
under a time limit, so a kernel that hangs ends that part and not the run:

* ``k1``: K1's tensor-core route at 4096^3 (the pipeline's GEMM) and
  2048^3 (config 5's ``int_dot``), on a K-major B (the kernel alone) and a
  row-major B (the wrapper's copy included), each checked against its
  plain version, beside ``torch._int_mm`` on the same K-major and
  row-major B;
* ``k2``: the tiled K2 at 2048^3 on the canonical plan, with its modes
  fixed at compile time and read at run time, checked against the plain
  version; the same kernel on other micro-tiles and occupancy targets
  (``k2_tiles.cu``); and P1 (``chain_probe``) on the same plan;
* ``k2s``: K2′ at 512^3 (``chip_smoke.py``'s path b) and 2048^3 on the
  canonical plan, checked against its plain version and K2, with its
  device and host time per call beside K2's time (given another
  checkout's root, the same in both trees in turns: other, this, this,
  other); K2, K2′ and ``qgemul`` at the tree cells' shapes beside the
  variants whose stack holds their k (depths 13, 14 and 32 on several
  tiles), and at shapes under one k-slice or one wave of blocks; then its
  variants (``k2s_variants.cu``: 16-byte ``cp.async``
  instead of TMA, slices of 16 instead of 32, only the modes compiled in,
  other micro-tiles and blocks an SM beside the package's 4 x 1 at 3) and the
  package's instantiation with every step read at run time, each checked
  against the package's kernel; and the ``cuobjdump -sass`` opcode counts
  of each one's slice loop (the SASS itself into
  ``build/qublas_tpu_torch/experiments/k2s_sass.txt``);
* ``k3``: K3 at its main-path shapes (BASELINE config 2 at [4096, 1024]
  and [131072, 1024], the layered GEMM's reduce at [512, 512, 512] over
  axis 1), checked against its plain version, with its device and host
  time per call; given another checkout's root (e.g. the parent commit's
  ``git archive``), the same in both trees in turns (other, this, this,
  other), each tree's own package and kernels;
* ``p1``: P1 (``chain_probe``) at ``measured_chain_prods``' shapes (the
  canonical plan, G = 2048 programs of [128, 256], T = 128 and 16),
  checked against its plain version, with its device time per call,
  ``measured_chain_prods``, and K2′ at 2048^3 on the same plan with its
  rate over P1's (given another checkout's root, the same in both trees in
  turns: other, this, this, other).

* ``k2h``: K2h at ``chip_smoke.py``'s i1 shapes (2048^3 with s = 16;
  k = 2040 and the dl configuration with s = 8): the tensor-core kernel on
  the int8 lanes (its compiled-modes instantiation) and the digit kernels
  on int16 and int32 copies of the operands in turns; the tensor-core
  kernel with its modes read at run time and the dots without the tail
  (``k2h_variants.cu``: as the int8 kernel reads its operands, on
  cache-resident operand rows, at the occupancy of the stages' shared
  memory alone, and the digit kernel's on the int16 copies), by event and
  device time, checked against the package where they compute its
  function; and the ``cuobjdump -sass`` opcode counts of each one's
  longest loop (the SASS itself into
  ``build/qublas_tpu_torch/experiments/k2h_sass.txt``).  Given another
  checkout's root (e.g. the parent commit's ``git archive``): K2h on i1's
  int8 operands at 2048^3 and on int16 and int32 copies of them, in both
  trees in turns (other, this, this, other), each tree's route
  (``k2h_route``) and kernels, checked against the plain version;

* ``main`` (given another checkout's root only): the main path's calls end
  to end, in both trees in turns ((other, this, this, other) three
  times): the pipeline
  forward at 4096^3 and the canonical ``qgemul`` at 2048^3
  (``chip_smoke.py``'s path a, on raws made on the card from a seed), each
  by CUDA events and by the host's time to enqueue one call, so that a
  change to ``qgemul``'s dispatch shows in both.

Times are CUDA-event medians (``qublas_tpu_torch.timing.timeit``) and, for
K1, device time per call from a ``torch.profiler`` trace (without the
host's time to launch) and the host's time to enqueue one call, printed
with the card's name and power limit.
"""

import ctypes
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _k1(card):
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops import fused_gemm as fg
    from qublas_tpu_torch.timing import device_us, host_us, timeit

    dev = torch.device("cuda", 0)
    fa, wide, mid = qt.pipeline_formats()
    rng = np.random.RandomState(0)
    for n, what in ((4096, "pipeline GEMM"), (2048, "int_dot")):
        x = torch.from_numpy(rng.randint(-128, 128, (n, n)).astype(np.int8))
        w = torch.from_numpy(rng.randint(-128, 128, (n, n)).astype(np.int8))
        x, w = x.to(dev), w.to(dev)
        wk = fg.kmajor(w)
        plan = qt.exact_plan(fa, fa, qt.mul_merge(fa, fa, wide), (wide,), n)
        if what == "int_dot":
            def call(b):
                return fg.int_dot(x, b)
            want = fg.int_dot_plain(x, w)
        else:
            def call(b):
                return fg.fused_int8_gemm(x, b, plan.prod_frac, mid)
            want = fg.fused_int8_gemm_plain(x, w, plan.prod_frac, mid)
        ops = 2 * n ** 3
        for b, layout in ((wk, "K-major"), (w, "row-major")):
            got = call(b)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (what, n, layout)
            ms = timeit(lambda: call(b))
            four = timeit(lambda: [call(b) for _ in range(4)])
            dus = device_us(lambda: call(b))
            hus = host_us(lambda: call(b))
            print(f"k1 {what} {n}^3 B {layout}: {ms:.4f} ms, "
                  f"{ops / ms / 1e9:.2f} TOP/s; four calls {four:.4f} ms; "
                  f"device us per call {dus}; host us per call {hus:.1f}; "
                  f"== plain [{card}]", flush=True)
        for b, layout in ((wk, "K-major"), (w, "row-major")):
            ms = timeit(lambda: torch._int_mm(x, b))
            four = timeit(lambda: [torch._int_mm(x, b) for _ in range(4)])
            dus = device_us(lambda: torch._int_mm(x, b))
            hus = host_us(lambda: torch._int_mm(x, b))
            print(f"k1 torch._int_mm {n}^3 B {layout}: {ms:.4f} ms, "
                  f"{ops / ms / 1e9:.2f} TOP/s; four calls {four:.4f} ms; "
                  f"device us per call {dus}; host us per call {hus:.1f} "
                  f"[{card}]", flush=True)
    out = torch.empty((2048, 2048), dtype=torch.int32, device=dev)
    for label, fn in (
            ("torch.cuda.current_stream", lambda: torch.cuda.current_stream(
                dev).cuda_stream),
            ("torch.empty 2048^2 int32", lambda: torch.empty(
                (2048, 2048), dtype=torch.int32, device=dev)),
            ("k1_operand of a K-major B's view", lambda: fg.k1_operand(
                wk.t())),
            ("torch.Tensor.zero_ 2048^2 int32", out.zero_)):
        print(f"k1 host us per call of {label}: {host_us(fn):.1f} "
              f"[{card}]", flush=True)


def _experiment_lib(name):
    """Build ``<name>.cu`` of this directory against the package's csrc/
    into build/qublas_tpu_torch/experiments/lib<name>.so and load it."""
    from qublas_tpu_torch import _build

    out = _build.BUILD_DIR / "experiments"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, "-shared",
           "-I", str(_build.CSRC), str(HERE / f"{name}.cu"), "-o", str(so)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "error")):
            print("  " + line.strip(), flush=True)
    res.check_returncode()
    return ctypes.CDLL(str(so))


def _tiles_lib():
    lib = _experiment_lib("k2_tiles")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k2_tiled_variant.argtypes = (I, I, I, I, P, P, P, I, I, I, P)
    lib.k2_tiled_variant.restype = I
    return lib


def _k2(card):
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import _build
    from qublas_tpu_torch.ops import library
    from qublas_tpu_torch.ops import tree_gemm as TT
    from qublas_tpu_torch.ops.chain_probe import (BM, BN, G, T1, chain_probe,
                                                  probe_tile)
    from qublas_tpu_torch.timing import timeit

    dev = torch.device("cuda", 0)
    n = 2048
    f = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
    rng = np.random.RandomState(1)

    def raws():
        x = rng.randint(f.raw_min, f.raw_max + 1, size=(n, n))
        return torch.from_numpy(x.astype(np.int32)).to(dev)

    a, b = raws(), raws()
    plan = TT.plan_tree(f, f, qt.mul_merge(f, f), (), n, f)
    want = TT.tree_gemm_plain(a, b, plan, f)
    params = TT._kernel_params(plan, f, TT.K2_LOG_BLK)

    def tiled(modes):
        # the package's K2 op with its instantiation forced
        return torch.ops.qublas.tree_gemm(a, b, list(params), modes, 4)

    rate = {}
    for modes, label in ((1, "modes fixed (TRN::TCPL, SAT::ZERO)"),
                         (0, "modes read at run time")):
        got = tiled(modes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), label
        ms = timeit(lambda: tiled(modes))
        rate[f"tiled {modes}"] = n ** 3 / ms / 1e6
        print(f"k2 tiled {n}^3, {label}: {ms:.4f} ms, "
              f"{n ** 3 / ms / 1e6:.2f} Gprod/s, == plain [{card}]",
              flush=True)

    tlib = _tiles_lib()
    for tm, tn, minb in ((4, 2, 1), (2, 2, 3), (4, 1, 2), (2, 1, 3),
                         (1, 2, 3), (2, 1, 4), (1, 1, 4)):
        for modes in (1, 0):
            out = torch.empty((n, n), dtype=torch.int32, device=dev)

            def run():
                _build.check(tlib.k2_tiled_variant(
                    tm, tn, minb, modes, a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), n, n, n, library.c_ints(params)),
                    "k2_tiled_variant")
            run()
            torch.cuda.synchronize()
            assert torch.equal(out, want), (tm, tn, minb, modes)
            ms = timeit(run, runs=5, warmup=1)
            label = f"tiled {tm}x{tn} min {minb} blocks, modes {modes}"
            rate[label] = n ** 3 / ms / 1e6
            print(f"k2 {label} {n}^3: {ms:.4f} ms, {rate[label]:.2f} "
                  f"Gprod/s, == plain [{card}]", flush=True)

    xp, yp = probe_tile(f, dev)
    ms = timeit(lambda: chain_probe(xp, yp, plan, T1, G))
    p1 = BM * BN * G * T1 / ms / 1e6
    print(f"k2 P1 chain_probe T={T1} x {G} programs: {ms:.4f} ms, "
          f"{p1:.2f} Gstep/s [{card}]", flush=True)
    for label, r in rate.items():
        print(f"k2 {label}: {r / p1:.4f} of P1's rate [{card}]", flush=True)


def _k2s_operands(n):
    """The canonical plan's operands and plan at n^3 on the card."""
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops import tree_gemm as TT

    dev = torch.device("cuda", 0)
    f = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
    rng = np.random.RandomState(n)
    a, b = (torch.from_numpy(rng.randint(f.raw_min, f.raw_max + 1, (n, n))
                             .astype(np.int32)).to(dev) for _ in range(2))
    return a, b, TT.plan_tree(f, f, qt.mul_merge(f, f), (), n, f), f


def _k2s_times(card):
    """K2′ in this tree (whichever ``qublas_tpu_torch`` is imported) at
    512^3 and 2048^3, beside K2."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops import tree_gemm as TT
    from qublas_tpu_torch.timing import device_us, host_us, timeit

    tree = Path(qt.__file__).resolve().parent.parent
    for n in (512, 2048):
        a, b, plan, f = _k2s_operands(n)

        def call():
            return TT.tree_gemm_stream(a, b, plan, f)

        got = call()
        assert torch.equal(got, TT.tree_gemm(a, b, plan, f)), n
        if n == 512:
            assert torch.equal(got, TT.tree_gemm_stream_plain(a, b, plan, f))
        ms = timeit(call)
        k2 = timeit(lambda: TT.tree_gemm(a, b, plan, f))
        print(f"k2s {tree}: {n}^3 event {ms:.4f} ms, device us per call "
              f"{device_us(call)}, host us per call {host_us(call, 20):.2f};"
              f" K2 {k2:.4f} ms, K2′/K2 {ms / k2:.4f}; == plain and K2 "
              f"[{card}]", flush=True)


def _k2s_against(card, other: str):
    """K2′'s times in this tree and in the checkout ``other`` (e.g. the
    parent commit), in turns: other, this, this, other."""
    this, other = str(HERE.parent.parent), str(Path(other).resolve())
    for tree in (other, this, this, other):
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "k2s-times"], env=env, cwd=tree, timeout=900,
                       check=True)


# k2s_variants.cu's variants, by its K2S_VARIANT; each computes K2′'s
# function on the canonical plan
K2S_VARIANTS = {1: "16-byte cp.async instead of TMA",
                2: "slices of 16 products",
                3: "only the modes compiled in (shift, width at run time)",
                4: "2 x 1 outputs a thread, 4 blocks an SM",
                5: "4 x 1 outputs a thread, 2 blocks an SM",
                6: "2 x 2 outputs a thread, 2 blocks an SM",
                7: "2 x 2 outputs a thread, 3 blocks an SM",
                8: "depth 14, 4 x 1 outputs a thread, 3 blocks an SM",
                9: "depth 14, 2 x 1 outputs a thread, 4 blocks an SM",
                10: "depth 14, 4 x 1 outputs a thread, 2 blocks an SM",
                11: "depth 13, 4 x 1 outputs a thread, 3 blocks an SM",
                12: "depth 32 (MAXL), 1 output a thread, 2 blocks an SM"}
# the stack depth of each variant (k below 2^depth)
K2S_VARIANT_TOP = {v: 14 if 8 <= v <= 10 else 13 if v == 11 else
                   32 if v == 12 else 12 for v in K2S_VARIANTS}

# the tree cells' GEMMs (m, k, n): BERT-Large's fc1 and fc2 at 4 sequences
# of 384 (gpubench/configs/bertl_fc_tree16.json)
K2S_CELL_SHAPES = {"fc1": (1536, 1024, 4096), "fc2": (1536, 4096, 1024)}
# shapes below one k-slice or one wave of blocks (m, k, n): the card
# tests' and the fuzz's sizes, where K2 might beat K2′ on launch cost
K2S_SMALL_SHAPES = ((64, 100, 48), (33, 13, 17), (64, 16, 48),
                    (256, 31, 256), (256, 32, 256), (256, 64, 256),
                    (128, 256, 128), (128, 1024, 128), (512, 512, 512))


def _k2s_variants_lib():
    """Build k2s_variants.cu once for each variant, all at once, into
    build/qublas_tpu_torch/experiments/libk2s_variants.so and load it."""
    from qublas_tpu_torch import _build

    out = _build.BUILD_DIR / "experiments"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for v in K2S_VARIANTS:
        obj = out / f"k2s_variant_{v}.o"
        cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, f"-DK2S_VARIANT={v}",
               "-I", str(_build.CSRC), "-c", str(HERE / "k2s_variants.cu"),
               "-o", str(obj)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    for obj, proc in jobs:
        text, _ = proc.communicate()
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "error")):
                print("  " + line.strip(), flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {obj.name}")
    so = out / "libk2s_variants.so"
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS[:2], "-shared",
                    "-o", str(so), *(str(o) for o, _ in jobs)], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for v in K2S_VARIANTS:
        fn = getattr(lib, f"k2s_variant_{v}")
        fn.argtypes = (P, L, P, L, P, I, I, I, P)
        fn.restype = I
    return lib, so


def _k2s_variants(card):
    import torch

    from qublas_tpu_torch import _build
    from qublas_tpu_torch.ops import library
    from qublas_tpu_torch.ops import tree_gemm as TT
    from qublas_tpu_torch.timing import device_us, timeit

    lib, so = _k2s_variants_lib()
    for n in (512, 2048):
        a, b, plan, f = _k2s_operands(n)
        assert TT.k2s_plan(plan) == 1
        params = TT._kernel_params(plan, f, 0)
        want = TT.tree_gemm_stream(a, b, plan, f)
        out = torch.empty_like(want)
        runs = [("the package's kernel (TMA, slices of 32, the steps "
                 "compiled in, 4 x 1 outputs, 3 blocks an SM)", 1)]
        runs += [(label, v) for v, label in K2S_VARIANTS.items()]
        runs.append(("the package's kernel with every step read at run "
                     "time (its plan 0, rolled)", 0))
        for label, v in runs:
            if label.startswith("the package"):
                def run(plan_index=v):
                    # the package's K2′ op with its instantiation forced
                    return torch.ops.qublas.tree_gemm_stream(
                        a, b, list(params), plan_index, 4)
            else:
                fn = getattr(lib, f"k2s_variant_{v}")

                def run(fn=fn):
                    _build.check(fn(a.data_ptr(), n, b.data_ptr(), n,
                                    out.data_ptr(), n, n, n,
                                    library.c_ints(params)), "k2s_variant")
                    return out
            out.zero_()
            res = run()
            torch.cuda.synchronize()
            assert torch.equal(res, want), (n, label)
            ms = timeit(run, runs=5 if n > 512 else 10, warmup=1)
            dus = sum(device_us(run, runs=5).values())
            print(f"k2sv {n}^3 {label}: event {ms:.4f} ms, device "
                  f"{dus:.2f} us per call, == the package's K2′ [{card}]",
                  flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"k2sv SM clock after the timings, and its maximum: {clocks} "
          f"[{card}]", flush=True)
    _sass_dump(("tree_gemm_stream_kernel",), (_build.library_path(), so),
               "k2sv", "k2s_sass.txt")


def _k2s_cells(card, small_only=False):
    """K2 and K2′ at the tree cells' shapes and at small ones: the
    package's kernels and ``qgemul`` on its route and on each route forced,
    and at the cells' shapes the variants whose stack holds k, by event,
    device and host time, each checked against K2; at the small shapes
    also ``qgemul``'s host time a call on K2 and on K2′ in turns (K2, K2′,
    K2′, K2), where the host sets the pace.  ``small_only``: the small
    shapes alone."""
    import statistics

    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import _build
    from qublas_tpu_torch.ops import gemm as G
    from qublas_tpu_torch.ops import library
    from qublas_tpu_torch.ops import tree_gemm as TT
    from qublas_tpu_torch.timing import device_us, host_us, timeit

    dev = torch.device("cuda", 0)
    f = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
    lib = None if small_only else _k2s_variants_lib()[0]

    def qgemul_on(k2s, qa, qb):
        # qgemul with its tree tier's kernel forced to K2′ or to K2
        saved = G.tree_kernel
        G.tree_kernel = lambda plan, _: (
            ("k2s", TT.k2s_plan(plan)) if k2s else ("k2", TT.k2_modes(plan)))
        try:
            return qt.qgemul(qa, qb, f).data
        finally:
            G.tree_kernel = saved
    shapes = [] if small_only else list(K2S_CELL_SHAPES.items())
    shapes += [(f"{m}x{k}x{n}", (m, k, n)) for m, k, n in K2S_SMALL_SHAPES]
    for label, (m, k, n) in shapes:
        rng = np.random.RandomState(m + k + n)
        a, b = (torch.from_numpy(rng.randint(f.raw_min, f.raw_max + 1, sh)
                                 .astype(np.int32)).to(dev)
                for sh in ((m, k), (k, n)))
        plan = TT.plan_tree(f, f, qt.mul_merge(f, f), (), k, f)
        assert TT.k2s_plan(plan) == 1
        want = TT.tree_gemm(a, b, plan, f)
        qa, qb = qt.QTensor(a, f), qt.QTensor(b, f)
        runs = [("K2 (tree_gemm)", lambda: TT.tree_gemm(a, b, plan, f)),
                ("K2′ (tree_gemm_stream)",
                 lambda: TT.tree_gemm_stream(a, b, plan, f)),
                ("qgemul", lambda: qt.qgemul(qa, qb, f).data),
                ("qgemul on K2", lambda: qgemul_on(False, qa, qb)),
                ("qgemul on K2′", lambda: qgemul_on(True, qa, qb))]
        params = TT._kernel_params(plan, f, 0)
        out = torch.empty_like(want)
        for v in K2S_VARIANTS if label in K2S_CELL_SHAPES else ():
            if v < 8 or k >= 1 << K2S_VARIANT_TOP[v]:
                continue
            fn = getattr(lib, f"k2s_variant_{v}")

            def run(fn=fn):
                _build.check(fn(a.data_ptr(), k, b.data_ptr(), n,
                                out.data_ptr(), m, n, k,
                                library.c_ints(params)), "k2s_variant")
                return out
            runs.append((f"variant {v}: {K2S_VARIANTS[v]}", run))
        for name, run in runs:
            out.zero_()
            res = run()
            torch.cuda.synchronize()
            assert torch.equal(res, want), (label, name)
            ms = timeit(run, runs=30, warmup=3)
            dus = sum(device_us(run, runs=10).values())
            hus = host_us(run, runs=30)
            rate = f"{m * k * n / dus / 1e3:.2f}" if dus else "no device rows"
            print(f"k2sc {label} [{m}, {k}] @ [{k}, {n}] {name}: event "
                  f"{ms:.4f} ms, device {dus:.2f} us, host {hus:.1f} us "
                  f"per call, {rate} Gprod/s on the device, == K2 "
                  f"[{card}]", flush=True)
        if label in K2S_CELL_SHAPES:
            continue
        turns = {False: [], True: []}
        for k2s in (False, True, True, False, False, True, True, False):
            turns[k2s].append(host_us(lambda: qgemul_on(k2s, qa, qb),
                                      runs=200))
        print(f"k2sc {label} qgemul host us a call in turns: on K2 "
              f"{statistics.mean(turns[False]):.1f} "
              f"{[round(x, 1) for x in turns[False]]}, on K2′ "
              f"{statistics.mean(turns[True]):.1f} "
              f"{[round(x, 1) for x in turns[True]]} [{card}]", flush=True)


def _k2s(card):
    _k2s_times(card)
    _k2s_cells(card)
    _k2s_variants(card)


def _k3_cases():
    """K3's main-path shapes: (label, x reduced over axis 1, plan)."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.reduce import plan_reduce

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    f44 = qt.qformat(4, 4)
    config2 = (qt.qformat(5, 3, round_mode=qt.RoundMode.RND_CONV,
                          overflow_mode=qt.OverflowMode.SAT_ZERO),
               qt.qformat(6, 2))
    f88z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
    for rows in (4096, 131072):
        x = torch.randint(-128, 128, (rows, 1024), generator=gen, device=dev,
                          dtype=torch.int8)
        yield (f"config 2 [{rows}, 1024] axis 1", x,
               plan_reduce(f44, config2, 1024))
    # the layered GEMM's products: Qu<8,8> raws in int32 lanes
    x = torch.randint(f88z.raw_min, f88z.raw_max + 1, (512, 512, 512),
                      generator=gen, device=dev, dtype=torch.int32)
    yield ("layered GEMM's reduce [512, 512, 512] axis 1", x,
           plan_reduce(qt.mul_merge(f88z, f88z), (), 512))


def _k3_times(card):
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops.reduce import qreduce_kernel, qreduce_plain
    from qublas_tpu_torch.timing import device_us, host_us, timeit

    tree = Path(qt.__file__).resolve().parent.parent
    for what, x, plan in _k3_cases():
        def call():
            return qreduce_kernel(x, 1, plan)

        assert torch.equal(call(), qreduce_plain(x, 1, plan)), what
        ms = timeit(call)
        dev_us = device_us(call)
        hus = host_us(call)
        print(f"k3 {tree}: {what}: event {ms:.4f} ms, device us per call "
              f"{dev_us}, host us per call {hus:.2f}, == plain [{card}]",
              flush=True)


def _main_times(card):
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.timing import host_us, timeit

    tree = Path(qt.__file__).resolve().parent.parent
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n, tn = 4096, 2048
    fa, _, mid = qt.pipeline_formats()
    f88z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)

    def raws(f, shape, dtype):
        return torch.randint(f.raw_min, f.raw_max + 1, shape, generator=gen,
                             device=dev, dtype=dtype)

    pipe = qt.QuantPipeline(raws(fa, (n, n), torch.int8),
                            raws(fa, (n, n), torch.int8))
    x = raws(fa, (n, n), torch.int8)
    a = qt.QTensor(raws(f88z, (tn, tn), torch.int32), f88z)
    b = qt.QTensor(raws(f88z, (tn, tn), torch.int32), f88z)
    for what, fn, runs in (("pipeline forward 4096^3", lambda: pipe(x), 10),
                           ("canonical qgemul 2048^3",
                            lambda: qt.qgemul(a, b, f88z), 5)):
        ms = timeit(fn, runs=runs)
        hus = host_us(fn, runs=runs)
        print(f"main {tree}: {what}: event {ms:.4f} ms, host us per call "
              f"{hus:.2f} [{card}]", flush=True)


def _main_against(card, other: str):
    """The main path's times in this tree and in the checkout ``other``, in
    turns: (other, this, this, other) three times, since host times spread
    widely between processes."""
    this, other = str(HERE.parent.parent), str(Path(other).resolve())
    for tree in (other, this, this, other) * 3:
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "main-times"], env=env, cwd=tree, timeout=900,
                       check=True)


def _k3_against(card, other: str):
    """K3's times in this tree and in the checkout ``other`` (e.g. the
    parent commit), in turns: other, this, this, other."""
    this, other = str(HERE.parent.parent), str(Path(other).resolve())
    for tree in (other, this, this, other):
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "k3"],
                       env=env, cwd=tree, timeout=900, check=True)


# a SASS line of cuobjdump: /*address*/ [@predicate] OPCODE[.modifiers] ...;
_SASS_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_]*)([^;]*)")


def _sass_functions(so):
    """{kernel name: its SASS lines} of the library ``so``, from
    ``cuobjdump -sass``, names demangled where c++filt is there."""
    from qublas_tpu_torch import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    try:
        res = subprocess.run(["c++filt"], input="\n".join(funcs),
                             capture_output=True, text=True, timeout=60)
        plain = dict(zip(funcs, res.stdout.splitlines()))
    except (OSError, subprocess.SubprocessError):
        plain = {}
    return {plain.get(k, k): v for k, v in funcs.items()}


def _sass_counts(lines):
    """Instructions of one kernel (NOPs left out), by opcode: in the whole
    kernel, and in its longest loop (from the target of a backward branch
    to the branch), each counted once whether it runs or is branched
    over."""
    ops, loops = [], []
    for line in lines:
        m = _SASS_INSTR.match(line)
        if not m or m.group(2) == "NOP":
            continue
        addr = int(m.group(1), 16)
        ops.append((addr, m.group(2)))
        target = re.search(r"0x([0-9a-f]+)", m.group(3))
        if m.group(2) == "BRA" and target and int(target.group(1), 16) <= addr:
            loops.append((int(target.group(1), 16), addr))
    lo, hi = max(loops, key=lambda ab: ab[1] - ab[0], default=(0, -1))
    return (Counter(op for _, op in ops),
            Counter(op for a, op in ops if lo <= a <= hi))


def _sass_dump(wanted, libraries, tag, filename):
    """Print the instruction counts of the kernels of ``libraries`` whose
    names contain one of ``wanted``, and write their SASS to
    build/qublas_tpu_torch/experiments/``filename``."""
    from qublas_tpu_torch import _build

    funcs = {}
    for so in libraries:
        funcs.update(_sass_functions(so))
    dump = []
    for name, lines in funcs.items():
        if not any(w in name for w in wanted):
            continue
        whole, loop = _sass_counts(lines)
        top = ", ".join(f"{op} {c}" for op, c in loop.most_common(14))
        short = name.replace("(anonymous namespace)::", "")
        print(f"{tag} sass {short.split('(')[0].replace('void ', '')}: "
              f"{sum(whole.values())} instructions, its longest loop "
              f"{sum(loop.values())}: {top}", flush=True)
        dump += [f"Function : {name}", *lines, ""]
    path = _build.BUILD_DIR / "experiments" / filename
    path.write_text("\n".join(dump))
    print(f"{tag} sass written to {path}", flush=True)


def _p1_times(card):
    """P1 in this tree (whichever ``qublas_tpu_torch`` is imported) at
    ``measured_chain_prods``' shapes, ``measured_chain_prods`` itself, and
    K2′ at 2048^3 on the same plan."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops import chain_probe as CP
    from qublas_tpu_torch.ops import tree_gemm as TT
    from qublas_tpu_torch.timing import device_us, host_us, timeit

    tree = Path(qt.__file__).resolve().parent.parent
    dev = torch.device("cuda", 0)
    a, b, plan, f = _k2s_operands(2048)
    x, y = CP.probe_tile(f, dev)
    p1_ms = {}
    for steps in (CP.T1, CP.T2):
        def call():
            return CP.chain_probe(x, y, plan, steps, CP.G)

        assert torch.equal(call(), CP.chain_probe_plain(x, y, plan, steps,
                                                        CP.G)), steps
        p1_ms[steps] = timeit(call)
        print(f"p1 {tree}: T={steps} x {CP.G} programs of [{CP.BM}, "
              f"{CP.BN}] event {p1_ms[steps]:.4f} ms, device us per call "
              f"{device_us(call)}, host us per call {host_us(call, 20):.2f}"
              f"; == plain [{card}]", flush=True)
    rate = CP.measured_chain_prods(f, plan, dev)
    ms = timeit(lambda: TT.tree_gemm_stream(a, b, plan, f))
    dus = device_us(lambda: TT.tree_gemm_stream(a, b, plan, f))
    k2s_rate = 2048 ** 3 / (ms / 1e3)
    print(f"p1 {tree}: measured_chain_prods {rate / 1e9:.2f} Gprod/s; K2′ "
          f"2048^3 event {ms:.4f} ms, device us per call {dus}, "
          f"{k2s_rate / 1e9:.2f} Gprod/s, {k2s_rate / rate:.4f} of P1's "
          f"rate [{card}]", flush=True)


def _p1_against(card, other: str):
    """P1's times in this tree and in the checkout ``other`` (e.g. the
    parent commit), in turns: other, this, this, other."""
    this, other = str(HERE.parent.parent), str(Path(other).resolve())
    for tree in (other, this, this, other):
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "p1-times"], env=env, cwd=tree, timeout=900,
                       check=True)


# (variant, its operands' lane bytes, what it leaves out or changes); none
# computes K2h's function
K2H_VARIANTS = ((1, 1, "the block dots alone (the tail an xor)"),
                (2, 1, "the block dots alone, every operand row its first "
                 "(cache-resident stages)"),
                (3, 1, "the block dots alone in the stages' shared memory "
                 "only (more blocks an SM), no drain"),
                (4, 2, "the digit kernel's block dots alone on the int16 "
                 "copies (four MMAs a k16 step and n8 tile)"))


def _k2h(card):
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import _build
    from qublas_tpu_torch.ops import library
    from qublas_tpu_torch.ops import tree_gemm as TT
    from qublas_tpu_torch.timing import device_us, timeit

    sys.path.insert(0, str(HERE.parent.parent))
    from chip_smoke import hybrid_config

    lib = _experiment_lib("k2h_variants")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k2h_variant.argtypes = (I, P, L, P, L, P, I, I, I, I, P)
    lib.k2h_variant.restype = I
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    n = 2048
    for kind, k in (("base", 2048), ("base", 2040), ("dl", 2048)):
        fa, mul, layers, out = hybrid_config(kind)
        a = torch.randint(-128, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        lanes = {1: (a, b)}
        for lane in (torch.int16, torch.int32):
            lanes[lane.itemsize] = (a.to(lane), b.to(lane))
        hp = TT.plan_hybrid(fa, fa, qt.mul_merge(fa, fa, mul), layers, k,
                            out)
        params = TT._hybrid_params(hp, k, out)
        modes = TT.k2h_modes(hp, k)
        want = TT.tree_gemm_hybrid(a, b, hp, out)
        assert torch.equal(want, TT.tree_gemm_hybrid_plain(a, b, hp, out))
        got = torch.empty_like(want)
        tag = f"{kind} {k} (s = {hp.s}, dl = {hp.dl})"

        def package(m=modes, d=1):
            # the package's tensor-core K2h op with its instantiation forced
            return torch.ops.qublas.tree_gemm_hybrid_mma(
                *lanes[d], list(params), m, got.element_size())
        calls = {d: (lambda d=d: package(d=d)) for d in lanes}
        for d in lanes:
            assert torch.equal(calls[d](), want), (tag, d)
        turns = {d: [] for d in lanes}
        for d in (1, 2, 4, 4, 2, 1):
            turns[d].append(timeit(calls[d], runs=5, warmup=1))
        print(f"k2h {tag}: tensor-core kernel (modes instantiation {modes}) "
              + "; ".join(
                  f"{('int8 lanes', 'int16 copies', '', 'int32 copies')[d - 1]}"
                  f" {turns[d][0]:.4f}, {turns[d][1]:.4f} ms, device us "
                  f"{sum(device_us(calls[d], runs=5).values()):.1f}"
                  for d in lanes) + f" [{card}]", flush=True)
        runs = [("the package's kernel, modes read at run time",
                 lambda: package(0), True)]
        for v, d, label in K2H_VARIANTS:
            def run(v=v, d=d):
                x, y = lanes[d]
                _build.check(lib.k2h_variant(
                    v, x.data_ptr(), k, y.data_ptr(), n, got.data_ptr(), n,
                    n, k, got.element_size(), library.c_ints(params)),
                    "k2h_variant")
                return got
            runs.append((label, run, False))
        for label, run, exact in runs:
            got.zero_()
            res = run()
            torch.cuda.synchronize()
            same = torch.equal(res, want)
            assert same or not exact, (tag, label)
            ms = timeit(run, runs=5, warmup=1)
            dus = sum(device_us(run, runs=5).values())
            print(f"k2hv {tag} {label}: event {ms:.4f} ms, device "
                  f"{dus:.1f} us per call"
                  + (", == the package's kernel" if same else "")
                  + f" [{card}]", flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"k2h SM clock after the timings, and its maximum: {clocks} "
          f"[{card}]", flush=True)
    _sass_dump(("tree_gemm_hybrid_mma_kernel",),
               (_build.library_path(),
                _build.BUILD_DIR / "experiments" / "libk2h_variants.so"),
               "k2hv", "k2h_sass.txt")


def _k2h_lanes(card):
    """K2h on i1's int8 operands at 2048^3 (``chip_smoke.py``'s i1
    configuration, raws from its seed) and on int16 and int32 copies of
    them, in this process's tree: the route ``k2h_route`` gives each, its
    event time (copies the route makes included) and device time, checked
    against the plain version.  Only what both trees have is called."""
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch.ops import tree_gemm as TT
    from qublas_tpu_torch.timing import device_us, timeit

    sys.path.insert(0, str(HERE.parent.parent))
    from chip_smoke import hybrid_config

    tree = Path(qt.__file__).resolve().parent.parent
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    n = 2048
    fa, mul, layers, out = hybrid_config("base")
    a = torch.randint(fa.raw_min, fa.raw_max + 1, (n, n), generator=gen,
                      device=dev, dtype=torch.int8)
    b = torch.randint(fa.raw_min, fa.raw_max + 1, (n, n), generator=gen,
                      device=dev, dtype=torch.int8)
    hp = TT.plan_hybrid(fa, fa, qt.mul_merge(fa, fa, mul), layers, n, out)
    want = TT.tree_gemm_hybrid_plain(a, b, hp, out)
    for lane in (torch.int8, torch.int16, torch.int32):
        x, y = a.to(lane), b.to(lane)

        def call(x=x, y=y):
            return TT.tree_gemm_hybrid(x, y, hp, out)
        assert torch.equal(call(), want), (tree, lane)
        ms = timeit(call, runs=10, warmup=2)
        print(f"k2h-lanes {tree}: i1 {n}^3 on {lane} lanes, route "
              f"{TT.k2h_route(x, y)}: event {ms:.4f} ms, device us per call "
              f"{device_us(call, runs=5)}; == plain [{card}]", flush=True)


def _k2h_against(card, other: str):
    """K2h's lanes in this tree and in the checkout ``other`` (e.g. the
    parent commit), in turns: other, this, this, other."""
    this, other = str(HERE.parent.parent), str(Path(other).resolve())
    for tree in (other, this, this, other):
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "k2h-lanes"], env=env, cwd=tree, timeout=900,
                       check=True)


def main() -> int:
    import torch

    from qublas_tpu_torch import _build
    from qublas_tpu_torch.timing import card_line

    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 1
    _build.lib()
    card = card_line()
    parts = {"k1": _k1, "k2": _k2, "k2s": _k2s, "k3": _k3_times,
             "p1": _p1_times, "k2h": _k2h}
    if len(sys.argv) > 2 and sys.argv[1] == "k3":
        _k3_against(card, sys.argv[2])
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "k2s":
        _k2s_against(card, sys.argv[2])
        _k2s_variants(card)
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "k2s-times":
        _k2s_times(card)
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "k2s-cells":
        _k2s_cells(card, sys.argv[2:] == ["small"])
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "p1":
        _p1_against(card, sys.argv[2])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "p1-times":
        _p1_times(card)
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "main":
        _main_against(card, sys.argv[2])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "main-times":
        _main_times(card)
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "k2h":
        _k2h_against(card, sys.argv[2])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "k2h-lanes":
        _k2h_lanes(card)
        return 0
    if len(sys.argv) > 1:
        parts[sys.argv[1]](card)
        return 0
    for line in _build.library_path().with_suffix(".log").read_text() \
            .splitlines():
        if "registers" in line or "spill stores" in line or "done at" in line \
                or "Compiling entry" in line:
            print("  " + line.split(":", 1)[-1].strip(), flush=True)
    print(card, flush=True)
    rc = 0
    for name in parts:
        try:
            res = subprocess.run([sys.executable, "-m", __spec__.name, name],
                                 timeout=600)
            rc |= res.returncode
        except subprocess.TimeoutExpired:
            print(f"kernel_sweeps: part {name} timed out", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
