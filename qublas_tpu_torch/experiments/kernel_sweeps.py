"""Design measurements for K1 and K2 on the card (not imported by the package).

    python3 -m qublas_tpu_torch.experiments.kernel_sweeps [k1|k2]

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
  (``k2_tiles.cu``); and P1 (``chain_probe``) on the same plan.

Times are CUDA-event medians (``qublas_tpu_torch.timing.timeit``) and, for
K1, device time per call from a ``torch.profiler`` trace (without the
host's time to launch) and the host's time to enqueue one call, printed
with the card's name and power limit.
"""

import ctypes
import subprocess
import sys
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


def _tiles_lib():
    from qublas_tpu_torch import _build

    out = _build.BUILD_DIR / "experiments"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libk2_tiles.so"
    cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, "-shared",
           "-I", str(_build.CSRC), str(HERE / "k2_tiles.cu"), "-o", str(so)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip(), flush=True)
    res.check_returncode()
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k2_tiled_variant.argtypes = (I, I, I, I, P, P, P, I, I, I, P)
    lib.k2_tiled_variant.restype = I
    return lib


def _k2(card):
    import numpy as np
    import torch

    import qublas_tpu_torch as qt
    from qublas_tpu_torch import _build
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
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    params = TT._kernel_params(plan, f, TT.K2_LOG_BLK)

    def tiled(modes):
        out = torch.empty((n, n), dtype=torch.int32, device=dev)
        _build.check(lib.qk_tree_gemm(0, a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), n, n, n, 4, params,
                                      modes, stream), "tree_gemm")
        return out

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
                    out.data_ptr(), n, n, n, params), "k2_tiled_variant")
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


def main() -> int:
    import torch

    from qublas_tpu_torch import _build
    from qublas_tpu_torch.timing import card_line

    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 1
    _build.lib()
    card = card_line()
    parts = {"k1": _k1, "k2": _k2}
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
