"""Build and load the CUDA kernels of ``csrc/``.

The kernels are compiled at first use, from this package's own ``csrc/``
sources, by ``nvcc`` into one shared library with a plain C interface,
which is loaded with ``ctypes``.  Each ``.cu`` file compiles in its own
``nvcc`` process, all at once, and one more links them.  The library lands
in ``build/qublas_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edit to a source rebuilds it and an unchanged tree
reuses it; a file lock lets one process build it while the others wait.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
and each step's seconds are kept beside it as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

from .qformat import QFormat

__all__ = ["lib", "check", "rq_args", "library_path", "record"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "qublas_tpu_torch"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # nvcc wall seconds; None if cached

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # device, x, out, outer, n, inner, in_bytes, out_bytes, params, modes,
    # lanes, stream
    "qk_qreduce": (_I, _P, _P, _L, _L, _L, _I, _I, _P, _I, _I, _P),
    # device, a, lda, bt, ldb, c, m, n, k, out_bytes, d, round, ovf, w,
    # sgn, lut, mask, stream
    "qk_fused_gemm_s8": (_I, _P, _L, _P, _L, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _P, _I, _P),
    # device, a, lda, bt, ldb, c, offsets, groups, m, n, k, out_bytes, d,
    # round, ovf, w, sgn, lut, mask, stream, launched
    "qk_fused_gemm_s8_grouped": (_I, _P, _L, _P, _L, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _P, _I, _P, _P),
    # device, a, b, c, m, n, k, out_bytes, d, round, ovf, w, sgn, stream
    "qk_fused_gemm_s32": (_I, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _P),
    # device, a, b, c, m, n, k, out_bytes, params, modes, stream
    "qk_tree_gemm": (_I, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P),
    # device, a, lda, b, ldb, c, m, n, k, out_bytes, params, modes, digits,
    # stream
    "qk_tree_gemm_hybrid_mma": (_I, _P, _L, _P, _L, _P, _I, _I, _I, _I, _P,
                                _I, _I, _P),
    # device, a, lda, b, ldb, c, m, n, k, out_bytes, params, plan, stream
    "qk_tree_gemm_stream": (_I, _P, _L, _P, _L, _P, _I, _I, _I, _I, _P, _I,
                            _P),
    # device, shared, d, pos, w, out, rows, n, k, out_bytes, steps, stream
    "qk_moe_combine": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # device, a, b, out, n, steps, stream
    "qk_mul_requant": (_I, _P, _P, _P, _L, _P, _P),
    # device, x, out, rows, n, table, mask, gain, steps, stream
    "qk_rms_norm": (_I, _P, _P, _I, _I, _P, _I, _I, _P, _P),
    # device, x, y, out, elems, programs, steps, params, plan, stream
    "qk_chain_probe": (_I, _P, _P, _P, _I, _I, _I, _P, _I, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: building the kernels needs the CUDA "
                       "toolkit (set CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in cu + cuh:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqublas_kernels_{h.hexdigest()[:16]}.so"


def _compile(so: Path):
    global build_seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources()[0]:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, obj, cmd, proc in jobs:
        out, _ = proc.communicate()
        log += [" ".join(cmd), out,
                f"{src.name}: done at {time.perf_counter() - t0:.1f} s, "
                f"code {proc.returncode}"]
        if proc.returncode:
            failed.append(f"{src.name}:\n{out[-4000:]}")
    tmp = so.with_name(f"{tag}.tmp.so")
    objs = [str(obj) for _, obj, _, _ in jobs]
    if not failed:
        cmd = [nvcc, *COMPILE_FLAGS[:2], "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log += [" ".join(cmd), res.stdout + res.stderr]
        if res.returncode:
            failed.append(f"link:\n{res.stderr[-4000:]}")
    build_seconds = time.perf_counter() - t0
    log.append(f"total {build_seconds:.1f} s")
    so.with_suffix(".log").write_text("\n".join(log) + "\n")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # one process builds while the others (ranks, test workers
            # started together) wait for its library
            with open(BUILD_DIR / "kernels.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not so.exists():
                    _compile(so)
        handle = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, kernel: str):
    """Raise if a C entry point reported an error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {err}")


def rq_args(from_frac: int, fmt: QFormat):
    """The requantize step ``from_frac -> fmt`` as ``csrc/requant.cuh``'s
    ``Rq`` fields: shift, round mode, overflow mode, width, signedness."""
    return (from_frac - fmt.frac_bits, int(fmt.round_mode),
            int(fmt.overflow_mode), fmt.storage_bits, int(fmt.signed))


def record(wrapper, instance: str, fmts=()):
    """Note one launch of ``wrapper``'s kernel in ``wrapper.seen``, a
    ``Counter`` keyed by (instantiation, the (round, overflow) pairs of the
    formats ``fmts`` that its requantize steps write): what a sweep reads
    to tell which variants of a kernel it reached.  The launch sites call
    it only inside ``utils.profiling.launch_record``."""
    # names of the distinct pairs only: an enum's name costs a lookup
    pairs = tuple(sorted((r.name, o.name) for r, o in
                         {(f.round_mode, f.overflow_mode) for f in fmts}))
    wrapper.seen[(instance, pairs)] += 1
