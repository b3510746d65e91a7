"""The port's copy of ``qublas_tpu/native.py``: ctypes bindings of the
native C++ host engine (``native/qublas_host.cpp``) and the CPython
marshalling extension (``native/fastlimbs.c``) for host storage.

Both are compiled from the checkout with ``g++`` at first use into
``build/qublas_tpu_torch/`` (never beside the sources), each named by a
hash of its source and flags, so an edit rebuilds it and an unchanged tree
reuses it.  One process compiles, under a lock, into a name of its own and
renames the library into place; concurrent test workers wait for it.  A
machine without ``g++`` has no engine (:func:`available` is False) and
every caller takes the exact Python model; where ``g++`` exists, a failed
build raises.  The engine covers formats whose values and intermediates
fit its 64-bit or multiword envelope; each wrapper checks that with the
width proofs and returns None outside it, and the caller then takes the
Python model (a routing decision, as in the JAX package).

Semantics: identical to :mod:`.hostint` / :mod:`.hostops`
(``tests/test_torch_native.py`` holds them in every mode).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ._build import BUILD_DIR
from .qformat import OverflowMode, QFormat

_SRC = Path(__file__).resolve().parent.parent / "native" / "qublas_host.cpp"
_FL_SRC = _SRC.parent / "fastlimbs.c"
_lock = threading.Lock()
_lib = None
_tried = False


class _Fmt(ctypes.Structure):
    _fields_ = [("int_bits", ctypes.c_int32), ("frac_bits", ctypes.c_int32),
                ("is_signed", ctypes.c_int32), ("round_mode", ctypes.c_int32),
                ("overflow_mode", ctypes.c_int32)]


def _fmt(f: QFormat) -> _Fmt:
    return _Fmt(f.int_bits, f.frac_bits, int(f.signed), int(f.round_mode),
                int(f.overflow_mode))


def _compile(src: Path, stem: str, flags) -> Optional[Path]:
    """``g++ flags src`` into ``BUILD_DIR/<stem>_<hash>.so`` unless it is
    there; None without ``g++``.  Raises when ``g++`` fails."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    so = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one process compiles while the others wait for its library
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        res = subprocess.run([gxx, *flags, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if res.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {src}:\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
    return so


def _build() -> Optional[ctypes.CDLL]:
    so = _compile(_SRC, "libqublas_host", ("-O3", "-shared", "-fPIC"))
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(_Fmt)
    lib.qh_requantize.argtypes = [i64p, i64p, ctypes.c_size_t,
                                  ctypes.c_int32, fp]
    lib.qh_double_to_raw.argtypes = [dp, i64p, ctypes.c_size_t, fp]
    lib.qh_mul.argtypes = [i64p, i64p, i64p, ctypes.c_size_t,
                           ctypes.c_int32, ctypes.c_int32, fp]
    lib.qh_addsub.argtypes = [i64p, i64p, i64p, ctypes.c_size_t,
                              ctypes.c_int32, ctypes.c_int32,
                              ctypes.c_int32, fp]
    lib.qh_div.argtypes = [i64p, i64p, i64p, ctypes.c_size_t,
                           ctypes.c_int32, ctypes.c_int32, fp]
    lib.qh_tree_gemm.argtypes = [i64p, i64p, i64p,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64,
                                 ctypes.c_int32, ctypes.c_int32,
                                 fp, fp, fp, ctypes.c_int32,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.c_int32, fp]
    lib.qh_cast.argtypes = [i64p, i64p, ctypes.c_size_t, ctypes.c_int32, fp]
    lib.qh_pack_bits.argtypes = [i64p, ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_int32]
    lib.qh_unpack_bits.argtypes = [ctypes.c_char_p, i64p, ctypes.c_size_t,
                                   ctypes.c_int32, ctypes.c_int32]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.qh_w_limbs.restype = ctypes.c_int32
    lib.qh_wx_supported.restype = ctypes.c_int32
    lib.qh_wx_supported.argtypes = [ctypes.c_int32]
    i32 = ctypes.c_int32
    lib.qh_wx_requantize.argtypes = [u64p, u64p, ctypes.c_size_t,
                                     i32, i32, i32, i32, fp]
    lib.qh_wx_mul.argtypes = [u64p, u64p, u64p, ctypes.c_size_t,
                              i32, i32, i32, i32, i32, i32, fp]
    lib.qh_wx_addsub.argtypes = [u64p, u64p, u64p, ctypes.c_size_t,
                                 i32, i32, i32, i32, i32, i32, i32, fp]
    lib.qh_wx_div.argtypes = [u64p, u64p, u64p, ctypes.c_size_t,
                              i32, i32, i32, i32, i32, i32, fp]
    lib.qh_wx_shift.argtypes = [u64p, u64p, ctypes.c_size_t,
                                i32, i32, i32, i32]
    lib.qh_wx_tree_gemm.argtypes = [u64p, u64p, u64p,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, i32, i32, i32, i32,
                                    i32, i32,
                                    fp, fp, fp, i32,
                                    ctypes.POINTER(i32), i32, fp]
    lib.qh_abi_version.restype = ctypes.c_int32
    if lib.qh_abi_version() != 7 or lib.qh_w_limbs() != _NL \
            or not all(lib.qh_wx_supported(nl) for nl in _W_NL_OPTIONS):
        raise RuntimeError(f"{so}: not the engine these bindings expect")
    return lib


_fl_mod = None
_fl_tried = False


def _build_fastlimbs():
    """Compile and import the CPython marshalling extension (int <-> limb
    buffers via _PyLong_AsByteArray, one C loop per batch); None without
    ``g++`` or Python's headers, and then the pure-Python
    to_bytes/from_bytes loops run."""
    inc = sysconfig.get_paths()["include"]
    if not (Path(inc) / "Python.h").exists():
        return None
    so = _compile(_FL_SRC, "qublas_fastlimbs",
                  ("-O2", "-shared", "-fPIC", f"-I{inc}"))
    if so is None:
        return None
    spec = importlib.util.spec_from_file_location("qublas_fastlimbs", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_fastlimbs():
    """The marshalling extension, built on first call, or None."""
    global _fl_mod, _fl_tried
    with _lock:
        if not _fl_tried:
            _fl_tried = True
            _fl_mod = _build_fastlimbs()
        return _fl_mod


def get_lib() -> Optional[ctypes.CDLL]:
    """The engine, built on first call, or None without ``g++``."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = _build()
        return _lib


def available() -> bool:
    return get_lib() is not None


def _i64(a) -> Optional[np.ndarray]:
    arr = np.asarray(a)
    if arr.dtype == object:
        try:
            arr = arr.astype(np.int64)
        except (OverflowError, TypeError):
            return None
    return np.ascontiguousarray(arr, dtype=np.int64)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


_MAX_TOTAL_BITS = 126  # i128 headroom

# multiword engine envelope: templated limb counts (8/16/32/64/128 x
# uint64 — 512..8192-bit working widths; 64/128 added late round 4); every
# intermediate (products, alignment shifts, +1 rounding carries) must fit
# the picked width signed.  _NL stays the legacy/default marshalling width;
# wider ops pick the smallest sufficient count via _w_pick_nl (round-3:
# >512-bit working widths — e.g. 300-bit x 300-bit products — now run
# compiled instead of on per-element Python ints).
_NL = 8
_W_NL_OPTIONS = (8, 16, 32, 64, 128)
_W_MAX_BITS = 64 * _W_NL_OPTIONS[-1] - 2


def _nl_for(bits: int) -> int:
    """Limbs needed to store a ``bits``-bit signed value (element width on
    the variable-limb ABI — operands marshal at their value width)."""
    return max((bits + 63) // 64, 1)


def _w_pick_nl(need_bits: int) -> Optional[int]:
    """Smallest engine limb count whose signed working width (with the
    2-bit negation/carry margin) covers ``need_bits``."""
    for nl in _W_NL_OPTIONS:
        if need_bits <= 64 * nl - 2:
            return nl
    return None


def _to_limbs(arr, nl: int = _NL) -> Optional[np.ndarray]:
    """Object array of Python ints -> (n, nl) uint64 limb matrix (LE,
    two's complement mod 2^(64*nl)).  None if any value does not fit.

    ``int.to_bytes`` does the split at C speed — the Python-level cost is
    one call per element, not one per limb."""
    flat = np.asarray(arr, dtype=object).reshape(-1)
    nbytes = 8 * nl
    fl = get_fastlimbs()
    try:
        if fl is not None:
            buf = fl.to_bytes(flat.tolist(), nbytes)
        else:
            buf = b"".join(
                int(v).to_bytes(nbytes, "little", signed=True)
                for v in flat)
    except OverflowError:
        return None  # a value does not fit the working width signed
    # no copy: engine inputs are read-only, frombuffer is contiguous
    return np.frombuffer(buf, dtype=np.uint64).reshape(-1, nl)


def _from_limbs(limbs: np.ndarray, nl: int = _NL) -> np.ndarray:
    """(n, nl) uint64 limbs -> object array of signed Python ints."""
    n = limbs.shape[0]
    raw = np.ascontiguousarray(limbs).tobytes()
    nbytes = 8 * nl
    fl = get_fastlimbs()
    if fl is not None:
        out = np.empty(n, dtype=object)
        out[:] = fl.from_bytes(raw, n, nbytes)
        return out
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little",
                                signed=True)
    return out


def _uptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _w_requant_bits(src_bits: int, from_frac: int, to: QFormat) -> int:
    """Working width a multiword requantize needs (intermediates + the
    WRP_TCPL_SAT machine word the store may wrap at)."""
    d = from_frac - to.frac_bits
    width = src_bits + max(-d, 0) + 1
    word = 64 * ((to.storage_bits + 63) // 64)  # WRP_TCPL_SAT machine word
    return max(width, word)


def _w_requant_fits(src_bits: int, from_frac: int, to: QFormat) -> bool:
    return _w_requant_bits(src_bits, from_frac, to) <= _W_MAX_BITS


def _requant_fits(src_bits: int, from_frac: int, to: QFormat) -> bool:
    """Intermediates of frac_convert/int_convert must fit i128."""
    d = from_frac - to.frac_bits
    width = src_bits + max(-d, 0) + 1
    return width <= _MAX_TOTAL_BITS and to.storage_bits <= 64


def _eff_width(fmt: QFormat) -> int:
    """Width actually occupied by a value stored in ``fmt``: the declared
    storage, except WRP_TCPL_SAT (identity stub) where values wrap only at
    the machine word — int32 / int64 / 64·ceil(w/64) bits."""
    w = fmt.storage_bits
    if fmt.overflow_mode != OverflowMode.WRP_TCPL_SAT:
        return w
    return 32 if w <= 32 else 64 if w <= 64 else 64 * ((w + 63) // 64)


def _value_bits(arr) -> int:
    """Max two's-complement width of the actual values (the ``fill(int)``
    wart lets raws legally exceed their format's storage range, so envelope
    proofs must use real value widths, not declared ones)."""
    flat = np.asarray(arr, dtype=object).reshape(-1)
    if flat.size == 0:
        return 1
    fl = get_fastlimbs()
    if fl is not None:
        return fl.max_bits(flat.tolist())
    bits = 1
    for v in flat:
        v = int(v)
        bits = max(bits, (v.bit_length() + 1) if v >= 0
                   else ((-v - 1).bit_length() + 1))
    return bits


def requantize(raws, from_fmt: QFormat, to: QFormat) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    src_bits = max(_eff_width(from_fmt), _value_bits(raws))
    if src_bits <= 64 and _requant_fits(src_bits, from_fmt.frac_bits, to):
        a = _i64(raws)
        if a is not None:
            out = np.empty_like(a)
            lib.qh_requantize(_ptr(a), _ptr(out), a.size, from_fmt.frac_bits,
                              ctypes.byref(_fmt(to)))
            return out
    return requantize_wide(raws, from_fmt.frac_bits, to, src_bits)


def requantize_wide(raws, from_frac: int, to: QFormat,
                    src_bits: int) -> Optional[np.ndarray]:
    """Multiword compiled requantize (working width picked per config);
    object-int in/out."""
    lib = get_lib()
    if lib is None:
        return None
    nl = _w_pick_nl(_w_requant_bits(src_bits, from_frac, to))
    if nl is None:
        return None
    arr = np.asarray(raws, dtype=object)
    nla = min(_nl_for(src_bits), nl)
    nlo = min(_nl_for(_eff_width(to)), nl)
    limbs = _to_limbs(arr, nla)
    if limbs is None:
        return None
    out = np.empty((limbs.shape[0], nlo), dtype=np.uint64)
    lib.qh_wx_requantize(_uptr(limbs), _uptr(out), limbs.shape[0], nl,
                         nla, nlo, from_frac, ctypes.byref(_fmt(to)))
    return _from_limbs(out, nlo).reshape(arr.shape)


def double_to_raw(vals, fmt: QFormat) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None or fmt.storage_bits > 64:
        return None
    if fmt.overflow_mode in (OverflowMode.WRP_TCPL, OverflowMode.WRP_TCPL_SAT):
        return None  # exact wrap of huge doubles needs arbitrary precision
    a = np.ascontiguousarray(np.asarray(vals, dtype=np.float64))
    out = np.empty(a.shape, dtype=np.int64)
    lib.qh_double_to_raw(a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         _ptr(out), a.size, ctypes.byref(_fmt(fmt)))
    return out


def binary_op(op: str, a_raws, b_raws, fa: QFormat, fb: QFormat,
              to: QFormat) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    # envelope proofs use the ACTUAL value widths (max with the declared
    # storage): the fill(int) wart lets raws exceed their format's range
    ea = max(_eff_width(fa), _value_bits(a_raws))
    eb = max(_eff_width(fb), _value_bits(b_raws))
    if ea > 64 or eb > 64 or to.storage_bits > 64:
        return binary_op_wide(op, a_raws, b_raws, fa, fb, to,
                              sa_bits=ea, sb_bits=eb)
    a, b = _i64(a_raws), _i64(b_raws)
    if a is None or b is None:
        return binary_op_wide(op, a_raws, b_raws, fa, fb, to,
                              sa_bits=ea, sb_bits=eb)
    a, b = np.broadcast_arrays(a, b)
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    out = np.empty_like(a)
    if op == "mul":
        if not _requant_fits(ea + eb, fa.frac_bits + fb.frac_bits, to):
            return binary_op_wide(op, a_raws, b_raws, fa, fb, to,
                              sa_bits=ea, sb_bits=eb)
        lib.qh_mul(_ptr(a), _ptr(b), _ptr(out), a.size, fa.frac_bits,
                   fb.frac_bits, ctypes.byref(_fmt(to)))
    elif op in ("add", "sub"):
        f = max(fa.frac_bits, fb.frac_bits)
        src = max(ea + f - fa.frac_bits, eb + f - fb.frac_bits) + 1
        if not _requant_fits(src, f, to):
            return binary_op_wide(op, a_raws, b_raws, fa, fb, to,
                              sa_bits=ea, sb_bits=eb)
        lib.qh_addsub(_ptr(a), _ptr(b), _ptr(out), a.size, fa.frac_bits,
                      fb.frac_bits, 1 if op == "sub" else 0,
                      ctypes.byref(_fmt(to)))
    elif op == "div":
        sa = max(fb.frac_bits - fa.frac_bits, 0)
        sb = max(fa.frac_bits - fb.frac_bits, 0)
        if ea + sa + max(to.frac_bits, 0) > _MAX_TOTAL_BITS or \
                eb + sb > _MAX_TOTAL_BITS:
            return binary_op_wide(op, a_raws, b_raws, fa, fb, to,
                                  sa_bits=ea, sb_bits=eb)
        lib.qh_div(_ptr(a), _ptr(b), _ptr(out), a.size, fa.frac_bits,
                   fb.frac_bits, ctypes.byref(_fmt(to)))
    else:
        raise ValueError(op)
    return out


def binary_op_wide(op: str, a_raws, b_raws, fa: QFormat, fb: QFormat,
                   to: QFormat, sa_bits: Optional[int] = None,
                   sb_bits: Optional[int] = None) -> Optional[np.ndarray]:
    """Compiled multiword elementwise ops — the reference's 200-bit test
    territory (test/ArbiInt grids) at C speed instead of the Python loop.

    ``sa_bits``/``sb_bits`` let :func:`binary_op` pass its already-computed
    value widths (``_value_bits`` is an O(n) Python pass over object raws —
    don't do it twice)."""
    lib = get_lib()
    if lib is None:
        return None
    if sa_bits is None:
        sa_bits = max(_eff_width(fa), _value_bits(a_raws))
    if sb_bits is None:
        sb_bits = max(_eff_width(fb), _value_bits(b_raws))
    if op == "mul":
        need = _w_requant_bits(sa_bits + sb_bits,
                               fa.frac_bits + fb.frac_bits, to)
    elif op == "div":
        # round-5 compiled multiword divider (qh_wx_div): numerator
        # upshifts by sa + out frac, denominator by sb; the quotient is
        # bounded by the numerator and only the overflow stage runs
        sa = max(fb.frac_bits - fa.frac_bits, 0)
        sb = max(fa.frac_bits - fb.frac_bits, 0)
        num_bits = sa_bits + sa + max(to.frac_bits, 0) + 1
        need = max(_w_requant_bits(num_bits, to.frac_bits, to),
                   sb_bits + sb + 1)
    else:
        f = max(fa.frac_bits, fb.frac_bits)
        src = max(sa_bits + f - fa.frac_bits, sb_bits + f - fb.frac_bits) + 1
        need = _w_requant_bits(src, f, to)
    nl = _w_pick_nl(need)
    if nl is None:
        return None
    a = np.asarray(a_raws, dtype=object)
    b = np.asarray(b_raws, dtype=object)
    a, b = np.broadcast_arrays(a, b)
    nla, nlb = min(_nl_for(sa_bits), nl), min(_nl_for(sb_bits), nl)
    nlo = min(_nl_for(_eff_width(to)), nl)
    la, lb = _to_limbs(a, nla), _to_limbs(b, nlb)
    if la is None or lb is None:
        return None
    out = np.empty((la.shape[0], nlo), dtype=np.uint64)
    if op == "mul":
        lib.qh_wx_mul(_uptr(la), _uptr(lb), _uptr(out), la.shape[0], nl,
                      nla, nlb, nlo, fa.frac_bits, fb.frac_bits,
                      ctypes.byref(_fmt(to)))
    elif op == "div":
        lib.qh_wx_div(_uptr(la), _uptr(lb), _uptr(out), la.shape[0], nl,
                      nla, nlb, nlo, fa.frac_bits, fb.frac_bits,
                      ctypes.byref(_fmt(to)))
    else:
        lib.qh_wx_addsub(_uptr(la), _uptr(lb), _uptr(out), la.shape[0], nl,
                         nla, nlb, nlo, fa.frac_bits, fb.frac_bits,
                         1 if op == "sub" else 0, ctypes.byref(_fmt(to)))
    return _from_limbs(out, nlo).reshape(a.shape)


def shift_wide(raws, shift: int) -> Optional[np.ndarray]:
    """Compiled multiword structural shift (left >= 0, arithmetic right
    < 0) — mirrors reference staticShiftLeft/Right value semantics."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.asarray(raws, dtype=object)
    vb = _value_bits(arr)
    nl = _w_pick_nl(vb + max(shift, 0) + 1)
    if nl is None:
        return None
    nla = min(_nl_for(vb), nl)
    nlo = min(_nl_for(vb + max(shift, 0) + 1), nl)
    limbs = _to_limbs(arr, nla)
    if limbs is None:
        return None
    out = np.empty((limbs.shape[0], nlo), dtype=np.uint64)
    lib.qh_wx_shift(_uptr(limbs), _uptr(out), limbs.shape[0], nl,
                    nla, nlo, shift)
    return _from_limbs(out, nlo).reshape(arr.shape)


_OPCODES = {"seed": 0, "convert": 1, "add": 2}


def tree_gemm_host(A, B, fa: QFormat, fb: QFormat, mul_fmt: QFormat,
                   add_formats, out_fmt: QFormat) -> Optional[np.ndarray]:
    """Exact host GEMM with per-product quantization and per-layer tree
    accumulation, on the C++ engine (streaming binary-carry — same
    association order as the reference's vector-path reducer; differential
    tests pin it to hostops.qgemul).  Returns int64 [m, n] raws at
    ``out_fmt``, or None outside the 64-bit envelope."""
    lib = get_lib()
    if lib is None:
        return None
    from .ops.tree_gemm import drain_ops, level_formats

    a = _i64(A)
    b = _i64(B)
    A_obj = np.asarray(A, dtype=object)
    if A_obj.ndim != 2 or np.asarray(B, dtype=object).ndim != 2:
        return None
    m, k = A_obj.shape
    n = np.asarray(B, dtype=object).shape[1]
    level_fmts, merge_fmts = level_formats(mul_fmt, add_formats, k)
    drain = drain_ops(k, len(merge_fmts))
    final_fmt = mul_fmt
    for op, l in drain:
        final_fmt = level_fmts[l] if op == "seed" else merge_fmts[l]

    # operand widths use ACTUAL values (fill(int) wart can exceed storage);
    # intermediate level widths use machine-word-aware effective widths
    # (WRP_TCPL_SAT stores beyond its declared storage)
    ea = max(_eff_width(fa), _value_bits(A_obj))
    eb = max(_eff_width(fb), _value_bits(B))
    narrow = a is not None and b is not None and ea <= 64 and eb <= 64 \
        and all(_eff_width(f) <= 64
                for f in [mul_fmt, out_fmt] + level_fmts + merge_fmts) \
        and _requant_fits(ea + eb, fa.frac_bits + fb.frac_bits, mul_fmt) \
        and all(_requant_fits(_eff_width(level_fmts[l]) + 1,
                              level_fmts[l].frac_bits, mf)
                for l, mf in enumerate(merge_fmts)) \
        and _requant_fits(_eff_width(final_fmt), final_fmt.frac_bits,
                          out_fmt)

    ops = np.array([v for op, l in drain for v in (_OPCODES[op], l)],
                   dtype=np.int32)
    lf_arr = (_Fmt * len(level_fmts))(*[_fmt(f) for f in level_fmts])
    mf_arr = (_Fmt * len(merge_fmts))(*[_fmt(f) for f in merge_fmts])
    if narrow:
        out = np.empty((m, n), dtype=np.int64)
        lib.qh_tree_gemm(
            _ptr(np.ascontiguousarray(a)), _ptr(np.ascontiguousarray(b)),
            _ptr(out), m, k, n, fa.frac_bits, fb.frac_bits,
            ctypes.byref(_fmt(mul_fmt)), lf_arr, mf_arr, len(merge_fmts),
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(drain),
            ctypes.byref(_fmt(out_fmt)))
        final = np.empty_like(out)
        lib.qh_cast(_ptr(out), _ptr(final), out.size, final_fmt.frac_bits,
                    ctypes.byref(_fmt(out_fmt)))
        return final

    # multiword engine: the reference's >64-bit GEMM territory compiled.
    # Envelope: products and every merge intermediate must fit the picked
    # working width (smallest of 512/1024/2048 bits that covers them all).
    need = _w_requant_bits(ea + eb, fa.frac_bits + fb.frac_bits, mul_fmt)
    for l, mf in enumerate(merge_fmts):
        need = max(need, _w_requant_bits(_eff_width(level_fmts[l]) + 1,
                                         level_fmts[l].frac_bits, mf))
    need = max(need, _w_requant_bits(_eff_width(final_fmt),
                                     final_fmt.frac_bits, out_fmt))
    nl = _w_pick_nl(need)
    if nl is None:
        return None
    nla, nlb = min(_nl_for(ea), nl), min(_nl_for(eb), nl)
    nlm = min(_nl_for(_eff_width(final_fmt)), nl)
    nlo = min(_nl_for(_eff_width(out_fmt)), nl)
    la = _to_limbs(A_obj, nla)
    lb = _to_limbs(np.asarray(B, dtype=object), nlb)
    if la is None or lb is None:
        return None
    out = np.empty((m * n, nlm), dtype=np.uint64)
    lib.qh_wx_tree_gemm(
        _uptr(la), _uptr(lb), _uptr(out), m, k, n, nl, nla, nlb, nlm,
        fa.frac_bits, fb.frac_bits,
        ctypes.byref(_fmt(mul_fmt)), lf_arr, mf_arr, len(merge_fmts),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(drain),
        ctypes.byref(_fmt(out_fmt)))
    final = np.empty((m * n, nlo), dtype=np.uint64)
    lib.qh_wx_requantize(_uptr(out), _uptr(final), m * n, nl, nlm, nlo,
                         final_fmt.frac_bits, ctypes.byref(_fmt(out_fmt)))
    return _from_limbs(final, nlo).reshape(m, n)


def pack_bits(raws, width: int) -> Optional[str]:
    lib = get_lib()
    if lib is None or width > 64 or width <= 0:
        return None
    a = _i64(raws)
    if a is None:
        return None
    buf = ctypes.create_string_buffer(a.size * width)
    lib.qh_pack_bits(_ptr(a), buf, a.size, width)
    return buf.raw.decode("ascii")


def unpack_bits(bits: str, width: int,
                twos_complement: bool) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None or width >= 64 or width <= 0 or len(bits) % width:
        return None
    n = len(bits) // width
    out = np.empty(n, dtype=np.int64)
    lib.qh_unpack_bits(bits.encode("ascii"), _ptr(out), n, width,
                       1 if twos_complement else 0)
    return out
