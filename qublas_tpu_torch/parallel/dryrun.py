"""The dry run of the sharded surface, and the case runner of its tests.

:func:`dryrun_rank` is the port of ``__graft_entry__.dryrun_multichip``'s
sequence: K-sharded GEMMs (psum, reduce-scatter, the ring, a sqrt ROM),
the M/N-sharded canonical order-sensitive GEMM, the complex K strategies
(TF on int32 dots, Basic in the 40-bit limb domain), the batch strategies,
the sharded reductions (their i32 and limb regimes), pair and limb
operands, the wide and limb K strategies and their rings, the
subtree-aligned K split of real and complex trees and of a reduction, and
(beyond the JAX sequence, so that every strategy runs) the M/N-sharded
order-sensitive complex GEMM, each
held bit for bit (Δ=0) to the single-device call of the port on the same
rank.  :func:`dryrun_multichip` runs it in a world of ranks spawned on
this machine.

:func:`run_cases` runs a list of sharded calls described by plain values
(numpy raws and formats) and returns each result as plain values, so a
test can hold each to its JAX counterpart: the ranks import the port
only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dryrun_rank", "dryrun_multichip", "run_cases"]


def _formats():
    from ..qformat import OverflowMode, qformat

    fa = qformat(3, 4)                                  # int8 storage
    wide = qformat(20, 8)                               # lossless accumulate
    mid = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    return fa, wide, mid


def _same(what: str, got, ref):
    """Δ=0: same format, storage kind and raws (either may be complex)."""
    if hasattr(got, "imag"):
        _same(f"{what} (real)", got.real, ref.real)
        _same(f"{what} (imag)", got.imag, ref.imag)
        return
    assert got.fmt == ref.fmt, (what, got.fmt, ref.fmt)
    assert (got.is_limb, got.is_pair) == (ref.is_limb, ref.is_pair), what
    g = np.asarray(got.raw(), dtype=object).reshape(-1).tolist()
    r = np.asarray(ref.raw(), dtype=object).reshape(-1).tolist()
    assert got.shape == ref.shape and g == r, \
        f"{what}: sharded != single-device"


class _Against:
    """The sharding module with the first call of each strategy run on
    ``mesh`` and again on ``eager`` (a mesh of the same shape whose
    programs run eagerly) in its place, the two results held Δ=0 and the
    first returned; a strategy's later calls run on ``eager`` alone."""

    def __init__(self, module, mesh, eager):
        self._module, self._mesh, self._eager = module, mesh, eager
        self.first = []

    def __getattr__(self, name):
        fn = getattr(self._module, name)

        def swap(v):
            return self._eager if v is self._mesh else v

        def both(*args, **kwargs):
            ref = fn(*map(swap, args),
                     **{k: swap(v) for k, v in kwargs.items()})
            if name in self.first:
                return ref
            self.first.append(name)
            got = fn(*args, **kwargs)
            _same(f"{name}: {self._mesh.programs} vs eager", got, ref)
            return got
        return both


def dryrun_rank(mesh, seed: int = 1, eager=None) -> list:
    """Run the dry-run sequence on this rank's ``mesh`` (every rank of the
    world calls it), its operands drawn from ``seed``, each call held Δ=0
    to the single-device port call; returns the names of the calls
    checked.  Given ``eager`` (a mesh of the same shape whose programs run
    eagerly), only each strategy's first call runs on ``mesh`` (one
    program a strategy, held Δ=0 to the same call on ``eager`` too) and
    the later ones on ``eager``."""
    from ..anus import build_table, sqrt_func
    from ..complex import QComplexTensor
    from ..ops.cgemm import cgemul
    from ..ops.gemm import qgemul
    from ..ops.reduce import qreduce
    from ..qformat import OverflowMode, RoundMode, qformat
    from ..qtensor import QTensor, from_raw
    from . import sharding as S

    if eager is not None:
        S = _Against(S, mesh, eager)
    dev = mesh.device
    fa, wide, mid = _formats()
    f88z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    rng = np.random.RandomState(seed)
    done = []

    def raw(fmt, shape):
        return from_raw(rng.randint(fmt.raw_min, fmt.raw_max + 1, shape),
                        fmt, dev)

    def wide_raw(bits, shape, fmt, scale=1, add=0):
        v = rng.randint(-(1 << bits), 1 << bits, shape, dtype=np.int64)
        return from_raw(v.astype(object) * scale + add, fmt, dev)

    def check(name, got, ref):
        _same(name, got, ref)
        done.append(name)

    m, k, n = 8, 8 * tp, 8 * tp
    a, b = raw(fa, (m, k)), raw(fa, (k, n))
    gk = dict(mul_to=wide, add_formats=(wide,))
    ref = qgemul(a, b, mid, **gk)
    check("k psum", S.sharded_qgemul_k(a, b, mid, mesh, **gk), ref)
    check("k reduce-scatter", S.sharded_qgemul_k(
        a, b, mid, mesh, reduce_scatter=True, **gk), ref)
    check("k pipelined", S.sharded_qgemul_k_pipelined(a, b, mid, mesh, **gk),
          ref)
    a2, b2 = raw(f88z, (dp * 2, 4)), raw(f88z, (4, tp * 2))
    check("mn canonical", S.sharded_qgemul_mn(a2, b2, f88z, mesh),
          qgemul(a2, b2, f88z))

    table = build_table(sqrt_func, mid, mid)
    check("k sqrt ROM", S.sharded_qgemul_k(a, b, mid, mesh,
                                           epilogue_lut=table, **gk),
          qgemul(a, b, mid, epilogue_lut=table, **gk))

    ca = QComplexTensor(a, QTensor(a.data, fa))
    cb = QComplexTensor(b, QTensor(b.data, fa))
    cmid = qformat(5, 4)
    ckw = dict(algo="tf", add_formats=(wide,), ab=cmid, cd=cmid, ba=cmid,
               abc=wide, cdb=wide, bad=wide, AB=wide, BC=wide)
    check("cgemul_k TF", S.sharded_cgemul_k(ca, cb, (mid, mid), mesh, **ckw),
          cgemul(ca, cb, (mid, mid), **ckw))

    f40c, w51 = qformat(25, 15), qformat(51, 30)
    ckw_w = dict(algo="basic", add_formats=(qformat(58, 30),),
                 ac=w51, bd=w51, ad=w51, bc=w51,
                 acbd=qformat(52, 30), adbc=qformat(52, 30))
    cout_w = (qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL),) * 2
    ckk = 8 * tp
    caw = QComplexTensor(wide_raw(39, (2, ckk), f40c),
                         wide_raw(39, (2, ckk), f40c))
    cbw = QComplexTensor(wide_raw(39, (ckk, tp * 2), f40c),
                         wide_raw(39, (ckk, tp * 2), f40c))
    y6w = S.sharded_cgemul_k(caw, cbw, cout_w, mesh, **ckw_w)
    assert y6w.real.is_limb
    check("cgemul_k limb domain (40-bit parts)", y6w,
          cgemul(caw, cbw, cout_w, **ckw_w))

    nbq = dp * tp * 2
    cab = QComplexTensor(raw(fa, (nbq, 2, 4)), raw(fa, (nbq, 2, 4)))
    cbb = QComplexTensor(raw(fa, (nbq, 4, 3)), raw(fa, (nbq, 4, 3)))
    check("cgemul_dp", S.sharded_cgemul_dp(cab, cbb, (mid, mid), mesh, **ckw),
          cgemul(cab, cbb, (mid, mid), **ckw))

    xr = raw(fa, (dp * tp * 2, 8 * tp))
    check("qreduce batch", S.sharded_qreduce(xr, (wide,), axis=1,
                                             mesh=mesh),
          qreduce(xr, (wide,), axis=1))
    x0 = QTensor(xr.data[0], fa)
    check("qreduce_k", S.sharded_qreduce_k(x0, (wide,), mesh=mesh),
          qreduce(x0, (wide,)))
    flr = qformat(40, 28)
    xl8 = wide_raw(62, (8 * tp,), flr, scale=1 << 6, add=1)
    check("qreduce_k limb regime",
          S.sharded_qreduce_k(xl8, (qformat(78, 28),), mesh=mesh),
          qreduce(xl8, (qformat(78, 28),)))

    f40 = qformat(30, 9)
    aw = wide_raw(39, (dp * 2, 8), f40)
    bw = raw(fa, (8, tp * 2))
    assert aw.is_pair
    check("mn pair operands", S.sharded_qgemul_mn(aw, bw, qformat(33, 9),
                                                  mesh),
          qgemul(aw, bw, qformat(33, 9)))

    kw_out = qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)
    kw_fmts = dict(mul_to=qformat(40, 17), add_formats=(qformat(48, 17),))
    kwk = 8 * tp
    aw2 = wide_raw(39, (4, kwk), f40)
    bw16 = wide_raw(15, (kwk, tp * 2), qformat(7, 8))
    ref11 = qgemul(aw2, bw16, kw_out, **kw_fmts)
    for rs in (False, True):
        check(f"k_wide reduce_scatter={rs}", S.sharded_qgemul_k_wide(
            aw2, bw16, kw_out, mesh, reduce_scatter=rs, **kw_fmts), ref11)
    check("k_wide pipelined", S.sharded_qgemul_k_wide_pipelined(
        aw2, bw16, kw_out, mesh, **kw_fmts), ref11)

    nb = dp * tp * 2
    ab, bb = raw(fa, (nb, 4, 8)), raw(fa, (8, 6))
    check("dp", S.sharded_qgemul_dp(ab, bb, mid, mesh, use_pallas=False,
                                    **gk),
          qgemul(ab, bb, mid, **gk))

    f40w = qformat(25, 15)
    kl_out = qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)
    kl_fmts = dict(mul_to=qformat(51, 30), add_formats=(qformat(57, 30),))
    klk = 8 * tp
    awl = wide_raw(39, (3, klk), f40w)
    bwl = wide_raw(39, (klk, tp * 2), f40w)
    ref13 = qgemul(awl, bwl, kl_out, **kl_fmts)
    for rs in (False, True):
        y13 = S.sharded_qgemul_k_limb(awl, bwl, kl_out, mesh,
                                      reduce_scatter=rs, **kl_fmts)
        assert y13.is_limb
        check(f"k_limb reduce_scatter={rs}", y13, ref13)
    check("k_limb pipelined", S.sharded_qgemul_k_limb_pipelined(
        awl, bwl, kl_out, mesh, **kl_fmts), ref13)

    for kt in (8 * tp, 8 * tp + 8, 8 * tp + 3):
        at, bt = raw(f88z, (4, kt)), raw(f88z, (kt, 4))
        check(f"k_tree k={kt}", S.sharded_qgemul_k_tree(
            at, bt, f88z, mesh, add_formats=(f88z,), use_pallas=False),
            qgemul(at, bt, f88z, add_formats=(f88z,)))

    kc = 8 * tp + 5
    cat = QComplexTensor(raw(f88z, (3, kc)), raw(f88z, (3, kc)))
    cbt = QComplexTensor(raw(f88z, (kc, 3)), raw(f88z, (kc, 3)))
    check(f"cgemul_k_tree k={kc}", S.sharded_cgemul_k_tree(
        cat, cbt, (f88z, f88z), mesh, algo="tf", add_formats=(f88z,)),
        cgemul(cat, cbt, (f88z, f88z), algo="tf", add_formats=(f88z,)))

    for nr in (8 * tp, 8 * tp + 3):
        xt5 = raw(f88z, (nr,))
        check(f"qreduce_k_tree n={nr}", S.sharded_qreduce_k_tree(
            xt5, (f88z,), mesh=mesh), qreduce(xt5, (f88z,)))

    fl = qformat(40, 28)
    outl = qformat(50, 30, round_mode=RoundMode.RND_CONV,
                   overflow_mode=OverflowMode.SAT_TCPL)
    al = wide_raw(62, (dp * 2, 6), fl, scale=1 << 6, add=3)
    bl = raw(fa, (6, tp * 2))
    assert al.is_limb
    check("mn limb operands", S.sharded_qgemul_mn(
        al, bl, outl, mesh, mul_to=qformat(48, 40)),
        qgemul(al, bl, outl, mul_to=qformat(48, 40)))

    cam = QComplexTensor(raw(f88z, (dp * 2, 4)), raw(f88z, (dp * 2, 4)))
    cbm = QComplexTensor(raw(f88z, (4, tp * 2)), raw(f88z, (4, tp * 2)))
    cmk = dict(algo="tf", add_formats=(f88z,))
    check("cgemul_mn order-sensitive", S.sharded_cgemul_mn(
        cam, cbm, (f88z, f88z), mesh, **cmk),
        cgemul(cam, cbm, (f88z, f88z), **cmk))
    return done


def _dryrun_world(dp: int, tp: int, device) -> list:
    from .collectives import make_mesh

    return dryrun_rank(make_mesh(dp, tp, device))


def dryrun_multichip(n_devices: int, backend: str = "nccl", devices=None,
                     timeout: float = 900.0) -> list:
    """Run :func:`dryrun_rank` in a world of ``n_devices`` ranks spawned on
    this machine, on a (2, n/2) mesh when ``n_devices`` is even and above
    1, else (1, n), as ``__graft_entry__.dryrun_multichip`` lays its mesh
    out.  ``devices`` is where each rank computes (the card unless named;
    its strategies run as ``make_mesh`` runs them there); returns rank 0's
    list of calls checked."""
    from .launch import run_world

    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return run_world(n_devices, backend, _dryrun_world,
                     (dp, n_devices // dp, devices), timeout=timeout)[0]


# ---------------------------------------------------------------------------
# the case runner of the tests: plain values in, plain values out
# ---------------------------------------------------------------------------

def _decode(v, device):
    """A case's argument as the port's object: ``("q", raws, fmt)`` a
    QTensor, ``("c", re, im, fr, fi)`` a QComplexTensor, ``("lut", in,
    out)`` a sqrt ROM, ``("per_rank", array)`` this rank's entry of
    ``array`` as a tensor; tuples, lists and dicts element by element."""
    import torch

    from ..anus import build_table, sqrt_func
    from ..complex import QComplexTensor
    from ..qtensor import from_raw

    if isinstance(v, tuple) and v and v[0] == "per_rank":
        rank = torch.distributed.get_rank()
        return torch.from_numpy(np.ascontiguousarray(v[1][rank])).to(device)
    if isinstance(v, tuple) and v and v[0] == "q":
        return from_raw(v[1], v[2], device)
    if isinstance(v, tuple) and v and v[0] == "c":
        return QComplexTensor(from_raw(v[1], v[3], device),
                              from_raw(v[2], v[4], device))
    if isinstance(v, tuple) and v and v[0] == "lut":
        return build_table(sqrt_func, v[1], v[2])
    if isinstance(v, (tuple, list)):
        return type(v)(_decode(x, device) for x in v)
    if isinstance(v, dict):
        return {k: _decode(x, device) for k, x in v.items()}
    return v


def _encode(res):
    """A result as plain values: ``("q", fmt, raws, is_limb, is_pair)``,
    ``("c", q_re, q_im)``, ``("t", array)`` for a tensor, or the value
    itself."""
    import torch

    if isinstance(res, torch.Tensor):
        return ("t", res.cpu().numpy())
    if hasattr(res, "imag"):
        return ("c", _encode(res.real), _encode(res.imag))
    if hasattr(res, "fmt"):
        return ("q", res.fmt, np.asarray(res.raw(), dtype=object),
                bool(res.is_limb), bool(res.is_pair))
    return res


def run_cases(cases, device, programs=None, stats=None) -> list:
    """Run each case ``(fn_name, (dp, tp), args, kwargs)`` of
    :mod:`.sharding` on this rank (every rank of the world runs the same
    list), its operands on ``device`` (``"cuda"`` or ``"cpu"``), its
    meshes' strategies run as ``programs`` says (``make_mesh``'s: eager or
    a compiled backend), and return, a case each, ``("ok", encoded
    result)`` or ``("raise", exception class names, message)``.  An
    exception is recorded and the next case runs: every gate the cases
    exercise raises before any collective, on every rank alike.  A list
    ``stats`` receives, a case each, the ``(calls, bytes)`` the case added
    to its mesh's ``stats``.  Raises ``RuntimeError`` if the rank has
    imported JAX or the JAX package."""
    import sys

    from . import sharding as S
    from .collectives import make_mesh

    meshes, out = {}, []
    for fn_name, shape, args, kwargs in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape[0], shape[1], device, programs)
        mesh = meshes[shape]
        before = dict(mesh.stats)
        try:
            res = getattr(S, fn_name)(*_decode(args, device), mesh=mesh,
                                      **_decode(kwargs, device))
            out.append(("ok", _encode(res)))
        except Exception as e:
            out.append(("raise", [c.__name__ for c in type(e).__mro__],
                        str(e)))
        if stats is not None:
            stats.append((mesh.stats["calls"] - before["calls"],
                          mesh.stats["bytes"] - before["bytes"]))
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "qublas_tpu")]
    if bad:
        raise RuntimeError(f"the rank imported {bad[:5]}")
    return out
