"""The torch port's complex GEMM against the JAX package, Δ=0.

``cgemul``/``cgemv`` on CPU tensors (the dots take ``int_dot``'s plain
version, the reduce K3's) against ``qublas_tpu.ops.cgemm`` on the CPU: the
same raws, formats and lane dtypes, and the same route decision (the fast
path's ``info["domain"]``, or None where the proof sends the config to the
layered path).  Where the JAX package would compute in its limb domain the
port raises.  Inputs come from numpy seeds; formats cross with ``P``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qublas_tpu.complex import QComplexTensor as JQC
from qublas_tpu.complex import complex_from_raw as jcomplex
from qublas_tpu.ops import cgemm as JCG
from qublas_tpu.qformat import OverflowMode, RoundMode, qformat
from qublas_tpu.qtensor import from_raw as jfrom_raw
from qublas_tpu_torch import hostops
from qublas_tpu_torch.convert import complex_from_jax, port_format
from qublas_tpu_torch.ops import cgemm as TCG

F = qformat(3, 4)
WIDE = qformat(20, 8)
MID = qformat(5, 4)
OUT5 = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2
BASIC_KW = dict(ac=WIDE, bd=WIDE, ad=WIDE, bc=WIDE, acbd=WIDE, adbc=WIDE)
TF_KW = dict(ab=MID, cd=MID, ba=MID, abc=WIDE, cdb=WIDE, bad=WIDE, AB=WIDE,
             BC=WIDE)
F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)


def P(f):
    """The port's formats of a JAX-package format, pair or layer list."""
    if f is None:
        return None
    if isinstance(f, (tuple, list)):
        return tuple(P(x) for x in f)
    return port_format(f)


def _kw(algo):
    return BASIC_KW if algo == "basic" else TF_KW


def _mat(seed, shape, fr=F, fi=F, dtype=None):
    rng = np.random.RandomState(seed)
    re = rng.randint(fr.raw_min, fr.raw_max + 1, shape)
    im = rng.randint(fi.raw_min, fi.raw_max + 1, shape)
    if dtype is not None:
        re, im = re.astype(dtype), im.astype(dtype)
    return jcomplex(re, im, fr, fi)


def _same(got, want):
    for g, w in ((got.real, want.real), (got.imag, want.imag)):
        assert dataclasses.astuple(g.fmt) == dataclasses.astuple(w.fmt)
        assert g.data.dtype == getattr(torch, str(w.data.dtype))
        np.testing.assert_array_equal(g.raw(), np.asarray(w.raw()))


def _both(a, b, out, algo, add_formats, tags, **kw):
    """cgemul of the same operands through both packages."""
    want = JCG.cgemul(a, b, out, algo=algo, add_formats=add_formats, **tags,
                      **kw)
    got = TCG.cgemul(complex_from_jax(a, "cpu"), complex_from_jax(b, "cpu"),
                     P(out), algo=algo, add_formats=P(add_formats),
                     **{k: P(v) for k, v in tags.items()}, **kw)
    return got, want


def _domains(a, b, out, algo, layers, tags):
    """The fast path's route decision in both packages: ``info["domain"]``
    of a computed result, None where the proof fails."""
    orf, oif = out if isinstance(out, tuple) else (out, out)
    j_info, t_info = {}, {}
    jres = JCG._fast_cgemul(a, b, orf, oif, algo, layers, layers, tags,
                            info=j_info)
    tres = TCG._fast_cgemul(complex_from_jax(a, "cpu"),
                            complex_from_jax(b, "cpu"), P(orf), P(oif), algo,
                            P(layers), P(layers),
                            {k: P(v) for k, v in tags.items()}, info=t_info)
    assert (jres is None) == (tres is None)
    return j_info.get("domain"), t_info.get("domain")


@pytest.mark.parametrize("algo", ["basic", "tf"])
@pytest.mark.parametrize("k", [1, 2, 5, 16, 33])
def test_fast_path_matches_jax(algo, k):
    a, b = _mat(k, (4, k)), _mat(k + 100, (k, 3))
    out = (qformat(18, 8), qformat(18, 8))
    got, want = _both(a, b, out, algo, (WIDE,), _kw(algo))
    _same(got, want)
    assert _domains(a, b, out, algo, (WIDE,), _kw(algo)) == ("i32", "i32")
    with JCG.force_fast_off():
        layered_j = JCG.cgemul(a, b, out, algo=algo, add_formats=(WIDE,),
                               **_kw(algo))
    with TCG.force_fast_off():
        layered_t, _ = _both(a, b, out, algo, (WIDE,), _kw(algo))
    _same(layered_t, layered_j)
    _same(got, layered_j)


@pytest.mark.parametrize("algo", ["basic", "tf"])
def test_config5_matches_jax_and_host(algo):
    """BASELINE config 5's formats at 16x33x8; the TF form distributes
    over four int8 dots.  A corner against the port's host golden model."""
    a, b = _mat(5, (16, 33), dtype=np.int8), _mat(6, (33, 8), dtype=np.int8)
    got, want = _both(a, b, OUT5, algo, (WIDE,), _kw(algo))
    _same(got, want)
    assert got.real.data.dtype == torch.int8
    ta, tb = complex_from_jax(a, "cpu"), complex_from_jax(b, "cpu")
    fp = TCG._fast_plan(ta, tb, *P(OUT5), algo, P((WIDE,)), P((WIDE,)),
                        {k: P(v) for k, v in _kw(algo).items()}, 33,
                        TCG._int8_parts(ta, tb))
    assert fp.form == ("tf4" if algo == "tf" else "basic")

    def rows(x):
        re, im = x.real.raw(), x.imag.raw()
        return [[((int(re[i, j]), x.real.fmt), (int(im[i, j]), x.imag.fmt))
                 for j in range(re.shape[1])] for i in range(re.shape[0])]

    host = hostops.cgemul(rows(ta[:3]), rows(tb[:, :4]), P(OUT5), algo,
                          P((WIDE,)),
                          **{k: P(v) for k, v in _kw(algo).items()})
    assert [[(r[0], i[0]) for r, i in row] for row in host] == \
        [[(int(got.real.raw()[i, j]), int(got.imag.raw()[i, j]))
          for j in range(4)] for i in range(3)]


def test_mixed_part_formats_and_transposes():
    fr, fi = qformat(3, 4), qformat(2, 5)
    out = (qformat(18, 9), qformat(17, 9))
    for algo in ("basic", "tf"):
        a, b = _mat(7, (6, 3), fr, fi), _mat(8, (4, 6), fr, fi)
        got, want = _both(a, b, out, algo, (WIDE,), _kw(algo),
                          transpose_a=True, transpose_b=True)
        _same(got, want)
        assert got.shape == (3, 4)


def test_tf_three_dot_form_on_wider_lanes():
    """int16 operand lanes: TF's three dots on the operand sums (K1's int32
    instantiation on the card)."""
    f = qformat(7, 4)
    wide, mid = qformat(22, 8), qformat(9, 4)
    tags = dict(ab=mid, cd=mid, ba=mid, abc=wide, cdb=wide, bad=wide,
                AB=wide, BC=wide)
    a, b = _mat(9, (5, 12), f, f), _mat(10, (12, 7), f, f)
    out = (qformat(22, 8), qformat(12, 4, overflow_mode=OverflowMode.SAT_TCPL))
    got, want = _both(a, b, out, "tf", (wide,), tags)
    _same(got, want)
    ta, tb = complex_from_jax(a, "cpu"), complex_from_jax(b, "cpu")
    assert ta.real.data.dtype == torch.int16
    fp = TCG._fast_plan(ta, tb, *P(out), "tf", P((wide,)), P((wide,)),
                        {k: P(v) for k, v in tags.items()}, 12,
                        TCG._int8_parts(ta, tb))
    assert fp.form == "tf3"


def test_epilogue_saturation_allowed():
    narrow = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),
              qformat(3, 4))
    a, b = _mat(11, (4, 8)), _mat(12, (8, 4))
    got, want = _both(a, b, narrow, "basic", (WIDE,), BASIC_KW)
    _same(got, want)


@pytest.mark.parametrize("name", ["lossy-basic", "tf-ba-default",
                                  "canonical"])
def test_lossy_configs_take_the_layered_path(name):
    """Configs the proof refuses: both packages return None from the fast
    path and compute the layered program, with the same bits."""
    f44 = qformat(4, 4)
    if name == "lossy-basic":
        f, out, algo, layers, tags = f44, f44, "basic", (), {}
    elif name == "tf-ba-default":
        # the default-inferred TF ba stage saturates
        f, out, algo, layers = f44, WIDE, "tf", (WIDE,)
        tags = dict(ab=MID, cd=MID, abc=WIDE, cdb=WIDE, bad=WIDE, AB=WIDE,
                    BC=WIDE)
    else:
        f, out, algo, layers, tags = F88Z, F88Z, "basic", (), {}
    a, b = _mat(13, (3, 5), f, f), _mat(14, (5, 3), f, f)
    assert _domains(a, b, out, algo, layers, tags) == (None, None)
    got, want = _both(a, b, out, algo, layers, tags)
    _same(got, want)


def test_batched_fast_and_layered_paths_match_jax():
    a, b = _mat(15, (3, 4, 8)), _mat(16, (3, 8, 5))
    got, want = _both(a, b, OUT5, "tf", (WIDE,), TF_KW)
    _same(got, want)
    assert got.shape == (3, 4, 5)
    # an order-sensitive config falls to the layered path, batch included
    f2 = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
    a2, b2 = _mat(17, (2, 3, 4), f2, f2), _mat(18, (2, 4, 3), f2, f2)
    got2, want2 = _both(a2, b2, (f2, f2), "tf", (), {})
    _same(got2, want2)


def test_cgemv_matches_jax():
    a = _mat(19, (6, 9))
    x = _mat(20, (9,))
    for algo in ("basic", "tf"):
        want = JCG.cgemv(a, x, OUT5, algo=algo, add_formats=(WIDE,),
                         **_kw(algo))
        got = TCG.cgemv(complex_from_jax(a, "cpu"), complex_from_jax(x, "cpu"),
                        P(OUT5), algo=algo, add_formats=P((WIDE,)),
                        **{k: P(v) for k, v in _kw(algo).items()})
        _same(got, want)
        assert got.shape == (6,)
    xt = _mat(21, (6,))
    want = JCG.cgemv(a, xt, OUT5, add_formats=(WIDE,), transpose_a=True,
                     **BASIC_KW)
    got = TCG.cgemv(complex_from_jax(a, "cpu"), complex_from_jax(xt, "cpu"),
                    P(OUT5), add_formats=P((WIDE,)), transpose_a=True,
                    **{k: P(v) for k, v in BASIC_KW.items()})
    _same(got, want)


def test_per_part_layer_formats():
    a, b = _mat(22, (3, 7)), _mat(23, (7, 2))
    layers = ((qformat(20, 8), qformat(21, 8)),)
    got, want = _both(a, b, None, "basic", layers, BASIC_KW)
    _same(got, want)


def test_fast_path_preserves_wart_raws():
    """fill(int)-wart raws (outside the format's range, held in a wider
    lane) keep their value through the fast path's dots: the port narrows
    by dtype (int8 pairs on the tensor cores, anything else on int32), never
    by the format's interval (ROADMAP round-5 fix)."""
    f = qformat(3, 4)
    wide = qformat(20, 8)
    out = (qformat(22, 8), qformat(22, 8))
    tags = dict(ac=wide, bd=wide, ad=wide, bc=wide, acbd=qformat(21, 8),
                adbc=qformat(21, 8))
    A = np.full((2, 3), 300)                      # wart raw -> int16 lane
    A[1, 2] = -7
    B = np.full((3, 2), 2)
    a = JQC(jfrom_raw(A, f), jfrom_raw(np.zeros((2, 3), dtype=int), f))
    b = JQC(jfrom_raw(B, f), jfrom_raw(np.ones((3, 2), dtype=int), f))
    got, want = _both(a, b, out, "basic", (qformat(22, 8),), tags)
    _same(got, want)
    assert _domains(a, b, out, "basic", (qformat(22, 8),), tags) == \
        ("i32", "i32")
    assert complex_from_jax(a, "cpu").real.data.dtype == torch.int16
    with TCG.force_fast_off():
        ref, _ = _both(a, b, out, "basic", (qformat(22, 8),), tags)
    for g, r in ((got.real, ref.real), (got.imag, ref.imag)):
        assert g.fmt == r.fmt
        np.testing.assert_array_equal(g.raw(), r.raw())
    assert int(got.real.raw()[0, 0]) == 300 * 2 * 3


def test_limb_domain_raises():
    """Proof-lossless but wider than int32 (outputs of 49-bit pair
    storage, as in the JAX package's own wart test): the port computes in
    its limb domain, as the JAX package does, Δ=0; the batched call (the
    layered path in both packages, since its outputs are not lanes) too."""
    wide = qformat(40, 8)
    out = (qformat(40, 8), qformat(40, 8))
    tags = dict(ac=wide, bd=wide, ad=wide, bc=wide, acbd=qformat(41, 8),
                adbc=qformat(41, 8))
    a, b = _mat(24, (2, 3)), _mat(25, (3, 2))
    layers = (qformat(44, 8),)
    assert _domains(a, b, out, "basic", layers, tags) == \
        ("limb", "limb")
    batched = (_mat(26, (2, 2, 3)), _mat(27, (2, 3, 2)))
    for x, y in ((a, b), batched):
        got, want = _both(x, y, out, "basic", layers, tags)
        for g, w in ((got.real, want.real), (got.imag, want.imag)):
            assert g.is_pair and w.is_pair and g.fmt == P(w.fmt)
            np.testing.assert_array_equal(g.raw(), np.asarray(w.raw()))


def test_proof_copies_match_jax():
    """The port's copies of ``_s_mul``/``_s_addsub`` answer as the JAX
    package's over a sweep of formats and modes."""
    from qublas_tpu.ops.widths import fmt_interval as jiv
    from qublas_tpu_torch.ops.widths import fmt_interval as tiv

    fmts = [qformat(3, 4), qformat(5, 4), qformat(2, 6, signed=False),
            qformat(20, 8), qformat(4, 2, round_mode=RoundMode.RND_CONV,
                                    overflow_mode=OverflowMode.SAT_ZERO)]
    for x in fmts:
        for y in fmts:
            for to in (None, WIDE, MID):
                jx, jy = JCG._Step(jiv(x), x), JCG._Step(jiv(y), y)
                tx, ty = TCG._Step(tiv(P(x)), P(x)), TCG._Step(tiv(P(y)),
                                                               P(y))
                pairs = [(JCG._s_mul(jx, jy, to), TCG._s_mul(tx, ty, P(to)))]
                for sub in (False, True):
                    pairs.append((JCG._s_addsub(jx, jy, to, sub),
                                  TCG._s_addsub(tx, ty, P(to), sub)))
                for j, t in pairs:
                    assert (j is None) == (t is None)
                    if j is not None:
                        assert (j.iv.lo, j.iv.hi) == (t.iv.lo, t.iv.hi)
                        assert dataclasses.astuple(j.fmt) == \
                            dataclasses.astuple(t.fmt)
