"""The port's copy of ``tests/test_fuzz_differential.py``, complex and
sharded: random complex multiplies (basic and TF, random step tags, lane
and pair parts), random complex GEMMs, and M/N-sharded GEMMs, on the CPU,
each trial held bit for bit to the port's ``hostops`` and to the JAX
package on the same raws.  The sharded trials run in one Gloo world of 2
ranks spawned for the module (``parallel.launch.start_world``, mesh
(1, 2)), each against the port's single-device call and the JAX package's
sharded call on its virtual mesh.  Same trial counts (``depthctl``) and
seeds as the JAX file.
"""

import numpy as np
import pytest

import depthctl
import jax as _jax
from torch_fuzz_gen import Gen, flat, jfmt, jq, same_fmt

import qublas_tpu.complex as jcx
import qublas_tpu.ops.cgemm as jcg
from qublas_tpu_torch import hostops
from qublas_tpu_torch.complex import cmul, cmul_tf, complex_from_raw
from qublas_tpu_torch.ops.cgemm import cgemul

SHARDED_TRIALS = depthctl.trials(6, 3)
WORLD_TIMEOUT = 240.0


def ccpu(re, im, fr, fi):
    return complex_from_raw(re, im, fr, fi, device="cpu")


def cjax(re, im, fr, fi):
    return jcx.QComplexTensor(jq(re, fr), jq(im, fi))


def _tags(g, names, some_fmt):
    return {n: (some_fmt() if g.rng.randint(0, 2) else None) for n in names}


TF = ("ab", "cd", "ba", "abc", "cdb", "bad", "AB", "BC")
BASIC = ("ac", "bd", "ad", "bc", "acbd", "adbc")


def _check_cmul(g, fr, fi, algo, kw, n):
    ar, ai = g.raws(fr, n), g.raws(fi, n)
    br, bi = g.raws(fr, n), g.raws(fi, n)
    fn = cmul_tf if algo == "tf" else cmul
    jfn = jcx.cmul_tf if algo == "tf" else jcx.cmul
    dev = fn(ccpu(ar, ai, fr, fi), ccpu(br, bi, fr, fi), **kw)
    jax = jfn(cjax(ar, ai, fr, fi), cjax(br, bi, fr, fi),
              **{k: jfmt(v) for k, v in kw.items()})
    host_fn = (hostops.complex_mul_tf if algo == "tf"
               else hostops.complex_mul_basic)
    for i in range(n):
        hp = host_fn(((int(ar[i]), fr), (int(ai[i]), fi)),
                     ((int(br[i]), fr), (int(bi[i]), fi)), **kw)
        assert flat(dev.real)[i] == hp[0][0] == flat(jax.real)[i], \
            (algo, fr, fi, kw, i)
        assert flat(dev.imag)[i] == hp[1][0] == flat(jax.imag)[i], \
            (algo, fr, fi, kw, i)
    assert same_fmt(dev.real.fmt, jax.real.fmt)
    assert same_fmt(dev.imag.fmt, jax.imag.fmt)


@pytest.mark.parametrize("trial", range(depthctl.trials(16, 8)))
def test_fuzz_complex_mul(trial):
    g = Gen("test_fuzz_complex_mul", trial)
    fr, fi = g.fmt(14), g.fmt(14)
    algo = "tf" if g.rng.randint(0, 2) else "basic"
    kw = _tags(g, TF if algo == "tf" else BASIC, lambda: g.fmt(18))
    _check_cmul(g, fr, fi, algo, kw, 12)


@pytest.mark.parametrize("trial", range(depthctl.trials(10, 5)))
def test_fuzz_cgemul(trial):
    g = Gen("test_fuzz_cgemul", trial)
    fr, fi = g.fmt(10), g.fmt(10)
    out = (g.fmt(16), g.fmt(16))
    layers = tuple(g.fmt(20) for _ in range(g.rng.randint(0, 3)))
    m, k, n = (int(g.rng.randint(1, 4)) for _ in range(3))
    A = (g.raws(fr, m * k).reshape(m, k), g.raws(fi, m * k).reshape(m, k))
    B = (g.raws(fr, k * n).reshape(k, n), g.raws(fi, k * n).reshape(k, n))
    dev = cgemul(ccpu(*A, fr, fi), ccpu(*B, fr, fi), out, algo="basic",
                 add_formats=layers)
    jax = jcg.cgemul(cjax(*A, fr, fi), cjax(*B, fr, fi),
                     tuple(jfmt(f) for f in out), algo="basic",
                     add_formats=tuple(jfmt(f) for f in layers))
    ar = [[((int(A[0][i, p]), fr), (int(A[1][i, p]), fi)) for p in range(k)]
          for i in range(m)]
    br = [[((int(B[0][p, j]), fr), (int(B[1][p, j]), fi)) for j in range(n)]
          for p in range(k)]
    host = hostops.cgemul(ar, br, out, algo="basic", add_formats=layers)
    want_re = [host[i][j][0][0] for i in range(m) for j in range(n)]
    want_im = [host[i][j][1][0] for i in range(m) for j in range(n)]
    assert flat(dev.real) == want_re == flat(jax.real), (fr, fi, out, layers)
    assert flat(dev.imag) == want_im == flat(jax.imag), (fr, fi, out, layers)


@pytest.mark.parametrize("trial", range(depthctl.trials(16, 6)))
def test_fuzz_wide_complex_mul(trial):
    """Complex multiplies whose parts and step formats land on the
    33..64-bit pair-storage routes."""
    g = Gen("test_fuzz_wide_complex_mul", trial)

    def some_fmt():
        return g.wide_fmt() if g.rng.randint(0, 2) else g.fmt(14)

    fr, fi = some_fmt(), some_fmt()
    algo = "tf" if g.rng.randint(0, 2) else "basic"
    kw = _tags(g, TF if algo == "tf" else BASIC, some_fmt)
    _check_cmul(g, fr, fi, algo, kw, 8)


def _sharded_cases():
    """(raws and formats) of each sharded trial, as the JAX test draws
    them; None where the JAX test skips (a host-path format)."""
    from qublas_tpu_torch.qtensor import from_raw

    cases = []
    for trial in range(SHARDED_TRIALS):
        g = Gen("test_fuzz_sharded_mn", trial)
        fa, fb = g.fmt(12), g.fmt(12)
        out = g.fmt(14)
        layers = tuple(g.fmt(18) for _ in range(g.rng.randint(0, 2)))
        m, k, n = 4, int(g.rng.randint(1, 6)), 8
        A = g.raws(fa, m * k).reshape(m, k)
        B = g.raws(fb, k * n).reshape(k, n)
        host = from_raw(A, fa, device="cpu").is_host \
            or from_raw(B, fb, device="cpu").is_host
        cases.append(None if host else (A, B, fa, fb, out, layers))
    return cases


def sharded_rank(cases):
    """One rank: each case's sharded_qgemul_mn on mesh (1, 2), its raws
    and format."""
    from qublas_tpu_torch.parallel import make_mesh, sharded_qgemul_mn
    from qublas_tpu_torch.qtensor import from_raw

    mesh = make_mesh(1, 2, "cpu")
    res = []
    for c in cases:
        if c is None:
            res.append(None)
            continue
        A, B, fa, fb, out, layers = c
        got = sharded_qgemul_mn(from_raw(A, fa, device="cpu"),
                                from_raw(B, fb, device="cpu"), out, mesh,
                                add_formats=layers)
        res.append((flat(got), got.fmt))
    return res


@pytest.fixture(scope="module")
def sharded_world():
    from qublas_tpu_torch.parallel.launch import start_world

    world = start_world(2, "gloo", sharded_rank, (_sharded_cases(),),
                        WORLD_TIMEOUT)
    return world.join()


@pytest.mark.skipif(len(_jax.devices()) < 8,
                    reason="needs the virtual 8-device mesh")
@pytest.mark.parametrize("trial", range(SHARDED_TRIALS))
def test_fuzz_sharded_mn(trial, sharded_world):
    """M/N sharding is bit-exact for any (order-sensitive too)
    configuration: each output's whole tree runs on one rank."""
    from qublas_tpu.parallel import make_mesh, sharded_qgemul_mn
    from qublas_tpu_torch.ops.gemm import qgemul
    from qublas_tpu_torch.qtensor import from_raw

    case = _sharded_cases()[trial]
    if case is None:
        pytest.skip("host-path formats don't shard")
    A, B, fa, fb, out, layers = case
    ref = qgemul(from_raw(A, fa, device="cpu"), from_raw(B, fb, device="cpu"),
                 out, add_formats=layers)
    jax = sharded_qgemul_mn(jq(A, fa), jq(B, fb), jfmt(out),
                            make_mesh(dp=2, tp=4),
                            add_formats=tuple(jfmt(f) for f in layers))
    for rank in sharded_world:
        raws, fmt = rank[trial]
        assert raws == flat(ref) == flat(jax), (fa, fb, out, layers)
        assert fmt == ref.fmt and same_fmt(fmt, jax.fmt)
