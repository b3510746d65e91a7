"""The port's device ops as one traced program: ``torch.compile(fullgraph=
True, dynamic=False)`` and ``torch.func.vmap`` against the JAX package's
``jax.jit``/``jax.vmap`` (Δ=0), the ``qublas::`` custom ops under
``torch.library.opcheck``, the pytrees, host storage refused, and one
Inductor build of the lane requantize chain against eager.

Each JAX site that jits or vmaps the package's ops has a case here, named
by its test: the same raws, made from a numpy seed, go through the JAX
function jitted (or vmapped) and the port's function compiled (or
vmapped), and the raws must agree bit for bit, and with the port's eager
call.  Compiles use ``backend="aot_eager"``: Dynamo's graph, lowered
through AOT autograd, run by eager kernels (the port's custom ops among
them).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import entry
from qublas_tpu import bitwise as jbitwise
from qublas_tpu.ops import elementwise as jew
from qublas_tpu.ops import gemm as jgemm
from qublas_tpu.ops.reduce import qreduce as jqreduce
from qublas_tpu.qformat import OverflowMode, RoundMode, qformat
from qublas_tpu.qtensor import QTensor as JQ
from qublas_tpu.qtensor import from_raw as jfrom_raw
import qublas_tpu_torch as qt
from qublas_tpu_torch import bitwise as tbitwise
from qublas_tpu_torch.convert import port_format as P
from qublas_tpu_torch.ops import elementwise as tew
from qublas_tpu_torch.ops import gemm as tgemm
from qublas_tpu_torch.ops import library
from qublas_tpu_torch.ops import tree_gemm as TG
from qublas_tpu_torch.ops.chain_probe import chain_probe
from qublas_tpu_torch.ops.limbint import LimbArray
from qublas_tpu_torch.ops.wideint import requantize_i32, requantize_i64
from qublas_tpu_torch.qtensor import QTensor as TQ


@pytest.fixture(autouse=True)
def _fresh_dynamo():
    # every case compiles closures of the same code objects: start each
    # from an empty cache, so that no case meets the recompile limit
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def compiled(fn):
    return torch.compile(fn, fullgraph=True, dynamic=False,
                         backend="aot_eager")


def raws(fmt, shape, seed):
    """Raws of ``fmt`` over its storage range from ``RandomState(seed)``:
    one draw each up to 62 bits, else composed from 32-bit draws."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    if fmt.storage_bits <= 62:
        return rng.randint(fmt.raw_min, fmt.raw_max + 1, n,
                           dtype=np.int64).reshape(shape)
    span = fmt.raw_max - fmt.raw_min + 1
    draws = -(-fmt.storage_bits // 32) + 1
    out = []
    for _ in range(n):
        v = 0
        for _w in range(draws):
            v = (v << 32) | int(rng.randint(0, 1 << 32, dtype=np.int64))
        out.append(fmt.raw_min + v % span)
    return np.array(out, dtype=object).reshape(shape)


def both(fmt, shape, seed):
    """The same raws as a JAX QTensor and a port QTensor on the CPU."""
    r = raws(fmt, shape, seed)
    return jfrom_raw(r, fmt), qt.from_raw(r, P(fmt), "cpu")


def ints(x):
    """Raws of a QTensor of either package, or of a raw tensor, as an
    object array of Python ints."""
    if hasattr(x, "raw"):
        x = x.raw()
    elif isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, dtype=object).astype(object)


def same(got, want):
    if hasattr(got, "fmt") and hasattr(want, "fmt"):
        assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    g, w = ints(got), ints(want)
    assert g.shape == w.shape
    assert [int(v) for v in g.reshape(-1)] == [int(v) for v in w.reshape(-1)]


F44 = qformat(4, 4)
F88 = qformat(8, 8)
F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
F40 = qformat(30, 9)
HYB_LAYERS = (qformat(8, 8), qformat(9, 8), qformat(10, 8), qformat(11, 8),
              qformat(6, 4, overflow_mode=OverflowMode.SAT_ZERO))


def _lanes():
    # tests/test_jit_compat.py:28
    to = qformat(5, 3)
    ja, ta = both(F44, (64,), 1)
    jb, tb = both(F44, (64,), 2)
    return (lambda x, y: jew.qadd(jew.qmul(x, y), x, to=to),
            lambda x, y: tew.qadd(tew.qmul(x, y), x, to=P(to)),
            (ja, jb), (ta, tb))


def _gemm_reduce():
    # tests/test_jit_compat.py:46
    ja, ta = both(F88Z, (4, 6), 3)
    jb, tb = both(F88Z, (6, 4), 4)
    lay = qformat(10, 6)

    def jf(a, b):
        c = jgemm.qgemul(a, b, F88Z)
        return c, jqreduce(c, (lay,))

    def tf(a, b):
        c = tgemm.qgemul(a, b, P(F88Z))
        return c, qt.qreduce(c, (P(lay),))
    return jf, tf, (ja, jb), (ta, tb)


def _vmap_lanes():
    # tests/test_jit_compat.py:66, under vmap
    ja, ta = both(F44, (3, 16), 5)
    jb, tb = both(F44, (3, 16), 6)
    return (lambda x, y: jew.qmul(x, y), lambda x, y: tew.qmul(x, y),
            (ja, jb), (ta, tb))


def _qneg_pytree():
    # tests/test_jit_compat.py:74: a QTensor in, a QTensor out
    ja, ta = both(F44, (8,), 7)
    return jew.qneg, tew.qneg, (ja,), (ta,)


def _hybrid():
    # tests/test_jit_compat.py:111: the hybrid tier
    fa, mul_to, out = qformat(3, 4), qformat(7, 8), qformat(5, 4)
    ja, ta = both(fa, (4, 32), 8)
    jb, tb = both(fa, (32, 4), 9)
    return (lambda a, b: jgemm.qgemul(a, b, out, mul_to=mul_to,
                                      add_formats=HYB_LAYERS),
            lambda a, b: tgemm.qgemul(a, b, P(out), mul_to=P(mul_to),
                                      add_formats=tuple(map(P, HYB_LAYERS))),
            (ja, jb), (ta, tb))


def _pair_qadd(shape):
    # tests/test_pair_storage.py:220 (jit) and :231 (vmap)
    to = qformat(44, 12)
    ja, ta = both(F40, shape, 10)
    jb, tb = both(F40, shape, 11)
    return (lambda x, y: jew.qadd(x, y, to=to),
            lambda x, y: tew.qadd(x, y, to=P(to)), (ja, jb), (ta, tb))


def _binary(fa, fb, to, n, op, seeds):
    ja, ta = both(fa, (n,), seeds[0])
    jb, tb = both(fb, (n,), seeds[1])
    return (lambda x, y: getattr(jew, op)(x, y, to=to),
            lambda x, y: getattr(tew, op)(x, y, to=P(to)),
            (ja, jb), (ta, tb))


def _pair_qxor():
    # tests/test_bitwise.py:80: a pair and an int32 lane
    ja, ta = both(F40, (8,), 12)
    jb, tb = both(qformat(15, 10), (8,), 13)
    return jbitwise.qxor, tbitwise.qxor, (ja, jb), (ta, tb)


def _gemm_case(fa, fb, out, shape, seeds, **kw):
    m, k, n = shape
    ja, ta = both(fa, (m, k), seeds[0])
    jb, tb = both(fb, (k, n), seeds[1])
    tkw = {key: (tuple(map(P, v)) if isinstance(v, tuple) else P(v))
           for key, v in kw.items()}
    return (lambda a, b: jgemm.qgemul(a, b, out, **kw),
            lambda a, b: tgemm.qgemul(a, b, P(out), **tkw),
            (ja, jb), (ta, tb))


CASES = {
    "jit_compat-elementwise_chain": _lanes,
    "jit_compat-gemm_and_reduce": _gemm_reduce,
    "jit_compat-vmap_elementwise": _vmap_lanes,
    "jit_compat-qtensor_pytree": _qneg_pytree,
    "jit_compat-hybrid_gemm": _hybrid,
    "pair_storage-jit": lambda: _pair_qadd((32,)),
    "pair_storage-vmap": lambda: _pair_qadd((4, 8)),
    "limbint-qmul": lambda: _binary(qformat(80, 40), qformat(70, 20),
                                    qformat(90, 30), 8, "qmul", (14, 15)),
    "limb384-qmul": lambda: _binary(qformat(200, 100), qformat(10, 4),
                                    qformat(210, 80), 16, "qmul", (16, 17)),
    "limb992-qadd": lambda: _binary(
        qformat(312, 199), qformat(312, 199),
        qformat(320, 199, overflow_mode=OverflowMode.SAT_ZERO), 8, "qadd",
        (18, 19)),
    "limb_div-qdiv": lambda: _binary(qformat(60, 40), qformat(50, 30),
                                     qformat(70, 20), 16, "qdiv", (20, 21)),
    "pair_div-qdiv": lambda: _binary(F40, F40, qformat(33, 4), 16, "qdiv",
                                     (22, 23)),
    "bitwise-qxor": _pair_qxor,
    "elementwise_device-qmul": lambda: _binary(
        F88, F88, qformat(6, 4, True, RoundMode.RND_CONV,
                          OverflowMode.SAT_ZERO), 64, "qmul", (24, 25)),
    "stream_gemm": lambda: _gemm_case(F40, F40, qformat(33, 9), (3, 48, 3),
                                      (26, 27)),
    "fast_gemm_wide": lambda: _gemm_case(
        F40, F88, qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO),
        (2, 16, 2), (28, 29), mul_to=qformat(40, 17),
        add_formats=(qformat(45, 17),)),
    "fast_gemm_limb": lambda: _gemm_case(
        qformat(25, 15), qformat(25, 15),
        qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL), (2, 16, 2),
        (30, 31), mul_to=qformat(51, 30), add_formats=(qformat(57, 30),)),
}
VMAP = {"jit_compat-vmap_elementwise", "pair_storage-vmap"}


@pytest.fixture
def streaming(name):
    """The streaming tier forced in both packages for its case, its wide
    tier off, as ``tests/test_stream_gemm.py``'s ``force_stream`` does."""
    if name != "stream_gemm":
        yield
        return
    with jgemm.stream_gate(0), jgemm.force_tiers_off("wide"), \
            tgemm.stream_gate(0), tgemm.force_tiers_off("wide"):
        yield


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_matches_jax(name, streaming):
    jfn, tfn, jargs, targs = CASES[name]()
    if name in VMAP:
        want = jax.vmap(jfn)(*jargs)
        got = torch.func.vmap(tfn)(*targs)
    else:
        want = jax.jit(jfn)(*jargs)
        got = compiled(tfn)(*targs)
    eager = tfn(*targs)
    flat_w = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(
        x, JQ))
    flat_g = torch.utils._pytree.tree_leaves(got, is_leaf=lambda x:
                                             isinstance(x, TQ))
    flat_e = torch.utils._pytree.tree_leaves(eager, is_leaf=lambda x:
                                             isinstance(x, TQ))
    assert len(flat_g) == len(flat_w) == len(flat_e)
    for g, w, e in zip(flat_g, flat_w, flat_e):
        assert isinstance(g, TQ)
        same(g, w)
        same(g, e)


def test_streaming_case_takes_the_stream():
    """The stream_gemm case reaches the streaming tier in the port: the
    layered path is not called under the forced gate."""
    calls = []
    real = tgemm._stream_gemm_wide

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out

    _, tfn, _, targs = CASES["stream_gemm"]()
    with tgemm.stream_gate(0), tgemm.force_tiers_off("wide"):
        tgemm._stream_gemm_wide = spy
        try:
            tfn(*targs)
        finally:
            tgemm._stream_gemm_wide = real
    assert calls == [True]


def test_pipeline_compiled_matches_jax_entry():
    """``QuantPipeline.forward`` compiled against ``jax.jit(entry()[0])``
    at (m, k, n) = (128, 256, 128): two K1 ops, the ROM and the cast."""
    forward = entry()[0]
    fa = qformat(3, 4)
    x = raws(fa, (128, 256), 40).astype(np.int8)
    w1 = raws(fa, (256, 128), 41).astype(np.int8)
    w2 = raws(fa, (128, 128), 42).astype(np.int8)
    want = np.asarray(jax.jit(forward)(x, w1, w2))
    pipe = qt.QuantPipeline.from_numpy(w1, w2, "cpu")
    got = compiled(pipe)(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pipe(torch.from_numpy(x)).numpy(), want)


def _graph_ops(fn, *args):
    """The ``qublas::`` ops in the graph of ``fn`` compiled, and its
    output."""
    seen = set()

    def backend(gm, example_inputs):
        seen.update(str(n.target) for n in gm.graph.nodes
                    if str(n.target).startswith("qublas."))
        return gm.forward

    out = torch.compile(fn, fullgraph=True, dynamic=False,
                        backend=backend)(*args)
    return seen, out


def test_every_kernel_is_a_node_of_the_graph():
    """Each path of the slice reaches its kernels as custom-op nodes of one
    graph: the pipeline (K1), the canonical tree with qreduce and a direct
    K2′ call (K2, K3, K2′), the hybrid tier in int8 and int16 lanes (both
    K2h kernels), config 5's four int8 dots, the lossless tier on int16
    lanes (K1's int32 instantiation) and P1."""
    f88z = P(F88Z)
    rng = np.random.RandomState(43)
    fa = P(qformat(3, 4))
    w1, w2 = (rng.randint(-128, 128, (64, 64)).astype(np.int8)
              for _ in range(2))
    pipe = qt.QuantPipeline.from_numpy(w1, w2, "cpu")
    x = torch.from_numpy(rng.randint(-128, 128, (16, 64)).astype(np.int8))
    ops, got = _graph_ops(pipe, x)
    assert ops == {"qublas.fused_gemm_s8"}
    assert torch.equal(got, pipe(x))

    a = qt.from_raw(raws(F88Z, (8, 64), 44), f88z, "cpu")
    b = qt.from_raw(raws(F88Z, (64, 8), 45), f88z, "cpu")
    plan = TG.plan_tree(f88z, f88z, f88z, (), 64, f88z)

    def canonical(a, b):
        c = qt.qgemul(a, b, f88z)
        return (c, qt.qreduce(c, (P(qformat(10, 6)),), axis=1),
                TG.tree_gemm_stream(a.data, b.data, plan, f88z))
    ops, got = _graph_ops(canonical, a, b)
    assert ops == {"qublas.tree_gemm", "qublas.qreduce",
                   "qublas.tree_gemm_stream"}
    for g, e in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(canonical(a, b))):
        assert torch.equal(g, e)

    layers = tuple(map(P, HYB_LAYERS))
    ha = qt.from_raw(raws(qformat(3, 4), (4, 32), 46), fa, "cpu")
    hb = qt.from_raw(raws(qformat(3, 4), (32, 4), 47), fa, "cpu")

    def hybrid(a, b):
        return qt.qgemul(a, b, P(qformat(5, 4)), mul_to=P(qformat(7, 8)),
                         add_formats=layers)
    for la, lb in ((torch.int8, torch.int8), (torch.int16, torch.int16),
                   (torch.int16, torch.int8), (torch.int32, torch.int32)):
        wa, wb = TQ(ha.data.to(la), fa), TQ(hb.data.to(lb), fa)
        ops, got = _graph_ops(hybrid, wa, wb)
        assert ops == {"qublas.tree_gemm_hybrid_mma"}
        same(got, hybrid(ha, hb))

    f34, wide, mid = P(qformat(3, 4)), P(qformat(20, 8)), P(qformat(5, 4))
    c = qt.complex_from_raw(rng.randint(-128, 128, (4, 6)),
                            rng.randint(-128, 128, (4, 6)), f34,
                            device="cpu")
    d = qt.complex_from_raw(rng.randint(-128, 128, (6, 3)),
                            rng.randint(-128, 128, (6, 3)), f34,
                            device="cpu")

    def cg(c, d):
        return qt.cgemul(c, d, f34, algo="tf", add_formats=(wide,), ab=mid,
                         cd=mid, ba=mid, abc=wide, cdb=wide, bad=wide,
                         AB=wide, BC=wide)
    ops, got = _graph_ops(cg, c, d)
    assert ops == {"qublas.fused_gemm_s8"}
    ref = cg(c, d)
    same(got.real, ref.real)
    same(got.imag, ref.imag)

    # the lossless tier on int16 lanes: K1's int32 instantiation
    wa = TQ(x.to(torch.int16), fa)
    wb = TQ(torch.from_numpy(w1).to(torch.int16), fa)

    def k1_s32(a, b):
        return qt.qgemul(a, b, mid, mul_to=wide, add_formats=(wide,))
    ops, got = _graph_ops(k1_s32, wa, wb)
    assert ops == {"qublas.fused_gemm_s32"}
    same(got, k1_s32(wa, wb))

    xt, yt = a.data[:, :8].contiguous(), b.data[:8].contiguous()
    ops, got = _graph_ops(lambda x, y: chain_probe(x, y, plan, 5, 3), xt, yt)
    assert ops == {"qublas.chain_probe"}
    assert torch.equal(got, chain_probe(xt, yt, plan, 5, 3))


def _op_cases():
    """Each custom op with arguments at a small size, on CPU tensors."""
    rng = np.random.RandomState(48)

    def lane(shape, lo=-100, hi=100, dtype=torch.int8):
        return torch.from_numpy(rng.randint(lo, hi, shape)).to(dtype)

    f88z = P(F88Z)
    rq = [4, int(RoundMode.RND_CONV), int(OverflowMode.SAT_ZERO), 8, 1]
    plan = TG.plan_tree(f88z, f88z, f88z, (), 24, f88z)
    a32, b32 = lane((5, 24), dtype=torch.int32), lane((24, 7),
                                                        dtype=torch.int32)
    k2 = list(TG._kernel_params(plan, f88z, TG.K2_LOG_BLK))
    k2s = list(TG._kernel_params(plan, f88z, 0))
    fa = P(qformat(3, 4))
    hp = TG.plan_hybrid(fa, fa, P(qformat(7, 8)), tuple(map(P, HYB_LAYERS)),
                        32, P(qformat(5, 4)))
    k2h = list(TG._hybrid_params(hp, 32, P(qformat(5, 4))))
    red = qt.ops.reduce.plan_reduce(P(F44), (P(qformat(5, 3)),), 13)
    x3 = lane((3, 13, 2), -128, 128)
    cp = TG.plan_tree(f88z, f88z, f88z, (), 2, f88z)
    return {
        "fused_gemm_s8": (lane((5, 24)), lane((24, 7)), rq, 1),
        "fused_gemm_s8-int_dot": (lane((5, 24)), lane((24, 7)), [], 4),
        "fused_gemm_s8-lut": (lane((5, 24)), lane((24, 7)), rq, 2,
                              lane((256,), -2 ** 15, 2 ** 15, torch.int32)),
        "fused_gemm_s32": (a32, b32.to(torch.int16), rq, 1),
        "tree_gemm": (a32, b32, k2, 0, 4),
        "tree_gemm_stream": (a32, b32, k2s, 1, 4),
        "tree_gemm_hybrid_mma": (lane((3, 32), -64, 64),
                                 lane((32, 5), -64, 64), k2h, 1, 1),
        "tree_gemm_hybrid_mma-digits2": (
            lane((3, 32), -32768, 32768, torch.int16),
            lane((32, 5), -32768, 32768, torch.int16), k2h, 1, 1),
        "tree_gemm_hybrid_mma-digits4": (
            lane((3, 32), -2 ** 31, 2 ** 31, torch.int32),
            lane((32, 5), -64, 64), k2h, 0, 1),
        "qreduce": (x3, 1, list(red.kernel_params()), red.tails, red.modes,
                    1),
        "chain_probe": (lane((4, 8), dtype=torch.int32),
                        lane((4, 8), dtype=torch.int32),
                        list(TG._kernel_params(cp, cp.final_fmt, 0)), 3, 2,
                        0),
        "chain_probe-no_steps": (lane((4, 8), dtype=torch.int32),
                                 lane((4, 8), dtype=torch.int32),
                                 list(TG._kernel_params(cp, cp.final_fmt,
                                                        0)), 0, 1, 0),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_opcheck(case):
    """``torch.library.opcheck`` on each ``qublas::`` op: schema, fake
    (shape and dtype only, dynamic sizes included), no aliasing, AOT
    dispatch."""
    args = _op_cases()[case]
    op = getattr(torch.ops.qublas, case.split("-")[0])
    torch.library.opcheck(op, args)


def test_every_entry_point_has_an_op():
    """One custom op for each C entry point of ``_build._SIGNATURES``."""
    from qublas_tpu_torch import _build

    names = {op._schema.name.split("::")[1] for op in library.OPS}
    assert {"qk_" + n for n in names} == set(_build._SIGNATURES)
    assert {c.split("-")[0] for c in _op_cases()} == names


def test_ops_read_plans_as_their_kernels_do():
    """The CPU implementations read their plans back from the kernels'
    parameters: a hybrid and a tree plan through the ops equal the plain
    versions on the original plans, in every mode pair of the tail."""
    fa = P(qformat(3, 4))
    rng = np.random.RandomState(49)
    a = torch.from_numpy(rng.randint(-128, 128, (3, 48))).to(torch.int8)
    b = torch.from_numpy(rng.randint(-128, 128, (48, 4))).to(torch.int8)
    for rm in RoundMode:
        for om in OverflowMode:
            out = P(qformat(5, 4, True, rm, om))
            lay = tuple(map(P, HYB_LAYERS[:-1])) + (
                P(qformat(6, 4, True, rm, om)),)
            hp = TG.plan_hybrid(fa, fa, P(qformat(7, 8)), lay, 48, out)
            assert torch.equal(TG.tree_gemm_hybrid(a, b, hp, out),
                               TG.tree_gemm_hybrid_plain(a, b, hp, out))
            tp = TG.plan_tree(fa, fa, P(qformat(7, 8)), lay, 48, out)
            assert torch.equal(TG.tree_gemm(a, b, tp, out),
                               TG.tree_gemm_plain(a, b, tp, out))


def test_pytrees():
    """QTensor, LimbArray and QComplexTensor are pytree nodes: the storage
    is the leaf (a LimbArray's with its element axes first), the format the
    context; ``tree_map`` rebuilds them."""
    flat, spec = torch.utils._pytree.tree_flatten(
        qt.random_fill((2, 3), P(qformat(70, 10)), device="cpu"))
    assert len(flat) == 1 and flat[0].shape == (2, 3, 3)
    limb = qt.random_fill((2, 3), P(qformat(70, 10)), device="cpu")
    back = torch.utils._pytree.tree_map(lambda t: t.clone(), limb)
    assert isinstance(back.data, LimbArray) and back.fmt == limb.fmt
    assert back.raw_list() == limb.raw_list()
    c = qt.complex_from_raw([[1, -2]], [[3, 4]], P(F88), device="cpu")
    leaves = torch.utils._pytree.tree_leaves(c)
    assert len(leaves) == 2
    neg = torch.utils._pytree.tree_map(torch.neg, c)
    assert neg.real.raw_list() == [-1, 2] and neg.imag.raw_list() == [-3, -4]


def test_qtable_placement():
    """A placed QTable looks its entries up where they lie, with no copy,
    and entries passed in (a module's buffer) give the same lookup."""
    fa = P(qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO))
    tt = qt.QTable(qt.sqrt_func, fa)
    assert tt.to("cpu") is tt and tt._table_on(torch.device("cpu")) is \
        tt.table
    x = qt.from_raw(raws(qformat(3, 4), (4, 8), 53), fa, "cpu")
    same(tt(x, tt.table.clone()), tt(x))
    pipe = qt.QuantPipeline.from_numpy(np.zeros((8, 8), np.int8),
                                       np.zeros((8, 8), np.int8), "cpu")
    assert "rom" not in pipe.state_dict()
    assert torch.equal(pipe.rom, pipe.table.table)


def test_vmap_limb_qadd():
    """``torch.func.vmap`` of ``qadd`` over limb QTensors maps their first
    element axis, and equals the unmapped call."""
    fa, to = qformat(70, 10), qformat(80, 12)
    a = qt.from_raw(raws(fa, (4, 8), 50), P(fa), "cpu")
    b = qt.from_raw(raws(fa, (4, 8), 51), P(fa), "cpu")
    got = torch.func.vmap(lambda x, y: tew.qadd(x, y, to=P(to)))(a, b)
    assert got.is_limb and got.shape == (4, 8)
    same(got, tew.qadd(a, b, to=P(to)))
    ja, jb = jfrom_raw(raws(fa, (4, 8), 50), fa), jfrom_raw(
        raws(fa, (4, 8), 51), fa)
    same(got, jax.jit(lambda x, y: jew.qadd(x, y, to=to))(ja, jb))


def test_host_storage_is_not_compiled():
    """A host-storage op refuses to compile (and to vmap), as the JAX
    package's refuses to jit: no silent eager fallback."""
    h = qt.from_raw(np.array([1 << 700, 3], dtype=object),
                    P(qformat(600, 600)), "cpu")
    assert h.is_host
    with pytest.raises(torch._dynamo.exc.Unsupported):
        compiled(tew.qneg)(h)
    with pytest.raises(ValueError):
        torch.func.vmap(tew.qneg)(h)


def _int_chain(x32, x64, x8, x16):
    """Requantizes in every round mode and every overflow mode at shift
    counts up to and past the word, int8 and int16 products that wrap, and
    ``//`` and ``%`` on negatives, as one program."""
    outs = []
    steps = [(rm, OverflowMode.SAT_TCPL, 8, True) for rm in RoundMode]
    steps += [(RoundMode.TRN_TCPL, om, w, signed) for om in OverflowMode
              for w, signed in ((8, True), (17, False), (32, True))]
    for rm, om, w, signed in steps:
        f = qt.QFormat(w - 1, 0, signed, rm, om)
        trunc = rm in (RoundMode.TRN_TCPL, RoundMode.TRN_SMGN)
        for d in (-32, -3, 0, 7, 31) + ((32, 40) if trunc else ()):
            outs.append(requantize_i32(x32, d, f))
        f = qt.QFormat(44, 0, signed, rm, om)
        for d in (-64, 5, 64, 70):
            outs.append(requantize_i64(x64, d, f))
    outs += [x8 * x8, x16 * x16, x8 * 3 + x8, x32 // 7, x32 % 7,
             x32 // -5, x32 % -5, x64 // 11, x64 % -11]
    return outs


def test_inductor_integer_semantics(tmp_path, monkeypatch):
    """The lane requantize chain built by Inductor's CPU backend equals
    eager bit for bit, in every round mode and every overflow mode (the
    lane and the 64-bit requantize), at shift counts
    at and past the word (int32 and int64), with wrapping int8/int16
    products and floor division and remainder of negatives."""
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path))
    rng = np.random.RandomState(52)
    edge32 = [0, 1, -1, 2**31 - 1, -2**31, 2**30, -2**30, 12345, -12345]
    edge64 = [0, 1, -1, 2**63 - 1, -2**63, 2**62, -2**40, 987654321]
    x32 = torch.tensor(edge32 + list(rng.randint(-2**31, 2**31, 55)),
                       dtype=torch.int32)
    x64 = torch.tensor(edge64 + [int(v) << 20 for v in
                                 rng.randint(-2**40, 2**40, 56)],
                       dtype=torch.int64)
    x8 = torch.from_numpy(rng.randint(-128, 128, 64)).to(torch.int8)
    x16 = torch.from_numpy(rng.randint(-2**15, 2**15, 64)).to(torch.int16)
    want = _int_chain(x32, x64, x8, x16)
    got = torch.compile(_int_chain, fullgraph=True, dynamic=False,
                        backend="inductor")(x32, x64, x8, x16)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
