"""What the ranks of ``tests/test_torch_sharding_compile.py``'s world run.

The ranks are spawned processes (``parallel.launch``): they import this
module and the port, never JAX, so this module imports nothing of either
JAX package at its top.  Each function returns plain values for the test
process to hold against the JAX side and each other.
"""

import weakref

import numpy as np
import torch

AOT = {"backend": "aot_eager"}

# graphs built by counting_backend in this process, as weak references
GRAPHS = []


def counting_backend(gm, example_inputs):
    """``aot_eager``, noting each graph it is handed."""
    GRAPHS.append(weakref.ref(gm))
    return torch._dynamo.lookup_backend("aot_eager")(gm, example_inputs)


def raising_backend(gm, example_inputs):
    raise RuntimeError("this backend refuses every graph")


def _bad_imports():
    import sys

    return [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                          "qublas_tpu")]


def both_forms(cases):
    """``run_cases`` of ``cases`` eagerly and compiled (``aot_eager``), with
    each case's collective calls and bytes: ``(eager, compiled,
    eager_stats, compiled_stats, programs_cached)``."""
    from qublas_tpu_torch.parallel import sharding as S
    from qublas_tpu_torch.parallel.dryrun import run_cases

    se, sc = [], []
    eager = run_cases(cases, "cpu", "eager", stats=se)
    compiled = run_cases(cases, "cpu", AOT, stats=sc)
    return eager, compiled, se, sc, len(S._PROGRAM_CACHE)


PERMS = {
    "ring": [(j, (j + 1) % 4) for j in range(4)],
    "butterfly 1": [(d, d ^ 1) for d in range(4)],
    "butterfly 2": [(d, d ^ 2) for d in range(4)],
    "partial": [(0, 2), (1, 3)],
    "fixed points": [(0, 0), (1, 2), (2, 1), (3, 3)],
}


def ppermute_forms():
    """Each perm of ``PERMS`` over a (1, 4) mesh, eagerly and compiled, on
    an int16 [3, 5] payload and an int64 scalar that name their rank: a
    perm each, ``(eager values, compiled values, eager stats delta,
    compiled stats delta)``."""
    import torch.distributed as dist

    from qublas_tpu_torch.parallel import collectives as C
    from qublas_tpu_torch.parallel import make_mesh
    from qublas_tpu_torch.parallel import sharding as S

    rank = dist.get_rank()
    mesh = make_mesh(1, 4, "cpu")
    aot = make_mesh(1, 4, "cpu", AOT)       # the programs' form and stats
    x = (torch.arange(15, dtype=torch.int16).reshape(3, 5) + 100 * rank + 1)
    s = torch.tensor(7 + rank, dtype=torch.int64)
    spec = torch.utils._pytree.tree_flatten((x, s))[1]
    out = {}
    for name, perm in PERMS.items():
        def move(x, s, perm=perm):
            return (C.ppermute(x, mesh, "tp", perm),
                    C.ppermute(s, mesh, "tp", perm))

        # a program as the strategies' are built, its counts recorded
        compiled = S._compile(move, spec, aot)
        b0, c0 = dict(mesh.stats), dict(aot.stats)
        eager = move(x, s)
        got = compiled(x, s)
        out[name] = ([t.numpy() for t in eager], [t.numpy() for t in got],
                     (mesh.stats["calls"] - b0["calls"],
                      mesh.stats["bytes"] - b0["bytes"]),
                     (aot.stats["calls"] - c0["calls"],
                      aot.stats["bytes"] - c0["bytes"]))
    return out


def _k_case(rng, m, out_fmt):
    from qublas_tpu_torch.qformat import qformat
    from qublas_tpu_torch.qtensor import from_raw

    fa = qformat(3, 4)
    a = from_raw(rng.randint(fa.raw_min, fa.raw_max + 1, (m, 16)), fa, "cpu")
    b = from_raw(rng.randint(fa.raw_min, fa.raw_max + 1, (16, 8)), fa, "cpu")
    wide = qformat(20, 8)
    return (a, b, out_fmt), dict(mul_to=wide, add_formats=(wide,))


def _raws(t):
    return np.asarray(t.raw(), dtype=object)


def cache_checks():
    """On a (1, 4) mesh whose programs compile through
    :func:`counting_backend`: a second call of one configuration builds no
    graph; twelve configurations of ``sharded_qgemul_k`` (twelve output
    formats) each build one graph, run compiled, with Dynamo told to fail
    rather than fall back to eager, and equal the eager mesh's result; a
    host-route configuration raises ``ValueError`` before any program is
    built; a backend that raises makes the call raise.  Returns a dict of
    what was seen."""
    from qublas_tpu_torch.parallel import make_mesh
    from qublas_tpu_torch.parallel import sharding as S
    from qublas_tpu_torch.qformat import OverflowMode, RoundMode, qformat

    counted = make_mesh(1, 4, "cpu", {"backend": counting_backend})
    eager = make_mesh(1, 4, "cpu", "eager")
    rng = np.random.RandomState(7)
    seen = {}

    args, kw = _k_case(rng, 4, qformat(3, 4))
    n0 = len(GRAPHS)
    first = S.sharded_qgemul_k(*args, counted, **kw)
    n1 = len(GRAPHS)
    again = S.sharded_qgemul_k(*args, counted, **kw)
    seen["graphs first, second call"] = (n1 - n0, len(GRAPHS) - n1)
    seen["second call equal"] = bool((_raws(first) == _raws(again)).all())

    outs = [qformat(i, f, round_mode=r, overflow_mode=o)
            for i, f in ((3, 4), (4, 3), (5, 2), (6, 4))
            for r, o in ((RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO),
                         (RoundMode.RND_CONV, OverflowMode.SAT_TCPL),
                         (RoundMode.RND_INF, OverflowMode.WRP_TCPL))]
    assert len(outs) == 12
    same = []
    n0 = len(GRAPHS)
    with torch._dynamo.config.patch(fail_on_recompile_limit_hit=True):
        for out in outs:
            args, kw = _k_case(rng, 4, out)
            got = S.sharded_qgemul_k(*args, counted, **kw)
            want = S.sharded_qgemul_k(*args, eager, **kw)
            same.append(got.fmt == want.fmt
                        and bool((_raws(got) == _raws(want)).all()))
    seen["twelve configurations: graphs"] = len(GRAPHS) - n0
    seen["twelve configurations: equal to eager"] = same

    f34 = qformat(3, 4)
    host = (S.QTensor(torch.zeros((2, 4), dtype=torch.int8), f34),
            S.QTensor(torch.zeros((4, 4), dtype=torch.int8), f34),
            qformat(600, 600))
    cached, n0 = len(S._PROGRAM_CACHE), len(GRAPHS)
    try:
        S.sharded_qgemul_mn(*host, counted)
        seen["host route"] = "returned"
    except ValueError as e:
        seen["host route"] = str(e)
    seen["host route: programs, graphs built"] = (
        len(S._PROGRAM_CACHE) - cached, len(GRAPHS) - n0)

    refusing = make_mesh(1, 4, "cpu", {"backend": raising_backend})
    args, kw = _k_case(rng, 4, f34)
    try:
        S.sharded_qgemul_k(*args, refusing, **kw)
        seen["raising backend"] = "returned"
    except Exception as e:   # Dynamo wraps the backend's error
        seen["raising backend"] = f"{type(e).__name__}: {e}"
    seen["imports"] = _bad_imports()
    return seen


def world_checks(cases):
    """Everything the test's world of 4 runs, in one record."""
    return {"forms": both_forms(cases), "ppermute": ppermute_forms(),
            "cache": cache_checks()}
