"""The port's sharded strategies as compiled per-rank programs, on the CPU.

``qublas_tpu_torch.parallel`` runs each strategy's per-rank program
eagerly or compiled (``torch.compile(fullgraph=True, dynamic=False)``),
behind ``sharding._PROGRAM_CACHE``, the counterpart of the JAX package's
``_cached`` jit sites.  One case a site: the JAX package's sixteen
``_cached`` calls (mn, k, kp, k_tree, kw, kwp, kl, klp, dp, ck_tree, cdp,
cmn, ck, qr, qrk, qrk_tree), each taken from
``tests/test_torch_sharding.py``'s cases (its numpy-seeded operands and
its helpers), run in a Gloo world of 4 ranks spawned for the module, both
eagerly and compiled with ``backend="aot_eager"``
(``parallel.dryrun.run_cases``); the results must agree Δ=0 (raws,
format, storage kind, on every rank) with each other and with the JAX
function on the virtual 8-device mesh, and each compiled call must count
the collectives and bytes its eager call counts.

In the same world (``tests/torch_sharding_ranks.py``, which the ranks
import): ``ppermute``'s traced form against its eager form on a ring, the
butterfly's two rounds, a partial perm and a perm with fixed points; a
second call of one key that builds no graph; twelve configurations of one
strategy that all run compiled; a host-route configuration refused before
any program is built; a backend that raises.  In this process: the
bounded LRU and its recency, and an eviction that releases the program's
graph.
"""

import gc
import types

import numpy as np
import pytest
import torch

import jax

import test_torch_sharding as TS
from qublas_tpu_torch.parallel import sharding as S

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the virtual 8-device mesh")

WORLD_TIMEOUT = 300.0

# the JAX package's _cached sites, each by a case of test_torch_sharding
SITES = {
    "mn": "mn canonical dp2 tp2",
    "k": "k reduce-scatter lut dp2",
    "kp": "k pipelined tp4",
    "k_tree": "k_tree pow2, butterfly auto",
    "kw": "k_wide pair out, reduce-scatter",
    "kwp": "k_wide pipelined, pair out",
    "kl": "k_limb limb operand, lane out, reduce-scatter",
    "klp": "k_limb pipelined, limb out",
    "dp": "dp batched lhs, shared rhs",
    "ck_tree": "cgemul_k_tree tf k=40 (q>1)",
    "cdp": "cgemul_dp",
    "cmn": "cgemul_mn order-sensitive TF",
    "ck": "cgemul_k basic, reduce-scatter",
    "qr": "qreduce batch, odd reduce length",
    "qrk": "qreduce_k pair regime, lane values",
    "qrk_tree": "qreduce_k_tree n=64, butterfly auto",
}
BY_ID = {cs[0]: cs for cs in TS.CASES}
ORDER = list(SITES)


def _port_cases():
    out = []
    for site in ORDER:
        _, world, fn, shape, args, kw, raises = BY_ID[SITES[site]]
        assert world == 4 and not raises, site
        out.append((fn, shape, TS.to_port(args), TS.to_port(kw)))
    return out


@pytest.fixture(scope="module")
def world():
    """The world's record (``torch_sharding_ranks.world_checks`` on each
    rank) and the JAX side of each site, computed while the world runs."""
    from qublas_tpu_torch.parallel.launch import start_world
    from torch_sharding_ranks import world_checks

    w = start_world(4, "gloo", world_checks, (_port_cases(),),
                    timeout=WORLD_TIMEOUT)
    try:
        jax_side = {site: TS._run_jax(*BY_ID[SITES[site]][2:6])
                    for site in ORDER}
        ranks = w.join()
    finally:
        w.stop()
    return ranks, jax_side


def _norm(res):
    status, val, *_ = res
    return (status, TS.norm(val)) if status == "ok" else (status, val)


@pytest.mark.parametrize("site", ORDER)
def test_compiled_site_matches_eager_and_jax(world, site):
    ranks, jax_side = world
    i = ORDER.index(site)
    want = jax_side[site]
    assert want[0] == "ok", f"{site}: JAX raised {want[2]}"
    assert len(ranks) == 4
    for r, rec in enumerate(ranks):
        eager, compiled, se, sc, _ = rec["forms"]
        assert _norm(compiled[i]) == want, f"{site}: rank {r} compiled != JAX"
        assert _norm(eager[i]) == want, f"{site}: rank {r} eager != JAX"
        assert sc[i] == se[i] and se[i][0] > 0, \
            f"{site}: rank {r} counts {sc[i]} compiled, {se[i]} eager"


def test_every_site_has_a_program():
    """One cached program a site on every rank, none for the eager runs,
    and the sixteen sites are the strategies of the JAX package's
    ``_cached`` calls."""
    import inspect

    from qublas_tpu.parallel import sharding as J

    src = inspect.getsource(J)
    jax_keys = {line.split('(("', 1)[1].split('"', 1)[0]
                for line in src.splitlines() if "_cached((" in line}
    assert jax_keys == set(SITES)
    port_src = inspect.getsource(S)
    port_keys = {line.split('_program(("', 1)[1].split('"', 1)[0]
                 for line in port_src.splitlines() if '_program(("' in line}
    assert port_keys == set(SITES)


def test_program_count(world):
    ranks, _ = world
    for r, rec in enumerate(ranks):
        assert rec["forms"][4] == len(SITES), r


@pytest.mark.parametrize("name", list(("ring", "butterfly 1", "butterfly 2",
                                       "partial", "fixed points")))
def test_ppermute_traced_equals_eager(world, name):
    """The traced ppermute (``permute_tensor`` of the payload's bytes, or
    ``all_to_all_single`` for a partial perm) gives each rank what the
    eager form gives it: the value of the rank that sends to it, zeros
    where nothing arrives, and counts the same calls and bytes."""
    from torch_sharding_ranks import PERMS

    ranks, _ = world
    perm = PERMS[name]
    for r, rec in enumerate(ranks):
        eager, got, se, sc = rec["ppermute"][name]
        src = [s for s, d in perm if d == r]
        sent = payload(src[0]) if src else [np.zeros_like(e) for e in eager]
        for e, g, w in zip(eager, got, sent):
            assert e.dtype == g.dtype == w.dtype, (name, r)
            assert np.array_equal(e, w), (name, r, "eager")
            assert np.array_equal(g, w), (name, r, "compiled")
        assert se == sc, (name, r, se, sc)


def payload(rank):
    """What ``ppermute_forms`` sends from ``rank``."""
    return [np.arange(15, dtype=np.int16).reshape(3, 5) + 100 * rank + 1,
            np.asarray(7 + rank, dtype=np.int64)]


def test_second_call_builds_no_graph(world):
    ranks, _ = world
    for rec in ranks:
        assert rec["cache"]["graphs first, second call"] == (1, 0)
        assert rec["cache"]["second call equal"]


def test_twelve_configurations_all_run_compiled(world):
    """Twelve configurations of ``sharded_qgemul_k``, Dynamo told to fail
    at its recompile limit: each builds its one graph (a program with a
    code object of its own), none runs eagerly, each equals eager."""
    ranks, _ = world
    for rec in ranks:
        assert rec["cache"]["twelve configurations: graphs"] == 12
        assert rec["cache"]["twelve configurations: equal to eager"] == \
            [True] * 12


def test_host_route_refused_before_compiling(world):
    ranks, _ = world
    for rec in ranks:
        msg = rec["cache"]["host route"]
        assert msg == S._HOST_MSG.format(who="sharded_qgemul_mn"), msg
        assert rec["cache"]["host route: programs, graphs built"] == (0, 0)


def test_raising_backend_raises(world):
    ranks, _ = world
    for rec in ranks:
        assert "this backend refuses every graph" in \
            rec["cache"]["raising backend"]
        assert rec["cache"]["imports"] == []


def test_host_route_raises_as_jax_does():
    """The JAX package refuses the same host-route configuration with a
    ValueError."""
    cid = "mn host-route output"
    _, _, fn, shape, args, kw, raises = BY_ID[cid]
    assert raises
    got = TS._run_jax(fn, shape, args, kw)
    assert got[0] == "raise" and got[1] == ["ValueError"]


def test_programs_default_by_device():
    """A mesh's programs: Inductor on the card, eager on the CPU, unless
    the caller names a form; only torch.compile's backend and mode."""
    from qublas_tpu_torch.parallel.collectives import _programs

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert _programs(None, cuda) == (("backend", "inductor"),)
    assert _programs(None, cpu) is None
    assert _programs("eager", cuda) is None
    assert _programs({"mode": "reduce-overhead", "backend": "inductor"},
                     cpu) == (("backend", "inductor"),
                              ("mode", "reduce-overhead"))
    with pytest.raises(ValueError, match="backend and mode"):
        _programs({"backend": "inductor", "fullgraph": False}, cuda)


# ---------------------------------------------------------------------------
# the LRU, in this process (tests/test_review_r3.py's for the JAX cache)
# ---------------------------------------------------------------------------

def test_program_cache_bounded(monkeypatch):
    monkeypatch.setattr(S, "_PROGRAM_CACHE", S._LRU(8))
    for i in range(100):
        S._cached(("shape", i), lambda i=i: ("program", i))
    assert len(S._PROGRAM_CACHE) <= 8
    assert S._PROGRAM_CACHE.get(("shape", 99)) == ("program", 99)
    assert S._PROGRAM_CACHE.get(("shape", 0)) is None
    assert S._PROGRAM_CACHE.max_items == 8
    assert S._LRU(512).max_items == 512


def test_program_cache_lru_recency(monkeypatch):
    monkeypatch.setattr(S, "_PROGRAM_CACHE", S._LRU(4))
    for i in range(4):
        S._cached(i, lambda i=i: f"p{i}")
    # touch 0 -> most recent; two more keys evict 1 and 2
    assert S._cached(0, lambda: "rebuilt") == "p0"
    S._cached(4, lambda: "p4")
    S._cached(5, lambda: "p5")
    assert S._PROGRAM_CACHE.get(0) == "p0"
    assert S._PROGRAM_CACHE.get(1) is None
    assert S._PROGRAM_CACHE.get(2) is None
    # a key is frozen: lists and dicts hash as tuples
    assert S._cached([6, {"a": [1]}], lambda: "p6") == \
        S._cached((6, (("a", (1,)),)), lambda: "other")


def test_eviction_releases_the_compiled_program(monkeypatch):
    """A program evicted from the cache drops its Dynamo cache entry: the
    graph its backend was handed is freed."""
    from torch_sharding_ranks import GRAPHS, counting_backend

    from qublas_tpu_torch.qformat import qformat
    from qublas_tpu_torch.qtensor import from_raw

    monkeypatch.setattr(S, "_PROGRAM_CACHE", S._LRU(1, S._Program.release))
    f = qformat(4, 4)
    x = from_raw(np.arange(8) - 4, f, "cpu")
    leaves, spec = torch.utils._pytree.tree_flatten((x,))

    def block(t):
        return S.ew.qadd(t, t, to=qformat(5, 4))

    # a mesh's programs and stats are all a program reads of it
    mesh = types.SimpleNamespace(programs=(("backend", counting_backend),),
                                 stats={"calls": 0, "bytes": 0})
    n0 = len(GRAPHS)
    prog = S._cached("first", lambda: S._compile(block, spec, mesh))
    assert prog(*leaves).raw().tolist() == [2 * v for v in range(-4, 4)]
    assert len(GRAPHS) == n0 + 1
    ref = GRAPHS[-1]
    assert ref() is not None
    S._cached("second", lambda: "another program")     # evicts "first"
    del prog
    gc.collect()
    assert ref() is None
