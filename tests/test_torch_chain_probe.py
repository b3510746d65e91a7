"""P1, the tree GEMM's per-product probe, against the JAX package, Δ=0.

``chain_probe``'s plain version (the port's ``tree_gemm._product`` and
``_merge`` in a loop on one tile, the tile written ``programs`` times)
against the same loop of the JAX package's ``tree_gemm._product`` and
``_merge`` (the body of ``bench.py:_measured_chain_prods``'s Pallas
kernel), for the canonical plan (split product route) and an i32-route
plan.  The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Here, without the card: ``p1_plan``, which picks the instantiation with
the product's and layer 0's steps compiled in, swept over modes and steps
and held to the C table that K2′ shares (``csrc/plan_steps.cuh``); the
launch geometry (``P1_CHAINS``, ``P1_THREADS``) held to
``csrc/chain_probe.cuh``; and the kernel's indexing replayed in torch from
that geometry (which element, program and chain each thread takes, the
vector and scalar paths), which must equal the plain version with every
output written once.
"""

import itertools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu.ops import tree_gemm as JT
from qublas_tpu.qformat import OverflowMode, RoundMode, mul_merge, qformat
from qublas_tpu_torch.convert import port_format as P
from qublas_tpu_torch.ops import chain_probe as CP
from qublas_tpu_torch.ops import tree_gemm as TT

PLANS = {
    "canonical": qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO),
    "i32": qformat(3, 4, round_mode=RoundMode.RND_CONV,
                   overflow_mode=OverflowMode.WRP_TCPL),
    "i32-sat": qformat(4, 3, round_mode=RoundMode.RND_INF,
                       overflow_mode=OverflowMode.SAT_TCPL),
}


def _plans(name):
    f = PLANS[name]
    jplan = JT.plan_tree(f, f, mul_merge(f, f), (), 256, f)
    tplan = TT.plan_tree(P(f), P(f), P(mul_merge(f, f)), (), 256, P(f))
    return f, jplan, tplan


def _tile(f, seed, shape=(16, 32)):
    rng = np.random.RandomState(seed)
    return (rng.randint(f.raw_min, f.raw_max + 1, shape).astype(np.int32),
            rng.randint(f.raw_min, f.raw_max + 1, shape).astype(np.int32))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plain_matches_jax_chain(name):
    f, jplan, tplan = _plans(name)
    assert jplan.prod_route == tplan.prod_route == \
        ("split" if name == "canonical" else "i32")
    x, y = _tile(f, 3)
    v, yv = jnp.asarray(x), jnp.asarray(y)
    for _ in range(8):
        p = JT._product(jplan, v, yv)
        v = JT._merge(jplan, 0, p, p)
    got = CP.chain_probe_plain(torch.from_numpy(x), torch.from_numpy(y),
                               tplan, 8, 3)
    assert got.shape == (3, 16, 32) and got.dtype == torch.int32
    for g in range(3):
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(v))


@pytest.mark.parametrize("steps", [0, 1, 5])
def test_wrapper_on_cpu_is_the_plain_version(steps):
    f, _, tplan = _plans("i32")
    x, y = (torch.from_numpy(t) for t in _tile(f, steps, (4, 8)))
    CP.chain_probe.launches = 0
    got = CP.chain_probe(x.to(torch.int8), y.to(torch.int16), tplan, steps,
                         2)
    want = CP.chain_probe_plain(x, y, tplan, steps, 2)
    assert torch.equal(got, want) and CP.chain_probe.launches == 0
    if steps == 0:
        assert torch.equal(got[1], x)


def test_wrapper_validates_and_measurement_needs_the_card():
    f, _, tplan = _plans("canonical")
    x = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        CP.chain_probe(x, x[:2], tplan, 1, 1)
    with pytest.raises(TypeError, match="int8/int16/int32"):
        CP.chain_probe(x.float(), x, tplan, 1, 1)
    with pytest.raises(ValueError, match=">= 0"):
        CP.chain_probe(x, x, tplan, -1, 1)
    with pytest.raises(ValueError, match="times the card"):
        CP.measured_chain_prods(P(f), tplan, "cpu")
    assert (CP.BM, CP.BN, CP.G, CP.T1, CP.T2) == (128, 256, 2048, 128, 16)


# ---- P1's instantiations and its kernel's indexing ----------------------

CSRC = pathlib.Path(CP.__file__).parent.parent / "csrc"
F88Z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
I32F = qt.qformat(3, 4, round_mode=qt.RoundMode.RND_CONV,
                  overflow_mode=qt.OverflowMode.WRP_TCPL)
CANON = (qt.RoundMode.TRN_TCPL, qt.OverflowMode.SAT_ZERO)

# (operand format, product format): the canonical step, a product shift
# of 10, a wider product, an unsigned product, the i32 product route
_STEPS = {"canonical": ((8, 8), (8, 8, True)), "shift": ((8, 9), (8, 8, True)),
          "width": ((8, 8), (9, 8, True)), "unsigned": ((8, 8), (8, 8, False)),
          "i32 route": ((3, 4), (8, 8, True))}


def _table_entry(params, e):
    """Whether the kernel parameters' product route, product step and
    layer-0 merge step are the table entry e's."""
    route, prod, merge = e
    return params[0] == route and tuple(params[2:7]) == prod \
        and tuple(params[8:13]) == merge


@pytest.mark.parametrize("rm,om", list(itertools.product(qt.RoundMode,
                                                         qt.OverflowMode)))
@pytest.mark.parametrize("where", ["product", "layer 0", "upper levels"])
def test_p1_plan_specialises_only_the_steps_p1_reads(rm, om, where):
    """p1_plan returns a compiled entry only when the product route, the
    product's step and layer 0's merge step (shift, modes, width,
    signedness) are the entry's: the (round, overflow) pair is swept in
    the product, in every layer, or in the layers above 0, which P1 never
    reads (and which keep K2′ on its run-time plan)."""
    out = qt.qformat(6, 2, round_mode=qt.RoundMode.RND_INF)
    for step, ((ib, fb), (mi, mf, signed)) in _STEPS.items():
        fmt = qt.qformat(ib, fb, round_mode=qt.RoundMode.RND_ZERO)
        canon = qt.qformat(mi, mf, signed, *CANON)
        swept = qt.qformat(mi, mf, signed, rm, om)
        mul, layers = {"product": (swept, (canon,)),
                       "layer 0": (canon, (swept,)),
                       "upper levels": (canon, (canon, swept))}[where]
        for k in (1, 32, 100):
            plan = TT.plan_tree(fmt, fmt, mul, layers, k, out)
            assert plan is not None
            params = list(TT._kernel_params(plan, out, 0))
            want = next((i + 1 for i, e in enumerate(TT.K2S_PLANS)
                         if _table_entry(params, e)), 0)
            compiled = step == "canonical" and \
                ((rm, om) == CANON or where == "upper levels")
            assert want == (1 if compiled else 0), (step, k)
            assert CP.p1_plan(plan) == want, (step, k, rm, om, where)
            if where == "upper levels" and (rm, om) != CANON and k > 1:
                assert TT.k2s_plan(plan) == 0


def _c_plans():
    """plan_steps.cuh's K2S_PLANS after its run-time entry, as
    ops.tree_gemm.K2S_PLANS writes them."""
    src = (CSRC / "plan_steps.cuh").read_text()
    body = re.search(r"K2S_PLANS\[\]\[11\] = \{(.*?)\};", src, re.S).group(1)
    rows = [[x.strip() for x in r.split(",")]
            for r in re.findall(r"\{([^{}]*)\}", body)]
    assert rows[0] == ["ANY"] * 11

    def value(x, enum):
        return int(x) if x.lstrip("-").isdigit() else int(enum[x])

    table = []
    for r in rows[1:]:
        # the route by its name in csrc/tree_gemm.cuh's Route enum
        step = [TT.ROUTES[r[0].removeprefix("ROUTE_").lower()]] + [
            (value(r[c], qt.RoundMode) if c in (2, 7) else
             value(r[c], qt.OverflowMode) if c in (3, 8) else int(r[c]))
            for c in range(1, 11)]
        table.append((step[0], tuple(step[1:6]), tuple(step[6:11])))
    return tuple(table)


def test_p1_and_k2s_pickers_follow_the_kernel_table():
    """The C table that K2′ and P1 share (csrc/plan_steps.cuh) is
    ops.tree_gemm.K2S_PLANS, and a plan built from each entry's steps takes
    that entry in both pickers."""
    table = _c_plans()
    assert table == TT.K2S_PLANS
    for i, (route, prod, merge) in enumerate(table):
        d, rnd, ovf, w, sgn = prod
        assert merge[0] == 0 and merge[1:] == prod[1:]
        # operands Qu<w-1-d, d>: products at 2d fraction bits, shifted by d
        # into the step's format; every merge adds two values of it
        fmt = qt.qformat(w - 1 - d, d)
        mul = qt.qformat(w - 1 - d, d, bool(sgn), qt.RoundMode(rnd),
                         qt.OverflowMode(ovf))
        for k in (1, 100, 4112):
            plan = TT.plan_tree(fmt, fmt, mul, (), k, mul)
            assert TT.ROUTES[plan.prod_route] == route
            assert CP.p1_plan(plan) == TT.k2s_plan(plan) == i + 1


def test_p1_shapes_match_the_kernel_source():
    """P1_CHAINS and P1_THREADS are csrc/chain_probe.cuh's, one for plan
    index 0 and for each entry of the table."""
    src = (CSRC / "chain_probe.cuh").read_text()

    def ints(name):
        body = re.search(name + r"\[\] = \{([^}]*)\};", src).group(1)
        return tuple(int(x) for x in body.split(","))

    assert ints("P1_CHAINS") == CP.P1_CHAINS
    assert ints("P1_THREADS") == CP.P1_THREADS
    assert len(CP.P1_CHAINS) == len(TT.K2S_PLANS) + 1
    assert all(c in (1, 2) or c % 4 == 0 for c in CP.P1_CHAINS)


def _replay(x, y, plan, steps, programs, instance, aligned, fault=None):
    """P1's kernel on the CPU, from its launch geometry: thread t of block
    b owns the chains of the P1_CHAINS flat outputs from (b P1_THREADS + t)
    P1_CHAINS, output i being element i % elems of program i / elems; on
    the vector path (elems a multiple of the chains, ``aligned`` bases) a
    thread's chains are neighbours in one program, else each chain reads
    its own element and one past the end repeats the thread's first and is
    not stored.  Every output must be written exactly once.  ``fault``
    breaks the geometry on purpose (test_p1_replay_catches_a_wrong_geometry).
    """
    chains, threads = CP.P1_CHAINS[instance], CP.P1_THREADS[instance]
    elems = x.numel()
    total = elems * programs
    out = torch.full((total,), -(1 << 30), dtype=torch.int32)
    writes = torch.zeros(total, dtype=torch.int64)
    if total:
        blocks = -(-total // (threads * chains))
        if fault == "last block dropped":
            blocks = total // (threads * chains)
        stride = chains - 1 if fault == "threads overlap" else chains
        first = torch.arange(blocks * threads, dtype=torch.int64) * stride
        first = first[first < total]                    # threads that return
        idx = first[:, None] + torch.arange(chains)     # [threads, chains]
        vec = elems % chains == 0 and aligned or \
            fault == "vector path on a ragged tile"
        if vec:
            e = ((first % elems)[:, None] + torch.arange(chains)) % elems
            assert bool((idx < total).all())
        else:
            e = torch.where(idx < total, idx, first[:, None]) % elems
        v = x.reshape(-1).to(torch.int32)[e]
        yv = y.reshape(-1).to(torch.int32)[e]
        for _ in range(steps):
            p = TT._product(plan, v, yv)
            v = TT._merge(plan, 0, p, p)
        live = idx < total
        out[idx[live]] = v[live]
        writes.index_add_(0, idx[live], torch.ones_like(idx[live]))
    assert bool((writes == 1).all())
    return out.view((programs,) + tuple(x.shape))


def _growing(shape, seed):
    """A tile whose canonical chains grow by under 1% a step: x raws in
    [100, 2000], y in [129, 131] (about 1.01 in Qu<8,8>), so that they are
    still not 0 after T = 128 steps and a lost or repeated step shows."""
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(100, 2001, shape).astype(np.int32)),
            torch.from_numpy(rng.randint(129, 132, shape).astype(np.int32)))


@pytest.mark.parametrize("name,instance", [("canonical", 1),
                                           ("canonical", 0), ("i32", 0)])
@pytest.mark.parametrize("shape,programs,aligned", [
    ((16, 32), 3, True),      # the vector path, one partial block
    ((13, 7), 5, True),       # elems not a multiple of 4 or 2
    ((16, 33), 9, True),      # programs x elems not a multiple of a block
    ((16, 32), 3, False),     # a base off 16 bytes
    ((128, 8), 2, True),      # exactly one block of 256 x 4 chains
    ((16, 32), 0, True)])     # no programs
def test_p1_replay_of_the_kernel_indexing_equals_plain(name, instance, shape,
                                                       programs, aligned):
    f = F88Z if name == "canonical" else I32F
    plan = TT.plan_tree(f, f, qt.mul_merge(f, f), (), 256, f)
    assert CP.p1_plan(plan) == (1 if name == "canonical" else 0)
    if name == "canonical":
        x, y = _growing(shape, programs)
    else:
        x, y = (torch.from_numpy(t) for t in _tile(f, programs, shape))
    got = _replay(x, y, plan, 5, programs, instance, aligned)
    want = CP.chain_probe_plain(x, y, plan, 5, programs)
    assert got.shape == want.shape and torch.equal(got, want)
    if programs:
        assert bool((want[0] != 0).all()) or name != "canonical"
        assert not torch.equal(want, CP.chain_probe_plain(x, y, plan, 4,
                                                          programs))


@pytest.mark.parametrize("fault", ["last block dropped", "threads overlap",
                                   "vector path on a ragged tile"])
def test_p1_replay_catches_a_wrong_geometry(fault):
    """The replay's checks fail when the geometry loses a chain, writes one
    twice or reads a neighbour of another program."""
    f = F88Z
    plan = TT.plan_tree(f, f, qt.mul_merge(f, f), (), 256, f)
    x, y = _growing((13, 7), 0)
    want = CP.chain_probe_plain(x, y, plan, 3, 5)
    with pytest.raises(AssertionError):
        got = _replay(x, y, plan, 3, 5, 1, True, fault)
        assert torch.equal(got, want)


def test_p1_growing_tile_keeps_its_chains_alive():
    """The card tests' tile for 'every step runs': after T = 128 canonical
    steps no chain is 0 and most differ from T = 127."""
    f = F88Z
    plan = TT.plan_tree(f, f, qt.mul_merge(f, f), (), 2048, f)
    x, y = _growing((16, 32), 0)
    a = CP.chain_probe_plain(x, y, plan, 128, 1)[0]
    b = CP.chain_probe_plain(x, y, plan, 127, 1)[0]
    assert bool((a != 0).all()) and (a != b).float().mean() > 0.9
