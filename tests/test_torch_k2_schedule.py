"""K2's and K2′'s schedules and instantiation choices, checked on the CPU.

The tiled K2 kernel (``csrc/tree_gemm_tiled.cu``) cannot
run here, so its schedule is replayed in torch from the int32 parameter
array the kernel receives (``ops.tree_gemm._kernel_params`` with
``K2_LOG_BLK``), as ``tests/test_torch_reduce.py`` replays K3's: k in
slices of 16 products, each product folded in as a binary-carry count
(one merge per trailing one-bit of its index in the slice), a full slice's
value pushed onto the slot stack, a ragged last slice left in levels 0-3,
then the drain (levels below 4 read from the slice's partials) and the
final requantize.  The replay must equal ``tree_gemm_plain`` (held to the
JAX package by ``tests/test_torch_tree_gemm.py``).  ``k2_modes``, which
picks the compiled (round, overflow) instantiation, is swept over plans.

K2′ (``csrc/tree_gemm_stream.cuh``) is replayed the same way from its
parameters (``log_blk`` 0): k in slices of ``2**K2S_LOG_S`` products, each
product pushed onto one stack over every tree level (its trailing one-bits
within the slice, and for the slice's last product the slice index's, are
its carries), then the drain reading ``slot[l]`` at level l.  It must equal
``tree_gemm_stream_plain`` and K2's replay.  ``k2s_plan``, which picks the
instantiation with the whole requantize steps compiled in, is swept over
mode pairs, shifts and widths and held to the C table.
"""

import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch.ops import tree_gemm as TT
from qublas_tpu_torch.ops.wideint import (mul_wide, requantize_i32,
                                          requantize_i64,
                                          requantize_split_mul)

F88Z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
LAYERS = (qt.qformat(9, 6, round_mode=qt.RoundMode.RND_CONV),
          qt.qformat(10, 4))
I32F = qt.qformat(3, 4, round_mode=qt.RoundMode.RND_CONV,
                  overflow_mode=qt.OverflowMode.WRP_TCPL)
# 25-bit lanes: 50-bit products, the 64-bit "pair" product route
PAIRF = qt.qformat(12, 12, overflow_mode=qt.OverflowMode.SAT_ZERO)


def _raws(seed, fmt, shape):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape).astype(np.int32))


def _rq_fmt(r):
    """A format whose requantize from frac ``d`` is ``r``'s step."""
    d, rnd, ovf, w, sgn = r
    return d, qt.QFormat(w - 1, 0, bool(sgn), qt.RoundMode(rnd),
                         qt.OverflowMode(ovf))


def _steps(params):
    """The kernels' parameter array (route, log_blk, prod[5], levels,
    merge[levels][5], ndrain, (op, level)[ndrain], fin[5]) as log_blk and
    the functions product(x, y), merge(l, left, right), drain(level),
    which runs the drain ops over level(l), and the final requantize."""
    p = list(params)
    route, log_blk = p[0], p[1]
    levels = p[7]
    merges = [p[8 + 5 * l:13 + 5 * l] for l in range(levels)]
    q = 8 + 5 * levels
    nd = p[q]
    drain_ops = [(p[q + 1 + 2 * s], p[q + 2 + 2 * s]) for s in range(nd)]
    fin = p[q + 1 + 2 * nd:q + 6 + 2 * nd]

    def rq(v, r):
        return requantize_i32(v, *_rq_fmt(r))

    def product(x, y):
        d, fmt = _rq_fmt(p[2:7])
        if route == TT.ROUTES["split"]:
            return requantize_split_mul(x, y, d, fmt)
        if route == TT.ROUTES["pair"]:
            return requantize_i64(mul_wide(x, y), d, fmt).to(torch.int32)
        return requantize_i32(x * y, d, fmt)

    def merge(l, left, right):
        return rq(left + right, merges[l])

    def drain(level):
        carry = None
        for op, l in drain_ops:
            if op == 1:
                carry = rq(carry, merges[l])
            elif op == 0:
                carry = level(l)
            else:
                carry = merge(l, level(l), carry)
        return rq(carry, fin)

    return log_blk, product, merge, drain


def _replay_k2(a, b, params):
    """K2's schedule over ``a`` [M, K] @ ``b`` [K, N] from its parameters."""
    log_blk, product, merge, drain = _steps(params)
    blk = 1 << log_blk
    k = a.shape[1]
    part, slots, t = {}, {}, 0
    for k0 in range(0, k, blk):
        cnt = min(blk, k - k0)
        for qq in range(cnt):
            v = product(a[:, k0 + qq, None], b[None, k0 + qq, :])
            ones = 0
            while qq & (1 << ones):   # one carry per trailing one-bit
                v = merge(ones, part.pop(ones), v)
                ones += 1
            if qq == blk - 1:         # a full slice: push its value
                j = 0
                while t & (1 << j):
                    v = merge(log_blk + j, slots.pop(j), v)
                    j += 1
                slots[j] = v
            else:
                part[ones] = v
        if cnt == blk:
            t += 1

    return drain(lambda l: part[l] if l < log_blk else slots[l - log_blk])


def _case(fmt, layers, k, seed=0, m=5, n=7):
    a = _raws(seed, fmt, (m, k))
    b = _raws(seed + 1, fmt, (k, n))
    plan = TT.plan_tree(fmt, fmt, qt.mul_merge(fmt, fmt), layers, k, fmt)
    assert plan is not None
    return a, b, plan


@pytest.mark.parametrize("k", [1, 2, 13, 16, 17, 48, 1000])
@pytest.mark.parametrize("config", ["canonical", "layered", "i32", "pair"])
def test_k2_schedule_matches_plain(k, config):
    fmt, layers = {"canonical": (F88Z, ()), "layered": (F88Z, LAYERS),
                   "i32": (I32F, ()), "pair": (PAIRF, ())}[config]
    a, b, plan = _case(fmt, layers, k, seed=k)
    want = TT.tree_gemm_plain(a, b, plan, fmt)
    params = TT._kernel_params(plan, fmt, TT.K2_LOG_BLK)
    got = _replay_k2(a, b, params).to(want.dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("level,k", [(0, 17), (2, 13), (3, 1000),
                                     (5, 1000)])
def test_k2_schedule_replay_sees_a_wrong_merge(level, k):
    """Mutation check of the replay: one merge's shift changed in the
    parameters (0 -> 1) changes the result, so the replay reads every level
    it is given: levels 0-3 inside a slice or its ragged tail, 4 and up on
    the stack and in the drain.  Small raws keep the sums clear of
    SAT::ZERO, which would hide the change."""
    fmt = qt.qformat(3, 4)
    a, b, plan = _case(fmt, (), k, seed=3, m=16, n=16)
    want = TT.tree_gemm_plain(a, b, plan, fmt)
    params = list(TT._kernel_params(plan, fmt, TT.K2_LOG_BLK))
    d = 8 + 5 * level
    assert params[d] == 0 and level < plan.levels
    params[d] = 1
    got = _replay_k2(a, b, params).to(want.dtype)
    assert not torch.equal(got, want)


def test_k2_parameters_carry_its_block_size():
    _, _, plan = _case(F88Z, (), 48)
    assert TT._kernel_params(plan, F88Z, TT.K2_LOG_BLK)[1] == 4
    assert TT.K2_LOG_BLK == 4


_ROUNDS = (qt.RoundMode.TRN_TCPL, qt.RoundMode.RND_CONV)
_OVFS = (qt.OverflowMode.SAT_ZERO, qt.OverflowMode.SAT_TCPL,
         qt.OverflowMode.WRP_TCPL)


@pytest.mark.parametrize("rm,om", list(itertools.product(_ROUNDS, _OVFS)))
@pytest.mark.parametrize("layer", ["none", "same", "other-round",
                                   "other-ovf"])
def test_k2_modes_specialises_only_shared_pairs(rm, om, layer):
    """k2_modes returns a compiled pair only when the product and every
    merge share it; the operand format's own modes do not matter."""
    fmt = qt.qformat(4, 4, round_mode=qt.RoundMode.RND_ZERO)
    mul = qt.qformat(8, 8, round_mode=rm, overflow_mode=om)
    layers = {
        "none": (),
        "same": (qt.qformat(9, 8, round_mode=rm, overflow_mode=om),),
        "other-round": (qt.qformat(9, 8, round_mode=qt.RoundMode.RND_INF,
                                   overflow_mode=om),),
        "other-ovf": (qt.qformat(9, 8, round_mode=rm,
                                 overflow_mode=qt.OverflowMode.SAT_SMGN),),
    }[layer]
    out = qt.qformat(6, 2, round_mode=qt.RoundMode.RND_INF)
    for k in (1, 16, 100):
        plan = TT.plan_tree(fmt, fmt, mul, layers, k, out)
        assert plan is not None
        steps = (plan.mul_fmt,) + plan.merge_fmts
        shared = {(f.round_mode, f.overflow_mode) for f in steps}
        want = 2 * TT.K2_MODES.index(shared.pop()) + 1 \
            if len(shared) == 1 and shared <= set(TT.K2_MODES) else 0
        if layer in ("none", "same") and \
                (rm, om) == (qt.RoundMode.TRN_TCPL, qt.OverflowMode.SAT_ZERO):
            assert want == 1
        assert TT.k2_modes(plan) == want, (k, layer, rm, om)


def test_canonical_plan_takes_the_compiled_modes():
    _, _, plan = _case(F88Z, (), 2048)
    assert TT.k2_modes(plan) == 1
    _, _, plan = _case(F88Z, LAYERS, 128)
    assert TT.k2_modes(plan) == 0
    _, _, plan = _case(PAIRF, (), 100)     # the same modes, 64-bit products
    assert plan.prod_route == "pair" and TT.k2_modes(plan) == 2


def test_k2_modes_match_the_kernel_source():
    """csrc/tree_gemm_tiled.cuh's K2_MODES: the run-time entry, then for
    each pair of ops.tree_gemm.K2_MODES its int32 routes and its 64-bit
    product route, as k2_modes numbers them."""
    src = (pathlib.Path(TT.__file__).parent.parent / "csrc" /
           "tree_gemm_tiled.cuh").read_text()
    body = re.search(r"K2_MODES\[\]\[3\] = \{(.*?)\};", src, re.S).group(1)
    rows = [[x.strip() for x in r.split(",")]
            for r in re.findall(r"\{([^{}]*)\}", body)]
    assert rows[0] == ["ANY"] * 3
    want = []
    for rm, om in TT.K2_MODES:
        want += [[rm.name, om.name, "INT32_ROUTES"],
                 [rm.name, om.name, "ROUTE_PAIR"]]
    assert rows[1:] == want


# ---------------------------------------------------------------------------
# K2′: the one-pass schedule of csrc/tree_gemm_stream.cuh
# ---------------------------------------------------------------------------

def _trailing_ones(x):
    n = 0
    while x & (1 << n):
        n += 1
    return n


def _replay_k2s(a, b, params, log_s=TT.K2S_LOG_S):
    """K2′'s kernel over ``a`` [M, K] @ ``b`` [K, N] from its parameters:
    slices of 2^log_s products, one stack over every level, the drain
    reading slot[l]."""
    log_blk, product, merge, drain = _steps(params)
    assert log_blk == 0
    s_len = 1 << log_s
    k = a.shape[1]
    slot = {}
    for s in range(-(-k // s_len)):
        cnt = min(s_len, k - s * s_len)      # a ragged last slice stops
        for q in range(cnt):                 # unrolled in the kernel
            kk = s * s_len + q
            v = product(a[:, kk, None], b[None, kk, :])
            ones = _trailing_ones(q)         # compile-time carries
            for l in range(ones):
                v = merge(l, slot[l], v)
            if ones == log_s:                # the slice's last product
                up = _trailing_ones(s)       # read at run time
                for l in range(log_s, log_s + up):
                    v = merge(l, slot[l], v)
                slot[log_s + up] = v
            else:
                slot[ones] = v
    return drain(lambda l: slot[l])


_K2S_KS = [1, 2, 13, 16, 17, 31, 32, 33, 48, 1000, 2048]


@pytest.mark.parametrize("k", _K2S_KS)
@pytest.mark.parametrize("config", ["canonical", "layered", "i32", "pair"])
def test_k2s_schedule_matches_plain_and_k2(k, config):
    fmt, layers = {"canonical": (F88Z, ()), "layered": (F88Z, LAYERS),
                   "i32": (I32F, ()), "pair": (PAIRF, ())}[config]
    a, b, plan = _case(fmt, layers, k, seed=k + 5, m=4, n=6)
    want = TT.tree_gemm_stream_plain(a, b, plan, fmt)
    got = _replay_k2s(a, b, TT._kernel_params(plan, fmt, 0)).to(want.dtype)
    assert torch.equal(got, want)
    k2 = _replay_k2(a, b, TT._kernel_params(plan, fmt, TT.K2_LOG_BLK))
    assert torch.equal(got, k2.to(want.dtype))


@pytest.mark.parametrize("log_s", [4, 5])
@pytest.mark.parametrize("k", [31, 100, 1000])
def test_k2s_slice_length_does_not_change_the_result(log_s, k):
    """Slices of 16 (the variant kernel_sweeps times) and of 32 products
    give the same stack."""
    a, b, plan = _case(F88Z, (), k, seed=k, m=3, n=5)
    got = _replay_k2s(a, b, TT._kernel_params(plan, F88Z, 0), log_s)
    assert torch.equal(got.to(torch.int32),
                       TT.tree_gemm_stream_plain(a, b, plan, F88Z))


@pytest.mark.parametrize("level,k", [(0, 17), (3, 13), (4, 1000), (5, 1000),
                                     (7, 1000), (9, 1000)])
def test_k2s_schedule_replay_sees_a_wrong_merge(level, k):
    """Mutation check of the replay: one merge's shift changed in the
    parameters (0 -> 1) changes the result, inside a slice (levels below
    5), at the slice's end carries (5 and up) and in the drain.  Small raws
    keep the sums clear of saturation, which would hide the change."""
    fmt = qt.qformat(3, 4)
    a, b, plan = _case(fmt, (), k, seed=3, m=16, n=16)
    want = TT.tree_gemm_stream_plain(a, b, plan, fmt)
    params = list(TT._kernel_params(plan, fmt, 0))
    d = 8 + 5 * level
    assert params[d] == 0 and level < plan.levels
    params[d] = 1
    got = _replay_k2s(a, b, params).to(want.dtype)
    assert not torch.equal(got, want)


# (operand format, product format): the canonical step, a product shift
# of 10, a wider product, an unsigned product, the i32 product route
_STEPS = {"canonical": ((8, 8), (8, 8, True)), "shift": ((8, 9), (8, 8, True)),
          "width": ((8, 8), (9, 8, True)), "unsigned": ((8, 8), (8, 8, False)),
          "i32 route": ((3, 4), (8, 8, True))}


@pytest.mark.parametrize("rm,om", list(itertools.product(_ROUNDS, _OVFS)))
@pytest.mark.parametrize("step", list(_STEPS))
@pytest.mark.parametrize("layer", ["none", "same", "other-width",
                                   "other-shift"])
def test_k2s_plan_specialises_only_the_compiled_steps(rm, om, step, layer):
    """k2s_plan returns a compiled entry only when the product route, the
    product's step and every merge's step (shift, modes, width,
    signedness) are the entry's; the operand format's modes and the output
    format do not matter."""
    (ib, fb), (mi, mf, signed) = _STEPS[step]
    fmt = qt.qformat(ib, fb, round_mode=qt.RoundMode.RND_ZERO)
    mul = qt.qformat(mi, mf, signed, rm, om)
    layers = {"none": (), "same": (mul,),
              "other-width": (qt.qformat(mi + 1, mf, signed, rm, om),),
              "other-shift": (qt.qformat(mi, mf - 1, signed, rm, om),)}[layer]
    out = qt.qformat(6, 2, round_mode=qt.RoundMode.RND_INF)
    for k in (1, 32, 100):
        plan = TT.plan_tree(fmt, fmt, mul, layers, k, out)
        assert plan is not None
        params = list(TT._kernel_params(plan, out, 0))
        steps = {tuple(params[8 + 5 * l:13 + 5 * l])
                 for l in range(plan.levels)}
        want = 0
        for i, (route, prod, merge) in enumerate(TT.K2S_PLANS):
            if params[0] == route and tuple(params[2:7]) == prod \
                    and steps == {merge}:
                want = i + 1
        canonical = (rm, om) == (qt.RoundMode.TRN_TCPL,
                                 qt.OverflowMode.SAT_ZERO) \
            and step == "canonical" and layer in ("none", "same")
        assert want == (1 if canonical else 0), (k, step, layer)
        assert TT.k2s_plan(plan) == want, (k, step, layer, rm, om)


def test_k2s_plans_match_the_kernel_source():
    """ops.tree_gemm.K2S_PLANS lists csrc/plan_steps.cuh's K2S_PLANS (the
    table that K2′ and P1 share) after its run-time entry, and K2S_LOG_S
    is csrc/tree_gemm_stream.cuh's."""
    csrc = pathlib.Path(TT.__file__).parent.parent / "csrc"
    src = (csrc / "plan_steps.cuh").read_text()
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
    assert tuple(table) == TT.K2S_PLANS
    src = (csrc / "tree_gemm_stream.cuh").read_text()
    assert re.search(r"K2S_LOG_S = (\d+);", src).group(1) == \
        str(TT.K2S_LOG_S)
    src = (csrc / "tree_gemm.cuh").read_text()
    enum = re.search(r"enum Route : int \{(.*?)\};", src, re.S).group(1)
    assert {k.strip().removeprefix("ROUTE_").lower(): int(v)
            for k, v in (e.split("=") for e in enum.split(","))} == \
        TT.ROUTES


def _cpp_table(src, name, cols):
    """The rows of the C table ``name[][cols]`` in ``src`` as lists of
    stripped cells."""
    body = re.search(rf"{name}\[\]\[{cols}\] = \{{(.*?)\}};", src,
                     re.S).group(1)
    return [[x.strip() for x in r.split(",")]
            for r in re.findall(r"\{([^{}]*)\}", body)]


def test_k2s_instances_match_the_kernel_source():
    """ops.tree_gemm's K2S_TOP, K2S_TOP2, K2S_MAXL and K2S_INSTANCES (stack
    depth, plan, outputs a thread, blocks an SM) are
    csrc/tree_gemm_stream.cuh's, each instantiation has its file
    tree_gemm_stream_<depth>_<plan>.cu, and the entry point picks the
    depths in k2s_top's order."""
    csrc = pathlib.Path(TT.__file__).parent.parent / "csrc"
    src = (csrc / "tree_gemm_stream.cuh").read_text()
    depth = {n: int(re.search(rf"constexpr int {n} = (\d+);", s_).group(1))
             for n, s_ in (("K2S_TOP", src), ("K2S_TOP2", src),
                           ("MAXL", (csrc / "tree_fold.cuh").read_text()))}
    assert (depth["K2S_TOP"], depth["K2S_TOP2"], depth["MAXL"]) == \
        (TT.K2S_TOP, TT.K2S_TOP2, TT.K2S_MAXL)
    rows = tuple((depth[r[0]], *map(int, r[1:]))
                 for r in _cpp_table(src, "K2S_INSTANCES", 4))
    assert rows == TT.K2S_INSTANCES
    for top, plan, _, _ in TT.K2S_INSTANCES:
        name = {TT.K2S_TOP: "K2S_TOP", TT.K2S_TOP2: "K2S_TOP2",
                TT.K2S_MAXL: "MAXL"}[top]
        inst = (csrc / f"tree_gemm_stream_{top}_{plan}.cu").read_text()
        assert f"QK_K2S_INSTANCE({name}, {plan});" in inst, (top, plan)
        assert f"extern QK_K2S_INSTANCE({name}, {plan});" in src
    entry = (csrc / "tree_gemm_stream.cu").read_text()
    picks = re.findall(r"launch_k2s<qk::(\w+), (\d)>", entry)
    assert picks == [("K2S_TOP", "1"), ("K2S_TOP", "0"), ("K2S_TOP2", "1"),
                     ("MAXL", "1"), ("MAXL", "0")]
    assert "plan && bit_length(k) <= qk::K2S_TOP2" in entry


@pytest.mark.parametrize("k,plan,top", [
    (1, 0, 12), (1, 1, 12), (4095, 0, 12), (4095, 1, 12), (4096, 0, 32),
    (4096, 1, 14), (8192, 1, 14), (16383, 1, 14), (16383, 0, 32),
    (16384, 1, 32), (2 ** 20, 1, 32)])
def test_k2s_top_picks_the_entry_points_depth(k, plan, top):
    assert TT.k2s_top(k, plan) == top


@pytest.mark.parametrize("case,k,device,want", [
    ("canonical", 1, "cuda", True),
    ("canonical", 31, "cuda", True),
    ("canonical", 100, "cuda", True),
    ("canonical", 1024, "cuda", True),
    ("canonical", 4095, "cuda", True),
    ("canonical", 4096, "cuda", True),
    ("canonical", 8192, "cuda", True),
    ("canonical", 1024, "cpu", False),
    ("canonical", 4096, "cpu", False),
    ("pair", 300, "cuda", False),
    ("layered", 300, "cuda", False),
    ("i32", 128, "cuda", False),
    ("layered", 4096, "cuda", False)])
def test_qgemul_tree_tier_route(case, k, device, want):
    """qgemul's order-sensitive tier takes K2′ for CUDA operands on a plan
    that K2′ has compiled in, at any size, and K2 for the pair route, the
    plans whose steps K2′ reads at run time and CPU tensors (takes_k2s
    reads only the device's type: no card needed)."""
    fmt, layers = {"canonical": (F88Z, ()), "pair": (PAIRF, ()),
                   "layered": (F88Z, LAYERS), "i32": (I32F, ())}[case]
    plan = TT.plan_tree(fmt, fmt, qt.mul_merge(fmt, fmt), layers, k, fmt)
    for _ in range(2):  # the plan keeps no answer: the second is the same
        assert TT.takes_k2s(plan, torch.device(device)) is want


@pytest.mark.parametrize("k2s", [False, True])
def test_qgemul_calls_the_kernel_takes_k2s_names(k2s, monkeypatch):
    """qgemul's tree tier calls tree_gemm_stream where its plan names K2′
    (tree_kernel, the rule of takes_k2s) and tree_gemm elsewhere, with the
    same bits (here on the CPU, the planner's kernel choice forced)."""
    from qublas_tpu_torch.ops import gemm as G

    calls = []
    for name in ("tree_gemm", "tree_gemm_stream"):
        fn = getattr(G, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(G, name, spy)
    monkeypatch.setattr(G, "tree_kernel", lambda plan, device_type: (
        ("k2s", TT.k2s_plan(plan)) if k2s else ("k2", TT.k2_modes(plan))))
    a, b, plan = _case(F88Z, (), 37, seed=2, m=3, n=4)
    got = qt.qgemul(qt.QTensor(a, F88Z), qt.QTensor(b, F88Z), F88Z)
    assert calls == ["tree_gemm_stream" if k2s else "tree_gemm"]
    assert torch.equal(got.data, TT.tree_gemm_plain(a, b, plan, F88Z))


def test_canonical_plan_takes_the_compiled_k2s_entry():
    _, _, plan = _case(F88Z, (), 512)
    assert TT.k2s_plan(plan) == 1
    assert TT.k2s_plan(_case(F88Z, (), 4112)[2]) == 1
    assert TT.k2s_plan(_case(F88Z, LAYERS, 128)[2]) == 0
    assert TT.k2s_plan(_case(I32F, (), 128)[2]) == 0


def test_kernel_parameters_are_built_once():
    _, _, plan = _case(F88Z, (), 100)
    assert TT._kernel_params(plan, F88Z, 0) is TT._kernel_params(plan, F88Z, 0)
    assert list(TT._kernel_params(plan, F88Z, 0))[1] == 0


@pytest.mark.parametrize("shape,view,direct", [
    ((5, 8), None, True), ((5, 13), None, False), ((4, 12), (1, 9), False),
    ((4, 12), (4, 12), True), ((4, 12), (0, 9), True), ((1, 3), None, False)])
def test_k2s_operand_pitches_rows_tma_cannot_read(shape, view, direct):
    """k2s_operand passes int32 rows whose base and pitch are multiples of
    16 bytes as they are, and copies others into rows of a multiple of 4
    elements, zero past the operand's columns."""
    t = _raws(0, F88Z, shape).clone()   # torch's 64-byte aligned storage
    if view is not None:
        t = t[:, view[0]:view[1]]
    got, pitch = TT.k2s_operand(t)
    assert (got.data_ptr() == t.data_ptr()) == direct
    assert pitch % 4 == 0 and got.stride(0) == pitch
    assert torch.equal(got[:, :t.shape[1]], t)
    if not direct:
        assert pitch == -(-t.shape[1] // 4) * 4
        assert not got[:, t.shape[1]:].any()
