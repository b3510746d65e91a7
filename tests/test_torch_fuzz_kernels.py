"""The kernel families of ``qublas_tpu_torch.fuzz`` on the CPU, where each
kernel wrapper takes its plain version: each trial's plain version held to
``hostops`` (``hostint`` for P1's chain) at the generators' steered
configurations; the generators' reach, case by case, into each route
predicate that the card sweep's coverage gate needs (``k1_route``,
``gemm._k1_lut``, ``k2_modes``, ``k2s_plan`` and ``k2s_route``, ``k2h_route`` and
``k2h_modes``, ``k3_route`` and ``k3_modes``, ``p1_plan``); the gate and
the launch record; the ported ``tools/deep_fuzz.py`` families at a few
trials; the command line; and the limb product route that the sweep found
reaching K2 (ROADMAP §C).
"""

import collections
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qublas_tpu_torch import _build, anus, fuzz, hostops
from qublas_tpu_torch.ops import gemm as G
from qublas_tpu_torch.ops import limbdot
from qublas_tpu_torch.ops import reduce as R
from qublas_tpu_torch.ops import tree_gemm as TG
from qublas_tpu_torch.ops.chain_probe import p1_plan
from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm, k1_route
from qublas_tpu_torch.qformat import (OverflowMode, RoundMode, mul_merge,
                                      qformat)
from qublas_tpu_torch.ops.widths import torch_dtype_for
from qublas_tpu_torch.qtensor import QTensor, from_raw

ROOT = Path(__file__).resolve().parent.parent
# the trials of each family that phase k of chip_smoke.py runs on the card
PHASE_K = 48
TRIALS = {"k1": 24, "k2": 12, "k2s": 8, "k2h": 16, "k3": 24, "p1": 24}
CHECKS = {"k1": fuzz.k1_check, "k3": fuzz.k3_check, "p1": fuzz.p1_check}
CASES = {"k1": fuzz.k1_case, "k2": fuzz.k2_case, "k2s": fuzz.k2s_case,
         "k2h": fuzz.k2h_case, "k3": fuzz.k3_case, "p1": fuzz.p1_case}
TREE_KERNELS = {"k2": TG.tree_gemm, "k2s": TG.tree_gemm_stream,
                "k2h": TG.tree_gemm_hybrid}


def _run_trial(family, t):
    sw = fuzz.Sweep("cpu", echo=False)
    case = CASES[family](t)
    if family in TREE_KERNELS:
        fuzz._tree_check(sw, case, t, TREE_KERNELS[family], family)
    else:
        CHECKS[family](sw, case, t)
    return sw


@pytest.mark.parametrize("family,t", [(f, t) for f, n in TRIALS.items()
                                      for t in range(n)])
def test_kernel_family_trial(family, t):
    sw = _run_trial(family, t)
    assert sw.fails == 0, sw.lines


def _tally(family, key):
    return collections.Counter(key(CASES[family](t)) for t in range(PHASE_K))


def test_k1_generator_reaches_every_route_and_mode():
    kinds, routes, pairs = collections.Counter(), set(), set()
    for t in range(PHASE_K):
        c = fuzz.k1_case(t)
        assert c["plan"] is not None, t
        kinds[c["kind"]] += 1
        if c["kind"] in ("gemm", "qgemul"):
            assert G._device_epilogue_ok(c["plan"], c["out"]), t
            pairs.add((c["out"].round_mode, c["out"].overflow_mode))
        if c["kind"] == "gemm":
            a, b = fuzz.k1_operands(c, "cpu")
            inst = "s8" if a.dtype == b.dtype == torch.int8 else "s32"
            routes.add((inst, "A", k1_route(a)))
            routes.add((inst, "Bt", k1_route(b.t())))
    assert set(kinds) == {"gemm", "qgemul", "wide", "limb"}
    assert len(pairs) >= fuzz.MIN_PAIRS
    for r in ("direct", "copy", "padded"):
        assert ("s8", "A", r) in routes and ("s8", "Bt", r) in routes, r
    assert any(inst == "s32" for inst, _, _ in routes)


def test_k1_generator_reaches_the_dot_tiers():
    """The wide and limb kinds reach K1's int_dot (the int64 tier's
    segment dots and the limb tier's digit dots) through qgemul."""
    calls = collections.Counter()
    real = G.int_dot

    def counted(where):
        def dot(a, b):
            calls[where] += 1
            return real(a, b)
        return dot

    saved = (G.int_dot, limbdot.int_dot)
    G.int_dot, limbdot.int_dot = counted("wide"), counted("limb")
    try:
        for t in range(PHASE_K):
            c = fuzz.k1_case(t)
            if c["kind"] in ("wide", "limb"):
                before = calls[c["kind"]]
                assert fuzz.k1_check(fuzz.Sweep("cpu", echo=False), c, t) \
                    is None
                assert calls[c["kind"]] > before, (t, c["kind"])
    finally:
        G.int_dot, limbdot.int_dot = saved


def test_k1_generator_reaches_the_table_epilogue():
    """Part of the qgemul kind draw a ROM as ``epilogue_lut``: within phase
    k's trials K1's epilogue takes some (int8 lanes in and out) and others
    run it after the GEMM, each trial held to ``hostops`` and the
    table's own entries."""
    routes = collections.Counter()
    for t in range(PHASE_K):
        c = fuzz.k1_case(t)
        if c["lut"] is None:
            continue
        assert c["kind"] == "qgemul", t
        table = anus.QTable(getattr(anus, c["lut"][0]), c["out"],
                            c["lut"][1])
        a, b = (QTensor(torch.zeros((1, 1), dtype=torch_dtype_for(f)), f)
                for f in (c["fa"], c["fb"]))
        routes[G._k1_lut(table, None, a, b, c["out"]) is not None] += 1
        sw = fuzz.Sweep("cpu", echo=False)
        fuzz.k1_check(sw, c, t)
        assert sw.fails == 0, sw.lines
    assert routes[True] >= 2 and routes[False] >= 1, routes


def test_k2_generator_reaches_all_six_instantiations():
    got = _tally("k2", lambda c: (
        8 if (c["A"].shape[1] >> TG.K2_LOG_BLK).bit_length() <= 8 else 32,
        TG.k2_modes(c["plan"])))
    assert sorted(got) == [(top, m) for top in (8, 32) for m in (0, 1, 2)]
    assert min(got.values()) >= PHASE_K // 6
    pairs = set()
    for t in range(PHASE_K):
        c = fuzz.k2_case(t)
        if TG.k2_modes(c["plan"]) == 0:
            pairs.update((f.round_mode, f.overflow_mode)
                         for f in TG._step_fmts(c["plan"], c["out"]))
    assert len(pairs) >= fuzz.MIN_PAIRS


def test_k2s_generator_reaches_both_plans_and_operand_routes():
    got = collections.Counter()
    for t in range(PHASE_K):
        c = fuzz.k2s_case(t)
        a, b = fuzz.tree_operands(c, "cpu")
        got["plan", TG.k2s_plan(c["plan"])] += 1
        got["stack", 12 if c["A"].shape[1].bit_length() <= 12 else 32] += 1
        got["a", TG.k2s_route(a.to(torch.int32))] += 1
        got["b", TG.k2s_route(b.to(torch.int32))] += 1
    for key in (("plan", 0), ("plan", 1), ("stack", 12), ("stack", 32),
                ("a", "direct"), ("a", "pitched"), ("b", "direct"),
                ("b", "pitched")):
        assert got[key] > 0, key


def test_k2s_generator_reaches_every_instantiation():
    """Phase k's trials of the k2s family reach each of K2′'s
    instantiations (stack depth by k2s_top, plan by k2s_plan), so the
    gate can ask for all of them."""
    got = _tally("k2s", lambda c: "stream_{}_{}".format(
        TG.k2s_top(c["A"].shape[1], TG.k2s_plan(c["plan"])),
        TG.k2s_plan(c["plan"])))
    assert set(got) == set(fuzz.K2S_INSTANCES), got


def test_k2h_generator_reaches_both_kernels_and_tails():
    got = collections.Counter()
    for t in range(PHASE_K):
        c = fuzz.k2h_case(t)
        a, b = fuzz.tree_operands(c, "cpu")
        route = TG.k2h_route(a, b)
        got[route,] += 1
        got["lane", TG.digit_lanes(a, b)] += 1
        got["modes", route, TG.k2h_modes(c["plan"], c["A"].shape[1])] += 1
        got["s", c["plan"].s] += 1
        got["dl>0",] += c["plan"].dl > 0
        got["odd blocks",] += (c["A"].shape[1] // c["plan"].s) % 2
    assert got["mma",] >= fuzz.MIN_LAUNCHES
    assert got["digits",] >= fuzz.MIN_LAUNCHES
    assert got["lane", 2] > 0 and got["lane", 4] > 0
    for route in ("mma", "digits"):
        for m in (0, 1, 2):
            assert got["modes", route, m] > 0, (route, m)
    assert {k[1] for k in got if k[0] == "s"} >= {8, 16, 32}
    assert got["dl>0",] > 0 and got["odd blocks",] > 0


def test_k3_generator_reaches_every_kernel_lane_and_mode():
    got, pairs = collections.Counter(), set()
    for t in range(PHASE_K):
        c = fuzz.k3_case(t)
        if c["kind"] == "layered":
            got["layered",] += 1
            continue
        x, axis = fuzz.k3_operand(c, "cpu")
        route, s = R.k3_route(x.contiguous(), axis, c["plan"])
        got[route,] += 1
        got["S", s] += 1
        got["lane", x.element_size()] += 1
        got["modes", c["plan"].modes] += 1
        pairs.update((f.round_mode, f.overflow_mode)
                     for f in c["plan"].merge_fmts)
    for key in (("warp",), ("thread",), ("columns",), ("layered",),
                ("lane", 1), ("lane", 2), ("lane", 4), ("modes", 0),
                ("modes", 1), ("modes", 2)):
        assert got[key] > 0, key
    assert len({k[1] for k in got if k[0] == "S"}) >= 3
    assert len(pairs) >= fuzz.MIN_PAIRS


def test_k3_layered_cases_reach_the_kernel():
    """The layered GEMM cases go through qgemul's layered tier, whose
    reduce over k runs on K3's wrapper."""
    calls = []
    real = R.qreduce_kernel

    def counted(x, axis, plan):
        calls.append(tuple(x.shape))
        return real(x, axis, plan)

    R.qreduce_kernel = counted
    try:
        for t in range(PHASE_K):
            c = fuzz.k3_case(t)
            if c["kind"] == "layered":
                n = len(calls)
                sw = fuzz.Sweep("cpu", echo=False)
                fuzz.k3_check(sw, c, t)
                assert sw.fails == 0, sw.lines
                assert len(calls) > n, t
    finally:
        R.qreduce_kernel = real


def test_p1_generator_reaches_both_plans_and_step_counts():
    got = _tally("p1", lambda c: (p1_plan(c["plan"]), c["steps"]))
    assert {p for p, _ in got} == {0, 1}
    for steps in fuzz.P1_STEPS:
        assert got[0, steps] > 0 and got[1, steps] > 0, steps


def test_gate_reports_what_a_sweep_missed():
    fuzz.reset_counts()
    findings = fuzz.gate({row[3] for row in fuzz.KERNELS})
    assert len([f for f in findings if "launches <" in f]) == 7
    # K2's six instantiations, K2′'s five and K1's table instantiation
    assert len([f for f in findings if "never launched" in f]) == 12
    for _, owner, attr, _, _ in fuzz.KERNELS:
        setattr(owner, attr, fuzz.MIN_LAUNCHES)
    fused_int8_gemm.lut_launches = 1
    modes = [qformat(3, 4, True, r, o) for r, o in fuzz.MODES[:fuzz.MIN_PAIRS]]
    for m in modes:
        _build.record(fused_int8_gemm, "gemm/s8/direct/direct", (m,))
        _build.record(R.qreduce_kernel, "warp_1/modes_0/1", (m,))
    # a table epilogue's launch adds no mode pair to the plain epilogues'
    _build.record(fused_int8_gemm, "gemm+lut/s8/direct/direct",
                  (qformat(3, 4, True, *fuzz.MODES[-1]),))
    for inst in fuzz.K2_INSTANCES:
        _build.record(TG.tree_gemm, inst, modes)
    for inst in fuzz.K2S_INSTANCES:
        _build.record(TG.tree_gemm_stream, f"{inst}/direct/pitched", modes)
    _build.record(fused_int8_gemm, "int_dot/s32")
    _build.record(TG.tree_gemm_hybrid, "mma_1", modes[:2])
    _build.record(TG.tree_gemm_hybrid, "digits2_0", modes[:3])
    try:
        assert fuzz.gate({row[3] for row in fuzz.KERNELS}) == []
        assert fuzz.mode_pairs(fused_int8_gemm, "gemm/") == {
            (m.round_mode.name, m.overflow_mode.name) for m in modes}
        rows = {r["name"]: r for r in fuzz.kernel_report()}
        assert rows["fused_int8_gemm"]["mode_pairs"] == fuzz.MIN_PAIRS
        assert rows["fused_int8_gemm"]["instances"] == {
            "gemm/s8/direct/direct": fuzz.MIN_PAIRS, "int_dot/s32": 1,
            "gemm+lut/s8/direct/direct": 1}
        assert set(rows["tree_gemm"]["instances"]) == set(fuzz.K2_INSTANCES)
        assert set(rows["tree_gemm_stream"]["instances"]) == {
            f"{i}/direct/pitched" for i in fuzz.K2S_INSTANCES}
        assert rows["tree_gemm_hybrid_mma"]["instances"] == {"mma_1": 1}
        assert rows["tree_gemm_hybrid_mma"]["mode_pairs"] == 2
        assert rows["tree_gemm_hybrid_digits"]["instances"] == {
            "digits2_0": 1}
        assert rows["tree_gemm_hybrid_digits"]["mode_pairs"] == 3
    finally:
        fuzz.reset_counts()


FAMILY_TRIALS = {"routes": 1, "elementwise": 40, "cast": 40, "reduce": 30,
                 "gemm": 30, "gemm_limbwide": 30, "complex": 30,
                 "cgemul": 30, "anus": 30, "bitstream": 40, "bitwise": 30}


@pytest.mark.parametrize("family", sorted(FAMILY_TRIALS))
def test_deep_fuzz_family_on_cpu(family):
    fn = dict(fuzz.FAMILIES)[family]
    sw = fuzz.Sweep("cpu", echo=False)
    done = fn(sw, FAMILY_TRIALS[family])
    assert sw.fails == 0, sw.lines
    assert done is None or done > 0


def test_world_families_on_cpu(capsys):
    res = fuzz.run({"routes_sharded": 1, "sharded": 12, "sharded_ktree": 12},
                   "cpu", timeout=240.0)
    assert res["fails"] == 0, capsys.readouterr().out[-3000:]
    assert set(res["stats"]) == {"routes_sharded", "sharded",
                                 "sharded_ktree"}


def _cli(*args, env=None):
    return subprocess.run([sys.executable, "-m", "qublas_tpu_torch.fuzz",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=env)


def test_cli_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT))
    res = _cli("1", "--family", "cast", env=env)
    assert res.returncode == 2
    assert res.stdout == ""
    assert len(res.stderr.strip().splitlines()) == 1
    assert "no CUDA device" in res.stderr


def test_cli_sweeps_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = _cli("20", "--device", "cpu", "--family", "cast", "--family", "p1",
               env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    last = res.stdout.strip().splitlines()[-1]
    assert last.startswith("sweep: 68 trials, 0 mismatches")
    assert _cli("--family", "nonesuch", env=env).returncode == 2


# -- the limb product route (ROADMAP §C) ------------------------------------

# lane operands whose product's requantize needs more than 64 working bits
# by the proof (route_mul says "limb"), every tree step inside int32
LIMB_CFG = (qformat(2, 0, False, RoundMode.RND_POS_INF,
                    OverflowMode.WRP_TCPL_SAT),
            qformat(18, -2, False, RoundMode.RND_ZERO, OverflowMode.SAT_SMGN),
            qformat(10, 20, False, RoundMode.RND_POS_INF,
                    OverflowMode.SAT_TCPL),
            (qformat(12, 0, True, RoundMode.RND_CONV,
                     OverflowMode.SAT_TCPL),),
            qformat(12, 0, True, RoundMode.RND_CONV, OverflowMode.WRP_TCPL))


def _limb_plan(k):
    fa, fb, mul_to, layers, out = LIMB_CFG
    return TG.plan_tree(fa, fb, mul_merge(fa, fb, mul_to, False), layers, k,
                        out)


def test_limb_product_plans_stay_off_the_tree_kernels():
    """plan_tree (as the JAX package's) admits a product on the "limb"
    route; K2 and K2′ take products on the int32 and 64-bit routes only,
    so their parameters refuse such a plan, P1's and K2′'s plan pickers
    read it as a run-time plan, and qgemul sends it to the tiers below."""
    plan = _limb_plan(5)
    assert plan is not None and plan.prod_route == "limb"
    with pytest.raises(ValueError, match="routes"):
        TG._kernel_params(plan, LIMB_CFG[4], TG.K2_LOG_BLK)
    assert p1_plan(plan) == 0 and TG.k2s_plan(plan) == 0


def test_limb_product_qgemul_matches_hostops_and_jax():
    import importlib

    import qublas_tpu.ops.gemm as jgemm
    from torch_fuzz_gen import flat, jq

    jfmt = importlib.import_module("torch_fuzz_gen").jfmt
    fa, fb, mul_to, layers, out = LIMB_CFG

    def no_tree(*a, **kw):
        raise AssertionError("a limb-route plan reached tree_gemm")

    saved = G.tree_gemm
    G.tree_gemm = no_tree
    try:
        for k in (1, 5, 16, 33):
            rng = np.random.RandomState(k)
            A = rng.randint(fa.raw_min, fa.raw_max + 1, (3, k))
            B = rng.randint(fb.raw_min, fb.raw_max + 1, (k, 2))
            got = G.qgemul(from_raw(A, fa, device="cpu"),
                           from_raw(B, fb, device="cpu"), out, mul_to=mul_to,
                           add_formats=layers)
            host = hostops.qgemul([[(int(v), fa) for v in r] for r in A],
                                  [[(int(v), fb) for v in r] for r in B],
                                  out, mul_to, layers)
            jax = jgemm.qgemul(jq(A, fa), jq(B, fb), jfmt(out),
                               mul_to=jfmt(mul_to),
                               add_formats=tuple(jfmt(f) for f in layers))
            want = [v for row in host for v, _ in row]
            assert flat(got) == want == flat(jax), k
            assert any(want), k
    finally:
        G.tree_gemm = saved


# -- P1 chains that leave the plan's proof ----------------------------------

# trials of the p1 family whose chains leave the x operand's interval (a
# layer 0 of WRP::TCPL_SAT wraps at the storage word, not the format): the
# first card run of 400 trials held these to Python ints past that point
P1_OUT_OF_PROOF = (179, 212, 286, 305, 389)


@pytest.mark.parametrize("t", P1_OUT_OF_PROOF)
def test_p1_chains_outside_the_proof_follow_the_jax_chain(t):
    """Past the proof the chain is int32 lane arithmetic: the port's plain
    P1 equals the JAX package's ``_product``/``_merge`` loop there, and the
    sweep's oracle stops where the chain leaves the proof."""
    import jax.numpy as jnp

    from qublas_tpu.ops import tree_gemm as JTG
    from qublas_tpu_torch.ops.chain_probe import chain_probe_plain
    from qublas_tpu_torch.ops.widths import fmt_interval
    from torch_fuzz_gen import jfmt

    c = fuzz.p1_case(t)
    plan = c["plan"]
    jplan = JTG.plan_tree(jfmt(c["fa"]), jfmt(c["fb"]), jfmt(plan.mul_fmt),
                          (jfmt(plan.merge_fmts[0]),), plan.k,
                          jfmt(plan.merge_fmts[0]))
    X, Y = c["X"].astype(np.int32), c["Y"].astype(np.int32)
    v, y = jnp.asarray(X), jnp.asarray(Y)
    for _ in range(c["steps"]):
        v = JTG._merge(jplan, 0, *(JTG._product(jplan, v, y),) * 2)
    plain = chain_probe_plain(torch.from_numpy(X), torch.from_numpy(Y), plan,
                              c["steps"], 1)[0]
    np.testing.assert_array_equal(plain.numpy(), np.asarray(v))
    x_iv = fmt_interval(c["fa"])
    stops = [fuzz.p1_oracle(plan, int(a), int(b), c["steps"], x_iv)
             for a, b in zip(X.reshape(-1)[:64], Y.reshape(-1)[:64])]
    assert None in stops
    sw = _run_trial("p1", t)
    assert sw.fails == 0, sw.lines


def test_a_generator_without_a_case_counts_as_a_failure(monkeypatch):
    """A generator that finds no configuration in its envelope, or raises,
    is a counted failure with its repro line, and the sweep goes on."""
    def none_found(t):
        raise fuzz.NoCase("no plan_tree plan in 400 draws")

    def broken(t):
        raise KeyError(t)

    monkeypatch.setattr(fuzz, "k2_case", none_found)
    monkeypatch.setattr(fuzz, "k3_case", broken)
    sw = fuzz.Sweep("cpu", echo=False)
    assert fuzz.sweep_k2(sw, 3) == 3 and fuzz.sweep_k3(sw, 2) == 2
    assert sw.fails == 5 and sw.crashes == 2
    assert sw.lines[0] == ("FAIL k2[0] the generator found no case: no "
                           "plan_tree plan in 400 draws")
    assert sw.lines[3].startswith("FAIL CRASH k3[0] drawing its case KeyError")


def test_p1_sweep_counts_the_chains_past_the_proof(monkeypatch):
    """sweep_p1 reports how many sampled chains it held to hostint and how
    many left the proof, and fails when too many left it."""
    sw = fuzz.Sweep("cpu", echo=False)
    fuzz.sweep_p1(sw, 6)
    assert sw.fails == 0, sw.lines
    assert sw.p1_held > 0
    assert sw.notes["p1"] == (f"{sw.p1_held} chains held to hostint, "
                              f"{sw.p1_past} past the proof")
    monkeypatch.setattr(fuzz, "p1_oracle", lambda *a: None)
    sw = fuzz.Sweep("cpu", echo=False)
    fuzz.sweep_p1(sw, 3)
    assert sw.p1_held == 0 and sw.p1_past > 0
    assert sw.fails == 1 and "chains left the proof" in sw.lines[0], sw.lines
