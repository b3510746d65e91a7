"""The port's CUDA kernels on the card: each against its plain version.

This file imports no JAX, so it also runs on a machine with a card and no
JAX, where ``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a CUDA device every test skips.  The plain versions are themselves
held Δ=0 against the JAX package by the other ``tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch import moe
from qublas_tpu_torch.ops import cgemm
from qublas_tpu_torch.ops import chain_probe as CP
from qublas_tpu_torch.ops import tree_gemm as TT
from qublas_tpu_torch.ops.chain_probe import (G, T1, T2, chain_probe,
                                              chain_probe_plain, p1_plan,
                                              probe_tile)
from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm,
                                             fused_int8_gemm_grouped,
                                             fused_int8_gemm_plain, int_dot,
                                             int_dot_plain, k1_route, kmajor)
from qublas_tpu_torch.ops.reduce import (k3_route, plan_reduce,
                                         qreduce_kernel, qreduce_plain)
from qublas_tpu_torch.ops.tree_gemm import (k2_modes, k2s_operand, k2s_plan,
                                            plan_tree, tree_gemm,
                                            tree_gemm_plain, tree_gemm_stream,
                                            tree_gemm_stream_plain)
from qublas_tpu_torch.utils.profiling import launch_record

pytestmark = pytest.mark.cuda

FA, WIDE, MID = qt.pipeline_formats()
F88Z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
LAYERS = (qt.qformat(9, 6, round_mode=qt.RoundMode.RND_CONV),
          qt.qformat(10, 4))
F44 = qt.qformat(4, 4)
CONFIG2 = (qt.qformat(5, 3, round_mode=qt.RoundMode.RND_CONV,
                      overflow_mode=qt.OverflowMode.SAT_ZERO),
           qt.qformat(6, 2))
SMGN = qt.qformat(3, 4, overflow_mode=qt.OverflowMode.SAT_SMGN)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _raws(seed, fmt, shape, dtype):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape).astype(dtype))


@pytest.mark.parametrize("m,k,n,dtype", [
    (256, 512, 256, np.int8), (1000, 777, 1003, np.int8), (1, 1, 1, np.int8),
    (130, 16, 129, np.int8), (70, 96, 50, np.int16), (33, 300, 17, np.int32)])
def test_k1_matches_plain(cuda, m, k, n, dtype):
    f = FA if dtype == np.int8 else qt.qformat(7, 4)
    a = _raws(m, f, (m, k), dtype).to(cuda)
    b = _raws(n, f, (k, n), dtype).to(cuda)
    for out in (MID, qt.qformat(3, 2, round_mode=qt.RoundMode.RND_CONV),
                qt.qformat(2, 1, False, qt.RoundMode.RND_ZERO,
                           qt.OverflowMode.WRP_TCPL),
                qt.qformat(8, 10)):
        got = fused_int8_gemm(a, b, 8, out)
        want = fused_int8_gemm_plain(a, b, 8, out)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (m, k, n, out)


@pytest.mark.parametrize("m,k,n,layers", [
    (128, 512, 128, ()), (77, 1000, 45, ()), (33, 13, 17, ()),
    (128, 128, 128, LAYERS), (5, 1, 3, ()), (40, 96, 300, LAYERS)])
def test_k2_matches_plain(cuda, m, k, n, layers):
    a = _raws(m + k, F88Z, (m, k), np.int32).to(cuda)
    b = _raws(n + k, F88Z, (k, n), np.int32).to(cuda)
    plan = plan_tree(F88Z, F88Z, qt.mul_merge(F88Z, F88Z), layers, k, F88Z)
    got = tree_gemm(a, b, plan, F88Z)
    want = tree_gemm_plain(a, b, plan, F88Z)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (m, k, n, layers)


def test_main_path_matches_cpu_and_counts_launches(cuda):
    """The main path on the card equals the same calls on CPU tensors (the
    plain versions), and launches K1 twice and K2′ once (the canonical
    tree's route, ``takes_k2s``)."""
    x = _raws(0, FA, (256, 256), np.int8)
    w1 = _raws(1, FA, (256, 256), np.int8).numpy()
    w2 = _raws(2, FA, (256, 128), np.int8).numpy()
    a = qt.from_raw(_raws(3, F88Z, (64, 100), np.int32).numpy(), F88Z, "cpu")
    b = qt.from_raw(_raws(4, F88Z, (100, 48), np.int32).numpy(), F88Z, "cpu")
    pipe_gpu = qt.QuantPipeline.from_numpy(w1, w2, cuda)
    fused_int8_gemm.launches = 0
    tree_gemm.launches = tree_gemm_stream.launches = 0
    y = pipe_gpu(x.to(cuda))
    c = qt.qgemul(a.to(cuda), b.to(cuda), F88Z)
    torch.cuda.synchronize()
    assert (fused_int8_gemm.launches, tree_gemm_stream.launches) == (2, 1)
    assert tree_gemm.launches == 0
    y_cpu = qt.QuantPipeline.from_numpy(w1, w2, "cpu")(x)
    c_cpu = qt.qgemul(a, b, F88Z)
    assert (fused_int8_gemm.launches, tree_gemm_stream.launches) == (2, 1)
    assert torch.equal(y.cpu(), y_cpu)
    assert c.fmt == c_cpu.fmt and torch.equal(c.data.cpu(), c_cpu.data)


def test_operands_on_two_devices_raise(cuda):
    a = _raws(5, FA, (8, 8), np.int8)
    with pytest.raises(ValueError, match="operands on"):
        fused_int8_gemm(a.to(cuda), a, 8, MID)


Z34 = qt.qformat(3, 4, overflow_mode=qt.OverflowMode.SAT_ZERO)


# route: (kernel, S, modes) that k3_route and k3_modes give; the modes are
# compiled in for int8 warp rows at S = 32 and columns in blocks of 16
@pytest.mark.parametrize("fmt,layers,shape,axis,dtype,route", [
    (F44, CONFIG2, (4096, 1024), 1, np.int8, ("warp", 32, 1)),
    (F44, CONFIG2, (131072, 1024), 1, np.int8, ("warp", 32, 1)),
    (Z34, (), (300, 1024), 1, np.int8, ("warp", 32, 2)),
    (F44, CONFIG2, (1024, 300), 0, np.int8, ("columns", 0, 1)),
    (F88Z, (), (8, 512, 64), 1, np.int32, ("columns", 0, 2)),
    (F44, (), (4, 512, 33), 1, np.int8, ("columns", 0, 0)),
    (F44, CONFIG2, (3, 1 << 18), 1, np.int8, ("warp", 32, 1)),
    (qt.qformat(7, 4), CONFIG2, (40, 2048), 1, np.int16, ("warp", 16, 1)),
    (qt.qformat(20, 8), (qt.qformat(26, 2),), (5, 1024), 1, np.int32,
     ("warp", 8, 0)),
    (F44, CONFIG2, (77, 1000), 1, np.int8, ("thread", 0, 1)),
    (F44, CONFIG2, (13, 45), 0, np.int8, ("columns", 0, 1)),
    (F44, (), (6, 13, 5), 1, np.int16, ("columns", 0, 0)),
    (qt.qformat(7, 4), CONFIG2, (40, 3), 1, np.int16, ("thread", 0, 1)),
    (qt.qformat(20, 8), (qt.qformat(26, 2),), (5, 1000, 3), 1, np.int32,
     ("columns", 0, 0)),
    (SMGN, (), (33, 13), 1, np.int8, ("thread", 0, 0)),
    (SMGN, (), (33, 64), 1, np.int8, ("warp", 2, 0)),
], ids=["config2-rows", "config2-rows-131072", "sat-zero-rows",
        "config2-cols", "canonical-cols", "run-time-cols", "deep-stack-rows",
        "int16-rows", "int32-rows", "ragged-batch", "odd-n-cols",
        "no-layers-3d", "int16", "int32", "smgn", "smgn-warp"])
def test_k3_matches_plain(cuda, fmt, layers, shape, axis, dtype, route):
    x = _raws(sum(shape), fmt, shape, dtype)
    if fmt == SMGN:
        x[..., -1] = fmt.raw_min  # the odd tail's raw that SMGN would clamp
    x = x.to(cuda)
    plan = plan_reduce(fmt, layers, shape[axis])
    assert k3_route(x, axis, plan) + (plan.modes,) == route
    got = qreduce_kernel(x, axis, plan)
    want = qreduce_plain(x, axis, plan)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    assert torch.equal(got, want), (shape, axis)


@pytest.mark.parametrize("n,route", [
    (13, ("thread", 0)), (96, ("warp", 1)), (1024, ("warp", 32))])
@pytest.mark.parametrize("signed", [True, False])
def test_k3_every_mode_matches_plain(cuda, signed, n, route):
    """Every layer mode pair, on the thread kernel and on the warp kernel
    (modes read at run time, or fixed where they are K3_MODES')."""
    x = _raws(3, F44, (100, n), np.int8).to(cuda)
    for rm in qt.RoundMode:
        for om in qt.OverflowMode:
            layers = (qt.qformat(5, 2, signed, rm, om),)
            plan = plan_reduce(F44, layers, n)
            assert k3_route(x, 1, plan) == route
            got = qreduce_kernel(x, 1, plan)
            want = qreduce_plain(x, 1, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), layers


@pytest.mark.parametrize("dtype,offset,s", [
    (np.int8, 1, 1), (np.int8, 2, 2), (np.int8, 4, 4), (np.int8, 8, 8),
    (np.int8, 16, 32), (np.int16, 1, 1), (np.int16, 2, 2), (np.int16, 8, 16),
    (np.int32, 1, 1), (np.int32, 2, 2)])
def test_k3_row_base_off_16_bytes_matches_plain(cuda, dtype, offset, s):
    """Rows that start off 16 bytes (a storage offset) take a narrower
    load of the warp kernel; rows 16 bytes off 32 keep its two 16-byte
    loads."""
    f = {np.int8: F44, np.int16: qt.qformat(7, 4),
         np.int32: qt.qformat(20, 8)}[dtype]
    layers = CONFIG2 if dtype != np.int32 else (qt.qformat(26, 2),)
    flat = _raws(offset, f, (300 * 1024 + offset,), dtype).to(cuda)
    x = flat[offset:].view(300, 1024)
    plan = plan_reduce(f, layers, 1024)
    assert x.storage_offset() == offset
    assert k3_route(x, 1, plan) == ("warp", s)
    got = qreduce_kernel(x, 1, plan)
    want = qreduce_plain(x, 1, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, qreduce_kernel(x.clone(), 1, plan))


@pytest.mark.parametrize("m,k,n,layers", [
    (64, 512, 64, ()), (33, 13, 17, ()), (77, 1000, 45, ()),
    (128, 128, 128, LAYERS)])
def test_k2_stream_matches_plain_and_k2(cuda, m, k, n, layers):
    a = _raws(m + k, F88Z, (m, k), np.int32).to(cuda)
    b = _raws(n + k, F88Z, (k, n), np.int32).to(cuda)
    plan = plan_tree(F88Z, F88Z, qt.mul_merge(F88Z, F88Z), layers, k, F88Z)
    got = tree_gemm_stream(a, b, plan, F88Z)
    want = tree_gemm_stream_plain(a, b, plan, F88Z)
    blocked = tree_gemm(a, b, plan, F88Z)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, blocked)


def test_qreduce_launches_k3_only_when_proven(cuda):
    x = qt.from_raw(_raws(9, F44, (64, 37), np.int8).numpy(), F44, cuda)
    qreduce_kernel.launches = 0
    tree_gemm_stream.launches = 0
    r = qt.qreduce(x, CONFIG2, axis=1)
    assert qreduce_kernel.launches == 1
    qt.qreduce(x[:, :1], CONFIG2, axis=1)          # n = 1: no launch
    wide = (qt.qformat(8, 8), qt.qformat(1000, 0), qt.qformat(6, 2))
    h = qt.qreduce(x[:4, :8], wide, axis=1)         # resumes on the host
    assert qreduce_kernel.launches == 1
    assert h.device == x.device
    cpu = qt.qreduce(x.to("cpu"), CONFIG2, axis=1)
    assert r.fmt == cpu.fmt and torch.equal(r.data.cpu(), cpu.data)
    assert qreduce_kernel.launches == 1 and tree_gemm_stream.launches == 0


# P1's plans, one for each instantiation (p1_plan): the canonical plan's
# compiled steps, a split-route and an i32-route plan read at run time
P1_PLANS = {"canonical": (F88Z, 1),
            "run-time split": (qt.qformat(8, 8, round_mode=qt.RoundMode.
                                          RND_CONV, overflow_mode=qt.
                                          OverflowMode.SAT_ZERO), 0),
            "run-time i32": (qt.qformat(3, 4, round_mode=qt.RoundMode.RND_CONV,
                                        overflow_mode=qt.OverflowMode.
                                        WRP_TCPL), 0)}


def _p1_plan(name, k=256):
    f, instance = P1_PLANS[name]
    plan = plan_tree(f, f, qt.mul_merge(f, f), (), k, f)
    assert plan.prod_route == ("i32" if name.endswith("i32") else "split")
    assert p1_plan(plan) == instance
    return f, plan


@pytest.mark.parametrize("name", list(P1_PLANS))
@pytest.mark.parametrize("steps", [0, 1, 16, 17])
@pytest.mark.parametrize("shape,offset", [((128, 256), 0), ((13, 7), 1),
                                          ((16, 32), 1), ((16, 33), 0)])
def test_p1_matches_plain(cuda, name, steps, shape, offset):
    """P1 at each instantiation on 4 programs: the vector path, a ragged
    tile, and tiles whose base is 4 bytes off 16 (the scalar path)."""
    f, plan = _p1_plan(name)
    n = shape[0] * shape[1]
    flat = _raws(steps, f, (2 * (n + offset),), np.int32).to(cuda)
    x = flat[offset:offset + n].view(shape)
    y = flat[n + 2 * offset:].view(shape)
    chain_probe.launches = 0
    got = chain_probe(x, y, plan, steps, 4)
    want = chain_probe_plain(x, y, plan, steps, 4)
    torch.cuda.synchronize()
    assert chain_probe.launches == 1
    assert got.shape == (4,) + shape and torch.equal(got, want)


@pytest.mark.parametrize("name,instance", [("canonical", 1), ("canonical", 0),
                                           ("run-time split", 0),
                                           ("run-time i32", 0)])
@pytest.mark.parametrize("steps", [T1, T2])
def test_p1_matches_plain_at_measured_shapes(cuda, name, instance, steps):
    """P1 on measured_chain_prods' tile, chain lengths and G, at each
    instantiation (the canonical plan also through the run-time one); the
    forced launch is one launch of the custom op, and counts as one."""
    f, plan = _p1_plan(name, 2048)
    x, y = probe_tile(f, cuda)
    chain_probe.launches = 0
    got = chain_probe(x, y, plan, steps, G) if instance else \
        CP._launch(x, y, plan, steps, G, 0)
    want = chain_probe_plain(x, y, plan, steps, G)
    torch.cuda.synchronize()
    assert chain_probe.launches == 1
    assert got.shape == (G,) + tuple(x.shape) and torch.equal(got, want)


@pytest.mark.parametrize("instance", [1, 0])
def test_p1_runs_every_step_of_every_program(cuda, instance):
    """On a tile whose canonical chains are still not 0 after T1 steps,
    each of 8 programs equals the plain chain, and T1 - 1 steps give
    another result: no chain leaves early and no program copies another."""
    f, plan = _p1_plan("canonical", 2048)
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randint(100, 2001, (128, 256)).astype(np.int32))
    y = torch.from_numpy(rng.randint(129, 132, (128, 256)).astype(np.int32))
    want = chain_probe_plain(x, y, plan, T1, 1)[0]
    assert bool((want != 0).all())
    x, y = x.to(cuda), y.to(cuda)
    got = CP._launch(x, y, plan, T1, 8, instance).cpu()
    short = CP._launch(x, y, plan, T1 - 1, 8, instance).cpu()
    for g in range(8):
        assert torch.equal(got[g], want), g
    assert (short != got).float().mean() > 0.9


@pytest.mark.parametrize("m,k,n,dtype", [
    (1000, 777, 1003, np.int8), (300, 256, 300, np.int16),
    (5, 33, 7, np.int32)])
def test_int_dot_matches_plain(cuda, m, k, n, dtype):
    f = FA if dtype == np.int8 else qt.qformat(7, 4)
    a = _raws(m, f, (m, k), dtype).to(cuda)
    b = _raws(n, f, (k, n), dtype).to(cuda)
    fused_int8_gemm.launches = 0
    got = int_dot(a, b)
    want = int_dot_plain(a, b)
    torch.cuda.synchronize()
    assert fused_int8_gemm.launches == 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_int_dot_keeps_the_int32_extremes(cuda):
    a = torch.tensor([[-(1 << 15), (1 << 15) - 1],
                      [-(1 << 15), -(1 << 15)]], dtype=torch.int16)
    b = torch.tensor([[-(1 << 15), 1 << 15], [(1 << 15) + 1, 1 << 15]],
                     dtype=torch.int32)
    got = int_dot(a.to(cuda), b.to(cuda)).cpu()
    assert got.tolist() == [[(1 << 31) - 1, -(1 << 15)],
                            [-(1 << 15), -(1 << 31)]]


@pytest.mark.parametrize("algo", ["tf", "basic"])
def test_config5_cgemul_matches_cpu_and_counts_launches(cuda, algo):
    """BASELINE config 5 on the card equals the same call on CPU tensors
    (int_dot's plain version), with four K1 launches; the order-sensitive
    complex GEMM launches K3 once per part."""
    wide, mid = qt.qformat(20, 8), qt.qformat(5, 4)
    out = (qt.qformat(3, 4, overflow_mode=qt.OverflowMode.SAT_ZERO),) * 2
    tags = dict(ab=mid, cd=mid, ba=mid, abc=wide, cdb=wide, bad=wide,
                AB=wide, BC=wide) if algo == "tf" else \
        dict(ac=wide, bd=wide, ad=wide, bc=wide, acbd=wide, adbc=wide)
    parts = [_raws(s, FA, shape, np.int8) for s, shape in
             ((1, (200, 300)), (2, (200, 300)), (3, (300, 150)),
              (4, (300, 150)))]
    a = qt.complex_from_raw(parts[0].numpy(), parts[1].numpy(), FA,
                            device="cpu")
    b = qt.complex_from_raw(parts[2].numpy(), parts[3].numpy(), FA,
                            device="cpu")
    fused_int8_gemm.launches = 0
    got = qt.cgemul(a.to(cuda), b.to(cuda), out, algo=algo,
                    add_formats=(wide,), **tags)
    torch.cuda.synchronize()
    assert fused_int8_gemm.launches == 4
    want = qt.cgemul(a, b, out, algo=algo, add_formats=(wide,), **tags)
    assert fused_int8_gemm.launches == 4
    for g, w in ((got.real, want.real), (got.imag, want.imag)):
        assert g.fmt == w.fmt and torch.equal(g.data.cpu(), w.data)
    # the order-sensitive canonical config takes the layered path
    c, d = (qt.complex_from_raw(_raws(s, F88Z, shape, np.int32).numpy(),
                                _raws(s + 1, F88Z, shape, np.int32).numpy(),
                                F88Z, device="cpu")
            for s, shape in ((5, (24, 40)), (7, (40, 30))))
    qreduce_kernel.launches = 0
    fused_int8_gemm.launches = 0
    got = qt.cgemul(c.to(cuda), d.to(cuda), F88Z, algo=algo)
    torch.cuda.synchronize()
    assert (qreduce_kernel.launches, fused_int8_gemm.launches) == (2, 0)
    want = qt.cgemul(c, d, F88Z, algo=algo)
    for g, w in ((got.real, want.real), (got.imag, want.imag)):
        assert g.fmt == w.fmt and torch.equal(g.data.cpu(), w.data)


@pytest.mark.parametrize("m,k,n", [
    (129, 256, 127), (127, 256, 129), (1, 1, 1),
    (130, 16, 129), (130, 32, 129), (130, 48, 129), (130, 4112, 129),
    (130, 1, 129), (130, 777, 129), (130, 1003, 129)])
def test_k1_tile_and_k_edges_match_plain(cuda, m, k, n):
    """K1's tensor-core route one past and one short of its 128 x 128 output
    tile, and at K that TMA reads in place or through the zero-padded
    copy."""
    a = _raws(m + k, FA, (m, k), np.int8).to(cuda)
    b = _raws(n + k, FA, (k, n), np.int8).to(cuda)
    assert k1_route(a) == ("direct" if k % 16 == 0 else "padded")
    for out in (MID, qt.qformat(8, 10)):
        got = fused_int8_gemm(a, b, 8, out)
        want = fused_int8_gemm_plain(a, b, 8, out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, k, n, out)
    assert torch.equal(int_dot(a, kmajor(b)), int_dot_plain(a, b))


@pytest.mark.parametrize("m,k,n", [
    (256, 512, 256), (129, 256, 127), (130, 1003, 129), (1, 1, 1),
    (300, 4112, 384), (130, 16, 144)])
@pytest.mark.parametrize("w,out_bytes", [(8, 1), (8, 2), (8, 4), (4, 1),
                                         (1, 2)])
def test_k1_table_matches_plain(cuda, m, k, n, w, out_bytes):
    """K1's table instantiation, Δ=0 to its plain version: tiles one past
    and one short of 128, K that TMA reads in place or through the padded
    copy, rows the 16-byte store takes (n · out_bytes a multiple of 16)
    and rows it does not, tables of 2^w entries holding the lane's
    extremes, stored in 1, 2 or 4 bytes; one launch, counted in
    ``launches`` and ``lut_launches``."""
    rng = np.random.RandomState(m + k + n + w + out_bytes)
    a = _raws(m + k, FA, (m, k), np.int8)
    b = _raws(n + k, FA, (k, n), np.int8)
    fmt = qt.qformat(w - 1, 0, round_mode=qt.RoundMode.RND_CONV)
    lane = {1: torch.int8, 2: torch.int16, 4: torch.int32}[out_bytes]
    info = torch.iinfo(lane)
    entries = rng.randint(info.min, info.max, 1 << w, dtype=np.int64)
    entries[0], entries[-1] = info.min, info.max
    lut = torch.from_numpy(entries).to(torch.int32)
    rq = qt._build.rq_args(8, fmt)
    fused_int8_gemm.launches = fused_int8_gemm.lut_launches = 0
    got = torch.ops.qublas.fused_gemm_s8(a.to(cuda), b.to(cuda), rq,
                                         out_bytes, lut.to(cuda))
    torch.cuda.synchronize()
    assert (fused_int8_gemm.launches, fused_int8_gemm.lut_launches) == (1, 1)
    want = torch.ops.qublas.fused_gemm_s8(a, b, rq, out_bytes, lut)
    assert got.dtype == want.dtype == lane
    assert torch.equal(got.cpu(), want), (m, k, n, w, out_bytes)


def test_pipeline_takes_k1_table_once_a_block(cuda):
    """A pipeline block on the card: two K1 launches, the first with the
    composed ROM and cast in its epilogue, and the CPU's bits."""
    x = _raws(5, FA, (300, 256), np.int8)
    w1 = _raws(6, FA, (256, 384), np.int8).numpy()
    w2 = _raws(7, FA, (384, 200), np.int8).numpy()
    pipe = qt.QuantPipeline.from_numpy(w1, w2, cuda)
    assert pipe.rom.device == cuda
    fused_int8_gemm.launches = fused_int8_gemm.lut_launches = 0
    y = pipe(x.to(cuda))
    torch.cuda.synchronize()
    assert (fused_int8_gemm.launches, fused_int8_gemm.lut_launches) == (2, 1)
    want = qt.QuantPipeline.from_numpy(w1, w2, "cpu")(x)
    assert torch.equal(y.cpu(), want)


@pytest.mark.parametrize("start,stop,routes", [
    (0, 544, ("direct", "direct")), (16, 544, ("direct", "direct")),
    (1, 529, ("copy", "copy")), (1, 528, ("padded", "padded"))])
def test_int_dot_on_views_matches_plain(cuda, start, stop, routes):
    """Views of wider tensors: at column 16 TMA reads them in place; one
    byte past 16-byte alignment they take a K-major copy."""
    a = _raws(1, FA, (300, 544), np.int8).to(cuda)
    bk = kmajor(_raws(2, FA, (544, 301), np.int8).to(cuda))
    x, y = a[:, start:stop], bk[start:stop]
    assert (k1_route(x), k1_route(y.t())) == routes
    got = int_dot(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got, int_dot_plain(x, y))
    assert torch.equal(int_dot(x, y.contiguous()), got)


@pytest.mark.parametrize("k", [1, 13, 16, 17, 1000, 2048])
@pytest.mark.parametrize("m,n", [(1, 1), (63, 65), (65, 63), (200, 200)])
def test_k2_tile_edges_match_plain(cuda, m, k, n):
    """The tiled K2 at its block-tile and micro-tile edges and around its
    16-deep k-slices, on the canonical plan's compiled modes."""
    a = _raws(m + k, F88Z, (m, k), np.int32).to(cuda)
    b = _raws(n + k, F88Z, (k, n), np.int32).to(cuda)
    plan = plan_tree(F88Z, F88Z, qt.mul_merge(F88Z, F88Z), (), k, F88Z)
    assert k2_modes(plan) == 1
    got = tree_gemm(a, b, plan, F88Z)
    want = tree_gemm_plain(a, b, plan, F88Z)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("config,k", [
    ("i32", 13), ("i32", 1000), ("layered", 17), ("layered", 1000),
    ("canonical", 4112), ("i32", 4112), ("layered", 4112)])
def test_k2_routes_and_instantiations_match_plain(cuda, config, k):
    """The i32 product route and the layered formats (modes read at run
    time), and k past 4096 (the 32-slot stack, TOP = 32) with the modes
    compiled and read at run time."""
    f = qt.qformat(3, 4, round_mode=qt.RoundMode.RND_CONV,
                   overflow_mode=qt.OverflowMode.WRP_TCPL) \
        if config == "i32" else F88Z
    layers = LAYERS if config == "layered" else ()
    a = _raws(k, f, (63, k), np.int32).to(cuda)
    b = _raws(k + 1, f, (k, 65), np.int32).to(cuda)
    plan = plan_tree(f, f, qt.mul_merge(f, f), layers, k, f)
    assert k2_modes(plan) == (1 if config == "canonical" else 0)
    got = tree_gemm(a, b, plan, f)
    want = tree_gemm_plain(a, b, plan, f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


I32F = qt.qformat(3, 4, round_mode=qt.RoundMode.RND_CONV,
                  overflow_mode=qt.OverflowMode.WRP_TCPL)


@pytest.mark.parametrize("k", [1, 13, 16, 17, 1000, 2048])
@pytest.mark.parametrize("m,n", [(1, 1), (63, 65), (65, 63), (200, 200)])
def test_k2s_tile_edges_match_plain(cuda, m, k, n):
    """K2′ at its block-tile and micro-tile edges and around its 32-deep
    k-slices, on the canonical plan's compiled steps; k and n off a
    multiple of 4 take the pitched copy."""
    a = _raws(m + k, F88Z, (m, k), np.int32).to(cuda)
    b = _raws(n + k, F88Z, (k, n), np.int32).to(cuda)
    plan = plan_tree(F88Z, F88Z, qt.mul_merge(F88Z, F88Z), (), k, F88Z)
    assert k2s_plan(plan) == 1
    tree_gemm_stream.launches = 0
    got = tree_gemm_stream(a, b, plan, F88Z)
    want = tree_gemm_stream_plain(a, b, plan, F88Z)
    torch.cuda.synchronize()
    assert tree_gemm_stream.launches == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("config,k", [
    ("i32", 13), ("i32", 1000), ("layered", 17), ("layered", 1000),
    ("canonical", 4112), ("i32", 4112), ("layered", 4112)])
def test_k2s_routes_and_instantiations_match_plain(cuda, config, k):
    """The i32 product route and the layered formats (steps read at run
    time), and k past 4096 (the 32-level stack) with the steps compiled
    and read at run time."""
    f = I32F if config == "i32" else F88Z
    layers = LAYERS if config == "layered" else ()
    a = _raws(k, f, (63, k), np.int32).to(cuda)
    b = _raws(k + 1, f, (k, 65), np.int32).to(cuda)
    plan = plan_tree(f, f, qt.mul_merge(f, f), layers, k, f)
    assert plan.prod_route == ("i32" if config == "i32" else "split")
    assert k2s_plan(plan) == (1 if config == "canonical" else 0)
    got = tree_gemm_stream(a, b, plan, f)
    want = tree_gemm_stream_plain(a, b, plan, f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, tree_gemm(a, b, plan, f))


@pytest.mark.parametrize("what", ["int8 lanes", "view off 16 bytes",
                                  "view at column 4", "transposed"])
def test_k2s_operands_that_take_a_copy_match_plain(cuda, what):
    """Operands in int8 lanes, views whose base or rows TMA cannot read in
    place, and a transposed B: pitched copies (k2s_operand), or the view
    itself where its base and pitch allow."""
    wide_a = _raws(1, F88Z, (70, 300), np.int32).to(cuda)
    wide_b = _raws(2, F88Z, (300, 92), np.int32).to(cuda)
    a, b = wide_a[:, 4:260], wide_b[4:260, :]
    if what == "int8 lanes":
        a, b = a.to(torch.int8), b.to(torch.int8)
        routes = (True, True)
    elif what == "view off 16 bytes":
        a, b = wide_a[:, 1:257], wide_b[1:257, 3:83]
        routes = (True, True)
    elif what == "view at column 4":
        routes = (False, False)
    else:
        b = b.t().contiguous().t()
        routes = (False, True)
    for t, copied in zip((a, b), routes):
        assert (k2s_operand(t)[0].data_ptr() != t.data_ptr()) == copied
    f = F88Z
    plan = plan_tree(f, f, qt.mul_merge(f, f), (), a.shape[1], f)
    got = tree_gemm_stream(a, b, plan, f)
    want = tree_gemm_stream_plain(a, b, plan, f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# The 64-bit "pair" product route: 25-bit lanes whose products need 50 bits
F12Z = qt.qformat(12, 12, round_mode=qt.RoundMode.TRN_TCPL,
                  overflow_mode=qt.OverflowMode.SAT_ZERO)


@pytest.mark.parametrize("rm", list(qt.RoundMode))
@pytest.mark.parametrize("om", list(qt.OverflowMode))
def test_pair_route_matches_plain_in_every_mode(cuda, rm, om):
    """K2 (both stack depths), K2′ and P1 (run-time instantiations) on the
    pair product route, with the product requantized in each mode pair and
    the layers saturating, ragged shapes."""
    sat = qt.OverflowMode.SAT_TCPL if om == qt.OverflowMode.WRP_TCPL_SAT \
        else om
    fa = qt.qformat(12, 12, round_mode=rm, overflow_mode=sat)
    fb = qt.qformat(2, 12, round_mode=rm, overflow_mode=sat)
    mul = qt.qformat(12, 12, round_mode=rm, overflow_mode=om)
    layers = (qt.qformat(13, 12, round_mode=rm, overflow_mode=sat),)
    out = qt.qformat(9, 5, signed=False, round_mode=rm, overflow_mode=om)
    for k in (37, 4112):
        a = _raws(k, fa, (33, k), np.int32).to(cuda)
        b = _raws(k + 1, fb, (k, 17), np.int32).to(cuda)
        plan = plan_tree(fa, fb, mul, layers, k, out)
        assert plan.prod_route == "pair" and k2s_plan(plan) == 0
        want = tree_gemm_plain(a, b, plan, out)
        assert torch.equal(tree_gemm(a, b, plan, out), want)
        assert torch.equal(tree_gemm_stream(a, b, plan, out), want)
    x = _raws(3, fa, (16, 33), np.int32).to(cuda)
    y = _raws(4, fb, (16, 33), np.int32).to(cuda)
    assert p1_plan(plan) == 0
    assert torch.equal(chain_probe(x, y, plan, 17, 3),
                       chain_probe_plain(x, y, plan, 17, 3))
    torch.cuda.synchronize()


def test_pair_route_qgemul_launches_k2_in_its_modes_instantiation(cuda):
    """qgemul on Qu<12,12,TRN::TCPL,SAT::ZERO>: the pair product route
    through K2's instantiation with those modes and the 64-bit product
    compiled in (not K2′, slower there), equal to K2′ and to the plain
    version."""
    a = qt.from_raw(_raws(5, F12Z, (100, 300), np.int32).numpy(), F12Z, cuda)
    b = qt.from_raw(_raws(6, F12Z, (300, 70), np.int32).numpy(), F12Z, cuda)
    plan = plan_tree(F12Z, F12Z, qt.mul_merge(F12Z, F12Z), (), 300, F12Z)
    assert plan.prod_route == "pair" and k2_modes(plan) == 2
    tree_gemm.launches = tree_gemm_stream.launches = 0
    got = qt.qgemul(a, b, F12Z)
    torch.cuda.synchronize()
    assert (tree_gemm.launches, tree_gemm_stream.launches) == (1, 0)
    want = tree_gemm_plain(a.data, b.data, plan, F12Z)
    assert torch.equal(got.data, want)
    assert torch.equal(tree_gemm_stream(a.data, b.data, plan, F12Z), want)


@pytest.mark.parametrize("k", [1, 31, 1024, 4095, 4096, 4097,
                               2 ** TT.K2S_TOP2 - 1, 2 ** TT.K2S_TOP2])
def test_canonical_qgemul_takes_k2s_at_every_depth(cuda, k):
    """The canonical plan through qgemul launches K2′ once, below one
    k-slice too, in the compiled instantiation at the stack depth that k
    needs (K2S_TOP below 4096, K2S_TOP2 below 2^K2S_TOP2, MAXL from there),
    equal bit for bit to K2 and to the plain version."""
    a = _raws(k, F88Z, (128, k), np.int32).to(cuda)
    b = _raws(k + 1, F88Z, (k, 64), np.int32).to(cuda)
    plan = plan_tree(F88Z, F88Z, qt.mul_merge(F88Z, F88Z), (), k, F88Z)
    assert k2s_plan(plan) == 1
    tree_gemm.launches = tree_gemm_stream.launches = 0
    tree_gemm_stream.seen.clear()
    with launch_record():
        got = qt.qgemul(qt.QTensor(a, F88Z), qt.QTensor(b, F88Z), F88Z)
    torch.cuda.synchronize()
    assert (tree_gemm.launches, tree_gemm_stream.launches) == (0, 1)
    top = TT.K2S_TOP if k < 4096 else \
        TT.K2S_TOP2 if k < 2 ** TT.K2S_TOP2 else TT.K2S_MAXL
    assert {i for i, _ in tree_gemm_stream.seen} == {
        f"stream_{top}_1/direct/direct" if k % 4 == 0 else
        f"stream_{top}_1/pitched/direct"}
    assert torch.equal(got.data, tree_gemm(a, b, plan, F88Z))
    assert torch.equal(got.data, tree_gemm_plain(a, b, plan, F88Z))


@pytest.mark.parametrize("config", ["layered", "i32"])
def test_run_time_plans_keep_k2_in_qgemul(cuda, config):
    """Plans whose steps K2′ reads at run time stay on K2 in qgemul, at any
    size."""
    fmt, layers = {"layered": (F88Z, LAYERS), "i32": (I32F, ())}[config]
    a = qt.from_raw(_raws(7, fmt, (256, 300), np.int32).numpy(), fmt, cuda)
    b = qt.from_raw(_raws(8, fmt, (300, 256), np.int32).numpy(), fmt, cuda)
    plan = plan_tree(fmt, fmt, qt.mul_merge(fmt, fmt), layers, 300, fmt)
    assert k2s_plan(plan) == 0
    tree_gemm.launches = tree_gemm_stream.launches = 0
    got = qt.qgemul(a, b, fmt, add_formats=layers)
    torch.cuda.synchronize()
    assert (tree_gemm.launches, tree_gemm_stream.launches) == (1, 0)
    assert torch.equal(got.data, tree_gemm_plain(a.data, b.data, plan, fmt))


def test_pair_storage_on_the_card_matches_cpu(cuda):
    """Pair storage end to end on the card: the lossless wide tier (K1's
    segment dots), the streaming tier and the pair elementwise ops, each
    equal to the same call on CPU copies."""
    from qublas_tpu_torch.ops import gemm as TG

    f58 = qt.qformat(5, 8)
    a = qt.from_raw(_raws(7, f58, (40, 200), np.int16).numpy(), f58, cuda)
    b = qt.from_raw(_raws(8, f58, (200, 30), np.int16).numpy(), f58, cuda)
    kw = dict(mul_to=qt.qformat(11, 16), add_formats=(qt.qformat(22, 16),))
    for tiers_off, launches in (((), 2), (("limb",), 2 * 7)):
        # the limb tier: one digit dot an output; the int64 wide tier: one
        # K1 segment dot a 31 products, 200 = 6 x 31 + 14
        fused_int8_gemm.launches = 0
        with TG.force_tiers_off(*tiers_off):
            for out in (qt.qformat(23, 8), qt.qformat(31, 16)):
                got = qt.qgemul(a, b, out, **kw)
                cpu = qt.qgemul(a.to("cpu"), b.to("cpu"), out, **kw)
                assert got.fmt == cpu.fmt and \
                    torch.equal(got.data.cpu(), cpu.data)
        assert fused_int8_gemm.launches == launches
    f88 = qt.qformat(8, 8)
    x = qt.from_raw(_raws(9, f88, (20, 48), np.int32).numpy(), f88, cuda)
    y = qt.from_raw(_raws(10, f88, (48, 12), np.int32).numpy(), f88, cuda)
    kw = dict(add_formats=(qt.qformat(24, 16),), mul_full_prec=True)
    with TG.stream_gate(0):
        got = qt.qgemul(x, y, f88, **kw)
        cpu = qt.qgemul(x.to("cpu"), y.to("cpu"), f88, **kw)
    assert torch.equal(got.data.cpu(), cpu.data)
    p = qt.qmul(x, x, full_prec=True)
    assert p.is_pair and p.device == x.device
    for r in (p + p, p - x, qt.qdiv(p, x), -p, abs(p),
              qt.qcast(p, qt.qformat(30, 3)), qt.qcmp(p, x)):
        data = r.data if hasattr(r, "fmt") else r
        assert data.device == x.device
    pc, xc = p.to("cpu"), x.to("cpu")
    for got, cpu in ((p + p, pc + pc), (qt.qdiv(p, x), qt.qdiv(pc, xc)),
                     (qt.qreduce(p, (qt.qformat(40, 16),), axis=1),
                      qt.qreduce(pc, (qt.qformat(40, 16),), axis=1))):
        assert got.fmt == cpu.fmt and torch.equal(got.data.cpu(), cpu.data)


# ---------------------------------------------------------------------------
# limb storage (65..992-bit formats): plain torch on the card, the digit
# dots on K1
# ---------------------------------------------------------------------------

def _limb_same(got, cpu):
    """A card QTensor (or tensor) equals the same call on CPU copies."""
    if hasattr(cpu, "fmt"):
        assert got.fmt == cpu.fmt and got.is_limb == cpu.is_limb
        assert got.device.type == "cuda"
        assert np.array_equal(got.raw(), cpu.raw())
    else:
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("name", ["g1", "g3"])
def test_limb_tier_digit_dots_on_k1_match_plain(cuda, name):
    """``qgemul``'s limb tier on the card: one K1 launch a k-segment an
    output, equal to the CPU and to the same digit dots on
    ``int_dot_plain``."""
    from qublas_tpu_torch.ops import limbdot

    if name == "g1":
        f, mul, add = (qt.qformat(31, 8), qt.qformat(63, 16),
                       qt.qformat(74, 16))
        outs = (add, qt.qformat(40, 8))
    else:
        f, mul, add = (qt.qformat(70, 10), qt.qformat(141, 20),
                       qt.qformat(152, 20))
        outs = (add,)
    a = qt.random_fill((70, 300), f, seed=3, device=cuda)
    b = qt.random_fill((300, 50), f, seed=4, device=cuda)
    for out in outs:
        fused_int8_gemm.launches = 0
        got = qt.qgemul(a, b, out, mul_to=mul, add_formats=(add,))
        torch.cuda.synchronize()
        assert fused_int8_gemm.launches == 1
        _limb_same(got, qt.qgemul(a.to("cpu"), b.to("cpu"), out,
                                  mul_to=mul, add_formats=(add,)))
        limbdot.int_dot = int_dot_plain
        try:
            plain = qt.qgemul(a, b, out, mul_to=mul, add_formats=(add,))
        finally:
            limbdot.int_dot = int_dot
        _limb_same(got, plain.to("cpu"))


def test_limb_dot_takes_a_k1_launch_a_segment(cuda):
    """300-bit operands at k = 3400: two k-segments, two K1 launches,
    equal to the plain digit dots."""
    from qublas_tpu_torch.ops import limbdot, limbint

    f = qt.qformat(299, 0)
    a = qt.random_fill((2, 3400), f, seed=5, device=cuda)
    b = qt.random_fill((3400, 3), f, seed=6, device=cuda)
    iv = limbdot.Interval(f.raw_min, f.raw_max)
    Kw = limbint.bits_to_limbs(limbdot.work_bits(iv, iv, 3400))
    fused_int8_gemm.launches = 0
    got = limbdot.limb_dot_2d(a.data, b.data, iv, iv, Kw)
    torch.cuda.synchronize()
    assert fused_int8_gemm.launches == 2
    want = limbdot.limb_dot_2d(a.data.to("cpu"), b.data.to("cpu"), iv, iv,
                               Kw)
    assert torch.equal(got.cpu(), want)


def test_limb_storage_on_the_card_matches_cpu(cuda):
    """The limb elementwise routes, ``qreduce``, ``QTable``, the streaming
    tier in limb values and ``cgemul``'s limb domain on the card, each
    equal to the same call on CPU copies, in every overflow mode."""
    from qublas_tpu_torch.ops import gemm as TG

    f70 = qt.qformat(70, 10, round_mode=qt.RoundMode.RND_CONV)
    u = qt.random_fill((33, 17), f70, seed=7, device=cuda)
    v = qt.random_fill((33, 17), qt.qformat(20, 9), seed=8, device=cuda)
    uc, vc = u.to("cpu"), v.to("cpu")
    assert u.is_limb and u.data.limbs.is_cuda
    cases = [lambda x, y: qt.qmul(x, x, to=qt.qformat(141, 20)),
             lambda x, y: qt.qadd(x, y), lambda x, y: x - y,
             lambda x, y: qt.qdiv(y, x, to=qt.qformat(40, 20)),
             lambda x, y: -x, lambda x, y: abs(x),
             lambda x, y: qt.qcmp(x, y), lambda x, y: qt.qeq(x, x),
             lambda x, y: qt.qreduce(x, (qt.qformat(90, 12),), axis=1),
             lambda x, y: qt.qcast(y, qt.qformat(200, 60))]
    for om in qt.OverflowMode:
        to = qt.qformat(50, 8, round_mode=qt.RoundMode.RND_INF,
                        overflow_mode=om)
        cases.append(lambda x, y, to=to: qt.qmul(x, y, to=to))
        cases.append(lambda x, y, to=to: qt.qcast(x, to))
    for op in cases:
        _limb_same(op(u, v), op(uc, vc))
    table = qt.QTable(np.sqrt, qt.qformat(3, 4), qt.qformat(90, 40))
    x = qt.from_raw(np.arange(-128, 128).reshape(16, 16), qt.qformat(3, 4),
                    cuda)
    _limb_same(table(x), table(x.to("cpu")))
    fs = qt.qformat(70, 10, round_mode=qt.RoundMode.TRN_TCPL,
                    overflow_mode=qt.OverflowMode.SAT_ZERO)
    a = qt.random_fill((4, 70), fs, seed=9, device=cuda)
    b = qt.random_fill((70, 3), fs, seed=10, device=cuda)
    with TG.stream_gate(0):
        _limb_same(qt.qgemul(a, b, fs, mul_to=fs, add_formats=(fs,)),
                   qt.qgemul(a.to("cpu"), b.to("cpu"), fs, mul_to=fs,
                             add_formats=(fs,)))
    f = qt.qformat(31, 8)
    w = qt.qformat(63, 16)
    tags = dict(ac=w, bd=w, ad=w, bc=w, acbd=qt.qformat(64, 16),
                adbc=qt.qformat(64, 16))
    rng = np.random.RandomState(11)
    parts = [rng.randint(f.raw_min, f.raw_max + 1, size=s)
             for s in ((20, 40), (20, 40), (40, 10), (40, 10))]
    ca = qt.complex_from_raw(parts[0], parts[1], f, device=cuda)
    cb = qt.complex_from_raw(parts[2], parts[3], f, device=cuda)
    info = {}
    fused_int8_gemm.launches = 0
    got = cgemm._fast_cgemul(ca, cb, None, None, "basic",
                             (qt.qformat(74, 16),), (qt.qformat(74, 16),),
                             tags, info=info)
    torch.cuda.synchronize()
    assert info == {"domain": "limb"} and fused_int8_gemm.launches == 4
    want = qt.cgemul(ca.to("cpu"), cb.to("cpu"), None, algo="basic",
                     add_formats=(qt.qformat(74, 16),), **tags)
    _limb_same(got.real, want.real)
    _limb_same(got.imag, want.imag)



# ---------------------------------------------------------------------------
# lane completion: broadcast batches on K1 and K2, qapprox and the
# bitwise ops on the card
# ---------------------------------------------------------------------------

def test_folded_broadcast_batch_is_one_launch(cuda):
    """A 3-D activation against a 2-D weight folds into one K1 (lossless)
    or K2 (tree) launch, equal to the 2-D call on the folded rows; a
    batched B against a 2-D A launches once a batch element."""
    x = _raws(20, FA, (4, 64, 96), np.int8).to(cuda)
    w = _raws(21, FA, (96, 80), np.int8).to(cuda)
    wb = _raws(22, FA, (3, 96, 80), np.int8).to(cuda)
    kw = dict(mul_to=WIDE, add_formats=(WIDE,))
    fused_int8_gemm.launches = 0
    got = qt.qgemul(qt.QTensor(x, FA), qt.QTensor(w, FA), MID, **kw)
    torch.cuda.synchronize()
    assert fused_int8_gemm.launches == 1
    flat = qt.qgemul(qt.QTensor(x.reshape(-1, 96), FA), qt.QTensor(w, FA),
                     MID, **kw)
    assert torch.equal(got.data.reshape(-1, 80), flat.data)
    fused_int8_gemm.launches = 0
    per = qt.qgemul(qt.QTensor(x[0], FA), qt.QTensor(wb, FA), MID, **kw)
    torch.cuda.synchronize()
    assert fused_int8_gemm.launches == 3
    for i in range(3):
        assert torch.equal(per.data[i], qt.qgemul(
            qt.QTensor(x[0], FA), qt.QTensor(wb[i], FA), MID, **kw).data)
    a = qt.from_raw(_raws(23, F88Z, (2, 3, 40, 70), np.int32).numpy(), F88Z,
                    cuda)
    b = qt.from_raw(_raws(24, F88Z, (70, 50), np.int32).numpy(), F88Z, cuda)
    tree_gemm.launches = tree_gemm_stream.launches = 0
    c = qt.qgemul(a, b, F88Z)
    torch.cuda.synchronize()
    assert (tree_gemm.launches, tree_gemm_stream.launches) == (0, 1)
    c2 = qt.qgemul(qt.QTensor(a.data.reshape(-1, 70), F88Z), b, F88Z)
    assert torch.equal(c.data.reshape(-1, 50), c2.data)
    c_cpu = qt.qgemul(a.to("cpu"), b.to("cpu"), F88Z)
    assert torch.equal(c.data.cpu(), c_cpu.data)


def test_batched_qgemv_is_one_launch(cuda):
    a = qt.from_raw(_raws(25, FA, (200, 96), np.int8).numpy(), FA, cuda)
    x = qt.from_raw(_raws(26, FA, (2, 8, 96), np.int8).numpy(), FA, cuda)
    kw = dict(mul_to=WIDE, add_formats=(WIDE,))
    fused_int8_gemm.launches = 0
    y = qt.qgemv(a, x, MID, **kw)
    torch.cuda.synchronize()
    assert fused_int8_gemm.launches == 1 and y.shape == (2, 8, 200)
    y_cpu = qt.qgemv(a.to("cpu"), x.to("cpu"), MID, **kw)
    assert torch.equal(y.data.cpu(), y_cpu.data)


@pytest.mark.parametrize("kind", ["lane", "pair", "limb"])
def test_qapprox_on_the_card_matches_cpu(cuda, kind):
    fx = {"lane": qt.qformat(3, 4), "pair": qt.qformat(31, 8),
          "limb": qt.qformat(80, 40)}[kind]
    fc = {"lane": qt.qformat(6, 6), "pair": qt.qformat(20, 12),
          "limb": qt.qformat(90, 30)}[kind]
    x = qt.random_fill((64, 33), fx, seed=27, device=cuda)
    c = [qt.scalar(v, fc, cuda) for v in (0.75, -1.5, 0.25)]
    segs = [qt.Segment(-1000.0, c[:1]), qt.Segment(0.0, c[:2]),
            qt.Segment(1.0, c[2:]), qt.Segment(1e12, c)]
    got = qt.qapprox(x, segs)
    segs_cpu = [qt.Segment(s.breakpoint, [t.to("cpu") for t in s.coeffs])
                for s in segs]
    want = qt.qapprox(x.to("cpu"), segs_cpu)
    assert got.device.type == "cuda" and got.fmt == want.fmt
    assert np.array_equal(got.raw(), want.raw())


def test_bitwise_on_the_card_matches_cpu(cuda):
    """``qnot`` on limbs keeps each limb a 32-bit value; the mixes of lane,
    pair and limb operands equal the CPU."""
    u = qt.random_fill((40, 30), qt.qformat(50, 29), seed=28, device=cuda)
    p = qt.random_fill((40, 30), qt.qformat(30, 9), seed=29, device=cuda)
    ln = qt.random_fill((40, 30), qt.qformat(3, 4), seed=30, device=cuda)
    n = qt.bitwise.qnot(u)
    assert int(n.data.limbs.min()) >= 0
    assert int(n.data.limbs.max()) <= 0xFFFFFFFF
    assert np.array_equal(n.raw(), qt.bitwise.qnot(u.to("cpu")).raw())
    for op in (qt.bitwise.qand, qt.bitwise.qor, qt.bitwise.qxor):
        for x, y in ((ln, p), (p, u), (ln, u)):
            got = op(x, y)
            assert got.device.type == "cuda"
            assert np.array_equal(got.raw(),
                                  op(x.to("cpu"), y.to("cpu")).raw())


# the hybrid tier's configurations: the JAX package's (s = 16 at k = 16t,
# s = 8 at k = 8 mod 16), one whose lossless prefix shifts (dl = 2, s = 8),
# one with a fifth lossless layer (s = 32), and the JAX package's with a
# top layer that rounds (RND::CONV), saturates (SAT::TCPL) or wraps
# (WRP::TCPL), whose tail modes no instantiation compiles in
HYB_FA = qt.qformat(3, 4)
HYB_SZ = qt.qformat(6, 4, overflow_mode=qt.OverflowMode.SAT_ZERO)
HYB_TOPS = {
    "conv": qt.qformat(6, 4, round_mode=qt.RoundMode.RND_CONV,
                       overflow_mode=qt.OverflowMode.SAT_ZERO),
    "sat": qt.qformat(6, 4, overflow_mode=qt.OverflowMode.SAT_TCPL),
    "wrap": qt.qformat(6, 4, overflow_mode=qt.OverflowMode.WRP_TCPL)}
HYBRID = {
    "base": (qt.qformat(7, 8),
             (qt.qformat(8, 8), qt.qformat(9, 8), qt.qformat(10, 8),
              qt.qformat(11, 8), HYB_SZ),
             qt.qformat(5, 4)),
    "dl": (qt.qformat(7, 10),
           (qt.qformat(8, 11), qt.qformat(9, 12), qt.qformat(10, 12),
            qt.qformat(5, 6, overflow_mode=qt.OverflowMode.SAT_ZERO)),
           qt.qformat(5, 5)),
    "s32": (qt.qformat(7, 8),
            (qt.qformat(8, 8), qt.qformat(9, 8), qt.qformat(10, 8),
             qt.qformat(11, 8), qt.qformat(12, 8), HYB_SZ),
            qt.qformat(5, 4)),
}
HYBRID.update({name: (qt.qformat(7, 8), HYBRID["base"][1][:4] + (top,),
                      qt.qformat(5, 4))
               for name, top in HYB_TOPS.items()})


def _hybrid_case(config, k):
    mul, layers, out = HYBRID[config]
    mul_fmt = qt.mul_merge(HYB_FA, HYB_FA, mul)
    hp = TT.plan_hybrid(HYB_FA, HYB_FA, mul_fmt, layers, k, out)
    tp = plan_tree(HYB_FA, HYB_FA, mul_fmt, layers, k, out)
    assert hp is not None and tp is not None
    return hp, tp, out


def _k2h_counts():
    h = TT.tree_gemm_hybrid
    return h.launches, h.mma_launches, h.digit_launches


def _k2h_both(a, b, hp, tp, out):
    """K2h on int8 ``a``, ``b`` (one launch of the tensor-core kernel),
    held to its plain version, to the digit kernels on int16 and int32
    copies of the same operands (one launch each) and to K2 on
    ``plan_tree``."""
    h = TT.tree_gemm_hybrid
    h.launches = h.mma_launches = h.digit_launches = 0
    got = TT.tree_gemm_hybrid(a, b, hp, out)
    torch.cuda.synchronize()
    assert _k2h_counts() == (1, 1, 0)
    assert TT.k2h_route(a, b) == "mma"
    assert torch.equal(got, TT.tree_gemm_hybrid_plain(a, b, hp, out))
    for i, lane in enumerate((torch.int16, torch.int32)):
        x, y = a.to(lane), b.to(lane)
        assert TT.k2h_route(x, y) == "digits"
        dig = TT.tree_gemm_hybrid(x, y, hp, out)
        torch.cuda.synchronize()
        assert _k2h_counts() == (2 + i, 1, 1 + i)
        assert torch.equal(got, dig), lane
    assert torch.equal(got, tree_gemm(a, b, tp, out))
    return got


@pytest.mark.parametrize("config,k,s", [
    ("base", 48, 16), ("base", 176, 16), ("base", 2040, 8),
    ("base", 2048, 16), ("base", 4096, 16), ("dl", 96, 8), ("dl", 2048, 8),
    ("s32", 96, 32), ("s32", 2048, 32), ("conv", 2040, 8),
    ("conv", 2048, 16), ("sat", 2040, 8), ("sat", 2048, 16),
    ("wrap", 2040, 8), ("wrap", 2048, 16)])
@pytest.mark.parametrize("m,n", [(1, 1), (63, 65), (200, 33)])
def test_k2h_matches_plain_and_k2(cuda, config, k, s, m, n):
    """K2h's tensor-core kernel (s = 8, 16 and 32, dl > 0, up to 256 block
    values, 9 levels of slots, ragged tiles and unaligned B rows; the tail's
    modes compiled in, or read at run time where the top layer rounds,
    saturates or wraps otherwise) equals its plain version on the card and
    on the CPU, the digit kernels on int16 and int32 copies of the same
    operands, and K2 on ``plan_tree`` of the same configuration."""
    hp, tp, out = _hybrid_case(config, k)
    assert hp.s == s and (hp.dl > 0) == (config == "dl")
    assert (TT.k2h_modes(hp, k) == 0) == (config in HYB_TOPS)
    a = _raws(m + k, HYB_FA, (m, k), np.int8).to(cuda)
    b = _raws(n + k, HYB_FA, (k, n), np.int8).to(cuda)
    got = _k2h_both(a, b, hp, tp, out)
    assert torch.equal(got.cpu(), TT.tree_gemm_hybrid(a.cpu(), b.cpu(), hp,
                                                       out))


@pytest.mark.parametrize("config,k", [("base", 2048), ("base", 2040),
                                      ("dl", 2048), ("s32", 2048)])
def test_k2h_every_raw_at_the_int8_minimum(cuda, config, k):
    """Every raw at -128: the largest block dots (s 2^14) and the tail's
    saturation, on the int8 and the digit kernels and K2."""
    hp, tp, out = _hybrid_case(config, k)
    a = torch.full((70, k), -128, dtype=torch.int8, device=cuda)
    b = torch.full((k, 40), -128, dtype=torch.int8, device=cuda)
    _k2h_both(a, b, hp, tp, out)


def test_k2h_mma_pitched_and_unaligned_operands(cuda):
    """The tensor-core kernel reads row-pitched views in place and stages
    operands whose base or pitch is off 16, 8 or 4 bytes (narrower copies,
    then byte loads): all equal the plain version."""
    hp, _, out = _hybrid_case("base", 176)
    big_a = _raws(1, HYB_FA, (90, 200), np.int8).to(cuda)
    big_b = _raws(2, HYB_FA, (180, 77), np.int8).to(cuda)
    for a, b in ((big_a[:, :176], big_b[:176, :64]),     # pitched
                 (big_a[3:, 1:177], big_b[2:178, 3:40]),  # off 1 byte
                 (big_a[:, 8:184], big_b[:176, 4:68]),    # off 8 and 4
                 (big_a[:64, :176].t().contiguous().t(), big_b[:176, :5])):
        TT.tree_gemm_hybrid.mma_launches = 0
        got = TT.tree_gemm_hybrid(a, b, hp, out)
        torch.cuda.synchronize()
        assert TT.tree_gemm_hybrid.mma_launches == 1
        assert torch.equal(got, TT.tree_gemm_hybrid_plain(a, b, hp, out))


def test_hybrid_qgemul_is_one_k2h_launch(cuda):
    """``qgemul`` on a hybrid configuration launches K2h once and no K2,
    a folded activation batch too; the results equal the CPU's."""
    mul, layers, out = HYBRID["base"]
    a = qt.from_raw(_raws(31, HYB_FA, (2, 40, 176), np.int8).numpy(),
                    HYB_FA, cuda)
    b = qt.from_raw(_raws(32, HYB_FA, (176, 50), np.int8).numpy(), HYB_FA,
                    cuda)
    for x in (a[0], a):
        TT.tree_gemm_hybrid.launches = tree_gemm.launches = 0
        got = qt.qgemul(x, b, out, mul_to=mul, add_formats=layers)
        torch.cuda.synchronize()
        assert (TT.tree_gemm_hybrid.launches, tree_gemm.launches) == (1, 0)
        want = qt.qgemul(x.to("cpu"), b.to("cpu"), out, mul_to=mul,
                         add_formats=layers)
        assert torch.equal(got.data.cpu(), want.data)


def test_hybrid_qgemul_int8_is_one_mma_launch_and_no_copy(cuda):
    """An int8 ``qgemul`` on the hybrid tier runs one kernel on the card:
    the tensor-core K2h, with no widening or transposing copy of either
    operand (the profiler's kernel list)."""
    from torch.profiler import ProfilerActivity, profile

    mul, layers, out = HYBRID["base"]
    a = qt.from_raw(_raws(33, HYB_FA, (256, 512), np.int8).numpy(), HYB_FA,
                    cuda)
    b = qt.from_raw(_raws(34, HYB_FA, (512, 256), np.int8).numpy(), HYB_FA,
                    cuda)
    qt.qgemul(a, b, out, mul_to=mul, add_formats=layers)  # build, warm up
    torch.cuda.synchronize()
    TT.tree_gemm_hybrid.launches = TT.tree_gemm_hybrid.mma_launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = qt.qgemul(a, b, out, mul_to=mul, add_formats=layers)
        torch.cuda.synchronize()
    assert (TT.tree_gemm_hybrid.launches,
            TT.tree_gemm_hybrid.mma_launches) == (1, 1)
    kernels = [e.key for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0]
    assert len(kernels) == 1 and "tree_gemm_hybrid_mma_kernel" in \
        kernels[0], kernels
    want = qt.qgemul(a.to("cpu"), b.to("cpu"), out, mul_to=mul,
                     add_formats=layers)
    assert torch.equal(got.data.cpu(), want.data)


def test_hybrid_qgemul_int16_takes_the_digit_kernel(cuda):
    """A hybrid configuration on int16 lanes (``Qu<5,6>`` operands) takes
    the digit kernel, once, equal to the CPU and to K2."""
    sz = qt.OverflowMode.SAT_ZERO
    fa = qt.qformat(5, 6)
    mul = qt.qformat(11, 12)
    layers = (qt.qformat(12, 12), qt.qformat(13, 12), qt.qformat(14, 12),
              qt.qformat(15, 12), qt.qformat(10, 6, overflow_mode=sz))
    out = qt.qformat(7, 6)
    a = qt.from_raw(_raws(35, fa, (100, 176), np.int16).numpy(), fa, cuda)
    b = qt.from_raw(_raws(36, fa, (176, 70), np.int16).numpy(), fa, cuda)
    assert a.data.dtype == torch.int16
    h = TT.tree_gemm_hybrid
    h.launches = h.mma_launches = h.digit_launches = 0
    with launch_record():     # the launch noted in h.seen
        got = qt.qgemul(a, b, out, mul_to=mul, add_formats=layers)
    torch.cuda.synchronize()
    assert _k2h_counts() == (1, 0, 1)
    assert any(i.startswith("digits2_") for i, _ in h.seen)
    want = qt.qgemul(a.to("cpu"), b.to("cpu"), out, mul_to=mul,
                     add_formats=layers)
    assert torch.equal(got.data.cpu(), want.data)
    tp = plan_tree(fa, fa, qt.mul_merge(fa, fa, mul), layers, 176, out)
    assert torch.equal(got.data, tree_gemm(a.data, b.data, tp, out))


# the digit kernels' configurations: (fa, fb, mul_to, layers, out), as
# tests/test_torch_hybrid.py:DIGIT_CONFIGS
_DSZ = qt.OverflowMode.SAT_ZERO
DIGITS = {
    "i16": (qt.qformat(5, 6), qt.qformat(5, 6), qt.qformat(11, 12),
            (qt.qformat(12, 12), qt.qformat(13, 12), qt.qformat(14, 12),
             qt.qformat(15, 12), qt.qformat(10, 6, overflow_mode=_DSZ)),
            qt.qformat(7, 6)),
    "i16xi8": (qt.qformat(5, 6), qt.qformat(3, 4), qt.qformat(9, 10),
               (qt.qformat(10, 10), qt.qformat(11, 10), qt.qformat(12, 10),
                qt.qformat(13, 10), qt.qformat(8, 5, overflow_mode=_DSZ)),
               qt.qformat(6, 4)),
    "i32xi8": (qt.qformat(8, 8), qt.qformat(3, 4), qt.qformat(12, 12),
               (qt.qformat(13, 12), qt.qformat(14, 12), qt.qformat(15, 12),
                qt.qformat(16, 12), qt.qformat(10, 6, overflow_mode=_DSZ)),
               qt.qformat(7, 6)),
    "i16xi32": (qt.qformat(4, 4), qt.qformat(8, 8), qt.qformat(13, 12),
                (qt.qformat(14, 12), qt.qformat(15, 12), qt.qformat(16, 12),
                 qt.qformat(17, 12), qt.qformat(10, 6, overflow_mode=_DSZ)),
                qt.qformat(7, 6)),
}


def _lane_of(fmt):
    from qublas_tpu_torch.ops.widths import torch_dtype_for

    return torch_dtype_for(fmt)


@pytest.mark.parametrize("config", sorted(DIGITS))
@pytest.mark.parametrize("k", [48, 176, 2040, 2048])
@pytest.mark.parametrize("full", [False, True], ids=["in", "full"])
@pytest.mark.parametrize("m,n", [(1, 1), (63, 65), (200, 33)])
def test_k2h_digits_match_plain(cuda, config, k, full, m, n):
    """The digit kernels on int16 and int32 lanes and mixed lanes (the
    narrower operand widened), raws inside the formats and over the whole
    lanes (the block dots wrapping mod 2^32): one launch, equal to the
    plain version on the CPU (int64 dots, wrapped) and to the digit
    kernels' plain version there."""
    fa, fb, mul, layers, out = DIGITS[config]
    hp = TT.plan_hybrid(fa, fb, qt.mul_merge(fa, fb, mul), layers, k, out)
    assert hp is not None
    rng = np.random.RandomState(k + m)

    def raws(fmt, shape):
        dt = _lane_of(fmt)
        info = torch.iinfo(dt)
        lo, hi = (info.min, info.max) if full else (fmt.raw_min,
                                                     fmt.raw_max)
        x = rng.randint(lo, hi + 1, shape, dtype=np.int64)
        if full:
            x.flat[:2] = (lo, hi)
        return torch.from_numpy(x).to(dt)
    a, b = raws(fa, (m, k)), raws(fb, (k, n))
    h = TT.tree_gemm_hybrid
    h.launches = h.mma_launches = h.digit_launches = 0
    got = TT.tree_gemm_hybrid(a.to(cuda), b.to(cuda), hp, out)
    torch.cuda.synchronize()
    assert _k2h_counts() == (1, 0, 1)
    want = TT.tree_gemm_hybrid_plain(a, b, hp, out)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, TT.tree_gemm_hybrid(a, b, hp, out))


def test_k2h_digits_pitched_and_unaligned_operands(cuda):
    """The digit kernel reads row-pitched int16 and int32 views in place
    and stages operands whose base or pitch is off 16 or 8 bytes
    (narrower copies, then byte loads): all equal the plain version."""
    hp, _, out = _hybrid_case("base", 176)
    for lane in (torch.int16, torch.int32):
        big_a = _raws(3, HYB_FA, (90, 200), np.int8).to(cuda).to(lane)
        big_b = _raws(4, HYB_FA, (180, 77), np.int8).to(cuda).to(lane)
        for a, b in ((big_a[:, :176], big_b[:176, :64]),     # pitched
                     (big_a[3:, 1:177], big_b[2:178, 3:40]),  # off 2 or 4
                     (big_a[:, 8:184], big_b[:176, 4:68]),    # off 16, 8
                     (big_a[:64, :176].t().contiguous().t(),
                      big_b[:176, :5])):
            TT.tree_gemm_hybrid.digit_launches = 0
            got = TT.tree_gemm_hybrid(a, b, hp, out)
            torch.cuda.synchronize()
            assert TT.tree_gemm_hybrid.digit_launches == 1
            assert torch.equal(got, TT.tree_gemm_hybrid_plain(a, b, hp, out))
def test_host_storage_on_the_card_machine(cuda):
    """The native engine builds; host tensors keep the card as their
    results' device, so a host op whose result fits a lane lands on the
    card; the host GEMM of wart raws against card lanes returns a pair on
    the card, equal to the host golden model; ``from_float`` through the
    engine equals the CPU's."""
    from qublas_tpu_torch import native

    assert native.available()
    h = qt.random_fill((8, 8), qt.qformat(600, 600), seed=33, device=cuda)
    assert h.is_host and h.device == cuda
    f20 = qt.qformat(20, 8)
    lane = qt.qcast(h, f20)
    assert not lane.is_host and lane.device == cuda
    assert np.array_equal(lane.raw(), qt.qcast(h.to("cpu"), f20).raw())
    w = qt.qformat(31, 0)
    ar = np.random.RandomState(34).randint(w.raw_min, w.raw_max + 1,
                                           (16, 24)).astype(object)
    ar[::5] += 1 << 40
    a = qt.from_raw(ar, w, cuda)
    b = qt.random_fill((24, 8), w, seed=35, device=cuda)
    out = qt.qformat(62, 0)
    g = qt.qgemul(a, b, out, mul_to=out, add_formats=(out,))
    assert a.is_host and g.device == cuda and g.is_pair
    assert np.array_equal(g.raw(), qt.host_qgemul(a, b, out, mul_to=out,
                                                  add_formats=(out,)))
    x = np.random.RandomState(36).randn(64, 64) * 4
    got = qt.from_float(x, HYB_FA, cuda)
    assert got.device == cuda
    assert np.array_equal(got.raw(), qt.from_float(x, HYB_FA, "cpu").raw())


def _shard_cases(world):
    """mn, k (psum and reduce-scatter) and k_tree over a (1, world) mesh,
    as ``parallel.dryrun.run_cases`` takes them, and each one's
    single-device call."""
    rng = np.random.RandomState(40 + world)

    def raws(fmt, shape):
        return rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape)

    a, b = raws(FA, (64, 64 * world)), raws(FA, (64 * world, 32 * world))
    c, d = raws(F88Z, (48, 64)), raws(F88Z, (64, 16 * world))
    e, f = raws(F88Z, (40, 128 * world)), raws(F88Z, (128 * world, 24))
    gk = dict(mul_to=WIDE, add_formats=(WIDE,))
    tk = dict(add_formats=(F88Z,))
    return [
        ("sharded_qgemul_mn", ("q", c, F88Z), ("q", d, F88Z), F88Z, {}),
        ("sharded_qgemul_k", ("q", a, FA), ("q", b, FA), MID, gk),
        ("sharded_qgemul_k", ("q", a, FA), ("q", b, FA), MID,
         dict(gk, reduce_scatter=True)),
        ("sharded_qgemul_k_tree", ("q", e, F88Z), ("q", f, F88Z), F88Z, tk),
        ("sharded_qgemul_k_tree", ("q", e, F88Z), ("q", f, F88Z), F88Z,
         dict(tk, butterfly=False)),
    ]


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_gemm_on_the_card(cuda, world, backend):
    """A world of one on NCCL, and a Gloo world of two ranks on the one
    card: mn, k and k_tree with its kernels on every rank, equal on every
    rank to the single-device call."""
    from qublas_tpu_torch.parallel.dryrun import run_cases
    from qublas_tpu_torch.parallel.launch import run_world

    cases = _shard_cases(world)
    shard = [(fn, (1, world), (x, y, out), kw)
             for fn, x, y, out, kw in cases]
    ranks = run_world(world, backend, run_cases, (shard, "cuda"),
                      timeout=300)
    for i, (fn, x, y, out, kw) in enumerate(cases):
        kw = {k: v for k, v in kw.items()
              if k not in ("reduce_scatter", "butterfly")}
        ref = qt.qgemul(qt.from_raw(x[1], x[2], cuda),
                        qt.from_raw(y[1], y[2], cuda), out, **kw)
        for r, res in enumerate(ranks):
            status, got = res[i]
            assert status == "ok", (fn, r, got)
            _, fmt, raw, _, _ = got
            assert fmt == ref.fmt and np.array_equal(
                raw.astype(np.int64), ref.raw().astype(np.int64)), (fn, r)


def test_pipeline_cuda_graph_replays_on_fresh_inputs(cuda):
    """The pipeline captured eagerly in a ``torch.cuda.CUDAGraph`` (its K1
    launches, the ROM and the cast) replays on two fresh inputs copied into
    its static input, each equal to the eager call, and a replay launches
    no counted kernel: no pointer or TMA descriptor was baked in stale."""
    rng = np.random.RandomState(91)
    w1, w2 = (rng.randint(FA.raw_min, FA.raw_max + 1, (512, 512))
              .astype(np.int8) for _ in range(2))
    pipe = qt.QuantPipeline.from_numpy(w1, w2, cuda)
    static_x = _raws(92, FA, (256, 512), np.int8).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):          # warm-up off the capture
            pipe(static_x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_y = pipe(static_x)
    for seed in (93, 94):
        x = _raws(seed, FA, (256, 512), np.int8).to(cuda)
        static_x.copy_(x)
        fused_int8_gemm.launches = 0
        graph.replay()
        torch.cuda.synchronize()
        assert fused_int8_gemm.launches == 0
        assert torch.equal(static_y, pipe(x)), seed


@pytest.mark.parametrize("k,n,sizes,launches", [
    (7168, 256, [0, 1, 127, 300], 1),
    # 300 groups (two launches of at most 256), a third of them empty
    (96, 200, [(7 * g) % 41 if g % 3 else 0 for g in range(300)], 2)])
def test_grouped_k1_matches_plain(cuda, k, n, sizes, launches):
    """K1's grouped instantiation against its plain version, with and
    without the table: groups of one row, of under and over a tile, empty
    ones; one launch a 256 groups."""
    fa = FA
    offsets = [0]
    for rows in sizes:
        offsets.append(offsets[-1] + rows)
    a = _raws(5, fa, (offsets[-1], k), np.int8).to(cuda)
    b = kmajor(_raws(6, fa, (len(sizes), k, n), np.int8).to(cuda))
    silu = qt.QTable(qt.silu_func, MID, fa)
    for table in (None, silu.table.to(cuda)):
        before = fused_int8_gemm.launches
        got = fused_int8_gemm_grouped(a, b, offsets, 8, MID, table, fa)
        want = fused_int8_gemm_grouped(a.cpu(), b.cpu(), offsets, 8, MID,
                                       None if table is None else
                                       table.cpu(), fa)
        torch.cuda.synchronize()
        assert fused_int8_gemm.launches - before == launches
        assert torch.equal(got.cpu(), want)


def test_moe_layer_at_published_widths(cuda):
    """One DeepSeek-V3 layer at the published widths, its RMSNorm and its
    MoE holding the 32 experts of routing group 0, on 384 rows: the
    reference's output bit for bit; N1 once; K1 once for the router, once
    a projection for the held experts (the grouped instantiation) and for
    the shared expert, the table in the gate projections' epilogue; G1
    twice; C1 once; one host sync."""
    import json
    from pathlib import Path

    from gpubench import inputs
    from gpubench.reference import moe_ffn as ref

    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "gpubench" / "configs" /
                      "dsv3_moe_int8.json").read_text())
    cfg.update(num_hidden_layers=1)
    w, pool = inputs.make(ref, cfg, {"sequences": 1, "seq_len": 384,
                                     "pool": 1}, 2 ** 31 + 3, cuda)
    layer = qt.QuantMoE(
        w["wr"][0].t(), w["bias"][0], w["wg"][0].transpose(1, 2),
        w["wu"][0].transpose(1, 2), w["wd"][0].transpose(1, 2),
        w["sg"][0].t(), w["su"][0].t(), w["sd"][0].t(), (0, 32))
    norm = qt.QuantRMSNorm(cfg["hidden_size"], cfg["norm_rms"], cuda)
    launches, luts = fused_int8_gemm.launches, fused_int8_gemm.lut_launches
    combines, gates = moe.combine.launches, moe.gated.launches
    norms = moe.rms_norm.launches
    got = layer(norm(pool[0]))
    torch.cuda.synchronize()
    assert moe.rms_norm.launches - norms == 1
    assert fused_int8_gemm.launches - launches == 1 + 3 + 3
    assert fused_int8_gemm.lut_launches - luts == 2
    assert moe.combine.launches - combines == 1
    assert moe.gated.launches - gates == 2
    assert layer.syncs == 1 and 0 < layer.pairs <= 384 * 8
    assert 0 < layer.largest <= 384
    want = ref.forward(pool[0], w, cfg)
    assert torch.equal(got.long(), want)


@pytest.mark.parametrize("rows,n,k,acc,narrow", [
    (300, 7168, 8, False, False), (37, 1000, 3, True, False),
    (64, 515, 5, True, True)])
def test_moe_combine_matches_plain(cuda, rows, n, k, acc, narrow):
    """C1 against its plain scatter-add: random outputs and weights, a
    third of the slots not held; into the output's int8 lane (rounded to
    nearest) and into the int32 accumulator, with the layer's formats, and
    on strided views of the outputs (copies are launched); a rounding pair
    format, a Qu<10,8> accumulator whose sum saturates and a ragged n,
    which C1 does not take, raise on the card."""
    f = dict(qt.moe_formats())
    if narrow:
        f.update(pair=qt.qformat(10, 10, round_mode=qt.RoundMode.RND_CONV),
                 acc=qt.qformat(10, 8))
    g = torch.Generator().manual_seed(rows)
    pairs = rows * k // 2
    shared = qt.QTensor(torch.randint(-2 ** 15, 2 ** 15, (rows, n),
                                      generator=g, dtype=torch.int16),
                        f["down"])
    d = qt.QTensor(torch.randint(-2 ** 15, 2 ** 15, (pairs, n), generator=g,
                                 dtype=torch.int16), f["down"])
    w = qt.QTensor(torch.randint(0, 5 * 4096, (rows, k), generator=g,
                                 dtype=torch.int16), f["weight"])
    pos = torch.randint(-pairs // 2, pairs, (rows, k), generator=g,
                        dtype=torch.int32).clamp_(min=-1)
    out = None if acc else f["out"]
    want = moe.combine(shared, d, pos, w, f["pair"], f["acc"], out)
    launches = moe.combine.launches
    card = [qt.QTensor(t.data.to(cuda), t.fmt) for t in (shared, d)]
    if acc:
        # views one column in: strided and off 16 bytes
        card = [qt.QTensor(torch.nn.functional.pad(t.data, (1, 0))[:, 1:],
                           t.fmt) for t in card]
    args = (*card, pos.to(cuda), qt.QTensor(w.data.to(cuda), w.fmt),
            f["pair"], f["acc"], out)
    if narrow:
        with pytest.raises(ValueError, match="C1 takes"):
            moe.combine(*args)
        return
    got = moe.combine(*args)
    torch.cuda.synchronize()
    assert moe.combine.launches - launches == 1
    assert got.dtype == (torch.int32 if acc else torch.int8)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape,lanes,fmts", [
    ((1000, 2048), (torch.int8, torch.int8), ("gu", "operand")),
    ((37, 41), (torch.int16, torch.int8),
     (qt.qformat(6, 6, round_mode=qt.RoundMode.RND_CONV,
                 overflow_mode=qt.OverflowMode.WRP_TCPL),
      qt.qformat(9, 2, overflow_mode=qt.OverflowMode.SAT_ZERO)))])
def test_gated_matches_plain(cuda, shape, lanes, fmts):
    """G1 against its plain version: int8 lanes in and out with the
    layer's formats (the cast rounded to nearest); int16 times int8 with a
    rounding, wrapping middle format, which G1 does not take, raises on
    the card."""
    f = qt.moe_formats()
    mid, out = (f[x] if isinstance(x, str) else x for x in fmts)
    g = torch.Generator().manual_seed(shape[0])
    a, b = (qt.QTensor(torch.randint(torch.iinfo(t).min,
                                     torch.iinfo(t).max + 1, shape,
                                     generator=g, dtype=t),
                       qt.qformat(8 * t.itemsize - 5, 4))
            for t in lanes)
    want = moe.gated(a, b, mid, out)
    launches = moe.gated.launches
    args = (qt.QTensor(a.data.to(cuda), a.fmt),
            qt.QTensor(b.data.to(cuda), b.fmt), mid, out)
    if lanes[0] != torch.int8:
        with pytest.raises(ValueError, match="G1 takes"):
            moe.gated(*args)
        return
    got = moe.gated(*args)
    torch.cuda.synchronize()
    assert moe.gated.launches - launches == 1
    assert torch.equal(got.data.cpu(), want.data)


@pytest.mark.parametrize("rows,n,rms", [(300, 7168, 0.125), (37, 64, 1.0),
                                        (5, 48, 0.5)])
def test_rms_norm_matches_plain(cuda, rows, n, rms):
    """N1 against its plain version: rows of small, typical and saturated
    raws, a zero row; a strided view (a copy is launched); rows not a
    multiple of 16 wide raise on the card."""
    g = torch.Generator().manual_seed(rows)
    x = torch.randint(-128, 128, (rows, n), generator=g, dtype=torch.int8)
    x[: rows // 3] = x[: rows // 3].clamp(-3, 3)
    x[-1] = 0
    norm = qt.QuantRMSNorm(n, rms)
    want = norm(x)
    card = qt.QuantRMSNorm(n, rms, cuda)
    launches = moe.rms_norm.launches
    got = card(x.to(cuda))
    wide = torch.nn.functional.pad(x.to(cuda), (0, 16))[:, :n]
    assert torch.equal(card(wide).cpu(), want)
    torch.cuda.synchronize()
    assert moe.rms_norm.launches - launches == 2
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="N1 takes"):
        qt.QuantRMSNorm(n - 8, rms, cuda)(x[:, 8:].to(cuda))
