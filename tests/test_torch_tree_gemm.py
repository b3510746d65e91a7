"""The torch port's order-sensitive tree GEMM against the JAX package, Δ=0.

Kernel K2's plain version (``tree_gemm_plain``: ``tree_gemm_scan``'s
schedule as a Python loop on torch tensors) must give the raws of the JAX
package's Pallas kernels in interpret mode (``tree_gemm_blocked``,
``tree_gemm_pallas``), of ``tree_gemm_scan`` and of ``qgemul``, for
power-of-two, odd and ragged k, where the drain has converts and adds.
The K2 kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from qublas_tpu.ops import gemm as JG
from qublas_tpu.ops import tree_gemm as JT
from qublas_tpu.qformat import OverflowMode, RoundMode, mul_merge, qformat
from qublas_tpu.qtensor import from_raw as jfrom_raw
from qublas_tpu_torch.ops import gemm as TG
from qublas_tpu_torch.ops import tree_gemm as TT
from qublas_tpu_torch.qtensor import from_raw

F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
F44 = qformat(4, 4)
LAYERS = (qformat(9, 6, round_mode=RoundMode.RND_CONV), qformat(10, 4))


def _operands(seed, fmt, m, k, n):
    rng = np.random.RandomState(seed)
    A = rng.randint(fmt.raw_min, fmt.raw_max + 1, (m, k))
    B = rng.randint(fmt.raw_min, fmt.raw_max + 1, (k, n))
    return A, B


def _plain(A, B, fmt, plan, out):
    return TT.tree_gemm_plain(from_raw(A, fmt, "cpu").data,
                              from_raw(B, fmt, "cpu").data, plan, out).numpy()


@pytest.mark.parametrize("k,layers", [(64, ()), (128, ()), (128, LAYERS)],
                         ids=["k64", "k128", "k128-layered"])
def test_plain_matches_blocked_interpret(k, layers):
    A, B = _operands(k, F88Z, 128, k, 128)
    mf = mul_merge(F88Z, F88Z)
    jplan = JT.plan_tree(F88Z, F88Z, mf, layers, k, F88Z)
    want = np.asarray(JT.tree_gemm_blocked(
        jfrom_raw(A, F88Z).data, jfrom_raw(B, F88Z).data, jplan, F88Z,
        interpret=True))
    plan = TT.plan_tree(F88Z, F88Z, mf, layers, k, F88Z)
    np.testing.assert_array_equal(_plain(A, B, F88Z, plan, F88Z), want)


def test_plain_matches_slot_stack_kernel_interpret():
    k = 24
    A, B = _operands(24, F88Z, 128, k, 128)
    mf = mul_merge(F88Z, F88Z)
    jplan = JT.plan_tree(F88Z, F88Z, mf, (), k, F88Z)
    want = np.asarray(JT.tree_gemm_pallas(
        jfrom_raw(A, F88Z).data, jfrom_raw(B, F88Z).data, jplan, F88Z,
        interpret=True))
    plan = TT.plan_tree(F88Z, F88Z, mf, (), k, F88Z)
    np.testing.assert_array_equal(_plain(A, B, F88Z, plan, F88Z), want)


@pytest.mark.parametrize("k", [13, 100, 1000])
def test_plain_matches_scan(k):
    A, B = _operands(k, F88Z, 3, k, 5)
    mf = mul_merge(F88Z, F88Z)
    jplan = JT.plan_tree(F88Z, F88Z, mf, (), k, F88Z)
    want = np.asarray(JT.tree_gemm_scan(
        jfrom_raw(A, F88Z).data, jfrom_raw(B, F88Z).data, jplan, F88Z))
    plan = TT.plan_tree(F88Z, F88Z, mf, (), k, F88Z)
    assert plan.drain == jplan.drain
    np.testing.assert_array_equal(_plain(A, B, F88Z, plan, F88Z), want)


@pytest.mark.parametrize("name,k", [
    ("canonical", 13), ("canonical", 100), ("canonical", 1000),
    ("i32-layered", 11), ("i32-layered", 100), ("hybrid-prefix", 64)])
def test_qgemul_tree_tier_matches_jax(name, k):
    """The port's qgemul dispatch into the tree tier against JAX's qgemul,
    which takes its scan tier or, for a lossless prefix, its hybrid tier:
    the same bits."""
    if name == "canonical":
        fa, kw, out = F88Z, {}, F88Z
    elif name == "i32-layered":
        fa, out = F44, qformat(6, 3)
        kw = dict(mul_to=qformat(5, 5, overflow_mode=OverflowMode.SAT_ZERO),
                  add_formats=(qformat(6, 4, round_mode=RoundMode.RND_CONV),
                               qformat(5, 2)))
    else:
        fa, out, lossless = qformat(3, 4), qformat(6, 2), qformat(12, 8)
        kw = dict(mul_to=qformat(10, 8),
                  add_formats=(lossless,) * 3 + (qformat(6, 2),))
        assert JT.plan_hybrid(fa, fa, kw["mul_to"], kw["add_formats"], k,
                              out) is not None
    A, B = _operands(k + 1, fa, 4, k, 6)
    want = JG.qgemul(jfrom_raw(A, fa), jfrom_raw(B, fa), out,
                     use_pallas=False, **kw)
    got = TG.qgemul(from_raw(A, fa, "cpu"), from_raw(B, fa, "cpu"), out, **kw)
    assert got.fmt == want.fmt
    assert got.data.dtype == getattr(torch, str(want.data.dtype))
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_pair_product_route_raises():
    f = qformat(15, 8)
    mf = mul_merge(f, f)
    plan = TT.plan_tree(f, f, mf, (), 4, f)
    assert plan is not None and plan.prod_route == "pair"
    a = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        TT.tree_gemm(a, a.t().contiguous(), plan, f)
