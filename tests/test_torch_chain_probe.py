"""P1, the tree GEMM's per-product probe, against the JAX package, Δ=0.

``chain_probe``'s plain version (the port's ``tree_gemm._product`` and
``_merge`` in a loop on one tile, the tile written ``programs`` times)
against the same loop of the JAX package's ``tree_gemm._product`` and
``_merge`` (the body of ``bench.py:_measured_chain_prods``'s Pallas
kernel), for the canonical plan (split product route) and an i32-route
plan.  The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
