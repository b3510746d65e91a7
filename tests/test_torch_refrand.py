"""The port's copy of the reference RNG (``qublas_tpu_torch.refrand``)
against ``qublas_tpu.refrand``: the same draws on the same seeds, and
``reference_fill``/``reference_shuffle`` tensors equal to the JAX
package's.  The compiled reference's own streams (``fill.json``,
``shuffle.json``) pin the port in ``tests/test_torch_golden.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from qublas_tpu import qtensor as JQ
from qublas_tpu import refrand as JR
from qublas_tpu.qformat import qformat
from qublas_tpu_torch import qtensor as TQ
from qublas_tpu_torch import refrand as TR
from qublas_tpu_torch.convert import port_format as P


def _same(got, want):
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert (got.is_pair, got.is_limb) == (want.is_pair, want.is_limb)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(np.asarray(got.raw(), dtype=object),
                                  np.asarray(want.raw(), dtype=object))


@pytest.mark.parametrize("seed", [1, 5489, 2**32 - 1])
def test_mt19937_draws_match(seed):
    j, t = JR.MT19937(seed), TR.MT19937(seed)
    assert [t() for _ in range(1500)] == [j() for _ in range(1500)]


@pytest.mark.parametrize("a,b", [(0, 0), (0, 1), (0, 6), (3, 1000),
                                 (0, (1 << 32) - 1), (0, 1 << 32),
                                 (0, (1 << 64) - 1),
                                 ((-(1 << 39)) & ((1 << 64) - 1),
                                  (1 << 39) - 1)])
def test_uniform_int_matches(a, b):
    j, t = JR.MT19937(7), TR.MT19937(7)
    assert [TR.uniform_int(t, a, b) for _ in range(200)] == \
        [JR.uniform_int(j, a, b) for _ in range(200)]


@pytest.mark.parametrize("bits", [1, 8, 17, 32, 33, 63, 64, 65, 100, 128,
                                  200, 992])
def test_fill_raw_matches(bits):
    j, t = JR.MT19937(3), TR.MT19937(3)
    assert [TR.fill_raw(t, bits) for _ in range(60)] == \
        [JR.fill_raw(j, bits) for _ in range(60)]


@pytest.mark.parametrize("fmt", [qformat(3, 4), qformat(8, 8),
                                 qformat(30, 9), qformat(100, 40),
                                 qformat(3, 4, signed=False)],
                         ids=["lane8", "lane32", "pair", "limb", "unsigned"])
def test_reference_fill_and_shuffle_match(fmt):
    jt = JR.reference_fill((4, 5), fmt, gen=JR.MT19937(11))
    tt = TR.reference_fill((4, 5), P(fmt), gen=TR.MT19937(11), device="cpu")
    _same(tt, jt)
    _same(TR.reference_shuffle(tt, gen=TR.MT19937(2)),
          JR.reference_shuffle(jt, gen=JR.MT19937(2)))


def test_default_stream_and_reset():
    """``reset`` restarts the shared stream, as restarting the reference
    program does; fills draw from it in flat order."""
    f = qformat(8, 8)
    TR.reset(1)
    JR.reset(1)
    t = TR.reference_fill((2, 3), P(f), device="cpu")
    _same(t, JR.reference_fill((2, 3), f))
    gen = TR.MT19937(1)
    assert t.raw_list() == [TR.fill_raw(gen, 17) for _ in range(6)]
    TR.reset(9)
    a = TR.fill_raw(TR.default_gen(), 40)
    TR.reset(9)
    assert TR.fill_raw(TR.default_gen(), 40) == a
    TR.reset(1)
    JR.reset(1)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 12, 33])
def test_reference_permutation_is_the_shuffle(n):
    """The permutation applied as an index equals the JAX package's swaps
    on the raws, and moves the tensor to ``device`` when one is named."""
    f = qformat(8, 8)
    src = np.arange(1000, 1000 + n)
    perm = TR.reference_permutation(n, TR.MT19937(1))
    assert sorted(perm) == list(range(n))
    want = JR.reference_shuffle(JQ.from_raw(src, f), gen=JR.MT19937(1))
    got = TR.reference_shuffle(TQ.from_raw(src, P(f), "cpu"),
                               gen=TR.MT19937(1), device=torch.device("cpu"))
    assert got.raw_list() == [int(v) for v in
                              np.asarray(want.raw()).reshape(-1)]
    assert got.raw_list() == [int(v) for v in src[perm]]


def test_reference_shuffle_refuses_beyond_the_replica():
    with pytest.raises(ValueError, match="n\\^2 < 2\\^32"):
        TR.reference_permutation(1 << 16 | 1, TR.MT19937(1))
