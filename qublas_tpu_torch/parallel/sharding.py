"""Sharded quantized GEMM, complex GEMM and Qreduce over a (dp, tp) mesh.

Port of ``qublas_tpu.parallel.sharding`` on ``torch.distributed``: the
same strategies, the same gates and errors, the same bits.  A mesh is a
grid of processes (:mod:`.collectives`); every rank calls the same
function with the same **global** operands, as the JAX functions take
global arrays, computes on its own block (``shard_map``'s ``in_specs``:
each rank slices the block of its place in the grid) and returns the
**whole** result as a plain :class:`~qublas_tpu_torch.qtensor.QTensor` on
its device: its output blocks are gathered over the mesh, as a JAX global
array reads whole.  Limb storage stacks its limbs on a leading axis, so
the sharded dims of a limb leaf sit one further on.

Strategies (``qublas_tpu/parallel/sharding.py``'s module docstring):

* ``"mn"``: M over dp, N over tp; each rank's block is one single-device
  :func:`~qublas_tpu_torch.ops.gemm.qgemul` (any tier: K1, K2h, K2, ...).
  Bit-exact for every configuration.
* ``"k"`` / ``"k_pipelined"``: the contraction dim over tp under the
  lossless proof; each rank's partial dot is K1's ``int_dot``, the
  partials sum with a psum or a reduce-scatter (or ride a ppermute ring),
  then ``requantize_i32``.
* ``"k_wide"`` / ``"k_limb"`` (and their rings): the same for dots beyond
  int32: exact int64 partial dots, or balanced-digit limb dots on K1.
* ``"k_tree"``: order-sensitive trees split on subtree boundaries; each
  rank folds its subtrees (one ``qgemul``, K2 on the card, when its span
  is one subtree), the level-s nodes all-gather (or fold by a ppermute
  butterfly), the top layers fold with ``qreduce`` (K3).
* ``"dp"``: batch over the whole mesh, one ``qgemul`` a rank.

The JAX package checks at trace time, on a 1-row x 1-col probe, that a
configuration never takes a host route inside ``shard_map``; here the
ops' own dispatch on formats decides it (:func:`~qublas_tpu_torch.ops.gemm.
gemm_on_device`, :func:`~qublas_tpu_torch.ops.cgemm.cgemul_on_device`,
:func:`~qublas_tpu_torch.ops.reduce.reduce_format`: nothing is computed),
and such a configuration raises the same ``ValueError``.  So the JAX
package's probe cache (``_PROBE_CACHE``) has no counterpart: there is no
probe to keep.

Each strategy's per-rank program, from this rank's blocks to the value it
returns (its compute, its collectives and the gather of the output), runs
as the mesh's ``programs`` say (:func:`~.collectives.make_mesh`): eagerly
(the plain version, the default on the CPU), or compiled by
``torch.compile(fullgraph=True, dynamic=False)`` (Inductor by default on
the card), as the JAX package jits its ``shard_map`` programs.  A compiled
program is built once per static configuration and kept in
``_PROGRAM_CACHE``, the counterpart of the JAX package's ``_cached`` and its
bounded LRU: the key holds what the JAX key holds, plus the mesh (its
token, which stands for its process groups, its shape, backend, device
and programs) and the operands' shapes, strides, dtypes and formats.  Each program is compiled
under a code object of its own, so Dynamo's recompile limit never sends one
configuration of a strategy back to eager, and an eviction drops the
program's graphs and kernels.  The gates run before any program: a
configuration they refuse raises before anything compiles.  A compile or
launch error raises; nothing falls back to eager.
"""

from __future__ import annotations

import itertools
import types
from typing import Optional

import torch
import torch.utils._pytree as pytree

from ..ops import elementwise as ew
from ..ops import limbint as L
from ..ops.fused_gemm import int_dot
from ..ops.gemm import _plan_of, _swap, gemm_on_device, pair_dot_2d, qgemul
from ..ops.reduce import layer_format, qreduce, reduce_format
from ..ops.wideint import requantize_i32, requantize_i64
from ..ops.widths import Interval, fmt_interval, storage_kind, torch_dtype_for
from ..qformat import QFormat, add_merge, mul_merge
from ..qtensor import QTensor
from . import collectives as C
from .collectives import Mesh, init_distributed, make_mesh

__all__ = ["make_mesh", "shard_qgemul", "sharded_qgemul_k",
           "sharded_qgemul_k_tree",
           "sharded_qgemul_k_pipelined", "sharded_qgemul_k_wide",
           "sharded_qgemul_k_wide_pipelined", "sharded_qgemul_k_limb",
           "sharded_qgemul_k_limb_pipelined", "sharded_qgemul_mn",
           "sharded_qgemul_dp", "init_distributed",
           "sharded_cgemul", "sharded_cgemul_mn", "sharded_cgemul_k",
           "sharded_cgemul_k_tree", "sharded_cgemul_dp",
           "sharded_qreduce", "sharded_qreduce_k", "sharded_qreduce_k_tree",
           "choose_strategy", "choose_cgemul_strategy"]

_HOST_MSG = ("this GEMM config outgrows device lanes (host route); {who} "
             "cannot run it inside shard_map")
_CHOST_MSG = ("this complex GEMM config outgrows device lanes (host route); "
              "{who} cannot run it inside shard_map")
_RHOST_MSG = ("this reduction outgrows device lanes (host route); {who} "
              "cannot run it inside shard_map")


# ---------------------------------------------------------------------------
# the program cache: each rank's program compiled once per configuration
# ---------------------------------------------------------------------------

def _freeze(x):
    """Recursively hashable view of a config value (lists/dicts -> tuples)."""
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    return x


class _LRU:
    """Small bounded LRU over an insertion-ordered dict; ``release`` is
    called on each value it evicts or clears."""

    def __init__(self, max_items: int, release=None):
        self.max_items = max_items
        self.release = release
        self._d: dict = {}

    def get(self, key):
        v = self._d.pop(key, None)
        if v is not None:
            self._d[key] = v       # re-insert: most recently used
        return v

    def put(self, key, value) -> None:
        self._d.pop(key, None)
        while len(self._d) >= self.max_items:
            self._drop(self._d.pop(next(iter(self._d))))
        self._d[key] = value

    def _drop(self, value) -> None:
        if self.release is not None:
            self.release(value)

    def __len__(self):
        return len(self._d)

    def clear(self) -> None:
        while self._d:
            self._drop(self._d.popitem()[1])


class _Program:
    """A compiled per-rank program (:func:`_compile`) and the collectives
    its trace counted, added to its mesh's stats on each call."""

    def __init__(self, fn, mesh: Mesh):
        self.fn = fn
        self.mesh = mesh
        self.notes = []

    def __call__(self, *leaves):
        with C.recording(self.notes):
            out = self.fn(*leaves)
        self.mesh.stats["calls"] += len(self.notes)
        self.mesh.stats["bytes"] += sum(self.notes)
        return out

    def release(self) -> None:
        """Drop the program's Dynamo cache: its graphs and kernels (the
        program has a code object of its own)."""
        torch._dynamo.reset_code(self.fn.__wrapped__.__code__)


_PROGRAM_CACHE = _LRU(512, _Program.release)


def _cached(key, build):
    """Memoize compiled per-rank programs by static config (the JAX
    package's ``_cached``): ``build()`` compiles one on a miss.  Every key
    component goes through :func:`_freeze`, and the cache is LRU-bounded,
    so key churn cannot keep compiled programs forever."""
    key = _freeze(key)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        fn = build()
    _PROGRAM_CACHE.put(key, fn)
    return fn


_PROGRAM_IDS = itertools.count()


def _compile(block, spec, mesh: Mesh) -> _Program:
    """``block`` as a compiled program of the leaves of its blocks (pytree
    ``spec``: the formats are the program's constants, the tensors its
    inputs) on ``mesh`` (its programs' form), under a code object of its
    own."""
    def program(*leaves):
        C.trace_begins()
        return block(*pytree.tree_unflatten(list(leaves), spec))

    code = program.__code__.replace(
        co_name=f"rank_program_{next(_PROGRAM_IDS)}")
    fresh = types.FunctionType(code, program.__globals__, code.co_name,
                               None, program.__closure__)
    return _Program(torch.compile(fresh, fullgraph=True, dynamic=False,
                                  **dict(mesh.programs)), mesh)


def _program(key, mesh: Mesh, block, *blocks):
    """Run this rank's program of a strategy, ``block(*blocks)`` from its
    blocks to the value the strategy returns: eagerly on a mesh whose
    programs are eager, else compiled once per ``key`` (with the mesh and
    the blocks' signature added) and cached.  Lookup tables the key holds
    are placed on the mesh's device first, so a program finds them there
    on every call."""
    if mesh.programs is None:
        return block(*blocks)
    from ..anus import QTable

    for v in pytree.tree_leaves(_freeze(key)):
        if isinstance(v, QTable) and v.table is not None:
            v._table_on(mesh.device)
    leaves, spec = pytree.tree_flatten(blocks)
    key = (key, mesh.token, mesh.shape, mesh.backend, str(mesh.device),
           mesh.programs, spec,
           tuple((tuple(t.shape), t.stride(), t.dtype) for t in leaves))
    return _cached(key, lambda: _compile(block, spec, mesh))(*leaves)


# ---------------------------------------------------------------------------
# blocks: shard_map's in_specs and out_specs on one rank
# ---------------------------------------------------------------------------

def _leaf(t: QTensor):
    """(storage tensor, offset of the element dims in it)."""
    return (t.data.limbs, 1) if t.is_limb else (t.data, 0)


def _wrap(leaf: torch.Tensor, like: QTensor) -> QTensor:
    return QTensor(L.LimbArray(leaf) if like.is_limb else leaf, like.fmt)


def _spec(spec, ndim: int):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _block(t: QTensor, mesh: Mesh, spec) -> QTensor:
    """This rank's block of the global ``t`` under ``spec`` (per element
    dim: None, "dp", "tp" or ("dp", "tp")), on the mesh's device."""
    if t.is_host:
        raise ValueError("host-storage values cannot run inside shard_map")
    leaf, lead = _leaf(t)
    tp = mesh.shape["tp"]
    for i, s in enumerate(_spec(spec, t.ndim)):
        if s is None:
            continue
        if isinstance(s, str):
            parts, idx = mesh.shape[s], mesh.get_local_rank(s)
        else:
            parts = mesh.shape["dp"] * tp
            idx = mesh.get_local_rank("dp") * tp + mesh.get_local_rank("tp")
        size = t.shape[i]
        if size % parts:
            raise ValueError(f"dim {i} of shape {t.shape} does not split "
                             f"over {parts} devices ({s})")
        blk = size // parts
        leaf = leaf.narrow(lead + i, idx * blk, blk)
    return _wrap(leaf.to(mesh.device), t)


def _whole(t: QTensor, mesh: Mesh, spec) -> QTensor:
    """The global value of which each rank holds block ``t`` under
    ``spec``."""
    leaf, lead = _leaf(t)
    return _wrap(C.unshard(leaf, mesh, _spec(spec, t.ndim), lead), t)


# ---------------------------------------------------------------------------
# the host-route gates (the JAX package's trace-time checks)
# ---------------------------------------------------------------------------

def _traceable(a: QTensor, b: QTensor, out_fmt, mul_to, add_formats,
               mul_full_prec: bool) -> bool:
    """The JAX package's trace-time check: whether the configuration's
    routes stay on the device.  All-lane configurations (lane operands and
    every explicit format lane-stored) pass unchecked, as there: their
    products and sums stay in the pair and limb envelopes.  Decided by
    :func:`~qublas_tpu_torch.ops.gemm.gemm_on_device`."""
    fmts = [out_fmt] + ([mul_to] if mul_to is not None else []) \
        + list(add_formats)
    if not (a.is_pair or b.is_pair or a.is_limb or b.is_limb
            or a.is_host or b.is_host
            or any(storage_kind(f) != "lane" for f in fmts)):
        return True
    return gemm_on_device(a, b, out_fmt, mul_to, add_formats, mul_full_prec)


def _check_traceable(a: QTensor, b: QTensor, out_fmt, mul_to, add_formats,
                     kw, who: str) -> None:
    """``ValueError`` for a configuration that takes a host route."""
    if not _traceable(a, b, out_fmt, mul_to, add_formats,
                      kw.get("mul_full_prec", False)):
        raise ValueError(_HOST_MSG.format(who=who))


def _gemm_kw(kw: dict) -> dict:
    """``qgemul``'s keywords of a strategy's ``**kw``: ``use_pallas``
    chooses the TPU kernels in the JAX package and has no counterpart
    here."""
    return {k: v for k, v in kw.items() if k != "use_pallas"}


# ---------------------------------------------------------------------------
# shard_qgemul and its choice of strategy
# ---------------------------------------------------------------------------

def choose_strategy(a: QTensor, b: QTensor, out_fmt: QFormat, mesh_shape,
                    mul_to=None, add_formats=(),
                    mul_full_prec: bool = False) -> str:
    """The strategy ``shard_qgemul(strategy="auto")`` takes, in the JAX
    package's order of choice (``qublas_tpu/parallel/sharding.py:253-307``):
    ``"dp"`` for a batched LHS; ``"k"`` under the int32 proof with tp | K;
    ``"k_limb"``, then ``"k_wide"``, for proof-lossless dots beyond int32;
    else ``"mn"``, or ``"k_tree"`` when the tree splits at least 3 levels
    deep and mn cannot shard the output or the shape is K-dominated (and
    the configuration runs on device routes), the proofs read from the
    tier of the global call's plan (``ops.gemm.plan_qgemul``, no tier
    off).  ``mesh_shape`` is a mesh or its ``{"dp": .., "tp": ..}``;
    nothing is communicated."""
    shape = getattr(mesh_shape, "shape", mesh_shape)
    if a.ndim > 2:
        return "dp"
    tp = shape["tp"]
    m_, n_, k_ = a.shape[0], b.shape[-1], a.shape[-1]
    tier = _plan_of(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                    tiers_off=frozenset()).tier
    if k_ % tp == 0 and (tier == "k1" or tier in ("limb", "wide")
                         and b.ndim == 2):
        return {"k1": "k", "limb": "k_limb", "wide": "k_wide"}[tier]
    mn_ok = m_ % shape["dp"] == 0 and n_ % tp == 0
    s, _q, _E, _nn = _k_tree_split(k_, tp)
    if s >= 3 and (not mn_ok or k_ >= 8 * max(m_, n_)) and _traceable(
            a, b, out_fmt, mul_to, add_formats, mul_full_prec):
        return "k_tree"
    return "mn"


def shard_qgemul(a: QTensor, b: QTensor, out_fmt: QFormat, mesh: Mesh,
                 mul_to=None, add_formats=(), strategy: str = "auto",
                 **kw) -> QTensor:
    """Sharded C = A @ B (see the module docstring for the strategies;
    ``"auto"`` is :func:`choose_strategy`)."""
    if isinstance(add_formats, QFormat):
        add_formats = (add_formats,)
    add_formats = tuple(add_formats)
    ta, tb = kw.pop("transpose_a", False), kw.pop("transpose_b", False)
    if ta:
        a = _swap(a)
    if tb:
        b = _swap(b)
    if strategy == "auto":
        strategy = choose_strategy(a, b, out_fmt, mesh, mul_to, add_formats,
                                   kw.get("mul_full_prec", False))
    fn = _STRATEGIES.get(strategy)
    if fn is None:
        raise ValueError(f"unknown strategy {strategy!r}")
    return fn(a, b, out_fmt, mesh, mul_to=mul_to, add_formats=add_formats,
              **kw)


# ---------------------------------------------------------------------------
# M/N sharding: bit-exact for every config
# ---------------------------------------------------------------------------

def sharded_qgemul_mn(a: QTensor, b: QTensor, out_fmt: QFormat, mesh: Mesh,
                      mul_to=None, add_formats=(), **kw) -> QTensor:
    """Shard M over dp, N over tp; each rank computes whole dot products
    for its output block, so any accumulation config stays bit-exact.
    Configurations that take a host route raise ``ValueError``."""
    kw = _gemm_kw(kw)
    _check_traceable(a, b, out_fmt, mul_to, add_formats, kw,
                     "sharded_qgemul_mn")

    def block(la, lb):
        c = qgemul(la, lb, out_fmt, mul_to=mul_to, add_formats=add_formats,
                   **kw)
        return _whole(c, mesh, ("dp", "tp"))

    return _program(("mn", a.fmt, b.fmt, out_fmt, mul_to, add_formats, kw),
                    mesh, block, _block(a, mesh, ("dp", None)),
                    _block(b, mesh, (None, "tp")))


# ---------------------------------------------------------------------------
# K sharding: the exactness-proof regime; psum / reduce-scatter
# ---------------------------------------------------------------------------

def _k_epilogue(dot: torch.Tensor, prod_frac: int, out_fmt: QFormat,
                out_dtype, epilogue_lut) -> QTensor:
    raw = requantize_i32(dot, prod_frac, out_fmt).to(out_dtype)
    res = QTensor(raw, out_fmt)
    return res if epilogue_lut is None else epilogue_lut(res)


def _k_gates(plan, out_fmt: QFormat):
    """The int32-lane output and epilogue gates of the K strategies."""
    from ..ops.widths import route_requant

    out_dtype = torch_dtype_for(out_fmt)
    if out_dtype is None:
        raise ValueError(
            "K-sharding writes int32 lanes; this output format needs "
            "wider storage - use strategy='mn'")
    if route_requant(plan.dot_interval, plan.prod_frac, out_fmt) != "i32":
        raise ValueError(
            "the requantize epilogue outgrows int32 lanes for this "
            "config - use strategy='mn'")
    return out_dtype


def sharded_qgemul_k(a: QTensor, b: QTensor, out_fmt: QFormat, mesh: Mesh,
                     mul_to=None, add_formats=(), mul_full_prec=False,
                     reduce_scatter: bool = False,
                     epilogue_lut=None) -> QTensor:
    """Shard the contraction dim over ``tp``: each rank's partial int32 dot
    of its K-slice is one K1 ``int_dot``; the partials sum with a psum
    (output replicated) or a reduce-scatter (output N-sharded over tp, read
    whole), and the requantize epilogue runs on the sum.  Requires the
    lossless-accumulation proof; raises ``ValueError`` otherwise."""
    k = a.shape[-1]
    tp = mesh.shape["tp"]
    plan = _plan_of(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                    tiers_off=frozenset()).exact
    if plan is None:
        raise ValueError(
            "K-sharding needs a lossless accumulation proof; this config's "
            "tree is order-sensitive — use strategy='mn'")
    if not plan.dot_interval.fits32:
        raise ValueError("dot interval exceeds int32; use strategy='mn'")
    if k % tp:
        raise ValueError(f"K={k} not divisible by tp={tp}")
    if reduce_scatter and b.shape[-1] % tp:
        raise ValueError(
            f"N={b.shape[-1]} not divisible by tp={tp} (reduce_scatter "
            f"shards the output's N dim)")
    out_dtype = _k_gates(plan, out_fmt)

    def block(la, lb):
        partial_dot = int_dot(la.data, lb.data)
        if reduce_scatter:
            dot = C.psum_scatter(partial_dot, mesh, "tp", dim=1)
        else:
            dot = C.psum(partial_dot, mesh, "tp")
        res = _k_epilogue(dot, plan.prod_frac, out_fmt, out_dtype,
                          epilogue_lut)
        return _whole(res, mesh, (None, "tp")) if reduce_scatter else res

    return _program(("k", plan.prod_frac, out_fmt, bool(reduce_scatter),
                     epilogue_lut), mesh, block,
                    _block(a, mesh, (None, "tp")),
                    _block(b, mesh, ("tp", None)))


def _ring(tp: int):
    return [(j, (j + 1) % tp) for j in range(tp)]


def sharded_qgemul_k_pipelined(a: QTensor, b: QTensor, out_fmt: QFormat,
                               mesh: Mesh, mul_to=None, add_formats=(),
                               mul_full_prec=False,
                               epilogue_lut=None) -> QTensor:
    """K-sharded GEMM as a decomposed reduce-scatter matmul: each of the
    ``tp`` steps computes one output N-block's partial dot (one K1
    ``int_dot``) while the accumulator rotates one rank along the ring;
    at step ``i`` rank ``d`` computes the block that lands on rank ``d``
    after the remaining ``tp-1-i`` rotations.  Output N-sharded over tp,
    read whole.  Same proof gate as :func:`sharded_qgemul_k`."""
    k = a.shape[-1]
    tp = mesh.shape["tp"]
    n = b.shape[-1]
    plan = _plan_of(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                    tiers_off=frozenset()).exact
    if plan is None or not plan.dot_interval.fits32:
        raise ValueError(
            "pipelined K-sharding needs a lossless accumulation proof; "
            "use strategy='mn' for order-sensitive configs")
    if k % tp or n % tp:
        raise ValueError(f"K={k} and N={n} must divide tp={tp}")
    bn = n // tp
    out_dtype = _k_gates(plan, out_fmt)
    idx = mesh.get_local_rank("tp")

    def block(la, lb):
        x, y = la.data, lb.data
        acc = torch.zeros((x.shape[0], bn), dtype=torch.int32,
                          device=x.device)
        for i in range(tp):
            blk = (idx + tp - 1 - i) % tp
            p = int_dot(x, y[:, blk * bn:(blk + 1) * bn])
            acc = C.ppermute(acc, mesh, "tp", _ring(tp)) + p
        res = _k_epilogue(acc, plan.prod_frac, out_fmt, out_dtype,
                          epilogue_lut)
        return _whole(res, mesh, (None, "tp"))

    return _program(("kp", plan.prod_frac, out_fmt, epilogue_lut, bn), mesh,
                    block, _block(a, mesh, (None, "tp")),
                    _block(b, mesh, ("tp", None)))


# ---------------------------------------------------------------------------
# Subtree-aligned K sharding: ORDER-SENSITIVE configs (no proof needed)
# ---------------------------------------------------------------------------

def _k_tree_split(k: int, tp: int):
    """Split geometry of :func:`sharded_qgemul_k_tree`: the deepest subtree
    level ``s`` with ``2^s | k`` and ``2^s <= k // tp``; each rank folds
    ``q`` complete ``2^s``-element subtrees over its ``E = q * 2^s`` span
    (k zero-padded to ``tp * E``; pad elements fill whole node slots past
    ``n_nodes = k / 2^s``).  Returns ``(s, q, E, n_nodes)``."""
    v2 = (k & -k).bit_length() - 1
    cap = max((k // tp).bit_length() - 1, 0)
    s = min(v2, cap)
    q = -(-k // (tp << s))
    return s, q, q << s, k >> s


def _node_format(mul_fmt: QFormat, add_formats, s: int) -> QFormat:
    """Format of a level-``s`` tree node: the per-layer TypeAt formats
    (QuBLAS.h:4913) folded from the product format through layers
    ``0..s-1``."""
    fmt = mul_fmt
    for lvl in range(s):
        lf = layer_format(add_formats, lvl)
        fmt = lf if lf is not None else add_merge(fmt, fmt)
    return fmt


def _shift_layers(add_formats, s: int):
    """Layer formats as seen from level ``s`` upward (TypeAt is ``min(layer,
    len-1)``: a suffix that repeats its last element)."""
    if not add_formats or s == 0:
        return tuple(add_formats)
    return tuple(add_formats[min(s + i, len(add_formats) - 1)]
                 for i in range(max(len(add_formats) - s, 1)))


def _pad_k(t: QTensor, axis: int, pad: int) -> QTensor:
    """``t`` zero-padded by ``pad`` elements along ``axis`` (any device
    storage); zero raws are valid in every format."""
    if pad == 0:
        return t
    if t.is_host:
        raise ValueError("host-storage values cannot run inside shard_map")
    leaf, lead = _leaf(t)
    shape = list(leaf.shape)
    shape[lead + axis] = pad
    return _wrap(torch.cat([leaf, leaf.new_zeros(shape)], dim=lead + axis),
                 t)


def _moveaxis(t: QTensor, src: int, dst: int) -> QTensor:
    if t.is_limb:
        return QTensor(t.data.movedim(src, dst), t.fmt)
    return QTensor(torch.movedim(t.data, src, dst), t.fmt)


def _unsqueeze0(t: QTensor) -> QTensor:
    leaf, lead = _leaf(t)
    return _wrap(leaf.unsqueeze(lead), t)


def _gather_nodes(t: QTensor, mesh: Mesh) -> QTensor:
    """all_gather a node-leading QTensor over ``tp`` (node axis 0)."""
    leaf, lead = _leaf(t)
    return _wrap(C.all_gather(leaf, mesh, "tp", dim=lead), t)


def _ppermute_qt(t: QTensor, mesh: Mesh, perm) -> QTensor:
    """ppermute every storage leaf of a QTensor over ``tp``."""
    leaf, _ = _leaf(t)
    return _wrap(C.ppermute(leaf, mesh, "tp", perm), t)


def _butterfly_fold(v: QTensor, add_formats, s: int, mesh: Mesh) -> QTensor:
    """ppermute-butterfly top fold: round ``lvl`` pairs rank ``d`` with
    ``d ^ 2^lvl`` (the global tree's level ``s+lvl`` pairing) and both
    partners merge, so the value ends replicated; log2(tp) rounds."""
    tp = mesh.shape["tp"]
    for lvl in range(tp.bit_length() - 1):
        stride = 1 << lvl
        pv = _ppermute_qt(v, mesh, [(d, d ^ stride) for d in range(tp)])
        # the tree merge is a quantized ADD of same-format operands:
        # commutative, so no left/right select is needed
        v = ew.qadd(v, pv, to=layer_format(add_formats, s + lvl))
    return v


def _bf_ok(q: int, s: int, tp: int, n_nodes: int, butterfly) -> bool:
    ok = q == 1 and s >= 1 and tp >= 2 and tp & (tp - 1) == 0 \
        and n_nodes == tp
    if butterfly and not ok:
        raise ValueError(
            "butterfly=True needs a one-subtree-per-device power-of-2 "
            "split (q==1, tp a power of 2, n_nodes==tp); this shape "
            "does not qualify - use butterfly=None (auto) or False")
    return ok if butterfly is None else bool(butterfly)


def sharded_qgemul_k_tree(a: QTensor, b: QTensor, out_fmt: QFormat,
                          mesh: Mesh, mul_to=None, add_formats=(),
                          mul_full_prec=False, epilogue_lut=None,
                          use_pallas=None,
                          butterfly: Optional[bool] = None) -> QTensor:
    """K-shard an ORDER-SENSITIVE tree GEMM, bit-exact by construction:
    the contraction dim splits on level-``s`` subtree boundaries, each rank
    folds its complete subtrees with the global layer formats, the
    ``k/2^s`` node values all-gather over tp and the top layers fold with
    the shifted TypeAt formats through ``qreduce``, whose odd-tail
    converting assignments reproduce the global tree (ragged ``k``
    included: pad nodes are dropped after the gather).

    When a rank's span is one subtree, its fold is one single-device
    ``qgemul`` into the node format (K2 on the card), and for power-of-2
    ``tp`` the cross-rank levels fold by the ppermute butterfly.
    ``butterfly``: None = whenever the split qualifies, False = always
    gather, True = require it (``ValueError`` when the split does not
    qualify).  ``use_pallas`` is the JAX package's choice of TPU kernels
    and has no counterpart here."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("k_tree shards 2-D GEMMs (use dp for batches)")
    _check_traceable(a, b, out_fmt, mul_to, add_formats,
                     dict(mul_full_prec=mul_full_prec),
                     "sharded_qgemul_k_tree")
    k = a.shape[-1]
    tp = mesh.shape["tp"]
    s, q, E, n_nodes = _k_tree_split(k, tp)
    mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)
    node_fmt = _node_format(mul_fmt, add_formats, s)
    top_layers = _shift_layers(add_formats, s)
    use_bf = _bf_ok(q, s, tp, n_nodes, butterfly)
    pad = tp * E - k
    m, n = a.shape[0], b.shape[-1]

    def block(la, lb):
        if s == 0:
            # nodes are the quantized products themselves
            prod = ew.qmul(_unsqueeze_last(la), _unsqueeze0(lb), to=mul_to,
                           full_prec=mul_full_prec)
            nodes = _moveaxis(prod, 1, 0)
        elif q == 1:
            # the rank's span is ONE complete subtree: the local fold is a
            # single-device qgemul whose tree ends in node_fmt
            one = qgemul(la, lb, node_fmt, mul_to=mul_to,
                         add_formats=add_formats,
                         mul_full_prec=mul_full_prec)
            if use_bf:
                res = ew.qcast(_butterfly_fold(one, add_formats, s, mesh),
                               out_fmt)
                return res if epilogue_lut is None else epilogue_lut(res)
            nodes = _unsqueeze0(one)
        else:
            # q complete subtrees: all at once, layered ([m, q, 2^s, n])
            ca = _unsqueeze_last(_reshape(la, (m, q, 1 << s)))
            rb = _reshape(lb, (q, 1 << s, n))
            prod = ew.qmul(ca, rb, to=mul_to, full_prec=mul_full_prec)
            nodes = _moveaxis(qreduce(prod, add_formats, axis=-2), 1, 0)
        real = _gather_nodes(nodes, mesh)[0:n_nodes]   # drop pad nodes
        res = ew.qcast(qreduce(real, top_layers, axis=0), out_fmt)
        return res if epilogue_lut is None else epilogue_lut(res)

    return _program(("k_tree", a.fmt, b.fmt, out_fmt, mul_to, add_formats,
                     mul_full_prec, epilogue_lut, k, m, n, use_bf), mesh,
                    block, _block(_pad_k(a, 1, pad), mesh, (None, "tp")),
                    _block(_pad_k(b, 0, pad), mesh, ("tp", None)))


def _reshape(t: QTensor, shape) -> QTensor:
    return QTensor(t.data.reshape(shape), t.fmt)


def _unsqueeze_last(t: QTensor) -> QTensor:
    leaf, _ = _leaf(t)
    return _wrap(leaf.unsqueeze(-1), t)


# ---------------------------------------------------------------------------
# Wide K sharding: exact int64 partial dots, one int64 psum
# ---------------------------------------------------------------------------

def _k_plan(tier: str, a: QTensor, b: QTensor, out_fmt: QFormat, mul_to,
            add_formats, mul_full_prec, tp: int):
    """Proof gate of the limb and wide K strategies: the global call's
    plan, the tiers before ``tier`` off, takes the single-device ``tier``
    (its gate ``limb_dot_plan`` or ``wide_dot_ok``), on 2-D operands with
    tp | K.  The plan or None; its limbs, from the global k, hold the sum
    and every partial."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[-1] % tp:
        return None
    off = frozenset({"k1"} if tier == "limb" else {"k1", "limb"})
    plan = _plan_of(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                    tiers_off=off)
    return plan if plan.tier == tier else None


# the JAX package sums tp 16-bit columns into int32, exact while tp < 2^15;
# the port's int64 sums hold more, and keep the bound so that both
# packages admit the same meshes
_PSUM_COLS_MAX_TP = 1 << 15


def _check_psum_tp(mesh) -> None:
    tp = mesh.shape["tp"]
    if tp >= _PSUM_COLS_MAX_TP:
        raise ValueError(
            f"tp={tp} exceeds the carry-correct column-psum bound "
            f"(summed 16-bit columns must fit int32: tp < 2^15)")


def _psum_pair(p: torch.Tensor, mesh: Mesh, scatter: bool) -> torch.Tensor:
    """Cross-rank sum of int64 partial dots: one int64 psum (or reduce-
    scatter along N).  Mod-2^64 addition is exact for the true dot because
    the proof bounds it, and every partial, to the signed 64-bit range: the
    JAX package's 16-bit-column psum gives the same bits."""
    if scatter:
        return C.psum_scatter(p, mesh, "tp", dim=p.ndim - 1)
    return C.psum(p, mesh, "tp")


def _pair_epilogue(dot: torch.Tensor, prod_frac: int, out_fmt: QFormat,
                   epilogue_lut) -> QTensor:
    """``requantize_pair`` (lane out) or ``requantize_pair_keep`` (pair out)
    of an int64 dot, then the ROM."""
    raw = requantize_i64(dot, prod_frac, out_fmt)
    res = ew._finish(raw, out_fmt)
    return res if epilogue_lut is None else epilogue_lut(res)


def _wide_lut_gate(out_fmt: QFormat, epilogue_lut):
    if epilogue_lut is not None and storage_kind(out_fmt) != "lane":
        raise ValueError("epilogue_lut needs a lane-storage output format")


def sharded_qgemul_k_wide(a: QTensor, b: QTensor, out_fmt: QFormat,
                          mesh: Mesh, mul_to=None, add_formats=(),
                          mul_full_prec=False, reduce_scatter: bool = False,
                          epilogue_lut=None) -> QTensor:
    """K-sharded GEMM for proof-lossless configs whose dot outgrows int32
    but fits int64: each rank's exact int64 partial dot
    (:func:`~qublas_tpu_torch.ops.gemm.pair_dot_2d`: K1 segment dots where
    products fit int32), one int64 psum / reduce-scatter, the pair
    requantize after the collective.  Requires the proof; raises
    ``ValueError`` otherwise (use strategy='mn')."""
    _check_psum_tp(mesh)
    tp = mesh.shape["tp"]
    plan = _k_plan("wide", a, b, out_fmt, mul_to, add_formats,
                   mul_full_prec, tp)
    if plan is None:
        raise ValueError(
            "wide K-sharding needs 2-D lane/pair operands, tp | K, a "
            "lossless accumulation proof with the dot in the 64-bit "
            "domain, and a lane/pair-domain epilogue; use strategy='mn'")
    plan = plan.exact
    _wide_lut_gate(out_fmt, epilogue_lut)
    if reduce_scatter and b.shape[-1] % tp:
        raise ValueError(
            f"N={b.shape[-1]} not divisible by tp={tp} (reduce_scatter "
            f"shards the output's N dim)")

    def block(la, lb):
        p = pair_dot_2d(la.data, lb.data, plan.prod_interval)
        res = _pair_epilogue(_psum_pair(p, mesh, reduce_scatter),
                             plan.prod_frac, out_fmt, epilogue_lut)
        return _whole(res, mesh, (None, "tp")) if reduce_scatter else res

    return _program(("kw", a.fmt, b.fmt, plan.prod_frac, out_fmt,
                     bool(reduce_scatter), epilogue_lut), mesh, block,
                    _block(a, mesh, (None, "tp")),
                    _block(b, mesh, ("tp", None)))


def _slice_n(y: QTensor, start: int, size: int) -> QTensor:
    """N-block ``[:, start:start+size]`` of a ``[k, n]`` operand in any
    device storage."""
    leaf, lead = _leaf(y)
    return _wrap(leaf.narrow(lead + 1, start, size), y)


def sharded_qgemul_k_wide_pipelined(a: QTensor, b: QTensor, out_fmt: QFormat,
                                    mesh: Mesh, mul_to=None, add_formats=(),
                                    mul_full_prec=False,
                                    epilogue_lut=None) -> QTensor:
    """:func:`sharded_qgemul_k_pipelined`'s ring for int64 dots: each step's
    exact N-block partial dot joins the accumulator as it rotates, added
    mod 2^64 (every intermediate is a subset sum the proof bounds to the
    signed 64-bit range, so no tp bound).  Output N-sharded, read whole.
    Same gate as :func:`sharded_qgemul_k_wide`."""
    tp = mesh.shape["tp"]
    n = b.shape[-1]
    plan = _k_plan("wide", a, b, out_fmt, mul_to, add_formats,
                   mul_full_prec, tp)
    if plan is None or n % tp:
        raise ValueError(
            "pipelined wide K-sharding needs 2-D lane/pair operands, "
            "tp | K and tp | N, a lossless accumulation proof with the dot "
            "in the 64-bit domain, and a lane/pair-domain epilogue; use "
            "strategy='mn'")
    plan = plan.exact
    _wide_lut_gate(out_fmt, epilogue_lut)
    bn = n // tp
    idx = mesh.get_local_rank("tp")

    def block(la, lb):
        acc = torch.zeros((la.shape[0], bn), dtype=torch.int64,
                          device=mesh.device)
        for i in range(tp):
            blk = (idx + tp - 1 - i) % tp
            p = pair_dot_2d(la.data, _slice_n(lb, blk * bn, bn).data,
                            plan.prod_interval)
            acc = C.ppermute(acc, mesh, "tp", _ring(tp)) + p
        res = _pair_epilogue(acc, plan.prod_frac, out_fmt, epilogue_lut)
        return _whole(res, mesh, (None, "tp"))

    return _program(("kwp", a.fmt, b.fmt, plan.prod_frac, out_fmt,
                     epilogue_lut, bn), mesh, block,
                    _block(a, mesh, (None, "tp")),
                    _block(b, mesh, ("tp", None)))


# ---------------------------------------------------------------------------
# Limb K sharding: digit-domain partial dots, one limb psum
# ---------------------------------------------------------------------------

def _carry_limbs(s: torch.Tensor) -> torch.Tensor:
    """One carry pass over stacked ``(Kw, ...)`` int64 limb sums (each below
    2^63): 32-bit limbs of the value mod 2^(32 Kw)."""
    out, car = [], None
    for d in range(s.shape[0]):
        t = s[d] if car is None else s[d] + car
        out.append(t & L.M32)
        car = t >> 32
    return torch.stack(out)


def _psum_limbs(limbs: torch.Tensor, mesh: Mesh, scatter: bool):
    """Carry-correct cross-rank sum of stacked ``(Kw, m, n)`` 32-bit limbs
    in int64: one int64 psum (or reduce-scatter along the last dim) sums
    each limb (below tp * 2^32, exact in int64), then one carry pass.
    Mod-2^(32 Kw) addition is exact for the true dot because the limb plan
    bounds it, and every partial, to the working width: the JAX package's
    2 Kw 16-bit-column psum gives the same bits."""
    if scatter:
        s = C.psum_scatter(limbs, mesh, "tp", dim=limbs.ndim - 1)
    else:
        s = C.psum(limbs, mesh, "tp")
    return _carry_limbs(s)


def _limb_epilogue(tot: torch.Tensor, prod_frac: int, out_fmt: QFormat,
                   epilogue_lut) -> QTensor:
    res = ew._finish(L.requantize_limb(tot, prod_frac, out_fmt), out_fmt)
    return res if epilogue_lut is None else epilogue_lut(res)


def sharded_qgemul_k_limb(a: QTensor, b: QTensor, out_fmt: QFormat,
                          mesh: Mesh, mul_to=None, add_formats=(),
                          mul_full_prec=False, reduce_scatter: bool = False,
                          epilogue_lut=None) -> QTensor:
    """K-sharded GEMM for proof-lossless configs beyond the 64-bit domain:
    each rank's exact stacked-limb partial dot is balanced int8 digit dots
    on K1 (:func:`~qublas_tpu_torch.ops.limbdot.limb_dot_2d`), the partials
    combine with the carry-correct limb psum / reduce-scatter, and the limb
    requantize runs after the collective.  Requires the proof; raises
    ``ValueError`` otherwise (use strategy='mn')."""
    from ..ops.limbdot import limb_dot_2d

    _check_psum_tp(mesh)
    tp = mesh.shape["tp"]
    plan = _k_plan("limb", a, b, out_fmt, mul_to, add_formats,
                   mul_full_prec, tp)
    if plan is None:
        raise ValueError(
            "limb K-sharding needs 2-D device operands, tp | K, a lossless "
            "accumulation proof, and a dot/epilogue inside the limb "
            "working envelope; use strategy='mn'")
    Kw, prod_frac = plan.limbs, plan.exact.prod_frac
    _wide_lut_gate(out_fmt, epilogue_lut)
    if reduce_scatter and b.shape[-1] % tp:
        raise ValueError(
            f"N={b.shape[-1]} not divisible by tp={tp} (reduce_scatter "
            f"shards the output's N dim)")
    iva, ivb = fmt_interval(a.fmt), fmt_interval(b.fmt)

    def block(la, lb):
        acc = limb_dot_2d(la.data, lb.data, iva, ivb, Kw)
        res = _limb_epilogue(_psum_limbs(acc, mesh, reduce_scatter),
                             prod_frac, out_fmt, epilogue_lut)
        return _whole(res, mesh, (None, "tp")) if reduce_scatter else res

    return _program(("kl", a.fmt, b.fmt, prod_frac, out_fmt, Kw,
                     bool(reduce_scatter), epilogue_lut), mesh, block,
                    _block(a, mesh, (None, "tp")),
                    _block(b, mesh, ("tp", None)))


def sharded_qgemul_k_limb_pipelined(a: QTensor, b: QTensor, out_fmt: QFormat,
                                    mesh: Mesh, mul_to=None, add_formats=(),
                                    mul_full_prec=False,
                                    epilogue_lut=None) -> QTensor:
    """The ring for limb dots: each step's exact ``(Kw, m, bn)`` partial
    dot joins the limb accumulator as it rotates, added mod 2^(32 Kw)
    (``ladd``; no column psum, so no tp bound).  Output N-sharded, read
    whole.  Same gate as :func:`sharded_qgemul_k_limb`."""
    from ..ops.limbdot import limb_dot_2d

    tp = mesh.shape["tp"]
    n = b.shape[-1]
    plan = _k_plan("limb", a, b, out_fmt, mul_to, add_formats,
                   mul_full_prec, tp)
    if plan is None or n % tp:
        raise ValueError(
            "pipelined limb K-sharding needs 2-D device operands, tp | K "
            "and tp | N, a lossless accumulation proof, and a dot/epilogue "
            "inside the limb working envelope; use strategy='mn'")
    Kw, prod_frac = plan.limbs, plan.exact.prod_frac
    _wide_lut_gate(out_fmt, epilogue_lut)
    bn = n // tp
    iva, ivb = fmt_interval(a.fmt), fmt_interval(b.fmt)
    idx = mesh.get_local_rank("tp")

    def block(la, lb):
        acc = torch.zeros((Kw, la.shape[0], bn), dtype=torch.int64,
                          device=mesh.device)
        for i in range(tp):
            blk = (idx + tp - 1 - i) % tp
            p = limb_dot_2d(la.data, _slice_n(lb, blk * bn, bn).data, iva,
                            ivb, Kw)
            acc = L.ladd(C.ppermute(acc, mesh, "tp", _ring(tp)), p)
        res = _limb_epilogue(acc, prod_frac, out_fmt, epilogue_lut)
        return _whole(res, mesh, (None, "tp"))

    return _program(("klp", a.fmt, b.fmt, prod_frac, out_fmt, Kw,
                     epilogue_lut, bn), mesh, block,
                    _block(a, mesh, (None, "tp")),
                    _block(b, mesh, ("tp", None)))


# ---------------------------------------------------------------------------
# DP batch sharding
# ---------------------------------------------------------------------------

def sharded_qgemul_dp(a: QTensor, b: QTensor, out_fmt: QFormat, mesh: Mesh,
                      mul_to=None, add_formats=(), **kw) -> QTensor:
    """Shard the leading batch dim over the whole mesh (dp x tp): each rank
    runs independent GEMMs on its batch slice (a 2-D ``b`` shared), one
    ``qgemul`` call a rank."""
    if a.ndim < 3:
        raise ValueError("dp strategy needs a batched LHS [batch, m, k]")
    kw = _gemm_kw(kw)
    _check_traceable(a, b, out_fmt, mul_to, add_formats, kw,
                     "sharded_qgemul_dp")
    spec_a = (("dp", "tp"),)
    spec_b = spec_a if b.ndim == a.ndim else ()

    def block(la, lb):
        c = qgemul(la, lb, out_fmt, mul_to=mul_to, add_formats=add_formats,
                   **kw)
        return _whole(c, mesh, spec_a)

    return _program(("dp", a.fmt, b.fmt, out_fmt, mul_to, add_formats, kw,
                     spec_b), mesh, block, _block(a, mesh, spec_a),
                    _block(b, mesh, spec_b))


_STRATEGIES = {
    "k_limb": sharded_qgemul_k_limb,
    "k_limb_pipelined": sharded_qgemul_k_limb_pipelined,
    "k_wide": sharded_qgemul_k_wide,
    "k_wide_pipelined": sharded_qgemul_k_wide_pipelined,
    "k_tree": sharded_qgemul_k_tree,
    "k": sharded_qgemul_k,
    "k_pipelined": sharded_qgemul_k_pipelined,
    "mn": sharded_qgemul_mn,
    "dp": sharded_qgemul_dp,
}


# ---------------------------------------------------------------------------
# Complex GEMM sharding (TF/Basic per-product algorithms)
# ---------------------------------------------------------------------------

def _cparts(c):
    return c.real, c.imag


def _cfmts(c):
    return c.real.fmt, c.imag.fmt


def _complex(r: QTensor, i: QTensor):
    from ..complex import QComplexTensor

    return QComplexTensor(r, i)


def _cblock(c, mesh: Mesh, spec):
    return _complex(_block(c.real, mesh, spec), _block(c.imag, mesh, spec))


def _cwhole(c, mesh: Mesh, spec):
    return _complex(_whole(c.real, mesh, spec), _whole(c.imag, mesh, spec))


def _stack_qt(ts):
    """Stack same-format QTensors along a new leading axis."""
    lead = _leaf(ts[0])[1]
    return _wrap(torch.stack([_leaf(t)[0] for t in ts], dim=lead), ts[0])


def _stack_complex(cs):
    return _complex(_stack_qt([c.real for c in cs]),
                    _stack_qt([c.imag for c in cs]))


def _check_ctraceable(a, b, out_fmt, algo, add_formats, mul_tags,
                      who: str) -> None:
    """The JAX package's trace-time check of a complex GEMM: ``ValueError``
    for a configuration that takes a host route, decided by
    :func:`~qublas_tpu_torch.ops.cgemm.cgemul_on_device`."""
    from ..ops.cgemm import cgemul_on_device

    if not cgemul_on_device(a, b, out_fmt, algo, add_formats, **mul_tags):
        raise ValueError(_CHOST_MSG.format(who=who))


def _cfast_plan(a, b, out_fmt, algo, add_formats, mul_tags):
    """The complex fast path's plan for the whole call (the global K and
    the whole output's caps), or None where its proof fails."""
    from ..ops.cgemm import _part_formats, _split_layers, fast_plan

    orf, oif = _part_formats(out_fmt)
    r_layers, i_layers = _split_layers(add_formats)
    return fast_plan(a, b, orf, oif, algo, r_layers, i_layers, mul_tags,
                     a.shape[-1], (a.shape[-2], b.shape[-1]))


def choose_cgemul_strategy(a, b, out_fmt, mesh_shape, algo: str = "basic",
                           add_formats=(), **mul_tags) -> str:
    """The strategy ``sharded_cgemul(strategy="auto")`` takes for 2-D
    operands (``qublas_tpu/parallel/sharding.py:1323-1357``): ``"k"`` when
    the fast path's proof holds and tp | K; else ``"mn"``, or ``"k_tree"``
    when the split is at least 3 levels deep and mn cannot shard the
    output or the shape is K-dominated.  Batched operands: ``"dp"`` when
    the batch splits over the mesh, else ``"per_element"`` (2-D auto a
    batch element)."""
    from ..ops.cgemm import cgemul_on_device

    shape = getattr(mesh_shape, "shape", mesh_shape)
    if a.real.ndim > 2:
        n_dev = shape["dp"] * shape["tp"]
        return "dp" if a.real.shape[0] % n_dev == 0 else "per_element"
    if _cfast_plan(a, b, out_fmt, algo, add_formats, mul_tags) is not None \
            and a.shape[-1] % shape["tp"] == 0:
        return "k"
    m_, n_, k_ = a.shape[0], b.shape[-1], a.shape[-1]
    mn_ok = m_ % shape["dp"] == 0 and n_ % shape["tp"] == 0
    s, _q, _E, _nn = _k_tree_split(k_, shape["tp"])
    if s >= 3 and (not mn_ok or k_ >= 8 * max(m_, n_)) and \
            cgemul_on_device(a, b, out_fmt, algo, add_formats, **mul_tags):
        return "k_tree"
    return "mn"


def sharded_cgemul(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                   add_formats=(), strategy: str = "auto", **mul_tags):
    """Sharded complex C = A @ B (see
    :func:`qublas_tpu_torch.ops.cgemm.cgemul`): ``"mn"`` (any config),
    ``"k"`` (the fast path's integer dots summed over tp, under its
    proof), ``"k_tree"``, ``"dp"``; ``"auto"`` is
    :func:`choose_cgemul_strategy` (a batch that does not split over the
    mesh runs 2-D auto a batch element, stacked)."""
    if strategy == "auto":
        strategy = choose_cgemul_strategy(a, b, out_fmt, mesh, algo,
                                          add_formats, **mul_tags)
        if strategy == "per_element":
            outs = [sharded_cgemul(
                        _complex(a.real[i], a.imag[i]),
                        _complex(b.real[i], b.imag[i])
                        if b.real.ndim == a.real.ndim else b,
                        out_fmt, mesh, algo=algo, add_formats=add_formats,
                        strategy="auto", **mul_tags)
                    for i in range(a.real.shape[0])]
            return _stack_complex(outs)
    fn = _CSTRATEGIES.get(strategy)
    if fn is None:
        raise ValueError(f"unknown strategy {strategy!r}")
    return fn(a, b, out_fmt, mesh, algo=algo, add_formats=add_formats,
              **mul_tags)


def sharded_cgemul_k_tree(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                          add_formats=(), butterfly: Optional[bool] = None,
                          **mul_tags):
    """K-shard an ORDER-SENSITIVE complex GEMM, the complex analogue of
    :func:`sharded_qgemul_k_tree`: each rank computes its K-slice's complex
    products and folds complete ``2^s``-element subtrees per part with the
    global per-part layer formats; the per-part nodes all-gather and the
    top layers fold with the shifted formats; each part then takes its
    converting assignment into ``out_fmt``.  One-subtree-per-rank
    power-of-2 splits run the local fold as one single-device ``cgemul``
    (its fast dispatch included) and fold the cross-rank levels with the
    butterfly per part.  ``butterfly`` as in :func:`sharded_qgemul_k_tree`.
    """
    from ..complex import cmul, cmul_tf
    from ..hostops import complex_mul_basic, complex_mul_tf
    from ..ops.cgemm import _part_formats, _split_layers, cgemul

    if a.real.ndim != 2 or b.real.ndim != 2:
        raise ValueError("k_tree shards 2-D complex GEMMs (dp for batches)")
    _check_ctraceable(a, b, out_fmt, algo, add_formats, mul_tags,
                      "sharded_cgemul_k_tree")
    orf, oif = _part_formats(out_fmt)
    k = a.shape[-1]
    tp = mesh.shape["tp"]
    s, q, E, n_nodes = _k_tree_split(k, tp)
    r_layers, i_layers = _split_layers(add_formats)
    r_layers, i_layers = tuple(r_layers), tuple(i_layers)
    top_r = _shift_layers(r_layers, s)
    top_i = _shift_layers(i_layers, s)
    # per-part product formats (tag quirks included) -> level-s node
    # formats for the q == 1 local cgemul
    mulh = complex_mul_tf if algo == "tf" else complex_mul_basic
    (_z1, pr_fmt), (_z2, pi_fmt) = mulh(
        ((0, a.real.fmt), (0, a.imag.fmt)),
        ((0, b.real.fmt), (0, b.imag.fmt)), **mul_tags)
    node_r = _node_format(pr_fmt, r_layers, s)
    node_i = _node_format(pi_fmt, i_layers, s)
    use_bf = _bf_ok(q, s, tp, n_nodes, butterfly)
    pad = tp * E - k
    m, n = a.real.shape[0], b.real.shape[-1]

    def block(la, lb):
        if q == 1 and s >= 1:
            loc = cgemul(la, lb, (node_r, node_i), algo=algo,
                         add_formats=add_formats, **mul_tags)

            def fold_one(t, layers, top, of):
                if use_bf:
                    topv = _butterfly_fold(t, layers, s, mesh)
                else:
                    nodes = _gather_nodes(_unsqueeze0(t), mesh)[0:n_nodes]
                    topv = qreduce(nodes, top, axis=0)
                return ew.qcast(topv, of or topv.fmt)

            return _complex(fold_one(loc.real, r_layers, top_r, orf),
                            fold_one(loc.imag, i_layers, top_i, oif))
        mulfn = cmul_tf if algo == "tf" else cmul
        pa = _complex(*(_unsqueeze_last(t) for t in _cparts(la)))
        pb = _complex(*(_unsqueeze0(t) for t in _cparts(lb)))
        prod = mulfn(pa, pb, **mul_tags)         # [m, E, n] a part

        def fold(t, layers, top, of):
            if s == 0:
                nodes = _moveaxis(t, 1, 0)
            else:
                sub = qreduce(_reshape(t, (m, q, 1 << s, n)), layers,
                              axis=-2)            # [m, q, n]
                nodes = _moveaxis(sub, 1, 0)
            real_nodes = _gather_nodes(nodes, mesh)[0:n_nodes]
            topv = qreduce(real_nodes, top, axis=0)
            return ew.qcast(topv, of or topv.fmt)

        return _complex(fold(prod.real, r_layers, top_r, orf),
                        fold(prod.imag, i_layers, top_i, oif))

    return _program(("ck_tree", _cfmts(a), _cfmts(b), out_fmt, algo,
                     add_formats, mul_tags, k, m, n, use_bf), mesh, block,
                    _complex(*(_block(_pad_k(t, 1, pad), mesh, (None, "tp"))
                               for t in _cparts(a))),
                    _complex(*(_block(_pad_k(t, 0, pad), mesh, ("tp", None))
                               for t in _cparts(b))))


def sharded_cgemul_dp(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                      add_formats=(), **mul_tags):
    """Shard the leading batch dim of a batched complex GEMM over the whole
    mesh (dp x tp): each rank runs the complex GEMMs of its batch slice.
    Bit-exact for every config."""
    from ..ops.cgemm import cgemul

    if a.real.ndim < 3:
        raise ValueError("dp strategy needs a batched LHS [batch, m, k]")
    _check_ctraceable(a, b, out_fmt, algo, add_formats, mul_tags,
                  "sharded_cgemul_dp")
    n_dev = mesh.shape["dp"] * mesh.shape["tp"]
    if a.real.shape[0] % n_dev:
        raise ValueError(
            f"batch dim {a.real.shape[0]} not divisible by {n_dev} devices")
    spec_a = (("dp", "tp"),)
    spec_b = spec_a if b.real.ndim == a.real.ndim else ()

    def block(la, lb):
        c = cgemul(la, lb, out_fmt, algo=algo, add_formats=add_formats,
                   **mul_tags)
        return _cwhole(c, mesh, spec_a)

    return _program(("cdp", _cfmts(a), _cfmts(b), out_fmt, algo,
                     add_formats, mul_tags, spec_b), mesh, block,
                    _cblock(a, mesh, spec_a), _cblock(b, mesh, spec_b))


def sharded_cgemul_mn(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                      add_formats=(), **mul_tags):
    """Shard M over dp, N over tp; each rank computes whole complex dots
    for its block: bit-exact for every config."""
    from ..ops.cgemm import cgemul

    _check_ctraceable(a, b, out_fmt, algo, add_formats, mul_tags,
                      "sharded_cgemul_mn")

    def block(la, lb):
        c = cgemul(la, lb, out_fmt, algo=algo, add_formats=add_formats,
                   **mul_tags)
        return _cwhole(c, mesh, ("dp", "tp"))

    return _program(("cmn", _cfmts(a), _cfmts(b), out_fmt, algo,
                     add_formats, mul_tags), mesh, block,
                    _cblock(a, mesh, ("dp", None)),
                    _cblock(b, mesh, (None, "tp")))


def sharded_cgemul_k(a, b, out_fmt, mesh: Mesh, algo: str = "basic",
                     add_formats=(), reduce_scatter: bool = False,
                     **mul_tags):
    """Shard the contraction dim over ``tp``: each rank computes the
    complex fast path's partial integer dots (3 or 4 for TF, 4 for Basic,
    on K1) of its K-slice; the dots sum over tp (psum, or a reduce-scatter
    with ``reduce_scatter=True``) before the exact shift/combine epilogue.
    Dots beyond int32 run as limb dots and sum with the carry-correct limb
    psum.  Requires the fast path's proof (``ValueError`` otherwise)."""
    from ..ops.cgemm import _fast_cgemul, _LimbPlan, _part_formats, \
        _split_layers

    k = a.shape[-1]
    tp = mesh.shape["tp"]
    if k % tp:
        raise ValueError(f"K={k} not divisible by tp={tp}")
    if reduce_scatter and b.shape[-1] % tp:
        raise ValueError(
            f"N={b.shape[-1]} not divisible by tp={tp} (reduce_scatter "
            f"shards the output's N dim)")
    orf, oif = _part_formats(out_fmt)
    r_layers, i_layers = _split_layers(add_formats)
    # the proof and the domain at the GLOBAL k and the whole output's caps
    cap = (a.shape[0], b.shape[-1])
    fp = _cfast_plan(a, b, out_fmt, algo, add_formats, mul_tags)
    if fp is None:
        raise ValueError(
            "K-sharded cgemul needs the lossless fast-path proof; this "
            "config is order-sensitive - use strategy='mn'")
    if isinstance(fp, _LimbPlan):
        # the JAX package's limb hook sums 16-bit columns: the same bound
        _check_psum_tp(mesh)
    if reduce_scatter:
        def red(d):
            return C.psum_scatter(d, mesh, "tp", dim=1)

        def lred(d):
            return _psum_limbs(d, mesh, True)
    else:
        def red(d):
            return C.psum(d, mesh, "tp")

        def lred(d):
            return _psum_limbs(d, mesh, False)

    def block(la, lb):
        c = _fast_cgemul(la, lb, orf, oif, algo, r_layers, i_layers,
                         mul_tags, dot_reduce=red, limb_dot_reduce=lred,
                         k_total=k, cap_mn=cap)
        if c is None:
            raise ValueError(
                "K-sharded cgemul needs the lossless fast-path proof; this "
                "config is order-sensitive - use strategy='mn'")
        return _cwhole(c, mesh, (None, "tp")) if reduce_scatter else c

    return _program(("ck", _cfmts(a), _cfmts(b), orf, oif, algo, r_layers,
                     i_layers, mul_tags, k, cap, bool(reduce_scatter)),
                    mesh, block, _cblock(a, mesh, (None, "tp")),
                    _cblock(b, mesh, ("tp", None)))


_CSTRATEGIES = {
    "k": sharded_cgemul_k,
    "k_tree": sharded_cgemul_k_tree,
    "mn": sharded_cgemul_mn,
    "dp": sharded_cgemul_dp,
}


# ---------------------------------------------------------------------------
# Sharded Qreduce
# ---------------------------------------------------------------------------

def sharded_qreduce(x: QTensor, layer_formats=(), axis: int = -1,
                    mesh: Mesh = None, batch_axis: int = 0) -> QTensor:
    """Batch-sharded tree reduction: ``batch_axis`` split over the whole
    mesh (dp x tp), the exact tree of each lane run locally (``qreduce``,
    K3 on the card); bit-exact for every config."""
    if x.ndim < 2:
        raise ValueError("sharded_qreduce needs a batch axis; "
                         "use sharded_qreduce_k for 1-D inputs")
    if batch_axis % x.ndim == axis % x.ndim:
        raise ValueError("batch_axis must differ from the reduction axis")
    n_dev = mesh.shape["dp"] * mesh.shape["tp"]
    if x.shape[batch_axis] % n_dev:
        raise ValueError(
            f"batch dim {x.shape[batch_axis]} not divisible by {n_dev}")
    red_axis = axis % x.ndim
    spec = [None] * x.ndim
    spec[batch_axis % x.ndim] = ("dp", "tp")
    out_spec = [s for i, s in enumerate(spec) if i != red_axis]
    # a reduction that takes a host route raises
    if x.is_host or reduce_format(x.fmt, layer_formats,
                                  x.shape[red_axis]) is None:
        raise ValueError(_RHOST_MSG.format(who="sharded_qreduce"))

    def block(lx):
        return _whole(qreduce(lx, layer_formats, axis=red_axis), mesh,
                      out_spec)

    return _program(("qr", x.fmt, layer_formats, red_axis, spec, out_spec),
                    mesh, block, _block(x, mesh, spec))


def sharded_qreduce_k(x: QTensor, layer_formats=(),
                      mesh: Mesh = None) -> QTensor:
    """Reduction-axis-sharded tree reduction of a vector under the lossless
    tree proof (``tree_exact``): each rank sums its slice exactly (int32,
    int64 or stacked limbs, by the sum's width), the partials psum, and one
    requantize gives the tree's value."""
    from ..ops.gemm import tree_exact
    from ..ops.limbdot import limb_axis_sum, to_limbs_any
    from ..ops.reduce import _normalize
    from ..ops.widths import (LIMB_INTER_MAX_BITS, requant_work_bits,
                              route_requant)

    layer_formats = _normalize(layer_formats)
    if x.ndim != 1:
        raise ValueError("sharded_qreduce_k reduces a 1-D vector")
    n = x.shape[0]
    tp = mesh.shape["tp"]
    if n % tp:
        raise ValueError(f"n={n} not divisible by tp={tp}")
    final_fmt = tree_exact(fmt_interval(x.fmt), x.fmt, layer_formats, n)
    if final_fmt is None:
        raise ValueError(
            "sharded_qreduce_k needs a lossless tree proof; this config is "
            "order-sensitive - use the batch-sharded form or a single chip")
    total_iv = fmt_interval(x.fmt)
    total_iv = Interval(min(total_iv.lo * n, total_iv.lo),
                        max(total_iv.hi * n, total_iv.hi))
    # the sum's regime, as in the JAX package: int32; the 64-bit domain
    # (lane or pair values and final formats); else stacked limbs
    frac = x.fmt.frac_bits
    regime = "i32" if total_iv.fits32 else "pair"
    limb_k = None
    if regime == "pair" and not (
            total_iv.fits64 and not x.is_limb and not x.is_host
            and storage_kind(final_fmt) in ("lane", "pair")
            and route_requant(total_iv, frac, final_fmt)
            in ("i32", "pair")):
        regime = "limb"
    if regime != "i32":
        _check_psum_tp(mesh)
    if regime == "limb":
        need = max(total_iv.bits,
                   requant_work_bits(total_iv, frac, final_fmt))
        if x.is_host or storage_kind(final_fmt) is None \
                or need > LIMB_INTER_MAX_BITS:
            raise ValueError(
                "sum outgrows the device limb working envelope - use the "
                "batch-sharded form")
        limb_k = L.bits_to_limbs(need)
    out_dtype = torch_dtype_for(final_fmt)
    if regime == "i32":
        if out_dtype is None:
            raise ValueError(
                "sharded_qreduce_k writes int32 lanes; this reduction's "
                "final format needs wider storage - use the batch-sharded "
                "form")
        if route_requant(total_iv, frac, final_fmt) != "i32":
            raise ValueError(
                "the requantize epilogue outgrows int32 lanes for this "
                "config - use the batch-sharded form")

    def block(lx):
        if regime == "i32":
            tot = C.psum(lx.data.to(torch.int32).sum(dim=0, keepdim=True,
                                                     dtype=torch.int32),
                         mesh, "tp")
            raw = requantize_i32(tot, frac, final_fmt).to(out_dtype)
            return QTensor(raw[0], final_fmt)
        if regime == "limb":
            part = limb_axis_sum(to_limbs_any(lx.data, limb_k), 0)
            tot = _psum_limbs(part.reshape(limb_k, 1), mesh, False)
            raw = L.requantize_limb(tot, frac, final_fmt)
            return ew._finish(raw, final_fmt)[0]
        tot = C.psum(lx.data.to(torch.int64).sum(dim=0, keepdim=True),
                     mesh, "tp")
        return ew._finish(requantize_i64(tot, frac, final_fmt),
                          final_fmt)[0]

    return _program(("qrk", x.fmt, frac, final_fmt, regime, limb_k), mesh,
                    block, _block(x, mesh, ("tp",)))


def sharded_qreduce_k_tree(x: QTensor, layer_formats=(),
                           mesh: Mesh = None,
                           butterfly: Optional[bool] = None) -> QTensor:
    """Reduction-axis sharding of an ORDER-SENSITIVE tree reduction (the
    Qreduce analogue of :func:`sharded_qgemul_k_tree`): the vector splits
    on level-``s`` subtree boundaries, each rank folds complete subtrees,
    the ``n/2^s`` nodes all-gather and the top layers fold with the
    shifted formats (ragged ``n``: pad nodes dropped after the gather).
    One-node-per-rank power-of-2 splits fold by the ppermute butterfly;
    ``butterfly`` as in :func:`sharded_qgemul_k_tree`."""
    from ..ops.reduce import _normalize

    layer_formats = _normalize(layer_formats)
    if x.ndim != 1:
        raise ValueError("sharded_qreduce_k_tree reduces a 1-D vector")
    if x.is_host:
        raise ValueError("host-storage values cannot run inside shard_map")
    n = x.shape[0]
    tp = mesh.shape["tp"]
    s, q, E, n_nodes = _k_tree_split(n, tp)
    if reduce_format(x.fmt, layer_formats, n) is None:
        raise ValueError(_RHOST_MSG.format(who="sharded_qreduce_k_tree"))
    top_layers = _shift_layers(layer_formats, s)
    use_bf = _bf_ok(q, s, tp, n_nodes, butterfly)

    def block(lx):
        if s == 0:
            nodes = lx                                   # [E] raw elements
        else:
            nodes = qreduce(_reshape(lx, (q, 1 << s)), layer_formats,
                            axis=1)                      # [q]
        if use_bf:
            return _butterfly_fold(nodes, layer_formats, s, mesh)[0]
        real = _gather_nodes(nodes, mesh)[0:n_nodes]
        return qreduce(real, top_layers, axis=0)

    return _program(("qrk_tree", x.fmt, layer_formats, n, use_bf), mesh,
                    block, _block(_pad_k(x, 0, tp * E - n), mesh, ("tp",)))
