"""The (dp, tp) mesh and its collectives on ``torch.distributed``.

The JAX package shards with ``jax.sharding.Mesh`` and ``shard_map``; its
collectives are ``psum``, ``psum_scatter``, ``all_gather`` and
``ppermute`` over a named mesh axis.  Here a mesh is a grid of processes
(one rank a process): global rank ``r = d * tp + t`` sits at ``(dp=d,
tp=t)``, as ``jax.devices()`` reshaped to ``(dp, tp)`` does, and each axis
has one process group per line of the grid.  The wrappers below are the
named-axis collectives on those groups:

==========================  ================================================
JAX                         here
==========================  ================================================
``psum(x, ax)``             :func:`psum`: ``all_reduce(SUM)``
``psum_scatter(x, ax,       :func:`psum_scatter`: ``reduce_scatter`` of a
scatter_dimension=d,        contiguous copy with the group's blocks of dim
tiled=True)``               ``d`` first (both backends split dim 0)
``all_gather(x, ax,         :func:`all_gather`: ``all_gather_into_tensor``
axis=d, tiled=True)``       on dim 0, then the blocks joined along ``d``
``ppermute(x, ax, perm)``   :func:`ppermute`: ``batch_isend_irecv`` of the
                            pairs
``axis_index(ax)``          :meth:`Mesh.get_local_rank`
==========================  ================================================

Each wrapper has two forms.  Called eagerly it is the plain version above,
on ``torch.distributed``'s collectives.  Traced by ``torch.compile`` (a
strategy's program, :mod:`.sharding`) it is the traceable form on
``torch.distributed._functional_collectives`` over the same process
groups: ``all_reduce``, ``reduce_scatter_tensor``, ``all_gather_tensor``,
and ``permute_tensor`` of the flattened payload for a ppermute (the
functional collectives split dim 0, so the payload goes flat; a partial
perm is the same ``all_to_all_single`` with the idle ranks' splits 0).  Both
forms give the same bits and count the same calls and bytes.  On a staged
mesh (below) a traced form keeps its host copies in the program, but for a
psum: Inductor copies an all-reduce's input first, and that copy in host
memory would be a CPU kernel of its C++ backend, so Gloo is handed the
card's tensor and stages it itself.

The backend is the caller's (:func:`init_distributed`): NCCL takes the
device tensors as they are.  Gloo takes host tensors: on a Gloo mesh whose
compute device is the card, every payload is copied to host memory, sent,
and copied back, the same way for every collective (several ranks sharing
one card is such a mesh).  Gloo sums int32 and int64 and moves bytes, so
sums take int32/int64 payloads and the moves send a tensor's bytes.
Each mesh counts, in ``Mesh.stats``, the collectives this rank makes on
it and the payload bytes it hands them.  A compiled program's collectives
are counted when Dynamo traces it (:func:`recording`, run at trace time
through ``torch.compiler.assume_constant_result``) and added to its mesh's
stats on each of its calls, so a compiled call counts what the eager call
counts.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import socket
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

__all__ = ["Mesh", "init_distributed", "make_mesh", "psum", "psum_scatter",
           "all_gather", "ppermute", "unshard", "free_port"]

_AXES = ("dp", "tp")

_TOKENS = itertools.count()
# .notes: the payload bytes of each collective of the program being run,
# which its trace fills (recording)
_RECORD = threading.local()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl",
                     timeout: Optional[float] = None) -> int:
    """Join the process group (``qublas_tpu.parallel.init_distributed``'s
    counterpart) and return the world size.

    ``coordinator_address`` is ``host:port`` of rank 0, ``num_processes``
    the world size and ``process_id`` this rank; a world of one process
    needs no address.  ``backend`` is ``"nccl"`` (one card a rank) or
    ``"gloo"`` (host memory: the CPU, or several ranks on one card).
    ``timeout`` bounds every collective, in seconds.  A process already in
    a group keeps it."""
    if not dist.is_initialized():
        world = 1 if num_processes is None else int(num_processes)
        rank = 0 if process_id is None else int(process_id)
        if coordinator_address is None:
            if world > 1:
                raise ValueError("a world of several processes needs the "
                                 "coordinator's address")
            coordinator_address = f"localhost:{free_port()}"
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        if backend == "nccl":
            # one card a rank, as NCCL requires
            kw["device_id"] = torch.device(
                "cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(kw["device_id"])
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank, **kw)
    return dist.get_world_size()


class Mesh:
    """A (dp, tp) grid of the processes of the default group.

    ``shape`` is ``{"dp": dp, "tp": tp}`` as on a JAX mesh; ``device`` is
    where this rank computes; ``backend`` is the group's; ``stats`` counts
    the collectives this rank makes on the mesh and the payload bytes it
    hands them; ``programs`` is how the sharded strategies run on it (None:
    eagerly, else the keywords of ``torch.compile`` as sorted pairs, see
    :func:`make_mesh`); ``token`` names the mesh in this process (the
    program cache's keys hold it).  Built by
    :func:`make_mesh`, collectively: every rank creates the same groups in
    the same order."""

    def __init__(self, dp: int, tp: int, device: torch.device,
                 programs=None):
        self.shape = {"dp": dp, "tp": tp}
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.staged = self.backend == "gloo" and device.type != "cpu"
        self.programs = _programs(programs, device)
        self.stats = {"calls": 0, "bytes": 0}
        self.token = f"mesh{next(_TOKENS)}"
        self._groups = {}
        for d in range(dp):
            ranks = [d * tp + t for t in range(tp)]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups["tp"] = (g, ranks)
        for t in range(tp):
            ranks = [d * tp + t for d in range(dp)]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups["dp"] = (g, ranks)
        self._groups[_AXES] = (dist.group.WORLD,
                               list(range(dp * tp)))

    def get_local_rank(self, axis: str) -> int:
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        tp = self.shape["tp"]
        return self.rank // tp if axis == "dp" else self.rank % tp

    def group(self, axes):
        """(process group, its global ranks in group order) of this rank's
        line along ``axes``: ``"dp"``, ``"tp"`` or ``("dp", "tp")``."""
        return self._groups[_key(axes)]

    def __repr__(self):
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"device={self.device}, backend={self.backend}, "
                f"programs={self.programs})")


def _programs(programs, device: torch.device):
    """``make_mesh``'s ``programs`` as ``Mesh.programs``: None for eager,
    else ``torch.compile``'s keywords as sorted (name, value) pairs."""
    if programs is None:
        programs = {"backend": "inductor"} if device.type == "cuda" \
            else "eager"
    if programs == "eager":
        return None
    bad = set(programs) - {"backend", "mode"}
    if bad:
        raise ValueError(f"programs takes torch.compile's backend and mode, "
                         f"not {sorted(bad)}")
    return tuple(sorted(programs.items()))


def _key(axes):
    if isinstance(axes, str):
        return axes
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else _AXES


def make_mesh(dp: int = 1, tp: Optional[int] = None, devices=None,
              programs=None) -> Mesh:
    """Build a (dp, tp) mesh over the default group (call on every rank).
    ``tp`` defaults to the ranks left over; ``devices`` is where this rank
    computes, the card unless the caller names another.

    ``programs`` is how the sharded strategies run on the mesh: each
    rank's program compiled (``torch.compile`` with ``fullgraph=True,
    dynamic=False`` and the keywords of this dict: ``backend``, ``mode``)
    and kept in the program cache, or ``"eager"``.  None takes
    the device's default: Inductor on the card, as the JAX package always
    jits, and eager (the plain version) on the CPU."""
    world = dist.get_world_size()
    if tp is None:
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"{world} devices != dp({dp}) * tp({tp})")
    device = torch.device("cuda" if devices is None else devices)
    return Mesh(dp, tp, device, programs)


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------

def _out(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` where the group's backend reads it: host memory on a staged
    mesh, else where it is."""
    return x.cpu() if mesh.staged else x


def _back(mesh: Mesh, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(like.device) if mesh.staged else y


def _traced() -> bool:
    """Whether Dynamo is tracing the caller (a compiled program)."""
    return torch.compiler.is_compiling()


@contextlib.contextmanager
def recording(notes: list):
    """Run a compiled program's call with ``notes`` as its record: a trace
    of the program during the call (its first, or a recompile) refills
    ``notes`` with the payload bytes of each collective it makes, which the
    program adds to its mesh's stats after each call.  A collective traced
    outside a recording is not counted."""
    outer = getattr(_RECORD, "notes", None)
    _RECORD.notes = notes
    try:
        yield
    finally:
        _RECORD.notes = outer


@torch.compiler.assume_constant_result
def trace_begins() -> int:
    """Called first in a compiled program: Dynamo runs it when the trace
    starts (again if it restarts), which empties the record."""
    notes = getattr(_RECORD, "notes", None)
    if notes is not None:
        notes.clear()
    return 0


@torch.compiler.assume_constant_result
def _note(nbytes: int) -> int:
    # run by Dynamo when it traces the collective, not by the graph
    notes = getattr(_RECORD, "notes", None)
    if notes is not None:
        notes.append(nbytes)
    return 0


def _count(mesh: Mesh, x: torch.Tensor):
    nbytes = x.numel() * x.element_size()
    if _traced():
        _note(nbytes)
    else:
        mesh.stats["calls"] += 1
        mesh.stats["bytes"] += nbytes


def _sum_payload(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sums take int32 or int64 payloads, got {x.dtype}")
    return x.contiguous()


def psum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of this rank's line along ``axes``
    (int32 sums wrap mod 2^32, int64 mod 2^64)."""
    g, _ = mesh.group(axes)
    y = _sum_payload(x)
    if _traced():
        # Inductor copies an all-reduce's input first: on a staged mesh
        # Gloo is handed the card's tensor (it stages a CUDA all-reduce
        # through host memory itself), so that copy is a kernel on the card
        # and the program holds no CPU kernel
        _count(mesh, y)
        return funcol.all_reduce(y, "sum", g)
    y = y.cpu() if mesh.staged else y.clone()   # all_reduce sums in place
    _count(mesh, y)
    dist.all_reduce(y, group=g)
    return _back(mesh, y, x)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """Tiled ``psum_scatter`` along ``dim``: the sum over the line, of which
    this rank keeps block ``i`` of ``dim`` (``i`` its index in the line).
    The blocks go first in a contiguous copy, since both backends split
    dim 0."""
    g, ranks = mesh.group(axes)
    n = len(ranks)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} blocks")
    blocks = torch.stack(torch.chunk(_sum_payload(x), n, dim=dim))
    shape = blocks.shape[1:]
    # [n * rows, ...]: what Gloo's dim-0 split reads
    src = _out(mesh, blocks.reshape((-1,) + tuple(shape[1:])))
    _count(mesh, src)
    if _traced():
        out = funcol.reduce_scatter_tensor(src, "sum", 0, g)
    else:
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=g)
    return _back(mesh, out.reshape(shape), x)


def _gather_bytes(x: torch.Tensor, mesh: Mesh, axes) -> list:
    """Every rank's ``x`` of this rank's line along ``axes``, in line
    order (the same shape and dtype on every rank), moved as bytes."""
    g, ranks = mesh.group(axes)
    n = len(ranks)
    flat = _out(mesh, x.contiguous().reshape(-1).view(torch.uint8))
    _count(mesh, flat)
    if _traced():
        out = funcol.all_gather_tensor(flat, 0, g)
    else:
        out = torch.empty((n * flat.numel(),), dtype=torch.uint8,
                          device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=g)
    out = _back(mesh, out, x).view(x.dtype).reshape((n,) + tuple(x.shape))
    return list(out.unbind(0))


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """Tiled ``all_gather`` along ``dim``: the line's blocks joined along
    ``dim`` in line order."""
    return torch.cat(_gather_bytes(x, mesh, axes), dim=dim)


def ppermute(x: torch.Tensor, mesh: Mesh, axes, perm) -> torch.Tensor:
    """``ppermute`` over this rank's line: each ``(src, dst)`` pair of
    ``perm`` (indices along the line) sends src's ``x`` to dst.  A rank
    that receives nothing gets zeros, as in JAX."""
    g, ranks = mesh.group(axes)
    me = ranks.index(mesh.rank)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if _traced():
        return _ppermute_traced(x, mesh, g, len(ranks), perm, dst, src,
                                me)
    if dst == [me] and src == [me]:
        return x.clone()
    send = _out(mesh, x.contiguous()).view(torch.uint8) \
        if x.ndim else _out(mesh, x.reshape(1)).view(torch.uint8)
    recv = torch.zeros_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[d]) for d in dst]
    ops += [dist.P2POp(dist.irecv, recv, ranks[s]) for s in src]
    if ops:
        _count(mesh, send)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(mesh, recv, x).view(x.dtype).reshape(x.shape)


def _ppermute_traced(x, mesh, g, n, perm, dst, src, me) -> torch.Tensor:
    """:func:`ppermute`'s traceable form, one collective of the whole line
    unless every pair keeps its value: a full permutation is
    ``permute_tensor`` of the payload's bytes, flat (``src_dst[s]`` = the
    rank ``s`` sends to); a partial one the same ``all_to_all_single`` with the
    split sizes of the ranks that send or receive nothing set to 0, and
    zeros where nothing arrives.  It counts what the eager form counts: a
    rank that only keeps its own value, or takes no part, counts
    nothing."""
    if all(s == d for s, d in perm):
        return x.clone() if src else torch.zeros_like(x)
    flat = _out(mesh, x.reshape(-1).view(torch.uint8))
    if (dst or src) and not (dst == [me] and src == [me]):
        _count(mesh, flat)
    if len(perm) == n:
        to = dict(perm)
        y = funcol.permute_tensor(flat, [to[s] for s in range(n)], g)
    else:
        ins, outs = [0] * n, [0] * n
        for d in dst:
            ins[d] = flat.numel()
        for s in src:
            outs[s] = flat.numel()
        y = funcol.all_to_all_single(flat if dst else flat[:0], outs, ins, g)
        if not src:
            return torch.zeros_like(x)
    return _back(mesh, y, x).view(x.dtype).view(x.shape)


def unshard(x: torch.Tensor, mesh: Mesh, spec, lead: int = 0):
    """The whole of a tensor of which each rank holds block ``x``, as a
    JAX global array of ``out_specs`` ``spec`` reads whole: ``spec`` names,
    for each dim from ``lead`` on, the mesh axes it is split over
    (``None``, ``"dp"``, ``"tp"`` or ``("dp", "tp")``).  The blocks are
    gathered over the axes that split a dim; a replicated ``spec`` needs
    no collective."""
    used = set()
    for s in spec:
        if s is not None:
            used |= {s} if isinstance(s, str) else set(s)
    if not used:
        return x
    axes = _AXES if used == set(_AXES) else used.pop()
    _, ranks = mesh.group(axes)
    blocks = _gather_bytes(x, mesh, axes)
    tp = mesh.shape["tp"]
    grid = {}
    for r, blk in zip(ranks, blocks):
        d, t = divmod(r, tp)
        pos = tuple(0 if s is None else d if s == "dp" else t if s == "tp"
                    else r for s in spec)
        grid.setdefault(pos, blk)
    return _assemble(grid, lead)


def _assemble(grid: dict, dim: int) -> torch.Tensor:
    """Join blocks keyed by their position along dims ``dim``, ``dim+1``,
    ..."""
    if len(next(iter(grid))) == 0:
        return grid[()]
    rows = {}
    for pos, blk in grid.items():
        rows.setdefault(pos[0], {})[pos[1:]] = blk
    return torch.cat([_assemble(rows[i], dim + 1) for i in sorted(rows)],
                     dim=dim)
