"""Spawn a world of ranks on this machine and collect what each returns.

    results = run_world(world, backend, fn, args, timeout=600)

starts ``world`` processes (``multiprocessing``'s spawn context: each a
fresh interpreter that imports ``fn``'s module, never its caller's
modules), joins each to a process group of ``backend`` on a free localhost
port (:func:`~.collectives.init_distributed`), calls ``fn(*args)`` there
and returns the list of its results, rank by rank.  A rank that raises, or
a world that outlasts ``timeout`` seconds, stops every rank and raises
``RuntimeError`` with what the ranks reported: nothing carries on after a
failed rank.
"""

from __future__ import annotations

import multiprocessing as mp
import time
import traceback
from multiprocessing.connection import wait

__all__ = ["run_world", "start_world", "World"]


def _rank_main(rank, world, backend, port, timeout, fn, args, conn):
    try:
        import torch.distributed as dist

        from .collectives import init_distributed

        init_distributed(f"localhost:{port}", world, rank, backend=backend,
                         timeout=timeout)
        res = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
        conn.send(("ok", res))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class World:
    """A running world (:func:`start_world`); :meth:`join` collects it."""

    def __init__(self, world: int, backend: str, fn, args, timeout: float):
        from .collectives import free_port

        ctx = mp.get_context("spawn")
        port = free_port()
        self.timeout = timeout
        self.t0 = time.monotonic()
        self.procs, self.conns = [], []
        for rank in range(world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main,
                            args=(rank, world, backend, port, timeout, fn,
                                  args, send),
                            name=f"rank{rank}", daemon=True)
            p.start()
            send.close()
            self.procs.append(p)
            self.conns.append(recv)

    def join(self) -> list:
        """Each rank's result, in rank order; raises ``RuntimeError`` if a
        rank failed or the world outlasted its timeout (every rank is
        stopped first)."""
        results = [None] * len(self.procs)
        errors = []
        pending = set(range(len(self.procs)))
        try:
            while pending:
                left = self.timeout - (time.monotonic() - self.t0)
                if left <= 0:
                    errors.append(f"ranks {sorted(pending)}: no result "
                                  f"within {self.timeout} s")
                    break
                ready = wait([self.conns[r] for r in pending],
                             timeout=min(left, 5.0))
                for conn in ready:
                    r = self.conns.index(conn)
                    pending.discard(r)
                    try:
                        status, val = conn.recv()
                    except EOFError:
                        status, val = "error", (f"exited with code "
                                                f"{self.procs[r].exitcode}")
                    if status == "ok":
                        results[r] = val
                    else:
                        errors.append(f"rank {r}:\n{val}")
                if errors:
                    break
        finally:
            self.stop()
        if errors:
            raise RuntimeError("world failed:\n" + "\n".join(errors))
        return results

    def stop(self):
        """Stop every rank still running."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=30)
        for c in self.conns:
            c.close()


def start_world(world: int, backend: str, fn, args=(),
                timeout: float = 600.0) -> World:
    """Start ``world`` ranks running ``fn(*args)`` (see the module's
    docstring) and return at once; :meth:`World.join` waits."""
    return World(world, backend, fn, tuple(args), timeout)


def run_world(world: int, backend: str, fn, args=(),
              timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on each of ``world`` ranks; their results in rank
    order (see the module's docstring)."""
    return start_world(world, backend, fn, args, timeout).join()
