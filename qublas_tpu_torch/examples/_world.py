"""The world that the examples' sharded steps run in."""

from __future__ import annotations

import torch

from ..parallel.launch import run_world


def world_for(device) -> tuple:
    """(ranks, backend) of an example's world: one NCCL rank on the card
    (NCCL takes one card a rank), two Gloo ranks on the CPU."""
    if torch.device(device).type == "cuda":
        return 1, "nccl"
    return 2, "gloo"


def run_sharded(fn, args, device, timeout: float = 300.0) -> list:
    """``fn(*args)`` on every rank of the world of :func:`world_for`, its
    results in rank order."""
    world, backend = world_for(device)
    return run_world(world, backend, fn, args, timeout)
