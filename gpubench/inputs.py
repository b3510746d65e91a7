"""The benchmark's one generator: weights and a pool of input batches,
made on the device from the seed.

A configuration gives, per operand, the raws' distribution
(``{"low", "high"}`` inclusive, and an ``outlier_share`` of raws drawn
from the format's whole range instead); its reference gives the shapes and
formats; the traffic gives how many distinct batches the pool holds.  The
draws run on the device, a few large calls per operand, in a fixed order,
so one seed gives the same tensors on every run.
"""

from __future__ import annotations

import torch

LANES = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def draw(g: torch.Generator, spec: dict, shape, fmt, device) -> torch.Tensor:
    """Raws of ``fmt`` in its storage lane, distributed as ``spec``."""
    dtype = LANES[fmt.storage_bytes]
    if not fmt.raw_min <= spec["low"] <= spec["high"] <= fmt.raw_max:
        raise ValueError(f"raws [{spec['low']}, {spec['high']}] outside "
                         f"the format's [{fmt.raw_min}, {fmt.raw_max}]")
    t = torch.randint(spec["low"], spec["high"] + 1, shape, generator=g,
                      device=device, dtype=dtype)
    share = spec.get("outlier_share", 0)
    if share:
        wide = torch.randint(fmt.raw_min, fmt.raw_max + 1, shape,
                             generator=g, device=device, dtype=dtype)
        pick = torch.rand(shape, generator=g, device=device) < share
        t = torch.where(pick, wide, t)
    return t


def make(reference, config: dict, traffic: dict, seed: int, device):
    """(weights, pool): the operands that stay, by name, and
    ``traffic["pool"]`` distinct batches of the pooled one."""
    g = generator(seed, device)
    shapes = reference.operands(config, traffic)
    specs = config["operands"]
    weights = {name: draw(g, specs[name], shape, fmt, device)
               for name, (shape, fmt) in shapes.items()
               if name != reference.POOLED}
    shape, fmt = shapes[reference.POOLED]
    pool = [draw(g, specs[reference.POOLED], shape, fmt, device)
            for _ in range(traffic["pool"])]
    return weights, pool
