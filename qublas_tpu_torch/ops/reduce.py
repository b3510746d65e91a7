"""Per-layer formats of the Qreduce tree (port of
``qublas_tpu.ops.reduce.layer_format``; the reduce op itself is still to be
ported, ROADMAP item 8)."""

from __future__ import annotations

__all__ = ["layer_format"]


def layer_format(layer_formats, layer: int):
    """Per-layer output format: ``TypeAt<min(layer, len-1)>``
    (QuBLAS.h:4913); None when no layer formats are given."""
    if not layer_formats:
        return None
    return layer_formats[min(layer, len(layer_formats) - 1)]
