"""Checkpoint and interchange of QTensor trees on torch.

Port of ``qublas_tpu.checkpoint``, with the same file layout, so that a file
saved by one package loads in the other with the same raws and formats:

* :func:`save` / :func:`load` — an ``.npz`` holding one array per tensor
  (keys ``t0``, ``t1``, ...; lane and pair raws as their int8/16/32 or
  int64 arrays, limb and host raws as exact decimal text) and a JSON spec
  of the tree under ``__spec__`` (QTensor, QComplexTensor, dict, list,
  tuple, scalars and arrays).  ``load`` places every QTensor on ``device``, the
  card unless the caller names another; plain arrays come back as numpy
  arrays, as in the JAX package.
* :func:`dumps_bits` / :func:`loads_bits` — the BitStream string as a
  self-describing record (a JSON header line, then the bits).

Host tensors (beyond 992 bits, or wart raws beyond the storage word) are
written as exact decimal text, as the JAX package writes them, and load
back into host storage, with ``device`` as their results' device.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from . import bitstream
from .complex import QComplexTensor
from .qformat import OverflowMode, QFormat, RoundMode
from .qtensor import QTensor, from_raw

__all__ = ["save", "load", "dumps_bits", "loads_bits"]


def _fmt_to_list(f: QFormat):
    return [f.int_bits, f.frac_bits, int(f.signed), int(f.round_mode),
            int(f.overflow_mode)]


def _fmt_from_list(v) -> QFormat:
    i, f, s, rm, om = (int(x) for x in v)
    return QFormat(i, f, bool(s), RoundMode(rm), OverflowMode(om))


def _encode(obj, arrays: dict):
    # array keys are a plain counter; the spec records each tensor's key
    if isinstance(obj, QTensor):
        key = f"t{len(arrays)}"
        if obj.is_limb or obj.is_host:
            # exact decimal text, as the JAX package writes limb and host
            # tensors (the BitStream format keeps only the logical width,
            # which would lose wart raws)
            dec = ",".join(str(int(v)) for v in obj.raw().reshape(-1))
            arrays[key] = np.frombuffer(dec.encode(), dtype=np.uint8)
            return {"__qt__": key, "fmt": _fmt_to_list(obj.fmt),
                    "shape": list(obj.shape), "wide": True, "enc": "dec"}
        arrays[key] = obj.raw()
        return {"__qt__": key, "fmt": _fmt_to_list(obj.fmt), "wide": False}
    if isinstance(obj, QComplexTensor):
        return {"__qc__": [_encode(obj.real, arrays),
                           _encode(obj.imag, arrays)]}
    if isinstance(obj, dict):
        return {"__d__": {k: _encode(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        enc = [_encode(v, arrays) for v in obj]
        return {"__l__": enc, "tuple": isinstance(obj, tuple)}
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return {"__v__": obj}
    if isinstance(obj, torch.Tensor):
        obj = obj.cpu().numpy()
    key = f"t{len(arrays)}"
    arrays[key] = np.asarray(obj)
    return {"__np__": key}


def _decode(spec, arrays: dict, device):
    if "__qt__" in spec:
        fmt = _fmt_from_list(spec["fmt"])
        data = arrays[spec["__qt__"]]
        if spec["wide"]:
            shape = tuple(spec["shape"])
            if spec.get("enc") == "dec":
                txt = bytes(data).decode()
                raws = [int(s) for s in txt.split(",")] if txt else []
                return from_raw(np.array(raws, dtype=object).reshape(shape),
                                fmt, device)
            # the JAX package's first checkpoints: BitStream-encoded
            return bitstream.from_bits(bytes(data).decode(), fmt, shape,
                                       twos_complement=True, device=device)
        # lane and pair raws keep their saved lane dtype, as the JAX
        # package's load does
        return QTensor(torch.from_numpy(np.ascontiguousarray(data)).to(device),
                       fmt)
    if "__qc__" in spec:
        r, i = spec["__qc__"]
        return QComplexTensor(_decode(r, arrays, device),
                              _decode(i, arrays, device))
    if "__d__" in spec:
        return {k: _decode(v, arrays, device)
                for k, v in spec["__d__"].items()}
    if "__l__" in spec:
        vals = [_decode(v, arrays, device) for v in spec["__l__"]]
        return tuple(vals) if spec["tuple"] else vals
    if "__v__" in spec:
        return spec["__v__"]
    return arrays[spec["__np__"]]


def save(path: str, tree: Any) -> None:
    """Write a tree of QTensor/QComplexTensor/arrays/scalars to ``path``
    (.npz).  Raw bits round-trip exactly; formats travel as metadata."""
    arrays: dict = {}
    spec = _encode(tree, arrays)
    arrays["__spec__"] = np.frombuffer(json.dumps(spec).encode(),
                                       dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def load(path: str, device="cuda") -> Any:
    """Inverse of :func:`save` (also of the JAX package's ``save``), with
    every QTensor placed on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    spec = json.loads(bytes(arrays.pop("__spec__")).decode())
    return _decode(spec, arrays, device)


def dumps_bits(t: QTensor, tensor_order=None, elem_order=None) -> str:
    """Self-describing BitStream record: one JSON header line, then the
    '0'/'1' stream (the JAX package's wire format)."""
    header = {
        "fmt": _fmt_to_list(t.fmt),
        "shape": list(t.shape),
        "tensor_order": _order_to_json(tensor_order),
        "elem_order": _order_to_json(elem_order),
    }
    return json.dumps(header) + "\n" + bitstream.to_bits(
        t, tensor_order, elem_order)


def loads_bits(s: str, device="cuda") -> QTensor:
    head, bits = s.split("\n", 1)
    h = json.loads(head)
    return bitstream.from_bits(
        bits, _fmt_from_list(h["fmt"]), tuple(h["shape"]),
        _order_from_json(h["tensor_order"]), _order_from_json(h["elem_order"]),
        twos_complement=True, device=device)


def _order_to_json(o):
    if o is None or o is bitstream.l2r or isinstance(o, bitstream.l2r):
        return None
    return o.chunk if isinstance(o, bitstream.r2l) else 1


def _order_from_json(v):
    return None if v is None else bitstream.r2l(int(v))
