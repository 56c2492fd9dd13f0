"""A dtype-exact state snapshot with no template, for bit-exact crash
recovery (checkpoint/federated.py): ``state_flatten`` /
``state_unflatten``, the port's counterpart of
``src/repro/checkpoint/serialization.py``'s ``state_flatten`` /
``state_unflatten``.  A JSON manifest holds the structure (dict, tuple,
list, None) and the Python scalars; each tensor or numpy array goes into
the npz with its dtype exactly, a dtype numpy lacks (bfloat16) as its raw
bits in an unsigned integer of its width.  Tensors are saved from the
host and restored onto the run's device (a tensor saved from the CPU
stays there); numpy arrays stay numpy arrays, and Python ints stay ints.

Not ported: the reference's template snapshot (``flatten_tree``,
``unflatten_into``, ``save_npz``, ``load_npz``), whose one caller is its
launch layer's training loop.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# the integer dtypes of a width that carry a tensor's raw bits: torch's
# (signed, the ones it views freely) and numpy's (unsigned, the npz form)
_BITS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16),
         4: (torch.int32, np.uint32), 8: (torch.int64, np.uint64)}


def state_flatten(state):
    """-> (manifest, {name: np.ndarray}) for ``np.savez`` and json."""
    arrays: Dict[str, np.ndarray] = {}

    def leaf(kind, arr, **extra):
        node: Dict[str, Any] = {"t": kind, "id": f"a{len(arrays)}", **extra}
        arrays[node["id"]] = arr
        return node

    def rec(t):
        if t is None:
            return {"t": "none"}
        if isinstance(t, dict):
            items = list(t.items())
            return {"t": "dict", "k": [k for k, _ in items],
                    "v": [rec(v) for _, v in items]}
        if isinstance(t, tuple):
            return {"t": "tuple", "v": [rec(x) for x in t]}
        if isinstance(t, list):
            return {"t": "list", "v": [rec(x) for x in t]}
        if isinstance(t, (bool, int, float, str)):
            return {"t": "py", "v": t}
        if torch.is_tensor(t):
            x = t.detach().to("cpu").contiguous()
            name = str(x.dtype).removeprefix("torch.")
            try:
                arr, raw = x.numpy(), False
            except TypeError:              # bfloat16 and the like
                as_int, unsigned = _BITS[x.element_size()]
                arr, raw = x.view(as_int).numpy().view(unsigned), True
            return leaf("tensor", arr, dtype=name, raw=raw,
                        host=t.device.type == "cpu")
        arr = np.asarray(t)
        if arr.dtype.kind not in "biufc":
            raise TypeError(f"state_flatten: no exact npz form for "
                            f"{arr.dtype}")
        return leaf("numpy", arr)

    return rec(state), arrays


def state_unflatten(manifest, arrays: Dict[str, np.ndarray], device="cpu"):
    """Inverse of ``state_flatten`` (the manifest may have round-tripped
    through JSON); tensors saved from a device go onto ``device``."""

    def rec(n):
        t = n["t"]
        if t == "none":
            return None
        if t == "dict":
            return {k: rec(v) for k, v in zip(n["k"], n["v"])}
        if t == "tuple":
            return tuple(rec(x) for x in n["v"])
        if t == "list":
            return [rec(x) for x in n["v"]]
        if t == "py":
            return n["v"]
        arr = arrays[n["id"]]
        if t == "numpy":
            return arr
        dtype = getattr(torch, n["dtype"])
        if n["raw"]:
            as_int = _BITS[dtype.itemsize][0]
            x = torch.from_numpy(np.array(arr).view(
                torch.empty(0, dtype=as_int).numpy().dtype)).view(dtype)
        else:
            x = torch.from_numpy(np.array(arr))
        return x if n["host"] else x.to(device)

    return rec(manifest)
