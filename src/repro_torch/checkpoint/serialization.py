"""Tree serialization to npz.  Counterpart of
``src/repro/checkpoint/serialization.py``, in two forms:

- The template snapshot (``flatten_tree``, ``unflatten_into``,
  ``save_npz``, ``load_npz``; launch/train.py's checkpoints): the leaves
  under '/'-joined paths (dict keys sorted, list and tuple entries by
  index, ``None`` skipped), each copied to the host as numpy, a dtype
  numpy lacks (bfloat16) as float32; a restore rebuilds the template's
  structure and casts each leaf to the template leaf's dtype and device.
- A dtype-exact state snapshot with no template, for bit-exact crash
  recovery (checkpoint/federated.py): ``state_flatten`` /
  ``state_unflatten``.  A JSON manifest holds the structure (dict, tuple,
  list, None) and the Python scalars; each tensor or numpy array goes into
  the npz with its dtype exactly, a dtype numpy lacks (bfloat16) as its
  raw bits in an unsigned integer of its width.  Tensors are saved from
  the host and restored onto the run's device (a tensor saved from the
  CPU stays there); numpy arrays stay numpy arrays, and Python ints stay
  ints.
"""
from __future__ import annotations

import io
from typing import Any, Dict

import numpy as np
import torch

# the integer dtypes of a width that carry a tensor's raw bits: torch's
# (signed, the ones it views freely) and numpy's (unsigned, the npz form)
_BITS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16),
         4: (torch.int32, np.uint32), 8: (torch.int64, np.uint64)}


def _host_array(t) -> np.ndarray:
    """A leaf as a host numpy array: a tensor copied from its device, a
    bfloat16 one (no numpy dtype) as its float32 values."""
    if torch.is_tensor(t):
        t = t.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    arr = np.asarray(t)
    return arr if arr.dtype.kind in "biufc" else np.asarray(t, np.float32)


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'/'-joined path: host numpy array} of every leaf of ``tree``."""
    out: Dict[str, np.ndarray] = {}

    def rec(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                rec(t[k], f"{path}/{k}" if path else str(k))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                rec(v, f"{path}/{i}" if path else str(i))
        elif t is not None:
            out[path] = _host_array(t)

    rec(tree, prefix)
    return out


def unflatten_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """A tree shaped like ``template`` from ``flat`` (flatten_tree's form):
    a tensor leaf comes back on the template leaf's device in its dtype, a
    numpy leaf as numpy in its dtype, anything else as the stored array;
    a list stays a list, a tuple a tuple."""

    def rec(t, path):
        if isinstance(t, dict):
            return {k: rec(t[k], f"{path}/{k}" if path else str(k))
                    for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(rec(v, f"{path}/{i}" if path else str(i))
                           for i, v in enumerate(t))
        if t is None:
            return None
        arr = flat[path]
        if torch.is_tensor(t):
            return torch.from_numpy(np.array(arr)).to(t.device, t.dtype)
        return arr.astype(t.dtype) if hasattr(t, "dtype") else arr

    return rec(template, prefix)


def save_npz(path: str, tree) -> int:
    """``tree`` flattened into an npz at ``path``; returns its bytes."""
    buf = io.BytesIO()
    np.savez(buf, **flatten_tree(tree))
    data = buf.getvalue()
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_npz(path: str, template):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_into(template, flat)


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
