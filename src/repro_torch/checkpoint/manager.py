"""Step-indexed checkpoint manager with retention.  Counterpart of
``src/repro/checkpoint/manager.py``: the same file names
(``ckpt_{step:08d}.npz`` and its ``.json`` beside it) and the same
retention (the newest ``keep_n`` steps), and both of its forms: the
template snapshot (``save`` / ``restore``: launch/train.py's LoRA trees,
the metadata in the ``.json``) and the dtype-exact state snapshot with no
template (``save_state`` / ``restore_state``, the federated run's)."""
from __future__ import annotations

import io
import json
import os
import re
from typing import Optional

import numpy as np

from repro_torch.checkpoint import serialization

_FMT = "ckpt_{step:08d}.npz"
_RE = re.compile(r"ckpt_(\d{8})\.npz$")


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, _FMT.format(step=step))

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> str:
        """The template snapshot of ``tree`` (serialization.save_npz) at
        ``step``, ``metadata`` in the json beside it."""
        path = self._path(step)
        serialization.save_npz(path, tree)
        if metadata is not None:
            with open(path + ".json", "w") as f:
                json.dump(metadata, f)
        self._gc()
        return path

    def restore(self, template, step: Optional[int] = None):
        """-> (tree, metadata or None) saved by ``save`` (the latest step
        by default), rebuilt like ``template``: each leaf in the template
        leaf's dtype, on its device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._path(step)
        tree = serialization.load_npz(path, template)
        meta = None
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        return tree, meta

    def save_state(self, step: int, state,
                   metadata: Optional[dict] = None) -> str:
        """A dtype-exact snapshot with no template (bit-exact crash
        recovery): the arrays in the npz, the structure manifest and the
        Python scalars in the json beside it."""
        path = self._path(step)
        manifest, arrays = serialization.state_flatten(state)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        with open(path + ".json", "w") as f:
            json.dump({"manifest": manifest, "meta": metadata}, f)
        self._gc()
        return path

    def restore_state(self, step: Optional[int] = None, device="cpu"):
        """-> (state, metadata) saved by ``save_state`` (the latest step by
        default), its device tensors on ``device``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._path(step)
        with open(path + ".json") as f:
            doc = json.load(f)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        return (serialization.state_unflatten(doc["manifest"], arrays,
                                              device), doc.get("meta"))

    def steps(self):
        return sorted(int(m.group(1)) for m in map(_RE.match,
                                                   os.listdir(self.dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            p = self._path(s)
            os.remove(p)
            if os.path.exists(p + ".json"):
                os.remove(p + ".json")
