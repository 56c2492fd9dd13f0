"""Sharding policy: partition specs for params, LoRA, optimizer state,
batches and KV caches.

Counterpart of ``src/repro/launch/sharding.py``, with the same name-based
rules and divisibility fallbacks, evaluated against a mesh's shape
(launch/mesh.MeshSpec, or anything with ``axis_names`` and a ``shape``
dict):

- embeddings / LM head: vocab dim on ``model`` when divisible, else the
  d_model dim, else replicated.
- attention / MLP projections: column-parallel in, row-parallel out;
  a dim that does not divide falls back to the other scheme, then to
  replication (qwen2's 12 heads, whisper's 51865 vocab).
- MoE experts: the expert dim on ``model`` when divisible (qwen3-moe
  128/16), else the per-expert ffn dim (mixtral's 8 experts < 16).
- LoRA A follows its base matrix's input sharding, B its output sharding.
- KV caches: batch on the data axes, a cache sequence of 16384 or more on
  ``model``.

A spec is a ``P``: one entry a tensor dim, each ``None``, an axis name
or a tuple of axis names (jax's ``PartitionSpec``); ``to_placements``
turns one into the DTensor placements of a ``DeviceMesh`` of the same
shape.

Layout: the reference stacks each layer-pattern position's blocks on a
leading group axis (``params["blocks"]``), the port keeps one tree a
layer (``params["layers"]``, bridge.py).  The rules read a leaf's name
and its trailing dims and pad the spec with ``None`` in front, so a port
leaf's spec is the reference's without the leading ``None`` of the
group axis.  The one rule that reads the leading dims is the recurrent
cache states' (``cache_spec``: the first axis that the data-axis extent
divides); for every registry arch at decode_32k and long_500k the
reference never picks its group axis there (its group counts, 8 for
RecurrentGemma-2B and 24 for RWKV-6, are not multiples of 16 or 32), so
the port's per-layer states take the same spec less the group axis
(tests/test_torch_launch_specs.py holds them to it).

Not ported: ``shard_client_tree`` and ``client_shardings``, which place
a client-stacked tree for ``run_federated(..., mesh=)``: the reference's
mesh-sharded path is not trusted yet.  ``client_spec`` is ported as a
spec function.
"""
from __future__ import annotations

from typing import Tuple

# column-parallel (shard output dim) / row-parallel (shard input dim)
COL = {"wq", "wk", "wv", "w_gate", "w_in", "cm_w_k", "w_rec_in",
       "w_gate_in", "w_r", "w_k", "w_v", "w_g", "cm_w_r", "w_down"}
ROW = {"wo", "w_out", "cm_w_v", "w_o", "w_up"}
VEC_COL = {"bq", "bk", "bv", "b_a", "b_x", "lambda", "conv_b"}
REPLICATE = {"router", "decay_a", "decay_b", "img_proj"}


def _entry(e):
    """One spec entry in canonical form, as jax's ``PartitionSpec`` keeps
    it: a tuple of one axis name is that name, an empty tuple ``None``."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry a tensor dim (``None``, an axis name or
    a tuple of axis names); ``P()`` replicates a tensor of any rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _div(n: int, m: int) -> bool:
    return n % m == 0


def to_placements(spec: P, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on a ``DeviceMesh`` shaped as
    ``mesh``: for each mesh axis in order, ``Shard(d)`` when tensor dim d
    names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            if name is None:
                continue
            if name not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {name!r}, not in "
                                 f"the mesh's {mesh.axis_names}")
            if name in dims:
                raise ValueError(f"spec {spec} shards two dims over axis "
                                 f"{name!r}")
            dims[name] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.axis_names)


def client_spec(mesh, ndim: int) -> P:
    """A leading stacked-client axis on the mesh's client axes
    (launch/mesh.client_axes), the rest replicated."""
    from repro_torch.launch.mesh import client_axes
    return P(client_axes(mesh), *([None] * (ndim - 1)))


class ShardingPolicy:
    def __init__(self, mesh, cfg):
        self.mesh = mesh
        self.cfg = cfg
        self.M = mesh.shape["model"]
        self.dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
        self.dp_size = 1
        for a in self.dp:
            self.dp_size *= mesh.shape[a]

    def _pad(self, spec_tail, ndim):
        return P(*([None] * (ndim - len(spec_tail)) + list(spec_tail)))

    # ------------------------------------------------------------------ #
    def param_spec(self, path, leaf) -> P:
        name = path[-1]
        shape = leaf.shape
        nd = leaf.dim()
        M = self.M
        if nd == 0 or name.startswith("mu_") or name in (
                "scale", "bias", "ln_x", "bonus_u", "decay_w0"):
            return P()
        if name == "embed":
            V, d = shape[-2], shape[-1]
            if _div(V, M):
                return self._pad(["model", None], nd)
            if _div(d, M):
                return self._pad([None, "model"], nd)
            return P()
        if name == "pos_embed":
            return P()
        if name == "lm_head":
            d, V = shape[-2], shape[-1]
            if _div(V, M):
                return self._pad([None, "model"], nd)
            if _div(d, M):
                return self._pad(["model", None], nd)
            return P()
        # MoE expert tensors: (.., E, d_in, d_out)
        is_expert = self.cfg.is_moe and name in (
            "w_gate", "w_in", "w_out") and nd >= 3 and \
            shape[-3] == self.cfg.n_experts
        if is_expert:
            E = shape[-3]
            if _div(E, M):
                return self._pad(["model", None, None], nd)
            # fall back: shard the per-expert ffn dim
            io = -1 if name in ("w_gate", "w_in") else -2
            if _div(shape[io], M):
                tail = [None, None, None]
                tail[io] = "model"
                return self._pad(tail, nd)
            return P()
        if name in REPLICATE:
            return P()
        if name in ("conv_w", "w_a", "w_x"):       # (K, w), (w, w) lru
            if _div(shape[-1], M):
                return self._pad([None, "model"], nd)
            return P()
        if name in VEC_COL:
            if _div(shape[-1], M):
                return self._pad(["model"], nd)
            return P()
        if name in COL:
            if _div(shape[-1], M):
                return self._pad([None, "model"], nd)
            if _div(shape[-2], M):
                return self._pad(["model", None], nd)
            return P()
        if name in ROW:
            if _div(shape[-2], M):
                return self._pad(["model", None], nd)
            if _div(shape[-1], M):
                return self._pad([None, "model"], nd)
            return P()
        return P()

    # ------------------------------------------------------------------ #
    def lora_spec(self, base_path, which: str, leaf) -> P:
        """A follows the base weight's input dim; B its output dim."""
        name = base_path[-1]
        nd = leaf.dim()
        M = self.M
        col = name in COL or name in ("embed", "lm_head")
        if which == "a":
            if not col and _div(leaf.shape[-2], M):
                return self._pad(["model", None], nd)    # row-parallel base
            return P()
        if col and _div(leaf.shape[-1], M):
            return self._pad([None, "model"], nd)
        return P()

    # ------------------------------------------------------------------ #
    def tree_specs(self, params):
        """A spec tree mirroring ``params`` (base, bound or LoRA trees):
        dicts stay dicts, lists become tuples, ``None`` stays ``None``."""

        def rec(t, path):
            if isinstance(t, dict):
                if set(t) == {"a", "b"} and hasattr(t["a"], "dim"):
                    return {"a": self.lora_spec(path, "a", t["a"]),
                            "b": self.lora_spec(path, "b", t["b"])}
                return {k: rec(v, path + (k,)) for k, v in t.items()}
            if isinstance(t, (tuple, list)):
                return tuple(rec(v, path) for v in t)
            if t is None:
                return None
            return self.param_spec(path, t)

        return rec(params, ())

    # ------------------------------------------------------------------ #
    def opt_specs(self, lora_specs):
        """Adam state mirrors its params; the step count replicated."""
        return {"m": lora_specs, "v": lora_specs, "step": P()}

    # ------------------------------------------------------------------ #
    def batch_spec(self, batch_shapes, shardable_batch: bool = True) -> dict:
        dp = self.dp if shardable_batch else ()
        out = {}
        for k, v in batch_shapes.items():
            lead = dp if (shardable_batch
                          and _div(v.shape[0], max(self.dp_size, 1))) else ()
            out[k] = P(lead, *([None] * (v.dim() - 1))) if lead else P(
                *([None] * v.dim()))
        return out

    # ------------------------------------------------------------------ #
    def cache_spec(self, path, leaf) -> P:
        """KV caches: batch on the data axes, a long cache's sequence dim
        on ``model``; a recurrent state's first axis that the data-axis
        extent divides on the data axes."""
        name = path[-1]
        nd = leaf.dim()
        shape = leaf.shape
        # attention caches (..., B, S_cache, KV, hd): only a LARGE cache is
        # sequence-sharded; a ring buffer (a window of 4k or less) is small,
        # and a model-sharded sequence would make every decode update and
        # read gather the whole cache
        if name in ("k", "v") and nd >= 4:
            spec = [None] * nd
            if _div(shape[-4], self.dp_size):
                spec[-4] = self.dp
            if shape[-3] >= 16384 and _div(shape[-3], self.M):
                spec[-3] = "model"
            return P(*spec)
        spec = [None] * nd
        for ax in range(nd):
            if shape[ax] >= self.dp_size and _div(shape[ax], self.dp_size):
                spec[ax] = self.dp
                break
        return P(*spec)

    def cache_specs(self, cache_shapes):
        """A spec tree mirroring a cache tree (``Model.init_cache``'s)."""
        def rec(t, path):
            if isinstance(t, dict):
                return {k: rec(v, path + (k,)) for k, v in t.items()}
            if isinstance(t, (tuple, list)):
                return tuple(rec(v, path) for v in t)
            return self.cache_spec(path, t)
        return rec(cache_shapes, ())
