"""The launch layer's shapes, meshes and sharding specs in the port
against the reference's, on the CPU, at every registry arch's full size
(nothing is allocated: the reference's ``eval_shape`` against the port's
``meta`` tensors):

- ``configs/shapes``: the four shapes, ``shape_supported`` and
  ``skip_reason`` for all 12 archs, exactly;
- ``launch/mesh``'s helpers on the (16, 16) and (2, 16, 16) production
  meshes against the reference's on a ``jax.sharding.AbstractMesh``;
- ``ShardingPolicy``'s specs of the parameters, the LoRA tree, the Adam
  state, the train batch of each shape and the decode caches (decode_32k,
  and long_500k where the arch takes it), exactly, the reference's
  stacked pattern-group axis dropped (the port keeps one tree a layer);
- ``Model.init_abstract``: every leaf on ``meta``, shapes and dtypes the
  reference's;
- ``launch/specs``: the train and decode inputs and the abstract cache,
  shapes and dtypes the reference's.
Also ``core/schedule`` (the rank staircase and ``grow_lora``) against
the reference."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.core import schedule as ref_schedule  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.optim import adam as ref_adam  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry, shapes  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.launch import mesh, sharding, specs  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.peft import lora  # noqa: E402

ARCHS = tuple(ref_registry.ARCHS)
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
_TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int32": torch.int32, "bool": torch.bool}


def _is_spec(x):
    return isinstance(x, JP)


def _drop(tree):
    """A stacked tree's specs (or shapes) without the leading group axis."""
    if isinstance(tree, dict):
        return {k: _drop(v) for k, v in tree.items()}
    if tree is None:
        return None
    if _is_spec(tree):
        return JP(*tuple(tree)[1:]) if len(tree) else tree
    return tree[1:]                                   # a shape tuple


def _leafmap(fn, tree):
    """fn over a reference tree's leaves (specs or ShapeDtypeStructs)."""
    return jax.tree.map(fn, tree, is_leaf=_is_spec)


def _port_layout(ref_tree, cfg, per_layer=_drop):
    """A reference tree (specs or (shape, dtype) pairs) in the port's
    layout: ``blocks`` (one stacked tree a pattern position) and ``tail``
    as one entry a layer under ``layers``, the encoder's blocks likewise,
    an encoder-decoder cache's ``xkv`` as (k, v) a layer; other keys as
    they are."""
    pat = cfg.layer_pattern or (None,)
    G, P = cfg.n_layers // len(pat), len(pat)
    out = {k: v for k, v in ref_tree.items()
           if k not in ("blocks", "tail", "xkv", "xkv_tail", "encoder")}
    layers = [per_layer(ref_tree["blocks"][p]) for _ in range(G)
              for p in range(P)]
    tail = list(ref_tree.get("tail") or ())
    layers += tail + [None] * (cfg.n_layers - G * P - len(tail))
    out["layers"] = tuple(layers)
    if "encoder" in ref_tree:
        enc = dict(ref_tree["encoder"])
        blocks = enc.pop("blocks")
        enc["layers"] = tuple(per_layer(blocks)
                              for _ in range(cfg.n_encoder_layers))
        out["encoder"] = enc
    if "xkv" in ref_tree:
        k, v = ref_tree["xkv"]
        out["xkv"] = tuple((per_layer(k), per_layer(v)) for _ in range(G)) \
            + tuple(tuple(kv) for kv in ref_tree["xkv_tail"])
    return out


def _norm(tree):
    """Spec or shape trees as plain nested dicts and tuples."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if _is_spec(tree) or isinstance(tree, sharding.P):
        return ("P",) + tuple(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(_norm(v) for v in tree)
    return tree


def _ref_mesh(name):
    return AbstractMesh(*MESHES[name])


def _mesh(name):
    return mesh.MeshSpec(*MESHES[name])


def _same_specs(got, want):
    assert _norm(got) == _norm(want)


def _shapes(ref_tree):
    """(shape, dtype name) of each reference leaf."""
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), ref_tree)


def _port_shapes(tree):
    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(rec(v) for v in t)
        if t is None:
            return None
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return rec(tree)


def _drop_shape(tree):
    if isinstance(tree, dict):
        return {k: _drop_shape(v) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1],
                                                                 str):
        return (tree[0][1:], tree[1])
    return tuple(_drop_shape(v) for v in tree)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_support_match_reference(arch):
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    assert cfg.subquadratic == ref_cfg.subquadratic
    for name, want in ref_shapes.SHAPES.items():
        got = shapes.SHAPES[name]
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert shapes.shape_supported(cfg, got) == \
            ref_shapes.shape_supported(ref_cfg, want)
        assert shapes.skip_reason(cfg, got) == \
            ref_shapes.skip_reason(ref_cfg, want)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_helpers_match_reference(name):
    got, want = _mesh(name), _ref_mesh(name)
    assert mesh.make_production_mesh(multi_pod=name == "multipod") == got
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    for fn in ("data_axes", "client_axes", "client_axis_size",
               "model_axis_size", "n_edges"):
        assert getattr(mesh, fn)(got) == getattr(ref_mesh, fn)(want), fn
    assert mesh.n_edges(None) == ref_mesh.n_edges(None) == 1
    for nd in (1, 3):
        _same_specs(sharding.client_spec(got, nd),
                    ref_sharding.client_spec(want, nd))


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = _mesh("multipod")
    assert sharding.to_placements(sharding.P(("pod", "data"), None,
                                             "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements(sharding.P(), m) == \
        (Replicate(), Replicate(), Replicate())
    assert sharding.to_placements(sharding.P(None, "model"), _mesh("pod")) \
        == (Replicate(), Shard(1))
    with pytest.raises(ValueError):
        sharding.to_placements(sharding.P("model", "model"), m)
    assert sharding.P(("data",), ()) == ("data", None)


# --------------------------------------------------------------------------- #
# The model trees of every arch at full size
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def trees():
    """{arch: (reference params, LoRA and Adam state as ShapeDtypeStructs;
    the port's as meta tensors)}, bf16 parameters."""
    out = {}
    for arch in ARCHS:
        ref_cfg, cfg = ref_registry.get_config(arch), \
            registry.get_config(arch)
        rp = ref_build(ref_cfg).init_abstract(jnp.bfloat16)
        targets = ref_lora.default_targets(ref_cfg)
        rl = jax.eval_shape(lambda: ref_lora.init_lora(
            jax.random.PRNGKey(0), rp, targets, 8))
        ro = jax.eval_shape(ref_adam.init, rl)
        p = build_model(cfg).init_abstract(torch.bfloat16)
        with torch.device("meta"):
            lt = lora.init_lora(torch.Generator(), p,
                                lora.default_targets(cfg), 8)
        out[arch] = (ref_cfg, rp, rl, ro, cfg, p, lt, adam.init(lt))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_abstract_matches_reference(trees, arch):
    ref_cfg, rp, rl, _, cfg, p, lt, _ = trees[arch]
    assert {t.device.type for t in tree_lib.leaves(p)} == {"meta"}
    assert {t.device.type for t in tree_lib.leaves(lt)} == {"meta"}
    assert _port_shapes(p) == _port_layout(_shapes(rp), cfg, _drop_shape)
    assert _port_shapes(lt) == _port_layout(_shapes(rl), cfg, _drop_shape)
    assert sum(t.numel() for t in tree_lib.leaves(p)) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(rp))


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_lora_opt_specs_match_reference(trees, arch, name):
    ref_cfg, rp, rl, ro, cfg, p, lt, opt = trees[arch]
    ref_pol = ref_sharding.ShardingPolicy(_ref_mesh(name), ref_cfg)
    pol = sharding.ShardingPolicy(_mesh(name), cfg)
    _same_specs(pol.tree_specs(p), _port_layout(ref_pol.tree_specs(rp), cfg))
    lt_sp = pol.tree_specs(lt)
    ref_lt_sp = _port_layout(ref_pol.tree_specs(rl), cfg)
    _same_specs(lt_sp, ref_lt_sp)
    _same_specs(pol.opt_specs(lt_sp),
                {"m": ref_lt_sp, "v": ref_lt_sp, "step": JP()})


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(trees, arch, name):
    """The train inputs of every shape (shapes, dtypes and batch specs),
    the decode inputs, and the abstract caches at decode_32k and, where
    supported, long_500k (shapes, dtypes and cache specs)."""
    ref_cfg, rp, _, _, cfg, p, _, _ = trees[arch]
    ref_pol = ref_sharding.ShardingPolicy(_ref_mesh(name), ref_cfg)
    pol = sharding.ShardingPolicy(_mesh(name), cfg)
    for sname, shape in shapes.SHAPES.items():
        ref_shape = ref_shapes.SHAPES[sname]
        rb, b = ref_specs.train_input_specs(ref_cfg, ref_shape), \
            specs.train_input_specs(cfg, shape)
        assert _port_shapes(b) == _shapes(rb)
        _same_specs(pol.batch_spec(b), ref_pol.batch_spec(rb))
        _same_specs(pol.batch_spec(b, False), ref_pol.batch_spec(rb, False))
        assert _port_shapes(specs.decode_input_specs(cfg, shape)) == \
            _shapes(ref_specs.decode_input_specs(ref_cfg, ref_shape))
        if shape.mode != "decode" or not shapes.shape_supported(cfg, shape):
            continue
        rc = ref_specs.abstract_cache(ref_build(ref_cfg), rp, ref_shape)
        c = specs.abstract_cache(build_model(cfg), p, shape)
        assert {t.device.type for t in tree_lib.leaves(c)} == {"meta"}
        assert _port_shapes(c) == _port_layout(_shapes(rc), cfg, _drop_shape)
        _same_specs(pol.cache_specs(c),
                    _port_layout(_cache_specs(ref_pol, rc), cfg))


def _cache_specs(ref_pol, cache):
    """The reference's cache_shardings' specs (its recursion, with
    cache_spec in place of the NamedSharding)."""
    def rec(t, path):
        if isinstance(t, dict):
            return {k: rec(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(rec(v, path) for v in t)
        return ref_pol.cache_spec(path, t)
    return rec(cache, ())


# --------------------------------------------------------------------------- #
# core/schedule
# --------------------------------------------------------------------------- #
def test_rank_schedule_matches_reference():
    for total in (0, 1, 2, 3, 5, 7, 10):
        for ranks in ((2, 4, 8), (8,), (1, 2), (4, 8, 16, 32)):
            for rnd in range(total + 3):
                assert schedule.rank_schedule(rnd, total, ranks) == \
                    ref_schedule.rank_schedule(rnd, total, ranks)
    assert schedule.rank_schedule(0, 6) == ref_schedule.rank_schedule(0, 6)


def test_grow_lora_matches_reference():
    """A two-layer tree of wq and wv factors at rank 4, B nonzero, grown
    to rank 8: the reference's padded and rescaled factors bit for bit."""
    rng = np.random.default_rng(0)

    def factors(d_in, d_out):
        return {"a": rng.normal(size=(2, d_in, 4)).astype(np.float32),
                "b": rng.normal(size=(2, 4, d_out)).astype(np.float32)}

    lt = {"blocks": ({"attn": {"wq": factors(16, 16),
                               "wv": factors(16, 8)}},)}
    want = ref_schedule.grow_lora(lt, 8)
    got = schedule.grow_lora(bridge.lora_from_reference(lt, "cpu"), 8)
    back = bridge.lora_to_reference(got)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
