"""The registry's decoder-only families in the port against the
reference's, on the CPU, without runs: the registry and every config
field for field; each of the six architectures (Qwen2 with QKV bias over
GQA, Qwen3 with qk-norm, Mistral-Large, Nemotron-4 with LayerNorm and a
squared-ReLU MLP, Mixtral and Qwen3-MoE through models/moe.py) at
``reduced()``: from the reference's init, bridged, the port's logits and
aux term; qk-norm attention and the dense squared-ReLU MLP alone; the
two architectures the port refused before (LLaVA, Whisper), which now
build and give the reference's logits; the bridge's round
trip of MoE and qk-norm trees; and the analytic FLOPs the ledger's
``client_flops`` reads.

Tolerances: logits and aux fp32 atol 5e-5 / rtol 5e-4 (sums in other
orders over two layers of width 256); the single layers atol 1e-5 /
rtol 1e-4; the bridge and the configs exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.models import attention, mlp  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402

FAMILIES = ("qwen2-1.5b", "qwen3-1.7b", "mistral-large-123b",
            "nemotron-4-340b", "mixtral-8x7b", "qwen3-moe-235b-a22b")
LOGITS = dict(atol=5e-5, rtol=5e-4)
LAYER = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _reduced(arch):
    """(reference, port) configs of ``arch`` at ``reduced()``, the
    reference's under its plain (``xla``) policy."""
    return (dataclasses.replace(ref_registry.get_config(arch).reduced(),
                                kernel_policy="xla"),
            registry.get_config(arch).reduced())


def test_registry_and_configs_match_reference():
    """The same 12 names in the same order; every config field for field
    (but the kernel policy, whose names differ), its parameter counts and
    the FLOPs of a train and a forward pass, exactly."""
    assert list(registry.ARCHS) == list(ref_registry.ARCHS)
    assert len(registry.ARCHS) == 12
    for arch in registry.ARCHS:
        got, want = registry.get_config(arch), ref_registry.get_config(arch)
        for f in dataclasses.fields(want):
            if f.name != "kernel_policy":
                assert getattr(got, f.name) == getattr(want, f.name), \
                    (arch, f.name)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        for frac in (1.0, 0.25):
            assert metrics.train_flops(got, 1280, True, 4096, frac) == \
                ref_metrics.train_flops(want, 1280, True, 4096, frac)
            assert metrics.fwd_flops(got, 1280, frac) == \
                ref_metrics.fwd_flops(want, 1280, frac)
    with pytest.raises(KeyError):
        registry.get_config("gpt3")


@pytest.mark.parametrize("arch", FAMILIES)
def test_logits_and_aux_match_reference(arch):
    """From the reference's init (bridged), the port's forward gives the
    reference's logits and aux term: 0 for the dense families, the summed
    load-balance terms for the MoE ones (``shard_map`` dispatch runs as
    ``batched`` in both without a mesh)."""
    ref_cfg, cfg = _reduced(arch)
    ref_model = ref_build(ref_cfg)
    params = _np(ref_model.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (3, 24)).astype(np.int32)
    want, want_aux = ref_model.forward(params,
                                       {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = build_model(cfg).forward(
            bridge.params_from_reference(params, "cpu"),
            {"tokens": torch.as_tensor(tokens).long()})
    assert got.shape == want.shape == (3, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(float(aux), float(want_aux), **LOGITS)
    assert (float(aux) > 0) == cfg.is_moe


def test_qk_norm_attention_matches_reference():
    """Qwen3's attention alone, with q_norm/k_norm scales away from 1 and
    a QKV bias beside them: the per-head RMSNorm after the bias and the
    reshape, before RoPE, over 8 query heads on 2 kv heads."""
    cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").reduced(
        d_model=128), n_heads=8, n_kv_heads=2, head_dim=32, qkv_bias=True)
    ref_cfg = dataclasses.replace(
        ref_registry.get_config("qwen3-1.7b").reduced(d_model=128),
        n_heads=8, n_kv_heads=2, head_dim=32, qkv_bias=True,
        kernel_policy="xla")
    p = _np(ref_attention.init_attention(jax.random.PRNGKey(2), ref_cfg))
    rng = np.random.default_rng(3)
    for name in ("q_norm", "k_norm", "bq", "bk", "bv"):
        p[name] = (1.0 + 0.5 * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    assert p["q_norm"].shape == p["k_norm"].shape == (32,)
    x = rng.standard_normal((2, 20, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    want = ref_attention.attention_fwd(p, ref_cfg, jnp.asarray(x),
                                       jnp.asarray(pos))
    got = attention.attention_fwd(_torch(p), cfg, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    # the norm is really applied: without it the output moves
    plain = {k: v for k, v in _torch(p).items()
             if k not in ("q_norm", "k_norm")}
    off = attention.attention_fwd(plain, cfg, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()).long())
    assert float((off - got).abs().max()) > 1e-2
    init = attention.init_attention(torch.Generator().manual_seed(0), cfg,
                                    "cpu")
    assert sorted(init) == sorted(p)


def test_dense_relu2_mlp_matches_reference():
    """Nemotron-4's dense MLP alone: relu(x @ w_in)² @ w_out."""
    ref_cfg, cfg = _reduced("nemotron-4-340b")
    p = _np(ref_mlp.init_mlp(jax.random.PRNGKey(4), ref_cfg))
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want = ref_mlp.mlp_fwd(p, ref_cfg, jnp.asarray(x))
    got = mlp.mlp_fwd(_torch(p), cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    init = mlp.init_mlp(torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(init) == sorted(p) == ["w_in", "w_out"]


@pytest.mark.parametrize("arch,what", [
    ("llava-next-34b", "VLM image-embedding prefix"),
    ("whisper-base", "encoder-decoder")])
def test_unported_archs_raise(arch, what):
    """The two architectures the port refused until it ran the VLM
    image-embedding prefix and the encoder-decoder: ``build_model``
    accepts both at full size and reduced, and the reduced model, from
    the reference's init bridged, gives the reference's logits with the
    stub embeddings its forward reads (Whisper's 16 encoder frames,
    LLaVA's 8 image tokens prepended to the text)."""
    for cfg in (registry.get_config(arch),
                registry.get_config(arch).reduced()):
        assert build_model(cfg).cfg is cfg
    ref_cfg, cfg = _reduced(arch)
    params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(8)))
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 10))}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = 0.02 * rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.d_model))
    else:
        batch["img_embeds"] = 0.02 * rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.image_embed_dim))
    batch = {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
             for k, v in batch.items()}
    want, _ = ref_build(ref_cfg).forward(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = build_model(cfg).forward(
        bridge.params_from_reference(params, "cpu"),
        {k: torch.from_numpy(v) if v.dtype.kind == "f"
         else torch.from_numpy(v).long() for k, v in batch.items()})
    assert got.shape == (2, 10 + (0 if cfg.is_encoder_decoder
                                  else cfg.n_image_tokens), cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "qwen3-1.7b"])
def test_bridge_round_trips_moe_and_qk_norm(arch):
    """Reference -> port -> reference gives every leaf back bit for bit
    (the router, the stacked experts, q_norm/k_norm), and port -> reference
    -> port the port's own init; the leaves keep their shapes."""
    ref_cfg, cfg = _reduced(arch)
    ref_cfg = dataclasses.replace(ref_cfg, n_layers=3)
    cfg = dataclasses.replace(cfg, n_layers=3)
    params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(6)))
    port = bridge.params_from_reference(params, "cpu")
    back = bridge.params_to_reference(port, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    layer = port["layers"][0]
    if cfg.is_moe:
        E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
        assert layer["mlp"]["router"].shape == (d, E)
        assert layer["mlp"]["w_in"].shape == (E, d, ff)
        assert layer["mlp"]["w_out"].shape == (E, ff, d)
    if cfg.qk_norm:
        assert layer["attn"]["q_norm"].shape == (cfg.head_dim,)
    own = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    again = bridge.params_from_reference(bridge.params_to_reference(own, cfg),
                                         "cpu")
    assert len(tree_lib.leaves(again)) == len(tree_lib.leaves(own))
    for got, want in zip(tree_lib.leaves(again), tree_lib.leaves(own)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
