"""The port's other PEFT pieces against the reference's, on the CPU: the
bottleneck adapters (peft/adapters.py), the soft prompt (peft/prompt.py)
and ``lora.merge``, on reduced GPT-2-style and Whisper models (width 64)
from the reference's init bridged.

``adapter_fwd`` and a model with adapters bound against the reference's
at atol 1e-5 / rtol 1e-4; a freshly drawn adapter (``w_up`` zero) is the
identity; the soft prompt through ``Model.forward`` against the
reference's; ``merge`` against ``bind`` in each package (the forward of
the merged weights against the bound ones, as tests/test_lora.py holds
the reference's) and the merged weights against the reference's merge;
the bridge's round trip of adapter and prompt trees bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import adapters as ref_adapters  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro.peft import prompt as ref_prompt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.fedavg import to_device  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import adapters, prompt  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

LAYER = dict(atol=1e-5, rtol=1e-4)
RANK, ALPHA = 4, 32.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, n_layers=2):
    ref = ref_registry.get_config(arch).reduced(n_layers=n_layers,
                                                d_model=64)
    return (dataclasses.replace(ref, kernel_policy="xla"),
            registry.get_config(arch).reduced(n_layers=n_layers, d_model=64))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, 11)),
             "lengths": np.full(3, 11), "labels": np.zeros(3, np.int64)}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = (0.02 * rng.standard_normal(
            (3, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _moved(tree, seed, std):
    """``tree`` with every leaf moved by std·N(0, 1): a trained-looking
    adapter (``w_up`` off zero) or LoRA tree (B off zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda t: (np.asarray(t) + std * rng.standard_normal(
        np.shape(t))).astype(np.float32), tree)


# 3 layers: the reference keeps the stacked blocks and a tail of 0 (GPT-2
# style, one group a layer); Whisper's decoder of 2 with its encoder
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-base"])
def test_adapters_match_reference(arch):
    """``adapter_fwd`` on one layer's adapter, and ``Model.forward`` with
    an adapter bound in every decoder layer (after the MLP residual; the
    encoder carries none), against the reference's; a fresh draw is the
    identity; the bridge round-trips the adapter tree bit for bit."""
    ref_cfg, cfg = _cfgs(arch, n_layers=3 if arch == "qwen2-1.5b" else 2)
    params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(0)))
    ad = _moved(ref_adapters.init_adapters(jax.random.PRNGKey(1), params,
                                           cfg.d_model, bottleneck=8),
                2, 0.05)
    back = bridge.adapters_to_reference(
        bridge.adapters_from_reference(ad, "cpu", cfg), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(ad)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(ad)):
        np.testing.assert_array_equal(g, w)
    one = jax.tree.map(lambda t: t[1], ad["blocks"][0])
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.d_model)
                                                 ).astype(np.float32)
    np.testing.assert_allclose(
        adapters.adapter_fwd({k: torch.from_numpy(v) for k, v in
                              one.items()}, torch.from_numpy(x)).numpy(),
        np.asarray(ref_adapters.adapter_fwd(one, jnp.asarray(x))), **LAYER)
    base = bridge.params_from_reference(params, "cpu")
    port_ad = bridge.adapters_from_reference(ad, "cpu", cfg)
    batch = _batch(cfg)
    want, _ = jax.jit(ref_build(ref_cfg).forward)(
        ref_adapters.bind(params, ad), _jnp(batch))
    got, _ = build_model(cfg).forward(adapters.bind(base, port_ad),
                                      to_device(batch, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    fresh = adapters.init_adapters(torch.Generator().manual_seed(0), base,
                                   cfg.d_model, bottleneck=8, device="cpu")
    assert len(fresh["layers"]) == len(base["layers"])
    assert all(not a["w_up"].any() for a in fresh["layers"])
    np.testing.assert_array_equal(
        build_model(cfg).forward(adapters.bind(base, fresh),
                                 to_device(batch, "cpu"))[0].numpy(),
        build_model(cfg).forward(base, to_device(batch, "cpu"))[0].numpy())


def test_soft_prompt_matches_reference():
    """A soft prompt of 5 virtual tokens, expanded over the batch and
    prepended as ``prefix_embeds``, through ``Model.forward``: the
    reference's logits over 5 + S positions; ``init_prompt``'s shape and
    scale; the bridge's round trip."""
    ref_cfg, cfg = _cfgs("qwen2-1.5b")
    params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(0)))
    pt = _np(ref_prompt.init_prompt(jax.random.PRNGKey(4), cfg.d_model,
                                    n_virtual=5))
    port_pt = bridge.prompt_from_reference(pt, "cpu")
    np.testing.assert_array_equal(
        bridge.prompt_to_reference(port_pt)["prompt"], pt["prompt"])
    batch = _batch(cfg)
    want, _ = jax.jit(ref_build(ref_cfg).forward)(
        params, dict(_jnp(batch), prefix_embeds=ref_prompt.expand(pt, 3)))
    got, _ = build_model(cfg).forward(
        bridge.params_from_reference(params, "cpu"),
        dict(to_device(batch, "cpu"), prefix_embeds=prompt.expand(port_pt,
                                                                  3)))
    assert got.shape == (3, 5 + 11, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    own = prompt.init_prompt(torch.Generator().manual_seed(0), cfg.d_model,
                             n_virtual=16, device="cpu")["prompt"]
    assert own.shape == (16, cfg.d_model)
    assert 0.015 < float(own.std()) < 0.025


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-base"])
def test_merge_matches_bind_and_reference(arch):
    """``merge`` (W + A@B·alpha/r) against ``bind`` of the same trained
    LoRA tree: the forward of the merged weights equals the bound one
    (as tests/test_lora.py holds the reference's), and the merged weights
    equal the reference's merge, every wq/wk/wv (Whisper's encoder and
    cross-attention included) changed and every other leaf the base's
    bit for bit."""
    ref_cfg, cfg = _cfgs(arch)
    params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(0)))
    lt = _moved(ref_lora.init_lora(jax.random.PRNGKey(1), params,
                                   ("wq", "wk", "wv"), RANK, ALPHA), 5, 0.02)
    base = bridge.params_from_reference(params, "cpu")
    plt = bridge.lora_from_reference(lt, "cpu", cfg)
    merged = lora_lib.merge(base, plt, ALPHA, RANK)
    batch = to_device(_batch(cfg), "cpu")
    model = build_model(cfg)
    np.testing.assert_allclose(
        model.forward(merged, batch)[0].numpy(),
        model.forward(lora_lib.bind(base, plt, ALPHA, RANK), batch)[0]
        .numpy(), **LAYER)
    want = ref_lora.merge(params, lt, ALPHA, RANK)
    got = bridge.params_to_reference(merged, cfg)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    changed = 0
    for (path, w), g, b in zip(paths, jax.tree.leaves(got),
                               jax.tree.leaves(params)):
        key = jax.tree_util.keystr(path)
        if any(f"'{name}'" in key for name in ("wq", "wk", "wv")):
            changed += 1
            assert not np.array_equal(g, b), key
            np.testing.assert_allclose(g, np.asarray(w), **LAYER)
        else:
            np.testing.assert_array_equal(g, b)
    assert changed == len(jax.tree.leaves(lt)) // 2 > 0
