"""The port's serving entry point (``repro_torch.launch.serve``) and the
merged-LoRA flow of ``examples/serve_decode.py`` against the reference,
on the CPU.

- ``generate`` at temperature 0 gives the reference serve loop's greedy
  tokens (its jitted ``decode_step``, prefill by single steps, then
  argmax) on gpt2-tiny, from the port's seed-0 weights bridged.
- ``main([... "--device", "cpu"])`` returns 0, greedy and sampled;
  ``--device cuda`` on a machine without CUDA raises.
- The example's flow on Qwen3, RWKV-6 and RecurrentGemma at
  ``reduced()``: the reference's ``init_lora`` (default targets, rank 4,
  every factor + 0.01) bridged, the port's ``lora.merge`` against the
  reference's leaf by leaf (atol 1e-6 / rtol 1e-5: the sum over the rank
  in another order), then the reference's greedy loop (batch 4, prompt 8,
  8 generated) and the port's ``generate`` on the merged weights: the
  same tokens.
- LoRA on Qwen3-MoE's stacked experts (``targets=("w_in", "w_out")``):
  the port's ``init_lora`` draws (E, d, r) / (E, r, ff) factors (the
  reference's shapes a layer, B zero), its ``merge`` of the reference's
  factors (B drawn nonzero) gives the reference's merged experts, the
  merged model's teacher-forced decode logits the reference's (atol
  1e-5 / rtol 1e-4), and ``bind`` refuses the stacked leaf."""
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
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora  # noqa: E402

STEP = dict(atol=1e-5, rtol=1e-4)
MERGED = dict(atol=1e-6, rtol=1e-5)


def _pair(arch, reduce=True):
    """(reference model, port model, port seed-0 params, the same bridged
    to the reference), the reference under its plain (``xla``) policy."""
    ref_cfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
    if reduce:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    ref_model = ref_build(dataclasses.replace(ref_cfg, kernel_policy="xla"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return ref_model, model, params, bridge.params_to_reference(params, cfg)


def _ref_greedy(ref_model, params, prompt, gen):
    """The reference's serve loop at temperature 0: the tokens it emits."""
    B, P = prompt.shape
    cache = ref_model.init_cache(params, B, P + gen, dtype=jnp.float32)
    step = jax.jit(ref_model.decode_step)
    out, tok = [], jnp.asarray(prompt[:, 0])
    for t in range(P + gen):
        tok_in = jnp.asarray(prompt[:, t]) if t < P else tok
        logits, cache = step(params, cache, tok_in, jnp.asarray(t, jnp.int32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        if t >= P - 1:
            out.append(np.asarray(tok))
    return np.stack(out[:gen], 1)


def _prompt(cfg, B, P, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, P)).astype(np.int32)


def test_generate_greedy_matches_reference_loop():
    ref_model, model, params, ref_params = _pair("gpt2-tiny", reduce=False)
    prompt = _prompt(model.cfg, 4, 16, 3)
    want = _ref_greedy(ref_model, ref_params, prompt, 12)
    with torch.inference_mode():
        got, logits = serve.generate(model, params,
                                     torch.as_tensor(prompt).long(), 12,
                                     temperature=0.0)
    assert got.shape == (4, 12) and logits.shape == (4, model.cfg.vocab_size)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", ["0", "1.0"])
def test_main_on_cpu(temperature, capsys):
    assert serve.main(["--arch", "gpt2-tiny", "--gen", "6", "--prompt-len",
                       "4", "--temperature", temperature,
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=gpt2-tiny: generated (4, 6) tokens" in out
    assert "tok/s batched" in out


def test_main_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "gpt2-tiny", "--device", "cuda"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b",
                                  "recurrentgemma-2b"])
def test_example_merged_lora_flow(arch):
    ref_model, model, params, ref_params = _pair(arch)
    targets = ref_lora.default_targets(ref_model.cfg)
    assert tuple(lora.default_targets(model.cfg)) == tuple(targets)
    lt = jax.tree.map(lambda x: np.asarray(x) + 0.01, ref_lora.init_lora(
        jax.random.PRNGKey(1), ref_params, targets, rank=4))
    ref_served = jax.tree.map(np.asarray, ref_lora.merge(ref_params, lt,
                                                         alpha=32.0, rank=4))
    served = lora.merge(params, bridge.lora_from_reference(lt, "cpu",
                                                           model.cfg),
                        alpha=32.0, rank=4)
    got = bridge.params_to_reference(served, model.cfg)
    assert jax.tree.structure(got) == jax.tree.structure(ref_served)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **MERGED),
                 got, ref_served)
    prompt = _prompt(model.cfg, 4, 8, 2)
    want = _ref_greedy(ref_model, ref_served, prompt, 8)
    with torch.inference_mode():
        toks, _ = serve.generate(model, served, torch.as_tensor(prompt).long(),
                                 8, temperature=0.0)
    np.testing.assert_array_equal(toks.numpy(), want)


def test_lora_on_stacked_experts():
    ref_model, model, params, ref_params = _pair("qwen3-moe-235b-a22b")
    cfg, targets = model.cfg, ("w_in", "w_out")
    E, d, ff, r = cfg.n_experts, cfg.d_model, cfg.d_ff, 4
    mine = lora.init_lora(torch.Generator().manual_seed(1), params, targets,
                          rank=r)
    for layer in mine["layers"]:
        assert set(layer) == {"mlp"} and set(layer["mlp"]) == set(targets)
        assert layer["mlp"]["w_in"]["a"].shape == (E, d, r)
        assert layer["mlp"]["w_in"]["b"].shape == (E, r, ff)
        assert layer["mlp"]["w_out"]["a"].shape == (E, ff, r)
        assert not layer["mlp"]["w_out"]["b"].any()
    rng = np.random.default_rng(4)
    lt = jax.tree.map(lambda x: np.asarray(x) + 0.01 * rng.standard_normal(
        np.shape(x)).astype(np.float32), ref_lora.init_lora(
            jax.random.PRNGKey(1), ref_params, targets, rank=r))
    port_lt = bridge.lora_from_reference(lt, "cpu", cfg)
    shapes = jax.tree.map(np.shape, bridge.lora_to_reference(mine, cfg))
    assert jax.tree.map(np.shape, lt) == shapes
    ref_served = jax.tree.map(np.asarray, ref_lora.merge(ref_params, lt,
                                                         alpha=32.0, rank=r))
    served = lora.merge(params, port_lt, alpha=32.0, rank=r)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **MERGED),
                 bridge.params_to_reference(served, cfg), ref_served)
    tokens = _prompt(cfg, 4, 6, 5)
    cache = ref_model.init_cache(ref_served, 4, 6, dtype=jnp.float32)
    step = jax.jit(ref_model.decode_step)
    want = []
    for t in range(6):
        lg, cache = step(ref_served, cache, jnp.asarray(tokens[:, t]),
                         jnp.asarray(t, jnp.int32))
        want.append(np.asarray(lg))
    with torch.inference_mode():
        got = serve.decode_logits(model, served,
                                  torch.as_tensor(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), **STEP)
    with pytest.raises(NotImplementedError, match="stacked expert"):
        lora.bind(params, port_lt, alpha=32.0, rank=r)
