"""The port's decode path against the reference's, on the CPU.

Nine configs: the reference's decode test's six families
(``tests/test_models.py``'s ``FAMS``: dense GQA, a sliding window of 4
whose ring wraps, MoE at capacity factor 4.0, the Griffin hybrid with a
local window of 4 (two groups' worth of layers: one full pattern group
and a two-layer tail), RWKV-6 and the encoder-decoder with learned
positions), GPT-2-tiny (QKV bias, learned positions), Qwen3 at
``reduced(d_model=64)`` (qk-norm) and LLaVA at ``reduced(d_model=64)``,
which decodes text alone.  Every config starts from the port's seed-0
weights (the zero biases and unit qk-norm scales drawn away from their
init, so that those paths count), bridged to the reference
(``bridge.params_to_reference``; the reference's own init takes 5-10 s a
config here, op by op); both
decode one numpy-seeded token batch (B 2, T 9) from a fresh cache in
fp32, the reference through one jitted ``decode_step``.

Checks: each step's logits at atol 1e-5 / rtol 1e-4; the final caches
(the K/V rings and linear caches, RG-LRU and RWKV-6 states, the
encoder-decoder's cross K/V) bridged back (``bridge.cache_to_reference``)
at the same tolerance, and the reference's through
``cache_from_reference`` and back bit for bit; the port's decode against
its own forward within 2e-3 (the reference's bar for its own).  At the
default bf16 cache: ``attention_decode`` from weights and inputs whose
fp32 projections are exact in any order, the K/V slots the reference's
bit for bit (both round to nearest even, ties included); the dense model,
whose fp32 projections the two sum in different orders, K/V at most one
bf16 ulp apart (12 of 3456 differ) and the logits within the bf16 cache's own effect on the
reference."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_gpt2_tiny  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402

STEP = dict(atol=1e-5, rtol=1e-4)
B, T = 2, 9

FAMS = {
    "dense": dict(name="dense", family="dense", n_layers=3, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97),
    "swa": dict(name="swa", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
                sliding_window=4),
    "moe": dict(name="moe", family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=96, vocab_size=97, n_experts=4, top_k=2,
                moe_capacity_factor=4.0),
    "hybrid": dict(name="hyb", family="hybrid", n_layers=5, d_model=64,
                   n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=97,
                   local_window=4, lru_width=64,
                   layer_pattern=("rglru", "rglru", "local_attn")),
    "ssm": dict(name="ssm", family="ssm", n_layers=2, d_model=64, n_heads=0,
                n_kv_heads=0, d_ff=128, vocab_size=97,
                layer_pattern=("rwkv6",), head_dim=16),
    "audio": dict(name="audio", family="audio", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=97,
                  activation="gelu", norm="layernorm", use_rope=False,
                  max_position_embeddings=128, n_encoder_layers=2,
                  encoder_seq_len=16),
}
CASES = tuple(FAMS) + ("gpt2-tiny", "qwen3-1.7b", "llava-next-34b")
# leaves initialised to 0 or 1 that are drawn away from it, so that the
# QKV bias and the qk-norm scales change the result
PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm")


def _configs(case):
    """(reference, port) configs of ``case``, the reference's under its
    plain (``xla``) policy."""
    if case in FAMS:
        return (RefModelConfig(**FAMS[case], kernel_policy="xla"),
                ModelConfig(**FAMS[case]))
    if case == "gpt2-tiny":
        return (dataclasses.replace(ref_gpt2_tiny(), kernel_policy="xla"),
                gpt2_tiny())
    return (dataclasses.replace(ref_registry.get_config(case).reduced(
        d_model=64), kernel_policy="xla"),
        registry.get_config(case).reduced(d_model=64))


def _perturbed(tree, gen):
    """The port's params with the PERTURBED leaves moved off their init."""
    if isinstance(tree, dict):
        return {k: v + 0.3 * torch.randn(v.shape, generator=gen)
                if k in PERTURBED else _perturbed(v, gen)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_perturbed(v, gen) for v in tree)
    return tree


def _f32(tree):
    """A reference cache as numpy fp32 (bf16 leaves as their values)."""
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32), tree)


def _run(case, cache_dtype):
    ref_cfg, cfg = _configs(case)
    ref_model, model = ref_build(ref_cfg), build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    tp = _perturbed(model.init(gen, "cpu"), gen)
    params = bridge.params_to_reference(tp, cfg)
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    ref_batch, batch = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.as_tensor(tokens).long()}
    if cfg.is_encoder_decoder:
        enc = (0.1 * rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
        ref_batch["enc_embeds"] = jnp.asarray(enc)
        batch["enc_embeds"] = torch.from_numpy(enc)

    jdt = jnp.bfloat16 if cache_dtype == torch.bfloat16 else jnp.float32
    ref_cache = ref_model.init_cache(params, B, T, ref_batch, dtype=jdt)
    step = jax.jit(ref_model.decode_step)
    want = []
    for t in range(T):
        lg, ref_cache = step(params, ref_cache, ref_batch["tokens"][:, t],
                             jnp.asarray(t, jnp.int32))
        want.append(np.asarray(lg))

    with torch.no_grad():
        cache = model.init_cache(tp, B, T, batch, dtype=cache_dtype)
        got = []
        for t in range(T):
            lg, cache = model.decode_step(tp, cache, batch["tokens"][:, t], t)
            got.append(lg.numpy())
        full, _ = model.forward(tp, batch)
    return {"cfg": cfg, "want": np.stack(want, 1), "got": np.stack(got, 1),
            "full": full.numpy(), "ref_cache": ref_cache, "cache": cache}


@pytest.fixture(scope="module")
def runs():
    out = {case: _run(case, torch.float32) for case in CASES}
    out["dense bf16"] = _run("dense", torch.bfloat16)
    return out


@pytest.mark.parametrize("case", CASES)
def test_decode_logits_match_reference(runs, case):
    r = runs[case]
    assert r["got"].shape == r["want"].shape == (B, T, r["cfg"].vocab_size)
    np.testing.assert_allclose(r["got"], r["want"], **STEP)


@pytest.mark.parametrize("case", CASES)
def test_final_cache_matches_reference(runs, case):
    """The port's cache after T steps, in the reference's layout, against
    the reference's; and the reference's through the bridge and back bit
    for bit."""
    r = runs[case]
    want = _f32(r["ref_cache"])
    got = bridge.cache_to_reference(r["cache"], r["cfg"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **STEP),
                 got, want)
    back = bridge.cache_to_reference(bridge.cache_from_reference(
        jax.tree.map(np.asarray, r["ref_cache"]), "cpu"), r["cfg"])
    jax.tree.map(np.testing.assert_array_equal, back, want)


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_own_forward(runs, case):
    """Decode against the port's forward over the same tokens, within the
    reference's 2e-3 (the MoE at capacity factor 4.0 drops no token either
    way; the windows of 4 mask the same keys)."""
    r = runs[case]
    assert float(np.abs(r["full"] - r["got"]).max()) < 2e-3


def _bf16_bits(x):
    """fp32 numpy holding bf16 values -> their 16-bit patterns (int)."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16) \
        .astype(np.int64)


def test_bf16_cache_model_within_its_own_effect(runs):
    """The dense model at the default bf16 cache.  Its K/V come from fp32
    projections that the two frameworks sum in different orders (a few
    ulps apart, more where a sum cancels), and a value within that of a
    bf16 rounding boundary rounds to the neighbouring bf16 value: so the
    slots are bf16 in both, at most one bf16 ulp apart and equal in all
    but a small share; the logits lie within the bf16 cache's own effect
    on the reference (its distance from the reference's fp32-cache run)."""
    r = runs["dense bf16"]
    for layer in r["cache"]["layers"]:
        assert layer["k"].dtype == layer["v"].dtype == torch.bfloat16
    assert str(jax.tree.leaves(r["ref_cache"])[0].dtype) == "bfloat16"
    got = bridge.cache_to_reference(r["cache"], r["cfg"])
    want = _f32(r["ref_cache"])
    n = differ = 0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= np.maximum(ulp, STEP["atol"]))
        n, differ = n + g.size, differ + int((g != w).sum())
    assert differ <= 0.01 * n, (differ, n)
    own = np.abs(r["want"] - runs["dense"]["want"]).max()
    assert np.abs(r["got"] - r["want"]).max() <= own


def _grid(rng, shape, scale):
    """Small integers times a power of two: products and sums of them are
    exact in fp32 in any order."""
    return (rng.integers(-8, 9, shape) * scale).astype(np.float32)


@pytest.mark.parametrize("window", [0, 4])
def test_bf16_cache_kv_bit_for_bit(window):
    """attention_decode at the default bf16 cache, linear and ring: from
    weights and inputs on a grid where the fp32 projections are exact in
    any summation order (no RoPE, no norm), the two frameworks' fp32 k and
    v are the same and the bf16 slots written from them the same bits
    (both round to nearest even; many of these values are exact ties),
    over 9 steps; each step's output at atol 1e-5 / rtol 1e-4."""
    from repro.models import attention as ref_attention
    from repro_torch.models import attention
    kw = dict(FAMS["dense"], use_rope=False)
    ref_cfg, cfg = RefModelConfig(**kw, kernel_policy="xla"), ModelConfig(**kw)
    rng = np.random.default_rng(11)
    d, hd = cfg.d_model, cfg.head_dim
    p = {"wq": _grid(rng, (d, 4 * hd), 2.0 ** -6),
         "wk": _grid(rng, (d, 2 * hd), 2.0 ** -6),
         "wv": _grid(rng, (d, 2 * hd), 2.0 ** -6),
         "wo": _grid(rng, (4 * hd, d), 2.0 ** -6)}
    x = _grid(rng, (T, B, 1, d), 2.0 ** -3)
    ref_cache = ref_attention.init_kv_cache(ref_cfg, B, T, window=window)
    cache = attention.init_kv_cache(cfg, B, T, window=window)
    assert cache["k"].dtype == torch.bfloat16
    step = jax.jit(lambda c, xt, pos: ref_attention.attention_decode(
        p, ref_cfg, xt, c, pos, window=window))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ties = 0
    with torch.no_grad():
        for t in range(T):
            want, ref_cache = step(ref_cache, jnp.asarray(x[t]),
                                   jnp.asarray(t, jnp.int32))
            got, cache = attention.attention_decode(
                tp, cfg, torch.from_numpy(x[t]), cache, t, window=window)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
            v32 = torch.from_numpy(x[t]) @ tp["wv"]
            ties += int(((v32.view(torch.int32) & 0xFFFF) == 0x8000).sum())
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            _bf16_bits(cache[name].float().numpy()),
            _bf16_bits(np.asarray(ref_cache[name]).astype(np.float32)))
    assert ties > 0


def test_ring_wraps_and_linear_cache_clamps():
    """The two slot rules at positions past the cache, through the port
    alone: a ring of the window's size writes position pos into slot
    pos % 4; a linear cache of 3 slots writes min(pos, 2), so past its
    end it keeps overwriting its last slot, as the reference's does."""
    from repro_torch.models import attention
    cfg = ModelConfig(**FAMS["swa"])
    gen = torch.Generator().manual_seed(0)
    p = attention.init_attention(gen, cfg, "cpu")
    x = torch.randn(1, 6, 1, cfg.d_model, generator=gen)
    ring_w, lin_w = {}, {}
    with torch.no_grad():
        ring = attention.init_kv_cache(cfg, 1, 32, window=4,
                                       dtype=torch.float32)
        lin = attention.init_kv_cache(cfg, 1, 3, dtype=torch.float32)
        for pos in range(6):
            attention.attention_decode(p, cfg, x[:, pos], ring, pos, window=4)
            attention.attention_decode(p, cfg, x[:, pos], lin, pos)
            ring_w[pos] = ring["k"][:, pos % 4].clone()
            lin_w[pos] = lin["k"][:, min(pos, 2)].clone()
    assert ring["k"].shape[1] == 4 and lin["k"].shape[1] == 3
    for slot, pos in enumerate((4, 5, 2, 3)):
        assert torch.equal(ring["k"][:, slot], ring_w[pos])
    for slot, pos in enumerate((0, 1, 5)):
        assert torch.equal(lin["k"][:, slot], lin_w[pos])
    assert not torch.equal(lin_w[5], lin_w[4])
