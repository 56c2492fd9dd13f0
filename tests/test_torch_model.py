"""The port's GPT-2 substrate against the reference's, at ``gpt2_tiny``:
a bridged parameter tree gives the same logits as
``repro.models.factory.Model.forward`` (kernel policy ``xla``), with and
without a bound LoRA tree, and the building blocks match one by one.

Inputs come from the reference's own init (bridged, numpy in between) or
a numpy seed.  Tolerance atol 1e-4 / rtol 1e-4 on logits and layer
outputs (fp32, different summation order over 4 layers of width 128);
1e-6 on elementwise pieces and the optimizer."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.optim import adam as ref_adam  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
RANK, ALPHA = 4, 32.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def bridged():
    """Reference params and a LoRA tree with non-zero B, both sides."""
    ref_cfg = dataclasses.replace(ref_tiny(), kernel_policy="xla")
    ref_model = ref_build(ref_cfg)
    params = _np(ref_model.init(jax.random.PRNGKey(0)))
    lt = _np(ref_lora.init_lora(jax.random.PRNGKey(1), params,
                                ("wq", "wk", "wv"), RANK, ALPHA))
    rng = np.random.default_rng(0)
    for leaf in lt["blocks"][0]["attn"].values():
        leaf["b"] = (rng.standard_normal(leaf["b"].shape) * 0.05
                     ).astype(np.float32)
    tokens = rng.integers(1, ref_cfg.vocab_size, (2, 24)).astype(np.int32)
    return dict(ref_model=ref_model, params=params, lora=lt, tokens=tokens,
                base=bridge.params_from_reference(params, "cpu"),
                port_lora=bridge.lora_from_reference(lt, "cpu"),
                model=build_model(gpt2_tiny()))


@pytest.mark.parametrize("with_lora", [False, True])
def test_logits_match_reference(bridged, with_lora):
    b = bridged
    ref_params, port_params = b["params"], b["base"]
    if with_lora:
        ref_params = ref_lora.bind(ref_params, b["lora"], ALPHA, RANK)
        port_params = lora_lib.bind(port_params, b["port_lora"], ALPHA, RANK)
    want, _ = b["ref_model"].forward(ref_params,
                                     {"tokens": jnp.asarray(b["tokens"])})
    with torch.no_grad():
        got, aux = b["model"].forward(
            port_params, {"tokens": torch.as_tensor(b["tokens"]).long()})
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_fwd_matches_reference(bridged):
    b = bridged
    cfg = gpt2_tiny()
    ref_bound = ref_lora.bind(b["params"], b["lora"], ALPHA, RANK)
    ref_layer = jax.tree.map(lambda x: x[1], ref_bound["blocks"][0]["attn"])
    port_layer = lora_lib.bind(b["base"], b["port_lora"], ALPHA,
                               RANK)["layers"][1]["attn"]
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)) \
        .astype(np.float32)
    want = ref_attention.attention_fwd(ref_layer, ref_tiny(), jnp.asarray(x),
                                       jnp.arange(24)[None])
    with torch.no_grad():
        got = attention.attention_fwd(port_layer, cfg, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lora_apply_matches_reference():
    rng = np.random.default_rng(2)
    x, w, a, b = [(rng.standard_normal(s) * sc).astype(np.float32)
                  for s, sc in (((2, 10, 48), 1.0), ((48, 40), 0.1),
                                ((48, 8), 0.1), ((8, 40), 0.1))]
    want = ref_lora.lora_apply(*map(jnp.asarray, (x, w, a, b)))
    got = lora_lib.lora_apply(*map(torch.tensor, (x, w, a, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_building_blocks_match_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 64)) * 2 + 0.5).astype(np.float32)
    ln = {"scale": rng.standard_normal(64).astype(np.float32),
          "bias": rng.standard_normal(64).astype(np.float32)}
    np.testing.assert_allclose(
        common.layernorm({k: torch.tensor(v) for k, v in ln.items()},
                         torch.tensor(x)).numpy(),
        np.asarray(ref_common.layernorm(ln, jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(common.gelu(torch.tensor(x)).numpy(),
                               np.asarray(ref_common.gelu(jnp.asarray(x))),
                               atol=1e-6)
    for args in ((7, 7, 0, 0), (5, 9, 4, 3)):
        np.testing.assert_array_equal(common.causal_mask(*args).numpy(),
                                      np.asarray(ref_common.causal_mask(*args)))


def test_adam_matches_reference():
    """Three steps of the port's Adam against the reference's, same grads."""
    rng = np.random.default_rng(4)
    p = {"a": rng.standard_normal((6, 3)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    tp = tree_lib.map_(torch.tensor, p)
    rp, rs, ts = jax.tree.map(jnp.asarray, p), ref_adam.init(p), adam.init(tp)
    for _ in range(3):
        g = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 1e-3).astype(np.float32),
            p)
        rp, rs = ref_adam.update(jax.tree.map(jnp.asarray, g), rs, rp, 1e-3)
        tp, ts = adam.update(tree_lib.map_(torch.tensor, g), ts, tp, 1e-3)
    assert ts["step"] == int(rs["step"]) == 3
    for got, want in zip(tree_lib.leaves(tp), jax.tree.leaves(rp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
