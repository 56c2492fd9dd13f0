"""The port's GPT-2 substrate against the reference's, at ``gpt2_tiny``:
a bridged parameter tree gives the same logits as
``repro.models.factory.Model.forward`` (kernel policy ``xla``), with and
without a bound LoRA tree, the same gradient with respect to the bound
base weights and the LoRA factors as ``jax.grad`` under kernel policy
``pallas``, and the building blocks match one by one.

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


def _live_targets(tree, targets, wrap):
    """``tree`` with each targeted 2-D weight passed through ``wrap``."""
    if isinstance(tree, dict):
        return {k: (wrap(v) if k in targets and getattr(v, "ndim", 0) == 2
                    else _live_targets(v, targets, wrap))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_live_targets(v, targets, wrap) for v in tree)
    return tree


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# each gradient leaf within this many times the largest relative L2
# distance between the reference's own "xla" and "pallas" gradients
GRAD_FACTOR = 3.0


@pytest.fixture(scope="module")
def base_grads(bridged):
    """A labelled batch, the reference's gradient of the classification
    loss with respect to the bound wq/wk/wv and the LoRA factors under
    kernel policy ``pallas`` (its custom_vjp returns dW through
    ``_dw_call``, in interpret mode here) as port-ordered leaves, and the
    bound GRAD_FACTOR sets from the ``xla`` policy's distance to it."""
    from repro.core import tasks as ref_tasks

    b = bridged
    rng = np.random.default_rng(5)
    batch = {"tokens": b["tokens"],
             "lengths": rng.integers(8, 25, 2).astype(np.int32),
             "labels": rng.integers(0, 77, 2).astype(np.int32)}

    def grads(policy):
        model = ref_build(dataclasses.replace(ref_tiny(),
                                              kernel_policy=policy))

        def loss(params, lt):
            logits, _ = model.forward(ref_lora.bind(params, lt, ALPHA, RANK),
                                      jax.tree.map(jnp.asarray, batch))
            return ref_tasks.classification_loss_fn(logits, batch)[0]

        gp, gl = jax.grad(loss, argnums=(0, 1))(b["params"], b["lora"])
        leaves = []
        _live_targets(bridge.params_from_reference(_np(gp), "cpu"),
                      ("wq", "wk", "wv"), leaves.append)
        return leaves + tree_lib.leaves(
            bridge.lora_from_reference(_np(gl), "cpu"))

    want = grads("pallas")
    bound = GRAD_FACTOR * max(_rel_l2(x, w)
                              for x, w in zip(grads("xla"), want))
    return batch, want, bound


@pytest.mark.parametrize("route", ["plain", "function"])
def test_base_weight_grads_match_reference(bridged, base_grads, route,
                                           monkeypatch):
    """The gradient of the classification loss with respect to the bound
    base weights wq/wk/wv of every layer and to the LoRA factors, against
    the reference's ``jax.grad`` under kernel policy ``pallas``.
    ``plain`` is the port's CPU path (autograd through the plain chain);
    ``function`` sends every LoRA projection through LoRAMatmul (its dW
    twin included) and every attention through FlashAttention, as the
    ``cuda`` policy does on the card.  Each leaf within GRAD_FACTOR times
    the reference's own "xla"-to-"pallas" distance in relative L2
    (elementwise atol 1e-4 / rtol 1e-4 is out of reach: on the B
    factors' gradients, up to 7 here, the reference's two policies part
    by more)."""
    from repro_torch.core import tasks
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ops

    b, targets = bridged, ("wq", "wk", "wv")
    batch, want, bound = base_grads

    calls = []
    if route == "function":
        def lora_function(x, w, a, b_):
            calls.append(("lora", w.requires_grad))
            *lead, K = x.shape
            return lm.lora_matmul(x.reshape(-1, K), w, a, b_).reshape(
                *lead, w.shape[1])

        def flash_function(q, k, v, causal, window, q_offset):
            calls.append(("flash", q.requires_grad))
            return fa.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal, window,
                                      q_offset)
        monkeypatch.setattr(ops, "lora_matmul", lora_function)
        monkeypatch.setattr(ops.ref, "attention_ref", flash_function)
    ws = []

    def live(t):
        t = t.detach().clone().requires_grad_(True)
        ws.append(t)
        return t

    base = _live_targets(b["base"], targets, live)
    lt = tree_lib.map_(lambda t: t.detach().clone().requires_grad_(True),
                       b["port_lora"])
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    logits, _ = b["model"].forward(lora_lib.bind(base, lt, ALPHA, RANK), tb)
    loss, _ = tasks.get_loss_fn("classification")(logits, tb)
    got = torch.autograd.grad(loss, ws + tree_lib.leaves(lt))
    assert calls == ((([("lora", True)] * 3 + [("flash", True)]) * 4)
                     if route == "function" else [])
    assert len(got) == len(want) == 3 * 4 + 2 * 3 * 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        rel = _rel_l2(g.numpy(), w.numpy())
        assert rel <= bound, f"leaf {i}: relative L2 {rel:.3e} > {bound:.3e}"


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


@pytest.mark.parametrize("dp_clip", [0.0, 0.5])
def test_plain_path_runs_in_float64(dp_clip):
    """The yardstick of the full-width gates on the card: from weights cast
    to float64 the plain path stays float64 end to end.  The initial LoRA
    (B = 0) is the fp32 one's draws in float64; one train step (Adam;
    under DP the clipped mean of per-example gradients) keeps every LoRA
    leaf and Adam moment in float64; and the step's gradient is within
    1e-5 relative L2 of the fp32 one."""
    from repro_torch.configs.base import FedConfig, PrivacyConfig
    from repro_torch.core import tasks
    from repro_torch.core.fedavg import make_fns, to_device
    from repro_torch.data import banking77
    from repro_torch.data.loader import epoch_batches
    from repro_torch.privacy import dp as dp_mod

    def f64(tree):
        return tree_lib.map_(
            lambda t: t.double() if t.is_floating_point() else t, tree)

    cfg = dataclasses.replace(gpt2_tiny(), kernel_policy="torch")
    fed = FedConfig(framework="fedllm", rounds=1, lora_rank=RANK,
                    lora_alpha=ALPHA, lora_dropout=0.0,
                    privacy=PrivacyConfig(dp_clip=dp_clip))
    _, train, _ = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                         scale=0.04)
    batch = to_device(next(iter(epoch_batches(train, 8, seed=0))), "cpu")
    model = build_model(cfg)
    fns, loss_fn = make_fns(model, fed), tasks.get_loss_fn("classification")
    base = model.init(torch.Generator().manual_seed(0), "cpu")
    lt, lt64 = (lora_lib.init_lora(torch.Generator().manual_seed(1), b,
                                   ("wq", "wk", "wv"), RANK, ALPHA)
                for b in (base, f64(base)))
    for a, b in zip(tree_lib.leaves(lt), tree_lib.leaves(lt64)):
        assert b.dtype == torch.float64 and torch.equal(a.double(), b)

    def step_grad(b, l):
        if dp_clip:
            _, rows = fns["per_example_grads"](b, l, batch)
            return [dp_mod.clipped_grad_mean(rows, dp_clip)]
        live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), l)
        logits, _ = model.forward(lora_lib.bind(b, live, ALPHA, RANK), batch)
        loss, _ = loss_fn(logits, batch)
        return torch.autograd.grad(loss, tree_lib.leaves(live))

    g32, g64 = step_grad(base, lt), step_grad(f64(base), lt64)
    assert all(g.dtype == torch.float64 for g in g64)
    num = sum(float(((a.double() - b) ** 2).sum()) for a, b in zip(g32, g64))
    den = sum(float((b ** 2).sum()) for b in g64)
    assert den > 0 and (num / den) ** 0.5 <= 1e-5
    new, state, loss = fns["train_step"](f64(base), lt64,
                                         fns["opt_init"](lt64), batch)
    leaves = (tree_lib.leaves(new) + tree_lib.leaves(state["m"])
              + tree_lib.leaves(state["v"]))
    assert leaves and all(t.dtype == torch.float64 for t in leaves)
    assert loss.dtype == torch.float64
