"""The port's Griffin hybrid (RecurrentGemma) against the reference's, on
the CPU: the RG-LRU scan's plain twins (the versions the CUDA kernels are
held to on the card) against the Pallas ``rglru_scan`` in interpret mode
and against ``jax.vjp`` of the reference's scan oracle; the RG-LRU layer,
RMSNorm, RoPE, SwiGLU and windowed GQA attention; the bridge and the
whole hybrid forward; and FedLLM, KD-FedLLM (top-8 int8 logits) and
DP-FedLLM (clip 0.5, noise 0, secure aggregation) end to end at
``recurrentgemma-2b.reduced(n_layers=5, d_model=128)`` (one pattern group
of (rglru, rglru, local_attn) and a two-layer RG-LRU tail).

Inputs come from a numpy seed or the reference's own init (bridged).
Tolerances: the scan twins atol 1e-6 / rtol 1e-5 (the same recurrence in
fp32; XLA may contract a·h + b into one FMA, the twin rounds twice); the
RG-LRU layer, attention, logits atol 1e-5 to 1e-4 / rtol 1e-4 (fp32, an
associative scan or other summation orders against a sequential loop);
elementwise pieces atol 1e-6; FedLLM at the North-star bar (ledger bytes
and FLOPs exact, round loss and accuracy within 1e-3, final LoRA atol
5e-5 / rtol 5e-4)."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.configs.recurrentgemma_2b import config as ref_rg2b  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import recurrentgemma_2b  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.models import attention, common, mlp, rglru  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

SCAN = dict(atol=1e-6, rtol=1e-5)
LAYER = dict(atol=1e-5, rtol=1e-4)
RANK, ALPHA = 4, 32.0
FED = dict(framework="fedllm", rounds=2, lora_rank=RANK, lora_dropout=0.0,
           seed=0)


def _cfgs():
    """(reference, port) configs of the reduced hybrid."""
    ref_cfg = dataclasses.replace(
        ref_rg2b().reduced(n_layers=5, d_model=128), kernel_policy="xla")
    return ref_cfg, recurrentgemma_2b().reduced(n_layers=5, d_model=128)


def _scan_inputs(seed, B, S, W):
    """Decays in (0, 1) and inputs of the size the RG-LRU gives them."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, W)) - 2))
         ).astype(np.float32)
    b = (rng.standard_normal((B, S, W)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


# --------------------------------------------------------------------------- #
# The scan twins (row 15)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,W", [(2, 64, 128), (3, 24, 200), (1, 1, 64),
                                   (2, 40, 96)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_twin_matches_pallas(B, S, W, with_h0):
    """The plain twin against the Pallas kernel (W 200 takes ops.fit_block's
    block of 100, S 1 a single step), with h0 zero or random; the
    autograd Function on CPU tensors gives the twin's bits."""
    a, b, h0 = _scan_inputs(B * S + W, B, S, W)
    if not with_h0:
        h0 = np.zeros_like(h0)
    want_h, want_hf = jax_ops.rglru(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0))
    th0 = torch.tensor(h0) if with_h0 else None
    got_h, got_hf = ref.rglru_scan(torch.tensor(a), torch.tensor(b), th0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SCAN)
    np.testing.assert_allclose(got_hf.numpy(), np.asarray(want_hf), **SCAN)
    fn_h, fn_hf = rg.rglru_scan(torch.tensor(a), torch.tensor(b), th0)
    assert torch.equal(fn_h, got_h) and torch.equal(fn_hf, got_hf)


@pytest.mark.parametrize("with_dh_final", [False, True])
def test_rglru_scan_bwd_matches_jax_vjp(with_dh_final):
    """da, db, dh0 of the backward twin against ``jax.vjp`` of the
    reference's scan oracle; the autograd Function's gradients are the
    twin's, and so are plain autograd's through the step loop, bit for
    bit."""
    B, S, W = 3, 37, 48
    a, b, h0 = _scan_inputs(5, B, S, W)
    rng = np.random.default_rng(6)
    dh = rng.standard_normal((B, S, W)).astype(np.float32)
    dhf = rng.standard_normal((B, W)).astype(np.float32) if with_dh_final \
        else np.zeros((B, W), np.float32)
    _, vjp = jax.vjp(jax_ref.rglru_scan_ref, jnp.asarray(a), jnp.asarray(b),
                     jnp.asarray(h0))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dh), jnp.asarray(dhf)))]

    ta, tb, th0 = (torch.tensor(x) for x in (a, b, h0))
    h, _ = ref.rglru_scan(ta, tb, th0)
    tdhf = torch.tensor(dhf) if with_dh_final else None
    got = ref.rglru_scan_bwd(ta, h, th0, torch.tensor(dh), tdhf, True)
    for g, w, name in zip(got, want, ("da", "db", "dh0")):
        np.testing.assert_allclose(g.numpy(), w, **SCAN, err_msg=name)

    for fn in (rg.rglru_scan, ref.rglru_scan):
        leaves = [x.clone().requires_grad_(True) for x in (ta, tb, th0)]
        hs, hf = fn(*leaves)
        out = (hs * torch.tensor(dh)).sum()
        if with_dh_final:
            out = out + (hf * torch.tensor(dhf)).sum()
        grads = torch.autograd.grad(out, leaves)
        for g, twin in zip(grads, got):
            assert torch.equal(g, twin), fn


def test_rglru_scan_bwd_without_h0():
    """h0 None: the first step's da is g·0 and no dh0 is formed."""
    a, b, _ = _scan_inputs(7, 2, 9, 16)
    dh = np.random.default_rng(8).standard_normal(a.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a_, b_: jax_ref.rglru_scan_ref(
        a_, b_, jnp.zeros((2, 16)))[0], jnp.asarray(a), jnp.asarray(b))
    want = vjp(jnp.asarray(dh))
    ta, tb = torch.tensor(a), torch.tensor(b)
    h, _ = ref.rglru_scan(ta, tb)
    da, db, dh0 = ref.rglru_scan_bwd(ta, h, None, torch.tensor(dh))
    assert dh0 is None
    np.testing.assert_allclose(da.numpy(), np.asarray(want[0]), **SCAN)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[1]), **SCAN)


def test_rglru_cuda_policy_refuses_cpu_tensors():
    a, b, h0 = (torch.tensor(x) for x in _scan_inputs(9, 2, 4, 8))
    with ops.policy_scope("cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.rglru(a, b)
        with pytest.raises(ValueError, match="CUDA"):
            ops.rglru(a, b, h0)
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru_fwd(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru_bwd(a, a, None, a)
    with ops.policy_scope("torch"):                # the plain path runs
        h, _ = ops.rglru(a, b, h0)
    assert torch.equal(h, ref.rglru_scan(a, b, h0)[0])


# --------------------------------------------------------------------------- #
# Layers and building blocks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_layer_matches_reference(with_h0):
    """The port's RG-LRU block (gates, conv1d, scan, GeLU gate) against the
    reference's associative scan, from the reference's init with
    non-zero biases."""
    ref_cfg, cfg = _cfgs()
    p = jax.tree.map(np.asarray,
                     ref_rglru.init_rglru(jax.random.PRNGKey(3), ref_cfg))
    rng = np.random.default_rng(10)
    for k in ("conv_b", "b_a", "b_x"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width)).astype(np.float32) \
        if with_h0 else None
    want, want_h = ref_rglru.rglru_fwd(
        p, ref_cfg, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    got, got_h = rglru.rglru_fwd({k: torch.tensor(v) for k, v in p.items()},
                                 cfg, torch.tensor(x),
                                 None if h0 is None else torch.tensor(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **LAYER)


def test_norm_rope_swiglu_match_reference():
    ref_cfg, cfg = _cfgs()
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 7, 64)) * 2 + 0.5).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        common.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x)),
        np.asarray(ref_common.rmsnorm({"scale": scale}, jnp.asarray(x))),
        atol=1e-6, rtol=1e-6)
    q = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    for positions in (np.arange(24), np.arange(24)[None].repeat(2, 0) + 5):
        np.testing.assert_allclose(
            common.apply_rope(torch.tensor(q), torch.tensor(positions),
                              1e4).numpy(),
            np.asarray(ref_common.apply_rope(jnp.asarray(q),
                                             jnp.asarray(positions), 1e4)),
            atol=1e-5, rtol=1e-5)
    p = jax.tree.map(np.asarray, ref_mlp.init_mlp(jax.random.PRNGKey(4),
                                                  ref_cfg))
    assert sorted(p) == ["w_gate", "w_in", "w_out"]
    h = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        mlp.mlp_fwd({k: torch.tensor(v) for k, v in p.items()}, cfg,
                    torch.tensor(h)).numpy(),
        np.asarray(ref_mlp.mlp_fwd(p, ref_cfg, jnp.asarray(h))), **LAYER)


def test_windowed_gqa_rope_attention_matches_reference():
    """RoPE, one KV head for four query heads and a window of 8 over
    S = 24, so that the window masks most of each row."""
    ref_cfg, cfg = _cfgs()
    assert cfg.n_kv_heads == 1 and cfg.n_heads == 4 and cfg.use_rope
    p = jax.tree.map(np.asarray, ref_attention.init_attention(
        jax.random.PRNGKey(5), ref_cfg))
    x = np.random.default_rng(12).standard_normal((2, 24, cfg.d_model)) \
        .astype(np.float32)
    positions = np.arange(24)[None].repeat(2, 0)
    want = ref_attention.attention_fwd(p, ref_cfg, jnp.asarray(x),
                                       jnp.asarray(positions), window=8)
    got = attention.attention_fwd({k: torch.tensor(v) for k, v in p.items()},
                                  cfg, torch.tensor(x),
                                  torch.tensor(positions), window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    full = attention.attention_fwd({k: torch.tensor(v) for k, v in p.items()},
                                   cfg, torch.tensor(x))
    assert not np.allclose(full.numpy(), got.numpy(), atol=1e-3)


# --------------------------------------------------------------------------- #
# Bridge and the whole model
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def hybrid():
    """Reference params and a LoRA tree with non-zero B, both sides."""
    ref_cfg, cfg = _cfgs()
    ref_model = ref_build(ref_cfg)
    params = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    lt = jax.tree.map(np.asarray, ref_lora.init_lora(
        jax.random.PRNGKey(1), params, ("wq", "wk", "wv"), RANK, ALPHA))
    rng = np.random.default_rng(13)
    for leaf in lt["blocks"][2]["attn"].values():
        leaf["b"] = (rng.standard_normal(leaf["b"].shape) * 0.05
                     ).astype(np.float32)
    tokens = rng.integers(1, ref_cfg.vocab_size, (2, 24)).astype(np.int32)
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_model=ref_model, params=params,
                lora=lt, tokens=tokens,
                base=bridge.params_from_reference(params, "cpu"),
                port_lora=bridge.lora_from_reference(lt, "cpu", cfg),
                model=build_model(cfg))


def test_bridge_round_trip(hybrid):
    """Layer g·P + pi is group g's pattern position pi, the tail follows;
    a LoRA tree keeps None at the RG-LRU layers and comes back as the
    reference's tree exactly."""
    h, cfg = hybrid, hybrid["cfg"]
    layers = h["base"]["layers"]
    assert len(layers) == 5 and cfg.layer_kinds == (
        "rglru", "rglru", "local_attn", "rglru", "rglru")
    assert "pos_embed" not in h["base"]
    for i, (kind, layer) in enumerate(zip(cfg.layer_kinds, layers)):
        want = h["params"]["blocks"][i]["attn"] if i < 3 else \
            h["params"]["tail"][i - 3]["attn"]
        assert sorted(layer["attn"]) == sorted(want)
        assert ("wq" in layer["attn"]) == (kind == "local_attn")
        for name, leaf in layer["attn"].items():
            np.testing.assert_array_equal(
                leaf.numpy(), want[name][0] if i < 3 else want[name])
    assert [x is None for x in h["port_lora"]["layers"]] == \
        [True, True, False, True, True]
    back = bridge.lora_to_reference(h["port_lora"], cfg)
    assert jax.tree.structure(back) == jax.tree.structure(h["lora"])
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(h["lora"])):
        np.testing.assert_array_equal(got, want)
    assert lora_lib.n_bytes(h["port_lora"]) == ref_lora.n_bytes(h["lora"])
    own = lora_lib.init_lora(torch.Generator().manual_seed(0), h["base"],
                             ("wq", "wk", "wv"), RANK)
    assert [x is None for x in own["layers"]] == \
        [x is None for x in h["port_lora"]["layers"]]


@pytest.mark.parametrize("with_lora", [False, True])
def test_hybrid_logits_match_reference(hybrid, with_lora):
    h = hybrid
    ref_params, port_params = h["params"], h["base"]
    if with_lora:
        ref_params = ref_lora.bind(ref_params, h["lora"], ALPHA, RANK)
        port_params = lora_lib.bind(port_params, h["port_lora"], ALPHA, RANK)
    want, _ = h["ref_model"].forward(ref_params,
                                     {"tokens": jnp.asarray(h["tokens"])})
    with torch.no_grad():
        got, aux = h["model"].forward(
            port_params, {"tokens": torch.as_tensor(h["tokens"]).long()})
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_hybrid_param_count_matches_reference():
    ref_cfg, cfg = _cfgs()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    assert recurrentgemma_2b().param_count() == ref_rg2b().param_count()
    assert recurrentgemma_2b().layer_kinds == ref_rg2b().layer_kinds


# --------------------------------------------------------------------------- #
# FedLLM end to end
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fed_runs(hybrid):
    """The reference's and the port's FedLLM runs from the same weights:
    paper_splits(scale=0.04, pad_len=24), 3 IID clients, 2 rounds, rank 4,
    dropout 0, batch 16, eval batch 64."""
    ref_cfg, cfg = _cfgs()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    clients = partition.iid_partition(train, 3)
    lt = jax.tree.map(np.asarray, ref_lora.init_lora(
        jax.random.PRNGKey(FED["seed"] + 1), hybrid["params"],
        ("wq", "wk", "wv"), RANK, ALPHA))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = ref_run(dataclasses.replace(ref_cfg, kernel_policy="auto"),
                      RefFedConfig(**FED), pub, clients, test, batch_size=16,
                      eval_batch=64)
    port = run_federated(cfg, FedConfig(**FED), pub, clients, test,
                         batch_size=16, eval_batch=64, device="cpu",
                         base=hybrid["base"],
                         lora=bridge.lora_from_reference(lt, "cpu", cfg))
    return ref, port


def test_fedllm_ledger_and_flops_equal(fed_runs):
    ref, port = fed_runs
    assert port.ledger.by_name() == ref.ledger.by_name() == \
        {"lora_params": 110592}
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client


def test_fedllm_rounds_and_final_lora_close(fed_runs):
    ref, port = fed_runs
    assert len(port.history) == len(ref.history) == 2
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    cfg = _cfgs()[1]
    got = bridge.lora_to_reference(port.final_lora, cfg)
    want = jax.tree.map(np.asarray, ref.final_lora)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)


# --------------------------------------------------------------------------- #
# KD-FedLLM and DP-FedLLM end to end
# --------------------------------------------------------------------------- #
OTHER = {"kd": (dict(framework="kd", logit_topk=8, logit_quant_bits=8), {},
                {"logits": 105600}),
         "dp": (dict(framework="fedllm"), dict(dp_clip=0.5, secure_agg=True),
                {"lora_params": 110592, "secagg_keys": 1344, "dp_meta": 72})}


@pytest.fixture(scope="module")
def other_runs(hybrid):
    """{case: (reference result, port result)}: KD with top-8 int8 logits
    and DP (clip 0.5, noise 0, secure aggregation) on the reduced hybrid,
    fed_runs' data, rounds, rank and dropout, from the reference's
    initial weights bridged (KD: one LoRA tree per client and one for the
    server, from the reference's keys)."""
    ref_cfg, cfg = _cfgs()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    clients = partition.iid_partition(train, 3)

    def draw(key):
        lt = ref_lora.init_lora(key, hybrid["params"], ("wq", "wk", "wv"),
                                RANK, ALPHA)
        return bridge.lora_from_reference(jax.tree.map(np.asarray, lt),
                                          "cpu", cfg)

    kd_key = jax.random.PRNGKey(FED["seed"] + 2)
    loras = {"kd": {"clients": [draw(jax.random.fold_in(kd_key, ci))
                                for ci in range(len(clients))],
                    "server": draw(jax.random.fold_in(kd_key, 999))},
             "dp": draw(jax.random.PRNGKey(FED["seed"] + 1))}
    out = {}
    for name, (fed_kw, priv, _) in OTHER.items():
        common_kw = {**FED, **fed_kw}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref = ref_run(dataclasses.replace(ref_cfg, kernel_policy="auto"),
                          RefFedConfig(**common_kw,
                                       privacy=RefPrivacy(**priv)),
                          pub, clients, test, batch_size=16, eval_batch=64)
        port = run_federated(cfg, FedConfig(**common_kw,
                                             privacy=PrivacyConfig(**priv)),
                             pub, clients, test, batch_size=16,
                             eval_batch=64, device="cpu",
                             base=hybrid["base"], lora=loras[name])
        out[name] = (ref, port)
    return out


@pytest.mark.parametrize("case", list(OTHER))
def test_kd_and_dp_ledger_and_flops_equal(other_runs, case):
    ref, port = other_runs[case]
    assert port.ledger.by_name() == ref.ledger.by_name() == OTHER[case][2]
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
        assert hp.epsilon == hr.epsilon


@pytest.mark.parametrize("case", list(OTHER))
def test_kd_and_dp_rounds_and_final_lora_close(other_runs, case):
    ref, port = other_runs[case]
    assert len(port.history) == len(ref.history) == 2
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    got = bridge.lora_to_reference(port.final_lora, _cfgs()[1])
    want = jax.tree.map(np.asarray, ref.final_lora)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)


def test_split_step_on_the_hybrid_matches_reference():
    """Split-FedLLM runs on this 5-layer hybrid (one pattern group and the
    two-layer tail, so split_layer 1 leaves the client no layer: L = 0,
    the client only embeds and the server holds every layer, the final
    RMSNorm and the tied head), as the reference's does: the reference's
    own split_train_step runs, and one port split step from the same
    weights and batch gives its boundary, c4 gradient, LoRA gradient and
    loss (tests/test_torch_split_family.py; the runs against the
    reference: tests/test_torch_split_hybrid*.py)."""
    import test_torch_split_family as fam
    sfns = fam.assert_split_step_matches("hybrid", 5, 1, 6)
    assert sfns["n_client_groups"] == 0 and sfns["n_groups"] == 1
    assert sfns["n_client_layers"] == 0
