"""The port's RWKV-6 (Finch) against the reference's, on the CPU: the WKV
recurrence's plain twins (the versions the CUDA kernels are held to on
the card) against the Pallas ``rwkv6_scan`` in interpret mode, against
the reference's scan oracles and against ``jax.vjp`` of
``rwkv6_scan_ref``; the autograd Function's wiring; the time-mix,
channel-mix, block and whole-model forward; the bridge; and FedLLM end
to end at ``rwkv6_1_6b().reduced(n_layers=2, d_model=128)`` (2 heads of
64, d_ff 384, V 512) with LoRA on w_r/w_k/w_v/w_g, and KD-FedLLM (top-8
int8) and DP-FedLLM (clip 0.5, secure aggregation) there too.

Inputs come from a numpy seed or the reference's own init (bridged).
Tolerances: the forward twin against the Pallas kernel atol/rtol 2e-4
(the reference's own bar for its kernel, tests/test_kernels.py), against
the step oracles atol 1e-5 / rtol 1e-4 (the same recurrence in fp32, sums
over D in another order); the backward twin against ``jax.vjp`` atol
1e-4 / rtol 1e-4 (fp32 sums of up to S·D terms); the autograd Function
gives the twins' bits; the time-mix, block and logits atol 1e-5 to 1e-4 /
rtol 1e-4 (fp32; the chunked form at S = 32 against the exact
recurrence); elementwise pieces atol 1e-6; FedLLM at the North-star bar
(ledger bytes and FLOPs exact, round loss and accuracy within 1e-3,
final LoRA atol 5e-5 / rtol 5e-4; DP's final LoRA from the port's fp64
run instead: within 3x the reference's distance from it, + 1e-6, and
within relative L2 1e-5 of the reference's)."""
import dataclasses
import re
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.configs.rwkv6_1_6b import config as ref_rwkv  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.rwkv6_1_6b import rwkv6_1_6b  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402
from repro_torch.models import common, rwkv6, transformer  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

PALLAS = dict(atol=2e-4, rtol=2e-4)
SCAN = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=1e-4, rtol=1e-4)
LAYER = dict(atol=1e-5, rtol=1e-4)
RANK, ALPHA = 4, 32.0
TARGETS = lora_lib.RWKV_TARGETS
FED = dict(framework="fedllm", rounds=2, lora_rank=RANK, lora_dropout=0.0,
           seed=0, lora_targets=TARGETS)


def _cfgs():
    """(reference, port) configs of the reduced RWKV-6."""
    ref_cfg = dataclasses.replace(
        ref_rwkv().reduced(n_layers=2, d_model=128), kernel_policy="xla")
    return ref_cfg, rwkv6_1_6b().reduced(n_layers=2, d_model=128)


def _wkv_inputs(seed, BH, S, D, U=None, min_logw=None):
    """r, k, v ~ N(0, 1), logw = -softplus(N(0, 1)) as the reference's
    kernel test draws them (or uniform in [min_logw, 0]), u ~ N(0, 0.01)
    of U rows (BH by default)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32)
               for _ in range(3))
    if min_logw is None:
        logw = -np.logaddexp(0.0, rng.standard_normal((BH, S, D)))
    else:
        logw = rng.uniform(min_logw, 0.0, (BH, S, D))
    u = rng.standard_normal((U or BH, D)) * 0.1
    return r, k, v, logw.astype(np.float32), u.astype(np.float32)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


# --------------------------------------------------------------------------- #
# The WKV twins (row 16)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("BH,S,D,bt", [(4, 32, 16, 16), (2, 64, 32, 32),
                                       (8, 16, 64, 16)])
def test_rwkv6_scan_twin_matches_pallas(BH, S, D, bt):
    """The forward twin against the Pallas kernel in interpret mode at the
    reference's sweep; the autograd Function on CPU tensors gives the
    twin's bits."""
    inputs = _wkv_inputs(BH + S + D, BH, S, D)
    want_y, want_sf = pallas_rwkv6(*map(jnp.asarray, inputs), bt=bt)
    got_y, got_sf = ref.rwkv6_scan(*_t(*inputs))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **PALLAS)
    np.testing.assert_allclose(got_sf.numpy(), np.asarray(want_sf), **PALLAS)
    fn_y, fn_sf = rw.rwkv6_scan(*_t(*inputs))
    assert torch.equal(fn_y, got_y) and torch.equal(fn_sf, got_sf)


def test_rwkv6_scan_twin_ragged_and_head_layout():
    """A ragged S (37) against ``rwkv6_scan_ref``, and ops.rwkv6's (B, S,
    H, D) layout with a (H, D) bonus against the model's oracle
    ``wkv_ref``."""
    inputs = _wkv_inputs(3, 6, 37, 32)
    want = jax_ref.rwkv6_scan_ref(*map(jnp.asarray, inputs))
    got = ref.rwkv6_scan(*_t(*inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCAN)

    B, S, H, D = 2, 37, 3, 16
    r, k, v, logw, _ = _wkv_inputs(4, B * H, S, D)
    shp = (B, S, H, D)
    r, k, v, logw = (x.reshape(shp) for x in (r, k, v, logw))
    u = (np.random.default_rng(5).standard_normal((H, D)) * 0.1
         ).astype(np.float32)
    want_y, want_sf = ref_rwkv6.wkv_ref(*map(jnp.asarray, (r, k, v, logw,
                                                           u)))
    with ops.policy_scope("torch"):
        got_y, got_sf = ops.rwkv6(*_t(r, k, v, logw, u))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SCAN)
    np.testing.assert_allclose(got_sf.numpy(), np.asarray(want_sf), **SCAN)


@pytest.mark.parametrize("with_dsf", [False, True])
def test_rwkv6_scan_bwd_matches_jax_vjp(with_dsf):
    """dr, dk, dv, dlogw and du of the backward twin against ``jax.vjp``
    of ``rwkv6_scan_ref``, with decays down to the model's floor -e³ (w
    about 2e-9) and random dy and dS_final; every gradient finite."""
    BH, S, D = 4, 37, 16
    inputs = _wkv_inputs(6, BH, S, D, min_logw=-np.exp(3.0))
    rng = np.random.default_rng(7)
    dy = rng.standard_normal((BH, S, D)).astype(np.float32)
    dsf = rng.standard_normal((BH, D, D)).astype(np.float32) if with_dsf \
        else np.zeros((BH, D, D), np.float32)
    _, vjp = jax.vjp(jax_ref.rwkv6_scan_ref, *map(jnp.asarray, inputs))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dsf)))]
    got = ref.rwkv6_scan_bwd(*_t(*inputs), torch.tensor(dy),
                             torch.tensor(dsf) if with_dsf else None,
                             need_dlogw=True, need_du=True)
    for g, w, name in zip(got, want, ("dr", "dk", "dv", "dlogw", "du")):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), w, **GRAD, err_msg=name)


def test_rwkv6_function_matches_autograd_and_skips(monkeypatch):
    """On CPU tensors the autograd Function's gradients are the backward
    twin's and agree with autograd through the forward twin; it asks for
    dlogw and du only where logw and u need a gradient; a bonus shared
    over the batch (U = H) gets the sum over its rows."""
    BH, S, D, H = 6, 21, 16, 3
    inputs = _wkv_inputs(8, BH, S, D, U=H)
    rng = np.random.default_rng(9)
    dy = torch.tensor(rng.standard_normal((BH, S, D)).astype(np.float32))
    dsf = torch.tensor(rng.standard_normal((BH, D, D)).astype(np.float32))

    def grads(fn, needs):
        leaves = [x.clone().requires_grad_(n)
                  for x, n in zip(_t(*inputs), needs)]
        y, sf = fn(*leaves)
        return torch.autograd.grad((y * dy).sum() + (sf * dsf).sum(),
                                   [x for x in leaves if x.requires_grad])

    twin = ref.rwkv6_scan_bwd(*_t(*inputs), dy, dsf, True, True)
    for g, want in zip(grads(rw.rwkv6_scan, [True] * 5), twin):
        assert torch.equal(g, want)
    for g, want in zip(grads(ref.rwkv6_scan, [True] * 5), twin):
        torch.testing.assert_close(g, want, **GRAD)

    asked = []
    bwd = ref.rwkv6_scan_bwd

    def recording(*args):
        asked.append(args[-2:])
        return bwd(*args)

    monkeypatch.setattr(ref, "rwkv6_scan_bwd", recording)
    got = grads(rw.rwkv6_scan, [True, True, True, False, False])
    assert asked == [(False, False)] and len(got) == 3
    for g, want in zip(got, twin[:3]):
        assert torch.equal(g, want)
    with torch.no_grad():
        y, _ = rw.rwkv6_scan(*_t(*inputs))
    assert y.grad_fn is None


def test_rwkv6_cuda_policy_refuses_cpu_tensors():
    r, k, v, logw, u = _t(*_wkv_inputs(10, 4, 5, 16, U=2))
    shp = (2, 5, 2, 16)
    with ops.policy_scope("cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.rwkv6(*(x.reshape(shp) for x in (r, k, v, logw)), u)
    with pytest.raises(ValueError, match="CUDA"):
        rw.rwkv6_fwd(r, k, v, logw, u)
    with pytest.raises(ValueError, match="CUDA"):
        rw.rwkv6_bwd(r, k, v, logw, u, torch.zeros(4, 1, 16, 16), r)
    with pytest.raises(ValueError, match="head dim"):
        rw.rwkv6_fwd(*_t(*_wkv_inputs(11, 2, 3, 24)))
    with ops.policy_scope("torch"):                # the plain path runs
        y, _ = ops.rwkv6(*(x.reshape(shp) for x in (r, k, v, logw)), u)
    assert y.shape == shp


def _bwd_closed_form(r, k, v, logw, u, dy, dsf, bt):
    """The WKV backward as rwkv6_bwd_kernel forms it (csrc/rwkv6_scan.cu's
    head): each chunk of bt steps in closed form from its checkpoint P0
    and H (dL/dS after its last step), with T(a, b) = prod_{a<l<b} w_l."""
    BH, S, D = r.shape
    ub = u.repeat(BH // u.shape[0], 1)
    w = torch.exp(logw)
    st, ck = torch.zeros(BH, D, D, dtype=r.dtype), []
    for t in range(S):
        if t % bt == 0:
            ck.append(st)
        st = w[:, t, :, None] * st + k[:, t, :, None] * v[:, t, None, :]
    H = torch.zeros_like(st) if dsf is None else dsf
    dr, dk, dv, dlw = (torch.zeros_like(r) for _ in range(4))
    for ci in range(len(ck) - 1, -1, -1):
        t0, P0 = ci * bt, ck[ci]
        R, K, V, W, DY = (x[:, t0:t0 + bt] for x in (r, k, v, w, dy))
        n = R.shape[1]

        def T(a, b):
            out = torch.ones(BH, D, dtype=r.dtype)
            for i in range(a + 1, b):
                out = out * W[:, i]
            return out

        y1 = torch.einsum("xde,xje->xdj", P0, DY)
        y2 = torch.einsum("xde,xje->xdj", H, V)
        z = (H * P0).sum(-1)
        gv = torch.einsum("xae,xbe->xab", V, DY)        # v_a · dy_b
        for j in range(n):
            A, C = T(-1, j), T(j, n)
            a1, a2, a3 = A * y1[..., j], C * y2[..., j], C * A * z
            for i in range(j):
                a1 = a1 + T(i, j) * K[:, i] * gv[:, i, j, None]
                a3 = a3 + C * T(i, j) * K[:, i] * y2[..., i]
            for i in range(j + 1, n):
                a2 = a2 + T(j, i) * R[:, i] * gv[:, j, i, None]
                a3 = a3 + A * T(j, i) * R[:, i] * y1[..., i]
                for i2 in range(j):
                    a3 = a3 + (T(j, i) * T(i2, j) * R[:, i] * K[:, i2]
                               * gv[:, i2, i, None])
            c = gv[:, j, j, None]
            dr[:, t0 + j] = a1 + ub * K[:, j] * c
            dk[:, t0 + j] = a2 + R[:, j] * ub * c
            dlw[:, t0 + j] = W[:, j] * a3
            y3 = torch.einsum("xd,xde->xe", C * K[:, j], H)
            for i in range(j + 1, n):
                krk = (T(j, i) * R[:, i] * K[:, j]).sum(-1, keepdim=True)
                y3 = y3 + krk * DY[:, i]
            ruk = (R[:, j] * ub * K[:, j]).sum(-1, keepdim=True)
            dv[:, t0 + j] = y3 + ruk * DY[:, j]
        H = T(-1, n)[..., None] * H + sum(
            (T(-1, i) * R[:, i])[..., None] * DY[:, i, None, :]
            for i in range(n))
    return dr, dk, dv, dlw


@pytest.mark.parametrize("BH,S,D,dsf", [(6, 21, 16, True), (4, 8, 32, False),
                                        (3, 1, 16, True)])
def test_wkv_backward_closed_form_is_the_step_recurrence(BH, S, D, dsf):
    """The chunked closed form the CUDA backward computes (its math, in
    fp64 on the CPU) equals the step-by-step twin's gradient to fp64
    rounding, with and without dS_final, at a ragged last chunk and at
    one step, log-decays from -0.05 down to -e."""
    rng = np.random.default_rng(BH * 100 + S)
    f64 = torch.float64
    r, k, v, dy = (torch.tensor(rng.standard_normal((BH, S, D)), dtype=f64)
                   for _ in range(4))
    logw = -torch.exp(torch.tensor(rng.uniform(-3.0, 1.0, (BH, S, D)),
                                   dtype=f64))
    u = torch.tensor(rng.standard_normal((2 if BH % 2 == 0 else 1, D)) * 0.1,
                     dtype=f64)
    ds = torch.tensor(rng.standard_normal((BH, D, D)), dtype=f64) \
        if dsf else None
    want = ref.rwkv6_scan_bwd(r, k, v, logw, u, dy, ds, True, False)[:4]
    got = _bwd_closed_form(r, k, v, logw, u, dy, ds, rw.BT)
    for name, g, w_ in zip(("dr", "dk", "dv", "dlogw"), got, want):
        torch.testing.assert_close(g, w_, rtol=1e-10, atol=1e-10,
                                   msg=name)


@pytest.mark.parametrize("BH,S,D", [(512, 80, 64), (12, 37, 16), (3, 1, 32)])
def test_checkpoint_interval_is_the_cuda_sources(BH, S, D):
    """The wrapper's checkpoint interval is the BT that csrc/rwkv6_scan.cu
    compiles with (the forward writes a state every BT steps, the backward
    walks chunks of BT), and the checkpoints the wrapper allocates and
    checks hold the state before every BT-th step."""
    src = (Path(rw.__file__).parent / "csrc" / "rwkv6_scan.cu").read_text()
    found = re.findall(r"^constexpr int BT = (\d+);", src, re.M)
    assert found == [str(rw.BT)]
    assert rw.checkpoint_shape(BH, S, D) == (BH, len(range(0, S, rw.BT)),
                                             D, D)


# --------------------------------------------------------------------------- #
# Layers and the whole model
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def model_case():
    """Reference params with a non-zero bonus, a LoRA tree on the
    time-mix projections with non-zero B, both sides."""
    ref_cfg, cfg = _cfgs()
    ref_model = ref_build(ref_cfg)
    params = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(12)
    attn = params["blocks"][0]["attn"]
    attn["bonus_u"] = (rng.standard_normal(attn["bonus_u"].shape) * 0.3
                       ).astype(np.float32)
    lt = jax.tree.map(np.asarray, ref_lora.init_lora(
        jax.random.PRNGKey(1), params, TARGETS, RANK, ALPHA))
    for leaf in lt["blocks"][0]["attn"].values():
        leaf["b"] = (rng.standard_normal(leaf["b"].shape) * 0.05
                     ).astype(np.float32)
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_model=ref_model, params=params,
                lora=lt, base=bridge.params_from_reference(params, "cpu"),
                port_lora=bridge.lora_from_reference(lt, "cpu", cfg),
                model=build_model(cfg))


def _layer(params, i):
    return jax.tree.map(lambda x: x[i], params["blocks"][0])


def _torch_tree(tree):
    return jax.tree.map(torch.tensor, tree)


@pytest.mark.parametrize("S", [24, 32])
def test_timemix_channelmix_block_match_reference(model_case, S):
    """Layer 1's pieces from the reference's init with a non-zero bonus:
    at S = 24 the reference's time-mix runs its step scan, at S = 32 its
    chunked form, whose clamps (±80) never bind here: every chunk's
    cumulative log-decay stays above -80."""
    h = model_case
    ref_cfg, cfg = h["ref_cfg"], h["cfg"]
    p = _layer(h["params"], 1)
    tp = _torch_tree(p)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)) \
        .astype(np.float32)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    xw = ref_rwkv6._lerp(xj, ref_rwkv6._shift(xj), p["attn"]["mu_w"])
    want_lw = ref_rwkv6._decay(p["attn"], xw)
    got_lw = rwkv6._decay(tp["attn"], torch.tensor(np.asarray(xw)))
    np.testing.assert_allclose(got_lw.numpy(), np.asarray(want_lw),
                               atol=1e-6, rtol=1e-5)
    if S % ref_rwkv6.CHUNK == 0:
        chunks = np.asarray(want_lw).reshape(2, S // 16, 16, -1)
        assert chunks.cumsum(axis=2).min() > -80.0
    want, (want_sf, _) = ref_rwkv6.timemix_fwd(p["attn"], ref_cfg, xj)
    got, got_sf = rwkv6.timemix_fwd(tp["attn"], cfg, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    np.testing.assert_allclose(got_sf.numpy(), np.asarray(want_sf), **LAYER)
    want_cm, _ = ref_rwkv6.channelmix_fwd(p["attn"], ref_cfg, xj)
    np.testing.assert_allclose(
        rwkv6.channelmix_fwd(tp["attn"], cfg, xt).numpy(),
        np.asarray(want_cm), **LAYER)
    want_b, _ = ref_transformer.block_fwd(p, ref_cfg, "rwkv6", xj, None)
    got_b, aux = transformer.block_fwd(tp, cfg, "rwkv6", xt, None)
    assert aux is None
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **LAYER)


def test_relu2_and_layernorm_match_reference():
    x = (np.random.default_rng(13).standard_normal((3, 7, 64)) * 2
         ).astype(np.float32)
    np.testing.assert_array_equal(common.relu2(torch.tensor(x)).numpy(),
                                  np.asarray(ref_common.relu2(jnp.asarray(x))))
    p = {"scale": np.linspace(0.5, 1.5, 64, dtype=np.float32),
         "bias": np.linspace(-1, 1, 64, dtype=np.float32)}
    np.testing.assert_allclose(
        common.layernorm(_torch_tree(p), torch.tensor(x)).numpy(),
        np.asarray(ref_common.layernorm(p, jnp.asarray(x))), atol=1e-6,
        rtol=1e-6)


def test_config_and_bridge_match_reference(model_case):
    """The port's config is the reference's field for field (head_dim 0
    when reduced); the bridged tree has the reference's layers (no mlp,
    no pos_embed, an untied head); the LoRA tree comes back exactly;
    the port's own LoRA init targets the same leaves."""
    h = model_case
    ref_full, full = ref_rwkv(), rwkv6_1_6b()
    for f in dataclasses.fields(full):
        if f.name != "kernel_policy":
            assert getattr(full, f.name) == getattr(ref_full, f.name), f.name
            assert getattr(h["cfg"], f.name) == getattr(h["ref_cfg"],
                                                        f.name), f.name
    assert h["cfg"].head_dim == 0 and full.attention_free
    assert full.param_count() == ref_full.param_count() == 1_482_981_376
    assert full.active_param_count() == ref_full.active_param_count()
    base = h["base"]
    assert sorted(base) == ["embed", "final_norm", "layers", "lm_head"]
    for i, layer in enumerate(base["layers"]):
        assert sorted(layer) == ["attn", "norm1", "norm2"]
        for name, leaf in layer["attn"].items():
            if isinstance(leaf, dict):
                continue
            np.testing.assert_array_equal(
                leaf.numpy(), h["params"]["blocks"][0]["attn"][name][i])
    n_ref = sum(x.size for x in jax.tree.leaves(h["params"]))
    own = build_model(h["cfg"]).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    n_port, n_own = (sum(t.numel() for t in tree_lib.leaves(tree))
                     for tree in (base, own))
    assert n_ref == n_port == n_own
    back = bridge.lora_to_reference(h["port_lora"], h["cfg"])
    assert jax.tree.structure(back) == jax.tree.structure(h["lora"])
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(h["lora"])):
        np.testing.assert_array_equal(got, want)
    mine = lora_lib.init_lora(torch.Generator().manual_seed(0), own, TARGETS,
                              RANK)
    assert [sorted(x["attn"]) for x in mine["layers"]] == \
        [sorted(TARGETS)] * 2
    assert lora_lib.n_bytes(mine) == ref_lora.n_bytes(h["lora"])


@pytest.mark.parametrize("S", [24, 32])
def test_rwkv6_logits_match_reference(model_case, S):
    """The whole forward with LoRA bound, at the step scan's S and the
    chunked form's."""
    h = model_case
    tokens = np.random.default_rng(14 + S).integers(
        1, h["cfg"].vocab_size, (2, S)).astype(np.int32)
    ref_params = ref_lora.bind(h["params"], h["lora"], ALPHA, RANK)
    port_params = lora_lib.bind(h["base"], h["port_lora"], ALPHA, RANK)
    want, _ = h["ref_model"].forward(ref_params,
                                     {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = h["model"].forward(
            port_params, {"tokens": torch.as_tensor(tokens).long()})
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# --------------------------------------------------------------------------- #
# FedLLM end to end
# --------------------------------------------------------------------------- #
def _fed_inputs(model_case):
    """The FedLLM runs' inputs: the reference's initial weights from
    FED's seed, paper_splits(scale=0.04, pad_len=24) and 3 IID clients."""
    cfg = model_case["cfg"]
    params = jax.tree.map(np.asarray, model_case["ref_model"].init(
        jax.random.PRNGKey(FED["seed"])))
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    return params, pub, partition.iid_partition(train, 3), test


@pytest.fixture(scope="module")
def fed_runs(model_case):
    """The reference's and the port's FedLLM runs from the same weights:
    paper_splits(scale=0.04, pad_len=24), 3 IID clients, 2 rounds, rank 4,
    dropout 0, batch 16, eval batch 64, LoRA on w_r/w_k/w_v/w_g."""
    ref_cfg, cfg = model_case["ref_cfg"], model_case["cfg"]
    params, pub, clients, test = _fed_inputs(model_case)
    lt = jax.tree.map(np.asarray, ref_lora.init_lora(
        jax.random.PRNGKey(FED["seed"] + 1), params, TARGETS, RANK, ALPHA))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = ref_run(dataclasses.replace(ref_cfg, kernel_policy="auto"),
                      RefFedConfig(**FED), pub, clients, test, batch_size=16,
                      eval_batch=64)
    port = run_federated(cfg, FedConfig(**FED), pub, clients, test,
                         batch_size=16, eval_batch=64, device="cpu",
                         base=bridge.params_from_reference(params, "cpu"),
                         lora=bridge.lora_from_reference(lt, "cpu", cfg))
    return ref, port


def test_fedllm_ledger_and_flops_equal(fed_runs):
    ref, port = fed_runs
    assert port.ledger.by_name() == ref.ledger.by_name() == \
        {"lora_params": 393216}
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
    assert port.history[0].loss != port.history[1].loss
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
                {"lora_params": 393216, "secagg_keys": 1344, "dp_meta": 72})}


def _fp64(tree):
    return tree_lib.map_(
        lambda t: t.double() if t.is_floating_point() else t, tree)


@pytest.fixture(scope="module")
def other_runs(model_case):
    """{case: (reference result, port result)}: KD with top-8 int8 logits
    and DP (clip 0.5, noise 0, secure aggregation) on the reduced RWKV-6,
    fed_runs' weights, data, rounds, rank, dropout and targets, from the
    reference's initial LoRA bridged (KD: one tree per client and one for
    the server, from the reference's keys; DP: FedLLM's, seed + 1); and
    under "dp64" the port's DP run from fp64 copies of the same weights
    (fp64 end to end: runtime.compute_dtype), the yardstick of DP's final
    LoRA."""
    ref_cfg, cfg = model_case["ref_cfg"], model_case["cfg"]
    params, pub, clients, test = _fed_inputs(model_case)
    base = bridge.params_from_reference(params, "cpu")

    def draw(key):
        lt = ref_lora.init_lora(key, params, TARGETS, RANK, ALPHA)
        return bridge.lora_from_reference(jax.tree.map(np.asarray, lt),
                                          "cpu", cfg)

    kd_key = jax.random.PRNGKey(FED["seed"] + 2)
    loras = {"kd": {"clients": [draw(jax.random.fold_in(kd_key, ci))
                                for ci in range(len(clients))],
                    "server": draw(jax.random.fold_in(kd_key, 999))},
             "dp": draw(jax.random.PRNGKey(FED["seed"] + 1))}
    out, feds = {}, {}
    for name, (fed_kw, priv, _) in OTHER.items():
        common_kw = {**FED, **fed_kw}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref = ref_run(dataclasses.replace(ref_cfg, kernel_policy="auto"),
                          RefFedConfig(**common_kw,
                                       privacy=RefPrivacy(**priv)),
                          pub, clients, test, batch_size=16, eval_batch=64)
        feds[name] = FedConfig(**common_kw, privacy=PrivacyConfig(**priv))
        port = run_federated(cfg, feds[name], pub, clients, test,
                             batch_size=16, eval_batch=64, device="cpu",
                             base=base, lora=loras[name])
        out[name] = (ref, port)
    out["dp64"] = run_federated(cfg, feds["dp"], pub, clients, test,
                                batch_size=16, eval_batch=64, device="cpu",
                                base=_fp64(base), lora=_fp64(loras["dp"]))
    return out


def _rel_l2(got, want) -> float:
    """Relative L2 distance between two lists of arrays taken as one
    vector."""
    num = sum(float(((np.float64(g) - np.float64(w)) ** 2).sum())
              for g, w in zip(got, want))
    return (num / sum(float((np.float64(w) ** 2).sum()) for w in want)) ** 0.5


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
    """Rounds within 1e-3.  KD's final LoRA within atol 5e-5 / rtol 5e-4
    elementwise.  DP's is judged from fp64, as the card's gates judge
    full-width runs: Adam divides each update by sqrt(v), so a coordinate
    whose gradient sits at the fp32 noise floor moves by a good part of
    lr in a direction the summation order picks, and any two fp32 runs
    may part there by more than the elementwise bar.  The port's fp32 run
    must lie within 3x the reference's distance from the port's fp64 run
    (+1e-6), and within relative L2 1e-5 of the reference's fp32 run:
    the fp64 run is the port's own, so a fault that both of its runs
    carry would widen the first bar as far as it goes, while the second
    holds the port to the reference.  The elementwise bar is printed for
    DP, not held."""
    ref, port = other_runs[case]
    assert len(port.history) == len(ref.history) == 2
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    cfg = _cfgs()[1]
    got = bridge.lora_to_reference(port.final_lora, cfg)
    want = jax.tree.map(np.asarray, ref.final_lora)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    if case == "kd":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)
        return
    exact = jax.tree.leaves(bridge.lora_to_reference(
        other_runs["dp64"].final_lora, cfg))
    assert all(x.dtype == np.float64 for x in exact)
    port_gap, ref_gap = _rel_l2(got, exact), _rel_l2(want, exact)
    apart = _rel_l2(got, want)
    outside = sum(int((~np.isclose(g, w, atol=5e-5, rtol=5e-4)).sum())
                  for g, w in zip(got, want))
    print(f"DP final LoRA, relative L2 from the port's fp64 run: port "
          f"{port_gap:.3e}, reference {ref_gap:.3e}; port from the "
          f"reference {apart:.3e}, outside atol 5e-5 / rtol 5e-4: "
          f"{outside} of {sum(g.size for g in got)} elements")
    assert port_gap <= 3.0 * ref_gap + 1e-6
    assert apart <= 1e-5


def test_split_step_on_rwkv_matches_reference():
    """Split-FedLLM runs on this 2-layer RWKV-6 (split_layer 1: the client
    holds layer 0, the server layer 1, the final LayerNorm and the untied
    head), as the reference's does: the reference's own split_train_step
    runs, and one port split step from the same weights and batch gives
    its boundary, c4 gradient, LoRA gradient of both halves and loss
    (tests/test_torch_split_family.py; the runs against the reference:
    tests/test_torch_split_rwkv*.py).  At S 24 the reference's WKV takes
    its step scan, so no exponent clamp binds."""
    import test_torch_split_family as fam
    assert 24 % ref_rwkv6.CHUNK != 0
    sfns = fam.assert_split_step_matches("rwkv", 2, 1, 8)
    assert sfns["n_client_groups"] == sfns["n_client_layers"] == 1
