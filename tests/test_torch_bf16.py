"""The port's plain path in bf16, the launch builders' default dtype,
against the reference's bf16 steps on the CPU.

``launch/steps.build_step`` builds its parameters in bf16 by default, as
the reference does.  The plain versions must then compute where the
reference computes in fp32 (RoPE, the norms, the LoRA and attention
oracles, the RG-LRU gates, the RWKV-6 decay and recurrence) and return
the input's dtype.  Each family's default-dtype train, prefill and
decode steps run at ``reduced(1)`` size (one layer; RecurrentGemma keeps
its three-layer pattern) on bridged weights cast to bf16 (the train
step without remat), beside the reference's jitted steps on the same
bf16 arrays (layers unrolled: they compile faster).  The weights are the
port's seeded init, bridged to the reference's tree (whose structure,
shapes and dtypes ``jax.eval_shape`` of its own init must give); the
LoRA factors and the Adam state are drawn with numpy into the
reference's LoRA and Adam trees (an eager jax init costs seconds a
family).  Prefill and decode logits, the train step's loss and its
first-step gradient (Adam's m) are held to the reference's within a
relative L2 of 2e-2, or 3x the reference's own distance between its
bf16 and fp32 steps where that is larger.  The fp32 results of RoPE and
of the LoRA and attention twins stay the bits of their fp32 formulas."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.optim import adam as ref_adam  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402

ARCHS = ("qwen3-1.7b", "gpt2", "recurrentgemma-2b", "rwkv6-1.6b",
         "mixtral-8x7b", "whisper-base")
B, L, RANK = 2, 8, 8
BAR = 2e-2
MESH = mesh_mod.MeshSpec((1, 1), ("data", "model"))


def _ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree.leaves(tree)])


def _check(what, got, ref16, ref32):
    """got within BAR of ref16, or 3x ref16's distance from ref32 (a
    callable: the fp32 reference runs only when the bar is missed)."""
    err = _rel(got, ref16)
    bar = BAR if err <= BAR else max(BAR, 3 * _rel(ref16, ref32()))
    assert err <= bar, f"{what}: {err:.3e} from the reference, bar {bar:.3e}"


def _bf16(x):
    """A numpy leaf cast on the host (an eager jax cast compiles a
    program for each shape)."""
    return x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) \
        else x


def _jit(fn):
    """``fn`` jitted, each call's program compiled at XLA's lowest backend
    optimization level (the same HLO; LLVM's passes skipped, about a third
    of the compile time at these sizes)."""
    return lambda *args: jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    ref_cfg = dataclasses.replace(ref_registry.get_config(arch).reduced(1),
                                  kernel_policy="xla")
    cfg = registry.get_config(arch).reduced(1)
    p32 = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    rp32 = bridge.params_to_reference(p32, cfg)
    want = jax.eval_shape(ref_build(ref_cfg).init, jax.random.PRNGKey(0))
    assert jax.tree.structure(rp32) == jax.tree.structure(want)
    assert [(x.shape, x.dtype) for x in jax.tree.leaves(rp32)] == \
        [(x.shape, x.dtype) for x in jax.tree.leaves(want)]
    rp16 = jax.tree.map(_bf16, rp32)
    p16 = tree_lib.map_(lambda t: t.to(torch.bfloat16)
                        if t.is_floating_point() else t,
                        bridge.params_from_reference(rp32, "cpu"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (B, L)).astype(np.int32)
    rb = {"tokens": tokens}
    pb = {"tokens": torch.from_numpy(tokens)}
    if cfg.is_encoder_decoder:
        e = rng.normal(0, 1, (B, cfg.encoder_seq_len, cfg.d_model))
        rb["enc_embeds"] = e.astype(jnp.bfloat16)
        pb["enc_embeds"] = torch.from_numpy(e.astype(np.float32)).to(
            torch.bfloat16)
    rb32 = dict(rb, **({"enc_embeds": rb["enc_embeds"].astype(np.float32)}
                       if cfg.is_encoder_decoder else {}))
    return arch, ref_cfg, cfg, rp32, rp16, p16, rb, rb32, pb, rng


def test_default_dtype_is_bf16():
    _, args, _ = steps.build_step(registry.get_config("qwen3-1.7b").reduced(),
                                  ShapeConfig("prefill_32k", L, B, "prefill"),
                                  MESH)
    assert {t.dtype for t in tree_lib.leaves(args[0])
            if t.is_floating_point()} == {torch.bfloat16}


def test_prefill(family):
    arch, ref_cfg, cfg, rp32, rp16, p16, rb, rb32, pb, _ = family
    shape = ShapeConfig("prefill_32k", L, B, "prefill")
    fn = _jit(ref_steps.build_prefill_step(ref_cfg, shape, _ref_mesh(),
                                                 scan_layers=False)[0])
    got = steps.build_prefill_step(cfg, shape, MESH)[0](p16, pb)
    assert got.dtype == torch.bfloat16 and got.shape == (B, cfg.vocab_size)
    _check(f"{arch} prefill logits", got.float().numpy(),
           np.asarray(fn(rp16, rb), np.float32),
           lambda: np.asarray(fn(rp32, rb32)))


def test_train(family):
    arch, ref_cfg, cfg, rp32, rp16, p16, rb, rb32, pb, rng = family
    shape = ShapeConfig("train_4k", L, B, "train")
    # the reference's LoRA tree: A ~ N(0, 1/r) as its init draws, B ~
    # N(0, 0.02) (not its zeros, so that both factors get a gradient)
    shapes = jax.eval_shape(lambda p: ref_lora.init_lora(
        jax.random.PRNGKey(1), p, ref_lora.default_targets(ref_cfg), RANK),
        rp32)
    lt = jax.tree_util.tree_map_with_path(
        lambda path, s: rng.normal(0, RANK ** -0.5 if path[-1].key == "a"
                                   else 0.02, s.shape).astype(np.float32),
        shapes)
    opt = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                       jax.eval_shape(ref_adam.init, lt))
    fn = _jit(ref_steps.build_train_step(
        ref_cfg, shape, _ref_mesh(), remat="none", scan_layers=False,
        lora_rank=RANK)[0])
    r16 = fn(rp16, lt, opt, rb)
    _, new_opt, loss = steps.build_train_step(cfg, shape, MESH,
                                              remat="none")[0](
        p16, bridge.lora_from_reference(lt, "cpu", cfg),
        bridge.opt_state_from_reference(opt, "cpu", cfg), pb)
    r32 = {}

    def ref32():
        if not r32:
            r32["out"] = fn(rp32, lt, opt, rb32)
        return r32["out"]

    _check(f"{arch} train loss", [float(loss)], [float(r16[2])],
           lambda: [float(ref32()[2])])
    _check(f"{arch} first-step gradient (Adam's m)",
           _flat(bridge.lora_to_reference(new_opt["m"], cfg)),
           _flat(r16[1]["m"]), lambda: _flat(ref32()[1]["m"]))


def test_decode(family):
    arch, ref_cfg, cfg, rp32, rp16, p16, rb, rb32, pb, _ = family
    shape = ShapeConfig("decode_32k", L, B, "decode")
    fn = _jit(ref_steps.build_decode_step(ref_cfg, shape, _ref_mesh(),
                                                scan_layers=False)[0])
    enc = cfg.is_encoder_decoder
    cache16 = ref_build(ref_cfg).init_cache(
        rp16, B, L, {"enc_embeds": rb["enc_embeds"]} if enc else None,
        dtype=jnp.bfloat16)
    cache = build_model(cfg).init_cache(
        p16, B, L, {"enc_embeds": pb["enc_embeds"]} if enc else None)
    pos, tok = 3, rb["tokens"][:, 3]
    got, _ = steps.build_decode_step(cfg, shape, MESH)[0](
        p16, cache, torch.from_numpy(tok), pos)
    assert got.dtype == torch.bfloat16

    def ref32():
        c32 = ref_build(ref_cfg).init_cache(
            rp32, B, L, {"enc_embeds": rb32["enc_embeds"]} if enc else None,
            dtype=jnp.float32)
        return np.asarray(fn(rp32, c32, tok, jnp.int32(pos))[0])

    _check(f"{arch} decode logits", got.float().numpy(),
           np.asarray(fn(rp16, cache16, tok, jnp.int32(pos))[0], np.float32),
           ref32)


def test_fp32_results_keep_their_bits():
    """The casts leave fp32 alone: RoPE, the LoRA twins and the attention
    twins give the bits of their fp32 formulas (the expressions they had
    before bf16 inputs were taken)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    x, pos = r(2, 5, 3, 8), torch.arange(5)
    freqs = common.rope_freqs(8, 1e4)
    ang = (pos[..., None].float() * freqs)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    want = torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x2 * torch.cos(ang) + x1 * torch.sin(ang)], dim=-1)
    assert torch.equal(common.apply_rope(x, pos, 1e4), want)

    xm, w, a, b, gm = r(6, 16), r(16, 12), r(16, 4), r(4, 12), r(6, 12)
    assert torch.equal(ref.lora_matmul_ref(xm, w, a, b), xm @ w + (xm @ a) @ b)
    y, xa = ref.lora_fwd(xm, w, a, b)
    assert torch.equal(xa, xm @ a) and torch.equal(y, xm @ w + (xm @ a) @ b)
    dx, gb = ref.lora_dx(gm, w, a, b)
    assert torch.equal(gb, gm @ b.t())
    assert torch.equal(dx, gm @ w.t() + (gm @ b.t()) @ a.t())
    assert torch.equal(ref.lora_dw(xm, gm), xm.t() @ gm)
    assert torch.equal(ref.panel_grad(gm, xa, True), (gm.t() @ xa).t())

    q, k, v, do = r(4, 6, 8), r(2, 6, 8), r(2, 6, 8), r(4, 6, 8)
    kr, vr = k.repeat_interleave(2, 0), v.repeat_interleave(2, 0)
    mask = torch.ones(6, 6, dtype=torch.bool).tril()
    s = ((q * 8 ** -0.5) @ kr.transpose(1, 2)).masked_fill(~mask, -1e30)
    assert torch.equal(ref.attention_ref(q, k, v), torch.softmax(s, -1) @ vr)
    o, lse = ref.attention_fwd(q, k, v)
    assert torch.equal(lse, torch.logsumexp(s, -1))
    assert torch.equal(o, torch.exp(s - lse[..., None]) @ vr)
    dd = (do * o).sum(-1)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do @ vr.transpose(1, 2) - dd[..., None])
    assert torch.equal(ref.attention_dq(q, k, v, do, lse, dd),
                       (ds @ kr) * 8 ** -0.5)
    dk, dv = ref.attention_dkv(q, k, v, do, lse, dd)
    assert torch.equal(dk, (ds.transpose(1, 2) @ q).view(2, 2, 6, 8).sum(1)
                       * 8 ** -0.5)
    assert torch.equal(dv, (p.transpose(1, 2) @ do).view(2, 2, 6, 8).sum(1))


def test_bf16_twins_compute_in_fp32():
    """bf16 operands: the twins' results are their fp32 results rounded
    once to bf16 (each input's bf16 value taken exactly)."""
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(6, 16, generator=g), torch.randn(16, 12, generator=g)
    a, b = torch.randn(16, 4, generator=g), torch.randn(4, 12, generator=g)
    xb, wb = x.bfloat16(), w.bfloat16()
    got = ref.lora_matmul_ref(xb, wb, a, b)
    want = ref.lora_matmul_ref(xb.float(), wb.float(), a, b).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    q, k = torch.randn(4, 6, 8, generator=g), torch.randn(2, 6, 8, generator=g)
    qb, kb = q.bfloat16(), k.bfloat16()
    got = ref.attention_ref(qb, kb, kb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.attention_ref(qb.float(), kb.float(),
                                              kb.float()).bfloat16())
    pos = torch.arange(6)
    got = common.apply_rope(qb.view(1, 6, 4, 8), pos, 1e4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, common.apply_rope(qb.float().view(1, 6, 4, 8),
                                              pos, 1e4).bfloat16())
