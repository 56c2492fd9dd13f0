"""The VLM image prefix (LLaVA-NeXT-34B) and the encoder-decoder
(Whisper-base) in the port against the reference's, on the CPU.

Both at ``reduced(d_model=64)``: Whisper with 2 encoder and 2 decoder
layers and 16 stub frames, LLaVA with 2 layers and 8 stub image tokens of
dim 64; the stub embeddings 0.02·N(0, 1) from a numpy seed, the text a
Banking77-style batch (``paper_splits(scale=0.04, pad_len=24)``).  Every
port computation starts from the reference's ``model.init(PRNGKey(0))``
bridged, the reference under its plain (``xla``) policy and the port
under ``torch``.

Each new module against its reference function (``encode``,
``attention_fwd_noncausal``, ``cross_attention_fwd``,
``encode_cross_kv``, ``embed_tokens`` with the image and the prefix) at
atol 1e-5 / rtol 1e-4, and ``Model.forward`` of both models likewise;
the bridge's round trip of every new tree bit for bit, and the LoRA
targets leaf by leaf.  Then one module fixture of paired reference and
port computations (``pairs``): a train step of ``make_fns`` (the LoRA
gradient and the stepped LoRA at atol 5e-5 / rtol 5e-4), the DP step's
per-example rows (the reference's ``vmap`` over the batch dict, each
example its own extras; atol 1e-5 / rtol 1e-4), the Split step of each
model's branch (the encoder-decoder's, client = encoder; the image
prefix's at split_layer 1) with an fp32 boundary (loss, boundary, c4
gradient and every LoRA gradient at atol 1e-5 / rtol 1e-5) and an int8
one (the first step's levels: at most 1e-4 of them one level apart), and
``run_federated`` on both, which attaches no stub embeddings: LLaVA runs
text-only (``img_proj`` unused) with the reference's ledger, loss and
final LoRA, Whisper fails as the reference's does, on the missing
``enc_embeds``."""
import dataclasses
import functools
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.core import compression as ref_compression  # noqa: E402
from repro.core import fedavg as ref_fedavg  # noqa: E402
from repro.core import split as ref_split  # noqa: E402
from repro.core import tasks as ref_tasks  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import compression, split, tasks  # noqa: E402
from repro_torch.core.fedavg import make_fns, to_device  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.data.loader import epoch_batches  # noqa: E402
from repro_torch.models import attention, common, encdec  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

ARCHS = ("whisper-base", "llava-next-34b")
LAYER = dict(atol=1e-5, rtol=1e-4)
STEP = dict(atol=5e-5, rtol=5e-4)
RANK, ALPHA, B = 4, 32.0, 4
TARGETS = ("wq", "wk", "wv")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _cfgs(arch):
    """(reference, port) configs of ``arch`` at ``reduced(d_model=64)``,
    the reference's under its plain policy."""
    return (dataclasses.replace(
        ref_registry.get_config(arch).reduced(d_model=64),
        kernel_policy="xla"),
        registry.get_config(arch).reduced(d_model=64))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's init as numpy arrays (drawn once; callers do not
    change them)."""
    return _np(ref_build(_cfgs(arch)[0]).init(jax.random.PRNGKey(0)))


def _lora(params, seed=1):
    """The reference's LoRA draw with B moved off zero (0.01·N(0, 1), a
    delta of the order of the base weights' at alpha/r 8), so that dA and
    dB are both non-zero."""
    lt = _np(ref_lora.init_lora(jax.random.PRNGKey(seed), params, TARGETS,
                                RANK, ALPHA))
    rng = np.random.default_rng(seed + 10)
    return jax.tree.map(lambda t: (t + 0.01 * rng.standard_normal(t.shape)
                                   ).astype(np.float32), lt)


@functools.lru_cache(maxsize=None)
def _data():
    pub, train, test = banking77.paper_splits(512, pad_len=24, scale=0.04)
    return pub, partition.iid_partition(train, 3), test


def _extras(cfg, n, seed):
    """The model's stub embeddings for ``n`` examples, 0.02·N(0, 1)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        shape, key = (n, cfg.encoder_seq_len, cfg.d_model), "enc_embeds"
    else:
        shape, key = (n, cfg.n_image_tokens, cfg.image_embed_dim), \
            "img_embeds"
    return {key: (0.02 * rng.standard_normal(shape)).astype(np.float32)}


def _batch(arch, n=B, seed=5):
    """Client 0's first batch of ``n`` with the model's extras."""
    cfg = _cfgs(arch)[1]
    batch = next(iter(epoch_batches(_data()[1][0], n, seed=0)))
    return dict(batch, **_extras(cfg, n, seed))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# Modules
# --------------------------------------------------------------------------- #
def test_sinusoidal_positions_match_reference():
    """At the reduced encoder's (16, 64) the reference's values at atol
    1e-5 / rtol 1e-4.  At Whisper-base's (1500, 512) an angle pos·inv
    carries the last bit of the fp32 ``exp`` that forms inv, which
    differs between libraries, times pos: both packages within 1500·2^-22
    of the formula evaluated in fp64."""
    np.testing.assert_allclose(
        common.sinusoidal_positions(16, 64).numpy(),
        np.asarray(ref_common.sinusoidal_positions(16, 64)), **LAYER)
    pos = np.arange(1500, dtype=np.float64)[:, None]
    inv = np.exp(-np.log(10000.0) * np.arange(256.0)[None] / (255 + 1e-9))
    exact = np.concatenate([np.sin(pos * inv), np.cos(pos * inv)], axis=-1)
    for got in (common.sinusoidal_positions(1500, 512).numpy(),
                np.asarray(ref_common.sinusoidal_positions(1500, 512))):
        assert np.abs(got - exact).max() <= 1500 * 2.0 ** -22


def test_cross_attention_init_has_no_bias_or_qk_norm():
    """A cross-attention drops the config's QKV bias and qk-norm, as the
    reference's ``init_attention(cross=True)``."""
    for arch in ("qwen2-1.5b", "qwen3-1.7b"):
        cfg = registry.get_config(arch).reduced()
        gen = torch.Generator().manual_seed(0)
        ref_cfg = ref_registry.get_config(arch).reduced()
        for cross in (False, True):
            got = attention.init_attention(gen, cfg, "cpu", cross=cross)
            want = ref_attention.init_attention(jax.random.PRNGKey(0),
                                                ref_cfg, cross=cross)
            assert sorted(got) == sorted(want)
            assert ("bq" in got or "q_norm" in got) != cross


def _layer_inputs(cfg, seed, s_enc=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, s_enc or cfg.encoder_seq_len,
                               cfg.d_model)).astype(np.float32)
    return x, enc


def test_attention_paths_match_reference():
    """Whisper's three attention paths on one decoder layer's weights:
    bidirectional self-attention, the cross K/V projection of an encoder
    output of another length, and cross-attention of 12 queries over it;
    each once with plain weights and once with LoRA-bound wq/wk/wv."""
    ref_cfg, cfg = _cfgs("whisper-base")
    params = _params("whisper-base")
    lt = _lora(params)
    layer = jax.tree.map(lambda t: t[0], params["blocks"][0])
    lora_layer = jax.tree.map(lambda t: t[0], lt["blocks"][0])
    x, enc = _layer_inputs(cfg, 3, s_enc=21)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).copy()
    @jax.jit
    def ref_paths(p):
        self_ = ref_attention.attention_fwd_noncausal(
            p["attn"], ref_cfg, jnp.asarray(x), jnp.asarray(pos))
        kv = ref_attention.encode_cross_kv(p["xattn"], ref_cfg,
                                           jnp.asarray(enc))
        return self_, kv, ref_attention.cross_attention_fwd(
            p["xattn"], ref_cfg, jnp.asarray(x), kv)

    for bound in (False, True):
        p = ref_lora.bind(layer, lora_layer, ALPHA, RANK) if bound else layer
        pt = lora_lib.bind(_torch(layer), _torch(lora_layer), ALPHA, RANK) \
            if bound else _torch(layer)
        want, want_kv, want_x = ref_paths(p)
        got = attention.attention_fwd_noncausal(
            pt["attn"], cfg, torch.from_numpy(x), torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
        got_kv = attention.encode_cross_kv(pt["xattn"], cfg,
                                           torch.from_numpy(enc))
        for g, w in zip(got_kv, want_kv):
            assert g.shape == (2, 21, cfg.n_kv_heads, cfg.head_dim)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **LAYER)
        want = want_x
        got = attention.cross_attention_fwd(pt["xattn"], cfg,
                                            torch.from_numpy(x), got_kv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_encode_and_decoder_match_reference():
    """The encoder (sinusoidal positions, 2 bidirectional blocks, norm)
    and the decoder given its output, against the reference's ``encode``
    and ``decode_given_enc``."""
    ref_cfg, cfg = _cfgs("whisper-base")
    params = _params("whisper-base")
    port = bridge.params_from_reference(params, "cpu")
    batch = _batch("whisper-base")
    want = ref_encdec.encode(params, ref_cfg, jnp.asarray(batch["enc_embeds"]))
    got = encdec.encode(port, cfg, torch.from_numpy(batch["enc_embeds"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    want_logits, _ = ref_encdec.decode_given_enc(
        params, ref_cfg, jnp.asarray(batch["tokens"]), want)
    got_logits, aux = encdec.decode_given_enc(
        port, cfg, torch.from_numpy(batch["tokens"]).long(), got)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **LAYER)
    assert float(aux) == 0.0


@pytest.mark.parametrize("img,prefix", [(True, False), (False, True),
                                        (True, True)])
def test_embed_tokens_image_and_prefix_match_reference(img, prefix):
    """LLaVA's embedding: the projected image tokens, then the soft
    prompt, prepended to the text; the positions over all of them."""
    ref_cfg, cfg = _cfgs("llava-next-34b")
    params = _params("llava-next-34b")
    port = bridge.params_from_reference(params, "cpu")
    batch = _batch("llava-next-34b")
    pre = (0.02 * np.random.default_rng(9).standard_normal(
        (B, 5, cfg.d_model))).astype(np.float32)
    kw = dict(img_embeds=batch["img_embeds"] if img else None,
              prefix_embeds=pre if prefix else None)
    h, pos = ref_tf.embed_tokens(params, ref_cfg,
                                 jnp.asarray(batch["tokens"]),
                                 **{k: None if v is None else jnp.asarray(v)
                                    for k, v in kw.items()})
    got, got_pos = transformer.embed_tokens(
        port, cfg, torch.from_numpy(batch["tokens"]).long(),
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in kw.items()})
    assert got.shape[1] == 24 + 8 * img + 5 * prefix
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **LAYER)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_forward_matches_reference(arch):
    """``Model.forward`` with the batch's extras (and for LLaVA also a
    soft prompt): the logits over S' positions, with bound LoRA."""
    ref_cfg, cfg = _cfgs(arch)
    params, batch = _params(arch), _batch(arch)
    lt = _lora(params)
    if not cfg.is_encoder_decoder:
        batch["prefix_embeds"] = (0.02 * np.random.default_rng(7)
                                  .standard_normal((B, 3, cfg.d_model))
                                  ).astype(np.float32)
    want, want_aux = ref_build(ref_cfg).forward(
        ref_lora.bind(params, lt, ALPHA, RANK), _jnp(batch))
    got, aux = build_model(cfg).forward(lora_lib.bind(
        bridge.params_from_reference(params, "cpu"),
        bridge.lora_from_reference(lt, "cpu", cfg), ALPHA, RANK),
        to_device(batch, "cpu"))
    assert got.shape == want.shape
    assert got.shape[1] == 24 + (0 if cfg.is_encoder_decoder else 8 + 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_accepts_and_runs(arch):
    """Both names build at full size and reduced (the two refusals are
    lifted); the reduced model's own init has the reference's tree, leaf
    by leaf, and its forward gives finite logits of the expected shape;
    the full config's parameter count is the reference's."""
    full = registry.get_config(arch)
    model = build_model(full)
    assert model.cfg is full
    assert full.param_count() == ref_registry.get_config(arch).param_count()
    ref_cfg, cfg = _cfgs(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    got = bridge.params_to_reference(params, cfg)
    want = _params(arch)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    logits, _ = build_model(cfg).forward(params, to_device(_batch(arch),
                                                            "cpu"))
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_lora_targets_and_bridge_round_trip(arch):
    """The port's ``init_lora`` on its own tree has the reference's LoRA
    tree, leaf by leaf (every wq/wk/wv: Whisper's encoder attention,
    decoder self-attention and ``xattn``; LLaVA's attention, not
    ``img_proj``); reference -> port -> reference gives every leaf of the
    parameters and of the LoRA tree back bit for bit."""
    ref_cfg, cfg = _cfgs(arch)
    params = _params(arch)
    lt = _lora(params)
    own = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    own_lt = lora_lib.init_lora(torch.Generator().manual_seed(1), own,
                                TARGETS, RANK, ALPHA)
    got = bridge.lora_to_reference(own_lt, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(lt)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(lt)):
        assert g.shape == w.shape
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(lt)[0]]
    n_sites = len(paths) // 2
    if cfg.is_encoder_decoder:
        assert sum("encoder" in p for p in paths) == 6
        assert sum("xattn" in p for p in paths) == 6
        assert n_sites == 9
    else:
        assert n_sites == 3 and not any("img_proj" in p for p in paths)
    for tree, to_port, to_ref in (
            (params, lambda t: bridge.params_from_reference(t, "cpu"),
             lambda t: bridge.params_to_reference(t, cfg)),
            (lt, lambda t: bridge.lora_from_reference(t, "cpu", cfg),
             lambda t: bridge.lora_to_reference(t, cfg))):
        back = to_ref(to_port(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_encdec_split_point_and_wire_bytes_by_hand(bits):
    """At Whisper-base's full width: L = 0 whatever ``split_layer``, and
    each boundary transfer counts 1500 encoder rows an example of 512
    values (int8: a byte each, int4: two a byte, fp32: 4 bytes) plus a
    4-byte scale a row when quantized, whatever the text's length."""
    cfg = registry.get_config("whisper-base")
    sfns = split.make_split_fns(build_model(cfg), FedConfig(
        split_layer=3, activation_quant_bits=bits))
    ref_sfns = ref_split.make_split_fns(
        ref_build(ref_registry.get_config("whisper-base")),
        RefFedConfig(split_layer=3, activation_quant_bits=bits))
    assert sfns["n_client_groups"] == sfns["n_client_layers"] == 0
    assert sfns["enc_dec"] and ref_sfns["n_client_groups"] == 0
    rows = 16 * 1500
    per_row = {0: 512 * 4, 8: 512 + 4, 4: 256 + 4}[bits]
    for shape in ((16, 80), (16, 24)):
        assert sfns["wire_bytes_per_batch"](shape) == \
            ref_sfns["wire_bytes_per_batch"](shape) == (rows * per_row,) * 2


# --------------------------------------------------------------------------- #
# Paired steps and runs (one module fixture)
# --------------------------------------------------------------------------- #
def _ref_loss_fn(arch, params, batch):
    """The reference's classification loss of ``batch`` as a function of
    the LoRA tree, as its train step differentiates it."""
    ref_cfg = _cfgs(arch)[0]
    model = ref_build(ref_cfg)
    loss_fn = ref_tasks.get_loss_fn("classification")
    params = jax.tree.map(jnp.asarray, params)

    def fn(l, b):
        logits, aux = model.forward(ref_lora.bind(params, l, ALPHA, RANK), b)
        return loss_fn(logits, b)[0] + aux
    return fn


def _ref_step(arch, params, lt, batch):
    """(the LoRA gradient, the LoRA after one Adam step) of the
    reference's ``make_fns`` train step; the gradient read off Adam's
    first moment after the step, m = (1 - b1)·g."""
    fed = RefFedConfig(lora_rank=RANK, lora_alpha=ALPHA, lora_dropout=0.0)
    fns = ref_fedavg.make_fns(ref_build(_cfgs(arch)[0]), fed)
    new_lt, opt, _ = fns["train_step"](params, lt, fns["opt_init"](lt),
                                       _jnp(batch), jax.random.PRNGKey(0))
    return jax.tree.map(lambda m: np.asarray(m) / (1.0 - 0.9),
                        opt["m"]), _np(new_lt)


def _port_step(arch, base, plt, batch):
    cfg = _cfgs(arch)[1]
    fed = FedConfig(lora_rank=RANK, lora_alpha=ALPHA, lora_dropout=0.0)
    fns = make_fns(build_model(cfg), fed)
    tb = to_device(batch, "cpu")
    live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), plt)
    logits, aux = build_model(cfg).forward(
        lora_lib.bind(base, live, ALPHA, RANK), tb)
    loss = tasks.get_loss_fn("classification")(logits, tb)[0] + aux
    grads = tree_lib.unflatten(plt, torch.autograd.grad(
        loss, tree_lib.leaves(live)))
    new_lt, _, _ = fns["train_step"](base, plt, fns["opt_init"](plt), tb)
    return grads, new_lt


def _ref_rows(arch, params, lt, batch):
    """(losses, per-example rows as one port-ordered LoRA tree a row) of
    the reference's ``vmap`` of batch-1 value_and_grad over the batch
    dict: each example sliced with its own extras."""
    fn = _ref_loss_fn(arch, params, batch)

    def one(l, ex):
        return fn(l, jax.tree.map(lambda v: v[None], ex))

    return jax.jit(jax.vmap(jax.value_and_grad(one), (None, 0)))(
        lt, _jnp(batch))


def _ref_split_parts(arch, params, lt, batch, L, bits):
    """The reference's split step taken apart, as core/split.split_step
    computes it (the boundary through ``quant_roundtrip`` both ways at
    ``bits``, none at 0): (loss, joined LoRA gradient, the raw boundary
    h, the server's raw gradient of the boundary it was sent)."""
    ref_cfg = _cfgs(arch)[0]
    enc_dec = ref_cfg.is_encoder_decoder
    c_lt, s_lt = ref_split.split_lora(lt, L)
    base_c, base_s = ref_split.split_base(jax.tree.map(jnp.asarray, params),
                                          L, enc_dec)
    bj = _jnp(batch)
    task_loss = ref_tasks.get_loss_fn("classification")
    G = ref_tf.n_groups_of(ref_cfg)

    def bind(base, tree):
        return ref_lora.bind(base, tree, ALPHA, RANK)

    def client_fwd(cl):
        bound = bind(base_c, cl)
        if enc_dec:
            return ref_encdec.encode({"encoder": bound["encoder"]}, ref_cfg,
                                     bj["enc_embeds"])
        h, pos = ref_tf.embed_tokens(bound, ref_cfg, bj["tokens"],
                                     bj["img_embeds"])
        return ref_tf.forward_groups(bound, ref_cfg, h, pos, 0, L)[0]

    def server_fwd(sl, h_in):
        bound = bind(base_s, sl)
        if enc_dec:
            logits, aux = ref_encdec.decode_given_enc(bound, ref_cfg,
                                                      bj["tokens"], h_in)
        else:
            Bn, Sp = h_in.shape[:2]
            pos = jnp.broadcast_to(jnp.arange(Sp, dtype=jnp.int32)[None],
                                   (Bn, Sp))
            h, aux = ref_tf.forward_groups(bound, ref_cfg, h_in, pos, 0,
                                           G - L, include_tail=True)
            h = ref_common.apply_norm(ref_cfg.norm, bound["final_norm"], h)
            logits = ref_tf.lm_logits(bound, ref_cfg, h)
        return task_loss(logits, bj)[0] + aux

    def wire(x):
        return ref_compression.quant_roundtrip(x, bits)[0] if bits else x

    h, vjp = jax.vjp(jax.jit(client_fwd), c_lt)
    loss, (s_grads, h_grad) = jax.jit(jax.value_and_grad(
        server_fwd, (0, 1)))(s_lt, wire(h))
    (c_grads,) = vjp(wire(h_grad))
    return (float(loss), _np(ref_split.join_lora(c_grads, s_grads)),
            np.asarray(h), np.asarray(h_grad))


SPLIT_LAYER = {"whisper-base": 3, "llava-next-34b": 1}


def _port_split(arch, base, plt, batch, bits):
    cfg = _cfgs(arch)[1]
    fed = FedConfig(lora_rank=RANK, lora_alpha=ALPHA, lora_dropout=0.0,
                    split_layer=SPLIT_LAYER[arch],
                    activation_quant_bits=bits)
    sfns = split.make_split_fns(build_model(cfg), fed)
    n = sfns["n_client_layers"]
    c_lt, s_lt = split.split_lora(plt, n)
    base_c, base_s = split.split_base(base, n, sfns["enc_dec"])
    loss, c_grads, s_grads, h, h_grad = sfns["split_grads"](
        base_c, base_s, c_lt, s_lt, to_device(batch, "cpu"))
    joined = split.join_lora(tree_lib.unflatten(c_lt, c_grads),
                             tree_lib.unflatten(s_lt, s_grads))
    return sfns, float(loss), joined, h, h_grad


@pytest.fixture(scope="module")
def pairs():
    """{arch: {what: (reference, port)}} of one train step, the DP rows
    and the Split step (bits 0 and 8) from the same bridged weights and
    batch, and {"runs": ...} of run_federated on both models; the
    fixture's wall time under "seconds"."""
    t0 = time.perf_counter()
    out = {}
    for arch in ARCHS:
        cfg = _cfgs(arch)[1]
        params, batch = _params(arch), _batch(arch)
        lt = _lora(params)
        base = bridge.params_from_reference(params, "cpu")
        plt = bridge.lora_from_reference(lt, "cpu", cfg)
        fed = FedConfig(lora_rank=RANK, lora_alpha=ALPHA, lora_dropout=0.0)
        loss, rows = make_fns(build_model(cfg), fed)["per_example_grads"](
            base, plt, to_device(batch, "cpu"))
        want_loss, want = _ref_rows(arch, params, lt, batch)
        want_rows = np.stack([np.concatenate([
            t.numpy().reshape(-1) for t in tree_lib.leaves(
                bridge.lora_from_reference(jax.tree.map(
                    lambda g, i=i: np.asarray(g)[i], want), "cpu", cfg))])
            for i in range(B)])
        L = 0 if cfg.is_encoder_decoder else SPLIT_LAYER[arch]
        out[arch] = {
            "step": (_ref_step(arch, params, lt, batch),
                     _port_step(arch, base, plt, batch)),
            "rows": ((np.asarray(want_loss), want_rows),
                     (loss.numpy(), rows.numpy())),
            "split": {bits: (_ref_split_parts(arch, params, lt, batch, L,
                                              bits),
                             _port_split(arch, base, plt, batch, bits))
                      for bits in (0, 8)},
        }
    pub, clients, test = _data()
    kw = dict(rounds=1, lora_rank=RANK, lora_dropout=0.0, seed=0)
    runs = {}
    for arch in ARCHS:
        ref_cfg, cfg = _cfgs(arch)
        params = _params(arch)
        lora = bridge.lora_from_reference(_np(ref_lora.init_lora(
            jax.random.PRNGKey(1), params, TARGETS, RANK, ALPHA)), "cpu", cfg)
        got = want = None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            try:
                want = ref_run(dataclasses.replace(ref_cfg,
                                                   kernel_policy="auto"),
                               RefFedConfig(**kw), pub, clients, test,
                               batch_size=16, eval_batch=64)
            except KeyError as e:
                want = e
        try:
            got = run_federated(cfg, FedConfig(**kw), pub, clients, test,
                                batch_size=16, eval_batch=64, device="cpu",
                                base=bridge.params_from_reference(params,
                                                                  "cpu"),
                                lora=lora)
        except KeyError as e:
            got = e
        runs[arch] = (want, got)
    out["runs"] = runs
    out["seconds"] = time.perf_counter() - t0
    print(f"pairs fixture wall_s={out['seconds']:.1f}")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(pairs, arch):
    """One ``make_fns`` train step from the same weights and batch (with
    the extras): the LoRA gradient (every wq/wk/wv site, Whisper's encoder
    and cross-attention included, each non-zero) and the stepped LoRA at
    atol 5e-5 / rtol 5e-4."""
    cfg = _cfgs(arch)[1]
    (want_g, want_lt), (got_g, got_lt) = pairs[arch]["step"]
    for got, want in ((got_g, want_g), (got_lt, want_lt)):
        got = jax.tree.leaves(bridge.lora_to_reference(got, cfg))
        want = jax.tree.leaves(want)
        assert len(got) == len(want) == (18 if cfg.is_encoder_decoder else 6)
        for g, w in zip(got, want):
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(g, w, **STEP)


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_rows_match_reference(pairs, arch):
    """The DP step's per-example losses and gradient rows of the port's
    one batched pass against the reference's ``vmap`` over the batch
    dict (each example with its own stub embeddings): the rows differ
    between examples, so no example saw another's extras."""
    (want_loss, want_rows), (loss, rows) = pairs[arch]["rows"]
    assert rows.shape == want_rows.shape and rows.shape[0] == B
    np.testing.assert_allclose(loss, want_loss, **LAYER)
    np.testing.assert_allclose(rows, want_rows, **LAYER)
    assert not np.allclose(rows[0], rows[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_split_step_matches_reference(pairs, arch):
    """One Split step with an fp32 boundary, the reference's taken apart
    as core/split.split_step computes it: Whisper's at L = 0 (client =
    encoder, boundary (B, 16, d), the server the decoder), LLaVA's after
    layer 1 (the client embeds the image prefix, boundary (B, 8 + 24,
    d)): loss, boundary, c4 gradient and the joined LoRA gradient of both
    halves at atol 1e-5 / rtol 1e-5."""
    cfg = _cfgs(arch)[1]
    (ref_loss, ref_grads, ref_h, ref_hg), port = pairs[arch]["split"][0]
    sfns, loss, joined, h, h_grad = port
    rows = cfg.encoder_seq_len if cfg.is_encoder_decoder \
        else cfg.n_image_tokens + 24
    assert h.shape == ref_h.shape == (B, rows, cfg.d_model)
    assert abs(loss - ref_loss) <= 1e-5
    np.testing.assert_allclose(h.numpy(), ref_h, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h_grad.numpy(), ref_hg, atol=1e-5, rtol=1e-5)
    assert np.abs(ref_hg).max() > 0
    got = jax.tree.leaves(bridge.lora_to_reference(joined, cfg))
    want = jax.tree.leaves(ref_grads)
    assert len(got) == len(want) == (18 if cfg.is_encoder_decoder else 6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def _levels_close(got, want, share):
    """``got``'s int8 levels, from ``quantize`` and from the roundtrip the
    split step applies (its values over the reference's row scales),
    against the reference's ``quantize`` levels of ``want``: at most one
    level apart, and at most ``share`` of them (or one) apart at all
    (None: any share)."""
    ref_comp = ref_compression.quantize(jnp.asarray(want), 8)[0]
    ref_q = np.asarray(ref_comp["q"]).astype(np.int32)
    trip = compression.quant_roundtrip(got, 8)[0].numpy()
    for levels in (compression.quantize(got, 8)[0]["q"].numpy(),
                   np.rint(trip / np.asarray(ref_comp["scale"]))):
        diff = np.abs(levels.astype(np.int32) - ref_q)
        assert diff.max() <= 1
        if share is not None:
            assert int((diff > 0).sum()) <= max(1, share * diff.size)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_int8_boundary_levels_match_reference(pairs, arch):
    """The first step's boundary levels.  Of the step with an fp32 wire,
    the c2 (the client's raw output) and c4 (the server's raw gradient)
    tensors of each package quantized to int8: at most 1e-4 of the
    levels (or one) flip, one level apart.  The step with an int8 wire
    both ways, the reference's taken apart likewise: the port's raw c2 is
    its fp32 run's bit for bit (the quantizer sits after it), the loss
    within 1e-4 of the reference's, and the c4 levels at most one level
    apart (a c2 level that flips moves one input of the server by a level
    and the gradients of its row, so their share is not bounded)."""
    (_, _, ref_h, ref_hg), port = pairs[arch]["split"][0]
    _, _, _, h, h_grad = port
    _levels_close(h, ref_h, 1e-4)
    _levels_close(h_grad, ref_hg, 1e-4)
    (ref_loss, _, _, ref_hg8), port8 = pairs[arch]["split"][8]
    _, loss, _, h8, hg8 = port8
    np.testing.assert_array_equal(h8.numpy(), h.numpy())
    assert abs(loss - ref_loss) <= 1e-4
    _levels_close(hg8, ref_hg8, None)


def test_run_federated_attaches_no_stub_embeddings(pairs):
    """``run_federated``'s batches carry no stub embeddings, in either
    package: LLaVA runs text-only (the same ledger, round loss within
    1e-3 and final LoRA at atol 5e-5 / rtol 5e-4 as the reference's),
    Whisper fails in both with a KeyError naming ``enc_embeds``."""
    cfg = _cfgs("llava-next-34b")[1]
    want, got = pairs["runs"]["llava-next-34b"]
    assert got.ledger.by_name() == want.ledger.by_name()
    assert abs(got.history[0].loss - want.history[0].loss) <= 1e-3
    for g, w in zip(jax.tree.leaves(bridge.lora_to_reference(got.final_lora,
                                                              cfg)),
                    jax.tree.leaves(_np(want.final_lora))):
        np.testing.assert_allclose(g, w, **STEP)
    want, got = pairs["runs"]["whisper-base"]
    assert isinstance(want, KeyError) and isinstance(got, KeyError)
    assert want.args == got.args == ("enc_embeds",)
