"""The DP-SGD step's per-example gradients in one batched pass, against the
reference's ``vmap`` and against a loop of batch-1 passes.

``core/fedavg.per_example_grads`` runs one forward and one backward of
the whole batch on the sum of the per-example losses; each LoRA
projection's backward gives each example's panel gradients (row 4 with an
example axis: ``ref.panel_grad_examples`` here, the ``lora_panel_examples``
kernel on the card) and bind's VJP, batched over the examples, carries
them to the LoRA leaves.  Tolerances: against the loop, the rows' largest
difference within 2e-5 of their largest entry (fp32 sums over another
batching of the same products; 1e-12 in fp64); against the reference, each
row within GRAD_FACTOR times the reference's own xla-to-pallas distance;
the losses within 1e-5 (fp32) of the reference's and the loop's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core import tasks as ref_tasks  # noqa: E402
from repro.kernels.lora_matmul import _panel_grad_call  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import \
    recurrentgemma_2b  # noqa: E402
from repro_torch.configs.rwkv6_1_6b import rwkv6_1_6b  # noqa: E402
from repro_torch.core import tasks  # noqa: E402
from repro_torch.core.fedavg import make_fns, to_device  # noqa: E402
from repro_torch.data import banking77  # noqa: E402
from repro_torch.data.loader import epoch_batches  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

RANK, ALPHA, BATCH, PAD = 4, 32.0, 6, 24
ROWS_RTOL = 2e-5
# a row's distance from the reference's, at most this many times the
# reference's own xla-to-pallas distance (tests/test_torch_model.py's bar)
GRAD_FACTOR = 3.0
LOSS_ATOL = 1e-5


def _f64(tree):
    return tree_lib.map_(
        lambda t: t.double() if t.is_floating_point() else t, tree)


def _batch(cfg, n=BATCH, seed=0):
    _, train, _ = banking77.paper_splits(cfg.vocab_size, pad_len=PAD,
                                         scale=0.04)
    return next(iter(epoch_batches(train, n, seed=seed)))


def _fed(dropout=0.0):
    return FedConfig(framework="fedllm", rounds=1, lora_rank=RANK,
                     lora_alpha=ALPHA, lora_dropout=dropout,
                     privacy=PrivacyConfig(dp_clip=1.0))


def _row_l2(got, want):
    """Each row's relative L2 distance."""
    return (got - want).norm(dim=1) / want.norm(dim=1)


def _rows_close(got, want, rtol=ROWS_RTOL):
    scale = float(want.abs().max())
    assert scale > 0
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(scope="module")
def gpt2_case():
    """gpt2_tiny's reference and port weights (a LoRA tree with non-zero
    B, bridged), one batch, and the reference's own per-example losses
    and gradient rows in the port's leaf order: ``jax.vmap(
    jax.value_and_grad(example_loss), in_axes=(None, 0))`` as
    src/repro/core/fedavg.py runs it, under kernel policy ``pallas``
    (``_panel_grad_call`` and the other Pallas kernels under the
    ``vmap``, in interpret mode) and ``xla``."""
    params = jax.tree.map(np.asarray, ref_build(ref_tiny()).init(
        jax.random.PRNGKey(0)))
    lt = jax.tree.map(np.asarray, ref_lora.init_lora(
        jax.random.PRNGKey(1), params, ("wq", "wk", "wv"), RANK, ALPHA))
    rng = np.random.default_rng(0)
    for block in lt["blocks"]:
        for leaf in block["attn"].values():
            leaf["b"] = (rng.standard_normal(leaf["b"].shape) * 0.05
                         ).astype(np.float32)
    batch = _batch(gpt2_tiny())
    jparams = jax.tree.map(jnp.asarray, params)
    task_loss = ref_tasks.get_loss_fn("classification")

    def reference(policy):
        model = ref_build(dataclasses.replace(ref_tiny(),
                                              kernel_policy=policy))

        def example_loss(l, example):
            one = jax.tree.map(lambda x: x[None], example)
            logits, aux = model.forward(ref_lora.bind(jparams, l, ALPHA,
                                                      RANK), one)
            loss, _ = task_loss(logits, one)
            return loss + aux

        losses, per_ex = jax.vmap(jax.value_and_grad(example_loss),
                                  in_axes=(None, 0))(
            jax.tree.map(jnp.asarray, lt),
            {k: jnp.asarray(v) for k, v in batch.items()})
        rows = torch.stack([torch.cat([t.reshape(-1) for t in tree_lib.leaves(
            bridge.lora_from_reference(jax.tree.map(
                lambda x: np.asarray(x[b]), per_ex), "cpu"))])
            for b in range(len(batch["tokens"]))])
        return torch.tensor(np.asarray(losses)), rows

    ref_losses, ref_rows = reference("pallas")
    _, xla_rows = reference("xla")
    cfg = dataclasses.replace(gpt2_tiny(), kernel_policy="torch")
    return dict(cfg=cfg, model=build_model(cfg),
                base=bridge.params_from_reference(params, "cpu"),
                lora=bridge.lora_from_reference(lt, "cpu"),
                batch=to_device(batch, "cpu"), ref_losses=ref_losses,
                ref_rows=ref_rows,
                ref_spread=float(_row_l2(xla_rows, ref_rows).max()))


@pytest.mark.parametrize("transpose_out", [False, True])
@pytest.mark.parametrize("B,S,L,r,bm,bl", [(3, 24, 256, 8, 24, 128),
                                           (2, 80, 384, 16, 16, 128)])
def test_panel_grad_examples_matches_vmapped_pallas_panel_grad_call(
        B, S, L, r, bm, bl, transpose_out):
    """Row 4 with an example axis: the twin against ``jax.vmap`` of the
    reference's ``_panel_grad_call`` in interpret mode (the form the DP
    step's ``vmap`` gives it), blocks dividing the shapes; the panel
    scaled by S^-0.5 so that the output is O(1)."""
    rng = np.random.default_rng(B + S + L + r)
    lhs = rng.standard_normal((B, S, L)).astype(np.float32)
    panel = (rng.standard_normal((B, S, r)) * S ** -0.5).astype(np.float32)
    want = np.asarray(jax.vmap(lambda x, p: _panel_grad_call(
        x, p, bm, bl, True, jnp.float32))(jnp.asarray(lhs),
                                          jnp.asarray(panel)))
    got = ref.panel_grad_examples(torch.tensor(lhs), torch.tensor(panel),
                                  transpose_out)
    assert got.shape == ((B, r, L) if transpose_out else (B, L, r))
    np.testing.assert_allclose(
        got.numpy(), want.transpose(0, 2, 1) if transpose_out else want,
        atol=1e-5, rtol=1e-5)


# (B, S, K, N, r) of the four sites the DP step meets, at reduced width:
# GPT-2 (K = N), RecurrentGemma-2B's wq (K = N) and wk/wv (N < 128, a
# single 128-column tile of dB), RWKV-6 (K = N); then K not a multiple of
# 4 with N odd, at rank 5
PAIR_SITES = [(4, 24, 192, 192, 8), (3, 20, 320, 320, 8),
              (3, 20, 320, 32, 8), (2, 24, 256, 256, 8),
              (3, 17, 130, 69, 5)]


@pytest.mark.parametrize("B,S,K,N,r", PAIR_SITES)
def test_panel_grad_examples_pair_matches_vmapped_pallas_panel_grad_call(
        B, S, K, N, r):
    """Row 4ᵉ's pair (a LoRA site's dA and dB of each example, one launch
    on the card): the twin against ``jax.vmap`` of the reference's
    ``_panel_grad_call`` in interpret mode, dA = _panel_grad_call(x, gb)
    and dB = _panel_grad_call(g, xa)ᵀ as its backward takes them, one block
    over each whole width; and bit for bit the two single-product twins
    it replaces.  Panels scaled by S^-0.5 (O(1) outputs)."""
    rng = np.random.default_rng(B * S + K + N + r)
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    g = rng.standard_normal((B, S, N)).astype(np.float32)
    gb, xa = ((rng.standard_normal((B, S, r)) * S ** -0.5).astype(np.float32)
              for _ in range(2))

    def pallas(lhs, panel):
        return np.asarray(jax.vmap(lambda u, p: _panel_grad_call(
            u, p, S, lhs.shape[2], True, jnp.float32))(jnp.asarray(lhs),
                                                       jnp.asarray(panel)))

    tx, tgb, tg, txa = (torch.tensor(t) for t in (x, gb, g, xa))
    da, db = ref.panel_grad_examples_pair(tx, tgb, tg, txa)
    assert da.shape == (B, K, r) and db.shape == (B, r, N)
    assert da.dtype == db.dtype == torch.float32 and db.is_contiguous()
    np.testing.assert_allclose(da.numpy(), pallas(x, gb), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), pallas(g, xa).transpose(0, 2, 1),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(da, ref.panel_grad_examples(tx, tgb))
    assert torch.equal(db, ref.panel_grad_examples(tg, txa, True))


def test_lora_examples_backward_takes_one_pair_a_site(monkeypatch):
    """LoRAMatmulExamples' backward makes one call of the pair (one launch
    on the card) for the site's dA and dB, and its sink gradients are each
    example's own: those of a batch-1 pass of the plain LoRA product."""
    from repro_torch.kernels import lora_matmul as lm

    calls = []
    real = ref.panel_grad_examples_pair

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(ref, "panel_grad_examples_pair", counting)
    B, S, K, N, r = 3, 5, 12, 10, 4
    gen = torch.Generator().manual_seed(0)
    x, w, a, b, probe = (torch.randn(shape, generator=gen) for shape in
                         ((B, S, K), (K, N), (K, r), (r, N), (B, S, N)))
    sa = torch.zeros(B, K, r, requires_grad=True)
    sb = torch.zeros(B, r, N, requires_grad=True)
    y = lm.LoRAMatmulExamples.apply(x, w, a, b, sa, sb, False)
    da, db = torch.autograd.grad((y * probe).sum(), (sa, sb))
    assert calls == [(B, S, K)]
    for i in range(B):
        a1, b1 = (t.detach().clone().requires_grad_(True) for t in (a, b))
        y1 = ref.lora_matmul_ref(x[i], w, a1, b1)
        want = torch.autograd.grad((y1 * probe[i]).sum(), (a1, b1))
        torch.testing.assert_close(da[i], want[0], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(db[i], want[1], atol=1e-5, rtol=1e-5)


def test_per_example_grads_match_reference_vmap(gpt2_case):
    """The port's rows and losses against the reference's ``vmap`` of
    ``value_and_grad(example_loss)`` under ``pallas`` at gpt2_tiny, from
    bridged weights: the losses within 1e-5, each row within GRAD_FACTOR
    times the largest relative L2 distance between the reference's own
    ``xla`` and ``pallas`` rows (1.3e-4 here: these B factors make
    gradients up to ~120, and fp32 noise in the forward reaches them
    amplified)."""
    c = gpt2_case
    fns = make_fns(c["model"], _fed())
    losses, rows = fns["per_example_grads"](c["base"], c["lora"], c["batch"])
    assert rows.shape == c["ref_rows"].shape and rows.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), c["ref_losses"].numpy(),
                               atol=LOSS_ATOL, rtol=0)
    assert 0 < c["ref_spread"] < 1e-3
    assert float(_row_l2(rows, c["ref_rows"]).max()) \
        <= GRAD_FACTOR * c["ref_spread"]


FAMILIES = {
    "gpt2": lambda: gpt2_tiny(),
    "recurrentgemma": lambda: recurrentgemma_2b().reduced(n_layers=5,
                                                         d_model=128),
    "rwkv6": lambda: rwkv6_1_6b().reduced(n_layers=2, d_model=128),
}


def _loop_rows(model, fed, base, lt, batch, seed):
    """Each example as a batch of one through the same bound tree (one
    dropout mask, drawn from ``seed`` as the step draws it)."""
    loss_fn = tasks.get_loss_fn("classification")
    live = [t.detach().requires_grad_(True) for t in tree_lib.leaves(lt)]
    bound = lora_lib.bind(base, tree_lib.unflatten(lt, live), fed.lora_alpha,
                          RANK, dropout=fed.lora_dropout,
                          dropout_gen=torch.Generator().manual_seed(seed))
    rows, losses = [], []
    for b in range(len(batch["tokens"])):
        one = {k: v[b:b + 1] for k, v in batch.items()}
        logits, aux = model.forward(bound, one)
        loss = loss_fn(logits, one)[0] + aux
        g = torch.autograd.grad(loss, live, retain_graph=True)
        rows.append(torch.cat([t.reshape(-1) for t in g]))
        losses.append(loss.detach())
    return torch.stack(losses), torch.stack(rows)


@pytest.mark.parametrize("variant", ["plain", "dropout", "fp64"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_example_grads_match_batch_one_loop(family, variant):
    """The batched rows against a loop of batch-1 passes on each ported
    family, with LoRA dropout 0.1 (one mask shared by the examples), and
    from fp64 weights and LoRA leaves (rows in fp64)."""
    cfg = dataclasses.replace(FAMILIES[family](), kernel_policy="torch")
    model = build_model(cfg)
    fed = _fed(0.1 if variant == "dropout" else 0.0)
    base = model.init(torch.Generator().manual_seed(0), "cpu")
    lt = lora_lib.init_lora(torch.Generator().manual_seed(1), base,
                            lora_lib.default_targets(cfg), RANK, ALPHA)
    gen = torch.Generator().manual_seed(2)
    lt = tree_lib.map_(lambda t: t + 0.05 * torch.randn(t.shape,
                                                        generator=gen), lt)
    if variant == "fp64":
        base, lt = _f64(base), _f64(lt)
    batch = to_device(_batch(cfg, n=4, seed=1), "cpu")
    losses, rows = make_fns(model, fed)["per_example_grads"](
        base, lt, batch, torch.Generator().manual_seed(3))
    want_losses, want = _loop_rows(model, fed, base, lt, batch, 3)
    dt = torch.float64 if variant == "fp64" else torch.float32
    assert rows.dtype == dt and losses.dtype == dt
    assert rows.shape == (4, lora_lib.n_params(lt))
    np.testing.assert_allclose(losses.numpy(), want_losses.numpy(),
                               atol=1e-12 if variant == "fp64" else LOSS_ATOL,
                               rtol=0)
    _rows_close(rows, want, 1e-12 if variant == "fp64" else ROWS_RTOL)


class _Counting:
    """A model whose forward is counted (and, with ``aux_grad``, returns
    an aux term that depends on the batch through the LoRA leaves)."""

    def __init__(self, model, aux_grad=False):
        self.model, self.cfg, self.aux_grad = model, model.cfg, aux_grad
        self.calls = 0

    def forward(self, params, batch):
        self.calls += 1
        logits, aux = self.model.forward(params, batch)
        if self.aux_grad:
            aux = aux + 1e-3 * logits.float().pow(2).mean()
        return logits, aux


def test_dp_step_runs_one_forward(gpt2_case):
    """A DP train step makes one forward of the batch, not one a
    example, and its rows' clipped mean moves the LoRA leaves."""
    c = gpt2_case
    model = _Counting(c["model"])
    fns = make_fns(model, _fed())
    new, _, loss = fns["train_step"](c["base"], c["lora"],
                                     fns["opt_init"](c["lora"]), c["batch"])
    assert model.calls == 1
    np.testing.assert_allclose(float(loss), float(c["ref_losses"].mean()),
                               atol=LOSS_ATOL, rtol=0)
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(new), tree_lib.leaves(c["lora"])))


def test_aux_with_gradient_refused(gpt2_case):
    """An aux term that mixes the examples (it carries a gradient)
    cannot be split by one batched pass: the step raises."""
    c = gpt2_case
    fns = make_fns(_Counting(c["model"], aux_grad=True), _fed())
    with pytest.raises(ValueError, match="aux"):
        fns["per_example_grads"](c["base"], c["lora"], c["batch"])


def test_per_example_scope_refusals():
    """Under the scope a projection whose input does not lead with the
    batch, and a bound base weight that requires a gradient, raise."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 5, 6), generator=gen)
    w, a, b = (torch.randn(s, generator=gen) for s in ((6, 7), (6, 2),
                                                        (2, 7)))
    with ops.per_example_scope(4) as sites:
        y = ops.lora_matmul(x, w, a, b)
        assert y.shape == (4, 5, 7) and len(sites) == 1
        torch.testing.assert_close(y, ref.lora_matmul_ref(x, w, a, b))
        with pytest.raises(ValueError, match="lead with the batch"):
            ops.lora_matmul(x.reshape(20, 6), w, a, b)
        with pytest.raises(ValueError, match="base weight"):
            ops.lora_matmul(x, w.requires_grad_(True), a, b)
        with pytest.raises(RuntimeError, match="already open"):
            with ops.per_example_scope(4):
                pass
