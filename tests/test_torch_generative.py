"""The port's generative task against the reference: the loss and its two
per-example forms, every step of ``make_fns(task="generative")`` at
``gpt2_tiny``, and ``run_federated(task="generative")`` under every
backend and setting the reference runs it on.

Both packages start from the reference's ``model.init(PRNGKey(0))`` and
LoRA draws, bridged; the port runs on the CPU with the plain kernel
policy.  Bars: ledger bytes and client FLOPs exactly; a round's loss and
accuracy (minus the loss, as the reference's ``eval_step`` gives it)
within 1e-3; the final LoRA within atol 5e-5 / rtol 5e-4, the bar the
reference holds its own backends to (tests/test_backend_parity.py).  A
step's loss within 1e-5 and its new LoRA within the same atol / rtol.

The runs (one module fixture) are the verify-skill configuration
(``paper_splits(scale=0.04, pad_len=24)``, 3 IID clients, rank 4 on
wq/wk/wv, dropout 0, batch 16, eval batch 64): FedLLM under
``sequential`` (2 rounds), ``spmd``, ``cohort`` (chunks of 2), async
(max_staleness 1) and DP (clip 0.5, secure aggregation); Split
(split_layer 1) with an fp32 and an int8 boundary, each under
``sequential`` and ``spmd``.  The port's ``spmd`` and ``cohort`` FedLLM
runs are held to the reference's sequential run (the reference's
backends agree within that bar), and its Split ``spmd`` runs to its own
sequential runs bit for bit (the same split steps in the same order).
An int8 boundary flips a level where the two packages' fp32 activations
straddle a half level, so its final LoRA is not held to the reference's
(tests/test_torch_split.py bounds that floor on the classification path);
its ledger and round metrics are.

KD over a generative task's logits raises ValueError at b4 in the
reference (the einsum of ``src/repro/core/kd.py:90`` over (C, N, S, V)),
and in the port."""
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
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core import fedavg as ref_fedavg  # noqa: E402
from repro.core import tasks as ref_tasks  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.models import loss as ref_loss  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core import fed_spmd, kd, tasks  # noqa: E402
from repro_torch.core.fedavg import make_fns, to_device  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.models import loss as losses  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402

SEED = 0
TARGETS = ("wq", "wk", "wv")
RANK, ALPHA = 4, 32.0
LORA_TOL = dict(atol=5e-5, rtol=5e-4)
LOSS_ATOL = 1e-5
# A step's gradient (the LoRA's change under SGD at lr 1) is judged from
# an fp64 run of the port's step: the port's fp32 step within 3x the
# reference's fp32 step's relative L2 distance from it (+1e-6), and the
# reference's within REF_GAP of it (the two compute the same function;
# both lie ~1e-6 from it here).  A LoRA B drawn much larger (N(0,
# 0.05²)) lets the LoRA branch outweigh the base 3x and fp32 noise reach
# the gradient amplified to ~1e-4
REF_GAP = 1e-4
# The KD loss runs in fp32 in both packages whatever the logits' dtype
# (kernels/ops.kd_loss, the reference's kd_kl), so an fp64 run is no
# yardstick for a KD step: the port's KD step is held to the reference's
# (1-5e-6 apart here)
KD_GAP = 1e-4
GEN = "generative"


def _data():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    return cfg, pub, partition.iid_partition(train, 3), test


def _ref_trees(lora_seed):
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    lt = jax.tree.map(np.asarray, ref_lora.init_lora(
        jax.random.PRNGKey(lora_seed), params, TARGETS, RANK, ALPHA))
    return params, lt


def _f64(tree):
    return tree_lib.map_(
        lambda t: t.double() if t.is_floating_point() else t, tree)


def _step_close(got, want_ref, exact, start, what):
    """A port step's new LoRA (``got``) and the reference's
    (``want_ref``) against the port's fp64 step (``exact``), each as its
    change from ``start``: the port's within 3x the reference's relative
    L2 distance (+1e-6), the reference's within REF_GAP.  Without
    ``exact`` the port's against the reference's, within KD_GAP."""
    want = bridge.lora_from_reference(jax.tree.map(np.asarray, want_ref),
                                      "cpu")

    def change(tree):
        return torch.cat([(x.double() - s.double()).reshape(-1) for x, s in
                          zip(tree_lib.leaves(tree), tree_lib.leaves(start))])

    if exact is None:
        d_want = change(want)
        gap = float((change(got) - d_want).norm() / d_want.norm())
        print(f"{what}: relative L2 from the reference {gap:.3e}")
        assert gap <= KD_GAP, (what, gap)
        return
    d64 = change(exact)
    gaps = [float((change(t) - d64).norm() / d64.norm()) for t in (got, want)]
    print(f"{what}: relative L2 from fp64, port {gaps[0]:.3e}, reference "
          f"{gaps[1]:.3e}")
    assert gaps[1] <= REF_GAP, (what, gaps)
    assert gaps[0] <= 3 * gaps[1] + 1e-6, (what, gaps)


def _lora_close(got, want_ref, what):
    """A port LoRA tree against a reference one (numpy or jax)."""
    want = bridge.lora_from_reference(jax.tree.map(np.asarray, want_ref),
                                      "cpu")
    for i, (x, y) in enumerate(zip(tree_lib.leaves(got),
                                   tree_lib.leaves(want))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **LORA_TOL,
                                   err_msg=f"{what}: leaf {i}")


# --------------------------------------------------------------------------- #
# The loss and its per-example forms
# --------------------------------------------------------------------------- #
def _lm_case(seed=0, B=6, S=12, V=40, prefix=3):
    """Logits with a prefix of ``prefix`` positions, tokens with pad 0s at
    the end of some rows and token 0 inside others, and one all-pad row."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, prefix + S, V)).astype(np.float32) * 2
    tokens = rng.integers(1, V, size=(B, S)).astype(np.int32)
    tokens[0, 7:] = 0
    tokens[1, 3] = 0
    tokens[2, 5] = 0
    tokens[3, :] = 0
    tokens[4, 1:] = 0
    return logits, {"tokens": tokens,
                    "lengths": np.full((B,), S, np.int32),
                    "labels": np.zeros((B,), np.int32)}


def test_generative_loss_matches_reference():
    logits, batch = _lm_case()
    want, want_lg = ref_tasks.generative_loss_fn(
        jnp.asarray(logits), {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_lg = tasks.generative_loss_fn(torch.from_numpy(logits),
                                           to_device(batch, "cpu"))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_lg.numpy(), np.asarray(want_lg))
    assert tasks.get_loss_fn("summarization") is tasks.generative_loss_fn
    assert tasks.task_logit_dim(GEN, 50257) == \
        ref_tasks.task_logit_dim(GEN, 50257) == 50257
    assert tasks.task_logit_dim("classification", 50257) == \
        ref_tasks.task_logit_dim("classification", 50257)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_next_token_loss_match_reference(masked):
    logits, batch = _lm_case(seed=1, prefix=0)
    mask = (batch["tokens"] != 0).astype(np.float32) if masked else None
    want = ref_loss.next_token_loss(
        jnp.asarray(logits), jnp.asarray(batch["tokens"]),
        None if mask is None else jnp.asarray(mask))
    got = losses.next_token_loss(
        torch.from_numpy(logits), torch.from_numpy(batch["tokens"]).long(),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got[0]), float(want[0]), atol=1e-6)
    assert float(got[1]) == float(want[1])
    # every token pad: n clamps at 1 and the loss is 0
    zero = torch.zeros(2, 5, dtype=torch.long)
    loss, n = losses.next_token_loss(torch.randn(2, 5, 7), zero,
                                     (zero != 0).float())
    assert float(loss) == 0.0 and float(n) == 1.0


def test_per_example_forms_match_reference_vmaps():
    """The DP step's rows (each example's own token mean, the reference's
    ``vmap`` of a batch of one) and the stacked clients' losses (each
    client's token-weighted mean over its rows, the reference's ``vmap``
    over clients) against the reference; the two differ, as a token mean
    of example means differs from a token-weighted mean."""
    logits, batch = _lm_case(seed=2)
    jl = jnp.asarray(logits)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    one = jax.jit(jax.vmap(lambda lg, ex: ref_tasks.generative_loss_fn(
        lg[None], jax.tree.map(lambda x: x[None], ex))[0]))(jl, jb)
    C = 3
    per_client = jax.jit(jax.vmap(
        lambda lg, b: ref_tasks.generative_loss_fn(lg, b)[0]))(
        jl.reshape((C, -1) + jl.shape[1:]),
        jax.tree.map(lambda x: x.reshape((C, -1) + x.shape[1:]), jb))
    tl, tb = torch.from_numpy(logits), to_device(batch, "cpu")
    rows = tasks.get_loss_rows_fn(GEN)(tl, tb)
    clients = tasks.get_clients_loss_fn(GEN)(tl, tb, C)
    np.testing.assert_allclose(rows.numpy(), np.asarray(one), atol=1e-6)
    np.testing.assert_allclose(clients.numpy(), np.asarray(per_client),
                               atol=1e-6)
    assert float(rows[3]) == 0.0        # the all-pad example
    # the batch loss is the token-weighted mean, not the mean of the rows
    whole = float(tasks.generative_loss_fn(tl, tb)[0])
    assert abs(whole - float(rows.mean())) > 1e-3
    # classification: both forms are means of the same rows
    cl_rows = tasks.get_loss_rows_fn("classification")(tl, tb)
    np.testing.assert_allclose(
        tasks.get_clients_loss_fn("classification")(tl, tb, C).numpy(),
        cl_rows.view(C, -1).mean(1).numpy(), atol=0)


# --------------------------------------------------------------------------- #
# make_fns(task="generative"): every step
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def steps_case():
    """gpt2_tiny's weights, a LoRA tree with B drawn N(0, 0.01²) (so
    both factors get gradients), the reference's and the port's generative
    steps, a batch of 6 and the stacked clients' inputs (3 clients of 2
    rows each, each client's LoRA its own)."""
    params, lt = _ref_trees(SEED + 1)
    rng = np.random.default_rng(0)
    for block in lt["blocks"]:
        for leaf in block["attn"].values():
            leaf["b"] = (rng.standard_normal(leaf["b"].shape) * 0.01
                         ).astype(np.float32)
    _, _, clients, _ = _data()
    batch = {k: v[:6] for k, v in clients[0].items()}
    batch["tokens"] = batch["tokens"].copy()
    batch["tokens"][1, 4] = 0                   # a token 0 inside a row
    cfg = dataclasses.replace(gpt2_tiny(), kernel_policy="torch")
    return dict(params=params, lt=lt, batch=batch, model=build_model(cfg),
                base=bridge.params_from_reference(params, "cpu"),
                lora=bridge.lora_from_reference(lt, "cpu"))


# the steps update with SGD at lr 1: the new LoRA is the old one less the
# gradient, which a bar can hold (Adam's first step moves a coordinate
# whose gradient sits near its epsilon by a sign fp32 noise picks)
STEP_FED = dict(lora_rank=RANK, lora_dropout=0.0, optimizer="sgd", lr=1.0)


def _ref_fns(dp_clip=0.0):
    fed = RefFedConfig(**STEP_FED, privacy=RefPrivacy(dp_clip=dp_clip))
    return ref_fedavg.make_fns(ref_build(ref_tiny()), fed, task=GEN)


def _port_fns(c, dp_clip=0.0):
    fed = FedConfig(**STEP_FED, privacy=PrivacyConfig(dp_clip=dp_clip))
    return make_fns(c["model"], fed, task=GEN)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("dp_clip", [0.0, 10.0])
def test_train_step_matches_reference(steps_case, dp_clip):
    """One step, plain and DP-SGD (the per-example rows clipped at 10,
    about the median row norm here, so some clip)."""
    c = steps_case
    rf = _ref_fns(dp_clip)
    jp, jl = _j(c["params"]), _j(c["lt"])
    want_lt, _, want_loss = rf["train_step"](
        jp, jl, rf["opt_init"](jl), _j(c["batch"]), jax.random.PRNGKey(0))
    pf = _port_fns(c, dp_clip)
    tb = to_device(c["batch"], "cpu")
    got_lt, opt, got_loss = pf["train_step"](
        c["base"], c["lora"], pf["opt_init"](c["lora"]), tb)
    assert opt == {"mu": None}
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               atol=LOSS_ATOL, rtol=0)
    exact, _, _ = pf["train_step"](_f64(c["base"]), _f64(c["lora"]),
                                   pf["opt_init"](_f64(c["lora"])), tb)
    _step_close(got_lt, want_lt, exact, c["lora"],
                f"train step, dp_clip {dp_clip}")
    if dp_clip:
        _, rows = pf["per_example_grads"](c["base"], c["lora"],
                                          to_device(c["batch"], "cpu"))
        norms = torch.linalg.vector_norm(rows, dim=1)
        assert bool((norms > dp_clip).any() and (norms < dp_clip).any())


def test_per_example_grads_match_reference_vmap(steps_case):
    """The DP step's rows against the reference's jitted ``vmap`` of
    ``value_and_grad`` of its example loss (src/repro/core/fedavg.py's
    form) under the generative loss."""
    c = steps_case
    model = ref_build(ref_tiny())
    jp = _j(c["params"])

    def example_loss(l, example):
        one = jax.tree.map(lambda x: x[None], example)
        logits, aux = model.forward(ref_lora.bind(jp, l, ALPHA, RANK), one)
        return ref_tasks.generative_loss_fn(logits, one)[0] + aux

    want_losses, per_ex = jax.jit(jax.vmap(jax.value_and_grad(example_loss),
                                           in_axes=(None, 0)))(
        _j(c["lt"]), _j(c["batch"]))
    B = len(c["batch"]["tokens"])
    want = np.stack([np.concatenate([t.numpy().ravel() for t in
                                     tree_lib.leaves(bridge.lora_from_reference(
                                         jax.tree.map(lambda x: np.asarray(
                                             x[b]), per_ex), "cpu"))])
                     for b in range(B)])
    pf, tb = _port_fns(c), to_device(c["batch"], "cpu")
    got_losses, rows = pf["per_example_grads"](c["base"], c["lora"], tb)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                               atol=LOSS_ATOL, rtol=0)
    _, exact = pf["per_example_grads"](_f64(c["base"]), _f64(c["lora"]), tb)
    assert rows.dtype == torch.float32 and exact.dtype == torch.float64
    # the (B, P) rows taken as one vector, as chip_smoke.py's gates take them
    gaps = [float((torch.as_tensor(r).double() - exact).norm()
                  / exact.norm()) for r in (rows, want)]
    print(f"per-example rows: relative L2 from fp64, port {gaps[0]:.3e}, "
          f"reference {gaps[1]:.3e}")
    assert gaps[1] <= REF_GAP and gaps[0] <= 3 * gaps[1] + 1e-6, gaps


def test_eval_logits_and_kd_steps_match_reference(steps_case):
    """eval_step (accuracy = minus the loss), logits_fn (the full LM
    logits) and kd_step (full student logits against full teacher logits,
    unmasked)."""
    c = steps_case
    rf, pf = _ref_fns(), _port_fns(c)
    jp, jl, jb = _j(c["params"]), _j(c["lt"]), _j(c["batch"])
    tb = to_device(c["batch"], "cpu")
    want_acc, want_loss = rf["eval_step"](jp, jl, jb)
    got_acc, got_loss = pf["eval_step"](c["base"], c["lora"], tb)
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               atol=LOSS_ATOL)
    assert float(got_acc) == -float(got_loss)
    assert float(want_acc) == -float(want_loss)
    want_lg = np.asarray(rf["logits_fn"](jp, jl, jb))
    got_lg = pf["logits_fn"](c["base"], c["lora"], tb)
    assert got_lg.shape == want_lg.shape == (6, 24, gpt2_tiny().vocab_size)
    np.testing.assert_allclose(got_lg.numpy(), want_lg, atol=1e-4, rtol=1e-4)
    # b2 over the public rows in the reference's shuffled batches, scattered
    # back to row order: (N, S, V)
    public = {k: np.concatenate([v] * 2)[:10] for k, v in c["batch"].items()}
    from repro.core import kd as ref_kd
    want_cl = np.asarray(ref_kd.client_logits(rf, jp, jl, public, 4))
    got_cl = kd.client_logits(pf, c["base"], c["lora"], public, 4, "cpu")
    assert got_cl.shape == want_cl.shape == (10, 24, gpt2_tiny().vocab_size)
    np.testing.assert_allclose(got_cl.numpy(), want_cl, atol=1e-4, rtol=1e-4)
    teacher = want_lg * 1.5 + 0.3
    want_lt, _, want_kd = rf["kd_step"](jp, jl, rf["opt_init"](jl), jb,
                                        jnp.asarray(teacher),
                                        jax.random.PRNGKey(0))
    got_lt, _, got_kd = pf["kd_step"](c["base"], c["lora"],
                                      pf["opt_init"](c["lora"]), tb,
                                      torch.from_numpy(teacher))
    np.testing.assert_allclose(float(got_kd), float(want_kd), atol=LOSS_ATOL,
                               rtol=1e-6)
    _step_close(got_lt, want_lt, None, c["lora"], "kd step")


def _stacked_inputs(c, C=3):
    """C clients' LoRA trees (each its own: the bridged tree plus a
    client-specific nudge) and their batches of 2 rows one after
    another."""
    rng = np.random.default_rng(5)
    lts = [jax.tree.map(lambda x: (x + 0.005 * rng.standard_normal(x.shape)
                                   ).astype(np.float32), c["lt"])
           for _ in range(C)]
    return lts, c["batch"]


@pytest.mark.parametrize("dp_clip", [0.0, 10.0])
def test_train_step_clients_matches_reference_vmap(steps_case, dp_clip):
    """The stacked step (``train_step_clients``, under DP
    ``per_example_grads_clients``) against the reference's ``vmap`` over
    clients of its train step, each client's loss its own token-weighted
    mean (or, under DP, its mean of example means)."""
    c = steps_case
    C = 3
    lts, batch = _stacked_inputs(c, C)
    rf = _ref_fns(dp_clip)
    sl = jax.tree.map(lambda *xs: jnp.stack(xs), *[_j(t) for t in lts])
    so = jax.vmap(rf["opt_init"])(sl)
    sb = jax.tree.map(lambda x: jnp.asarray(x).reshape((C, -1) + x.shape[1:]),
                      batch)
    want_lt, _, want_loss = jax.jit(jax.vmap(
        rf["train_step_impl"], in_axes=(None, 0, 0, 0, 0)))(
        _j(c["params"]), sl, so, sb, jax.random.split(jax.random.PRNGKey(0),
                                                      C))
    pf = _port_fns(c, dp_clip)
    plts = [bridge.lora_from_reference(t, "cpu") for t in lts]
    slt = fed_spmd.stack_trees(plts)
    sopt = fed_spmd.stack_trees([pf["opt_init"](t) for t in plts])
    got_lt, sopt, got_loss = pf["train_step_clients"](
        c["base"], slt, sopt, to_device(batch, "cpu"))
    assert sopt == {"mu": None}
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               atol=LOSS_ATOL, rtol=0)
    exact, _, _ = pf["train_step_clients"](
        _f64(c["base"]), _f64(slt), {"mu": None}, to_device(batch, "cpu"))
    for ci, (got, ex) in enumerate(zip(fed_spmd.unstack_tree(got_lt),
                                       fed_spmd.unstack_tree(exact))):
        _step_close(got, jax.tree.map(lambda x: np.asarray(x[ci]), want_lt),
                    ex, plts[ci], f"client {ci}, dp_clip {dp_clip}")


def test_logits_and_kd_step_clients_match_reference_vmap(steps_case):
    """``logits_fn_clients`` (C, B, S, V) and ``kd_step_clients`` against
    a 3-D teacher, against the reference's ``vmap`` of logits_fn and
    kd_step over clients (as its make_kd_spmd_fns)."""
    c = steps_case
    C = 3
    lts, batch = _stacked_inputs(c, C)
    rf, pf = _ref_fns(), _port_fns(c)
    sl = jax.tree.map(lambda *xs: jnp.stack(xs), *[_j(t) for t in lts])
    jp, jb = _j(c["params"]), _j(batch)
    want_lg = np.asarray(jax.jit(jax.vmap(rf["logits_fn"],
                                          in_axes=(None, 0, None)))(
        jp, sl, jb))
    plts = [bridge.lora_from_reference(t, "cpu") for t in lts]
    slt = fed_spmd.stack_trees(plts)
    rep = fed_spmd.repeat_batch(batch, C, "cpu")
    got_lg = pf["logits_fn_clients"](c["base"], slt, rep)
    assert got_lg.shape == want_lg.shape == (C, 6, 24,
                                             gpt2_tiny().vocab_size)
    np.testing.assert_allclose(got_lg.numpy(), want_lg, atol=1e-4, rtol=1e-4)
    teacher = want_lg.mean(0)
    want_lt, _, want_loss = jax.jit(jax.vmap(
        rf["kd_step"], in_axes=(None, 0, 0, None, None, 0)))(
        jp, sl, jax.vmap(rf["opt_init"])(sl), jb, jnp.asarray(teacher),
        jax.random.split(jax.random.PRNGKey(0), C))
    got_lt, _, got_loss = pf["kd_step_clients"](
        c["base"], slt, fed_spmd.stack_trees([pf["opt_init"](t)
                                              for t in plts]), rep,
        torch.from_numpy(teacher))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               atol=LOSS_ATOL, rtol=1e-6)
    for ci, got in enumerate(fed_spmd.unstack_tree(got_lt)):
        _step_close(got, jax.tree.map(lambda x: np.asarray(x[ci]), want_lt),
                    None, plts[ci], f"kd client {ci}")


# --------------------------------------------------------------------------- #
# run_federated(task="generative")
# --------------------------------------------------------------------------- #
FED = dict(rounds=1, lora_rank=RANK, lora_dropout=0.0, seed=SEED)
# (reference run, its settings) or None: the port's run is held to the
# reference run named
RUNS = {
    "fedllm": ("fedllm", dict(framework="fedllm", rounds=2)),
    "fedllm spmd": ("fedllm", dict(framework="fedllm", rounds=2,
                                   backend="spmd")),
    "fedllm cohort": ("fedllm", dict(framework="fedllm", rounds=2,
                                     backend="cohort", cohort_size=2)),
    "fedllm async": ("fedllm async", dict(framework="fedllm",
                                          aggregation="async",
                                          max_staleness=1)),
    "fedllm dp": ("fedllm dp", dict(framework="fedllm", privacy=dict(
        dp_clip=0.5, secure_agg=True))),
    "split": ("split", dict(framework="split", split_layer=1)),
    "split spmd": ("split", dict(framework="split", split_layer=1,
                                 backend="spmd")),
    "split int8": ("split int8", dict(framework="split", split_layer=1,
                                      activation_quant_bits=8)),
    "split int8 spmd": ("split int8", dict(framework="split", split_layer=1,
                                           activation_quant_bits=8,
                                           backend="spmd")),
}
REFERENCE = {"fedllm", "fedllm async", "fedllm dp", "split", "split int8"}


def _configs(settings, fed_cls, priv_cls):
    kw = dict(FED, **settings)
    if "privacy" in kw:
        kw["privacy"] = priv_cls(**kw["privacy"])
    return fed_cls(**kw)


@pytest.fixture(scope="module")
def runs():
    """The reference's generative runs (REFERENCE) and the port's (RUNS),
    from the same bridged weights: FedLLM from the reference's seed + 1
    LoRA draw, Split from its seed + 3 draw."""
    cfg, pub, clients, test = _data()
    params, lt1 = _ref_trees(SEED + 1)
    _, lt3 = _ref_trees(SEED + 3)
    out = {}
    for name, (ref_name, settings) in RUNS.items():
        lt = lt3 if name.startswith("split") else lt1
        if ref_name == name:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                out["reference", name] = ref_run(
                    ref_tiny(), _configs(settings, RefFedConfig, RefPrivacy),
                    pub, clients, test, task=GEN, batch_size=16,
                    eval_batch=64)
        out[name] = run_federated(
            cfg, _configs(settings, FedConfig, PrivacyConfig), pub, clients,
            test, task=GEN, batch_size=16, eval_batch=64, device="cpu",
            base=bridge.params_from_reference(params, "cpu"),
            lora=bridge.lora_from_reference(lt, "cpu"))
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_generative_ledger_and_flops_equal(runs, name):
    port, ref = runs[name], runs["reference", RUNS[name][0]]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
        assert hp.epsilon == hr.epsilon


@pytest.mark.parametrize("name", sorted(RUNS))
def test_generative_round_metrics_close(runs, name):
    port, ref = runs[name], runs["reference", RUNS[name][0]]
    assert len(port.history) == len(ref.history) >= 1
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
        # minus the eval loss, the reference's generative accuracy
        assert hp.accuracy == -hp.loss and hr.accuracy == -hr.loss
        assert 5.0 < hp.loss < 7.0


@pytest.mark.parametrize("name", sorted(n for n in RUNS if "int8" not in n))
def test_generative_final_lora_close(runs, name):
    _lora_close(runs[name].final_lora,
                runs["reference", RUNS[name][0]].final_lora, name)


@pytest.mark.parametrize("bits", ["split", "split int8"])
def test_generative_split_spmd_is_the_sequential_run(runs, bits):
    seq, spmd = runs[bits], runs[f"{bits} spmd"]
    assert [h.loss for h in spmd.history] == [h.loss for h in seq.history]
    for x, y in zip(tree_lib.leaves(spmd.final_lora),
                    tree_lib.leaves(seq.final_lora)):
        assert torch.equal(x, y)


def test_generative_kd_raises_value_error_in_both_packages():
    """The reference's KD round over generative logits fails at b4 (its
    einsum over a (C, N, S, V) stack); the port's aggregate_knowledge
    raises ValueError there too, and on the stack itself."""
    cfg, pub, clients, test = _data()
    pub = {k: v[:16] for k, v in pub.items()}
    fed = dict(framework="kd", rounds=1, lora_rank=RANK, lora_dropout=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError):
            ref_run(ref_tiny(), RefFedConfig(**fed), pub, clients, test,
                    task=GEN, batch_size=16, eval_batch=64)
    with pytest.raises(ValueError, match=r"not \(C, N, D\)"):
        run_federated(cfg, FedConfig(**fed), pub, clients, test, task=GEN,
                      batch_size=16, eval_batch=64, device="cpu")
    with pytest.raises(ValueError):
        kd.aggregate_knowledge([torch.zeros(4, 3, 7)] * 2)


@pytest.mark.parametrize("topk,bits", [(5, 8), (5, 0), (0, 8)])
def test_compress_for_wire_over_lm_logits_matches_reference(topk, bits):
    """The b3 upload over (N, S, V) knowledge, top-k and levels along V,
    as the reference's (bit for bit: the twins round as the reference)."""
    from repro.core import kd as ref_kd
    logits = np.random.default_rng(3).standard_normal((4, 3, 50)).astype(
        np.float32) * 3
    fed = dict(logit_topk=topk, logit_quant_bits=bits)
    want, want_wire = ref_kd.compress_for_wire(jnp.asarray(logits),
                                               RefFedConfig(**fed))
    got, wire = kd.compress_for_wire(torch.from_numpy(logits),
                                     FedConfig(**fed))
    assert wire == want_wire == kd.logit_wire_bytes(logits.shape,
                                                    FedConfig(**fed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
