"""The port's MoE layer (models/moe.py) and the MoE families end to end
against the reference's, on the CPU.

``moe_fwd`` against the reference's under ``global`` and ``batched``
dispatch, at the default capacity factor and at 0.5, where experts
overflow and the kept tokens must be the reference's; router logits with
exact ties, where the picked experts must be the lower indices (as
``jax.lax.top_k`` picks them).  The DP-SGD step's per-example rows (each
example routed alone with its own aux term, as the reference's ``vmap``
of batch-1 passes gives it).  One split step with MoE layers on both
sides of the cut (the server half's aux term joins the loss, the client
half's does not), and the stacked clients' step of the ``spmd`` and
``cohort`` backends (each client routed alone with its own aux term, as
the reference's ``vmap`` over clients gives it), through their first
step's LoRA gradient and aux term.  Then one module fixture of paired
reference and port runs, one round each: FedLLM on reduced Mixtral
(``sequential``), DP-SGD on it (clip 0.5, secure aggregation; and a
port run from fp64 weights), FedLLM under ``spmd`` on it, and KD (top-8
int8) on reduced Qwen3-MoE (qk-norm, top 2 of 4 experts).

Tolerances: the layer atol 1e-5 / rtol 1e-4, its input gradient atol
1e-5 / rtol 1e-4; per-example rows, split and stacked gradients atol
1e-5 / rtol 1e-4 (fp32 sums in other orders); runs: ledger bytes and
client FLOPs exact, round loss within 1e-3, the final LoRA within atol
5e-5 / rtol 5e-4, DP's from the port's fp64 run as tests/test_torch_rwkv.py
judges it."""
import dataclasses
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
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.core import tasks as ref_tasks  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.core import fed_spmd, split, tasks  # noqa: E402
from repro_torch.core.fedavg import make_fns, to_device  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.data.loader import epoch_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common, moe, transformer  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

LAYER = dict(atol=1e-5, rtol=1e-4)
RANK, ALPHA = 4, 32.0
TARGETS = ("wq", "wk", "wv")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _cfgs(arch, d_model=64, **change):
    """(reference, port) configs of ``arch`` at ``reduced(d_model=...)``
    (2 layers, 4 experts, top 2), the reference's under its plain
    policy."""
    ref_cfg = dataclasses.replace(
        ref_registry.get_config(arch).reduced(d_model=d_model),
        kernel_policy="xla", **change)
    return ref_cfg, dataclasses.replace(
        registry.get_config(arch).reduced(d_model=d_model), **change)


def _dropped(routes, cfg, dispatch):
    """Assignments beyond their expert's capacity, from top-k ids (B, S,
    k), counted as the dispatch packs them."""
    B, S, k = routes.shape
    rows = routes.reshape(1, -1) if dispatch == "global" \
        else routes.reshape(B, -1)
    cap = moe.expert_capacity(rows.shape[1] // k, cfg)
    counts = np.stack([np.bincount(r, minlength=cfg.n_experts)
                       for r in rows])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("dispatch", ["global", "batched"])
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_fwd_matches_reference(dispatch, factor):
    """Output, aux and the input gradient of sum(out · r) + aux; at
    capacity factor 0.5 experts overflow, and a token kept or dropped
    otherwise than the reference's would change its output row."""
    ref_cfg, cfg = _cfgs("mixtral-8x7b", moe_dispatch=dispatch,
                         moe_capacity_factor=factor)
    p = _np(ref_moe.init_moe(jax.random.PRNGKey(0), ref_cfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def ref_obj(xj):
        out, aux = ref_moe.moe_fwd(p, ref_cfg, xj)
        return (out * r).sum() + aux, (out, aux)

    (_, (want, want_aux)), want_dx = jax.jit(jax.value_and_grad(
        ref_obj, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    with moe.trace_routes() as routes:
        got, aux = moe.moe_fwd(_torch(p), cfg, xt)
    (dx,) = torch.autograd.grad((got * torch.from_numpy(r)).sum() + aux, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LAYER)
    np.testing.assert_allclose(float(aux), float(want_aux), **LAYER)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **LAYER)
    dropped = _dropped(routes[0].numpy(), cfg, dispatch)
    assert (dropped > 0) == (factor < 1.0)


@pytest.mark.parametrize("dispatch", ["global", "batched"])
def test_router_ties_pick_lower_experts(dispatch):
    """Router logits with exact ties: a zero router (all E probabilities
    equal: every token to experts 0 and 1, which overflow) and a router
    whose expert-3 column copies expert 1's.  The picked experts are the
    reference's ``jax.lax.top_k`` ids, the lower index first, and the
    outputs the reference's."""
    ref_cfg, cfg = _cfgs("mixtral-8x7b", moe_dispatch=dispatch)
    p = _np(ref_moe.init_moe(jax.random.PRNGKey(2), ref_cfg))
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    copy = dict(p, router=p["router"].copy())
    copy["router"][:, 3] = copy["router"][:, 1]
    # one compile, reused for both routers
    @jax.jit
    def ref_fwd(params):
        xj = jnp.asarray(x)
        out = ref_moe.moe_fwd(params, ref_cfg, xj)
        probs = jax.nn.softmax(xj @ params["router"], axis=-1)
        return out, jax.lax.top_k(probs, cfg.top_k)[1]

    for params in (dict(p, router=np.zeros_like(p["router"])), copy):
        (want, want_aux), want_e = ref_fwd(params)
        with moe.trace_routes() as routes:
            got, aux = moe.moe_fwd(_torch(params), cfg, torch.from_numpy(x))
        np.testing.assert_array_equal(routes[0].numpy(), np.asarray(want_e))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
        np.testing.assert_allclose(float(aux), float(want_aux), **LAYER)
        assert (routes[0].numpy()[..., 0] < routes[0].numpy()[..., 1]
                ).any()


def _weights(arch, **change):
    """(reference configs, reference params, port base, a LoRA tree with
    non-zero B in both layouts) of the reduced ``arch``."""
    ref_cfg, cfg = _cfgs(arch, **change)
    params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(0)))
    lt = _np(ref_lora.init_lora(jax.random.PRNGKey(1), params, TARGETS,
                                RANK, ALPHA))
    rng = np.random.default_rng(4)
    lt = jax.tree.map(lambda t: (t + 0.05 * rng.standard_normal(t.shape)
                                 ).astype(np.float32), lt)
    return (ref_cfg, cfg, params, lt,
            bridge.params_from_reference(params, "cpu"),
            bridge.lora_from_reference(lt, "cpu", cfg))


def _ref_loss(ref_cfg, params, lt, batch):
    """The reference's per-example objective: the classification loss of
    ``batch`` plus the model's aux term."""
    model = ref_build(ref_cfg)
    loss_fn = ref_tasks.get_loss_fn("classification")
    params = jax.tree.map(jnp.asarray, params)

    def fn(l, b):
        logits, aux = model.forward(ref_lora.bind(params, l, ALPHA, RANK), b)
        return loss_fn(logits, b)[0] + aux
    return fn


def _batches(n):
    pub, train, _ = banking77.paper_splits(512, pad_len=24, scale=0.04)
    clients = partition.iid_partition(train, 3)
    return [next(iter(epoch_batches(c, n, seed=0))) for c in clients]


@pytest.mark.parametrize("dispatch", ["global", "batched"])
def test_per_example_rows_match_reference(dispatch):
    """DP-SGD's per-example gradient rows and losses on reduced Mixtral:
    the port's one batched pass (each row routed alone, its own aux term)
    against the reference's ``vmap`` of batch-1 value_and_grad."""
    ref_cfg, cfg, params, lt, base, plt = _weights("mixtral-8x7b",
                                                   moe_dispatch=dispatch)
    batch = _batches(4)[0]
    fn = _ref_loss(ref_cfg, params, lt, batch)

    def one(l, ex):
        return fn(l, jax.tree.map(lambda v: v[None], ex))

    want_loss, want = jax.jit(jax.vmap(jax.value_and_grad(one), (None, 0)))(
        lt, {k: jnp.asarray(v) for k, v in batch.items()})
    fed = FedConfig(lora_rank=RANK, lora_alpha=ALPHA, lora_dropout=0.0)
    fns = make_fns(build_model(cfg), fed)
    loss, rows = fns["per_example_grads"](base, plt, to_device(batch, "cpu"))
    # rows in the port's leaf order: the reference's batched gradient
    # tree bridged one example at a time
    want_rows = np.stack([np.concatenate([
        t.numpy().reshape(-1) for t in tree_lib.leaves(
            bridge.lora_from_reference(jax.tree.map(
                lambda g, i=i: np.asarray(g)[i], want), "cpu", cfg))])
        for i in range(4)])
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **LAYER)
    # the rows from the port's fp64 pass: the MoE experts at the
    # reference's init make the gradient ill-conditioned enough that
    # fp32 passes part by ~1e-3 in a few elements
    _, exact = fns["per_example_grads"](_fp64(base), _fp64(plt),
                                        to_device(batch, "cpu"))
    port_gap = _rel_l2([rows.numpy()], [exact.numpy()])
    ref_gap = _rel_l2([want_rows], [exact.numpy()])
    print(f"per-example rows, relative L2 from the port's fp64 pass: port "
          f"{port_gap:.3e}, reference {ref_gap:.3e}")
    assert port_gap <= 3.0 * ref_gap + 1e-6
    assert _rel_l2([rows.numpy()], [want_rows]) <= 1e-4
    # each example's aux term is in its loss
    with torch.no_grad(), ops.per_example_scope(4):
        _, aux = build_model(cfg).forward(lora_lib.bind(
            base, plt, ALPHA, RANK), to_device(batch, "cpu"))
    assert aux.shape == (4,) and bool((aux > 0).all())


def test_split_step_with_moe_on_both_sides():
    """One Split step on reduced Mixtral (2 MoE layers, split after layer
    1, width 128) against the reference's split step taken apart
    (tests/test_torch_split_family.py): the loss within 1e-5, the
    boundary h, the c4 gradient and each LoRA gradient leaf of both
    halves within relative L2 1e-5 (the MoE experts at the reference's
    init carry h to |h| ~ 20).  The loss is the task loss plus the
    server half's aux term alone: the client half's (non-zero) is
    dropped, as the reference drops it."""
    import test_torch_split_family as fam
    mp = pytest.MonkeyPatch()
    mp.setitem(fam.FAMILIES, "mixtral", (
        lambda: ref_registry.get_config("mixtral-8x7b"),
        lambda: registry.get_config("mixtral-8x7b"), TARGETS))
    try:
        sfns, halves, batch = fam.first_step("mixtral", 2, 1)
        ref_loss, ref_grads, ref_h, ref_hg, own = fam.ref_split_parts(
            "mixtral", 2, 1, batch)
        cfg = fam.cfgs("mixtral", 2)[1]
    finally:
        mp.undo()
    assert sfns["n_client_layers"] == 1
    base_c, base_s, c_lt, s_lt = halves
    batch = to_device(batch, "cpu")
    loss, c_grads, s_grads, h, h_grad = sfns["split_grads"](*halves, batch)
    assert abs(float(ref_loss) - float(own)) <= 1e-6
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    assert _rel_l2([h.numpy()], [ref_h]) <= 1e-5
    assert _rel_l2([h_grad.numpy()], [ref_hg]) <= 1e-5
    got = jax.tree.leaves(bridge.lora_to_reference(split.join_lora(
        tree_lib.unflatten(c_lt, c_grads),
        tree_lib.unflatten(s_lt, s_grads)), cfg))
    want = jax.tree.leaves(_np(ref_grads))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        if not np.any(w):                  # dA while B is 0
            np.testing.assert_array_equal(g, w)
        else:
            assert _rel_l2([g], [w]) <= 1e-5
    bound = lambda b, l: lora_lib.bind(b, l, ALPHA, RANK)  # noqa: E731
    with torch.no_grad():
        h, pos = transformer.embed_tokens(bound(base_c, c_lt), cfg,
                                          batch["tokens"])
        h, aux_c = transformer.forward_groups(bound(base_c, c_lt), cfg, h,
                                              pos, 0, 1)
        hs, aux_s = transformer.forward_groups(bound(base_s, s_lt), cfg, h,
                                               pos, 0, 1, include_tail=True)
        logits = transformer.lm_logits(
            bound(base_s, s_lt), cfg,
            common.apply_norm(cfg.norm, base_s["final_norm"], hs))
        task_loss = tasks.get_loss_fn("classification")(logits, batch)[0]
    assert float(aux_c) > 1e-3 and float(aux_s) > 1e-3
    np.testing.assert_allclose(float(loss), float(task_loss + aux_s),
                               atol=1e-6)
    assert abs(float(loss) - float(task_loss + aux_s + aux_c)) > 1e-4


@pytest.mark.parametrize("dispatch", ["global", "batched"])
def test_stacked_clients_step_matches_reference(dispatch):
    """The stacked clients' step that ``spmd`` runs and ``cohort`` runs a
    chunk at a time, on reduced Qwen3-MoE (qk-norm, top 2 of 4): each
    client's loss (task loss plus its own aux term) and LoRA gradient
    against the reference's value_and_grad of that client alone (what its
    ``vmap`` over clients computes); each client's aux term against the
    reference's forward of its batch.  Under ``global`` dispatch a client
    packs its own B·S tokens."""
    ref_cfg, cfg, params, lt, base, plt = _weights("qwen3-moe-235b-a22b",
                                                   moe_dispatch=dispatch)
    batches = _batches(4)
    C = len(batches)
    fn = _ref_loss(ref_cfg, params, lt, None)
    ref_model = ref_build(ref_cfg)
    # one compile each, reused for the C clients' batches of one shape
    value_and_grad = jax.jit(jax.value_and_grad(fn))
    pj = jax.tree.map(jnp.asarray, params)
    aux_of = jax.jit(lambda bj: ref_model.forward(
        ref_lora.bind(pj, lt, ALPHA, RANK), bj)[1])
    want_loss, want_grads, want_aux = [], [], []
    for b in batches:
        bj = {k: jnp.asarray(v) for k, v in b.items()}
        loss, g = value_and_grad(lt, bj)
        want_loss.append(float(loss))
        want_grads.append(g)
        want_aux.append(float(aux_of(bj)))
    stacked = {k: np.concatenate([b[k] for b in batches])
               for k in batches[0]}
    slt = fed_spmd.stack_trees([plt] * C)
    fed = FedConfig(lora_rank=RANK, lora_alpha=ALPHA, lora_dropout=0.0,
                    backend="cohort", cohort_size=C)
    model = build_model(cfg)
    loss, grads = make_fns(model, fed)["grads_clients"](
        base, slt, to_device(stacked, "cpu"))
    np.testing.assert_allclose(loss.numpy(), want_loss, **LAYER)
    for c, g in enumerate(fed_spmd.unstack_tree(grads)):
        want = tree_lib.leaves(bridge.lora_from_reference(
            _np(want_grads[c]), "cpu", cfg))
        for x, y in zip(tree_lib.leaves(g), want):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **LAYER)
    with torch.no_grad(), ops.clients_scope(C):
        _, aux = model.forward(lora_lib.bind(base, slt, ALPHA, RANK),
                               to_device(stacked, "cpu"))
    np.testing.assert_allclose(aux.numpy(), want_aux, **LAYER)
    # the clients' aux terms differ: one term over the stacked batch
    # would not be any of them
    assert len(set(np.round(want_aux, 7))) == C


# --------------------------------------------------------------------------- #
# Paired runs, one round each
# --------------------------------------------------------------------------- #
RUNS = {
    "fedllm": ("mixtral-8x7b", dict(framework="fedllm"), {}),
    "dp": ("mixtral-8x7b", dict(framework="fedllm"),
           dict(dp_clip=0.5, secure_agg=True)),
    "spmd": ("mixtral-8x7b", dict(framework="fedllm", backend="spmd"), {}),
    "kd": ("qwen3-moe-235b-a22b", dict(framework="kd", logit_topk=8,
                                       logit_quant_bits=8), {}),
}


def _fp64(tree):
    return tree_lib.map_(
        lambda t: t.double() if t.is_floating_point() else t, tree)


@pytest.fixture(scope="module")
def runs():
    """{case: (reference result, port result)} of RUNS at reduced(d_model
    64), 1 round, rank 4, dropout 0, batch 16, eval batch 64 on
    paper_splits(scale=0.04, pad_len=24) over 3 IID clients, each side
    from the reference's init and LoRA draws (KD: a tree a client and one
    for the server); "dp64" the port's DP run from fp64 copies."""
    pub, train, test = banking77.paper_splits(512, pad_len=24, scale=0.04)
    clients = partition.iid_partition(train, 3)
    out = {}
    for case, (arch, fed_kw, priv) in RUNS.items():
        ref_cfg, cfg = _cfgs(arch)
        params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(0)))

        def draw(key):
            return bridge.lora_from_reference(_np(ref_lora.init_lora(
                key, params, TARGETS, RANK, ALPHA)), "cpu", cfg)

        if fed_kw["framework"] == "kd":
            key = jax.random.PRNGKey(2)
            lora = {"clients": [draw(jax.random.fold_in(key, ci))
                                for ci in range(len(clients))],
                    "server": draw(jax.random.fold_in(key, 999))}
        else:
            lora = draw(jax.random.PRNGKey(1))
        kw = dict(rounds=1, lora_rank=RANK, lora_dropout=0.0, seed=0,
                  **fed_kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref = ref_run(dataclasses.replace(ref_cfg, kernel_policy="auto"),
                          RefFedConfig(**kw, privacy=RefPrivacy(**priv)),
                          pub, clients, test, batch_size=16, eval_batch=64)
        fed = FedConfig(**kw, privacy=PrivacyConfig(**priv))
        base = bridge.params_from_reference(params, "cpu")
        out[case] = (ref, run_federated(cfg, fed, pub, clients, test,
                                        batch_size=16, eval_batch=64,
                                        device="cpu", base=base, lora=lora))
        if case == "dp":
            out["dp64"] = run_federated(cfg, fed, pub, clients, test,
                                        batch_size=16, eval_batch=64,
                                        device="cpu", base=_fp64(base),
                                        lora=_fp64(lora))
    return out


def _rel_l2(got, want) -> float:
    num = sum(float(((np.float64(g) - np.float64(w)) ** 2).sum())
              for g, w in zip(got, want))
    return (num / sum(float((np.float64(w) ** 2).sum()) for w in want)) ** 0.5


@pytest.mark.parametrize("case", list(RUNS))
def test_runs_ledger_and_flops_equal(runs, case):
    ref, port = runs[case]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    assert port.client_flops and port.client_flops[0] > 0
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client


@pytest.mark.parametrize("case", list(RUNS))
def test_runs_rounds_and_final_lora_close(runs, case):
    """Each round's loss and accuracy within 1e-3; FedLLM's final LoRA
    (sequential and spmd) within atol 5e-5 / rtol 5e-4, DP's within 3x
    the reference's distance from the port's fp64 run (+1e-6) and
    within relative L2 1e-5 of the reference's."""
    ref, port = runs[case]
    assert len(port.history) == len(ref.history) == 1
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    if case == "kd":
        return
    cfg = _cfgs(RUNS[case][0])[1]
    got = jax.tree.leaves(bridge.lora_to_reference(port.final_lora, cfg))
    want = jax.tree.leaves(_np(ref.final_lora))
    assert len(got) == len(want) == 6
    if case != "dp":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)
        return
    exact = jax.tree.leaves(bridge.lora_to_reference(
        runs["dp64"].final_lora, cfg))
    assert all(x.dtype == np.float64 for x in exact)
    assert _rel_l2(got, exact) <= 3.0 * _rel_l2(want, exact) + 1e-6
    assert _rel_l2(got, want) <= 1e-5
