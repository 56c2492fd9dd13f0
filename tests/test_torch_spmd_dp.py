"""The port's stacked-client backend (``backend="spmd"``) under DP-SGD,
heterogeneous client ranks and async aggregation, against the
reference's ``spmd`` runs on the CPU.

- Row 14ᶜ's twin (``ref.clip_mean_rows_clients``, through
  ``ops.clip_mean_rows_clients`` and privacy/dp.clipped_grad_mean_clients)
  against the reference's ``jax.vmap`` over clients of
  ``clipped_grad_mean`` with its Pallas kernel in interpret mode: atol
  1e-6 (the reference's bar for its clip kernel).
- The stacked DP step's per-example rows (core/fedavg's
  ``per_example_grads_clients``, one batched pass of 3 clients x 3
  examples) against the reference's ``vmap`` over clients of its
  per-example ``vmap`` (policy ``xla``) on the dense, hybrid and RWKV-6
  tiny models: each row within ROWS_RTOL relative L2 (fp32 sums of the
  same products in another order; below 1e-4 on all three on the CPU),
  the losses within 1e-5, and bit for bit
  the port's one-client ``per_example_grads`` of each client.
- End to end on the model of tests/test_population.py (d 32, 2 layers,
  4 clients of 24 rows, batch 8), from the reference's weights and LoRA
  draws bridged: FedLLM and KD (top-8 int8) with DP-SGD (clip 0.5, noise
  0) and secure aggregation, FedLLM with client ranks (zeropad and svd)
  and FedLLM async (``max_staleness`` 2 over 4 rounds, secure
  aggregation), each against the reference's ``spmd`` run: ledger by
  name and per client and round, client FLOPs and epsilon exactly; round
  loss and accuracy within 1e-3; the final LoRA within atol 5e-5 / rtol
  5e-4 (svd's through its deltas).  Async at ``max_staleness`` 0 under
  ``spmd`` is the sync ``spmd`` run bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.configs.recurrentgemma_2b import config as ref_rg2b  # noqa: E402
from repro.configs.rwkv6_1_6b import config as ref_rwkv  # noqa: E402
from repro.core import tasks as ref_tasks  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.data.population import ClientPopulation  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro.privacy import dp as ref_dp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import (FedConfig, ModelConfig,  # noqa: E402
                                      PrivacyConfig)
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import \
    recurrentgemma_2b  # noqa: E402
from repro_torch.configs.rwkv6_1_6b import rwkv6_1_6b  # noqa: E402
from repro_torch.core import fed_spmd  # noqa: E402
from repro_torch.core.fedavg import make_fns, to_device  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.data.loader import epoch_batches  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402
from repro_torch.privacy import dp  # noqa: E402

CFG = dict(name="pop-t", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv_heads=2, d_ff=64, vocab_size=192, qkv_bias=True,
           activation="gelu", norm="layernorm", use_rope=False,
           max_position_embeddings=64)
SEED, RANK, ALPHA, CLIP = 0, 4, 32.0, 0.5
TARGETS = ("wq", "wk", "wv")
FED = dict(n_clients=4, rounds=2, lora_rank=RANK, lora_dropout=0.0,
           kd_epochs=1, seed=SEED, backend="spmd")
RUNS = {
    "fedllm-dp": dict(framework="fedllm",
                      privacy=dict(dp_clip=CLIP, secure_agg=True)),
    "kd-dp": dict(framework="kd", logit_topk=8, logit_quant_bits=8,
                  privacy=dict(dp_clip=CLIP, secure_agg=True)),
    "fedllm-zeropad": dict(framework="fedllm", client_ranks=(4, 2, 4, 1)),
    "fedllm-svd": dict(framework="fedllm", client_ranks=(1, 2, 4, 2),
                       hetero_agg="svd"),
    "fedllm-async": dict(framework="fedllm", aggregation="async",
                         max_staleness=2, rounds=4,
                         privacy=dict(secure_agg=True)),
}
ROWS_RTOL = 2e-4
LORA_TOL = dict(atol=5e-5, rtol=5e-4)


def _data():
    pub = banking77.generate(24, CFG["vocab_size"], 12, seed=0)
    tr = banking77.generate(96, CFG["vocab_size"], 12, seed=1)
    te = banking77.generate(16, CFG["vocab_size"], 12, seed=2)
    return pub, partition.iid_partition(tr, 4, seed=0), te


def _initial(params, fed):
    """The reference's initial LoRA state for ``fed`` (FedLLM's PRNGKey(seed
    + 1) draw; KD's fold_in(PRNGKey(seed + 2), ci) at each client's rank
    and fold_in(., 999) for the server), bridged."""
    def draw(key, rank=RANK):
        lt = ref_lora.init_lora(key, params, TARGETS, rank, ALPHA)
        return bridge.lora_from_reference(jax.tree.map(np.asarray, lt),
                                          "cpu")

    if fed["framework"] == "fedllm":
        return draw(jax.random.PRNGKey(SEED + 1))
    key = jax.random.PRNGKey(SEED + 2)
    ranks = fed.get("client_ranks") or (RANK,) * FED["n_clients"]
    return {"clients": [draw(jax.random.fold_in(key, ci), r)
                        for ci, r in enumerate(ranks)],
            "server": draw(jax.random.fold_in(key, 999))}


def _configs(case):
    kw = dict(FED, **RUNS[case])
    priv = kw.pop("privacy", None)
    return (RefFedConfig(**kw, **({"privacy": RefPrivacy(**priv)}
                                  if priv else {})),
            FedConfig(**kw, **({"privacy": PrivacyConfig(**priv)}
                               if priv else {})))


@pytest.fixture(scope="module")
def runs():
    """{case: (reference spmd result, port spmd result)} for RUNS, and
    "sync" / "async0": the port's 2-round FedLLM spmd runs, sync and
    async at max_staleness 0."""
    pub, clients, test = _data()
    params = jax.tree.map(np.asarray, ref_build(RefModelConfig(**CFG)).init(
        jax.random.PRNGKey(SEED)))
    base = bridge.params_from_reference(params, "cpu")
    out = {}
    for case in RUNS:
        ref_fed, fed = _configs(case)
        ref = ref_run(RefModelConfig(**CFG), ref_fed, pub,
                      ClientPopulation.from_clients_data(clients), test,
                      batch_size=8, eval_batch=16)
        port = run_federated(ModelConfig(**CFG), fed, pub, clients, test,
                             batch_size=8, eval_batch=16, device="cpu",
                             base=base, lora=_initial(params, RUNS[case]))
        out[case] = (ref, port)
    lora = _initial(params, {"framework": "fedllm"})
    for tag, agg in (("sync", "sync"), ("async0", "async")):
        out[tag] = run_federated(
            ModelConfig(**CFG), FedConfig(**dict(FED, aggregation=agg,
                                                 max_staleness=0)),
            pub, clients, test, batch_size=8, eval_batch=16, device="cpu",
            base=base, lora=lora)
    return out


# --------------------------------------------------------------------------- #
# Row 14ᶜ's twin
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("C,B,P,clip", [(3, 8, 384, 1.0), (2, 5, 257, 0.5),
                                        (4, 16, 1000, 20.0)])
def test_clip_mean_rows_clients_matches_vmapped_reference(C, B, P, clip):
    """Each client's clipped mean against the reference's ``jax.vmap`` of
    ``clipped_grad_mean`` over the client axis (its Pallas clip kernel in
    interpret mode under the vmap); rows straddle the clip and client 1
    holds a zero row (the EPS guard)."""
    rng = np.random.default_rng(C * 100 + B)
    g = rng.standard_normal((C, B, P)).astype(np.float32) * 3.0
    g *= np.linspace(0.2, 2.0, B, dtype=np.float32)[None, :, None]
    g[1, 2] = 0.0
    with jax_ops.policy_scope("pallas"):
        want = np.asarray(jax.vmap(
            lambda x: ref_dp.clipped_grad_mean(x, clip))(jnp.asarray(g)))
    got = ref.clip_mean_rows_clients(torch.tensor(g), clip)
    assert got.shape == (C, P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    with ops.policy_scope("auto"):
        via_ops = dp.clipped_grad_mean_clients(torch.tensor(g), clip)
    assert torch.equal(via_ops, got)
    for c in range(C):
        np.testing.assert_allclose(
            got[c].numpy(), ref.clip_mean_rows_ref(torch.tensor(g[c]),
                                                   clip).numpy(),
            atol=1e-7, rtol=0)


# --------------------------------------------------------------------------- #
# The stacked DP step's per-example rows on every family
# --------------------------------------------------------------------------- #
FAMILIES = {
    "gpt2": (ref_tiny, gpt2_tiny),
    "recurrentgemma": (lambda: ref_rg2b().reduced(n_layers=3, d_model=64),
                       lambda: recurrentgemma_2b().reduced(n_layers=3,
                                                           d_model=64)),
    "rwkv6": (lambda: ref_rwkv().reduced(n_layers=2, d_model=64),
              lambda: rwkv6_1_6b().reduced(n_layers=2, d_model=64)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_example_rows_of_stacked_clients_match_reference(family):
    """3 clients, each its own LoRA (the reference's draw plus noise, so B
    is not zero) and 3 examples of its own: the stacked pass's (C, B, P)
    rows and (C, B) losses against the reference's vmap over clients of
    its per-example vmap, and each client's against the port's one-client
    per_example_grads, bit for bit."""
    C, B = 3, 3
    make_ref, make_port = FAMILIES[family]
    rcfg = dataclasses.replace(make_ref(), kernel_policy="xla")
    pcfg = dataclasses.replace(make_port(), kernel_policy="torch")
    params = jax.tree.map(np.asarray, ref_build(rcfg).init(
        jax.random.PRNGKey(0)))
    targets = lora_lib.default_targets(pcfg)
    rng = np.random.default_rng(0)
    lts = [jax.tree.map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.05).astype(
            np.float32),
        jax.tree.map(np.asarray, ref_lora.init_lora(
            jax.random.PRNGKey(1 + c), params, targets, RANK, ALPHA)))
        for c in range(C)]
    _, train, _ = banking77.paper_splits(pcfg.vocab_size, pad_len=24,
                                         scale=0.04)
    batch = next(iter(epoch_batches(train, C * B, seed=0)))

    model = ref_build(rcfg)
    task_loss = ref_tasks.get_loss_fn("classification")
    jparams = jax.tree.map(jnp.asarray, params)

    def example_loss(lt, example):
        one = jax.tree.map(lambda x: x[None], example)
        logits, aux = model.forward(ref_lora.bind(jparams, lt, ALPHA, RANK),
                                    one)
        return task_loss(logits, one)[0] + aux

    losses, per_ex = jax.vmap(lambda lt, b: jax.vmap(
        jax.value_and_grad(example_loss), in_axes=(None, 0))(lt, b))(
        jax.tree.map(lambda *x: jnp.stack(x), *lts),
        {k: jnp.asarray(v.reshape(C, B, *v.shape[1:]))
         for k, v in batch.items()})
    want = torch.stack([torch.stack([torch.cat([
        t.reshape(-1) for t in tree_lib.leaves(bridge.lora_from_reference(
            jax.tree.map(lambda x: np.asarray(x[c, b]), per_ex), "cpu",
            pcfg))]) for b in range(B)]) for c in range(C)])

    fns = make_fns(build_model(pcfg), FedConfig(
        lora_rank=RANK, lora_dropout=0.0, privacy=PrivacyConfig(dp_clip=1.0)))
    base = bridge.params_from_reference(params, "cpu")
    port_lts = [bridge.lora_from_reference(lt, "cpu", pcfg) for lt in lts]
    got_losses, rows = fns["per_example_grads_clients"](
        base, fed_spmd.stack_trees(port_lts), to_device(batch, "cpu"))
    assert rows.shape == want.shape and got_losses.shape == (C, B)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(losses),
                               atol=1e-5, rtol=0)
    rel = (rows - want).norm(dim=2) / want.norm(dim=2)
    assert float(rel.max()) <= ROWS_RTOL, rel
    for c in range(C):
        one = to_device({k: v[c * B:(c + 1) * B] for k, v in batch.items()},
                        "cpu")
        c_losses, c_rows = fns["per_example_grads"](base, port_lts[c], one)
        assert torch.equal(rows[c], c_rows)
        assert torch.equal(got_losses[c], c_losses)


# --------------------------------------------------------------------------- #
# End to end against the reference's spmd runs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(RUNS))
def test_spmd_ledger_flops_and_epsilon_equal_reference(runs, case):
    ref, port = runs[case]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.epsilon == hr.epsilon
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
    if "privacy" in RUNS[case]:
        assert port.ledger.by_name()["secagg_keys"] > 0
    if RUNS[case].get("aggregation") == "async":
        assert port.ledger.by_name()["secagg_recovery"] > 0


def _deltas(leaves):
    return [np.einsum("...dr,...rf->...df", np.float64(a), np.float64(b))
            for a, b in zip(leaves[::2], leaves[1::2])]


@pytest.mark.parametrize("case", list(RUNS))
def test_spmd_rounds_and_final_lora_close_to_reference(runs, case):
    ref, port = runs[case]
    assert len(port.history) == len(ref.history) == \
        RUNS[case].get("rounds", FED["rounds"])
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    got = jax.tree.leaves(bridge.lora_to_reference(port.final_lora))
    want = [np.asarray(x) for x in jax.tree.leaves(ref.final_lora)]
    assert [g.shape for g in got] == [w.shape for w in want]
    if RUNS[case].get("hetero_agg") == "svd":
        got, want = _deltas(got), _deltas(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **LORA_TOL)


def test_spmd_dp_clip_binds_at_noise_zero(runs):
    """The clip binds (the run without it ends elsewhere), and noise 0
    claims no guarantee: epsilon inf."""
    _, port = runs["fedllm-dp"]
    plain = runs["sync"]
    assert all(h.epsilon == float("inf") for h in port.history)
    assert any(not torch.equal(x, y) for x, y in zip(
        tree_lib.leaves(port.final_lora), tree_lib.leaves(plain.final_lora)))


def test_spmd_async_at_zero_staleness_is_sync_bit_for_bit(runs):
    sync, async0 = runs["sync"], runs["async0"]
    assert [(h.loss, h.accuracy) for h in async0.history] == \
        [(h.loss, h.accuracy) for h in sync.history]
    assert async0.ledger.by_name() == sync.ledger.by_name()
    assert async0.ledger.per_client_round() == sync.ledger.per_client_round()
    assert async0.client_flops == sync.client_flops
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(async0.final_lora), tree_lib.leaves(sync.final_lora)))


def test_spmd_async_stacks_only_the_ready_set(runs):
    """Under async a round's stacked programs take only the clients that
    start a job: each round's downloads are the starters', fewer than the
    fleet after round 0."""
    _, port = runs["fedllm-async"]
    downs = {}
    for e in port.ledger.events:
        if e.name == "lora_params" and e.direction == "down":
            downs.setdefault(e.round, []).append(e.client)
    assert downs[0] == list(range(FED["n_clients"]))
    assert any(len(v) < FED["n_clients"] for r, v in downs.items() if r)


def test_spmd_ranks_stack_truncated_trees_contiguous(runs):
    """Client ranks below the global one: each bucket's truncated trees
    stack into contiguous factors, and every client uploads its own
    rank's tree."""
    _, port = runs["fedllm-zeropad"]
    ranks = RUNS["fedllm-zeropad"]["client_ranks"]
    up = {ci: sum(e.bytes for e in port.ledger.events if e.client == ci
                  and e.name == "lora_params" and e.direction == "up")
          for ci in range(FED["n_clients"])}
    for ci, r in enumerate(ranks):
        assert up[ci] * RANK == up[0] * r
    lt = lora_lib.maybe_truncate_rank(port.final_lora, 2, RANK)
    stacked = fed_spmd.stack_trees([lt, lt])
    assert all(t.is_contiguous() for t in tree_lib.leaves(stacked))


class _AuxGrad:
    """A model whose aux term depends on the batch through the LoRA
    leaves: it mixes the examples."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def forward(self, params, batch):
        logits, aux = self.model.forward(params, batch)
        return logits, aux + 1e-3 * logits.float().pow(2).mean()


def test_stacked_dp_step_keeps_padded_clients_and_refuses_mixing_aux():
    """Under DP a client whose step is padding keeps its LoRA and Adam
    state, the stepping client takes the one-client DP step (the same
    bits); a model whose aux term carries a gradient is refused."""
    cfg = ModelConfig(**CFG)
    model = build_model(cfg)
    fed = FedConfig(**dict(FED, privacy=PrivacyConfig(dp_clip=CLIP)))
    fns = make_fns(model, fed)
    base = model.init(torch.Generator().manual_seed(0), "cpu")
    lora = lora_lib.init_lora(torch.Generator().manual_seed(1), base, TARGETS,
                              RANK, ALPHA)
    _, clients, _ = _data()
    batches, _, _ = fed_spmd.stack_client_batches(clients[:2], 8, [997])
    batch = fed_spmd.step_batch(to_device(batches, "cpu"), 0)
    slt = fed_spmd.stack_for_clients(lora, 2)
    sopt = fed_spmd.stack_for_clients(fns["opt_init"](lora), 2)
    new, opt, loss = fns["train_step_clients"](base, slt, sopt, batch, None,
                                               [True, False])
    assert opt["step"].tolist() == [1, 0] and loss.shape == (2,)
    one, _, one_loss = fns["train_step"](
        base, lora, fns["opt_init"](lora),
        to_device({k: v[0, 0] for k, v in batches.items()}, "cpu"))
    assert torch.equal(loss[0], one_loss)
    for x, y, z in zip(tree_lib.leaves(new), tree_lib.leaves(one),
                       tree_lib.leaves(slt)):
        assert torch.equal(x[0], y) and torch.equal(x[1], z[1])
    with pytest.raises(ValueError, match="aux"):
        make_fns(_AuxGrad(model), fed)["train_step_clients"](
            base, slt, sopt, batch, None, [True, True])
