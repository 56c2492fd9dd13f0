"""The port's async aggregation (``FedConfig(aggregation="async")``,
core/async_agg.py and round_program.AsyncSchedule) against the
reference's, on the CPU: the participation schedule draw for draw, the
staleness weights and the staleness-weighted, rank-aware FedAvg on
seeded trees; FedLLM (uniform ranks) and Split-FedLLM (client ranks 2, 4,
4, zeropad; split at layer 2, fp32 boundary) over 4 async rounds with
``max_staleness`` 2 and secure aggregation at the verify-skill
configuration (``gpt2_tiny``, ``paper_splits(scale=0.04, pad_len=24)``,
3 IID clients, rank 4, dropout 0), from the reference's initial weights
bridged; and ``max_staleness`` 0, which must give the port's own sync run
bit for bit (KD-FedLLM: tests/test_torch_async_kd.py).

At seed 0 the schedule (seeded 17) starts client 0's job in round 0 with
a delay of 3, so it arrives in round 3 beyond ``max_staleness`` and is
discarded, and client 2's arrives in round 2 at staleness 2 and is kept:
each round's secure-aggregation event recovers the masks of the members
its start cohort is missing.  The masks, the start rounds (``secagg_start``)
they are keyed by and the discarded uploads must be the reference's
exactly (uint64); ledger bytes and client FLOPs exactly; round loss and
accuracy within 1e-3; the final LoRA within atol 5e-5 / rtol 5e-4."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core import async_agg as ref_async  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro.privacy import secure_agg as ref_secure_agg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core import async_agg  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.privacy import secure_agg  # noqa: E402

SEED, RANK, ALPHA = 0, 4, 32.0
TARGETS = ("wq", "wk", "wv")
ASYNC = dict(aggregation="async", max_staleness=2, rounds=4)
RUNS = {"fedllm": dict(framework="fedllm", **ASYNC),
        "split": dict(framework="split", client_ranks=(2, 4, 4), **ASYNC)}
LORA_KEY = {"fedllm": SEED + 1, "split": SEED + 3}


# --------------------------------------------------------------------------- #
# The schedule, the weights and the combine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,n,staleness", [(17, 3, 2), (3, 5, 4),
                                              (0, 4, 0), (20, 8, 1)])
def test_participation_schedule_is_the_reference_draw_for_draw(seed, n,
                                                               staleness):
    got = async_agg.ParticipationSchedule(n, seed, staleness)
    want = ref_async.ParticipationSchedule(n, seed, staleness)
    np.testing.assert_array_equal(got.slowness, want.slowness)
    assert [[got.next_delay(ci) for _ in range(12)] for ci in range(n)] == \
        [[want.next_delay(ci) for _ in range(12)] for ci in range(n)]


def test_staleness_weight_matches_reference():
    for s in range(6):
        for decay in (0.0, 0.5, 0.7, 2.0):
            assert async_agg.staleness_weight(s, decay) == \
                ref_async.staleness_weight(s, decay)


def _ref_tree(seed, rank):
    rng = np.random.default_rng(seed)
    return {"blocks": ({"attn": {t: {
        "a": rng.standard_normal((2, 16, rank)).astype(np.float32),
        "b": rng.standard_normal((2, rank, 12)).astype(np.float32) * 0.1}
        for t in TARGETS}},)}


@pytest.mark.parametrize("hetero_agg", ["zeropad", "svd"])
@pytest.mark.parametrize("absent", [0.0, 7.0])
def test_stale_weighted_avg_matches_reference(hetero_agg, absent):
    """Arrivals of ranks 4, 2 and 4 at staleness 0, 2 and 1, with and
    without absent data weight anchored on the global tree: the
    reference's combine_arrivals under robust_agg "mean" (svd's through
    its deltas; the robust combines: tests/test_torch_faults.py)."""
    fed = FedConfig(lora_rank=4, hetero_agg=hetero_agg, staleness_decay=0.5)
    ref_fed = RefFedConfig(lora_rank=4, hetero_agg=hetero_agg,
                           staleness_decay=0.5)
    ranks = [4, 2, 4]
    glob = _ref_tree(0, 4)
    trees = [_ref_tree(1 + ci, r) for ci, r in enumerate(ranks)]
    arrivals = [(ci, trees[ci], s, w) for ci, s, w in
                ((0, 0, 3.0), (1, 2, 5.0), (2, 1, 2.0))]
    total = 10.0 + absent
    want = jax.tree.leaves(ref_async.combine_arrivals(
        glob, arrivals, total, ref_fed, ranks))
    got = async_agg.stale_weighted_avg(
        bridge.lora_from_reference(glob, "cpu"),
        [(ci, bridge.lora_from_reference(t, "cpu"), s, w)
         for ci, t, s, w in arrivals], total, fed, ranks)
    got = jax.tree.leaves(bridge.lora_to_reference(got))
    want = [np.asarray(x) for x in want]
    if hetero_agg == "svd":
        got, want = ([np.einsum("...dr,...rf->...df", np.float64(a),
                                np.float64(b))
                      for a, b in zip(x[::2], x[1::2])] for x in (got, want))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------- #
# FedLLM and Split, async with secure aggregation, against the reference
# --------------------------------------------------------------------------- #
def _data():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    return cfg, pub, partition.iid_partition(train, 3), test


def _spy_secagg(session_cls, seen):
    """Wraps ``session_cls``' deliver and discard to record, in call order,
    each aggregation event's (round, [(start, client, pairwise mask sum
    as uint64)]) and each discarded (start, client)."""
    deliver, discard = session_cls.deliver, session_cls.discard

    def spy_deliver(self, ledger, rnd, delivered):
        if self.enabled:
            delivered = list(delivered)
            seen.append(("deliver", rnd, [
                (start, ci, (self.masked(start, ci)
                             - self._padded(start, ci)).tobytes())
                for start, ci in delivered]))
        return deliver(self, ledger, rnd, delivered)

    def spy_discard(self, start, ci):
        if self.enabled:
            seen.append(("discard", start, ci))
        return discard(self, start, ci)

    session_cls.deliver, session_cls.discard = spy_deliver, spy_discard
    return lambda: (setattr(session_cls, "deliver", deliver),
                    setattr(session_cls, "discard", discard))


@pytest.fixture(scope="module")
def runs():
    """{case: (reference result, port result, reference secure-agg events,
    port events)} for RUNS with secure aggregation, and under
    "<framework> sync" / "<framework> async0" the port's sync run and its
    async run at max_staleness 0 (2 rounds, no secure aggregation)."""
    cfg, pub, clients, test = _data()
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    base = bridge.params_from_reference(params, "cpu")
    out = {}
    for name, extra in RUNS.items():
        kw = dict(lora_rank=RANK, lora_dropout=0.0, seed=SEED, split_layer=2,
                  **extra)
        lora = bridge.lora_from_reference(jax.tree.map(
            np.asarray, ref_lora.init_lora(jax.random.PRNGKey(LORA_KEY[name]),
                                           params, TARGETS, RANK, ALPHA)),
            "cpu")
        ref_seen, port_seen = [], []
        undo = [_spy_secagg(ref_secure_agg.SecureAggSession, ref_seen),
                _spy_secagg(secure_agg.SecureAggSession, port_seen)]
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                ref = ref_run(ref_tiny(), RefFedConfig(
                    **kw, privacy=RefPrivacy(secure_agg=True)), pub, clients,
                    test, batch_size=16, eval_batch=64)
            port = run_federated(cfg, FedConfig(
                **kw, privacy=PrivacyConfig(secure_agg=True)), pub, clients,
                test, batch_size=16, eval_batch=64, device="cpu", base=base,
                lora=lora)
        finally:
            for u in undo:
                u()
        out[name] = (ref, port, ref_seen, port_seen)
        for tag, agg in (("sync", "sync"), ("async0", "async")):
            fed = FedConfig(**dict(kw, rounds=2, aggregation=agg,
                                   max_staleness=0))
            out[f"{name} {tag}"] = run_federated(
                cfg, fed, pub, clients, test, batch_size=16, eval_batch=64,
                device="cpu", base=base, lora=lora)
    return out


@pytest.mark.parametrize("case", list(RUNS))
def test_async_ledger_and_flops_equal(runs, case):
    """Starters download, every arrival uploads (a discarded one too),
    secure aggregation charges keys a cohort and recovery shares for the
    members an event misses: the reference's bytes."""
    ref, port, _, _ = runs[case]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
    assert port.ledger.by_name()["secagg_recovery"] > 0


@pytest.mark.parametrize("case", list(RUNS))
def test_async_secure_agg_masks_and_starts_equal(runs, case):
    """Every aggregation event delivers the same (start round, client)
    uploads with the same pairwise masks, and the same stale upload is
    discarded: client 0's job of round 0, arriving in round 3."""
    _, _, ref_seen, port_seen = runs[case]
    assert port_seen == ref_seen
    assert ("discard", 0, 0) in port_seen
    kept = [(rnd, start, ci) for kind, rnd, got in port_seen
            if kind == "deliver" for start, ci, _ in got]
    assert (2, 0, 2) in kept                       # staleness 2, kept


@pytest.mark.parametrize("case", list(RUNS))
def test_async_rounds_and_final_lora_close(runs, case):
    ref, port, _, _ = runs[case]
    assert len(port.history) == len(ref.history) == 4
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    got = jax.tree.leaves(bridge.lora_to_reference(port.final_lora))
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref.final_lora))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("case", list(RUNS))
def test_async_at_zero_staleness_is_sync_bit_for_bit(runs, case):
    sync, async0 = runs[f"{case} sync"], runs[f"{case} async0"]
    assert [(h.loss, h.accuracy) for h in async0.history] == \
        [(h.loss, h.accuracy) for h in sync.history]
    assert async0.ledger.by_name() == sync.ledger.by_name()
    assert async0.ledger.per_client_round() == sync.ledger.per_client_round()
    assert async0.client_flops == sync.client_flops
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(async0.final_lora), tree_lib.leaves(sync.final_lora)))


@pytest.mark.parametrize("case", list(RUNS))
def test_async_under_spmd_matches_sequential(runs, case):
    """``backend="spmd"`` stacks each round's ready set (the clients
    that start a job): the sequential async run's ledger, FLOPs, secure
    aggregation and discards exactly, its rounds within 1e-3 and its
    final LoRA within atol 5e-5 / rtol 5e-4 (the spmd run against the
    reference's: tests/test_torch_spmd_dp.py)."""
    cfg, pub, clients, test = _data()
    _, seq, _, seq_seen = runs[case]
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    lora = bridge.lora_from_reference(jax.tree.map(
        np.asarray, ref_lora.init_lora(jax.random.PRNGKey(LORA_KEY[case]),
                                       params, TARGETS, RANK, ALPHA)), "cpu")
    seen = []
    undo = _spy_secagg(secure_agg.SecureAggSession, seen)
    try:
        spmd = run_federated(cfg, FedConfig(
            lora_rank=RANK, lora_dropout=0.0, seed=SEED, split_layer=2,
            backend="spmd", privacy=PrivacyConfig(secure_agg=True),
            **RUNS[case]), pub, clients, test, batch_size=16, eval_batch=64,
            device="cpu", base=bridge.params_from_reference(params, "cpu"),
            lora=lora)
    finally:
        undo()
    assert seen == seq_seen
    assert spmd.ledger.by_name() == seq.ledger.by_name()
    assert spmd.ledger.per_client_round() == seq.ledger.per_client_round()
    assert spmd.client_flops == seq.client_flops
    for hp, hs in zip(spmd.history, seq.history):
        assert abs(hp.loss - hs.loss) <= 1e-3
        assert abs(hp.accuracy - hs.accuracy) <= 1e-3
    for x, y in zip(tree_lib.leaves(spmd.final_lora),
                    tree_lib.leaves(seq.final_lora)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=5e-5,
                                   rtol=5e-4)
