"""The port's fault tolerance against the reference's, on the CPU: the
seeded FaultPlan (faults/plan.py), the upload-seam finite check and norm
screen (faults/guard.py) that quarantine offenders, the quorum rollover,
the robust combines (core/fed_spmd.robust_client_combine, median,
trimmed_mean and norm_clip) and the zero-weight guards.

The paired runs take tests/test_faults.py's case study (``gpt2_tiny``,
``paper_splits(scale=0.04, pad_len=24)``, 3 IID clients, rank 4, dropout
0), the port from the reference's initial weights bridged, policy
``torch``, ``device="cpu"``:

- FedLLM, trimmed_mean (trim 0.34), dropout 0.3, stragglers 0.3 (a late
  upload arrives at staleness 2) and one ``nan`` client, 3 sync rounds;
- KD, top-k 8 int8, trimmed_mean, dropout 0.3 and one ``nan`` client, 2
  rounds;
- Split (fp32 boundary), async with ``max_staleness`` 2, trimmed_mean,
  the FedLLM run's dropout and stragglers and one ``sign_flip`` client, 3
  rounds;
- FedLLM under ``quorum`` 1.0 with dropout 0.5 and norm_clip, 3 rounds;
- FedLLM under the norm screen (``screen_factor`` 5) against a
  ``norm_inflation`` client at 1000 and median, 2 rounds;
- FedLLM streamed by the ``cohort`` executor in chunks of 2 (clients
  0-1, then 2), secure aggregation, trimmed_mean, quorum 0.5, dropout
  0.3 and one ``nan`` client, 3 rounds: the whole-round screen, the
  quarantine while the arrivals are grouped by masking cohort, the
  robust buffer of the streamed fold and the streamed rollover (rounds
  1 and 2 roll over);
- KD streamed likewise, a median teacher (the streamed robust buffer)
  and the norm screen (``screen_factor`` 5) against a
  ``norm_inflation`` client at 1000, dropout 0.3, 2 rounds: in round 0
  the inflated client shares its chunk with one honest client, so only
  the whole round's median norm can screen it out.

Each is held to the reference: ledger events exactly (round, client,
name, direction, bytes, hop) and rollovers equal; per-round loss and
accuracy within 1e-3 and the final LoRA within atol 5e-5 / rtol 5e-4
(KD's server LoRA at the bar tests/test_torch_kd.py holds its top-8 int8
run to).  The fault draws follow the reference's ``fold_in`` chain word
for word (core/rng.host_fold_rng), so the same uploads are dropped,
delayed and corrupted.  The port's kill-and-resume runs are
tests/test_torch_checkpoint.py's."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FaultConfig as RefFaultConfig  # noqa: E402
from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacyConfig  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core import fed_spmd as ref_fed_spmd  # noqa: E402
from repro.core import fedavg as ref_fedavg  # noqa: E402
from repro.core import kd as ref_kd  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.faults import guard as ref_guard  # noqa: E402
from repro.faults.plan import FaultPlan as RefFaultPlan  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import (FaultConfig, FedConfig,  # noqa: E402
                                      PrivacyConfig)
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core import async_agg, fed_spmd, fedavg, kd  # noqa: E402
from repro_torch.core import metrics as M  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.faults import guard  # noqa: E402
from repro_torch.faults.plan import BYZANTINE_MODES, FaultPlan  # noqa: E402

SEED, RANK, ALPHA = 0, 4, 32.0
TARGETS = ("wq", "wk", "wv")
NAN = dict(byzantine=1, byzantine_mode="nan")
TRIM = dict(robust_agg="trimmed_mean", trim_frac=0.34)
# fault seed 1 delays client 2's upload of round 0 by 2 rounds, so it
# arrives within the run (at staleness 2), beside dropped uploads and a
# corrupt client 1
LATE = dict(dropout_rate=0.3, straggler_rate=0.3, seed=1)
INFLATE = dict(byzantine=1, byzantine_mode="norm_inflation",
               byzantine_scale=1000.0)
# streamed in chunks of 2: clients 0 and 1, then 2
COHORT = dict(backend="cohort", cohort_size=2)
# case -> (FedConfig fields, FaultConfig fields)
CASES = {
    "fedllm": (dict(framework="fedllm", rounds=3, **TRIM),
               dict(**LATE, **NAN)),
    "kd": (dict(framework="kd", rounds=2, logit_topk=8, logit_quant_bits=8,
                **TRIM), dict(dropout_rate=0.3, **NAN)),
    "split": (dict(framework="split", rounds=3, aggregation="async",
                   max_staleness=2, **TRIM),
              dict(**LATE, byzantine=1)),
    "quorum": (dict(framework="fedllm", rounds=3, quorum=1.0,
                    robust_agg="norm_clip"), dict(dropout_rate=0.5)),
    "screen": (dict(framework="fedllm", rounds=2, screen_factor=5.0,
                    robust_agg="median"), INFLATE),
    "fedllm cohort": (dict(framework="fedllm", rounds=3, quorum=0.5,
                           secure_agg=True, **COHORT, **TRIM),
                      dict(dropout_rate=0.3, **NAN)),
    "kd cohort": (dict(framework="kd", rounds=2, screen_factor=5.0,
                       robust_agg="median", **COHORT),
                  dict(dropout_rate=0.3, **INFLATE)),
}
LORA_KEY = {"fedllm": SEED + 1, "split": SEED + 3}


def _fields(case):
    """(FedConfig fields but privacy, FaultConfig fields, secure_agg)."""
    fed, faults = CASES[case]
    fed = dict(fed)
    secagg = fed.pop("secure_agg", False)
    return dict(n_clients=3, lora_rank=RANK, lora_dropout=0.0, split_layer=2,
                kd_epochs=1, seed=SEED, **fed), faults, secagg


def _data():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    return cfg, pub, partition.iid_partition(train, 3), test


def _to_port(tree):
    return bridge.lora_from_reference(jax.tree.map(np.asarray, tree), "cpu")


def _bridged(params, framework):
    """The reference's initial LoRA state for ``framework``, bridged."""
    if framework == "kd":
        key = jax.random.PRNGKey(SEED + 2)
        draw = [ref_lora.init_lora(jax.random.fold_in(key, i), params,
                                   TARGETS, RANK, ALPHA) for i in (0, 1, 2)]
        server = ref_lora.init_lora(jax.random.fold_in(key, 999), params,
                                    TARGETS, RANK, ALPHA)
        return {"clients": [_to_port(t) for t in draw],
                "server": _to_port(server)}
    return _to_port(ref_lora.init_lora(jax.random.PRNGKey(LORA_KEY[framework]),
                                       params, TARGETS, RANK, ALPHA))


@pytest.fixture(scope="module")
def paired():
    """{case: (reference result, port result)}, each run once."""
    cfg, pub, clients, test = _data()
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    base = bridge.params_from_reference(params, "cpu")
    out = {}
    for case in CASES:
        fed, faults, secagg = _fields(case)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref = ref_run(ref_tiny(), RefFedConfig(
                **fed, faults=RefFaultConfig(**faults),
                privacy=RefPrivacyConfig(secure_agg=secagg)), pub, clients,
                test, batch_size=16, eval_batch=64)
        port = run_federated(cfg, FedConfig(
            **fed, faults=FaultConfig(**faults),
            privacy=PrivacyConfig(secure_agg=secagg)),
                             pub, clients, test, batch_size=16, eval_batch=64,
                             device="cpu", base=base,
                             lora=_bridged(params, fed["framework"]))
        out[case] = (ref, port)
    return out


def _events(ledger):
    return [(e.round, e.client, e.name, e.direction, e.bytes, e.hop)
            for e in ledger.events]


@pytest.mark.parametrize("case", list(CASES))
def test_faulted_ledger_events_and_rollovers_equal(paired, case):
    ref, port = paired[case]
    assert _events(port.ledger) == _events(ref.ledger)
    assert port.rollovers == ref.rollovers
    assert port.ledger.fault_overhead_bytes() == \
        ref.ledger.fault_overhead_bytes()
    assert port.client_flops == [float(f) for f in ref.client_flops]


@pytest.mark.parametrize("case,names,rolled", [
    ("fedllm", {"quarantine", "retransmit"}, False),
    ("kd", {"quarantine", "retransmit"}, False),
    ("split", {"retransmit"}, False),
    ("quorum", {"retransmit"}, True),
    ("screen", {"quarantine"}, False),
    ("fedllm cohort", {"quarantine", "retransmit"}, True),
    ("kd cohort", {"quarantine", "retransmit"}, False)])
def test_each_run_meets_its_fault(paired, case, names, rolled):
    """Each run holds the faults it was built for: its events carry the
    named fault overhead, and the runs under a quorum rolled over (and
    only they).  The streamed KD run screened its inflated client 0 out
    of round 0, whose chunk {0, 1} alone could not (the median of two
    norms is their mean)."""
    _, port = paired[case]
    assert names <= set(port.ledger.by_name())
    if case == "kd cohort":
        assert (0, 0, "quarantine") in [(e.round, e.client, e.name)
                                        for e in port.ledger.events]
    if case == "fedllm cohort":      # round 0 folds, rounds 1 and 2 roll
        assert port.rollovers == 2
        assert port.history[0].loss == port.history[1].loss == \
            port.history[2].loss
    if case == "fedllm":     # round 2 takes client 2's upload of round 0 too
        ups = [(e.round, e.client) for e in port.ledger.events
               if e.name == "lora_params" and e.direction == M.UP]
        assert (2, 2) in ups
    assert (port.rollovers > 0) == rolled
    assert len(port.history) == CASES[case][0]["rounds"]
    assert all(bool(torch.isfinite(x).all())
               for x in tree_lib.leaves(port.final_lora))


@pytest.mark.parametrize("case", list(CASES))
def test_faulted_rounds_and_final_lora_close(paired, case):
    ref, port = paired[case]
    assert len(port.history) == len(ref.history)
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
    got = jax.tree.leaves(bridge.lora_to_reference(port.final_lora))
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref.final_lora))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)


# --------------------------------------------------------------------------- #
# The plan, the guard and the combines against the reference's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fault_seed", [0, 1, 7])
def test_fault_plan_decisions_are_the_reference_draw_for_draw(fault_seed):
    """Over 50 (round, client) pairs and three fault seeds: the dropped
    uploads, the extra delays and the byzantine set."""
    faults = dict(dropout_rate=0.4, straggler_rate=0.35, straggler_delay=3,
                  byzantine=2, seed=fault_seed)
    got = FaultPlan(FedConfig(seed=5, faults=FaultConfig(**faults)), 5)
    want = RefFaultPlan(RefFedConfig(seed=5, faults=RefFaultConfig(**faults)),
                        5)
    pairs = [(rnd, ci) for rnd in range(10) for ci in range(5)]
    assert [got.dropped(*p) for p in pairs] == \
        [want.dropped(*p) for p in pairs]
    assert [got.extra_delay(*p) for p in pairs] == \
        [want.extra_delay(*p) for p in pairs]
    assert got.byzantine == want.byzantine and len(got.byzantine) == 2
    assert any(got.dropped(*p) for p in pairs)
    assert any(got.extra_delay(*p) for p in pairs)


@pytest.mark.parametrize("mode", BYZANTINE_MODES)
def test_corruption_modes_match_the_reference(mode):
    """Each mode on a float tree in fp32 and bf16 beside an integer leaf,
    which passes through; a client outside the byzantine set is left
    alone."""
    fed_kw = dict(faults=dict(byzantine=1, byzantine_mode=mode,
                              byzantine_scale=100.0))
    plan = FaultPlan(FedConfig(faults=FaultConfig(**fed_kw["faults"])), 3)
    ref_plan = RefFaultPlan(RefFedConfig(
        faults=RefFaultConfig(**fed_kw["faults"])), 3)
    (bad,) = plan.byzantine
    assert ref_plan.byzantine == plan.byzantine
    x = np.random.default_rng(2).standard_normal((2, 3)).astype(np.float32)
    tree = {"w": torch.from_numpy(x), "h": torch.from_numpy(x).bfloat16(),
            "i": torch.arange(3)}
    ref_tree = {"w": jnp.asarray(x), "h": jnp.asarray(x, jnp.bfloat16),
                "i": jnp.arange(3)}
    got = plan.corrupt(tree, 0, bad)
    want = ref_plan.corrupt(ref_tree, 0, bad)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["h"].float().numpy(),
                                  np.asarray(want["h"], np.float32))
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["i"], torch.arange(3))
    ok = next(c for c in range(3) if c not in plan.byzantine)
    assert plan.corrupt(tree, 0, ok) is tree


def test_screen_matches_the_reference():
    """Verdicts over arrivals with a NaN, an inf and an inflated payload,
    by median norm, with the screen off and on."""
    rng = np.random.default_rng(4)
    arrs = [[rng.standard_normal((3, 4)).astype(np.float32),
             rng.standard_normal(5).astype(np.float32)] for _ in range(5)]
    arrs[1][0][1, 2] = np.nan
    arrs[2][1][0] = np.inf
    arrs[3] = [a * 50.0 for a in arrs[3]]
    port = [[torch.from_numpy(a) for a in leaves] for leaves in arrs]
    for factor in (0.0, 5.0, 100.0):
        assert guard.screen(port, factor) == ref_guard.screen(arrs, factor)
    assert guard.screen(port, 5.0) == [True, False, False, False, True]
    assert guard.arrays_norm(port[0]) == ref_guard.arrays_norm(arrs[0])
    assert guard.float_leaves({"a": port[0][0], "n": 3,
                               "i": torch.arange(2)}) == [port[0][0]]


def _stack(rng, C):
    return {"a": rng.standard_normal((C, 3, 2)).astype(np.float32),
            "b": rng.standard_normal((C, 4)).astype(np.float32)}


@pytest.mark.parametrize("C", [4, 5])
@pytest.mark.parametrize("method,kw", [
    ("median", {}), ("trimmed_mean", dict(trim_frac=0.2)),
    ("trimmed_mean", dict(trim_frac=0.49)), ("norm_clip", {}),
    ("norm_clip", dict(clip_norm=1.5)), ("mean", {})])
def test_robust_client_combine_matches_the_reference(C, method, kw):
    """Seeded stacks at an even (4) and an odd (5) client count: the even
    median is the mean of the middle pair, as ``jnp.median``'s (not
    ``torch.median``'s lower one), here and in norm_clip's median of
    the C norms.  Within rtol 1e-6 / atol 1e-7 (fp32 sums in another
    order)."""
    rng = np.random.default_rng(C)
    stack = _stack(rng, C)
    w = rng.uniform(0.5, 2.0, C).astype(np.float32)
    want = ref_fed_spmd.robust_client_combine(
        {k: jnp.asarray(v) for k, v in stack.items()}, jnp.asarray(w),
        method, **kw)
    got = fed_spmd.robust_client_combine(
        {k: torch.from_numpy(v) for k, v in stack.items()},
        torch.from_numpy(w), method, **kw)
    for k in stack:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    if method == "median" and C == 4:
        s = np.sort(stack["b"], axis=0)
        np.testing.assert_allclose(got["b"].numpy(), (s[1] + s[2]) * 0.5,
                                   rtol=1e-6)
        assert not np.allclose(got["b"].numpy(), s[1])


def test_robust_combine_rejects_outlier_and_unknown_method():
    good = np.ones((4, 8), np.float32)
    stack = {"a": torch.from_numpy(np.concatenate([good, 1e6 * good[:1]]))}
    w = torch.ones(5)
    for method, kw in [("median", {}), ("trimmed_mean", {"trim_frac": 0.25}),
                       ("norm_clip", {})]:
        out = fed_spmd.robust_client_combine(stack, w, method, **kw)
        assert out["a"].abs().max() < 100.0, method
    with pytest.raises(ValueError):
        fed_spmd.robust_client_combine(stack, w, "mode")


def test_zero_weight_guards():
    """A cohort of zero weight gives the uniform mean, not NaN: the
    client-axis mean, FedAvg and the KD teacher, as the reference's."""
    stack = {"a": torch.tensor([[1.0, 2.0], [3.0, 4.0]])}
    out = fed_spmd.weighted_client_mean(stack, torch.zeros(2))
    np.testing.assert_allclose(out["a"].numpy(), [2.0, 3.0])
    ref_out = ref_fed_spmd.weighted_client_mean(
        {"a": jnp.asarray(stack["a"].numpy())}, jnp.zeros(2))
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(ref_out["a"]))
    trees = [{"a": torch.ones(2)}, {"a": 3.0 * torch.ones(2)}]
    np.testing.assert_allclose(fedavg.fedavg(trees, [0.0, 0.0])["a"].numpy(),
                               2.0 * np.ones(2))
    np.testing.assert_allclose(np.asarray(ref_fedavg.fedavg(
        [{"a": jnp.ones(2)}, {"a": 3.0 * jnp.ones(2)}], [0.0, 0.0])["a"]),
        2.0 * np.ones(2))
    logits = [torch.ones((3, 4)), 3.0 * torch.ones((3, 4))]
    np.testing.assert_allclose(
        kd.aggregate_knowledge(logits, [0.0, 0.0]).numpy(),
        np.asarray(ref_kd.aggregate_knowledge(
            [jnp.ones((3, 4)), 3.0 * jnp.ones((3, 4))], [0.0, 0.0])))


@pytest.mark.parametrize("absent", [0.0, 7.0])
def test_robust_stale_combine_matches_the_reference(absent):
    """combine_arrivals under trimmed_mean with arrivals at ranks 4, 2 and
    4 and staleness 0, 2 and 1: rank 2 zero-padded, the robust statistic
    over the arrivals alone, blended with the global by the arrived
    share of the weight when some is absent."""
    from repro.core import async_agg as ref_async
    fed = FedConfig(lora_rank=4, robust_agg="trimmed_mean", trim_frac=0.34,
                    staleness_decay=0.5)
    ref_fed = RefFedConfig(lora_rank=4, robust_agg="trimmed_mean",
                           trim_frac=0.34, staleness_decay=0.5)
    ranks = [4, 2, 4]
    rng = np.random.default_rng(9)

    def tree(rank):
        return {"blocks": ({"attn": {t: {
            "a": rng.standard_normal((2, 16, rank)).astype(np.float32),
            "b": rng.standard_normal((2, rank, 12)).astype(np.float32)}
            for t in TARGETS}},)}

    glob, trees = tree(4), [tree(r) for r in ranks]
    arrivals = [(ci, trees[ci], s, w) for ci, s, w in
                ((0, 0, 3.0), (1, 2, 5.0), (2, 1, 2.0))]
    total = 10.0 + absent
    want = jax.tree.leaves(ref_async.combine_arrivals(glob, arrivals, total,
                                                      ref_fed, ranks))
    got = async_agg.combine_arrivals(
        _to_port(glob), [(ci, _to_port(t), s, w) for ci, t, s, w in arrivals],
        total, fed, ranks)
    got = jax.tree.leaves(bridge.lora_to_reference(got))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-6)


def test_payload_view_leaves_fault_events_out():
    ledger = M.CommLedger()
    ledger.record(0, 0, "lora_params", M.UP, 10)
    ledger.record(0, 1, "quarantine", M.UP, 7)
    ledger.record(1, 2, "retransmit", M.UP, 5)
    assert ledger.fault_overhead_bytes() == 12
    assert [e.name for e in ledger.payload_view().events] == ["lora_params"]
    assert M.FAULT_NAMES == ("quarantine", "retransmit")


def test_rollover_rounds_keep_the_global_state():
    """A round below quorum settles its masks and folds nothing: under
    quorum 1.0 with dropout 0.5 the global LoRA after a rolled round is
    the one before it."""
    cfg, pub, clients, test = _data()
    fed = FedConfig(rounds=1, lora_rank=2, lora_dropout=0.0, quorum=1.0,
                    faults=FaultConfig(dropout_rate=0.99))
    res = run_federated(cfg, fed, pub, clients, test, device="cpu")
    start = run_federated(cfg, dataclasses.replace(fed, rounds=0), pub,
                          clients, test, device="cpu")
    assert res.rollovers == 1
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(res.final_lora), tree_lib.leaves(start.final_lora)))
