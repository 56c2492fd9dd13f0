"""The port's cohort-streaming executor (``backend="cohort"``) against the
reference's, on the CPU, mirroring tests/test_population.py: the model
there (d 32, 2 layers), 4 clients, batch 8, 2 rounds, dropout 0, from the
reference's weights and LoRA draws bridged.

Each framework runs twice against the reference's cohort run: with a
cohort that covers the fleet (``cohort_size`` 8, an eager population of
IID shards), and streamed (``cohort_size`` 2, a lazy DirichletPopulation)
with secure aggregation, each chunk its own masking cohort, and
``n_edges`` 2 (the ledger split into a client->edge and an edge->server
hop).  FedLLM also runs async (``max_staleness`` 2 over 4 rounds, secure
aggregation) and with client ranks, zeropad (streamed in one
accumulator) and svd (the round's arrivals kept).  Bars: ledger bytes by
hop, by name and per client and round (also of ``payload_view``) and
client FLOPs exactly; round loss and accuracy within 1e-3; the final LoRA
within atol 5e-5 / rtol 5e-4 (svd's through its deltas).  The port's own
runs then show the hop accounting (the client->edge total of a two-hop
run is the one-hop run's total, the edge->server events counted by hand),
the per-chunk key exchange, the n_virtual_clients check and KD's
per-client state built on first use.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.data import population as ref_population  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import (FedConfig, ModelConfig,  # noqa: E402
                                      PrivacyConfig)
from repro_torch.core import metrics as M  # noqa: E402
from repro_torch.core.round_program import (KDProgram,  # noqa: E402
                                            RoundContext)
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition, population  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402
from repro_torch.privacy.secure_agg import KEY_BYTES, SHARE_BYTES  # noqa: E402

CFG = dict(name="pop-t", family="dense", n_layers=2, d_model=32, n_heads=2,
           n_kv_heads=2, d_ff=64, vocab_size=192, qkv_bias=True,
           activation="gelu", norm="layernorm", use_rope=False,
           max_position_embeddings=64)
SEED, RANK, ALPHA = 0, 4, 32.0
TARGETS = ("wq", "wk", "wv")
N = 4
FED = dict(n_clients=N, rounds=2, lora_rank=RANK, lora_dropout=0.0,
           split_layer=1, kd_epochs=1, seed=SEED, backend="cohort")
STREAMED = dict(cohort_size=2, n_edges=2, privacy=dict(secure_agg=True))
LAZY = dict(alpha=0.5, seed=0, shard_size=24)
RUNS = {
    **{f"{fw} whole": dict(framework=fw, cohort_size=8)
       for fw in ("fedllm", "kd", "split")},
    **{f"{fw} streamed": dict(framework=fw, lazy=True, **STREAMED)
       for fw in ("fedllm", "kd", "split")},
    "fedllm async": dict(framework="fedllm", cohort_size=2,
                         aggregation="async", max_staleness=2, rounds=4,
                         privacy=dict(secure_agg=True)),
    "fedllm zeropad": dict(framework="fedllm", cohort_size=2,
                           client_ranks=(4, 2, 4, 2)),
    "fedllm svd": dict(framework="fedllm", cohort_size=2,
                       client_ranks=(4, 2, 4, 1), hetero_agg="svd"),
}
LORA_KEY = {"fedllm": SEED + 1, "split": SEED + 3}
LORA_TOL = dict(atol=5e-5, rtol=5e-4)


def _data():
    pub = banking77.generate(24, CFG["vocab_size"], 12, seed=0)
    tr = banking77.generate(96, CFG["vocab_size"], 12, seed=1)
    te = banking77.generate(16, CFG["vocab_size"], 12, seed=2)
    return pub, tr, te


def _initial(params, framework):
    """The reference's initial LoRA draw of ``framework``, bridged."""
    def draw(key):
        lt = ref_lora.init_lora(key, params, TARGETS, RANK, ALPHA)
        return bridge.lora_from_reference(jax.tree.map(np.asarray, lt),
                                          "cpu")

    if framework != "kd":
        return draw(jax.random.PRNGKey(LORA_KEY[framework]))
    key = jax.random.PRNGKey(SEED + 2)
    return {"clients": [draw(jax.random.fold_in(key, ci)) for ci in range(N)],
            "server": draw(jax.random.fold_in(key, 999))}


def _fed(config_cls, privacy_cls, **kw):
    kw = dict(FED, **kw)
    kw.pop("lazy", None)
    priv = kw.pop("privacy", None)
    if priv:
        kw["privacy"] = privacy_cls(**priv)
    return config_cls(**kw)


@pytest.fixture(scope="module")
def case():
    pub, tr, te = _data()
    params = jax.tree.map(np.asarray, ref_build(RefModelConfig(**CFG)).init(
        jax.random.PRNGKey(SEED)))
    return dict(pub=pub, tr=tr, te=te, params=params,
                base=bridge.params_from_reference(params, "cpu"),
                clients=partition.iid_partition(tr, N, seed=0))


def _port(case, lazy=False, **kw):
    pop = population.DirichletPopulation(case["tr"], N, **LAZY) if lazy \
        else population.ClientPopulation.from_clients_data(case["clients"])
    fed = _fed(FedConfig, PrivacyConfig, **kw)
    return run_federated(ModelConfig(**CFG), fed, case["pub"], pop,
                         case["te"], batch_size=8, eval_batch=16,
                         device="cpu", base=case["base"],
                         lora=_initial(case["params"], fed.framework))


@pytest.fixture(scope="module")
def runs(case):
    """{name: (reference cohort result, port cohort result)} for RUNS."""
    out = {}
    for name, kw in RUNS.items():
        pop = ref_population.DirichletPopulation(case["tr"], N, **LAZY) \
            if kw.get("lazy") else \
            ref_population.ClientPopulation.from_clients_data(case["clients"])
        ref = ref_run(RefModelConfig(**CFG), _fed(RefFedConfig, RefPrivacy,
                                                  **kw),
                      case["pub"], pop, case["te"], batch_size=8,
                      eval_batch=16)
        out[name] = (ref, _port(case, **kw))
    return out


def _events(ledger):
    return [(e.round, e.client, e.name, e.direction, e.bytes, e.hop)
            for e in ledger.events]


@pytest.mark.parametrize("name", list(RUNS))
def test_cohort_ledger_and_flops_equal_reference(runs, name):
    ref, port = runs[name]
    assert port.ledger.by_hop() == ref.ledger.by_hop()
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.ledger.payload_view().per_client_round() == \
        ref.ledger.payload_view().per_client_round()
    assert sorted(_events(port.ledger)) == sorted(_events(ref.ledger))
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
        assert hp.epsilon == hr.epsilon


def _deltas(leaves):
    return [np.einsum("...dr,...rf->...df", np.float64(a), np.float64(b))
            for a, b in zip(leaves[::2], leaves[1::2])]


@pytest.mark.parametrize("name", list(RUNS))
def test_cohort_rounds_and_final_lora_close_to_reference(runs, name):
    ref, port = runs[name]
    assert len(port.history) == len(ref.history) == \
        RUNS[name].get("rounds", FED["rounds"])
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    got = jax.tree.leaves(bridge.lora_to_reference(port.final_lora))
    want = [np.asarray(x) for x in jax.tree.leaves(ref.final_lora)]
    assert [g.shape for g in got] == [w.shape for w in want]
    if RUNS[name].get("hetero_agg") == "svd":
        got, want = _deltas(got), _deltas(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **LORA_TOL)


@pytest.mark.parametrize("fw", ["fedllm", "kd", "split"])
def test_streamed_secure_agg_keys_a_chunk(runs, fw):
    """Each chunk of 2 is its own masking cohort: every client exchanges
    one key and one share with one peer a round (32 + 32 up, 32 + 32
    down), where one cohort of 4 would exchange three of each."""
    _, port = runs[f"{fw} streamed"]
    up = KEY_BYTES + 1 * SHARE_BYTES
    down = 1 * (KEY_BYTES + SHARE_BYTES)
    assert port.ledger.by_name()["secagg_keys"] == \
        FED["rounds"] * N * (up + down)
    assert "secagg_recovery" not in port.ledger.by_name()


def test_two_hop_accounting_by_hand(case, runs):
    """The client->edge hop of the streamed two-hop FedLLM run is the
    one-hop run's whole ledger; the edge->server hop holds, each round,
    one fused payload up and the new global down for each of the 2 edges
    (chunk g aggregated at edge g mod 2), the global tree's bytes each;
    the per-client mean and the model are the one-hop run's."""
    _, hier = runs["fedllm streamed"]
    flat = _port(case, **dict(RUNS["fedllm streamed"], n_edges=0))
    assert set(hier.ledger.by_hop()) == {M.CLIENT_EDGE, M.EDGE_SERVER}
    assert set(flat.ledger.by_hop()) == {M.CLIENT_SERVER}
    assert hier.ledger.hop_total(M.CLIENT_EDGE) == flat.ledger.total()
    lora_bytes = M.tree_bytes(flat.final_lora)
    edge = [e for e in hier.ledger.events if e.hop == M.EDGE_SERVER]
    assert sorted((e.round, e.client, e.direction) for e in edge) == sorted(
        (rnd, -(k + 1), d) for rnd in range(FED["rounds"]) for k in range(2)
        for d in (M.UP, M.DOWN))
    assert all(e.name == "edge_agg" and e.bytes == lora_bytes for e in edge)
    assert hier.ledger.hop_total(M.EDGE_SERVER) == \
        FED["rounds"] * 2 * 2 * lora_bytes
    assert hier.ledger.payload_view().per_client_round() == \
        flat.ledger.payload_view().per_client_round()
    assert [h.comm_bytes_per_client for h in hier.history] == \
        [h.comm_bytes_per_client for h in flat.history]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(hier.final_lora), tree_lib.leaves(flat.final_lora)))


def test_population_and_list_give_the_same_run_without_warning(case):
    """A list of shards goes through ``as_population``: the same run as
    the EagerPopulation over it, and no DeprecationWarning."""
    fed = _fed(FedConfig, PrivacyConfig, framework="fedllm", rounds=1,
               cohort_size=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        runs_ = [run_federated(ModelConfig(**CFG), fed, case["pub"], clients,
                               case["te"], batch_size=8, eval_batch=16,
                               device="cpu", base=case["base"])
                 for clients in (case["clients"],
                                 population.EagerPopulation(case["clients"]))]
    assert runs_[0].ledger.by_name() == runs_[1].ledger.by_name()
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(runs_[0].final_lora),
        tree_lib.leaves(runs_[1].final_lora)))


def test_n_virtual_clients_mismatch_raises(case):
    pop = population.DirichletPopulation(case["tr"], N, **LAZY)
    for n in (9, N - 1):
        fed = _fed(FedConfig, PrivacyConfig, framework="fedllm",
                   n_virtual_clients=n)
        with pytest.raises(ValueError, match="n_virtual_clients"):
            run_federated(ModelConfig(**CFG), fed, case["pub"], pop,
                          case["te"], batch_size=8, eval_batch=16,
                          device="cpu")


def test_kd_client_state_is_built_on_first_use(case):
    """Over a lazy population KD builds a client's LoRA tree, Adam state
    and parameter count when it is first read, each client's tree from a
    generator of its own (the same tree whatever order clients are built
    in); over a list the trees are drawn up front, one after another, as
    before."""
    cfg = ModelConfig(**CFG)
    model = build_model(cfg)
    fed = _fed(FedConfig, PrivacyConfig, framework="kd", n_clients=100_000)

    def program(clients):
        ctx = RoundContext(model, case["base"], cfg, fed, TARGETS,
                           case["pub"], clients, case["te"],
                           "classification", 8, 16, False, "cpu")
        return KDProgram(ctx)

    pop = population.DirichletPopulation(case["tr"], 100_000, **LAZY)
    a, b = program(pop), program(pop)
    assert len(a.lts) == 100_000 and not a.lts._vals
    late, early = a.lts[99_999], a.lts[3]
    assert set(a.lts._vals) == {3, 99_999}
    for x, y in zip(tree_lib.leaves(b.lts[3]), tree_lib.leaves(early)):
        assert torch.equal(x, y)
    for x, y in zip(tree_lib.leaves(b.lts[99_999]), tree_lib.leaves(late)):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(
        tree_lib.leaves(late), tree_lib.leaves(early)))
    assert a.n_lora[3] == sum(t.numel() for t in tree_lib.leaves(early))
    assert int(a.opts[3]["step"]) == 0
    gen = torch.Generator().manual_seed(SEED + 2)
    drawn = [lora_lib.init_lora(gen, case["base"], TARGETS, RANK, ALPHA)
             for _ in range(N + 1)]
    eager = program(case["clients"])
    for ci in reversed(range(N)):
        for x, y in zip(tree_lib.leaves(eager.lts[ci]),
                        tree_lib.leaves(drawn[ci])):
            assert torch.equal(x, y)
    for x, y in zip(tree_lib.leaves(eager.server_lt),
                    tree_lib.leaves(drawn[N])):
        assert torch.equal(x, y)
