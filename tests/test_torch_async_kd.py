"""The port's KD-FedLLM with heterogeneous client ranks under async
aggregation against the reference's, on the CPU: the verify-skill
configuration (``gpt2_tiny``, ``paper_splits(scale=0.04, pad_len=24)``,
3 IID clients, global rank 4, dropout 0) with client ranks 2, 4, 4 (each
client's LoRA tree and Adam state at its own rank; KD aggregates no
parameters, so ``hetero_agg`` does not reach it), top-8 int8 logits,
``max_staleness`` 2 over 4 rounds and secure aggregation, from the
reference's initial trees bridged (its clients' ``fold_in(key, ci)``
draws at their ranks); and ``max_staleness`` 0, which must give the
port's own sync run bit for bit (FedLLM and Split:
tests/test_torch_async.py, whose secure-aggregation spy this file uses).

Bars: ledger bytes and client FLOPs exactly the reference's; the masks,
start rounds and discarded uploads of secure aggregation exactly; round
loss and accuracy within 1e-3; the server's final LoRA within atol 5e-5
/ rtol 5e-4."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from test_torch_async import _spy_secagg  # noqa: E402
from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro.privacy import secure_agg as ref_secure_agg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.privacy import secure_agg  # noqa: E402

SEED, RANK, ALPHA = 0, 4, 32.0
TARGETS = ("wq", "wk", "wv")
RANKS = (2, 4, 4)
KD = dict(framework="kd", lora_rank=RANK, lora_dropout=0.0, seed=SEED,
          client_ranks=RANKS, logit_topk=8, logit_quant_bits=8)


@pytest.fixture(scope="module")
def runs():
    """{"async": (reference, port, reference secure-agg events, port
    events), "sync" / "async0": the port's 2-round runs at max_staleness
    0}."""
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    clients = partition.iid_partition(train, 3)
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    base = bridge.params_from_reference(params, "cpu")
    key = jax.random.PRNGKey(SEED + 2)

    def draw(k, rank):
        return bridge.lora_from_reference(jax.tree.map(
            np.asarray, ref_lora.init_lora(k, params, TARGETS, rank, ALPHA)),
            "cpu")
    lora = {"clients": [draw(jax.random.fold_in(key, ci), r)
                        for ci, r in enumerate(RANKS)],
            "server": draw(jax.random.fold_in(key, 999), RANK)}
    kw = dict(KD, aggregation="async", max_staleness=2, rounds=4)
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
            **kw, privacy=PrivacyConfig(secure_agg=True)), pub, clients, test,
            batch_size=16, eval_batch=64, device="cpu", base=base, lora=lora)
    finally:
        for u in undo:
            u()
    out = {"async": (ref, port, ref_seen, port_seen)}
    for tag, agg in (("sync", "sync"), ("async0", "async")):
        out[tag] = run_federated(
            cfg, FedConfig(**KD, rounds=2, aggregation=agg, max_staleness=0),
            pub, clients, test, batch_size=16, eval_batch=64, device="cpu",
            base=base, lora=lora)
    return out


def test_kd_async_hetero_ledger_flops_and_masks_equal(runs):
    """The clients' LoRA sizes set their FLOPs; logits up from every
    arrival and down to it, keys and recovery shares: the reference's
    bytes, masks, start rounds and discards."""
    ref, port, ref_seen, port_seen = runs["async"]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    assert port.client_flops[0] != port.client_flops[1]
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
    assert port_seen == ref_seen and ("discard", 0, 0) in port_seen


def test_kd_async_hetero_rounds_and_final_lora_close(runs):
    ref, port, _, _ = runs["async"]
    assert len(port.history) == len(ref.history) == 4
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    got = jax.tree.leaves(bridge.lora_to_reference(port.final_lora))
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref.final_lora))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)


def test_kd_async_at_zero_staleness_is_sync_bit_for_bit(runs):
    sync, async0 = runs["sync"], runs["async0"]
    assert [(h.loss, h.accuracy) for h in async0.history] == \
        [(h.loss, h.accuracy) for h in sync.history]
    assert async0.ledger.per_client_round() == sync.ledger.per_client_round()
    assert async0.client_flops == sync.client_flops
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(async0.final_lora), tree_lib.leaves(sync.final_lora)))
