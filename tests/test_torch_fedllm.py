"""The port's first slice end to end against the reference: the paper's
SSV case study (FedLLM, sequential clients, sync rounds, Adam) at the
verify-skill configuration — ``gpt2_tiny``, ``paper_splits(scale=0.04,
pad_len=24)``, ``iid_partition(train, 3)``, 2 rounds, LoRA rank 4 on
wq/wk/wv, dropout 0, batch 16, eval batch 64.

The port starts from the reference's ``model.init(PRNGKey(seed))`` and
``init_lora(PRNGKey(seed + 1), ...)``, bridged, and runs on the CPU with
the plain kernel policy.  Ledger bytes and client FLOPs must be equal
exactly (they are shape-derived); per-round loss and accuracy within 1e-3
and the final LoRA trees within atol 5e-5 / rtol 5e-4 — the bar the
reference holds its own backends to (tests/test_backend_parity.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.data import banking77 as ref_b77  # noqa: E402
from repro.data import loader as ref_loader  # noqa: E402
from repro.data import partition as ref_partition  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, loader, partition  # noqa: E402

SEED = 0
FED = dict(framework="fedllm", rounds=2, lora_rank=4, lora_dropout=0.0,
           seed=SEED)


@pytest.fixture(scope="module")
def runs():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    clients = partition.iid_partition(train, 3)
    ref_cfg = ref_tiny()
    params = jax.tree.map(np.asarray,
                          ref_build(ref_cfg).init(jax.random.PRNGKey(SEED)))
    lt = jax.tree.map(np.asarray, ref_lora.init_lora(
        jax.random.PRNGKey(SEED + 1), params, ("wq", "wk", "wv"), 4, 32.0))
    with pytest.warns(DeprecationWarning):
        ref = ref_run(ref_cfg, RefFedConfig(**FED), pub, clients, test,
                      batch_size=16, eval_batch=64)
    port = run_federated(cfg, FedConfig(**FED), pub, clients, test,
                         batch_size=16, eval_batch=64, device="cpu",
                         base=bridge.params_from_reference(params, "cpu"),
                         lora=bridge.lora_from_reference(lt, "cpu"))
    return ref, port


def test_ledger_bytes_equal(runs):
    ref, port = runs
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_round() == ref.ledger.per_round()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.ledger.total() == ref.ledger.total()
    assert port.ledger.mean_client_bytes_per_round() == \
        ref.ledger.mean_client_bytes_per_round()


def test_client_flops_equal(runs):
    ref, port = runs
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client


def test_round_metrics_close(runs):
    ref, port = runs
    assert len(port.history) == len(ref.history) == 2
    for hp, hr in zip(port.history, ref.history):
        assert hp.round == hr.round
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3


def test_final_lora_close(runs):
    ref, port = runs
    want = jax.tree.map(np.asarray, ref.final_lora)["blocks"][0]["attn"]
    got = bridge.lora_to_reference(port.final_lora)["blocks"][0]["attn"]
    assert sorted(got) == sorted(want) == ["wk", "wq", "wv"]
    for name in want:
        for factor in ("a", "b"):
            np.testing.assert_allclose(got[name][factor], want[name][factor],
                                       atol=5e-5, rtol=5e-4,
                                       err_msg=f"{name}.{factor}")


@pytest.mark.parametrize("scale,pad_len,n_clients", [(0.04, 24, 3),
                                                     (0.03, 80, 3),
                                                     (0.02, 16, 5)])
def test_data_pipeline_bit_identical(scale, pad_len, n_clients):
    """paper_splits, iid_partition and epoch_batches give the reference's
    arrays exactly."""
    got = banking77.paper_splits(512, pad_len=pad_len, scale=scale)
    want = ref_b77.paper_splits(512, pad_len=pad_len, scale=scale)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    shards = partition.iid_partition(got[1], n_clients)
    ref_shards = ref_partition.iid_partition(want[1], n_clients)
    for s, rs in zip(shards, ref_shards):
        for k in s:
            np.testing.assert_array_equal(s[k], rs[k])
        for bg, bw in zip(loader.epoch_batches(s, 16, seed=997 + 1),
                          ref_loader.epoch_batches(rs, 16, seed=997 + 1)):
            for k in bg:
                np.testing.assert_array_equal(bg[k], bw[k])


def test_own_init_runs_and_accounts_like_reference(runs):
    """Without base=/lora= the port draws its own weights from fed.seed;
    the wire accounting, being shape-derived, is the reference's."""
    ref, _ = runs
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    res = run_federated(cfg, FedConfig(**FED), pub,
                        partition.iid_partition(train, 3), test,
                        batch_size=16, eval_batch=64, device="cpu")
    assert res.ledger.per_client_round() == ref.ledger.per_client_round()
    assert all(np.isfinite(h.loss) for h in res.history)
