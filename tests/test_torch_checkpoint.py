"""The port's checkpoints (checkpoint/): the dtype-exact state snapshot
(``state_flatten`` / ``state_unflatten``),
``CheckpointManager``'s file names and retention, and kill-and-resume:
a run stopped after round k with ``checkpoint_every=1`` and resumed with
``resume_from`` ends bit for bit as the run that was not interrupted
(ledger events, history but the wall-time ``seconds``, rollovers and the
final LoRA), on the verify-skill case study (``gpt2_tiny``,
``paper_splits(scale=0.04, pad_len=24)``, rank 4, dropout 0, the CPU):

- FedLLM, async with ``max_staleness`` 2 and secure aggregation (in
  flight payloads, the schedule's generators and the masking session
  cross the checkpoint), 3 rounds, stopped after 2;
- KD under ``spmd`` (each client's adapter and Adam state, the server's,
  the global knowledge), 2 rounds, stopped after 1;
- Split, fp32 boundary (both halves and the server's Adam state), 2
  rounds, stopped after 1;
- FedLLM under ``cohort`` over a 4-client DirichletPopulation in chunks
  of 2 (the per-chunk masking-cohort ids), 2 rounds, stopped after 1;
- the same with faults, secure aggregation and trimmed_mean (the
  streamed round's screen, quarantines and robust buffer), 3 rounds,
  stopped after 1;
- FedLLM with faults under quorum 1.0 (rollovers, retransmits and a
  quarantine), 3 rounds, stopped after 1.

These are the port's runs alone, each against its own uninterrupted run;
the faulted runs against the reference are tests/test_torch_faults.py's.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import serialization  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import (FaultConfig, FedConfig,  # noqa: E402
                                      PrivacyConfig)
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition, population  # noqa: E402

BASE = dict(lora_rank=4, lora_dropout=0.0, split_layer=2, kd_epochs=1,
            seed=0)
# case -> (FedConfig fields, rounds, the round after which the run stops)
CASES = {
    "fedllm async secagg": (dict(aggregation="async", max_staleness=2,
                                 privacy=PrivacyConfig(secure_agg=True)),
                            3, 2),
    "kd spmd": (dict(framework="kd", backend="spmd"), 2, 1),
    "split": (dict(framework="split"), 2, 1),
    "fedllm cohort": (dict(backend="cohort", cohort_size=2), 2, 1),
    "fedllm cohort faults": (dict(backend="cohort", cohort_size=2,
                                  robust_agg="trimmed_mean", trim_frac=0.34,
                                  privacy=PrivacyConfig(secure_agg=True),
                                  faults=FaultConfig(
                                      dropout_rate=0.3, byzantine=1,
                                      byzantine_mode="nan")), 3, 1),
    "fedllm faults quorum": (dict(quorum=1.0, robust_agg="median",
                                  faults=FaultConfig(
                                      dropout_rate=0.5, byzantine=1,
                                      byzantine_mode="nan")), 3, 1),
}


def _state():
    """A state tree with fp32, fp64, bf16, int64 and bool tensors, numpy
    uint64 and float32 arrays, Python scalars (a large int, inf, a
    string, None) and nested tuples and lists."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    x[0, 0], x[0, 1], x[0, 2] = -0.0, float("nan"), float("-inf")
    return {
        "f32": x, "f64": torch.from_numpy(rng.standard_normal(7)),
        "bf16": (x * 3).bfloat16(),
        "i64": torch.arange(-3, 4), "mask": torch.tensor([True, False]),
        "u64": np.array([0, 2 ** 64 - 1, 12345678901234567890], np.uint64),
        "np32": rng.standard_normal(4).astype(np.float32),
        "py": (7, 2 ** 100 + 1, float("inf"), 0.1, "hop", None, True),
        "nested": ({"step": 3, "m": [x[1], (x[2],)]}, []),
        3: "an int key",
    }


def _same(a, b):
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and a.device == b.device
                and torch.equal(a.view(-1).view(torch.uint8),
                                b.view(-1).view(torch.uint8)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def test_state_round_trip_is_exact_through_npz_and_json(tmp_path):
    """Every leaf comes back with its dtype, bits and kind (a tensor a
    tensor, a numpy array a numpy array, a Python int an int), through
    the npz and a JSON round trip of the manifest."""
    state = _state()
    manifest, arrays = serialization.state_flatten(state)
    np.savez(tmp_path / "s.npz", **arrays)
    manifest = json.loads(json.dumps(manifest))
    with np.load(tmp_path / "s.npz") as z:
        back = serialization.state_unflatten(manifest,
                                             {k: z[k] for k in z.files})
    assert _same(state, back)
    assert back["bf16"].dtype == torch.bfloat16
    assert back["u64"].dtype == np.uint64
    assert type(back["nested"][0]["step"]) is int


def test_manager_names_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for step in (1, 2, 3):
        mgr.save_state(step, {"step": step, "x": torch.full((2,), step)},
                       metadata={"framework": "fedllm"})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000002.npz", "ckpt_00000002.npz.json",
        "ckpt_00000003.npz", "ckpt_00000003.npz.json"]
    state, meta = mgr.restore_state()
    assert state["step"] == 3 and torch.equal(state["x"], torch.full((2,), 3))
    assert meta == {"framework": "fedllm"}
    assert mgr.restore_state(2)[0]["step"] == 2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_state()


@pytest.fixture(scope="module")
def data():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    return cfg, pub, train, test


def _clients(case, train):
    if "cohort" in case:
        return population.DirichletPopulation(train, 4, alpha=0.5, seed=0,
                                              shard_size=16)
    return partition.iid_partition(train, 3)


def _history(res):
    return [dataclasses.replace(h, seconds=0.0) for h in res.history]


@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_is_bit_exact(data, tmp_path, case):
    cfg, pub, train, test = data
    extra, rounds, stop = CASES[case]
    fed = FedConfig(rounds=rounds, **BASE, **extra)
    clients = _clients(case, train)

    def run(fed, **kw):
        return run_federated(cfg, fed, pub, clients, test, batch_size=16,
                             eval_batch=64, device="cpu", **kw)

    full = run(fed)
    ckpt = str(tmp_path / "ckpt")
    run(dataclasses.replace(fed, rounds=stop), checkpoint_every=1,
        checkpoint_dir=ckpt)
    assert CheckpointManager(ckpt).latest_step() == stop
    resumed = run(fed, resume_from=ckpt)
    assert resumed.ledger.events == full.ledger.events
    assert _history(resumed) == _history(full)
    assert len(resumed.history) == rounds
    assert resumed.rollovers == full.rollovers
    assert resumed.client_flops == full.client_flops
    got, want = (tree_lib.leaves(r.final_lora) for r in (resumed, full))
    assert len(got) == len(want) > 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if "quorum" in case:
        assert full.rollovers > 0
    if "faults" in case:
        assert {"quarantine", "retransmit"} <= set(full.ledger.by_name())
