"""The port's training pieces against the reference: the synthetic Markov
corpus, SGD and the learning-rate schedules, the template checkpoints,
``launch/train.py`` and one generative train step on each reduced family.

- ``data/synthetic``: ``markov_corpus`` and ``lm_batches`` bit for bit.
- ``optim/sgd``: with and without momentum, several steps, at atol 1e-7
  (fp32, the same formulas); the stacked clients' update with a ``valid``
  mask against the reference's ``vmap`` of ``sgd.update`` under its
  ``_select``.  ``run_federated(optimizer="sgd")`` under ``sequential``
  and ``spmd`` (one module fixture) against the reference's sequential
  run: ledger and FLOPs exactly, round loss and accuracy within 1e-3,
  the final LoRA within atol 5e-5 / rtol 5e-4.
- ``optim/schedule``: the three schedules at a grid of steps, rtol 1e-6
  (``cos`` of two libraries).
- ``checkpoint``: the template snapshot round trip bit for bit (dtype and
  device the template's), the manager's file names, sidecar and
  ``keep_n``; ``flatten_tree`` of a bridged LoRA tree equal key for key
  and array for array to the reference's; the SGD state through the
  bridge both ways.
- ``launch/train.py``: the first 5 losses from bridged weights and the
  reference's LoRA draw on the same batches within 1e-4; the CLI to its
  end, its exit code the improvement its log prints.
- One generative train step (SGD at lr 1, so the LoRA's change is the
  gradient) on the hybrid, RWKV-6, MoE, VLM and encoder-decoder families
  at ``reduced(d_model=64)``: the loss within 1e-5 and the change within
  1e-4 in relative L2 of the reference's."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import serialization as ref_ser  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core import fedavg as ref_fedavg  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402
from repro.optim import sgd as ref_sgd  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import serialization  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core import fed_spmd  # noqa: E402
from repro_torch.core.fedavg import make_fns, to_device  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition, synthetic  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.optim import api, schedule, sgd  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SEED = 0
RANK, ALPHA = 4, 32.0
TARGETS = ("wq", "wk", "wv")
LORA_TOL = dict(atol=5e-5, rtol=5e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_weights(lora_seed=SEED + 1, rank=RANK):
    params = _np(ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    lt = _np(ref_lora.init_lora(jax.random.PRNGKey(lora_seed), params,
                                TARGETS, rank, ALPHA))
    return params, lt


# --------------------------------------------------------------------------- #
# data/synthetic.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,V,seed,branching", [(20000, 512, 0, 8),
                                                (5000, 50257, 3, 4),
                                                (1, 7, 1, 8)])
def test_markov_corpus_bit_identical(n, V, seed, branching):
    got = synthetic.markov_corpus(n, V, seed=seed, branching=branching)
    want = ref_synthetic.markov_corpus(n, V, seed=seed, branching=branching)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_lm_batches_bit_identical():
    corpus = synthetic.markov_corpus(3000, 512, seed=1)
    got = synthetic.lm_batches(corpus, 4, 24, seed=2)
    want = ref_synthetic.lm_batches(corpus, 4, 24, seed=2)
    for _ in range(5):
        g, w = next(got), next(want)
        assert g.keys() == w.keys() == {"tokens"}
        assert g["tokens"].shape == (4, 25)
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


# --------------------------------------------------------------------------- #
# optim/sgd.py and optim/schedule.py
# --------------------------------------------------------------------------- #
def _trees(seed, n=3):
    rng = np.random.default_rng(seed)
    shapes = {"x": (5, 3), "y": [(4,), (2, 2)]}
    return [{"x": rng.standard_normal(shapes["x"]).astype(np.float32),
             "y": [rng.standard_normal(s).astype(np.float32)
                   for s in shapes["y"]]} for _ in range(n)]


def _t(tree):
    return tree_lib.map_(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    params, *grads = _trees(0, 4)
    init, upd = api.make_optimizer("sgd", momentum=momentum)
    p, s = _t(params), init(_t(params))
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_sgd.init(rp, momentum)
    assert (s["mu"] is None) == (rs["mu"] is None) == (not momentum)
    for g in grads:
        p, s = upd(_t(g), s, p, 0.05)
        rp, rs = ref_sgd.update(jax.tree.map(jnp.asarray, g), rs, rp, 0.05,
                                momentum)
    for x, y in zip(tree_lib.leaves(p), jax.tree.leaves(rp)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-7,
                                   rtol=0)
    if momentum:
        for x, y in zip(tree_lib.leaves(s["mu"]),
                        jax.tree.leaves(rs["mu"])):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-7,
                                       rtol=0)
    else:
        assert s == {"mu": None}
    with pytest.raises(ValueError):
        api.make_optimizer("lamb")


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_update_clients_matches_reference_vmap(momentum):
    """Three stacked clients, the second padded (``valid`` false) at the
    second step: the reference's ``vmap`` of ``sgd.update`` under
    ``_select`` against ``make_client_update("sgd")``."""
    C = 3
    params = _trees(1, C)
    steps = [_trees(10 + k, C) for k in range(2)]
    valid = [[True, True, True], [True, False, True]]
    stack = (lambda ts: jax.tree.map(lambda *xs: jnp.stack(
        [jnp.asarray(x) for x in xs]), *ts))
    rp = stack(params)
    rs = jax.vmap(lambda p: ref_sgd.init(p, momentum))(rp)
    upd = api.make_client_update("sgd", momentum=momentum)
    p = fed_spmd.stack_trees([_t(t) for t in params])
    s = fed_spmd.stack_for_clients(sgd.init(_t(params[0]), momentum), C)
    if momentum:
        s = {"mu": tree_lib.map_(torch.zeros_like, p)}
    for grads, ok in zip(steps, valid):
        new_p, new_s = jax.vmap(lambda g, st, pp: ref_sgd.update(
            g, st, pp, 0.1, momentum))(stack(grads), rs, rp)
        okj = jnp.asarray(ok)
        rp = jax.tree.map(lambda n, o: jnp.where(
            okj.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), new_p, rp)
        rs = jax.tree.map(lambda n, o: jnp.where(
            okj.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), new_s, rs)
        p, s = upd(fed_spmd.stack_trees([_t(g) for g in grads]), s, p, 0.1,
                   np.asarray(ok))
    for x, y in zip(tree_lib.leaves(p), jax.tree.leaves(rp)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-7,
                                   rtol=0)
    if momentum:
        for x, y in zip(tree_lib.leaves(s["mu"]),
                        jax.tree.leaves(rs["mu"])):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-7,
                                       rtol=0)
    else:
        assert s == {"mu": None}
        assert fed_spmd.unstack_tree(s, C) == [{"mu": None}] * C


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("warmup_cosine", (1e-3, 10, 100)),
    ("warmup_cosine", (2e-3, 0, 7, 0.25)), ("linear_decay", (1e-3, 50))])
def test_schedules_match_reference(name, args):
    got_f, want_f = getattr(schedule, name)(*args), \
        getattr(ref_schedule, name)(*args)
    for step in (0, 1, 3, 5, 9, 10, 11, 49, 50, 77, 100, 150):
        got, want = got_f(step), want_f(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0, err_msg=f"{name} step {step}")
    assert float(got_f(torch.tensor(3))) == float(got_f(3))


# --------------------------------------------------------------------------- #
# run_federated(optimizer="sgd")
# --------------------------------------------------------------------------- #
SGD_FED = dict(framework="fedllm", rounds=2, lora_rank=RANK,
               lora_dropout=0.0, optimizer="sgd", lr=0.05, seed=SEED)


@pytest.fixture(scope="module")
def sgd_runs():
    cfg = gpt2_tiny()
    pub, train_, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                               scale=0.04)
    clients = partition.iid_partition(train_, 3)
    params, lt = _ref_weights()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = {"reference": ref_run(ref_tiny(), RefFedConfig(**SGD_FED), pub,
                                    clients, test, batch_size=16,
                                    eval_batch=64)}
    for backend in ("sequential", "spmd"):
        out[backend] = run_federated(
            cfg, FedConfig(**SGD_FED, backend=backend), pub, clients, test,
            batch_size=16, eval_batch=64, device="cpu",
            base=bridge.params_from_reference(params, "cpu"),
            lora=bridge.lora_from_reference(lt, "cpu"))
    return out


@pytest.mark.parametrize("backend", ["sequential", "spmd"])
def test_sgd_run_matches_reference(sgd_runs, backend):
    port, ref = sgd_runs[backend], sgd_runs["reference"]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    assert len(port.history) == len(ref.history) == 2
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    want = bridge.lora_from_reference(_np(ref.final_lora), "cpu")
    moved = 0.0
    for x, y, s in zip(tree_lib.leaves(port.final_lora),
                       tree_lib.leaves(want), tree_lib.leaves(
                           bridge.lora_from_reference(_ref_weights()[1],
                                                      "cpu"))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **LORA_TOL)
        moved = max(moved, float((x - s).abs().max()))
    assert moved > 1e-3                 # SGD at lr 0.05 moved the LoRA


# --------------------------------------------------------------------------- #
# checkpoint: the template snapshot
# --------------------------------------------------------------------------- #
def _port_tree():
    gen = torch.Generator().manual_seed(4)
    return {"layers": [{"attn": {"wq": {"a": torch.randn(6, 2, generator=gen),
                                        "b": torch.randn(2, 6, generator=gen)}}},
                       None,
                       {"attn": {"wq": {"a": torch.randn(6, 2, generator=gen)
                                        .double(),
                                        "b": torch.randn(2, 6, generator=gen)
                                        .to(torch.bfloat16)}}}],
            "scalar": torch.tensor(3, dtype=torch.int32),
            "host": np.arange(4, dtype=np.int16)}


def test_template_snapshot_round_trip(tmp_path):
    """save / restore through the manager: every leaf back in the
    template's dtype and device, bit for bit (bf16 through fp32, exact),
    the json sidecar, the file names and keep_n."""
    tree = _port_tree()
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for step in (5, 10, 15):
        path = mgr.save(step, tree, {"loss": 1.5 * step})
    assert Path(path).name == "ckpt_00000015.npz"
    assert mgr.steps() == [10, 15]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000010.npz", "ckpt_00000010.npz.json",
        "ckpt_00000015.npz", "ckpt_00000015.npz.json"]
    template = tree_lib.map_(lambda t: t * 0 if torch.is_tensor(t) else t,
                             tree)
    back, meta = mgr.restore(template)
    assert meta == {"loss": 22.5}
    assert back["layers"][1] is None and isinstance(back["layers"], list)
    for x, y in zip(tree_lib.leaves(back), tree_lib.leaves(tree)):
        if torch.is_tensor(y):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert mgr.restore(template, step=10)[1] == {"loss": 15.0}
    mgr.save(20, tree)                        # no metadata: no sidecar
    assert mgr.restore(template)[1] is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(template)


def test_flatten_tree_of_bridged_lora_matches_reference(tmp_path):
    """The reference's layout of a bridged port LoRA tree flattens to the
    reference's own keys and arrays; an npz the port saves loads through
    the reference's load_npz into the reference's tree."""
    params, lt = _ref_weights()
    port = bridge.lora_from_reference(lt, "cpu")
    got = serialization.flatten_tree(bridge.lora_to_reference(port))
    want = ref_ser.flatten_tree(lt)
    assert list(got) == list(want) and len(got) == 3 * 2
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    path = str(tmp_path / "lora.npz")
    serialization.save_npz(path, bridge.lora_to_reference(port))
    back = ref_ser.load_npz(path, jax.tree.map(jnp.asarray, lt))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(lt)):
        np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                     ("adam", {})])
def test_optimizer_state_bridges_both_ways(name, kw):
    """An optimizer state of a LoRA tree (SGD's {"mu": None} without
    momentum) through the bridge and back, and into the reference's
    update."""
    params, lt = _ref_weights()
    ref_init = {"sgd": lambda p: ref_sgd.init(p, kw.get("momentum", 0.0)),
                "adam": __import__("repro.optim.adam",
                                   fromlist=["init"]).init}[name]
    ref_state = _np(ref_init(jax.tree.map(jnp.asarray, lt)))
    port = bridge.opt_state_from_reference(ref_state, "cpu")
    want = api.make_optimizer(name, **kw)[0](
        bridge.lora_from_reference(lt, "cpu"))
    assert port.keys() == want.keys()
    for k in want:
        if want[k] is None or isinstance(want[k], int):
            assert port[k] == want[k]
        else:
            for x, y in zip(tree_lib.leaves(port[k]),
                            tree_lib.leaves(want[k])):
                assert torch.equal(x, y)
    back = bridge.opt_state_to_reference(port)
    assert jax.tree.structure(back) == jax.tree.structure(ref_state)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------- #
# launch/train.py
# --------------------------------------------------------------------------- #
def test_train_first_losses_match_reference():
    """train.py's loop from the reference's weights and LoRA draw (rank
    8, the reference launcher's ``fold_in(key, 1)``), bridged, on the
    port's batches, which are the reference launcher's: the first 5
    losses within 1e-4."""
    args = train.parse_args(["--steps", "5", "--device", "cpu"])
    cfg = train.arch_config(args)
    ref_cfg = ref_registry.get_config(args.arch)
    key = jax.random.PRNGKey(args.seed)
    model = ref_build(ref_cfg)
    base = model.init(key)
    fed = RefFedConfig(lora_rank=args.rank, lr=args.lr, lora_dropout=0.0,
                       lora_targets=ref_lora.default_targets(ref_cfg))
    fns = ref_fedavg.make_fns(model, fed, task="generative")
    lt = ref_lora.init_lora(jax.random.fold_in(key, 1), base,
                            fed.lora_targets, args.rank)
    port_lt = bridge.lora_from_reference(_np(lt), "cpu")
    opt = fns["opt_init"](lt)
    batches = list(_take(train.lm_batches(cfg, args), 5))
    want = []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        key, sub = jax.random.split(key)
        lt, opt, loss = fns["train_step"](base, lt, opt, jb, sub)
        want.append(float(loss))
    # the reference launcher's own batch stream
    ref_stream = ref_synthetic.lm_batches(ref_synthetic.markov_corpus(
        200_000, ref_cfg.vocab_size, seed=args.seed), args.batch, args.seq,
        seed=args.seed)
    for b in batches:
        np.testing.assert_array_equal(
            b["tokens"], next(ref_stream)["tokens"][:, :args.seq])
    res = train.run(args, base=bridge.params_from_reference(_np(base),
                                                            "cpu"),
                    lora=port_lt, batches=iter(batches))
    np.testing.assert_allclose(res.losses, want, atol=1e-4, rtol=0)
    assert res.rc == int(not np.mean(res.losses[-5:])
                         < np.mean(res.losses[:5]))


def _take(it, n):
    for _ in range(n):
        yield next(it)


def test_train_cli_runs_and_checkpoints(tmp_path):
    """``python -m repro_torch.launch.train`` on the CPU runs to its end:
    30 steps of gpt2-tiny (the loss falls: exit 0), a checkpoint at step
    25 that restores into the live tree; and its exit code is the
    improvement it prints at 6 steps, which may go either way over so few
    noisy batches."""
    # one thread, as this module pins its own: beside busy test workers an
    # unpinned torch pool spin-waits, up to ~17 s a step where one
    # thread takes ~0.1 s
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gpt2-tiny", "--steps", "30", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=env, cwd=SRC)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "(improved)" in out.stdout
    assert json.loads((tmp_path / "ckpt_00000025.npz.json").read_text()
                      )["loss"] > 0
    seen = {}
    args = train.parse_args(["--steps", "6", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "six")])
    res = train.run(args, on_step=lambda step, lt, loss: seen.update(
        {step: tree_lib.map_(torch.clone, lt)}))
    assert sorted(seen) == list(range(6))
    improved = np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert res.rc == (0 if improved else 1) == train.main(
        ["--steps", "6", "--device", "cpu"])
    for x, y in zip(tree_lib.leaves(seen[5]), tree_lib.leaves(res.lora)):
        assert torch.equal(x, y)
    with pytest.raises(RuntimeError, match="CUDA") if \
            not torch.cuda.is_available() else contextlib.nullcontext():
        train.main(["--steps", "1"])


def test_train_checkpoints_restore_into_live_tree(tmp_path):
    """--ckpt-dir saves every 25 steps; each restores into the live
    template bit for bit (the LoRA the loop held at that step)."""
    seen = {}
    args = train.parse_args(["--steps", "50", "--device", "cpu", "--seq",
                             "8", "--batch", "2", "--ckpt-dir",
                             str(tmp_path)])
    res = train.run(args, on_step=lambda step, lt, loss: seen.update(
        {step + 1: tree_lib.map_(torch.clone, lt)}))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == [25, 50]
    for step in (25, 50):
        back, meta = mgr.restore(res.lora, step)
        assert meta["loss"] == res.losses[step - 1]
        for x, y in zip(tree_lib.leaves(back), tree_lib.leaves(seen[step])):
            assert torch.equal(x, y)


# --------------------------------------------------------------------------- #
# One generative train step on each reduced family
# --------------------------------------------------------------------------- #
FAMILIES = {"recurrentgemma-2b": dict(n_layers=3),
            "rwkv6-1.6b": {}, "mixtral-8x7b": {},
            "llava-next-34b": {}, "whisper-base": {}}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_generative_step_on_each_family_matches_reference(arch):
    ref_cfg = dataclasses.replace(ref_registry.get_config(arch).reduced(
        d_model=64, **FAMILIES[arch]), kernel_policy="xla")
    cfg = dataclasses.replace(registry.get_config(arch).reduced(
        d_model=64, **FAMILIES[arch]), kernel_policy="torch")
    targets = ref_lora.default_targets(ref_cfg)
    params = _np(ref_build(ref_cfg).init(jax.random.PRNGKey(0)))
    lt = _np(ref_lora.init_lora(jax.random.PRNGKey(1), params, targets,
                                RANK, ALPHA))
    rng = np.random.default_rng(2)
    lt = jax.tree.map(lambda t: (t + 0.01 * rng.standard_normal(t.shape)
                                 ).astype(np.float32), lt)
    args = train.parse_args(["--arch", arch, "--batch", "2", "--seq", "12",
                             "--device", "cpu"])
    batch = next(train.lm_batches(cfg, args))
    fed = dict(lora_rank=RANK, lora_dropout=0.0, lora_targets=targets,
               optimizer="sgd", lr=1.0)
    rf = ref_fedavg.make_fns(ref_build(ref_cfg), RefFedConfig(**fed),
                             task="generative")
    jl = jax.tree.map(jnp.asarray, lt)
    want_lt, _, want_loss = rf["train_step"](
        jax.tree.map(jnp.asarray, params), jl, rf["opt_init"](jl),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    pf = make_fns(build_model(cfg), FedConfig(**fed), task="generative")
    start = bridge.lora_from_reference(lt, "cpu", cfg)
    got_lt, _, got_loss = pf["train_step"](
        bridge.params_from_reference(params, "cpu"), start,
        pf["opt_init"](start), to_device(batch, "cpu"))
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=1e-5,
                               rtol=0)

    def change(tree):
        return torch.cat([(x - s).reshape(-1) for x, s in zip(
            tree_lib.leaves(tree), tree_lib.leaves(start))])

    d_want = change(bridge.lora_from_reference(_np(want_lt), "cpu", cfg))
    gap = float((change(got_lt) - d_want).norm() / d_want.norm())
    assert float(d_want.norm()) > 0 and gap <= 1e-4, gap
