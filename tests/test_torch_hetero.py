"""The port's heterogeneous client ranks (paper SSIV.A.2) against the
reference's, on the CPU: ``peft/lora``'s ``pad_rank``, ``truncate_rank``,
``maybe_truncate_rank``, ``svd_truncate`` and ``map_factors``, and
``core/heterogeneous`` (``normalize_ranks``, ``aggregate_hetero`` zeropad
and svd) on seeded numpy trees; and FedLLM under ``hetero_agg`` "zeropad" and "svd" and
Split-FedLLM under "svd", with ``client_ranks``, at the verify-skill
configuration
(``gpt2_tiny``, ``paper_splits(scale=0.04, pad_len=24)``, 3 IID clients,
global rank 4, dropout 0, 2 rounds; Split at layer 2 with an fp32
boundary), from the reference's initial weights bridged (Split under
"zeropad" runs in tests/test_torch_async.py, async with ranks 2, 4, 4).

Bars: ledger bytes and client FLOPs exactly the reference's; round loss and
accuracy within 1e-3; the final LoRA within atol 5e-5 / rtol 5e-4.  An
SVD's column signs (and a rotation within equal singular values) are the
library's choice, and LAPACK under jax and under torch may choose
differently, so wherever an svd harmonization made a tree it is compared
through its deltas alpha / r * A @ B, at the same bar.  The pieces on
numpy trees are held at atol 1e-6 (zeropad: the same fp32 products) and
the svd deltas at atol 1e-5 / rtol 1e-5 (two LAPACK SVDs in fp32).
KD-FedLLM with heterogeneous ranks runs in tests/test_torch_async_kd.py,
its clients each at their own rank (KD aggregates no parameters, so
``hetero_agg`` does not reach it)."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core import heterogeneous as ref_hetero  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.core import heterogeneous  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

SEED, RANK, ALPHA = 0, 4, 32.0
TARGETS = ("wq", "wk", "wv")
RUNS = {
    "fedllm-zeropad": dict(framework="fedllm", client_ranks=(2, 4, 1)),
    "fedllm-svd": dict(framework="fedllm", client_ranks=(1, 2, 4),
                       hetero_agg="svd"),
    "split-svd": dict(framework="split", client_ranks=(1, 2, 4),
                      hetero_agg="svd"),
}
LORA_KEY = {"fedllm": SEED + 1, "split": SEED + 3}


# --------------------------------------------------------------------------- #
# The pieces on seeded trees
# --------------------------------------------------------------------------- #
def _ref_tree(seed, rank, layers=2, d=16, f=12):
    """A reference LoRA tree (blocks stacked over ``layers``) with random
    A and B."""
    rng = np.random.default_rng(seed)
    attn = {t: {"a": rng.standard_normal((layers, d, rank)).astype(
                    np.float32),
                "b": rng.standard_normal((layers, rank, f)).astype(
                    np.float32) * 0.1}
            for t in TARGETS}
    return {"blocks": ({"attn": attn},)}


def _port(tree):
    return bridge.lora_from_reference(tree, "cpu")


def _back(tree):
    return jax.tree.leaves(bridge.lora_to_reference(tree))


def _deltas(leaves):
    """alpha / r * A @ B of each (A, B) pair of a leaves list (A first)."""
    return [ALPHA / a.shape[-1] * np.einsum("...dr,...rf->...df",
                                            np.float64(a), np.float64(b))
            for a, b in zip(leaves[::2], leaves[1::2])]


@pytest.mark.parametrize("rank,target", [(2, 4), (4, 4), (3, 8), (1, 6)])
def test_pad_and_truncate_match_reference(rank, target):
    """pad_rank (with and without rescale), truncate_rank and
    maybe_truncate_rank give the reference's values; the port's
    truncated factors are contiguous, as the fused kernels take them."""
    ref = _ref_tree(rank + target, rank)
    port = _port(ref)
    for rescale in (True, False):
        got = _back(lora_lib.pad_rank(port, target, rescale))
        want = jax.tree.leaves(ref_lora.pad_rank(ref, target, rescale))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
    wide = _ref_tree(rank + 1, target)
    for cut in (1, rank):
        got = lora_lib.maybe_truncate_rank(_port(wide), cut, target)
        want = ref_lora.maybe_truncate_rank(wide, cut, target)
        for g, w in zip(_back(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
        assert all(t.is_contiguous() for t in
                   lora_lib.truncate_rank(_port(wide), cut, target)
                   ["layers"][0]["attn"]["wq"].values())
    same = _port(wide)
    assert lora_lib.maybe_truncate_rank(same, target, target) is same


def test_svd_truncate_keeps_the_reference_product():
    """svd_truncate's U·S and Vᵀ, multiplied back, are the reference's
    product (a stacked (3, 20, 12) delta of rank 5, kept at 3 and 5)."""
    rng = np.random.default_rng(3)
    delta = (rng.standard_normal((3, 20, 5)) @ rng.standard_normal(
        (3, 5, 12))).astype(np.float32)
    for r in (3, 5):
        u, vt = lora_lib.svd_truncate(torch.tensor(delta), r)
        ru, rvt = ref_lora.svd_truncate(jnp.asarray(delta), r)
        assert u.shape == (3, 20, r) and vt.shape == (3, r, 12)
        np.testing.assert_allclose((u @ vt).numpy(),
                                   np.asarray(ru @ rvt), atol=1e-5,
                                   rtol=1e-5)
        if r == 5:
            np.testing.assert_allclose((u @ vt).numpy(), delta, atol=1e-4)


@pytest.mark.parametrize("method", ["zeropad", "svd"])
def test_aggregate_hetero_matches_reference(method):
    """Three trees of ranks 1, 2, 4 with weights 3, 1, 2: zeropad's
    factors, svd's deltas."""
    ranks, weights = [1, 2, 4], [3.0, 1.0, 2.0]
    refs = [_ref_tree(10 + r, r) for r in ranks]
    ports = [_port(t) for t in refs]
    got = heterogeneous.aggregate_hetero(ports, ranks, ALPHA, 4, weights,
                                         method)
    want = ref_hetero.aggregate_hetero(refs, ranks, ALPHA, 4, weights,
                                       method)
    got_l, want_l = _back(got), [np.asarray(x)
                                 for x in jax.tree.leaves(want)]
    assert [g.shape for g in got_l] == [w.shape for w in want_l]
    if method == "zeropad":
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(g, w, atol=1e-6)
    else:
        for g, w in zip(_deltas(got_l), _deltas(want_l)):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        heterogeneous.aggregate_hetero(ports, ranks, ALPHA, 4, weights,
                                       "bogus")


@pytest.mark.parametrize("ranks,n,global_rank", [
    (None, 3, 8), ((), 2, 4), ((2, 4, 8), 3, 8), ((1,), 1, 1),
    ((2, 4), 3, 8), ((2, 9, 4), 3, 8), ((0, 4, 4), 3, 4)])
def test_normalize_ranks_matches_reference(ranks, n, global_rank):
    try:
        want = ref_hetero.normalize_ranks(ranks, n, global_rank)
    except ValueError:
        with pytest.raises(ValueError):
            heterogeneous.normalize_ranks(ranks, n, global_rank)
        return
    assert heterogeneous.normalize_ranks(ranks, n, global_rank) == want


def test_map_factors_over_several_trees_keeps_none_layers():
    """map_factors hands fn the matching {"a", "b"} leaves of every tree,
    one call a leaf in tree order, and keeps the first tree's containers
    and its None layers (the RG-LRU layers of a hybrid hold no LoRA);
    pad_rank through it keeps each delta exactly."""
    one = _port(_ref_tree(4, 2))
    two = _port(_ref_tree(5, 2))
    for t in (one, two):
        t["layers"] = [None] + list(t["layers"]) + [None]
    seen = []

    def fn(x, y):
        seen.append((x, y))
        return {"a": x["a"] + y["a"], "b": x["b"] - y["b"]}

    got = lora_lib.map_factors(fn, one, two)
    assert got["layers"][0] is None and got["layers"][-1] is None
    assert len(got["layers"]) == len(one["layers"])
    want = [(t1["attn"][k], t2["attn"][k])
            for t1, t2 in zip(one["layers"], two["layers"]) if t1
            for k in TARGETS]
    assert len(seen) == len(want) == 2 * len(TARGETS)
    assert all(x is wx and y is wy for (x, y), (wx, wy) in zip(seen, want))
    for i, (g, x, y) in enumerate(zip(tree_lib.leaves(got),
                                      tree_lib.leaves(one),
                                      tree_lib.leaves(two))):
        assert torch.equal(g, x - y if i % 2 else x + y)
    padded = lora_lib.pad_rank(one, 8)
    assert padded["layers"][0] is None
    got, want = tree_lib.leaves(padded), tree_lib.leaves(one)
    assert got[0].shape[-1] == 8
    for g, w in zip(_deltas([x.numpy() for x in got]),
                    _deltas([x.numpy() for x in want])):
        np.testing.assert_allclose(g, w, atol=1e-5)


# --------------------------------------------------------------------------- #
# FedLLM and Split with heterogeneous ranks, against the reference
# --------------------------------------------------------------------------- #
def _data():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    return cfg, pub, partition.iid_partition(train, 3), test


@pytest.fixture(scope="module")
def runs():
    """{case: (reference result, port result)}, each from the reference's
    initial weights and its LoRA draw (rank 4) bridged."""
    cfg, pub, clients, test = _data()
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    base = bridge.params_from_reference(params, "cpu")
    out = {}
    for name, extra in RUNS.items():
        kw = dict(rounds=2, lora_rank=RANK, lora_dropout=0.0, seed=SEED,
                  split_layer=2, **extra)
        lt = ref_lora.init_lora(jax.random.PRNGKey(LORA_KEY[kw["framework"]]),
                                params, TARGETS, RANK, ALPHA)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref = ref_run(ref_tiny(), RefFedConfig(**kw), pub, clients, test,
                          batch_size=16, eval_batch=64)
        port = run_federated(cfg, FedConfig(**kw), pub, clients, test,
                             batch_size=16, eval_batch=64, device="cpu",
                             base=base, lora=bridge.lora_from_reference(
                                 jax.tree.map(np.asarray, lt), "cpu"))
        out[name] = (ref, port)
    return out


@pytest.mark.parametrize("case", list(RUNS))
def test_hetero_ledger_and_flops_equal(runs, case):
    """Each client downloads the global tree truncated to its rank and
    uploads its own rank's tree: the reference's bytes; the weak clients
    move fewer."""
    ref, port = runs[case]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
    ranks = RUNS[case]["client_ranks"]
    lora = {ci: sum(e.bytes for e in port.ledger.events
                    if e.client == ci and e.name == "lora_params")
            for ci in range(3)}
    assert sorted(lora, key=lora.get) == sorted(range(3),
                                                key=ranks.__getitem__)


@pytest.mark.parametrize("case", list(RUNS))
def test_hetero_rounds_and_final_lora_close(runs, case):
    """Round loss and accuracy within 1e-3; the final LoRA (the global
    tree, or Split's joined one) within atol 5e-5 / rtol 5e-4, compared
    through its deltas where an svd harmonization made it."""
    ref, port = runs[case]
    assert len(port.history) == len(ref.history) == 2
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    got = _back(port.final_lora)
    want = [np.asarray(x) for x in jax.tree.leaves(ref.final_lora)]
    assert [g.shape for g in got] == [w.shape for w in want]
    if RUNS[case].get("hetero_agg") == "svd":
        got, want = _deltas(got), _deltas(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)


def test_hetero_ranks_under_spmd_match_sequential(runs):
    """Ranks below the global one under ``spmd``: one stacked program a
    rank bucket, the stacked truncated trees contiguous.  The sequential
    zeropad run's ledger and FLOPs exactly, its rounds within 1e-3 and
    its final LoRA within atol 5e-5 / rtol 5e-4 (the spmd runs against
    the reference's: tests/test_torch_spmd_dp.py)."""
    cfg, pub, clients, test = _data()
    _, seq = runs["fedllm-zeropad"]
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    lt = ref_lora.init_lora(jax.random.PRNGKey(LORA_KEY["fedllm"]), params,
                            TARGETS, RANK, ALPHA)
    spmd = run_federated(
        cfg, FedConfig(rounds=2, lora_rank=RANK, lora_dropout=0.0, seed=SEED,
                       backend="spmd", **RUNS["fedllm-zeropad"]),
        pub, clients, test, batch_size=16, eval_batch=64, device="cpu",
        base=bridge.params_from_reference(params, "cpu"),
        lora=bridge.lora_from_reference(jax.tree.map(np.asarray, lt), "cpu"))
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
