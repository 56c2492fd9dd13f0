"""The pieces shared by the tests that hold the port's Split-FedLLM on
the Griffin hybrid (RecurrentGemma) and on RWKV-6 to the reference's
(tests/test_torch_split_{hybrid,rwkv}*.py, which import this module), on
the CPU, and the tests of what needs no run: the split point and the
wire bytes of both families at their full widths against a hand count.

Both packages start from the reference's ``model.init(PRNGKey(0))`` and
its Split LoRA draw (``init_lora(PRNGKey(3))``, rank 4), bridged; the
port runs on the CPU with the plain kernel policy; the data is
``paper_splits(scale=0.04, pad_len=24)`` over 3 IID clients, batch 16,
eval batch 64, dropout 0, Split after pattern group ``split_layer``.
Each test file runs its settings in one module fixture (``run_pairs``).

Bars: ledger bytes, client FLOPs and epsilon exactly the reference's;
on the continuous paths per-round loss and accuracy within 1e-3 and the
final joined LoRA within atol 5e-5 / rtol 5e-4; one split step's
boundary, c4 gradient and LoRA gradients within atol 1e-5 / rtol 1e-5
(fp32 sums in other orders, gradients up to ~3).  A quantized boundary
turns fp32 noise into level flips (ROADMAP §3), and the runs part as
far as two fp32 runs of the port part from weights one ulp apart
(``NUDGED`` runs of the port, each weight moved one ulp up or down, the
direction drawn from a seed): its first step is held through the
boundary levels (at most 1e-4 of them one level apart); each round's
loss within 1e-3 plus 3x the largest difference of a nudged run's from
the port run's, its accuracy within 1e-3 plus the largest such
difference; and its final LoRA within 3x the largest distance of a
nudged run from the port run (+1e-6): the arithmetic of
chip_smoke.fp32_gates' "spread" paths.  The first step's levels are
taken from ``quantize`` and from the roundtrip the split step applies.
The control of these bars: the port with its boundary quantizer one
level off on one row in 64 (``planted_roundtrip``) must fail the first
step's levels, and the run-level bar each test file names, against the
same nudged spread; an fp64 run of the port (its boundary levels still
fp32's) shows how far the reference's gap is from one more sample of
the fp32 noise."""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.configs.recurrentgemma_2b import config as ref_rg2b  # noqa: E402
from repro.configs.rwkv6_1_6b import config as ref_rwkv  # noqa: E402
from repro.core import compression as ref_compression  # noqa: E402
from repro.core import split as ref_split  # noqa: E402
from repro.core import tasks as ref_tasks  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import recurrentgemma_2b  # noqa: E402
from repro_torch.configs.rwkv6_1_6b import rwkv6_1_6b  # noqa: E402
from repro_torch.core import compression, split  # noqa: E402
from repro_torch.core.fedavg import to_device  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.data.loader import epoch_batches  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

SEED, RANK, ALPHA = 0, 4, 32.0
NUDGED = 5
FAMILIES = {
    "hybrid": (ref_rg2b, recurrentgemma_2b, ("wq", "wk", "wv")),
    "rwkv": (ref_rwkv, rwkv6_1_6b, lora_lib.RWKV_TARGETS),
}


def cfgs(family: str, layers: int):
    """(reference, port) configs of the family reduced to ``layers``
    layers of width 128."""
    ref_fn, port_fn, _ = FAMILIES[family]
    ref_cfg = dataclasses.replace(ref_fn().reduced(n_layers=layers,
                                                   d_model=128),
                                  kernel_policy="xla")
    return ref_cfg, port_fn().reduced(n_layers=layers, d_model=128)


def targets(family: str):
    return FAMILIES[family][2]


@functools.lru_cache(maxsize=None)
def weights(family: str, layers: int):
    """The reference's base and Split LoRA draws, as numpy trees (drawn
    once; callers do not change them)."""
    ref_cfg, _ = cfgs(family, layers)
    params = jax.tree.map(np.asarray,
                          ref_build(ref_cfg).init(jax.random.PRNGKey(SEED)))
    lt = ref_lora.init_lora(jax.random.PRNGKey(SEED + 3), params,
                            targets(family), RANK, ALPHA)
    return params, jax.tree.map(np.asarray, lt)


@functools.lru_cache(maxsize=None)
def bridged(family: str, layers: int):
    """(base, full LoRA tree) of ``weights`` in the port's layout."""
    params, lt = weights(family, layers)
    return (bridge.params_from_reference(params, "cpu"),
            bridge.lora_from_reference(lt, "cpu", cfgs(family, layers)[1]))


def data():
    pub, train, test = banking77.paper_splits(512, pad_len=24, scale=0.04)
    return pub, partition.iid_partition(train, 3), test


def fed_configs(family: str, setting: dict):
    """(reference, port) FedConfigs of a setting: {"layers", "rounds",
    "split_layer", and FedConfig fields; "privacy": PrivacyConfig
    fields}."""
    extra = {k: v for k, v in setting.items() if k != "layers"}
    priv = extra.pop("privacy", None)
    kw = dict(framework="split", lora_rank=RANK, lora_dropout=0.0, seed=SEED,
              lora_targets=targets(family), **extra)
    return (RefFedConfig(**kw, **({"privacy": RefPrivacy(**priv)}
                                  if priv else {})),
            FedConfig(**kw, **({"privacy": PrivacyConfig(**priv)}
                               if priv else {})))


def nudged(base, seed: int):
    """``base`` with every weight moved one ulp up or down, the direction
    drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def move(t):
        up = torch.rand(t.shape, generator=gen) < 0.5
        inf = torch.full_like(t, math.inf)
        return torch.where(up, torch.nextafter(t, inf),
                           torch.nextafter(t, -inf))
    return tree_lib.map_(move, base)


def fp64(tree):
    return tree_lib.map_(
        lambda t: t.double() if t.is_floating_point() else t, tree)


_ROUNDTRIP = compression.quant_roundtrip


def planted_roundtrip(x, bits: int = 8):
    """compression.quant_roundtrip with a planted fault: every 64th row
    of the boundary comes back one level (its row's scale) too high."""
    y, n_bytes = _ROUNDTRIP(x, bits)
    rows = y.reshape(-1, y.shape[-1]).clone()
    qmax = 2 ** (bits - 1) - 1
    rows[::64] += rows[::64].abs().amax(-1, keepdim=True) / qmax
    return rows.reshape(y.shape), n_bytes


def run_pairs(family: str, settings: dict, quantized=()):
    """{setting: (reference result, port result)}, and for each setting of
    ``quantized`` (None, port result) under "<setting> nudged <i>" (the
    port's run from nudged(base, i)) for i < NUDGED, "<setting> planted"
    (with planted_roundtrip at the boundary) and "<setting> fp64" (from
    fp64 copies of the weights)."""
    pub, clients, test = data()
    out, trees = {}, {}
    for name, setting in settings.items():
        layers = setting["layers"]
        ref_cfg, cfg = cfgs(family, layers)
        if layers not in trees:
            trees[layers] = bridged(family, layers)
        base, lora = trees[layers]
        ref_fed, fed = fed_configs(family, setting)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref = ref_run(dataclasses.replace(ref_cfg, kernel_policy="auto"),
                          ref_fed, pub, clients, test, batch_size=16,
                          eval_batch=64)
        out[name] = (ref, run_federated(cfg, fed, pub, clients, test,
                                        batch_size=16, eval_batch=64,
                                        device="cpu", base=base, lora=lora))
        if name not in quantized:
            continue

        def port_run(b, lt):
            return None, run_federated(cfg, fed, pub, clients, test,
                                       batch_size=16, eval_batch=64,
                                       device="cpu", base=b, lora=lt)
        for i in range(NUDGED):
            out[f"{name} nudged {i}"] = port_run(nudged(base, i), lora)
        with mock.patch.object(compression, "quant_roundtrip",
                               planted_roundtrip):
            out[f"{name} planted"] = port_run(base, lora)
        out[f"{name} fp64"] = port_run(fp64(base), fp64(lora))
    return out


def final_leaves(result, family: str, layers: int):
    """A port result's final LoRA as the reference's leaves."""
    return jax.tree.leaves(bridge.lora_to_reference(
        result.final_lora, cfgs(family, layers)[1]))


def rel_l2(got, want) -> float:
    num = sum(float(((np.float64(g) - np.float64(w)) ** 2).sum())
              for g, w in zip(got, want))
    return math.sqrt(num / sum(float((np.float64(w) ** 2).sum())
                               for w in want))


# --------------------------------------------------------------------------- #
# The checks
# --------------------------------------------------------------------------- #
def assert_accounting_equal(ref, port):
    """Ledger bytes, client FLOPs and epsilon exactly the reference's."""
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in ref.client_flops]
    assert len(port.history) == len(ref.history)
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client
        assert hp.epsilon == hr.epsilon


def assert_rounds_close(ref, port):
    assert all(math.isfinite(h.loss) for h in ref.history)
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3


def assert_final_lora_close(ref, port, family, layers, n_leaves):
    got = final_leaves(port, family, layers)
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref.final_lora))
    assert len(got) == len(want) == n_leaves
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4)


def assert_rounds_within_flip_floor(runs, setting, judged=None):
    """Each round's loss within 1e-3 + 3x, its accuracy within 1e-3 + 1x,
    the largest difference of a nudged port run's from the port run's
    (the run held to the bar is the port run, or "<setting> <judged>")."""
    ref, port = runs[setting]
    judged = runs[f"{setting} {judged}"][1] if judged else port
    nudged_runs = [runs[f"{setting} nudged {i}"][1] for i in range(NUDGED)]
    assert all(math.isfinite(h.loss) for h in ref.history)
    for r, (hp, hr) in enumerate(zip(port.history, ref.history)):
        d_loss = max(abs(n.history[r].loss - hp.loss) for n in nudged_runs)
        d_acc = max(abs(n.history[r].accuracy - hp.accuracy)
                    for n in nudged_runs)
        hj = judged.history[r]
        assert abs(hj.loss - hr.loss) <= 1e-3 + 3.0 * d_loss, (r, d_loss)
        assert abs(hj.accuracy - hr.accuracy) <= 1e-3 + d_acc, (r, d_acc)


def flip_floor_readings(runs, setting, family, layers):
    """Relative L2 distances of final LoRAs: ``gap`` port from reference,
    ``nudged`` each nudged run from the port, ``floor`` their largest,
    ``nearest`` the reference from the nearest of the port run and its
    nudged runs, ``planted`` and ``fp64`` those runs from the reference
    and ``fp64_port`` the fp64 run from the port."""
    ref, port = runs[setting]
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref.final_lora))
    mine = final_leaves(port, family, layers)

    def of(key):
        return final_leaves(runs[f"{setting} {key}"][1], family, layers)
    nudged_d = [rel_l2(of(f"nudged {i}"), mine) for i in range(NUDGED)]
    gap = rel_l2(mine, want)
    return dict(gap=gap, nudged=nudged_d, floor=max(nudged_d),
                nearest=min([gap] + [rel_l2(of(f"nudged {i}"), want)
                                     for i in range(NUDGED)]),
                planted=rel_l2(of("planted"), want),
                fp64=rel_l2(of("fp64"), want),
                fp64_port=rel_l2(of("fp64"), mine))


def assert_final_lora_within_flip_floor(runs, setting, family, layers,
                                        judged=None):
    """The port's final LoRA (or run "<setting> <judged>"'s) within 3x the
    largest distance of the port's nudged runs from the port's (+1e-6)."""
    got = flip_floor_readings(runs, setting, family, layers)
    gap, floor = got[judged or "gap"], got["floor"]
    assert floor > 0.0
    assert gap <= 3.0 * floor + 1e-6, (gap, floor)


def assert_split_ledger_by_hand(port, cfg, rounds, half, dp: bool):
    """int8: per step c2 = rows * (d + 4) + 16 int32 labels and c4 = rows
    * (d + 4) (and a 12-byte dp_meta with DP); the client half (``half``
    bytes, fp32) down and up each round; 12 steps a round."""
    rows, d, steps = 16 * 24, cfg.d_model, 12
    got = port.ledger.by_name()
    assert got["lora_params"] == rounds * 3 * 2 * half
    assert got["activations"] == rounds * steps * (rows * (d + 4) + 16 * 4)
    assert got["act_grads"] == rounds * steps * rows * (d + 4)
    assert got.get("dp_meta", 0) == (rounds * steps * 12 if dp else 0)


def assert_spmd_is_sequential(seq, spmd):
    """The server half threads client after client under ``spmd``: the
    sequential run's steps on the same batches, so the same bits."""
    assert [h.loss for h in spmd.history] == [h.loss for h in seq.history]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(spmd.final_lora), tree_lib.leaves(seq.final_lora)))
    assert spmd.ledger.by_name() == seq.ledger.by_name()


# --------------------------------------------------------------------------- #
# One split step, compared directly
# --------------------------------------------------------------------------- #
def first_step(family: str, layers: int, split_layer: int):
    """The port's split fns, halves (base_c, base_s, c_lt, s_lt) and client
    0's first batch at the bridged weights, fp32 boundary."""
    _, cfg = cfgs(family, layers)
    base, lora = bridged(family, layers)
    _, fed = fed_configs(family, dict(layers=layers, split_layer=split_layer))
    sfns = split.make_split_fns(build_model(cfg), fed)
    n = sfns["n_client_layers"]
    c_lt, s_lt = split.split_lora(lora, n)
    base_c, base_s = split.split_base(base, n)
    batch = next(iter(epoch_batches(data()[1][0], 16, seed=SEED * 983)))
    return sfns, (base_c, base_s, c_lt, s_lt), batch


def ref_split_parts(family: str, layers: int, split_layer: int, batch):
    """The reference's split step taken apart, as core/split.split_step
    computes it (bits 0, no dropout, no DP): (loss, the joined LoRA
    gradient of both halves, h, h_grad, the loss of the reference's own
    split_train_step)."""
    ref_cfg, _ = cfgs(family, layers)
    params, lt = weights(family, layers)
    fed, _ = fed_configs(family, dict(layers=layers, split_layer=split_layer))
    sfns = ref_split.make_split_fns(ref_build(ref_cfg), fed)
    L, G = sfns["n_client_groups"], sfns["n_groups"]
    c_lt, s_lt = ref_split.split_lora(lt, L)
    base_c, base_s = ref_split.split_base(params, L, False)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    task_loss = ref_tasks.get_loss_fn("classification")

    def bind(base, tree):
        return ref_lora.bind(base, tree, ALPHA, RANK, dropout=0.0)

    def client_fwd(cl):
        bound = bind(base_c, cl)
        h, pos = ref_tf.embed_tokens(bound, ref_cfg, batch["tokens"], None)
        return ref_tf.forward_groups(bound, ref_cfg, h, pos, 0, L)[0]

    def server_fwd(sl, h_in):
        bound = bind(base_s, sl)
        B, Sp = h_in.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(Sp, dtype=jnp.int32)[None],
                               (B, Sp))
        h, aux = ref_tf.forward_groups(bound, ref_cfg, h_in, pos, 0, G - L,
                                       include_tail=True)
        h = ref_common.apply_norm(ref_cfg.norm, bound["final_norm"], h)
        return task_loss(ref_tf.lm_logits(bound, ref_cfg, h), batch)[0] + aux

    h, vjp = jax.vjp(jax.jit(client_fwd), c_lt)
    loss, (s_grads, h_grad) = jax.jit(jax.value_and_grad(
        server_fwd, (0, 1)))(s_lt, h)
    (c_grads,) = vjp(h_grad)
    opt = sfns["opt_init"]
    own = sfns["split_train_step"](base_c, base_s, c_lt, s_lt, opt(c_lt),
                                   opt(s_lt), batch,
                                   jax.random.PRNGKey(0))[-1]
    return (loss, ref_split.join_lora(c_grads, s_grads), np.asarray(h),
            np.asarray(h_grad), own)


def assert_split_step_matches(family: str, layers: int, split_layer: int,
                              n_leaves: int):
    """One split step from the same weights and batch, bits 0: the
    boundary h, the c4 gradient, the joined LoRA gradient of both halves
    and the loss at atol 1e-5; returns the port's split fns."""
    sfns, (base_c, base_s, c_lt, s_lt), batch = first_step(family, layers,
                                                           split_layer)
    ref_loss, ref_grads, ref_h, ref_hg, own = ref_split_parts(
        family, layers, split_layer, batch)
    assert abs(float(ref_loss) - float(own)) <= 1e-6   # taken apart right
    loss, c_grads, s_grads, h, h_grad = sfns["split_grads"](
        base_c, base_s, c_lt, s_lt, to_device(batch, "cpu"))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    np.testing.assert_allclose(h.numpy(), ref_h, atol=1e-5)
    np.testing.assert_allclose(h_grad.numpy(), ref_hg, atol=1e-5)
    assert np.abs(ref_hg).max() > 0
    joined = split.join_lora(tree_lib.unflatten(c_lt, c_grads),
                             tree_lib.unflatten(s_lt, s_grads))
    got = jax.tree.leaves(bridge.lora_to_reference(
        joined, cfgs(family, layers)[1]))
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_grads))
    assert len(got) == len(want) == n_leaves
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    return sfns


def assert_boundary_levels_match(family: str, layers: int, split_layer: int,
                                 bits: int):
    """The c2 and c4 levels of the first step, from ``quantize`` and from
    the roundtrip the split step applies (``quant_roundtrip``'s values
    over the reference's row scales): the port's equal the reference's
    but for level flips (at most 1e-4 of them, one level apart)."""
    sfns, halves, batch = first_step(family, layers, split_layer)
    _, _, ref_h, ref_hg, _ = ref_split_parts(family, layers, split_layer,
                                             batch)
    _, _, _, h, h_grad = sfns["split_grads"](*halves,
                                             to_device(batch, "cpu"))
    for name, got, want in (("c2", h, ref_h), ("c4", h_grad, ref_hg)):
        comp = compression.quantize(got, bits)[0]
        q = comp["q"].numpy() if bits == 8 else \
            compression.unpack_int4(comp["q4"], got.shape[-1]).numpy()
        ref_comp = ref_compression.quantize(jnp.asarray(want), bits)[0]
        ref_q = np.asarray(ref_comp["q"]) if bits == 8 else np.asarray(
            ref_compression.unpack_int4(ref_comp["q4"], want.shape[-1]))
        trip = compression.quant_roundtrip(got, bits)[0].numpy()
        trip_q = np.rint(trip / np.asarray(ref_comp["scale"]))
        for what, levels in (("quantize", q), ("roundtrip", trip_q)):
            diff = np.abs(levels.astype(np.int32) - ref_q.astype(np.int32))
            assert diff.max() <= 1, (name, what)
            assert int((diff > 0).sum()) <= 1e-4 * diff.size, (name, what)


# --------------------------------------------------------------------------- #
# Split point and wire bytes at full width
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_full_width_split_point_and_wire_bytes_by_hand(family, bits):
    """At the full configs (RecurrentGemma-2B: d 2560, 8 groups of 3 and
    a 2-layer tail; RWKV-6 1.6B: d 2048, 24 groups of 1) and split_layer
    2: L, the group count and the client's layers equal the reference's,
    and the per-step c2/c4 bytes of a (16, 80) batch equal a hand count
    (bits 0: 4 bytes a value; int8: a level a value and a 4-byte scale a
    row; int4: two levels a byte, rounded up a row, and the scale) and
    the reference's."""
    ref_fn, port_fn, tgts = FAMILIES[family]
    ref_cfg, cfg = ref_fn(), port_fn()
    fed = FedConfig(framework="split", split_layer=2, lora_targets=tgts,
                    activation_quant_bits=bits)
    ref_fed = RefFedConfig(framework="split", split_layer=2,
                           lora_targets=tgts, activation_quant_bits=bits)
    got = split.make_split_fns(build_model(cfg), fed)
    want = ref_split.make_split_fns(ref_build(ref_cfg), ref_fed)
    d = {"hybrid": 2560, "rwkv": 2048}[family]
    assert cfg.d_model == d
    assert got["n_client_groups"] == want["n_client_groups"] == 2
    assert got["n_groups"] == want["n_groups"] == \
        {"hybrid": 8, "rwkv": 24}[family]
    assert got["n_client_layers"] == {"hybrid": 6, "rwkv": 2}[family]
    rows = 16 * 80
    payload = {0: rows * d * 4, 8: rows * d, 4: rows * (d // 2)}[bits]
    hand = payload + (rows * 4 if bits else 0)
    assert got["wire_bytes_per_batch"]((16, 80)) == \
        want["wire_bytes_per_batch"]((16, 80)) == (hand, hand)
