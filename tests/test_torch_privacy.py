"""The port's privacy slice against the reference: DP-SGD per-example
clipping, seeded upload noise, the RDP accountant and simulated
secure aggregation, on FedLLM and KD-FedLLM.

Run parity is at the verify-skill configuration (``gpt2_tiny``,
``paper_splits(scale=0.04, pad_len=24)``, ``iid_partition(train, 3)``,
2 rounds, LoRA rank 4, dropout 0, batch 16, eval batch 64) from bridged
weights, with clipping at ``CLIP`` (about the median per-example gradient
norm of the first batch, so some examples clip and some do not) and
noise 0, on the CPU with the plain kernel policy.  Ledger bytes (with
``dp_meta`` and ``secagg_keys``), client FLOPs and epsilon must be equal
exactly; per-round loss and accuracy within 1e-3 and the final LoRA
within atol 5e-5 / rtol 5e-4, the bar the reference holds its own
backends to.  With noise the port draws torch's numbers, not
``jax.random``'s, so the noise is held to its distribution and its
determinism, not to the reference's bits."""
import dataclasses
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import round_program as ref_rp  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.optim import clip as ref_clip  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro.privacy import accountant as ref_acct  # noqa: E402
from repro.privacy import secure_agg as ref_sa  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core import round_program  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.optim import clip  # noqa: E402
from repro_torch.privacy import accountant, dp, secure_agg  # noqa: E402

SEED = 0
CLIP = 41.0
TARGETS = ("wq", "wk", "wv")
FED = dict(rounds=2, lora_rank=4, lora_dropout=0.0, seed=SEED)
CASES = {"fedllm": dict(framework="fedllm",
                        privacy=dict(dp_clip=CLIP, secure_agg=True)),
         "kd": dict(framework="kd", privacy=dict(dp_clip=CLIP))}


def _data(scale=0.04):
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=scale)
    return cfg, pub, partition.iid_partition(train, 3), test


def _bridged(framework, n_clients):
    """The reference's initial weights for ``framework``, bridged."""
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))

    def draw(key):
        lt = ref_lora.init_lora(key, params, TARGETS, 4, 32.0)
        return bridge.lora_from_reference(jax.tree.map(np.asarray, lt),
                                          "cpu")

    if framework == "fedllm":
        lora = draw(jax.random.PRNGKey(SEED + 1))
    else:
        key = jax.random.PRNGKey(SEED + 2)
        lora = {"clients": [draw(jax.random.fold_in(key, ci))
                            for ci in range(n_clients)],
                "server": draw(jax.random.fold_in(key, 999))}
    return bridge.params_from_reference(params, "cpu"), lora


@pytest.fixture(scope="module")
def runs():
    """{framework: (reference result, port result)}, each run once."""
    cfg, pub, clients, test = _data()
    out = {}
    for name, case in CASES.items():
        priv = case["privacy"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref = ref_run(ref_tiny(), RefFedConfig(
                framework=case["framework"], privacy=RefPrivacy(**priv),
                **FED), pub, clients, test, batch_size=16, eval_batch=64)
        base, lora = _bridged(case["framework"], len(clients))
        port = run_federated(cfg, FedConfig(
            framework=case["framework"], privacy=PrivacyConfig(**priv),
            **FED), pub, clients, test, batch_size=16, eval_batch=64,
            device="cpu", base=base, lora=lora)
        out[name] = (ref, port)
    return out


# --------------------------------------------------------------------------- #
# Runs against the reference (noise 0)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("framework", list(CASES))
def test_dp_ledger_flops_and_epsilon_equal(runs, framework):
    ref, port = runs[framework]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert port.ledger.by_name()["dp_meta"] > 0
    if framework == "fedllm":
        assert port.ledger.by_name()["secagg_keys"] > 0
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.ledger.privacy_overhead_bytes() == \
        ref.ledger.privacy_overhead_bytes()
    assert [(e.round, e.client, e.name, e.direction, e.bytes)
            for e in port.ledger.payload_events()] == \
        [(e.round, e.client, e.name, e.direction, e.bytes)
         for e in ref.ledger.payload_events()]
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.epsilon == hr.epsilon == math.inf
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client


@pytest.mark.parametrize("framework", list(CASES))
def test_dp_round_metrics_close(runs, framework):
    ref, port = runs[framework]
    assert len(port.history) == len(ref.history) == 2
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3


@pytest.mark.parametrize("framework", list(CASES))
def test_dp_final_lora_close(runs, framework):
    ref, port = runs[framework]
    want = jax.tree.map(np.asarray, ref.final_lora)["blocks"]
    got = bridge.lora_to_reference(port.final_lora)["blocks"]
    for layer in range(len(want)):
        for name in TARGETS:
            for factor in ("a", "b"):
                np.testing.assert_allclose(
                    got[layer]["attn"][name][factor],
                    want[layer]["attn"][name][factor], atol=5e-5, rtol=5e-4,
                    err_msg=f"{layer}.{name}.{factor}")


def test_clipping_changes_the_fedllm_run(runs):
    """The clip binds: without privacy the same run ends elsewhere."""
    _, port = runs["fedllm"]
    cfg, pub, clients, test = _data()
    base, lora = _bridged("fedllm", len(clients))
    plain = run_federated(cfg, FedConfig(framework="fedllm", **FED), pub,
                          clients, test, batch_size=16, eval_batch=64,
                          device="cpu", base=base, lora=lora)
    assert set(plain.ledger.by_name()) == {"lora_params"}
    assert all(h.epsilon == 0.0 for h in plain.history)
    a = tree_lib.leaves(plain.final_lora)
    b = tree_lib.leaves(port.final_lora)
    assert max(float((x - y).abs().max()) for x, y in zip(a, b)) > 1e-4


# --------------------------------------------------------------------------- #
# Noise > 0 (port runs at a smaller data scale)
# --------------------------------------------------------------------------- #
NOISY = PrivacyConfig(dp_clip=CLIP, dp_noise_multiplier=0.5)


@pytest.fixture(scope="module")
def noisy_runs():
    cfg, pub, clients, test = _data(scale=0.02)

    def run(priv):
        return run_federated(cfg, FedConfig(framework="fedllm", privacy=priv,
                                            **FED),
                             pub, clients, test, batch_size=16,
                             eval_batch=64, device="cpu")

    return clients, run(NOISY), run(NOISY), run(
        dataclasses.replace(NOISY, seed=7))


def test_noisy_epsilon_matches_reference(noisy_runs):
    clients, a, _, _ = noisy_runs
    acct = ref_rp.make_accountant(
        RefFedConfig(privacy=RefPrivacy(dp_clip=CLIP,
                                        dp_noise_multiplier=0.5)),
        ref_rp.sample_rate(clients, 16))
    want = [ref_rp.round_epsilon(acct, r + 1) for r in range(2)]
    assert [h.epsilon for h in a.history] == want
    assert 0 < want[0] < want[1] < math.inf


def test_noisy_runs_deterministic_and_seeded(noisy_runs):
    _, a, b, other = noisy_runs
    assert [h.loss for h in a.history] == [h.loss for h in b.history]
    for x, y in zip(tree_lib.leaves(a.final_lora),
                    tree_lib.leaves(b.final_lora)):
        assert torch.equal(x, y)
    assert any(not torch.equal(x, y) for x, y in zip(
        tree_lib.leaves(a.final_lora), tree_lib.leaves(other.final_lora)))


def test_upload_noise_has_sigma_c_std():
    """The noise the FedLLM upload adds, on a LoRA-sized tree of zeros:
    mean 0 and std sigma*C within a few standard errors, each leaf on its
    own sub-stream, and the same draws for the same (round, client)."""
    fed = FedConfig(privacy=NOISY)
    std = fed.privacy.noise_std
    assert std == 0.5 * CLIP
    tree = {"a": torch.zeros(300, 64), "b": torch.zeros(64, 300)}
    noisy = dp.privatize_tree(tree, dp.noise_generator(fed, 1, 2), std)
    z = torch.cat([x.reshape(-1) for x in tree_lib.leaves(noisy)]).double()
    n = z.numel()
    assert abs(float(z.mean())) < 4 * std / math.sqrt(n)
    assert abs(float(z.std()) / std - 1) < 4 / math.sqrt(2 * n)
    assert not torch.equal(noisy["a"].reshape(-1), noisy["b"].reshape(-1))
    again = dp.privatize_tree(tree, dp.noise_generator(fed, 1, 2), std)
    assert torch.equal(noisy["a"], again["a"])
    other = dp.privatize_tree(tree, dp.noise_generator(fed, 1, 0), std)
    assert not torch.equal(noisy["a"], other["a"])
    assert dp.privatize_tree(tree, dp.noise_generator(fed, 1, 2), 0.0) \
        is tree


def test_noise_stream_disjoint_from_dropout_stream():
    fed = FedConfig(privacy=NOISY)
    for rnd, ci in ((0, 0), (1, 2), (3, 1)):
        noise = dp.noise_generator(fed, rnd, ci)
        drop = round_program.local_generator(fed, rnd, ci)
        assert noise.initial_seed() != drop.initial_seed()
        assert noise.initial_seed() >= 1 << 62 > drop.initial_seed()
        assert not torch.equal(torch.rand(8, generator=noise),
                               torch.rand(8, generator=drop))
    # (fed.seed, privacy.seed) pairs enter separately
    a = dp.noise_generator(dataclasses.replace(
        fed, seed=0, privacy=dataclasses.replace(NOISY, seed=1)), 0, 0)
    b = dp.noise_generator(dataclasses.replace(
        fed, seed=1, privacy=dataclasses.replace(NOISY, seed=0)), 0, 0)
    assert a.initial_seed() != b.initial_seed()


def test_privatize_logits_clips_rows_then_noises():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((6, 77)).astype(np.float32) * 10)
    quiet = FedConfig(privacy=PrivacyConfig(dp_clip=2.0))
    y = dp.privatize_logits(x, dp.noise_generator(quiet, 0, 0), quiet)
    np.testing.assert_allclose(y.norm(dim=1).numpy(), 2.0, rtol=1e-6)
    want = ref_clip._clip_scale(jnp.linalg.norm(jnp.asarray(x.numpy()),
                                                axis=1, keepdims=True), 2.0)
    np.testing.assert_allclose(y.numpy(), x.numpy() * np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    assert dp.privatize_logits(x, None, FedConfig()) is x
    noisy = FedConfig(privacy=PrivacyConfig(dp_clip=2.0,
                                            dp_noise_multiplier=1.0))
    z = dp.privatize_logits(x, dp.noise_generator(noisy, 0, 0), noisy)
    assert not torch.equal(z, y)


# --------------------------------------------------------------------------- #
# Clip helpers
# --------------------------------------------------------------------------- #
def test_clipped_grad_mean_tree_matches_reference():
    """Flatten -> clip -> unflatten keeps structure and dtype and equals
    the reference's clip_per_example composed with the mean."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(6, 3, 5)).astype(np.float32)
    b = rng.normal(size=(6, 2)).astype(np.float32) * 4
    tree = {"w": torch.tensor(w), "b": torch.tensor(b).bfloat16()}
    out = dp.clipped_grad_mean(tree, 0.7)
    assert out["w"].shape == (3, 5) and out["b"].shape == (2,)
    assert out["b"].dtype == torch.bfloat16
    ref_tree = {"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)}
    clipped, norms = ref_clip.clip_per_example(ref_tree, 0.7)
    want = jax.tree.map(lambda x: jnp.mean(x.astype(jnp.float32), axis=0),
                        clipped)
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(want["w"]),
                               atol=1e-6)
    np.testing.assert_allclose(out["b"].float().numpy(),
                               np.asarray(want["b"]), atol=1e-2)
    got_clipped, got_norms = clip.clip_per_example(tree, 0.7)
    np.testing.assert_allclose(got_norms.numpy(), np.asarray(norms),
                               rtol=1e-6)
    np.testing.assert_allclose(got_clipped["w"].numpy(),
                               np.asarray(clipped["w"]), rtol=1e-6,
                               atol=1e-7)
    # a (B, P) tensor is a tree of one leaf: the kernel's rows in place
    flat = w.reshape(6, -1)
    one, _ = ref_clip.clip_per_example(jnp.asarray(flat), 0.7)
    np.testing.assert_allclose(
        dp.clipped_grad_mean(torch.tensor(flat), 0.7).numpy(),
        np.asarray(jnp.mean(one, axis=0)), atol=1e-6)


def test_clip_helpers_match_reference():
    rng = np.random.default_rng(4)
    tree = {"x": rng.normal(size=(4, 7)).astype(np.float32),
            "y": [rng.normal(size=(3,)).astype(np.float32)]}
    port = tree_lib.map_(torch.tensor, tree)
    ref_tree = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(clip.global_norm(port)),
                               float(ref_clip.global_norm(ref_tree)),
                               rtol=1e-6)
    got, norm = clip.clip_by_global_norm(port, 1.5)
    want, ref_norm = ref_clip.clip_by_global_norm(ref_tree, 1.5)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=1e-6, atol=1e-7)
    zeros = {"x": torch.zeros(2, 3)}
    assert torch.equal(clip.clip_by_global_norm(zeros, 1.0)[0]["x"],
                       zeros["x"])
    assert bool(clip.all_finite(port))
    port["y"][0][1] = float("nan")
    assert not bool(clip.all_finite(port))


# --------------------------------------------------------------------------- #
# Accountant
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sigma", [0.3, 0.8, 1.5, 4.0])
@pytest.mark.parametrize("q", [1.0, 0.25, 0.01])
def test_accountant_epsilon_matches_reference(sigma, q):
    port = accountant.GaussianAccountant(sigma, 1e-5, sample_rate=q)
    ref = ref_acct.GaussianAccountant(sigma, 1e-5, sample_rate=q)
    for steps in (0, 1, 3, 10, 100):
        got, want = port.epsilon(steps), ref.epsilon(steps)
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)
    assert port.closed_form_epsilon(7) == pytest.approx(
        ref.closed_form_epsilon(7), rel=1e-12)
    for order in (2, 5, 32):
        assert accountant.subsampled_gaussian_rdp(order, sigma, q) == \
            pytest.approx(ref_acct.subsampled_gaussian_rdp(order, sigma, q),
                          rel=1e-12)
        assert accountant.rdp_to_eps(1.3, order, 1e-6) == \
            ref_acct.rdp_to_eps(1.3, order, 1e-6)
    assert accountant.GaussianAccountant(0.0).epsilon(3) == math.inf


# --------------------------------------------------------------------------- #
# Secure aggregation
# --------------------------------------------------------------------------- #
def test_secure_agg_masks_match_reference_and_recover_absent():
    """Same payloads through the port's session and the reference's: the
    masked vectors are equal bit for bit, the masks cancel in uint64 with
    an absent member recovered, and key and recovery bytes are equal."""
    rng = np.random.default_rng(5)
    payloads = [{"a": rng.normal(size=(4, 3)).astype(np.float32),
                 "b": [rng.normal(size=(5,)).astype(np.float32)]}
                for _ in range(3)]
    pfed = FedConfig(seed=3, privacy=PrivacyConfig(secure_agg=True, seed=2))
    rfed = RefFedConfig(seed=3, privacy=RefPrivacy(secure_agg=True, seed=2))
    sessions = ((secure_agg.SecureAggSession(pfed), metrics.CommLedger(),
                 lambda p: tree_lib.map_(torch.tensor, p)),
                (ref_sa.SecureAggSession(rfed), ref_metrics.CommLedger(),
                 lambda p: jax.tree.map(jnp.asarray, p)))
    for sess, ledger, conv in sessions:
        sess.begin_cohort(ledger, 0, [0, 1, 2])
        for ci, p in enumerate(payloads):
            sess.collect(0, ci, conv(p))
    (ps, pl, _), (rs, rl, _) = sessions
    for ci in range(3):
        np.testing.assert_array_equal(ps.masked(0, ci), rs.masked(0, ci))
        np.testing.assert_array_equal(
            ps._plain[(0, ci)], secure_agg.flat_fixed_point(
                tree_lib.map_(torch.tensor, payloads[ci]), 24))
    # client 2 is absent: its masks with 0 and 1 are recovered
    ps.deliver(pl, 0, [(0, 0), (0, 1)])
    rs.deliver(rl, 0, [(0, 0), (0, 1)])

    def events(ledger):
        return [(e.round, e.client, e.name, e.direction, e.bytes)
                for e in ledger.events]

    assert events(pl) == events(rl)
    assert pl.by_name() == {"secagg_keys": 3 * (96 + 128),
                            "secagg_recovery": 2 * 32}
    assert secure_agg.key_exchange_bytes(3) == \
        ref_sa.key_exchange_bytes(3) == (96, 128)
    assert pl.privacy_overhead_bytes() == pl.total()
    assert pl.payload_events() == []
    # a masked upload off by one unit does not cancel
    bad = secure_agg.SecureAggSession(pfed)
    bad.begin_cohort(metrics.CommLedger(), 0, [0, 1])
    for ci in range(2):
        bad.collect(0, ci, tree_lib.map_(torch.tensor, payloads[ci]))
    real = bad.masked
    bad.masked = lambda s, c: real(s, c) + np.uint64(c == 0)
    with pytest.raises(AssertionError, match="cancel"):
        bad.deliver(metrics.CommLedger(), 0, [(0, 0), (0, 1)])
