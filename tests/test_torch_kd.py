"""The port's KD-FedLLM slice against the reference: logit distillation
with sequential clients and sync rounds at the verify-skill configuration
(``gpt2_tiny``, ``paper_splits(scale=0.04, pad_len=24)``,
``iid_partition(train, 3)``, 2 rounds, LoRA rank 4 on wq/wk/wv, dropout 0,
batch 16, eval batch 64), dense logits and top-k 8 with int8.

The port starts from the reference's ``model.init(PRNGKey(seed))`` and its
KD LoRA draws (``init_lora(fold_in(PRNGKey(seed + 2), ci))`` per client,
``fold_in(..., 999)`` for the server), bridged, and runs on the CPU with
the plain kernel policy.  Ledger bytes and client FLOPs must be equal
exactly (they are shape-derived); per-round loss and accuracy within 1e-3
and the final server LoRA within atol 5e-5 / rtol 5e-4, the bar the
reference holds its own backends to."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.gpt2_small import gpt2_tiny as ref_tiny  # noqa: E402
from repro.core import compression as ref_compression  # noqa: E402
from repro.core import kd as ref_kd  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.quantize import topk_quantize_rows as jax_topk  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.core import compression, kd  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SEED = 0
FED = dict(framework="kd", rounds=2, lora_rank=4, lora_dropout=0.0,
           seed=SEED)
SETTINGS = {"dense": {}, "top8-int8": dict(logit_topk=8, logit_quant_bits=8)}
TARGETS = ("wq", "wk", "wv")


def _data():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    return cfg, pub, partition.iid_partition(train, 3), test


def _bridged_weights(n_clients):
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    key = jax.random.PRNGKey(SEED + 2)

    def draw(i):
        lt = ref_lora.init_lora(jax.random.fold_in(key, i), params, TARGETS,
                                4, 32.0)
        return bridge.lora_from_reference(jax.tree.map(np.asarray, lt),
                                          "cpu")

    lora = {"clients": [draw(ci) for ci in range(n_clients)],
            "server": draw(999)}
    return bridge.params_from_reference(params, "cpu"), lora


@pytest.fixture(scope="module")
def runs():
    """{setting: (reference result, port result)}, each run once."""
    cfg, pub, clients, test = _data()
    base, lora = _bridged_weights(len(clients))
    out = {}
    for name, extra in SETTINGS.items():
        with pytest.warns(DeprecationWarning):
            ref = ref_run(ref_tiny(), RefFedConfig(**FED, **extra), pub,
                          clients, test, batch_size=16, eval_batch=64)
        port = run_federated(cfg, FedConfig(**FED, **extra), pub, clients,
                             test, batch_size=16, eval_batch=64,
                             device="cpu", base=base, lora=lora)
        out[name] = (ref, port)
    return out


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_kd_ledger_and_flops_equal(runs, setting):
    ref, port = runs[setting]
    assert port.ledger.by_name() == ref.ledger.by_name()
    assert set(port.ledger.by_name()) == {"logits"}
    assert port.ledger.per_client_round() == ref.ledger.per_client_round()
    assert port.ledger.total("up") == ref.ledger.total("up")
    assert port.ledger.total("down") == ref.ledger.total("down")
    assert port.client_flops == [float(f) for f in ref.client_flops]
    for hp, hr in zip(port.history, ref.history):
        assert hp.client_flops == hr.client_flops
        assert hp.comm_bytes_per_client == hr.comm_bytes_per_client


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_kd_round_metrics_close(runs, setting):
    ref, port = runs[setting]
    assert len(port.history) == len(ref.history) == 2
    for hp, hr in zip(port.history, ref.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_kd_final_server_lora_close(runs, setting):
    ref, port = runs[setting]
    want = jax.tree.map(np.asarray, ref.final_lora)["blocks"][0]["attn"]
    got = bridge.lora_to_reference(port.final_lora)["blocks"][0]["attn"]
    assert sorted(got) == sorted(want) == sorted(TARGETS)
    for name in want:
        for factor in ("a", "b"):
            np.testing.assert_allclose(got[name][factor], want[name][factor],
                                       atol=5e-5, rtol=5e-4,
                                       err_msg=f"{name}.{factor}")


def _logits(seed=3):
    x = (np.random.default_rng(seed).standard_normal((150, 77)) * 3
         ).astype(np.float32)
    x[0] = 2.0                                   # a row of ties
    x[1, [4, 40, 9]] = 11.0
    return x


@pytest.mark.parametrize("topk", [0, 8])
@pytest.mark.parametrize("bits", [0, 4, 8])
def test_compress_for_wire_matches_reference(topk, bits):
    """b3 payload and wire bytes, and the b7 byte arithmetic, for every
    combination of logit_topk and logit_quant_bits."""
    x = _logits()
    fed = FedConfig(framework="kd", logit_topk=topk, logit_quant_bits=bits)
    ref_fed = RefFedConfig(framework="kd", logit_topk=topk,
                           logit_quant_bits=bits)
    want, want_wire = ref_kd.compress_for_wire(x, ref_fed)
    with ops.policy_scope("torch"):
        got, wire = kd.compress_for_wire(torch.tensor(x), fed)
    assert wire == want_wire
    assert kd.logit_wire_bytes(x.shape, fed) == \
        ref_kd.logit_wire_bytes(x.shape, ref_fed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aggregate_knowledge_matches_reference():
    xs = [_logits(s) for s in (1, 2, 3)]
    ts = [torch.tensor(x) for x in xs]
    for w, frac in (([1.0, 2.0, 3.0], 0.0), ([0.0, 0.0, 0.0], 0.0),
                    (None, 0.25)):
        np.testing.assert_allclose(
            kd.aggregate_knowledge(ts, w, frac).numpy(),
            np.asarray(ref_kd.aggregate_knowledge(xs, w, frac)),
            atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("C", [9, 77])
def test_compression_helpers_match_reference(C):
    """int4 packing (odd and even widths), softened labels and their
    inverse, and the public-set alignment, against the reference."""
    rng = np.random.default_rng(C)
    q = rng.integers(-7, 8, (5, C)).astype(np.int8)
    packed = compression.pack_int4(torch.tensor(q))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(ref_compression.pack_int4(q)))
    np.testing.assert_array_equal(
        compression.unpack_int4(packed, C).numpy(), q)
    x = _logits(C)[:, :C]
    soft, wire = compression.soften(torch.tensor(x), 2.0)
    ref_soft, ref_wire = ref_compression.soften(x, 2.0)
    assert wire == ref_wire
    np.testing.assert_allclose(soft.float().numpy(),
                               np.asarray(ref_soft, np.float32), atol=1e-3)
    np.testing.assert_allclose(
        compression.soft_to_logits(soft, 2.0).numpy(),
        np.asarray(ref_compression.soft_to_logits(ref_soft, 2.0)),
        atol=1e-5, rtol=1e-5)
    _, pub, _, _ = _data()
    hists = [rng.dirichlet(np.ones(77)) for _ in range(3)]
    got = kd.align_public_dataset(pub, hists, 40, seed=C)
    want = ref_kd.align_public_dataset(pub, hists, 40, seed=C)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("ties", [False, True])
def test_topk_twin_matches_pallas_on_wide_rows(ties):
    """The top-k twin against the reference's Pallas kernel (interpret
    mode) on rows longer than the CUDA kernel's warp path (C 5003 > 2048,
    where it selects by radix), k 64: +0.0 and -0.0 entries, which the
    kernel's "first index of the row maximum" takes as equal (so the lower
    index wins, as in the twin's stable sort; ``lax.top_k``, the
    reference's oracle, orders -0.0 below +0.0, so the row of zeros is held
    to the kernel alone), and with ``ties`` integer values, so the 64th
    pick ties with later entries and the lower indices must win.  q and
    idx bit for bit; the Pallas kernel's scale within rtol 1e-6 (XLA turns
    its ``absmax / qmax`` into a product, tests/test_torch_kernels.py)."""
    k, bits = 64, 8
    rng = np.random.default_rng(5003)
    x = (rng.standard_normal((4, 5003)) * 3.0).astype(np.float32)
    if ties:
        x = np.round(x).astype(np.float32)
    x[:, ::7] = 0.0
    x[:, 3::7] = -0.0
    x[3] = np.where(x[3] > 0, 0.0, x[3])      # the picks in a row of zeros
    if ties:
        ordered = -np.sort(-x, axis=1)
        assert (ordered[:, k - 1] == ordered[:, k]).all()
    got = ref.topk_quantize_rows_ref(torch.tensor(x), k, bits)
    pallas = jax_topk(jnp.asarray(x), k=k, bits=bits, br=2, interpret=True)
    oracle = jax_ref.topk_quantize_rows_ref(jnp.asarray(x[:3]), k, bits)
    for name, g, p, w in zip(("q", "idx", "scale"), got, pallas, oracle):
        np.testing.assert_array_equal(g.numpy()[:3], np.asarray(w),
                                      err_msg=name)
        if name == "scale":
            np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(p),
                                          err_msg=name)
    picks = got[1][3].numpy()                 # +0.0 and -0.0 by index
    assert (x[3, picks] == 0).all() and (np.diff(picks) > 0).all()
    assert np.signbit(x[3, picks]).any() and not np.signbit(x[3, picks]).all()


def test_run_holds_the_kernel_policy_for_kd_loss_and_topk(monkeypatch):
    """The run, not only Model.forward, owns the kernel policy: the KD loss
    (in kd_step) and the b3 top-k quantize (in KDProgram.upload) run
    outside the forward and must see ``kernel_policy`` too."""
    seen = {"kd_loss": set(), "topk_quantize": set()}
    for name in seen:
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            seen[_name].add(ops._ACTIVE)
            return _real(*args, **kwargs)
        monkeypatch.setattr(ops, name, spy)
    cfg, pub, clients, test = _data()
    run_federated(dataclasses.replace(cfg, kernel_policy="torch"),
                  FedConfig(**{**FED, "rounds": 1}, logit_topk=8,
                            logit_quant_bits=8),
                  pub, clients, test, batch_size=16, eval_batch=64,
                  device="cpu")
    assert seen == {"kd_loss": {"torch"}, "topk_quantize": {"torch"}}
