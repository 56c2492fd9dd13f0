"""The port's stacked-client backend (``FedConfig(backend="spmd")``)
against the port's sequential backend and the reference.

The host helpers of core/fed_spmd.py are held to the reference's array
for array; the client-axis twins of kernels/ref.py (rows 1ᶜ, 2ᶜ and 4ᶜ)
to the reference's ``jax.vmap`` of ``_fwd_call``, ``_dx_call`` and
``_panel_grad_call`` over the client axis in interpret mode (W shared)
within atol 1e-5 / rtol 1e-5 (fp32 sums over K 64 or M 37 in another
order); the stacked Adam step to the one-client step bit for bit.  End
to end at the verify-skill configuration (``gpt2_tiny``,
``paper_splits(scale=0.04, pad_len=24)``, 3 clients, 2 rounds, dropout
0, from the reference's weights bridged): each framework's ``spmd`` run
against the port's sequential run with the bar the reference holds its
own backends to (tests/test_backend_parity.py): ledger bytes and client
FLOPs exactly, per-round loss and accuracy within 1e-3, and the final
LoRA within atol 5e-5 / rtol 5e-4; FedLLM also against one reference
``spmd`` run.  Split's ``spmd`` run is the sequential run's split steps
on the same batches, so it is bit for bit.  The port's two backends draw
the same dropout masks, so at dropout 0.1 they agree within the same
fp32 bar.
"""
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
from repro.core import fed_spmd as ref_spmd  # noqa: E402
from repro.core.rounds import run_federated as ref_run  # noqa: E402
from repro.data.population import ClientPopulation  # noqa: E402
from repro.kernels.lora_matmul import (_dx_call, _fwd_call,  # noqa: E402
                                       _panel_grad_call)
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import (FaultConfig, FedConfig,  # noqa: E402
                                      PrivacyConfig)
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import \
    recurrentgemma_2b  # noqa: E402
from repro_torch.configs.rwkv6_1_6b import rwkv6_1_6b  # noqa: E402
from repro_torch.core import fed_spmd  # noqa: E402
from repro_torch.core.fedavg import make_fns, to_device  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.kernels import lora_matmul as lm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

SEED = 0
FRAMEWORKS = ("fedllm", "kd", "split")
FED = dict(rounds=2, lora_rank=4, lora_dropout=0.0, split_layer=2,
           kd_epochs=1, seed=SEED)
TWIN_TOL = dict(atol=1e-5, rtol=1e-5)
LORA_TOL = dict(atol=5e-5, rtol=5e-4)


def _lora_close(got, want):
    for x, y in zip(tree_lib.leaves(got), tree_lib.leaves(want)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **LORA_TOL)


def _tiny_data():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.04)
    return cfg, pub, partition.iid_partition(train, 3), test


@pytest.fixture(scope="module")
def bridged():
    """The reference's gpt2_tiny weights and initial LoRA (wq/wk/wv, rank
    4), as numpy trees."""
    params = jax.tree.map(np.asarray,
                          ref_build(ref_tiny()).init(jax.random.PRNGKey(SEED)))
    lt = jax.tree.map(np.asarray, ref_lora.init_lora(
        jax.random.PRNGKey(SEED + 1), params, ("wq", "wk", "wv"), 4, 32.0))
    return params, lt


@pytest.fixture(scope="module")
def runs(bridged):
    """The port's sequential and spmd runs of each framework from the
    bridged weights (KD draws its own LoRA trees from ``fed.seed``), and
    the reference's spmd FedLLM run."""
    params, lt = bridged
    cfg, pub, clients, test = _tiny_data()
    out = {}
    for fw in FRAMEWORKS:
        for backend in ("sequential", "spmd"):
            out[fw, backend] = run_federated(
                cfg, FedConfig(framework=fw, backend=backend, **FED), pub,
                clients, test, batch_size=16, eval_batch=64, device="cpu",
                base=bridge.params_from_reference(params, "cpu"),
                lora=None if fw == "kd" else
                bridge.lora_from_reference(lt, "cpu"))
    out["reference"] = ref_run(
        ref_tiny(), RefFedConfig(framework="fedllm", backend="spmd", **FED),
        pub, ClientPopulation.from_clients_data(clients), test,
        batch_size=16, eval_batch=64)
    return out


# --------------------------------------------------------------------------- #
# Host helpers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("ragged", [False, True])
def test_stack_client_batches_matches_reference(ragged):
    """The same padding of short clients with their last batch, the same
    ``valid`` mask and the same token counts, array for array."""
    _, _, clients, _ = _tiny_data()
    if ragged:
        clients = [{k: v[:16 + 16 * ci] for k, v in c.items()}
                   for ci, c in enumerate(clients)]
    seeds = [997, 998]
    got, valid, n_tok = fed_spmd.stack_client_batches(clients, 16, seeds)
    want, ref_valid, ref_tok = ref_spmd.stack_client_batches(clients, 16,
                                                             seeds)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(valid, ref_valid)
    assert n_tok == ref_tok
    assert valid.all() != ragged


def test_stack_client_batches_refuses_a_client_without_a_batch():
    _, _, clients, _ = _tiny_data()
    short = [clients[0], {k: v[:10] for k, v in clients[1].items()}]
    with pytest.raises(ValueError, match="at least one full batch"):
        ref_spmd.stack_client_batches(short, 16, [0])
    with pytest.raises(ValueError, match="at least one full batch"):
        fed_spmd.stack_client_batches(short, 16, [0])


@pytest.mark.parametrize("ranks,clients", [
    ((4, 4, 4), None), ((2, 4, 2, 4, 4), None), ((8, 2, 2, 8), [3, 1, 0]),
    ((1,), None)])
def test_rank_buckets_and_segments_match_reference(ranks, clients):
    assert fed_spmd.rank_buckets(ranks, clients) == \
        ref_spmd.rank_buckets(ranks, clients)
    assert fed_spmd.rank_segments(ranks, clients) == \
        ref_spmd.rank_segments(ranks, clients)


def test_stack_and_unstack_trees_round_trip():
    """Per-client trees (an Adam state: tensors and an int step count)
    stack on a leading axis and come back unchanged."""
    gen = torch.Generator().manual_seed(0)
    states = [{"m": {"a": torch.randn((3, 2), generator=gen)},
               "v": {"a": torch.rand((3, 2), generator=gen)}, "step": s}
              for s in (4, 0, 7)]
    stacked = fed_spmd.stack_trees(states)
    assert stacked["m"]["a"].shape == (3, 3, 2)
    assert stacked["step"].tolist() == [4, 0, 7]
    for got, want in zip(fed_spmd.unstack_tree(stacked), states):
        assert got["step"] == want["step"] and isinstance(got["step"], int)
        assert torch.equal(got["m"]["a"], want["m"]["a"])
        assert torch.equal(got["v"]["a"], want["v"]["a"])
    broadcast = fed_spmd.stack_for_clients(states[0], 2)
    assert broadcast["step"].tolist() == [4, 4]
    assert torch.equal(broadcast["m"]["a"][1], states[0]["m"]["a"])


# --------------------------------------------------------------------------- #
# The client-axis twins (rows 1ᶜ, 2ᶜ, 4ᶜ) against the reference's vmap
# --------------------------------------------------------------------------- #
C, M_C, K, N, R = 3, 37, 64, 48, 4


def _client_inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((C, M_C, K)).astype(np.float32)
    g = rng.standard_normal((C, M_C, N)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    a = (rng.standard_normal((C, K, R)) * K ** -0.5).astype(np.float32)
    b = (rng.standard_normal((C, R, N)) * N ** -0.5).astype(np.float32)
    panel = (rng.standard_normal((C, M_C, R)) * M_C ** -0.5).astype(
        np.float32)
    return x, g, w, a, b, panel


def test_lora_fwd_clients_matches_vmapped_pallas_fwd_call():
    """Row 1ᶜ: ``jax.vmap`` of ``_fwd_call`` with W shared (in_axes
    (0, None, 0, 0)) in interpret mode."""
    x, _, w, a, b, _ = _client_inputs()
    y, xa = jax.vmap(lambda xc, ac, bc: _fwd_call(
        xc, jnp.asarray(w), ac, bc, M_C, 32, 16, True))(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    got_y, got_xa = ref.lora_fwd_clients(*map(torch.tensor, (x, w, a, b)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), **TWIN_TOL)
    np.testing.assert_allclose(got_xa.numpy(), np.asarray(xa), **TWIN_TOL)


def test_lora_dx_clients_matches_vmapped_pallas_dx_call():
    """Row 2ᶜ: ``jax.vmap`` of ``_dx_call`` with W shared."""
    _, g, w, a, b, _ = _client_inputs()
    dx, gb = jax.vmap(lambda gc, ac, bc: _dx_call(
        gc, jnp.asarray(w), ac, bc, M_C, 32, 16, True, jnp.float32))(
        jnp.asarray(g), jnp.asarray(a), jnp.asarray(b))
    got_dx, got_gb = ref.lora_dx_clients(*map(torch.tensor, (g, w, a, b)))
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(dx), **TWIN_TOL)
    np.testing.assert_allclose(got_gb.numpy(), np.asarray(gb), **TWIN_TOL)


@pytest.mark.parametrize("transpose_out", [False, True])
def test_panel_grad_clients_matches_vmapped_pallas_panel_grad_call(
        transpose_out):
    """Row 4ᶜ: ``jax.vmap`` of ``_panel_grad_call`` over the clients (dA
    = x_cᵀ·gb_c; dB = (g_cᵀ·xa_c)ᵀ transposed)."""
    x, _, _, _, _, panel = _client_inputs()
    want = np.asarray(jax.vmap(lambda lc, pc: _panel_grad_call(
        lc, pc, M_C, 32, True, jnp.float32))(jnp.asarray(x),
                                            jnp.asarray(panel)))
    got = ref.panel_grad_clients(torch.tensor(x), torch.tensor(panel),
                                 transpose_out)
    assert got.shape == ((C, R, K) if transpose_out else (C, K, R))
    np.testing.assert_allclose(
        got.numpy(), want.transpose(0, 2, 1) if transpose_out else want,
        **TWIN_TOL)


def test_lora_matmul_with_stacked_factors_is_each_clients_product():
    """ops.lora_matmul with a (C, K, r) and b (C, r, N): client c's rows of
    x (C·B, S, K) against its own factors, and its backward gives each
    client's dA and dB (the per-client products' gradients)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((C * 2, 5, K), generator=gen, requires_grad=True)
    w = torch.randn((K, N), generator=gen) * K ** -0.5
    a = (torch.randn((C, K, R), generator=gen) * 0.1).requires_grad_(True)
    b = (torch.randn((C, R, N), generator=gen) * 0.1).requires_grad_(True)
    y = ops.lora_matmul(x, w, a, b)
    assert y.shape == (C * 2, 5, N)
    probe = torch.randn(y.shape, generator=gen)
    gx, ga, gb = torch.autograd.grad((y * probe).sum(), (x, a, b))
    for c in range(C):
        xc = x[2 * c:2 * c + 2].detach().requires_grad_(True)
        ac, bc = (t[c].detach().requires_grad_(True) for t in (a, b))
        yc = ops.lora_matmul(xc, w, ac, bc)
        torch.testing.assert_close(y[2 * c:2 * c + 2], yc)
        want = torch.autograd.grad((yc * probe[2 * c:2 * c + 2]).sum(),
                                   (xc, ac, bc))
        torch.testing.assert_close(gx[2 * c:2 * c + 2], want[0])
        torch.testing.assert_close(ga[c], want[1])
        torch.testing.assert_close(gb[c], want[2])


def test_lora_matmul_with_stacked_factors_refusals():
    """A leading axis that is no multiple of the clients, a bound base
    weight that requires a gradient, CPU tensors under the ``cuda``
    policy and the client-axis kernels given CPU tensors all raise."""
    x = torch.ones((4, 3, K))
    w, a, b = torch.ones((K, N)), torch.ones((C, K, R)), torch.ones((C, R, N))
    with pytest.raises(ValueError, match="multiple of 3"):
        ops.lora_matmul(x, w, a, b)
    with pytest.raises(ValueError, match="base weight"):
        ops.lora_matmul(torch.ones((3, 3, K)), w.requires_grad_(True), a, b)
    with ops.policy_scope("cuda"), pytest.raises(ValueError, match="CUDA"):
        ops.lora_matmul(torch.ones((3, 3, K)), torch.ones((K, N)), a, b)
    xs = torch.ones((C, 3, K))
    with pytest.raises(ValueError, match="CUDA"):
        lm.lora_fwd_clients(xs, torch.ones((K, N)), a, b)
    with pytest.raises(ValueError, match="CUDA"):
        lm.lora_dx_clients(torch.ones((C, 3, N)), torch.ones((K, N)), a, b)
    with pytest.raises(ValueError, match="CUDA"):
        lm.lora_panel_clients(xs, torch.ones((C, 3, R)))


def test_adam_update_clients_is_each_clients_update():
    """The stacked Adam step gives each stepping client the bits of the
    one-client step at its own count; a padded client keeps its
    parameters, moments and count."""
    gen = torch.Generator().manual_seed(5)
    p = [torch.randn((C, 6, 2), generator=gen)]
    g = [torch.randn((C, 6, 2), generator=gen)]
    states = [adam.init([p[0][c]]) for c in range(C)]
    for c, steps in enumerate((1, 0, 3)):      # differing counts
        for _ in range(steps):
            _, states[c] = adam.update([g[0][c] * 0.5], states[c],
                                       [p[0][c]], 1e-3)
    stacked = fed_spmd.stack_trees(states)
    valid = [True, True, False]
    new_p, new_s = adam.update_clients(g, stacked, p, 1e-3, valid)
    assert new_s["step"].tolist() == [2, 1, 3]
    for c in range(C):
        if valid[c]:
            want_p, want_s = adam.update([g[0][c]], states[c], [p[0][c]],
                                         1e-3)
        else:
            want_p, want_s = [p[0][c]], states[c]
        assert torch.equal(new_p[0][c], want_p[0])
        assert torch.equal(new_s["m"][0][c], want_s["m"][0])
        assert torch.equal(new_s["v"][0][c], want_s["v"][0])


class _AuxGrad:
    """A model whose aux term depends on the batch through the LoRA
    leaves: it mixes the clients' examples."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def forward(self, params, batch):
        logits, aux = self.model.forward(params, batch)
        return logits, aux + 1e-3 * logits.float().pow(2).mean()


def test_stacked_step_keeps_padded_clients_and_refuses_mixing_aux(bridged):
    """A client whose step is padding keeps its LoRA and Adam state; a
    stepping client moves.  An aux term with a gradient is refused."""
    params, lt = bridged
    cfg, _, clients, _ = _tiny_data()
    model = build_model(cfg)
    fed = FedConfig(**FED)
    fns = make_fns(model, fed)
    base = bridge.params_from_reference(params, "cpu")
    lora = bridge.lora_from_reference(lt, "cpu")
    slt = fed_spmd.stack_for_clients(lora, 2)
    sopt = fed_spmd.stack_for_clients(fns["opt_init"](lora), 2)
    batches, _, _ = fed_spmd.stack_client_batches(clients[:2], 16, [997])
    batch = fed_spmd.step_batch(to_device(batches, "cpu"), 0)
    new, opt, loss = fns["train_step_clients"](base, slt, sopt, batch,
                                               None, [True, False])
    assert loss.shape == (2,) and opt["step"].tolist() == [1, 0]
    moved = [not torch.equal(x[0], y[0]) for x, y in zip(
        tree_lib.leaves(new), tree_lib.leaves(slt))]
    kept = [torch.equal(x[1], y[1]) for x, y in zip(
        tree_lib.leaves(new), tree_lib.leaves(slt))]
    assert any(moved) and all(kept)
    # the stepping client's step is the sequential train step on its batch
    seq_lt, _, seq_loss = fns["train_step"](
        base, lora, fns["opt_init"](lora),
        to_device({k: v[0, 0] for k, v in batches.items()}, "cpu"))
    np.testing.assert_allclose(float(loss[0]), float(seq_loss), atol=1e-6)
    for x, y in zip(tree_lib.leaves(new), tree_lib.leaves(seq_lt)):
        torch.testing.assert_close(x[0], y, **LORA_TOL)
    aux_fns = make_fns(_AuxGrad(model), fed)
    with pytest.raises(ValueError, match="aux"):
        aux_fns["train_step_clients"](base, slt, sopt, batch, None,
                                      [True, True])


FAMILIES = {
    "gpt2": lambda: gpt2_tiny(),
    "recurrentgemma": lambda: recurrentgemma_2b().reduced(n_layers=5,
                                                         d_model=128),
    "rwkv6": lambda: rwkv6_1_6b().reduced(n_layers=2, d_model=128),
}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stacked_local_update_is_each_clients_steps_on_every_family(
        family, dropout):
    """On each ported family (the tiny configs of
    tests/test_torch_per_example.py), the stacked local update of 3
    clients, each from its own LoRA and on its own batches, the last
    client's second step padding, against each client's sequential train
    steps with its own dropout generator: the LoRA within atol 5e-5 /
    rtol 5e-4, the step counts exactly.  Every client's LoRA differs, so
    a projection whose rows were grouped into the wrong clients shows."""
    cfg = dataclasses.replace(FAMILIES[family](), kernel_policy="torch")
    model = build_model(cfg)
    fed = FedConfig(framework="fedllm", rounds=1, lora_rank=R,
                    lora_dropout=dropout, seed=SEED)
    fns = make_fns(model, fed)
    base = model.init(torch.Generator().manual_seed(0), "cpu")
    lt0 = lora_lib.init_lora(torch.Generator().manual_seed(1), base,
                             lora_lib.default_targets(cfg), R,
                             fed.lora_alpha)
    gen = torch.Generator().manual_seed(2)
    lts = [tree_lib.map_(lambda t: t + 0.05 * torch.randn(
        t.shape, generator=gen), lt0) for _ in range(C)]
    _, train, _ = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                         scale=0.04)
    clients = [{k: v[4 * c:4 * c + (2 if c == C - 1 else 4)]
                for k, v in train.items()} for c in range(C)]
    batches, valid, _ = fed_spmd.stack_client_batches(clients, 2, [0])
    assert valid.tolist() == [[True, True], [True, True], [True, False]]
    slt, sopt, losses = fed_spmd.make_local_update(model, fed, fns=fns)(
        base, fed_spmd.stack_trees(lts),
        fed_spmd.stack_trees([fns["opt_init"](lt) for lt in lts]), batches,
        valid, [torch.Generator().manual_seed(10 + c) for c in range(C)],
        "cpu")
    assert sopt["step"].tolist() == [2, 2, 1]
    for c, got in enumerate(fed_spmd.unstack_tree(slt)):
        lt, opt = lts[c], fns["opt_init"](lts[c])
        cgen, closs = torch.Generator().manual_seed(10 + c), []
        for s in np.flatnonzero(valid[c]):
            lt, opt, loss = fns["train_step"](
                base, lt, opt, to_device({k: v[c, s] for k, v in
                                          batches.items()}, "cpu"), cgen)
            closs.append(float(loss))
        np.testing.assert_allclose(float(losses[c]), np.mean(closs),
                                   atol=1e-5, rtol=0)
        _lora_close(got, lt)


# --------------------------------------------------------------------------- #
# End to end
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fw", FRAMEWORKS)
def test_spmd_ledger_and_flops_equal_sequential(runs, fw):
    seq, spmd = runs[fw, "sequential"], runs[fw, "spmd"]
    assert spmd.ledger.by_name() == seq.ledger.by_name()
    assert spmd.ledger.per_round() == seq.ledger.per_round()
    assert spmd.ledger.per_client_round() == seq.ledger.per_client_round()
    assert spmd.client_flops == seq.client_flops


@pytest.mark.parametrize("fw", FRAMEWORKS)
def test_spmd_metrics_and_final_lora_close_to_sequential(runs, fw):
    seq, spmd = runs[fw, "sequential"], runs[fw, "spmd"]
    assert len(spmd.history) == len(seq.history) == 2
    for hs, hp in zip(seq.history, spmd.history):
        assert abs(hs.loss - hp.loss) <= 1e-3
        assert abs(hs.accuracy - hp.accuracy) <= 1e-3
    _lora_close(spmd.final_lora, seq.final_lora)


def test_split_spmd_is_the_sequential_run_bit_for_bit(runs):
    """Split's server half threads client after client through the same
    split steps on the same batches."""
    seq, spmd = runs["split", "sequential"], runs["split", "spmd"]
    assert [h.loss for h in spmd.history] == [h.loss for h in seq.history]
    for x, y in zip(tree_lib.leaves(spmd.final_lora),
                    tree_lib.leaves(seq.final_lora)):
        assert torch.equal(x, y)


def test_fedllm_spmd_matches_reference_spmd(runs):
    port, want = runs["fedllm", "spmd"], runs["reference"]
    assert port.ledger.by_name() == want.ledger.by_name()
    assert port.ledger.per_client_round() == want.ledger.per_client_round()
    assert port.client_flops == [float(f) for f in want.client_flops]
    for hp, hr in zip(port.history, want.history):
        assert abs(hp.loss - hr.loss) <= 1e-3
        assert abs(hp.accuracy - hr.accuracy) <= 1e-3
    got = bridge.lora_to_reference(port.final_lora)
    ref_tree = jax.tree.map(np.asarray, want.final_lora)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(ref_tree)):
        np.testing.assert_allclose(x, y, **LORA_TOL)


@pytest.mark.parametrize("fw", ["fedllm", "split"])
def test_spmd_handles_ragged_client_data(bridged, fw):
    """Clients with unequal batch counts run through the padded, masked
    stacked steps and give the sequential run's ledger and FLOPs exactly
    (tests/test_backend_parity.py's case)."""
    params, lt = bridged
    cfg, pub, clients, test = _tiny_data()
    ragged = [{k: v[:16 + 16 * ci] for k, v in c.items()}
              for ci, c in enumerate(clients)]
    out = {}
    for backend in ("sequential", "spmd"):
        out[backend] = run_federated(
            cfg, FedConfig(framework=fw, backend=backend,
                           **dict(FED, rounds=1)),
            pub, ragged, test, batch_size=16, eval_batch=64, device="cpu",
            base=bridge.params_from_reference(params, "cpu"),
            lora=bridge.lora_from_reference(lt, "cpu"))
    seq, spmd = out["sequential"], out["spmd"]
    assert seq.ledger.per_client_round() == spmd.ledger.per_client_round()
    assert seq.client_flops == spmd.client_flops
    assert abs(seq.final_accuracy - spmd.final_accuracy) <= 1e-3
    _lora_close(spmd.final_lora, seq.final_lora)


def test_spmd_refuses_a_client_without_a_full_batch(bridged):
    cfg, pub, clients, test = _tiny_data()
    short = [clients[0], {k: v[:10] for k, v in clients[1].items()}]
    with pytest.raises(ValueError, match="at least one full batch"):
        run_federated(cfg, FedConfig(backend="spmd", **dict(FED, rounds=1)),
                      pub, short, test, batch_size=16, eval_batch=64,
                      device="cpu")


def test_split_spmd_refuses_a_client_without_a_full_batch():
    """Split's stacked program is the sequential loop, and it refuses a
    client with no full batch as the other stacked programs do."""
    cfg, pub, clients, test = _tiny_data()
    short = [clients[0], {k: v[:10] for k, v in clients[1].items()}]
    with pytest.raises(ValueError, match="at least one full batch"):
        run_federated(cfg, FedConfig(framework="split", backend="spmd",
                                     **dict(FED, rounds=1)),
                      pub, short, test, batch_size=16, eval_batch=64,
                      device="cpu")


def test_spmd_and_sequential_draw_the_same_dropout_masks(bridged):
    """At dropout 0.1 each client draws its masks from the generator the
    sequential backend gives it, in the same order: the runs agree within
    the fp32 bar."""
    params, lt = bridged
    cfg, pub, clients, test = _tiny_data()
    out = {}
    for backend in ("sequential", "spmd"):
        out[backend] = run_federated(
            cfg, FedConfig(backend=backend,
                           **dict(FED, rounds=1, lora_dropout=0.1)),
            pub, clients, test, batch_size=16, eval_batch=64, device="cpu",
            base=bridge.params_from_reference(params, "cpu"),
            lora=bridge.lora_from_reference(lt, "cpu"))
    assert abs(out["spmd"].history[0].loss
               - out["sequential"].history[0].loss) <= 1e-4
    _lora_close(out["spmd"].final_lora, out["sequential"].final_lora)
    nodrop = run_federated(
        cfg, FedConfig(backend="spmd", **dict(FED, rounds=1)), pub, clients,
        test, batch_size=16, eval_batch=64, device="cpu",
        base=bridge.params_from_reference(params, "cpu"),
        lora=bridge.lora_from_reference(lt, "cpu"))
    assert any(not torch.equal(x, y) for x, y in zip(
        tree_lib.leaves(nodrop.final_lora),
        tree_lib.leaves(out["spmd"].final_lora)))


def test_spmd_refuses_what_it_does_not_port(bridged):
    """DP-SGD over the client axis runs: at clip 0.5 the sequential
    run's ledger exactly and its final LoRA within the fp32 bar (against
    the reference's spmd DP runs: tests/test_torch_spmd_dp.py); fault
    injection runs under ``spmd`` too, dropping and quarantining the
    uploads the sequential run does (the same ledger events, its final
    LoRA within the fp32 bar); ``mesh`` is no keyword of the port's entry
    point."""
    params, lt = bridged
    cfg, pub, clients, test = _tiny_data()
    out = {}
    for backend in ("sequential", "spmd"):
        out[backend] = run_federated(
            cfg, FedConfig(backend=backend, privacy=PrivacyConfig(
                dp_clip=0.5), **dict(FED, rounds=1)), pub, clients, test,
            batch_size=16, eval_batch=64, device="cpu",
            base=bridge.params_from_reference(params, "cpu"),
            lora=bridge.lora_from_reference(lt, "cpu"))
    assert out["spmd"].ledger.by_name() == out["sequential"].ledger.by_name()
    assert out["spmd"].client_flops == out["sequential"].client_flops
    _lora_close(out["spmd"].final_lora, out["sequential"].final_lora)
    for backend in ("sequential", "spmd"):
        out[backend] = run_federated(
            cfg, FedConfig(backend=backend, faults=FaultConfig(
                dropout_rate=0.4, byzantine=1, byzantine_mode="nan"),
                **dict(FED, rounds=2)), pub, clients, test, batch_size=16,
            eval_batch=64, device="cpu",
            base=bridge.params_from_reference(params, "cpu"),
            lora=bridge.lora_from_reference(lt, "cpu"))
    assert out["spmd"].ledger.events == out["sequential"].ledger.events
    assert {"quarantine", "retransmit"} <= set(out["spmd"].ledger.by_name())
    _lora_close(out["spmd"].final_lora, out["sequential"].final_lora)
    with pytest.raises(TypeError):
        run_federated(cfg, FedConfig(backend="spmd"), pub, clients, test,
                      device="cpu", mesh=None)
