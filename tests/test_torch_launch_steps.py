"""The launch layer's step builders in the port against the reference's,
on the CPU: Qwen3-1.7B at ``reduced()`` (2 layers, d 256, qk-norm), the
reference's weights bridged, fp32 arrays fed to both, dropout 0, 2
clients of 2 local steps (client 1's second step padding), S 16.

One module fixture runs the pairs, the reference's programs jitted on a
(1, 1) mesh: the train step under every ``remat`` (the port's three
runs within 1e-6 of each other), prefill, three decode steps, and the
fed_round programs (FedLLM at ``n_edges`` 1 and 2, under DP at noise 0
and under ``robust_agg="trimmed_mean"``; KD at classification; Split).
Beside them: ``aggregate_knowledge_batched`` (with all-zero weights),
``hierarchical_client_mean`` at 1, 2, 4 and a non-tiling 3 edges,
``run_spmd`` against ``run_federated(backend="spmd")``, every builder's
specs against the reference's ``in_shardings`` on both production
meshes at full size, and the builders' sourcing of the round programs.

Tolerances: LoRA, Adam state and gradients atol 5e-5 / rtol 5e-4 (the
port's bar for fp32 sums in another order; the KD server's LoRA after
its one Adam step is held there except on the entries whose gradient is
within a few hundred Adam eps of zero, which the Adam state holds);
losses and logits atol 1e-5; specs and shapes exactly."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs.base import PrivacyConfig as RefPrivacy  # noqa: E402
from repro.core import fed_spmd as ref_fed_spmd  # noqa: E402
from repro.core import kd as ref_kd  # noqa: E402
from repro.core import split as ref_split  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.factory import build_model as ref_build  # noqa: E402
from repro.optim import adam as ref_adam  # noqa: E402
from repro.peft import lora as ref_lora  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import FedConfig, PrivacyConfig  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import fed_spmd, kd, rounds_spmd  # noqa: E402
from repro_torch.core import split as split_mod  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

ARCH = "qwen3-1.7b"
C, S, B, L = 2, 2, 2, 16
SHAPE = ShapeConfig("train_4k", L, C * B, "train")
RANK = 8
CLIP = 0.05
STATE = dict(atol=5e-5, rtol=5e-4)
LOGITS = dict(atol=1e-5, rtol=0.0)


def _close(got, want, **tol):
    """Two trees (port tensors / reference arrays, ints) leaf by leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], **tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, **tol)
    elif want is None:
        assert got is None
    else:
        g = got.detach().cpu().numpy() if torch.is_tensor(got) else got
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(want, np.float64), **tol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _client(tree, c):
    return jax.tree.map(lambda x: np.asarray(x)[c], tree)


def _lora(tree, cfg):
    return bridge.lora_from_reference(tree, "cpu", cfg)


def _opt(tree, cfg):
    return bridge.opt_state_from_reference(tree, "cpu", cfg)


def _stacked(trees, conv, cfg):
    """A client-stacked reference tree in the port's stacked form."""
    return fed_spmd.stack_trees([conv(_client(trees, c), cfg)
                                 for c in range(C)])


def _per_client(stacked, ref_stacked, conv, cfg, **tol):
    for c, got in enumerate(fed_spmd.unstack_tree(stacked, C)):
        _close(got, conv(_client(ref_stacked, c), cfg), **tol)


@pytest.fixture(scope="module")
def runs():
    """{case: (port outputs, reference outputs, cfg)}."""
    ref_cfg = dataclasses.replace(ref_registry.get_config(ARCH).reduced(),
                                  kernel_policy="xla")
    cfg = registry.get_config(ARCH).reduced()
    rng = np.random.default_rng(0)
    mesh1 = jax.make_mesh((1, 1), ("data", "model"))
    ref_params = ref_build(ref_cfg).init(jax.random.PRNGKey(0))
    params = bridge.params_from_reference(ref_params, "cpu")

    def noisy(tree):
        return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
            0.0, 0.02, x.shape)).astype(np.float32), tree)

    targets = ref_lora.default_targets(ref_cfg)
    ref_lts = [noisy(ref_lora.init_lora(jax.random.PRNGKey(i), ref_params,
                                        targets, RANK)) for i in (1, 2, 3)]
    ref_opt = ref_adam.init(ref_lts[0])
    out = {}
    tokens = rng.integers(0, cfg.vocab_size, (C, S, B, L)).astype(np.int32)
    valid = np.array([[True, True], [True, False]])
    weights = np.array([3.0, 1.0], np.float32)
    gens = [torch.Generator().manual_seed(c) for c in range(C)]

    # -- train, prefill, decode ------------------------------------------ #
    batch = {"tokens": tokens[0, 0]}
    fn, _, _ = ref_steps.build_train_step(ref_cfg, SHAPE, mesh1,
                                          remat="full", lora_rank=RANK)
    ref_out = jax.jit(fn)(ref_params, ref_lts[0], ref_opt, batch)
    port = {}
    for remat in ("none", "full", "selective"):
        fn, _, _ = steps.build_train_step(cfg, SHAPE, mesh_mod.MeshSpec(
            (1, 1), ("data", "model")), remat=remat, dtype=torch.float32)
        port[remat] = fn(params, _lora(ref_lts[0], cfg),
                         _opt(ref_opt, cfg), {"tokens": _t(tokens[0, 0])})
    out["train"] = (port, ref_out)

    pshape = ShapeConfig("prefill_32k", L, B, "prefill")
    fn, _, _ = ref_steps.build_prefill_step(ref_cfg, pshape, mesh1)
    ref_pre = jax.jit(fn)(ref_params, batch)
    fn, _, _ = steps.build_prefill_step(cfg, pshape, mesh_mod.MeshSpec(
        (1, 1), ("data", "model")), dtype=torch.float32)
    out["prefill"] = (fn(params, {"tokens": _t(tokens[0, 0])}), ref_pre)

    dshape = ShapeConfig("decode_32k", L, B, "decode")
    fn, _, _ = ref_steps.build_decode_step(ref_cfg, dshape, mesh1)
    ref_fn = jax.jit(fn)
    ref_cache = ref_build(ref_cfg).init_cache(ref_params, B, L,
                                              dtype=jnp.float32)
    pfn, _, _ = steps.build_decode_step(cfg, dshape, mesh_mod.MeshSpec(
        (1, 1), ("data", "model")), dtype=torch.float32)
    cache = build_model(cfg).init_cache(params, B, L, dtype=torch.float32)
    dec = []
    for pos in range(3):
        tok = tokens[0, 0, :, pos]
        ref_logits, ref_cache = ref_fn(ref_params, ref_cache, tok,
                                       jnp.int32(pos))
        logits, cache = pfn(params, cache, _t(tok), torch.tensor(pos))
        dec.append((logits, ref_logits))
    out["decode"] = dec

    # -- fed_round programs ------------------------------------------------ #
    slt_ref = jax.tree.map(lambda *x: np.stack(x), *ref_lts[:C])
    sopt_ref = jax.tree.map(lambda x: np.stack([np.asarray(x)] * C), ref_opt)
    keys = ref_fed_spmd.split_keys(jax.random.PRNGKey(0), C, S)
    slt, sopt = _stacked(slt_ref, _lora, cfg), \
        fed_spmd.stack_for_clients(_opt(ref_opt, cfg), C)
    fb_ref = {"tokens": tokens}
    # both FedLLM rounds take FedConfig's default dropout (0.1), whose
    # masks the two packages draw from different streams: run them at 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_steps, "FedConfig", functools.partial(
            ref_steps.FedConfig, lora_dropout=0.0))
        mp.setattr(steps, "FedConfig", functools.partial(
            FedConfig, lora_dropout=0.0))
        for case, kw in (("fedllm", {}), ("fedllm edges 2", {"n_edges": 2}),
                         ("fedllm dp", {"privacy": CLIP}),
                         ("fedllm trimmed", {"robust_agg": "trimmed_mean"})):
            pkw = dict(kw)
            if "privacy" in kw:
                kw = dict(kw, privacy=RefPrivacy(dp_clip=CLIP))
                pkw = dict(pkw, privacy=PrivacyConfig(dp_clip=CLIP))
            fn, _, _ = ref_steps.build_fed_round_step(
                ref_cfg, SHAPE, mesh1, n_clients=C, n_local_steps=S,
                lora_rank=RANK, **kw)
            ref_o = jax.jit(fn)(ref_params, slt_ref, sopt_ref, fb_ref, keys,
                                valid, weights)
            fn, _, _ = steps.build_fed_round_step(
                cfg, SHAPE, mesh_mod.MeshSpec((1, 1), ("data", "model")),
                n_clients=C, n_local_steps=S, lora_rank=RANK,
                dtype=torch.float32, **pkw)
            out[case] = (fn(params, slt, sopt, {"tokens": tokens}, gens,
                            valid, weights), ref_o)

        # KD at classification: labels, lengths and a public batch
        kb = {"tokens": tokens,
              "labels": rng.integers(0, 77, (C, S, B)).astype(np.int32),
              "lengths": rng.integers(L // 2, L + 1, (C, S, B))
              .astype(np.int32)}
        pub = {"tokens": rng.integers(0, cfg.vocab_size, (B, L))
               .astype(np.int32),
               "lengths": rng.integers(L // 2, L + 1, (B,)).astype(np.int32)}
        fn, _, _ = ref_steps.build_fed_round_step(
            ref_cfg, SHAPE, mesh1, n_clients=C, n_local_steps=S,
            lora_rank=RANK, framework="kd")
        ref_o = jax.jit(fn)(ref_params, slt_ref, sopt_ref, ref_lts[2],
                            ref_opt, kb, keys, valid, weights, pub,
                            jax.random.split(jax.random.PRNGKey(1), C),
                            jax.random.PRNGKey(2))
        fn, _, _ = steps.build_fed_round_step(
            cfg, SHAPE, mesh_mod.MeshSpec((1, 1), ("data", "model")),
            n_clients=C, n_local_steps=S, lora_rank=RANK, framework="kd",
            dtype=torch.float32)
        out["kd"] = (fn(params, slt, sopt, _lora(ref_lts[2], cfg),
                        _opt(ref_opt, cfg), kb, gens, valid, weights, pub,
                        gens, torch.Generator()), ref_o)

        # Split: the halves at the split point of make_split_fns
        fn, _, _ = ref_steps.build_fed_round_step(
            ref_cfg, SHAPE, mesh1, n_clients=C, n_local_steps=S,
            lora_rank=RANK, framework="split")
        groups = 1                                   # FedConfig.split_layer
        rbc, rbs = ref_split.split_base(ref_params, groups, False)
        rc, rs = ref_split.split_lora(ref_lts[0], groups)
        ref_o = jax.jit(fn)(rbc, rbs, rc, rs, ref_adam.init(rs), fb_ref,
                            keys, valid, weights)
        pfn, _, _ = steps.build_fed_round_step(
            cfg, SHAPE, mesh_mod.MeshSpec((1, 1), ("data", "model")),
            n_clients=C, n_local_steps=S, lora_rank=RANK,
            framework="split", dtype=torch.float32)
        bc, bs = split_mod.split_base(params, groups, False)
        c_lt, s_lt = split_mod.split_lora(_lora(ref_lts[0], cfg), groups)
        out["split"] = (pfn(bc, bs, c_lt, s_lt, adam.init(s_lt),
                            {"tokens": tokens}, gens, valid, weights), ref_o)
    out["cfg"] = cfg
    return out


# --------------------------------------------------------------------------- #
def test_train_step_every_remat(runs):
    port, (lt, opt, loss) = runs["train"]
    cfg = runs["cfg"]
    for remat, (p_lt, p_opt, p_loss) in port.items():
        _close(p_lt, _lora(lt, cfg), **STATE)
        _close(p_opt, _opt(opt, cfg), **STATE)
        _close(p_loss, loss, **LOGITS)
        for other in port.values():
            _close(p_opt["m"], other[1]["m"], atol=1e-6, rtol=0.0)
            _close(p_lt, other[0], atol=1e-6, rtol=0.0)


def test_prefill_step(runs):
    got, want = runs["prefill"]
    assert tuple(got.shape) == tuple(want.shape) == (B, 512)
    _close(got, want, **LOGITS)


def test_decode_steps(runs):
    for got, want in runs["decode"]:
        _close(got, want, **LOGITS)


@pytest.mark.parametrize("case", ["fedllm", "fedllm edges 2", "fedllm dp",
                                  "fedllm trimmed"])
def test_fedllm_round(runs, case):
    (redist, new_opt, losses, new_lt), ref = runs[case]
    cfg = runs["cfg"]
    _per_client(redist, ref[0], _lora, cfg, **STATE)
    _per_client(new_lt, ref[3], _lora, cfg, **STATE)
    _per_client(new_opt, ref[1], _opt, cfg, **STATE)
    _close(losses, ref[2], **LOGITS)
    agg = fed_spmd.unstack_tree(redist, C)
    _close(agg[0], agg[1], atol=0.0, rtol=0.0)


def test_fedllm_edges_agree(runs):
    """Two edges reassociate the flat FedAvg: within fp32 rounding."""
    one, two = runs["fedllm"][0][0], runs["fedllm edges 2"][0][0]
    _close(two, one, atol=1e-7, rtol=1e-6)


def test_kd_round(runs):
    (slt, sopt, server_lt, server_opt), ref = runs["kd"]
    cfg = runs["cfg"]
    _per_client(slt, ref[0], _lora, cfg, **STATE)
    _per_client(sopt, ref[1], _opt, cfg, **STATE)
    _close(server_opt, _opt(ref[3], cfg), **STATE)
    # the server's one Adam step moves each entry by lr·g/(|g| + eps):
    # where |g| is within a few hundred eps (1e-8) of zero, fp32 noise in
    # g moves the step itself (ROADMAP's caveat: Adam amplifies fp32
    # noise).  Those entries are held through the Adam state above; every
    # other entry at the bar, and they stay under 1 % of them.
    want_m = tree_lib.leaves(_lora(ref[3]["m"], cfg))
    n_eps = 0
    for got, want, m in zip(tree_lib.leaves(server_lt),
                            tree_lib.leaves(_lora(ref[2], cfg)), want_m):
        steady = m.abs() / 0.1 >= 1e-6
        n_eps += int((~steady).sum())
        _close(got[steady], want[steady], **STATE)
    assert n_eps <= 1e-2 * sum(m.numel() for m in want_m)


def test_split_round(runs):
    (c_glob, s_lt, s_opt, losses, stacked_c), ref = runs["split"]
    cfg = runs["cfg"]
    _close(c_glob, _lora(ref[0], cfg), **STATE)
    _close(s_lt, _lora(ref[1], cfg), **STATE)
    _close(s_opt, _opt(ref[2], cfg), **STATE)
    _close(losses, ref[3], **LOGITS)
    _per_client(stacked_c, ref[4], _lora, cfg, **STATE)


# --------------------------------------------------------------------------- #
def test_aggregate_knowledge_batched():
    rng = np.random.default_rng(3)
    stack = rng.normal(size=(3, 5, 7)).astype(np.float32)
    for w in ([1.0, 2.0, 5.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]):
        want = ref_kd.aggregate_knowledge_batched(stack, np.asarray(w))
        got = kd.aggregate_knowledge_batched(_t(stack), torch.tensor(w))
        _close(got, want, atol=1e-6, rtol=1e-6)
    got = kd.aggregate_knowledge_batched(_t(stack), [0.0, 0.0, 0.0])
    _close(got, stack.mean(0), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_edges", [1, 2, 3, 4])
def test_hierarchical_client_mean(n_edges):
    rng = np.random.default_rng(n_edges)
    tree = {"a": rng.normal(size=(4, 6, 3)).astype(np.float32),
            "b": [rng.normal(size=(4, 5)).astype(np.float32)]}
    w = np.array([1.0, 3.0, 0.5, 2.0], np.float32)
    want = ref_fed_spmd.hierarchical_client_mean(tree, jnp.asarray(w),
                                                 n_edges)
    got = fed_spmd.hierarchical_client_mean(
        {"a": _t(tree["a"]), "b": [_t(tree["b"][0])]}, torch.tensor(w),
        n_edges)
    _close(got, want, atol=1e-7, rtol=1e-6)
    flat = fed_spmd.weighted_client_mean(
        {"a": _t(tree["a"]), "b": [_t(tree["b"][0])]}, torch.tensor(w))
    _close(got, flat, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("robust_agg", ["mean", "median"])
def test_client_combine(robust_agg):
    x = np.random.default_rng(5).normal(size=(4, 6, 3)).astype(np.float32)
    w = np.array([1.0, 3.0, 0.5, 2.0], np.float32)
    _close(fed_spmd.client_combine({"a": _t(x)}, torch.tensor(w),
                                   FedConfig(robust_agg=robust_agg)),
           ref_fed_spmd.client_combine({"a": x}, jnp.asarray(w),
                                       ref_fed_spmd.FedConfig(
                                           robust_agg=robust_agg)),
           atol=1e-7, rtol=1e-6)


def test_run_spmd_is_run_federated_spmd():
    from repro_torch.configs.gpt2_small import gpt2_tiny
    from repro_torch.core.round_program import run_program  # noqa: F401
    from repro_torch.data import banking77, partition
    from repro_torch.peft import lora as lora_lib

    cfg = gpt2_tiny()
    pub, tr, te = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                         scale=0.03)
    clients = partition.iid_partition(tr, 2)
    fed = FedConfig(rounds=1, lora_rank=4, lora_dropout=0.0, backend="spmd")
    model = build_model(cfg)
    base = model.init(torch.Generator().manual_seed(0), device="cpu")
    got = rounds_spmd.run_spmd(model, base, cfg,
                               dataclasses.replace(fed, backend="sequential"),
                               lora_lib.default_targets(cfg), pub, clients,
                               te, "classification", 16, 64, False)
    want = run_federated(cfg, fed, pub, clients, te, batch_size=16,
                         eval_batch=64, device="cpu", base=base)
    assert [h.loss for h in got.history] == [h.loss for h in want.history]
    assert got.ledger.by_name() == want.ledger.by_name()
    _close(got.final_lora, want.final_lora, atol=0.0, rtol=0.0)
    with pytest.raises(NotImplementedError):
        rounds_spmd.run_spmd(model, base, cfg, fed, (), pub, clients, te,
                             "classification", 16, 64, False, mesh=object())


# --------------------------------------------------------------------------- #
# Specs against the reference's in_shardings at full size
# --------------------------------------------------------------------------- #
def _ref_specs(shardings):
    return jax.tree.map(lambda s: JP(*s.spec), shardings,
                        is_leaf=lambda x: hasattr(x, "spec"))


def _norm(tree):
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (JP,)) or type(tree).__name__ == "P":
        return ("P",) + tuple(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(_norm(v) for v in tree)
    return tree


def _port_layout(ref_tree, port_tree, at=0):
    """A reference spec tree (blocks stacked on a group axis, a pattern
    of one) in the port's layout beside ``port_tree``: one entry a layer,
    the group axis (entry ``at``: 1 for a client-stacked tree) dropped."""
    if isinstance(ref_tree, dict) and "blocks" in ref_tree:
        out = {k: _port_layout(v, port_tree[k], at)
               for k, v in ref_tree.items() if k not in ("blocks", "tail")}
        drop = jax.tree.map(
            lambda s: JP(*(tuple(s)[:at] + tuple(s)[at + 1:])) if len(s)
            else s, ref_tree["blocks"][0], is_leaf=lambda x: isinstance(x,
                                                                        JP))
        out["layers"] = tuple(drop for _ in port_tree["layers"])
        return out
    if isinstance(ref_tree, dict):
        return {k: _port_layout(v, port_tree[k], at)
                for k, v in ref_tree.items()}
    return ref_tree


KEYS = {"fedllm": (4,), "kd": (6, 10, 11), "split": (6,)}
_REF_ABSTRACT = {}
STACKED = {"fedllm": (1, 2), "kd": (1, 2), "split": ()}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("step", ["train", "prefill", "decode", "fedllm",
                                  "kd", "split"])
def test_specs_match_reference(step, multi_pod, monkeypatch):
    """Every argument's specs, exactly, at Qwen3-1.7B's full size; where
    the reference takes PRNG keys the port's generators carry the
    client axis alone (the keys' leading entry, none for one key).  The
    reference's abstract parameters are traced once for all cases."""
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro.models import factory as ref_factory

    traced = ref_factory.Model.init_abstract

    def init_abstract(self, dtype=jnp.float32):
        key = (self.cfg, jnp.dtype(dtype).name)
        if key not in _REF_ABSTRACT:
            _REF_ABSTRACT[key] = traced(self, dtype)
        return _REF_ABSTRACT[key]

    monkeypatch.setattr(ref_factory.Model, "init_abstract", init_abstract)

    ref_cfg, cfg = ref_registry.get_config(ARCH), registry.get_config(ARCH)
    shape = dict(train="train_4k", prefill="prefill_32k",
                 decode="decode_32k").get(step, "train_4k")
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    ref_mesh = AbstractMesh(tuple(mesh.axis_sizes), mesh.axis_names)
    if step in ("train", "prefill", "decode"):
        _, _, want = ref_steps.BUILDERS[step](ref_cfg, REF_SHAPES[shape],
                                              ref_mesh)
        _, args, got = steps.BUILDERS[step](cfg, SHAPES[shape], mesh)
        keys, stacked = (), ()
    else:
        kw = dict(n_clients=2, framework=step, shard_clients=multi_pod)
        _, _, want = ref_steps.build_fed_round_step(
            ref_cfg, REF_SHAPES[shape], ref_mesh, **kw)
        _, args, got = steps.build_fed_round_step(cfg, SHAPES[shape], mesh,
                                                  **kw)
        keys, stacked = KEYS[step], STACKED[step]
    want = _ref_specs(want)
    assert len(got) == len(want) == len(args)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in keys:
            assert tuple(g) == tuple(w)[:len(g)], i
            continue
        w = _port_layout(w, g, 1 if i in stacked else 0)
        assert _norm(g) == _norm(w), i


def test_launch_builds_from_round_programs():
    import inspect
    src = inspect.getsource(steps)
    for sym in ("FedLLMProgram.spmd_round", "KDProgram.spmd_round",
                "SplitProgram.spmd_round"):
        assert f"round_program.{sym}" in src, sym
