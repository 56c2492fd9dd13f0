"""Step builders of the launch layer: the LoRA train step, the prefill
step, the serve (decode) step and the whole-round ``fed_round`` step of
each framework.  Each returns ``(fn, example_args, specs)``.

Counterpart of ``src/repro/launch/steps.py``.  ``example_args`` are the
step's arguments as ``meta`` tensors (shapes and dtypes, nothing
allocated; the parameters from ``Model.init_abstract(dtype)``, bf16 by
default as in the reference), with one ``torch.Generator`` a client
where the reference takes a grid of PRNG keys.  ``specs`` mirror them
with launch/sharding.py's partition specs, where the reference returns
``NamedSharding``s: the specs of a generator list are those of its
client axis.  To run a step, make real tensors of the example args'
shapes (``torch.zeros_like(x, device=...)`` and the like; the CUDA
kernels take float32, so pass ``dtype=torch.float32`` for a run on the
card) and call ``fn``: it runs under the config's kernel policy on the
device its tensors are on.

Differences from the reference: ``scan_layers`` is gone (an eager
forward is a Python loop over the layers; ``remat`` recomputes each
pattern group, models/transformer.forward); the federated rounds take no
``remat``, as the reference's round programs do not; ``mesh`` is a
launch/mesh.MeshSpec that only shapes the specs.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import (FedConfig, ModelConfig, PrivacyConfig,
                                      ShapeConfig)
from repro_torch.core import round_program, tasks
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.sharding import P, ShardingPolicy
from repro_torch.models.factory import build_model
from repro_torch.optim import adam
from repro_torch.peft import lora as lora_lib

LORA_RANK = 8
LORA_ALPHA = 32.0


def _policy_scoped(fn, cfg: ModelConfig):
    """``fn`` run under the config's kernel policy, as the round engine
    runs the same stages."""

    @functools.wraps(fn)
    def scoped(*args, **kwargs):
        with kernel_ops.policy_scope(cfg.kernel_policy):
            return fn(*args, **kwargs)

    return scoped


def _abstract_lora(params_shape, cfg, lora_rank):
    """The LoRA tree on ``default_targets`` and its Adam state, on meta."""
    with torch.device("meta"):
        lt = lora_lib.init_lora(torch.Generator(), params_shape,
                                lora_lib.default_targets(cfg), lora_rank,
                                LORA_ALPHA)
    return lt, adam.init(lt)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     remat: str = "full", lora_rank: int = LORA_RANK,
                     dtype=torch.bfloat16):
    """The local fine-tune step: the generative loss (plus the MoE aux
    term) differentiated with respect to the LoRA leaves only, the base
    frozen, then Adam at 1e-4.  fn(base, lt, opt, batch) -> (new_lt,
    new_opt, loss)."""
    model = build_model(cfg)
    policy = ShardingPolicy(mesh, cfg)
    params_shape = model.init_abstract(dtype)
    lt_shape, opt_shape = _abstract_lora(params_shape, cfg, lora_rank)
    batch_shape = specs_mod.train_input_specs(cfg, shape)
    lt_sp = policy.tree_specs(lt_shape)

    def train_step(base, lt, opt, batch):
        live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), lt)
        bound = lora_lib.bind(base, live, LORA_ALPHA, lora_rank)
        logits, aux = model.forward(bound, batch, remat=remat)
        # offset-aware LM loss (a VLM's image prefix shifts the positions)
        loss, _ = tasks.generative_loss_fn(logits, batch)
        loss = loss + aux
        leaves = tree_lib.leaves(live)
        # a model of no layers (the roofline's stem) has no LoRA leaves
        grads = torch.autograd.grad(loss, leaves) if leaves else []
        new_lt, new_opt = adam.update(tree_lib.unflatten(lt, list(grads)),
                                      opt, lt, 1e-4)
        return new_lt, new_opt, loss.detach()

    args = (params_shape, lt_shape, opt_shape, batch_shape)
    specs = (policy.tree_specs(params_shape), lt_sp,
             policy.opt_specs(lt_sp), policy.batch_spec(batch_shape))
    return _policy_scoped(train_step, cfg), args, specs


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       dtype=torch.bfloat16):
    """Inference prefill: the full-sequence forward (its full logits),
    the last position's logits returned.  fn(params, batch) -> (B, V)."""
    model = build_model(cfg)
    policy = ShardingPolicy(mesh, cfg)
    params_shape = model.init_abstract(dtype)
    batch_shape = specs_mod.train_input_specs(cfg, shape)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits[:, -1, :]

    return _policy_scoped(prefill_step, cfg), (params_shape, batch_shape), \
        (policy.tree_specs(params_shape), policy.batch_spec(batch_shape))


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      dtype=torch.bfloat16):
    """The serve step: one new token against a ``shape.seq_len``-deep
    cache (bf16, as the reference's).  fn(params, cache, token, pos) ->
    (logits (B, V), cache), the cache updated in place; ``pos`` an int or
    a 0-d tensor."""
    model = build_model(cfg)
    policy = ShardingPolicy(mesh, cfg)
    params_shape = model.init_abstract(dtype)
    cache_shape = specs_mod.abstract_cache(model, params_shape, shape)
    io = specs_mod.decode_input_specs(cfg, shape)
    GB = shape.global_batch
    tok_spec = P(policy.dp) if GB % max(policy.dp_size, 1) == 0 else P()

    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, int(pos))

    args = (params_shape, cache_shape, io["token"], io["pos"])
    specs = (policy.tree_specs(params_shape), policy.cache_specs(cache_shape),
             tok_spec, P())
    return _policy_scoped(serve_step, cfg), args, specs


def build_fed_round_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         n_clients: int = 2, n_local_steps: int = 1,
                         lora_rank: int = LORA_RANK,
                         framework: str = "fedllm",
                         privacy: PrivacyConfig = None,
                         shard_clients: bool = False,
                         cohort_size: int = 0, n_edges: int = 1,
                         robust_agg: str = "mean", dtype=torch.bfloat16):
    """A whole federated round of ``framework`` (``fedllm``, ``kd`` or
    ``split``) as one program, built from the stage functions the round
    engine runs (core/round_program's ``spmd_round``): the clients
    stacked on a leading axis, the server's aggregate a client-axis
    reduction.

    ``privacy`` threads a PrivacyConfig into the round (per-example
    DP-SGD clipping in the local update; with noise, one noise generator
    a client as an extra argument, a (C, S) grid of them for Split).
    ``robust_agg`` swaps the closing reduction for the robust combine.
    ``cohort_size`` > 0 clamps the client axis to one cohort;
    ``n_edges`` > 1 makes FedLLM's aggregate the two-hop
    ``fed_spmd.hierarchical_client_mean``.  ``shard_clients`` puts the
    client axis of the specs on the mesh's client axes (else only a
    multi-pod mesh's ``pod`` axis carries it).  FedLLM's round takes
    FedConfig's default LoRA dropout, KD's and Split's run at 0, as in
    the reference."""
    if cohort_size and cohort_size > 0:
        n_clients = min(n_clients, cohort_size)
    model = build_model(cfg)
    policy = ShardingPolicy(mesh, cfg)
    params_shape = model.init_abstract(dtype)
    lt_shape, opt_shape = _abstract_lora(params_shape, cfg, lora_rank)
    C, S = n_clients, n_local_steps

    def stack(t):
        return tree_lib.map_(lambda x: _meta((C,) + tuple(x.shape), x.dtype),
                             t)

    slt_shape = stack(lt_shape)
    sopt_shape = dict(stack({"m": opt_shape["m"], "v": opt_shape["v"]}),
                      step=_meta((C,), torch.int64))
    per_client_batch = max(shape.global_batch // n_clients, 1)

    def stacked_batch(extra_label_keys: bool):
        inner = specs_mod.train_input_specs(
            cfg, ShapeConfig(shape.name, shape.seq_len, per_client_batch,
                             "train"))
        if extra_label_keys:
            inner["labels"] = _meta((per_client_batch,), torch.int32)
            inner["lengths"] = _meta((per_client_batch,), torch.int32)
        return {k: _meta((C, S) + tuple(x.shape), x.dtype)
                for k, x in inner.items()}

    privacy = privacy or PrivacyConfig()
    pod = mesh_mod.client_axes(mesh) if shard_clients else (
        ("pod",) if "pod" in mesh.axis_names else ())

    def on_clients(x):
        return P(pod, *([None] * (x.dim() - 1)))

    def batch_specs(batch_shape, client_axis=pod):
        # the per-step batch dim can take ``data`` only when the client
        # axis does not (shard_clients on a single-pod mesh puts the
        # clients on ``data``)
        inner = ("data",) if "data" not in tuple(client_axis or ()) \
            else None
        return {k: P(client_axis, None,
                     inner if inner and x.shape[2] % max(
                         mesh.shape["data"], 1) == 0 else None,
                     *([None] * (x.dim() - 3)))
                for k, x in batch_shape.items()}

    def gens(n):
        return [torch.Generator() for _ in range(n)]

    param_sp = policy.tree_specs(params_shape)
    slt_sp = tree_lib.map_(on_clients, slt_shape)
    sopt_sp = tree_lib.map_(on_clients, sopt_shape)
    valid_shape = _meta((C, S), torch.bool)
    weights_shape = _meta((C,), torch.float32)
    valid_sp, weights_sp, gens_sp = P(pod, None), P(pod), P(pod)
    noised = privacy.noise_std > 0.0
    fed_kw = dict(lora_rank=lora_rank, lora_alpha=LORA_ALPHA,
                  privacy=privacy, robust_agg=robust_agg)

    if framework == "fedllm":
        fed = FedConfig(**fed_kw)
        round_step = round_program.FedLLMProgram.spmd_round(
            model, fed, task="generative", n_edges=n_edges)
        batch_shape = stacked_batch(False)
        args = (params_shape, slt_shape, sopt_shape, batch_shape, gens(C),
                valid_shape, weights_shape)
        specs = (param_sp, slt_sp, sopt_sp, batch_specs(batch_shape),
                 gens_sp, valid_sp, weights_sp)
        if noised:
            # one payload-noise generator a client (a3 upload boundary)
            args, specs = args + (gens(C),), specs + (gens_sp,)
        return _policy_scoped(round_step, cfg), args, specs

    if framework == "kd":
        # the classification task keeps the exchanged knowledge at the
        # class dims (generative KD is refused at b4 in both packages)
        fed = FedConfig(framework="kd", lora_dropout=0.0, **fed_kw)
        round_step = round_program.KDProgram.spmd_round(
            model, fed, task="classification")
        batch_shape = stacked_batch(True)
        public_shape = {
            "tokens": _meta((per_client_batch, shape.seq_len), torch.int32),
            "lengths": _meta((per_client_batch,), torch.int32)}
        lt_sp = policy.tree_specs(lt_shape)
        pub_sp = {k: P(("data",) if x.shape[0] % max(
            mesh.shape["data"], 1) == 0 else None, *([None] * (x.dim() - 1)))
            for k, x in public_shape.items()}
        args = (params_shape, slt_shape, sopt_shape, lt_shape, opt_shape,
                batch_shape, gens(C), valid_shape, weights_shape,
                public_shape, gens(C), torch.Generator())
        specs = (param_sp, slt_sp, sopt_sp, lt_sp, policy.opt_specs(lt_sp),
                 batch_specs(batch_shape), gens_sp, valid_sp, weights_sp,
                 pub_sp, gens_sp, P())
        if noised:
            # one b3 noise generator a client (upload boundary)
            args, specs = args + (gens(C),), specs + (gens_sp,)
        return _policy_scoped(round_step, cfg), args, specs

    if framework == "split":
        from repro_torch.core import split as split_mod

        fed = FedConfig(framework="split", lora_dropout=0.0, **fed_kw)
        sfns = split_mod.make_split_fns(model, fed, task="generative")
        round_step = round_program.SplitProgram.spmd_round(
            model, fed, task="generative", sfns=sfns)
        L = sfns["n_client_layers"]
        base_c, base_s = split_mod.split_base(params_shape, L,
                                              sfns["enc_dec"])
        c_shape, s_shape = split_mod.split_lora(lt_shape, L)
        s_opt_shape = adam.init(s_shape)
        s_sp = policy.tree_specs(s_shape)
        batch_shape = stacked_batch(False)
        # the client axis is looped over (the shared server half is
        # carried client to client), so nothing shards it
        args = (base_c, base_s, c_shape, s_shape, s_opt_shape, batch_shape,
                gens(C), valid_shape, weights_shape)
        specs = (policy.tree_specs(base_c), policy.tree_specs(base_s),
                 policy.tree_specs(c_shape), s_sp, policy.opt_specs(s_sp),
                 batch_specs(batch_shape, client_axis=None), P(None),
                 P(None, None), P(None))
        if noised:
            # a (C, S) grid of c2 activation noise generators
            args = args + ([gens(S) for _ in range(C)],)
            specs = specs + (P(None, None),)
        return _policy_scoped(round_step, cfg), args, specs
    raise ValueError(f"unknown federated framework {framework!r}")


BUILDERS = {
    "train": build_train_step,
    "prefill": build_prefill_step,
    "decode": build_decode_step,
}


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               remat: str = "full", dtype=torch.bfloat16):
    """Dispatch on the shape's mode."""
    if shape.mode == "train":
        return build_train_step(cfg, shape, mesh, remat=remat, dtype=dtype)
    if shape.mode == "prefill":
        return build_prefill_step(cfg, shape, mesh, dtype=dtype)
    return build_decode_step(cfg, shape, mesh, dtype=dtype)
