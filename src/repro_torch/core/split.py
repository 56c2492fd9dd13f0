"""Split-FedLLMs: activation-based updates (paper SSII.C):

    c1 client: forward through the first layers on private data
    c2 client -> server: boundary activations (+ labels)
    c3 server: forward through the remaining layers, loss, backprop
    c4 server -> client: activation gradients
    c5 client: backprop through its layers, update its LoRA
    cc1-cc4 clients <-> server: LoRA FedAvg of the *client-side* params

Counterpart of ``src/repro/core/split.py``.  A decoder-only model splits
at an *inter* point, a pattern-group boundary: the client holds the
embedding (with a VLM's ``img_proj``, which projects the batch's
``img_embeds`` into the prefix) and pattern groups [0, L), the server
the groups [L, G), the tail layers that follow the last full group, the
final norm and the head (tied to the embedding in GPT-2 and
RecurrentGemma, which both halves keep).  An encoder-decoder model
(Whisper) splits at its natural boundary, L = 0: the client holds the
encoder and runs models/encdec.encode on the batch's ``enc_embeds``, the
boundary is the encoder's output (B, S_enc, d), and the server runs the
whole decoder on it (models/encdec.decode_given_enc).

The boundary transfers pass through int8/int4 straight-through
quantization (paper SSIV.C.2) when ``activation_quant_bits`` is set: the
per-row CUDA kernel of kernels/quantize.py under the ``cuda`` kernel
policy (core/compression.quant_roundtrip).  Wire bytes are what the
quantized payload costs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.core import compression, tasks
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common, encdec, transformer
from repro_torch.models.factory import Model
from repro_torch.optim.api import make_optimizer
from repro_torch.peft import lora as lora_lib
from repro_torch.privacy import dp as dp_mod


# --------------------------------------------------------------------------- #
# LoRA and base-tree partitioning
# --------------------------------------------------------------------------- #
def split_lora(lt, n_client_layers: int):
    """(client_tree, server_tree) from a full-model LoRA tree: the client
    takes the first ``n_client_layers`` entries of the flat ``layers``
    list (L pattern groups: ``make_split_fns``' ``n_client_layers``, L·P),
    the server the rest, tail included."""
    client, server = {}, {}
    for k, v in lt.items():
        if k == "layers":
            client[k] = v[:n_client_layers]
            server[k] = v[n_client_layers:]
        elif k == "encoder":
            client[k] = v
        else:
            server[k] = v
    return client, server


def join_lora(client, server):
    """The full-model LoRA tree from its two halves."""
    out = {}
    for k in list(client) + [k for k in server if k not in client]:
        if k == "layers" and k in server:
            out[k] = list(client[k]) + list(server[k])
        else:
            out[k] = client[k] if k in client else server[k]
    return out


def split_base(base, n_client_layers: int, enc_dec: bool = False):
    """The frozen base params sliced after layer ``n_client_layers`` (as
    ``split_lora``).  The client half drops the final norm and the head;
    the server keeps the embedding, which a tied head reads.  With
    ``enc_dec`` the client holds the encoder alone and the server the
    rest (the decoder)."""
    if enc_dec:
        return ({k: v for k, v in base.items() if k == "encoder"},
                {k: v for k, v in base.items() if k != "encoder"})
    client = dict(base)
    client["layers"] = base["layers"][:n_client_layers]
    for k in ("final_norm", "lm_head"):
        client.pop(k, None)
    server = dict(base)
    server["layers"] = base["layers"][n_client_layers:]
    return client, server


# --------------------------------------------------------------------------- #
# Split train step
# --------------------------------------------------------------------------- #
def make_split_fns(model: Model, fed: FedConfig,
                   task: str = "classification"):
    """Returns a dict with ``split_step``, ``split_grads``, ``opt_init``,
    ``n_client_groups`` (L; 0 for an encoder-decoder), ``n_client_layers``
    (L times the pattern's length: the split point of ``split_lora`` and
    ``split_base``), ``enc_dec`` (``split_base``'s argument),
    ``wire_bytes_per_batch`` and ``n_groups``."""
    cfg = model.cfg
    task_loss = tasks.get_loss_fn(task)
    opt_init, opt_update = make_optimizer(fed.optimizer)
    n_groups = transformer.n_groups_of(cfg)
    enc_dec = cfg.is_encoder_decoder
    L = 0 if enc_dec else min(max(fed.split_layer, 0), n_groups - 1)
    qbits = fed.activation_quant_bits

    def _bind(base, lt, gen: Optional[torch.Generator] = None):
        rank = lora_lib.tree_rank(lt, fed.lora_rank)
        return lora_lib.bind(base, lt, fed.lora_alpha, rank,
                             dropout_gen=gen, dropout=fed.lora_dropout)

    def _maybe_q(x):
        return compression.quant_roundtrip(x, qbits)[0] if qbits else x

    def split_grads(base_c, base_s, c_lt, s_lt, batch, gen=None,
                    noise_gen=None):
        """(loss, c_grads, s_grads, h, h_grad) of one split step, the
        gradients as lists in ``tree.leaves`` order: ``h`` is the client's
        raw boundary output, ``h_grad`` the server's raw gradient of it
        (before the c4 quantization).  ``gen`` draws the LoRA-dropout
        masks of both halves; ``noise_gen`` (privacy/dp.noise_generator
        of the step) the c2 noise when ``PrivacyConfig.dp_clip > 0``."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        with kernel_ops.policy_scope(cfg.kernel_policy):
            # c1: client forward
            c_live = [t.detach().requires_grad_(True)
                      for t in tree_lib.leaves(c_lt)]
            bound = _bind(base_c, tree_lib.unflatten(c_lt, c_live), gen)
            if enc_dec:
                h = encdec.encode(bound, cfg, batch["enc_embeds"])
            else:
                h, positions = transformer.embed_tokens(
                    bound, cfg, tokens, batch.get("img_embeds"))
                h, _ = transformer.forward_groups(bound, cfg, h, positions,
                                                  0, L)
            # c2: activations up, privatized then quantized.  Straight
            # through: the reference takes the client's vjp before the
            # clip, the noise and the rounding, so no gradient flows
            # through them (autograd through clip_rows would differ).
            up = dp_mod.privatize_rows(h.detach(), noise_gen, fed)
            h_wire = _maybe_q(up).requires_grad_(True)
            # c3: server forward and backward
            s_live = [t.detach().requires_grad_(True)
                      for t in tree_lib.leaves(s_lt)]
            bound = _bind(base_s, tree_lib.unflatten(s_lt, s_live), gen)
            if enc_dec:
                logits, aux = encdec.decode_given_enc(bound, cfg, tokens,
                                                      h_wire)
            else:
                # the positions run over the boundary's rows (a VLM's
                # image prefix included)
                Sp = h_wire.shape[1]
                pos = torch.arange(Sp, device=h_wire.device)[None].expand(
                    B, Sp)
                hs, aux = transformer.forward_groups(
                    bound, cfg, h_wire, pos, 0, n_groups - L,
                    include_tail=True)
                hs = common.apply_norm(cfg.norm, bound["final_norm"], hs)
                logits = transformer.lm_logits(bound, cfg, hs)
            loss, _ = task_loss(logits, batch)
            loss = loss + aux
            *s_grads, h_grad = torch.autograd.grad(loss, s_live + [h_wire])
            # c4/c5: gradients down (quantized), applied to the client's
            # raw output
            c_grads = []
            if c_live and h.requires_grad:
                c_grads = list(torch.autograd.grad(h, c_live,
                                                   _maybe_q(h_grad)))
        return loss.detach(), c_grads, s_grads, h.detach(), h_grad

    def split_step(base_c, base_s, c_lt, s_lt, c_opt, s_opt, batch,
                   gen=None, noise_gen=None):
        """One split training step; returns (new_c, new_s, c_opt, s_opt,
        loss).  Each half has its own optimizer state and step count."""
        loss, c_grads, s_grads, _, _ = split_grads(base_c, base_s, c_lt, s_lt,
                                                   batch, gen, noise_gen)
        new_c, c_opt2 = opt_update(tree_lib.unflatten(c_lt, c_grads), c_opt,
                                   c_lt, fed.lr)
        new_s, s_opt2 = opt_update(tree_lib.unflatten(s_lt, s_grads), s_opt,
                                   s_lt, fed.lr)
        return new_c, new_s, c_opt2, s_opt2, loss

    def wire_bytes_per_batch(batch_shape: Tuple[int, int]) -> Tuple[int, int]:
        """(activation_up, grad_down) bytes for one batch (c2/c4): the
        payload (int4 nibble-packed, ceil per row) plus a 4-byte scale a
        row when quantized.  An encoder-decoder's boundary has
        ``cfg.encoder_seq_len`` rows an example, whatever the text's
        length."""
        B, S = batch_shape
        if enc_dec:
            S = cfg.encoder_seq_len
        rows, d = B * S, cfg.d_model
        if qbits == 4:
            payload = rows * ((d + 1) // 2)
        elif qbits:
            payload = rows * d * qbits // 8
        else:
            payload = rows * d * 4
        scale = rows * 4 if qbits else 0
        return payload + scale, payload + scale

    return {"split_step": split_step, "split_grads": split_grads,
            "opt_init": opt_init, "n_client_groups": L,
            "n_client_layers": L * transformer.group_len(cfg),
            "enc_dec": enc_dec,
            "wire_bytes_per_batch": wire_bytes_per_batch,
            "n_groups": n_groups}


# --------------------------------------------------------------------------- #
# Dynamic split-point selection (SSIV.C.1)
# --------------------------------------------------------------------------- #
def choose_split_point(cfg: ModelConfig, client_flops_budget: float,
                       n_tokens_per_round: int) -> int:
    """Largest client-side group count whose per-round training FLOPs fit
    the client budget (resource-aware workload distribution)."""
    n_groups = max(1, cfg.n_layers // max(len(cfg.layer_pattern or (1,)), 1))
    per_group = 6.0 * (cfg.active_param_count() / max(cfg.n_layers, 1)) \
        * len(cfg.layer_pattern or (1,)) * n_tokens_per_round
    if per_group <= 0:
        return 1
    k = int(client_flops_budget // per_group)
    return int(min(max(k, 1), n_groups - 1))
