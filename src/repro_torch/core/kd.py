"""KD-FedLLMs — logit-based knowledge sharing (paper SSII.B):

    b1 client: local fine-tuning on private data
    b2 client: logits on the PUBLIC dataset with the fine-tuned model
    b3 clients -> server: logits (optionally top-k / int8 compressed)
    b4 server: knowledge processing (weighted/filtered aggregation)
    b5 server: distillation -> global model update
    b6 server: global logits on the public dataset
    b7 server -> clients: global logits
    b8 client: local KD against the global knowledge

Counterpart of ``src/repro/core/kd.py``.  No parameters cross the
network: communication scales with |public dataset| x logit dim.  The
logits stay on the device from b2 to b8; only the per-step losses are
read back, once per distillation.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import compression, metrics
from repro_torch.core.fedavg import to_device
from repro_torch.data.loader import epoch_batches
from repro_torch.runtime import compute_dtype


def client_logits(fns, base, lt, public: Dict, batch_size: int, device):
    """b2: knowledge representations on the public dataset, row i holding
    the logits of public sample i.  Batches arrive permuted (seed-0
    shuffle), so the concatenation is scattered back to the original row
    order, which ``distill`` indexes teachers by."""
    outs = [fns["logits_fn"](base, lt, to_device(batch, device))
            for batch in epoch_batches(public, batch_size, seed=0,
                                       drop_remainder=False)]
    stacked = torch.cat(outs, dim=0)
    perm = torch.as_tensor(_epoch_perm(len(public["tokens"]), 0),
                           device=stacked.device)
    out = torch.zeros_like(stacked)
    out[perm] = stacked
    return out


def compress_for_wire(logits, fed: FedConfig):
    """b3 compression (SSIV.B.2).  Returns (logits', wire_bytes).  With
    both ``logit_topk`` and ``logit_quant_bits`` set, selection and
    quantization are one fused kernel (kernels/quantize.py)."""
    x = logits
    if fed.logit_topk and fed.logit_topk < x.shape[-1]:
        if fed.logit_quant_bits:
            comp, wire = compression.topk_quantize(x, fed.logit_topk,
                                                   fed.logit_quant_bits)
            return compression.topk_dequantize(comp), wire
        comp, wire = compression.topk_compress(x, fed.logit_topk)
        return compression.topk_decompress(comp), wire
    if fed.logit_quant_bits:
        return compression.quant_roundtrip(x, fed.logit_quant_bits)
    return x, x.numel() * 4


def logit_wire_bytes(shape, fed: FedConfig) -> int:
    """Arithmetic twin of ``compress_for_wire``'s byte accounting for a
    logit tensor of ``shape`` (the b7 download of global logits)."""
    n, d = math.prod(shape[:-1]), shape[-1]
    topk = fed.logit_topk if (fed.logit_topk and fed.logit_topk < d) else 0
    return metrics.logit_bytes(n, d, topk, fed.logit_quant_bits)


def aggregate_knowledge(client_logits_list: List,
                        weights: Optional[List[float]] = None,
                        entropy_filter_frac: float = 0.0):
    """b4: refined global knowledge.  Weighted mean of client logits, with
    optional entropy-based filtering (SSIV.B.3): samples whose mean
    predictive entropy is in the highest ``frac`` quantile take the
    lowest-entropy client's logits.  The client logits must stack to (C,
    N, D): a generative task's (N, S, V) knowledge raises ValueError, as
    the reference's ``einsum("c,cnd->nd")`` does (a KD round over LM
    logits is not a feature of either package)."""
    if weights is None:
        weights = [1.0] * len(client_logits_list)
    stack = torch.stack([x.float() for x in client_logits_list])
    if stack.dim() != 3:
        raise ValueError(f"aggregate_knowledge: the client logits stack to "
                         f"{tuple(stack.shape)}, not (C, N, D)")
    w = _normalized_w(torch.tensor(weights, dtype=torch.float32,
                                   device=stack.device))
    agg = torch.einsum("c,cnd->nd", w, stack)
    if entropy_filter_frac > 0.0:
        logp = torch.log_softmax(stack, dim=-1)
        ent = -(logp.exp() * logp).sum(-1)                 # (C, N)
        mean_ent = ent.mean(0)
        thresh = torch.quantile(mean_ent, 1.0 - entropy_filter_frac)
        noisy = mean_ent >= thresh
        best_client = ent.argmin(0)                        # (N,)
        chosen = stack[best_client, torch.arange(stack.shape[1],
                                                 device=stack.device)]
        agg = torch.where(noisy[:, None], chosen, agg)
    return agg


def aggregate_knowledge_batched(stacked, weights):
    """b4 as a client-axis reduction (the whole-round KD program,
    core/round_program.KDProgram.spmd_round): the weighted mean over axis
    0 of a (C, N, D) logit stack, summed in fp32 (fp64 for an fp64
    stack), the weights normalized as ``aggregate_knowledge``'s (a
    zero-mass cohort gives the uniform mean)."""
    dt = compute_dtype(stacked.dtype)
    w = _normalized_w(torch.as_tensor(weights, dtype=torch.float32,
                                      device=stacked.device))
    return torch.einsum("c,cnd->nd", w.to(dt), stacked.to(dt))


def _normalized_w(w):
    """Normalized knowledge weights; a zero-mass cohort degrades to a
    uniform mean instead of NaN."""
    s = w.sum()
    return torch.where(s > 0, w / torch.where(s > 0, s, 1.0),
                       1.0 / w.shape[0])


def distill(fns, base, lt, opt_state, public: Dict, teacher, epochs: int,
            batch_size: int, device, seed: int = 0):
    """b5/b8: update LoRA params by distilling ``teacher`` logits (N, D)
    on the device, row i for public sample i.  ``seed`` seeds the
    LoRA-dropout generator.  Returns (lt, opt_state, mean loss)."""
    gen = torch.Generator().manual_seed(seed)
    n = len(public["tokens"])
    total, count = 0.0, 0
    for ep in range(epochs):
        perm = torch.as_tensor(_epoch_perm(n, ep), device=teacher.device)
        start = 0
        for batch in epoch_batches(public, batch_size, seed=ep,
                                   drop_remainder=False):
            b = len(batch["tokens"])
            # teacher rows follow the same permutation as the batches
            t = teacher[perm[start:start + b]]
            start += b
            lt, opt_state, loss = fns["kd_step"](
                base, lt, opt_state, to_device(batch, device), t, gen)
            total = total + loss * b
            count += b
    return lt, opt_state, float(total) / max(count, 1)


def _epoch_perm(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)


# --------------------------------------------------------------------------- #
# Public-dataset alignment (SSIV.B.1)
# --------------------------------------------------------------------------- #
def align_public_dataset(public: Dict, client_label_hists: List[np.ndarray],
                         target_size: int, seed: int = 0) -> Dict:
    """Importance-resample the public dataset toward the clients' average
    label distribution, using only the label histograms clients share."""
    rng = np.random.default_rng(seed)
    target = np.mean(np.stack(client_label_hists), axis=0)
    labels = public["labels"]
    pub_hist = np.bincount(labels, minlength=len(target)).astype(np.float64)
    pub_hist /= max(pub_hist.sum(), 1.0)
    w = target[labels] / np.maximum(pub_hist[labels], 1e-9)
    w /= w.sum()
    sel = rng.choice(len(labels), size=target_size, replace=True, p=w)
    return {k: v[sel] for k, v in public.items()}
