"""Privacy subsystem: client-side DP-SGD, an RDP accountant, and
simulated secure aggregation — the paper's research-direction axes
(SSVI; FedLLM survey arXiv:2503.12016) as scenario knobs.

Counterpart of ``src/repro/privacy/``.  Configured by
``configs/base.PrivacyConfig`` (``FedConfig.privacy``) and wired through
core/round_program for FedLLM and KD-FedLLM (sequential clients, sync
rounds).  Per-framework threat surfaces:

==========  =========================  ================================
framework   private payload            mechanism
==========  =========================  ================================
FedLLM      LoRA param upload (a3)     per-example grad clip (DP-SGD)
                                       + Gaussian noise on the params
                                       + secure-agg masks on the upload
KD-FedLLM   public-set logits (b3)     per-example grad clip in b1 +
                                       row-clipped noisy logits (before
                                       top-k/int-quant compression) +
                                       secure-agg masks on the upload
Split       smashed activations (c2)   with the Split slice: per-token-
            + client-half LoRA (cc1)   row clip + Gaussian noise on
                                       every boundary transfer;
                                       secure-agg masks on the adapter
                                       upload
==========  =========================  ================================
"""
from repro_torch.privacy.accountant import GaussianAccountant  # noqa: F401
from repro_torch.privacy.dp import (clipped_grad_mean,  # noqa: F401
                                    noise_generator, privatize_logits,
                                    privatize_rows, privatize_tree)
from repro_torch.privacy.secure_agg import SecureAggSession  # noqa: F401
