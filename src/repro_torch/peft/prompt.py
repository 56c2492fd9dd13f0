"""Prompt tuning, the paper's third PEFT option: ``n_virtual`` learned
embeddings prepended to every input sequence (a soft prompt, passed to
the model as the batch's ``prefix_embeds``).

Counterpart of ``src/repro/peft/prompt.py``.
"""
from __future__ import annotations

import torch

from repro_torch.runtime import resolve_device


def init_prompt(gen: torch.Generator, d_model: int, n_virtual: int = 16,
                device=None):
    """{"prompt": (n_virtual, d_model)} drawn as 0.02·N(0, 1) from
    ``gen`` on the CPU, then moved to ``device`` (None: CUDA, or
    raise)."""
    p = torch.randn((n_virtual, d_model), generator=gen) * 0.02
    return {"prompt": p.to(resolve_device(device))}


def expand(prompt_tree, batch: int):
    """(n_virtual, d) -> (B, n_virtual, d) prefix embeddings."""
    p = prompt_tree["prompt"]
    return p[None].expand(batch, *p.shape)
