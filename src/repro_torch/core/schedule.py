"""Dynamic tunable-parameter schedules (paper SSIV.A.3): grow the LoRA
rank across rounds, cheap early rounds and capacity when it matters.

Counterpart of ``src/repro/core/schedule.py``."""
from __future__ import annotations

from typing import Sequence


def rank_schedule(round_idx: int, total_rounds: int,
                  ranks: Sequence[int] = (2, 4, 8)) -> int:
    """Staircase rank growth over training."""
    stage = min(len(ranks) - 1,
                round_idx * len(ranks) // max(total_rounds, 1))
    return ranks[stage]


def grow_lora(lt, new_rank: int):
    """Zero-pad a LoRA tree to a larger rank (a warm start that keeps the
    current delta, since the padded rows of B are zero)."""
    from repro_torch.peft import lora as lora_lib
    return lora_lib.pad_rank(lt, new_rank)
