"""The training entry point: LoRA fine-tuning of any ``--arch`` (reduced unless
``--full-size``; ``gpt2*`` never) on the synthetic Markov LM corpus, the
generative task.  Counterpart of ``src/repro/launch/train.py``, with the
same flags and ``--device`` (default ``cuda``; a machine without CUDA
raises, as runtime.resolve_device does, rather than carrying on on the
CPU):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 50 --batch 8 --seq 64 [--full-size] [--ckpt-dir DIR] \\
        [--device cpu]

Each step trains on ``tokens[:, :seq]`` of a (batch, seq + 1) window of
the corpus (``data/synthetic.lm_batches``), every position counted
(``lengths = seq``), through ``core/fedavg.make_fns(task="generative")``'s
train step (Adam at ``--lr``, LoRA of ``--rank`` on
``peft/lora.default_targets``).  A VLM's batch carries stub
``img_embeds`` and an encoder-decoder's stub ``enc_embeds``, 0.02·N(0, 1)
drawn on the host from a generator of their own.  With ``--ckpt-dir``
the LoRA tree is saved every 25 steps (checkpoint/manager's template
snapshot, the step's loss as metadata).  The run exits 0 when the mean of
the last 5 losses is below the mean of the first 5.

``run`` takes what a caller may supply instead of the flags' draws (the
config, base weights, the initial LoRA tree, the batches, a per-step
callback), as ``core/rounds.run_federated`` takes ``base=`` / ``lora=``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.fedavg import make_fns, to_device
from repro_torch.data import synthetic
from repro_torch.models.factory import build_model
from repro_torch.peft import lora as lora_lib
from repro_torch.runtime import resolve_device

CKPT_EVERY = 25


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-tiny", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (big!) instead of .reduced()")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def arch_config(args) -> ModelConfig:
    """``--arch``'s config, ``.reduced()`` unless ``--full-size`` or a
    ``gpt2*`` name."""
    cfg = get_config(args.arch)
    if not args.full_size and not args.arch.startswith("gpt2"):
        cfg = cfg.reduced()
    return cfg


def fed_config(cfg: ModelConfig, args) -> FedConfig:
    return FedConfig(lora_rank=args.rank, lr=args.lr, lora_dropout=0.0,
                     lora_targets=lora_lib.default_targets(cfg))


def initial_lora(base, fed: FedConfig, args):
    """The run's initial LoRA tree, drawn from ``--seed`` + 1."""
    return lora_lib.init_lora(torch.Generator().manual_seed(args.seed + 1),
                              base, fed.lora_targets, fed.lora_rank,
                              fed.lora_alpha)


def lm_batches(cfg: ModelConfig, args) -> Iterator[dict]:
    """The run's numpy batches, forever: ``markov_corpus(200_000, V)``
    windows, tokens cut to ``--seq``, ``lengths`` all ``--seq``, zero
    labels, and the model's stub embeddings (from a host generator seeded
    with ``--seed`` + 2)."""
    corpus = synthetic.markov_corpus(200_000, cfg.vocab_size, seed=args.seed)
    windows = synthetic.lm_batches(corpus, args.batch, args.seq,
                                   seed=args.seed)
    stub = torch.Generator().manual_seed(args.seed + 2)

    def draw(shape):
        return (0.02 * torch.randn(shape, generator=stub)).numpy()

    for w in windows:
        batch = {"tokens": w["tokens"][:, :args.seq],
                 "lengths": np.full((args.batch,), args.seq, np.int32),
                 "labels": np.zeros((args.batch,), np.int32)}
        if cfg.n_image_tokens:
            batch["img_embeds"] = draw((args.batch, cfg.n_image_tokens,
                                        cfg.image_embed_dim))
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = draw((args.batch, cfg.encoder_seq_len,
                                        cfg.d_model))
        yield batch


@dataclasses.dataclass
class TrainResult:
    rc: int
    lora: dict
    losses: List[float]


def run(args, cfg: ModelConfig = None, base=None, lora=None,
        batches: Iterator[dict] = None,
        on_step: Optional[Callable] = None) -> TrainResult:
    """The run of ``args``: ``--steps`` train steps over the
    batches (numpy, moved to the device), ``on_step(step, lt, loss)``
    after each, a checkpoint every CKPT_EVERY steps.  ``cfg`` (default
    arch_config), ``base`` (default ``model.init`` from ``--seed``),
    ``lora`` (default initial_lora) and ``batches`` (default lm_batches)
    replace its draws."""
    device = resolve_device(args.device)
    cfg = cfg or arch_config(args)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"family={cfg.family}")
    if base is None:
        base = model.init(torch.Generator().manual_seed(args.seed), device)
    fed = fed_config(cfg, args)
    fns = make_fns(model, fed, task="generative")
    lt = initial_lora(base, fed, args) if lora is None else lora
    opt = fns["opt_init"](lt)
    print(f"LoRA params: {lora_lib.n_params(lt) / 1e3:.1f}k "
          f"(targets={fed.lora_targets})")
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    batches = batches or lm_batches(cfg, args)
    t0, losses = time.perf_counter(), []
    for step in range(args.steps):
        batch = to_device(next(batches), device)
        lt, opt, loss = fns["train_step"](base, lt, opt, batch)
        losses.append(float(loss))
        if on_step is not None:
            on_step(step, lt, losses[-1])
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.perf_counter() - t0) / (step + 1):.2f}s/step)")
        if ckpt is not None and (step + 1) % CKPT_EVERY == 0:
            ckpt.save(step + 1, lt, {"loss": losses[-1]})
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return TrainResult(0 if last < first else 1, lt, losses)


def main(argv=None) -> int:
    return run(parse_args(argv)).rc


if __name__ == "__main__":
    raise SystemExit(main())
