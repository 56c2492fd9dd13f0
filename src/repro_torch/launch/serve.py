"""Serving entry point: batched autoregressive decode with the KV and
recurrent caches, for any ``--arch`` (reduced unless ``--full-size``).

Counterpart of ``src/repro/launch/serve.py``, with the same flags and
``--device`` (default ``cuda``; a machine without CUDA raises, as
runtime.resolve_device does, rather than carrying on on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --batch 4 --prompt-len 16 --gen 32 [--device cpu]

``generate`` prefills by single-step decode (teacher forcing over the
prompt), then takes the greedy token after the prompt and samples each
later one at ``temperature`` (greedy at 0) from an explicit generator.
The decode steps run under the model's kernel policy
(models/factory.Model.decode_step): on the card a bound LoRA projection
launches the fused LoRA kernel and a cross-attention the flash kernel.
A federated run's adapter is served merged (peft/lora.merge) or bound
(peft/lora.bind).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.models.factory import build_model
from repro_torch.runtime import resolve_device


def decode_logits(model, params, tokens, batch=None,
                  cache_dtype=torch.float32):
    """Teacher forcing: the logits (B, T, V) at every position of
    ``tokens`` (B, T), each from one decode_step on a fresh cache of T
    positions (``batch`` carries an encoder-decoder's ``enc_embeds``)."""
    B, T = tokens.shape
    cache = model.init_cache(params, B, T, batch, dtype=cache_dtype)
    steps = []
    for t in range(T):
        logits, cache = model.decode_step(params, cache, tokens[:, t], t)
        steps.append(logits)
    return torch.stack(steps, 1)


def generate(model, params, prompt, gen: int, temperature: float = 1.0,
             gen_rng=None, batch=None, cache=None,
             cache_dtype=torch.float32):
    """prompt (B, P) -> (generated tokens (B, gen), the last step's logits
    (B, V)).  The reference's loop: P prefill steps, then the argmax of
    the last prompt step's logits as the first token, then ``gen`` steps,
    each feeding the last token and drawing the next (argmax at
    ``temperature`` 0, else ``torch.multinomial`` of softmax(logits / T)
    from ``gen_rng``, a generator on the logits' device).  ``cache``
    (made by ``model.init_cache`` for P + gen positions) or a fresh one
    in ``cache_dtype``."""
    B, P = prompt.shape
    if cache is None:
        cache = model.init_cache(params, B, P + gen, batch, dtype=cache_dtype)
    logits = None
    for t in range(P):
        logits, cache = model.decode_step(params, cache, prompt[:, t], t)
    tok = logits.argmax(-1)
    out = []
    for t in range(P, P + gen):
        out.append(tok)
        logits, cache = model.decode_step(params, cache, tok, t)
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen_rng)[:, 0]
        else:
            tok = logits.argmax(-1)
    return torch.stack(out, 1), logits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-tiny", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size and not args.arch.startswith("gpt2"):
        cfg = cfg.reduced()
    model = build_model(cfg)
    host = torch.Generator().manual_seed(args.seed)
    params = model.init(host, device)
    B = args.batch
    prompt = torch.randint(1, cfg.vocab_size, (B, args.prompt_len),
                           generator=host).to(device)
    batch = {"tokens": prompt}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = (0.02 * torch.randn(
            (B, cfg.encoder_seq_len, cfg.d_model), generator=host)).to(device)
    sampler = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        cache = model.init_cache(params, B, args.prompt_len + args.gen, batch,
                                 dtype=torch.float32)
        t0 = time.perf_counter()
        out, logits = generate(model, params, prompt, args.gen,
                               args.temperature, sampler, cache=cache)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    print(f"arch={cfg.name}: generated {tuple(out.shape)} tokens in "
          f"{dt:.2f}s ({B * args.gen / dt:.1f} tok/s batched)")
    print("sample:", out[0][:16].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("serve: non-finite logits")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
