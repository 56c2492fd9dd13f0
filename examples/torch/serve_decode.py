"""Serving example on the PyTorch/H100 port: batched autoregressive
decode with merged LoRA weights — the deployment end of the federated
fine-tune (train with bind, serve with merge), across architecture
families, through launch/serve.py's ``generate``.

    PYTHONPATH=src python examples/torch/serve_decode.py [--device cpu]

Counterpart of examples/serve_decode.py; the card by default.
"""
import argparse
import time

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models.factory import build_model
from repro_torch.peft import lora
from repro_torch.runtime import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    for arch in ("qwen3-1.7b", "rwkv6-1.6b", "recurrentgemma-2b"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device=device)
        # pretend a federated run produced this adapter; merge for serving
        lt = lora.init_lora(torch.Generator().manual_seed(1), params,
                            lora.default_targets(cfg), 4)
        lt = tree_lib.map_(lambda x: x + 0.01, lt)
        served = lora.merge(params, lt, alpha=32.0, rank=4)

        B, P, G = 4, 8, 24
        prompt = torch.randint(1, cfg.vocab_size, (B, P),
                               generator=torch.Generator().manual_seed(2)
                               ).to(device)
        t0 = time.time()
        with torch.no_grad():
            _, logits = serve.generate(model, served, prompt, G,
                                       temperature=0.0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        assert torch.isfinite(logits).all()
        print(f"{arch:18s} ({cfg.family:6s}): {B}x{G} tokens in "
              f"{time.time()-t0:.2f}s (greedy, merged-LoRA serving)")


if __name__ == "__main__":
    main()
