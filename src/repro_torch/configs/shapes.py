"""The four assigned input shapes and the decode-shape eligibility rule.

Counterpart of ``src/repro/configs/shapes.py``: ``long_500k`` only for
sub-quadratic archs (recurrent, hybrid or a native sliding window); every
other arch runs the other three shapes."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k only for sub-quadratic archs; everything else runs all
    four shapes."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape_supported(cfg, shape):
        return ""
    return (f"{cfg.name} is pure full-attention: a {shape.seq_len} dense KV "
            "cache is the quadratic blow-up this shape discriminates "
            "(DESIGN SSDecode-shape policy)")
