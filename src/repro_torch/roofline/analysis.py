"""Roofline analysis: each (arch x shape x mesh) step's three roofline
terms on the H100, from the dry run's trace.

Counterpart of ``src/repro/roofline/analysis.py``.  The reference reads
XLA's ``cost_analysis()``, which counts a scanned layer once, so it
lowers a stem (0 layers) and one pattern group unrolled and scales:

    total = stem + (group - stem) * (n_layers / len(pattern))

An eager trace (launch/dryrun.trace_step) runs every layer, so
``analyze`` traces the full depth.  ``_variant`` and the stem + group
form stay (``extrapolate``), an identity the tests hold to the full count
on a uniform-pattern arch.

Per (arch x shape x mesh), each term one device's (the trace's counts
are per device, as the reference's post-SPMD ones):

    compute    = hlo_flops / peak of the parameters' dtype (hw.PEAKS)
    memory     = hlo_bytes / 3.35 TB/s
    collective = collective_bytes / 50 GB/s (the inter-node rate)

plus MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference) and
the MODEL_FLOPS / (hlo_flops · chips) usefulness ratio.  ``hlo_flops``
counts matrix products only (torch.utils.flop_counter's formulas) and
``hlo_bytes`` every unfused op's traffic: the compute term is a floor
for the products, the memory term a ceiling for the traffic.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.roofline import hw


def _trace(cfg, shape, mesh, remat="full", dtype=torch.bfloat16) -> dict:
    """The dry run's counts of cfg's step at ``shape`` on ``mesh``."""
    from repro_torch.launch import dryrun

    fn, args, specs = steps_mod.build_step(cfg, shape, mesh, remat=remat,
                                           dtype=dtype)
    prog = dryrun.trace_step(fn, args, specs, mesh, shape.mode, shape)[0]
    return {"flops": prog["hlo_flops"], "bytes": prog["hlo_bytes"],
            "coll": float(prog["collective_total"]),
            "coll_by_kind": prog["collective_bytes"]}


def _variant(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    enc = min(cfg.n_encoder_layers, n_layers) if cfg.n_encoder_layers else 0
    return dataclasses.replace(cfg, n_layers=n_layers,
                               n_encoder_layers=enc)


def extrapolate(stem: dict, group: dict, n_layers: int, pattern: int):
    """The reference's stem + group scaling of the counts ``flops``,
    ``bytes`` and ``coll`` to ``n_layers``."""
    scale = n_layers / pattern
    return {k: stem[k] + (group[k] - stem[k]) * scale
            for k in ("flops", "bytes", "coll")}


@dataclasses.dataclass
class RooflineTerms:
    """The trace's counts are one device's (DTensor's local shards), so
    each term divides by one GPU's peak.  ``dtype`` picks the compute
    peak (hw.PEAKS): bf16, as the reference's one peak, unless the step
    ran another."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per device
    hlo_bytes: float          # per device
    collective_bytes: float   # per device
    model_flops: float        # GLOBAL analytic 6ND / 2ND
    # seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dtype: str = "bf16"

    def __post_init__(self):
        self.t_compute = hw.compute_time_s(self.hlo_flops, 1, self.dtype)
        self.t_memory = hw.memory_time_s(self.hlo_bytes, 1)
        self.t_collective = hw.collective_time_s(self.collective_bytes, 1)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global traced FLOPs: below 1 where the step does
        extra products (remat's recompute, attention, replicated work)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: 1 token/seq


def analyze(arch_cfg: ModelConfig, shape_name: str,
            multi_pod: bool = False, remat: str = "full",
            verbose: bool = True, *, shape: ShapeConfig = None, mesh=None,
            dtype=torch.bfloat16, peak: str = None) -> RooflineTerms:
    """The reference's ``analyze``, from one full-depth trace.  Beyond
    it: ``shape`` and ``mesh`` (a launch/mesh.MeshSpec) replace the named
    shape's and the production mesh, ``dtype`` the parameters' bf16, and
    ``peak`` the hw.PEAKS key of the compute term (by default the
    dtype's: bf16, or fp32 parameters' 3xtf32, what the port's fp32
    kernels run)."""
    cfg = arch_cfg
    shape = shape or SHAPES[shape_name]
    mesh = mesh or mesh_mod.make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(mesh.axis_sizes)
    full = _trace(cfg, shape, mesh, remat, dtype)
    terms = RooflineTerms(
        arch=cfg.name, shape=shape_name,
        mesh="x".join(str(s) for s in mesh.axis_sizes), chips=chips,
        hlo_flops=full["flops"], hlo_bytes=full["bytes"],
        collective_bytes=full["coll"],
        model_flops=model_flops_for(cfg, shape),
        dtype=peak or ("bf16" if dtype == torch.bfloat16 else "3xtf32"))
    if verbose:
        r = terms
        print(f"{cfg.name} x {shape_name}: compute={r.t_compute*1e3:.1f}ms "
              f"memory={r.t_memory*1e3:.1f}ms "
              f"collective={r.t_collective*1e3:.1f}ms "
              f"-> {r.dominant}-bound, useful={r.useful_ratio:.2f}")
    return terms
