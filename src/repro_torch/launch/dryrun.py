"""Multi-pod dry run: trace every (architecture x input shape) step on
the production meshes (16 x 16 = 256 devices, or 2 x 16 x 16 = 512) and
record each device's memory, FLOPs, bytes and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k [--multi-pod] [--step auto|train|prefill|decode|fed_round]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --step fed_round --fed-framework kd
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results.json

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each step with XLA against 256 or 512 fake host devices.  Here the step
of launch/steps.py runs eagerly inside ``mesh.fake_device_mesh`` (a
``DeviceMesh`` over a ``"fake"`` process group, which moves nothing):
each argument becomes a DTensor whose local shard, this rank's, is a
``meta`` tensor (shapes and dtypes, no memory) placed by
``sharding.to_placements`` of its spec, and DTensor's sharding
propagation runs every op on the local shards and issues the
collectives the layouts need.  ``StepCounter``, a dispatch mode under
DTensor, sees each local op.  The locals are ``meta`` tensors rather
than FakeTensors: under ``FakeTensorMode`` the executors' host-side
tensors (the Adam step counts, the validity mask) would turn fake and
their host reads fail; ``meta`` gives the same shape-only arithmetic
and leaves host tensors real.

The record has the reference's schema, with these meanings:

- ``hlo_flops``: each device's matmul-class FLOPs, the formulas of
  ``torch.utils.flop_counter`` (FlopCounterMode's count, the same ops
  decomposed as it decomposes them), not XLA's cost analysis, which
  also counts elementwise work.  An eager trace runs every layer, so
  nothing is counted once for a loop.
- ``hlo_bytes``: each device's bytes read and written, every dispatched
  op that is not a view (its tensor inputs read, its outputs written,
  allocation alone moving nothing), unfused: an upper bound of the
  traffic a fused program would make.
- ``arg_gib_per_dev`` / ``out_gib_per_dev``: the local shards' bytes of
  the step's arguments and outputs; an output counts in full even where
  it is an argument updated in place (decode's cache), as XLA counts an
  output buffer it was not told it may donate.
- ``temp_gib_per_dev``: the peak of the storages made during the step
  and alive at once (each storage from its first op output until the
  last tensor on it goes, a weakref finalizer), less the outputs' new
  storages.  The scans' shape-only path (kernels/ops) makes only its
  outputs, so the per-step states of the step-by-step twin are not in
  it.
- ``collective_bytes`` / ``collective_total``: roofline/collectives'
  trace of the functional collectives, each kind's result bytes on one
  device.
- ``replicated_at``: the sites where the port's code made a sharded
  dim whole because no DTensor rule takes it (models/dtensor.replicated);
  their cost is in the collectives.
- ``trace_s``: the wall time of the eager trace, standing for the
  reference's ``lower_s`` and ``compile_s``.

Host-side inputs stay real: a decode step's ``pos`` is the Python int
``seq_len - 1``, a round's validity mask an all-True CPU tensor, its
Adam step counts zeros on the CPU, its generators CPU generators.  The
gates of the reference's jaxpr and HLO checks read the trace:
``--dp-clip`` needs kernels/ops.clip_mean_rows (or its stacked form)
called in the round, ``--robust-agg median|trimmed_mean`` an
``aten.sort``, ``--shard-clients`` the stacked client axis placed
``Shard(0)`` on the mesh's client axes; each raises when absent.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import weakref
from collections import Counter
from typing import Dict, List

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch import dtensor
from repro_torch import tree as tree_lib
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, shape_supported, skip_reason
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_mod
from repro_torch.roofline import collectives as coll_mod

GiB = 2**30

ASSIGNED = [a for a in ARCHS if not a.startswith("gpt2")]

# factory ops: they allocate and write nothing worth counting as traffic
_ALLOCATING = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}


def _tensors(x) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class StepCounter(coll_mod.CollectiveTrace):
    """A dispatch mode that counts, on each local (plain) op: FLOPs by
    ``flop_counter.flop_registry`` (an op outside it decomposed first, as
    FlopCounterMode does), bytes in and out of every op but views and
    factories, the storages made and freed (the peak of those alive at
    once), the collectives (CollectiveTrace), and every op's name at
    either level (``dispatched``).  DTensor's own shape pass is not
    counted (``shadows``).  ``charge`` adds a shape-only path's
    formula."""

    def __init__(self, known=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.dispatched: Counter = Counter()
        self._shadow = 0
        self._storages: Dict[int, int] = {}
        for t in known:
            self._storages.setdefault(id(t.untyped_storage()), 0)

    @contextlib.contextmanager
    def shadows(self):
        """DTensor's shape propagation runs each new op once on global-
        shaped FakeTensors (ShardingPropagator's tensor-meta pass, the
        factories of its fake args included); while open, the ops of that
        pass go uncounted."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        names = [n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)]
        if not names:
            raise RuntimeError("ShardingPropagator has no tensor-meta "
                               "pass: the dry run cannot tell it apart")
        name = names[0]
        orig = getattr(ShardingPropagator, name)

        def shadowed(prop, *args, **kwargs):
            self._shadow += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                self._shadow -= 1

        setattr(ShardingPropagator, name, shadowed)
        try:
            yield self
        finally:
            setattr(ShardingPropagator, name, orig)

    def charge(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def new_bytes(self, tensors) -> int:
        """The bytes of the storages of ``tensors`` made during the step
        and alive now (each storage once)."""
        seen = {id(t.untyped_storage()) for t in tensors}
        return sum(self._storages.get(k, 0) for k in seen)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.dispatched[func._overloadpacket.__name__] += 1
        if coll_mod.distributed_call(types):
            return NotImplemented
        if self._shadow:
            return func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        outs = _tensors(out)
        if not func.is_view and func not in _ALLOCATING:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._track(outs)
        self.record(func, out)
        return out


@contextlib.contextmanager
def _watching(names):
    """Counts the calls of kernels/ops functions ``names`` (module
    attributes, as their callers reach them) into the yielded Counter."""
    calls: Counter = Counter()
    orig = {n: getattr(kernel_ops, n) for n in names}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    for n, fn in orig.items():
        setattr(kernel_ops, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in orig.items():
            setattr(kernel_ops, n, fn)


def _distribute(args, specs, dmesh, mesh):
    """The step's example args as DTensors on ``dmesh``: each meta leaf
    a DTensor of its spec's placements over a meta local shard (rank 0's,
    uneven splits rounding up as XLA pads); host tensors, non-tensors
    (ints, generators) and ``None`` as they are.  A mesh of one device
    places nothing: plain meta tensors."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(x, spec):
        if not torch.is_tensor(x) or not x.is_meta or dmesh is None:
            return x
        pl = sharding.to_placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(x.shape, dmesh, pl)
        return DTensor.from_local(
            torch.empty(local, dtype=x.dtype, device="meta"), dmesh, pl,
            run_check=False, shape=x.shape, stride=x.stride())

    def walk(a, s):
        if isinstance(a, dict):
            return {k: walk(v, s[k]) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            if isinstance(s, sharding.P) or s is None:
                return type(a)(walk(v, s) for v in a)
            return type(a)(walk(v, w) for v, w in zip(a, s))
        return one(a, s)

    return [walk(a, s) for a, s in zip(args, specs)]


def _locals(tree) -> List[torch.Tensor]:
    return [t._local_tensor if dtensor.is_distributed(t) else t
            for t in _tensors(tree)]


def _host_inputs(step, args, shape):
    """The host-side inputs real, as module docstring says: decode's pos
    a Python int; a round's validity mask all True and its Adam step
    counts zeros, on the CPU."""
    args = list(args)
    if step == "decode":
        args[3] = shape.seq_len - 1
        return args
    if step != "fed_round":
        return args
    for i, a in enumerate(args):
        if torch.is_tensor(a) and a.dtype == torch.bool:
            args[i] = torch.ones(a.shape, dtype=torch.bool)
        elif isinstance(a, dict) and isinstance(a.get("step"), torch.Tensor):
            args[i] = dict(a, step=torch.zeros(a["step"].shape,
                                                dtype=a["step"].dtype))
    return args


def trace_step(fn, args, specs, mesh, step: str, shape):
    """Runs ``fn`` once on ``args`` distributed over a fake DeviceMesh of
    ``mesh`` (plain meta tensors for a one-device mesh).  Returns (the
    program record: trace_s, GiB, FLOPs, bytes, collectives,
    replicated_at and the exact byte counts ``*_bytes_per_dev``; the
    StepCounter; the distributed arguments)."""
    from torch.distributed.tensor.experimental import implicit_replication

    args = _host_inputs(step, args, shape)
    one = all(s == 1 for s in mesh.axis_sizes)
    ctx = contextlib.nullcontext(None) if one \
        else mesh_mod.fake_device_mesh(mesh)
    with ctx as dmesh:
        dargs = _distribute(args, specs, dmesh, mesh)
        arg_locals = _locals(dargs)
        counter = StepCounter(known=arg_locals)
        t0 = time.time()
        with contextlib.ExitStack() as stack:
            if not one:
                stack.enter_context(implicit_replication())
            replicated = stack.enter_context(
                dtensor.recording_replications())
            stack.enter_context(kernel_ops.shape_only_costs(counter.charge))
            stack.enter_context(counter.shadows())
            stack.enter_context(counter)
            stack.enter_context(counter.fallbacks())
            out = fn(*dargs)
        trace_s = time.time() - t0
        out_locals = _locals(out)
        arg_b = sum(_nbytes(t) for t in arg_locals)
        out_b = sum(_nbytes(t) for t in out_locals)
        temp_b = max(counter.peak - counter.new_bytes(out_locals), 0)
        cb = coll_mod.collective_bytes(counter)
        prog = {
            "trace_s": round(trace_s, 2),
            "arg_gib_per_dev": round(arg_b / GiB, 3),
            "temp_gib_per_dev": round(temp_b / GiB, 3),
            "out_gib_per_dev": round(out_b / GiB, 3),
            "hlo_flops": float(counter.flops),
            "hlo_bytes": float(counter.bytes),
            "collective_bytes": cb,
            "collective_total": sum(cb.values()),
            "replicated_at": list(replicated),
            "arg_bytes_per_dev": arg_b,
            "temp_bytes_per_dev": temp_b,
            "out_bytes_per_dev": out_b,
        }
        del out, out_locals, arg_locals
    return prog, counter, dargs


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            step: str = "auto", remat: str = "full",
            scan_layers: bool = True, verbose: bool = True,
            parse_collectives: bool = True,
            fed_framework: str = "fedllm", kernel_policy: str = None,
            client_ranks=None, aggregation: str = "sync",
            dp_clip: float = 0.0, dp_noise_multiplier: float = 0.0,
            secure_agg: bool = False, backend: str = "spmd",
            shard_clients: bool = False, n_clients: int = None,
            population: str = None, cohort_size: int = None,
            robust_agg: str = "mean", faults: str = None, *,
            mesh=None, shape=None, cfg=None,
            dtype=torch.bfloat16) -> dict:
    """The reference's ``run_one``: one record.  ``scan_layers`` is
    accepted and ignored (an eager forward runs every layer), as is
    ``parse_collectives`` (the trace always has them).  Beyond the
    reference: ``mesh`` (a launch/mesh.MeshSpec) replaces the production
    mesh, ``shape`` (a ShapeConfig) the named shape's, ``cfg`` the
    arch's registry config (a reduced one, say), ``dtype`` the
    parameters' bf16."""
    from repro_torch.configs.base import PrivacyConfig

    if step == "fed_round" and backend not in ("spmd", "cohort"):
        raise ValueError(
            "--step fed_round traces the SPMD round program (the "
            "sequential backend is a python loop with no single-program "
            "artifact); use --backend spmd or cohort")
    # --population dirichlet:<alpha>:<n_virtual>: the cohort-streaming
    # scenario.  The traced program is the per-cohort chunk program (the
    # host driver re-invokes it over the stream), so the stacked client
    # axis is clamped to one cohort.
    n_virtual = None
    pop_alpha = None
    if population:
        try:
            kind, alpha_s, nv = population.split(":")
            if kind != "dirichlet":
                raise ValueError(kind)
            pop_alpha, n_virtual = float(alpha_s), int(nv)
        except ValueError:
            raise ValueError(
                f"bad --population {population!r} (expected "
                "dirichlet:<alpha>:<n_virtual>, e.g. dirichlet:0.5:100000)")
        if not cohort_size:
            raise ValueError("--population requires --cohort-size (the "
                             "virtual fleet streams cohort by cohort)")
    if cohort_size:
        n_clients = cohort_size if n_clients is None \
            else min(n_clients, cohort_size)
    # --faults: host-side fault injection, which never changes the
    # program; --robust-agg does (the closing client-axis reduction)
    fault_cfg = None
    if faults:
        from repro_torch.configs.base import FaultConfig
        keymap = {"dropout": ("dropout_rate", float),
                  "straggler": ("straggler_rate", float),
                  "delay": ("straggler_delay", int),
                  "byzantine": ("byzantine", int),
                  "mode": ("byzantine_mode", str),
                  "scale": ("byzantine_scale", float)}
        kw = {}
        try:
            for item in faults.split(","):
                k, v = item.split(":")
                field, cast = keymap[k]
                kw[field] = cast(v)
        except (ValueError, KeyError):
            raise ValueError(
                f"bad --faults {faults!r} (expected comma-separated "
                f"key:value with keys {sorted(keymap)}, e.g. "
                "dropout:0.2,byzantine:2)")
        fault_cfg = FaultConfig(**kw)
    cfg = cfg or get_config(arch)
    if kernel_policy:
        cfg = dataclasses.replace(cfg, kernel_policy=kernel_policy)
    shape = shape or SHAPES[shape_name]
    privacy = PrivacyConfig(dp_clip=dp_clip,
                            dp_noise_multiplier=dp_noise_multiplier,
                            secure_agg=secure_agg)
    mesh = mesh or mesh_mod.make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.axis_sizes),
           "step": shape.mode if step == "auto" else step,
           "kernel_policy": cfg.kernel_policy}
    if step == "fed_round":
        rec["fed_framework"] = fed_framework
        rec["backend"] = backend
        if population:
            rec["population"] = population
            rec["dirichlet_alpha"] = pop_alpha
            rec["n_virtual_clients"] = n_virtual
        if cohort_size:
            rec["cohort_size"] = cohort_size
            rec["cohort_count"] = -(-(n_virtual or n_clients
                                      or 2) // cohort_size)
        # async reuses the same per-bucket local-update programs (the
        # arrival schedule is host-side); the record keeps the axis
        rec["aggregation"] = aggregation
        if robust_agg != "mean":
            rec["robust_agg"] = robust_agg
        if fault_cfg is not None:
            rec["faults"] = faults
            rec["fault_config"] = dataclasses.asdict(fault_cfg)
        if client_ranks:
            rec["client_ranks"] = list(client_ranks)
        if privacy.enabled:
            rec["dp_clip"] = dp_clip
            rec["dp_noise_multiplier"] = dp_noise_multiplier
            rec["secure_agg"] = secure_agg
            if secure_agg:
                from repro_torch.privacy.secure_agg import key_exchange_bytes
                cohort = len(client_ranks) if client_ranks else 2
                up, down = key_exchange_bytes(cohort)
                rec["secagg_key_bytes_per_client"] = up + down

    # heterogeneous client_ranks run one stacked program a rank bucket
    # (core/rounds_spmd.py runs exactly these); Split buckets only
    # contiguous equal-rank runs (rank_segments), like the runtime
    builds = [("", {})]
    if step == "fed_round" and client_ranks:
        from repro_torch.core import fed_spmd
        group = fed_spmd.rank_segments if fed_framework == "split" \
            else fed_spmd.rank_buckets
        sigs = []
        for rank, cis in group(list(client_ranks)):
            if (rank, len(cis)) not in sigs:
                sigs.append((rank, len(cis)))
        builds = [(f"rank{rank}x{n}", {"n_clients": n, "lora_rank": rank})
                  for rank, n in sigs]

    if step == "auto" and not shape_supported(cfg, shape):
        rec["status"] = "SKIP"
        rec["reason"] = skip_reason(cfg, shape)
        return rec

    if step == "fed_round" and shard_clients:
        if n_clients is None:
            n_clients = mesh_mod.client_axis_size(mesh)
        rec["client_axis"] = list(mesh_mod.client_axes(mesh))
        rec["shard_clients"] = True
    rec["status"] = "OK"
    programs = []
    for label, build_kw in builds:
        if step == "fed_round":
            fed_kw = dict(framework=fed_framework, privacy=privacy,
                          shard_clients=shard_clients,
                          robust_agg=robust_agg, dtype=dtype)
            if n_clients is not None:
                fed_kw["n_clients"] = n_clients
            if cohort_size:
                fed_kw["cohort_size"] = cohort_size
            if backend == "cohort" and fed_framework == "fedllm":
                # hierarchical a4 reduce: one edge per pod
                ne = mesh_mod.n_edges(mesh)
                if ne > 1:
                    fed_kw["n_edges"] = ne
                    rec["n_edges"] = ne
            fed_kw.update(build_kw)
            fn, args, specs = steps_mod.build_fed_round_step(
                cfg, shape, mesh, **fed_kw)
        else:
            # the shape's mode picks the builder, whatever --step says,
            # as in the reference
            fn, args, specs = steps_mod.build_step(
                cfg, shape, mesh, remat=remat, dtype=dtype)
        with _watching(("clip_mean_rows", "clip_mean_rows_clients")) as calls:
            prog, counter, dargs = trace_step(
                fn, args, specs, mesh,
                "fed_round" if step == "fed_round" else shape.mode, shape)

        if step == "fed_round" and privacy.dp_clip > 0 \
                and fed_framework in ("fedllm", "kd"):
            # the DP machinery reached the round: the clip-scale-
            # accumulate entry point (whose CUDA kernels run under the
            # cuda policy) was called.  Split's threat surface is the c2
            # activation clip + noise, row math with no per-example
            # gradients, so there is no clip to find in its round.
            reached = sum(calls.values()) > 0
            prog["dp_clip_called"] = reached
            if not reached:
                raise RuntimeError(
                    "--dp-clip but kernels/ops.clip_mean_rows was not "
                    "called in the traced round: the DP-SGD path did not "
                    "reach it")
        if step == "fed_round" and robust_agg in ("median", "trimmed_mean"):
            # median and trimmed mean sort the stacked client axis, which
            # plain FedAvg never does
            reached = counter.dispatched["sort"] > 0
            prog["robust_sort_dispatched"] = reached
            if not reached:
                raise RuntimeError(
                    f"--robust-agg {robust_agg} but no aten.sort was "
                    "dispatched: the robust reduction did not reach the "
                    "traced round")
        if step == "fed_round" and shard_clients:
            # the stacked client axis of the LoRA tree is Shard(0) on
            # the mesh's client axes
            from torch.distributed.tensor import Shard
            names = mesh.axis_names
            want = [names.index(a) for a in mesh_mod.client_axes(mesh)]
            leaves = tree_lib.leaves(dargs[1])
            placed = bool(leaves) and all(
                dtensor.is_distributed(t) and all(
                    t.placements[i] == Shard(0) for i in want)
                for t in leaves)
            prog["client_axis_sharded"] = placed
            if not placed:
                raise RuntimeError(
                    "--shard-clients but the stacked client dimension is "
                    "not placed on the mesh's "
                    f"{mesh_mod.client_axes(mesh)} axes")
        del counter, dargs
        if label:
            prog["bucket"] = label
        programs.append(prog)

    if len(programs) == 1:
        rec.update(programs[0])
    else:
        # roll per-bucket programs up into the flat record: summed time,
        # flops and bytes, the peak per-device memory
        for k in ("trace_s", "hlo_flops", "hlo_bytes"):
            rec[k] = round(sum(p[k] for p in programs), 2)
        for k in ("arg_gib_per_dev", "temp_gib_per_dev", "out_gib_per_dev",
                  "arg_bytes_per_dev", "temp_bytes_per_dev",
                  "out_bytes_per_dev"):
            rec[k] = max(p[k] for p in programs)
        cb = {}
        for p in programs:
            for kind, nbytes in p["collective_bytes"].items():
                cb[kind] = cb.get(kind, 0) + nbytes
        rec["collective_bytes"] = cb
        rec["collective_total"] = sum(p["collective_total"]
                                      for p in programs)
        rec["replicated_at"] = list(dict.fromkeys(
            s for p in programs for s in p["replicated_at"]))
        rec["bucket_programs"] = programs
    if cohort_size and step == "fed_round":
        # the per-cohort peak: one chunk program's whole footprint
        rec["cohort_peak_gib_per_dev"] = round(
            rec.get("arg_gib_per_dev", 0.0)
            + rec.get("temp_gib_per_dev", 0.0)
            + rec.get("out_gib_per_dev", 0.0), 3)
    if verbose:
        print(f"[{rec['status']}] {arch} x {shape_name} ({rec['mesh']}, "
              f"{rec['step']}): trace={rec.get('trace_s', '-')}s "
              f"args={rec.get('arg_gib_per_dev', '-')}GiB "
              f"temp={rec.get('temp_gib_per_dev', '-')}GiB "
              f"out={rec.get('out_gib_per_dev', '-')}GiB "
              f"flops/dev={rec.get('hlo_flops', 0):.4e} "
              f"coll={rec.get('collective_total', 0)/1e9:.2f}GB"
              + (f" buckets={len(programs)}" if len(programs) > 1 else ""))
        if rec.get("collective_bytes"):
            print("    collectives: " + ", ".join(
                f"{k} {v/1e9:.3f}GB"
                for k, v in sorted(rec["collective_bytes"].items())))
        if rec.get("replicated_at"):
            print("    replicated at: " + "; ".join(rec["replicated_at"]))
        if cohort_size and step == "fed_round":
            print(f"    cohorts: {rec.get('cohort_count')} x "
                  f"{cohort_size} clients"
                  + (f" of {n_virtual} virtual" if n_virtual else "")
                  + f", per-cohort peak "
                  f"{rec['cohort_peak_gib_per_dev']}GiB/dev")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (assigned arch x shape), both meshes")
    ap.add_argument("--step", default="auto",
                    choices=["auto", "train", "prefill", "decode",
                             "fed_round"])
    ap.add_argument("--fed-framework", default="fedllm",
                    choices=["fedllm", "kd", "split"],
                    help="which paper framework --step fed_round traces")
    ap.add_argument("--backend", default="spmd",
                    choices=["sequential", "spmd", "cohort"],
                    help="round-engine execution backend for --step "
                         "fed_round; spmd traces the whole stacked round, "
                         "cohort the per-cohort chunk program the "
                         "streaming driver re-invokes")
    ap.add_argument("--shard-clients", action="store_true",
                    help="shard the stacked client axis of --step "
                         "fed_round over the mesh's client axes "
                         "(launch/mesh.client_axes) and verify its "
                         "placement")
    ap.add_argument("--n-clients", type=int, default=None,
                    help="client count for --step fed_round (default 2, "
                         "or the client-axis extent with "
                         "--shard-clients); with --cohort-size this is "
                         "an alias clamped to one cohort")
    ap.add_argument("--population", default=None,
                    help="virtual client population for --step fed_round "
                         "as dirichlet:<alpha>:<n_virtual>, e.g. "
                         "dirichlet:0.5:100000 (requires --cohort-size; "
                         "the record gets cohort_count and the per-cohort "
                         "peak memory)")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="clients per streamed cohort for --step "
                         "fed_round: the traced chunk program stacks "
                         "exactly one cohort")
    ap.add_argument("--kernel-policy", default=None,
                    choices=["torch", "cuda", "auto"],
                    help="override ModelConfig.kernel_policy for the "
                         "traced step (the meta shards resolve auto to "
                         "torch)")
    ap.add_argument("--client-ranks", default=None,
                    help="comma-separated per-client LoRA ranks for "
                         "--step fed_round, e.g. 4,8,8,16; traces one "
                         "stacked program per rank bucket")
    ap.add_argument("--aggregation", default="sync",
                    choices=["sync", "async"],
                    help="aggregation schedule axis to record; async "
                         "reuses the per-bucket local-update programs "
                         "(arrival scheduling is host-side)")
    ap.add_argument("--dp-clip", type=float, default=0.0,
                    help="per-example L2 clip for --step fed_round "
                         "(kernels/ops.clip_mean_rows must be called in "
                         "the traced round)")
    ap.add_argument("--dp-noise-multiplier", type=float, default=0.0,
                    help="Gaussian noise multiplier sigma; adds the "
                         "per-client noise generators to the round")
    ap.add_argument("--robust-agg", default="mean",
                    choices=["mean", "median", "trimmed_mean", "norm_clip"],
                    help="Byzantine-robust closing reduction for --step "
                         "fed_round; median/trimmed_mean must dispatch a "
                         "sort")
    ap.add_argument("--faults", default=None,
                    help="seeded fault-injection scenario to record, as "
                         "comma-separated key:value (keys: dropout, "
                         "straggler, delay, byzantine, mode, scale); "
                         "host-side, does not change the program")
    ap.add_argument("--secure-agg", action="store_true",
                    help="record the simulated secure-aggregation "
                         "overlay (host-side masking; key-exchange "
                         "bytes in the record)")
    ap.add_argument("--remat", default="full", choices=["none", "full"])
    ap.add_argument("--no-scan", action="store_true",
                    help="accepted for the reference's command lines; an "
                         "eager trace runs every layer")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    records = []
    if args.all:
        for arch in ASSIGNED:
            for shape_name in SHAPES:
                for mp in (False, True):
                    records.append(run_one(arch, shape_name, mp,
                                           remat=args.remat))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        ranks = tuple(int(r) for r in args.client_ranks.split(",")) \
            if args.client_ranks else None
        meshes = (False, True) if args.both_meshes else (args.multi_pod,)
        for mp in meshes:
            records.append(run_one(args.arch, args.shape, mp,
                                   step=args.step, remat=args.remat,
                                   fed_framework=args.fed_framework,
                                   kernel_policy=args.kernel_policy,
                                   client_ranks=ranks,
                                   aggregation=args.aggregation,
                                   dp_clip=args.dp_clip,
                                   dp_noise_multiplier=(
                                       args.dp_noise_multiplier),
                                   secure_agg=args.secure_agg,
                                   backend=args.backend,
                                   shard_clients=args.shard_clients,
                                   n_clients=args.n_clients,
                                   population=args.population,
                                   cohort_size=args.cohort_size,
                                   robust_agg=args.robust_agg,
                                   faults=args.faults))

    ok = sum(r["status"] == "OK" for r in records)
    skip = sum(r["status"] == "SKIP" for r in records)
    print(f"\n{ok} OK, {skip} SKIP(policy), {len(records)-ok-skip} FAIL "
          f"of {len(records)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    if len(records) - ok - skip:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
