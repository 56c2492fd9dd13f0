"""The dry run and the roofline of the port (launch/dryrun.py,
roofline/{hw,collectives,analysis}.py) on the CPU.

One module fixture runs the reference's ``run_one`` in a subprocess
(512 fake host devices) for Qwen3-1.7B at train_4k, prefill_32k and
decode_32k and its FedLLM fed_round at train_4k on the 16 x 16 mesh,
plus every assigned (arch, shape)'s skip decision on both meshes, while
the port traces the same four steps on its fake 16 x 16 DeviceMesh.
Held: status, step, mesh, reason and the SKIP set on every assigned
(arch, shape) and both meshes; ``arg_gib_per_dev`` and
``out_gib_per_dev`` equal at the reference's 3 decimals (a leaf that
differs by design: the Adam step counts, int64 host tensors beside the
reference's int32, 8 bytes a client, below the third decimal).

The FLOPs are held to hand-written sums of 2·M·N·K on a reduced dense
config and to ``FlopCounterMode`` over the same step run on real CPU
tensors; the reference's stem + group extrapolation to the full count;
the scans' shape-only path to the FLOPs and bytes the counter reads off
the step-by-step twins at S 8 (and a CPU tensor never takes it); the
collective trace to one all-gather and one all-reduce of known bytes on
a fake (2, 2) mesh; hw's H100 arithmetic; ``model_flops_for`` to the
reference's on every assigned (arch, shape).  No process group is left
behind."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.shapes import SHAPES, shape_supported  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.roofline import analysis, collectives, hw  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "qwen3-1.7b"
CASES = (("train_4k", "auto"), ("prefill_32k", "auto"),
         ("decode_32k", "auto"), ("train_4k", "fed_round"))
ONE = mesh_mod.MeshSpec((1, 1), ("data", "model"))

REFERENCE = """
import json, sys
from repro.launch import dryrun
from repro.configs.shapes import SHAPES
out = {"full": [dryrun.run_one(%r, s, step=st, verbose=False)
                for s, st in %r],
       "skips": [dryrun.run_one(a, s, mp, verbose=False)
                 for a in dryrun.ASSIGNED for s in SHAPES
                 for mp in (False, True)
                 if not dryrun.shape_supported(dryrun.get_config(a),
                                               SHAPES[s])],
       "assigned": dryrun.ASSIGNED}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def records():
    """(the reference's records, the port's), the reference's run in a
    subprocess while the port traces."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE % (ARCH, CASES)],
                            cwd=SRC, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mine = [dryrun.run_one(ARCH, s, step=st, verbose=False)
                for s, st in CASES]
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out), mine


def test_records_match_the_reference(records):
    theirs, mine = records
    for r, m in zip(theirs["full"], mine):
        assert r["status"] == m["status"] == "OK"
        for key in ("arch", "shape", "mesh", "step", "arg_gib_per_dev",
                    "out_gib_per_dev"):
            assert m[key] == r[key], (key, m, r)
        for key in ("trace_s", "temp_gib_per_dev", "hlo_flops", "hlo_bytes",
                    "collective_total", "replicated_at"):
            assert key in m
        assert m["hlo_flops"] > 0 and m["hlo_bytes"] > 0
        assert set(m["collective_bytes"]) <= set(collectives.COLLECTIVES)
        assert m["collective_total"] == sum(m["collective_bytes"].values())
    assert not torch.distributed.is_initialized()


def test_skip_set_matches_the_reference(records):
    """Every assigned (arch, shape) on both meshes: the reference's SKIP
    records (status, step, mesh, reason) are the port's, and the port
    skips nothing else (each other pair traces, as the four above and
    ``--all`` show)."""
    theirs, _ = records
    assert dryrun.ASSIGNED == theirs["assigned"]
    mine = [dryrun.run_one(a, s, mp, verbose=False)
            for a in dryrun.ASSIGNED for s in SHAPES for mp in (False, True)
            if not shape_supported(registry.get_config(a), SHAPES[s])]
    assert mine == theirs["skips"]
    assert len(mine) == 14 and all(r["status"] == "SKIP" for r in mine)


def _dense_flops(cfg, B, S):
    """Hand-written 2·M·N·K of Qwen3's forward at (B, S): the four
    projections, the S x S scores and their product with V (the plain
    twin computes the masked half too), the SwiGLU MLP, the head."""
    T, d, f = B * S, cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layer = 2 * T * d * (2 * hq + 2 * hkv) \
        + 2 * 2 * B * cfg.n_heads * S * S * cfg.head_dim \
        + 3 * 2 * T * d * f
    return cfg.n_layers * layer + 2 * T * d * cfg.vocab_size


def test_flops_are_the_hand_count():
    cfg = registry.get_config(ARCH).reduced()
    shape = ShapeConfig("prefill_32k", 32, 2, "prefill")
    rec = dryrun.run_one(ARCH, "prefill_32k", mesh=ONE, shape=shape, cfg=cfg,
                         verbose=False)
    assert rec["hlo_flops"] == _dense_flops(cfg, 2, 32)
    # on a (2, 2) mesh each device does a quarter: batch over data, heads,
    # ffn and vocab over model
    rec = dryrun.run_one(ARCH, "prefill_32k",
                         mesh=mesh_mod.MeshSpec((2, 2), ("data", "model")),
                         shape=shape, cfg=cfg, verbose=False)
    assert rec["hlo_flops"] == _dense_flops(cfg, 2, 32) / 4
    assert rec["collective_bytes"]["all-reduce"] > 0


def test_flops_equal_flop_counter_mode_on_a_real_run():
    """The train step's count on the one-device mesh (meta tensors) is
    FlopCounterMode's over the same step on real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(registry.get_config(ARCH).reduced(d_model=64),
                              kernel_policy="torch")
    shape = ShapeConfig("train_4k", 16, 2, "train")
    fn, args, specs = steps.build_train_step(cfg, shape, ONE,
                                             dtype=torch.float32)
    rec = dryrun.trace_step(fn, args, specs, ONE, "train", shape)[0]
    g = torch.Generator().manual_seed(0)

    def real(t):
        if not torch.is_tensor(t):
            return t
        if t.dtype == torch.int32:
            return torch.randint(1, cfg.vocab_size, t.shape, generator=g,
                                 dtype=torch.int32)
        return torch.randn(t.shape, generator=g) * 0.02

    params, lt, opt, batch = (tree_lib.map_(real, a) for a in args)
    with FlopCounterMode(display=False) as fc:
        fn(params, lt, opt, batch)
    assert rec["hlo_flops"] == fc.get_total_flops() > 0
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_lib.leaves((params, lt, opt, batch))
                 if torch.is_tensor(t))
    assert rec["arg_bytes_per_dev"] == nbytes


def test_stem_and_group_extrapolate_to_the_full_count():
    """On a forward step (a train step's stem of no layers has no LoRA
    leaf, so no backward at all: there the form undercounts the head's
    backward, in the reference's lowering as here)."""
    cfg = registry.get_config(ARCH).reduced(n_layers=4)
    shape = ShapeConfig("prefill_32k", 16, 2, "prefill")
    counts = [analysis._trace(analysis._variant(cfg, n), shape, ONE)
              for n in (0, 1, 4)]
    got = analysis.extrapolate(counts[0], counts[1], cfg.n_layers, 1)
    for key in ("flops", "bytes", "coll"):
        assert got[key] == counts[2][key], key


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_rglru_shape_only_cost_is_the_twins(h0, backward):
    B, S, W = 3, 8, 5
    got = _costs(lambda a, b, h: ops.rglru(a, b, h),
                 [(B, S, W), (B, S, W)] + ([(B, W)] if h0 else []),
                 backward, h0)
    want = _costs(lambda a, b, h: ref.rglru_scan(a, b, h),
                       [(B, S, W), (B, S, W)] + ([(B, W)] if h0 else []),
                       backward, h0)
    assert got == want
    assert got == tuple(sum(c) for c in zip(*(
        ops.rglru_twin_cost(B, S, W, 4, h0, bwd)
        for bwd in (False, True)[:1 + backward])))


@pytest.mark.parametrize("backward", [False, True])
def test_rwkv6_shape_only_cost_is_the_twins(backward):
    B, S, H, D = 2, 8, 3, 4
    shapes = [(B, S, H, D)] * 4 + [(H, D)]
    got = _costs(lambda *x: ops.rwkv6(*x), shapes, backward, True, grads=4)
    flat = [(B * H, S, D)] * 4 + [(H, D)]
    want = _costs(lambda *x: ref.rwkv6_scan(*x), flat, backward, True,
                  grads=4)
    copies = _costs(lambda *x: _flats(*x), shapes, backward, True, grads=4)
    assert got[0] == want[0]
    assert got[1] == want[1] + copies[1]


def _flats(r, k, v, logw, u):
    B, S, H, D = r.shape
    return tuple(x.transpose(1, 2).reshape(B * H, S, D)
                 for x in (r, k, v, logw))


def _costs(fn, shapes, backward, last, grads=2):
    """(flops, bytes) the counter reads off ``fn`` on meta tensors, the
    first ``grads`` inputs requiring grad under ``backward``."""
    xs = [torch.empty(s, device="meta", requires_grad=backward and i < grads)
          for i, s in enumerate(shapes)]
    counter = dryrun.StepCounter(known=xs)
    with ops.shape_only_costs(counter.charge), counter:
        out = fn(*(xs if last else xs + [None]))
        if backward:
            outs = [o for o in out if o is not None and o.requires_grad]
            torch.autograd.grad(outs, [x for x in xs if x.requires_grad],
                                [torch.empty_like(o) for o in outs])
    return counter.flops, counter.bytes



def test_shape_only_path_only_for_tensors_without_data(monkeypatch):
    taken = []
    monkeypatch.setattr(ops._ShapeOnlyRGLRU, "apply",
                        lambda *a: taken.append(1) or (a[0], a[0][:, 0]))
    a = torch.rand(2, 4, 3)
    h, hf = ops.rglru(a, a, None)
    assert not taken and torch.equal(hf, ref.rglru_scan(a, a)[1])
    ops.rglru(a.to("meta"), a.to("meta"), None)
    assert taken == [1]
    assert not ops.shape_only(a) and ops.shape_only(a.to("meta"))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        assert ops.shape_only(torch.empty(2))


def test_collectives_read_off_a_fake_mesh():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with mesh_mod.fake_device_mesh(
            mesh_mod.MeshSpec((2, 2), ("data", "model"))) as dm:
        x = DTensor.from_local(torch.empty(4, 6, device="meta"), dm,
                               [Shard(0), Replicate()], run_check=False)
        with collectives.CollectiveTrace() as tr:
            x.redistribute(dm, [Replicate(), Replicate()])
        assert collectives.collective_bytes(tr) == {"all-gather": 8 * 6 * 4}
        y = DTensor.from_local(torch.empty(4, 6, device="meta"), dm,
                               [Replicate(), Partial()], run_check=False)
        with collectives.CollectiveTrace() as tr:
            y.redistribute(dm, [Replicate(), Replicate()])
        assert collectives.collective_bytes(tr) == {"all-reduce": 4 * 6 * 4}
        assert collectives.total_collective_bytes(tr.records) == 96
    assert not torch.distributed.is_initialized()


def test_h100_roofline_terms():
    assert hw.compute_time_s(989.4e12, 1) == 1.0
    assert hw.compute_time_s(494.7e12, 3, "3xtf32") == 1.0
    assert hw.compute_time_s(66.9e12 * 2, 2, "fp32") == 1.0
    assert hw.memory_time_s(3.35e12 * 4, 4) == 1.0
    assert hw.collective_time_s(50e9, 1) == 1.0
    t = analysis.RooflineTerms("a", "s", "16x16", 256, hlo_flops=989.4e12,
                               hlo_bytes=6.7e12, collective_bytes=25e9,
                               model_flops=989.4e12 * 128)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 2.0, 0.5)
    assert t.dominant == "memory" and t.step_time_s == 2.0
    assert t.useful_ratio == 0.5
    assert set(t.row()) == {"arch", "shape", "mesh", "t_compute_s",
                            "t_memory_s", "t_collective_s", "dominant",
                            "hlo_flops", "hlo_bytes", "collective_bytes",
                            "model_flops", "useful_ratio"}


def test_model_flops_match_the_reference():
    jax = pytest.importorskip("jax")  # noqa: F841
    from repro.configs import registry as ref_registry
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro.roofline import analysis as ref_analysis

    for arch in dryrun.ASSIGNED:
        for name, shape in SHAPES.items():
            assert analysis.model_flops_for(registry.get_config(arch), shape) \
                == ref_analysis.model_flops_for(
                    ref_registry.get_config(arch), REF_SHAPES[name]), \
                (arch, name)
