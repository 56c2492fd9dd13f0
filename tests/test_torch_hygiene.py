"""Boundaries of the port: it imports neither JAX nor the reference
package, it never carries on on the CPU when CUDA was asked for, its CUDA
kernel paths refuse CPU tensors instead of falling back, and every
``FedConfig`` setting outside the ported slices raises."""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers per host
torch.set_num_threads(1)

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import (FaultConfig, FedConfig,  # noqa: E402
                                      PrivacyConfig)
from repro_torch.configs.gpt2_small import gpt2_tiny  # noqa: E402
from repro_torch.configs.recurrentgemma_2b import recurrentgemma_2b  # noqa: E402
from repro_torch.configs.rwkv6_1_6b import rwkv6_1_6b  # noqa: E402
from repro_torch.core import rounds  # noqa: E402
from repro_torch.core.rounds import run_federated  # noqa: E402
from repro_torch.data import banking77, partition  # noqa: E402
from repro_torch.kernels import dp_clip  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kd_loss as kdl  # noqa: E402
from repro_torch.kernels import lora_matmul as lm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.peft import lora as lora_lib  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

WALK = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert {"repro_torch.privacy.dp", "repro_torch.privacy.accountant",
        "repro_torch.privacy.secure_agg", "repro_torch.optim.clip",
        "repro_torch.kernels.dp_clip", "repro_torch.core.split",
        "repro_torch.kernels.rglru_scan", "repro_torch.models.rglru",
        "repro_torch.configs.recurrentgemma_2b",
        "repro_torch.kernels.rwkv6_scan", "repro_torch.models.rwkv6",
        "repro_torch.configs.rwkv6_1_6b",
        "repro_torch.core.fed_spmd", "repro_torch.core.rng",
        "repro_torch.data.population", "repro_torch.faults.plan",
        "repro_torch.faults.guard", "repro_torch.checkpoint.serialization",
        "repro_torch.checkpoint.manager",
        "repro_torch.checkpoint.federated", "repro_torch.configs.registry",
        "repro_torch.configs.qwen2_1_5b", "repro_torch.configs.qwen3_1_7b",
        "repro_torch.configs.mistral_large_123b",
        "repro_torch.configs.nemotron_4_340b",
        "repro_torch.configs.mixtral_8x7b",
        "repro_torch.configs.qwen3_moe_235b_a22b",
        "repro_torch.configs.llava_next_34b",
        "repro_torch.configs.whisper_base",
        "repro_torch.models.moe", "repro_torch.models.encdec",
        "repro_torch.peft.adapters", "repro_torch.peft.prompt",
        "repro_torch.optim.sgd", "repro_torch.optim.schedule",
        "repro_torch.data.synthetic", "repro_torch.launch.train",
        "repro_torch.launch.serve", "repro_torch.launch.mesh",
        "repro_torch.launch.sharding", "repro_torch.launch.specs",
        "repro_torch.launch.steps", "repro_torch.configs.shapes",
        "repro_torch.core.rounds_spmd",
        "repro_torch.core.schedule"} <= set(names), names
"""


ENTRY_POINTS = """
import importlib, importlib.util, sys
from pathlib import Path
root = Path.cwd().parent
for name in ("repro_torch.launch.dryrun", "repro_torch.roofline.hw",
             "repro_torch.roofline.collectives",
             "repro_torch.roofline.analysis"):
    importlib.import_module(name)
files = [root / "scripts" / "torch_run_roofline.py",
         *sorted((root / "examples" / "torch").glob("*.py"))]
for path in files:
    spec = importlib.util.spec_from_file_location("m_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(files), bad)
assert not bad, bad
"""


def test_dry_run_roofline_script_and_examples_import_no_jax():
    """The dry run, the roofline modules (a namespace package the walk
    above does not enter), scripts/torch_run_roofline.py and the seven
    examples/torch/*.py load neither JAX nor the reference package."""
    out = subprocess.run([sys.executable, "-c", ENTRY_POINTS], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) == 8


def test_port_imports_no_jax_and_nothing_of_repro():
    out = subprocess.run([sys.executable, "-c", WALK], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64, torch.int32])
def test_cuda_path_refuses_tensors_that_are_not_fp32(dtype):
    """The CUDA kernels are fp32 instances: a CUDA tensor of another dtype
    raises ValueError, never cast and never sent to the plain version (a
    stand-in for a CUDA tensor here, where there is no card)."""
    import types
    on_card = types.SimpleNamespace(is_cuda=True, dtype=dtype,
                                    device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="float32"):
        ops._require_cuda("lora_matmul", on_card)
    ops._require_cuda("lora_matmul", types.SimpleNamespace(
        is_cuda=True, dtype=torch.float32, device=torch.device("cuda", 0)))


@pytest.fixture(scope="module")
def tiny_case():
    cfg = gpt2_tiny()
    pub, train, test = banking77.paper_splits(cfg.vocab_size, pad_len=24,
                                              scale=0.02)
    return cfg, pub, partition.iid_partition(train, 3), test


def test_run_federated_without_device_needs_cuda(tiny_case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, pub, clients, test = tiny_case
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated(cfg, FedConfig(rounds=1, lora_dropout=0.0), pub,
                      clients, test)


def test_split_without_device_needs_cuda(tiny_case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, pub, clients, test = tiny_case
    fed = FedConfig(framework="split", split_layer=2, rounds=1,
                    lora_dropout=0.0, activation_quant_bits=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated(cfg, fed, pub, clients, test)


def test_model_init_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(gpt2_tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].device.type == "cpu"


def test_cuda_policy_refuses_cpu_tensors():
    x, w, a, b = (torch.randn(2, 5, 16), torch.randn(16, 8),
                  torch.randn(16, 2), torch.randn(2, 8))
    q = torch.randn(1, 6, 2, 8)
    logits = torch.randn(4, 77)
    g = torch.randn(4, 96)
    with ops.policy_scope("cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.lora_matmul(x, w, a, b)
        with pytest.raises(ValueError, match="CUDA"):
            ops.mha_attention(q, q, q)
        with pytest.raises(ValueError, match="CUDA"):
            ops.kd_loss(logits, logits, 2.0)
        with pytest.raises(ValueError, match="CUDA"):
            ops.topk_quantize(logits, 8, 8)
        with pytest.raises(ValueError, match="CUDA"):
            ops.clip_mean_rows(g, 1.0)
        with pytest.raises(ValueError, match="CUDA"):
            ops.clip_mean_rows_clients(g.view(2, 2, 96), 1.0)
        with pytest.raises(ValueError, match="CUDA"):
            ops.quantize(g, 8)
        with pytest.raises(ValueError, match="CUDA"):
            ops.quantize_pack4(g)
    # the kernel wrappers themselves check before anything is built
    with pytest.raises(ValueError, match="CUDA"):
        lm.lora_fwd(x[0], w, a, b)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="CUDA"):
        kdl.kd_fwd(logits, logits, 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        qz.topk_quantize(logits, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        qz.quantize_rows(g, 8)
    with pytest.raises(ValueError, match="CUDA"):
        qz.quantize_pack4(g)
    with pytest.raises(ValueError, match="CUDA"):
        dp_clip.dp_clip_norms(g)
    with pytest.raises(ValueError, match="CUDA"):
        dp_clip.dp_clip_acc(g, torch.ones(4), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        dp_clip.dp_clip_acc_clients(g.view(2, 2, 96), torch.ones(2, 2), 1.0)


def test_auto_policy_resolves_by_device():
    assert ops.resolve("auto", "cpu") == "torch"
    assert ops.resolve("auto", torch.device("cuda", 0)) == "cuda"
    assert ops.resolve("torch", "cuda") == "torch"
    with pytest.raises(ValueError):
        ops.resolve("xla", "cpu")


@pytest.mark.parametrize("change", [
    dict(peft="adapter"),
])
def test_unported_settings_raise(tiny_case, change):
    cfg, pub, clients, test = tiny_case
    fed = dataclasses.replace(FedConfig(rounds=1, lora_dropout=0.0), **change)
    with pytest.raises(NotImplementedError):
        run_federated(cfg, fed, pub, clients, test, device="cpu")


@pytest.mark.parametrize("backend", ["sequential", "spmd"])
def test_generative_kd_raises_value_error(tiny_case, backend):
    """KD over a generative task's knowledge (N, S, V) is a feature of
    neither package: the reference's b4 einsum raises ValueError, and so
    does the port's aggregate_knowledge, under both backends."""
    cfg, pub, clients, test = tiny_case
    fed = FedConfig(framework="kd", rounds=1, lora_dropout=0.0,
                    backend=backend)
    with pytest.raises(ValueError, match="not \\(C, N, D\\)"):
        run_federated(cfg, fed, pub, clients, test, task="generative",
                      device="cpu")


@pytest.mark.parametrize("change", [
    dict(framework="kd", backend="cohort", robust_agg="median"),
    dict(framework="split", backend="cohort", quorum=0.5),
    dict(backend="spmd", privacy=PrivacyConfig(dp_clip=0.5),
         faults=FaultConfig(dropout_rate=0.2)),
    dict(backend="cohort", screen_factor=3.0),
    dict(backend="cohort", aggregation="async", robust_agg="trimmed_mean"),
    dict(backend="spmd", client_ranks=(2, 4, 4),
         faults=FaultConfig(straggler_rate=0.5)),
    dict(robust_agg="median"),
    dict(quorum=0.5), dict(screen_factor=3.0),
    dict(framework="split", backend="cohort", client_ranks=(2, 4, 4),
         robust_agg="norm_clip"),
    dict(aggregation="async", robust_agg="median"),
    dict(faults=FaultConfig(dropout_rate=0.2)),
])
def test_fault_tolerance_settings_run(tiny_case, change):
    """The settings the port refused before fault tolerance was ported
    (faults, robust_agg, quorum, the norm screen, under each backend) run
    a round to its end: one history entry, a finite final LoRA, an int
    count of rollovers."""
    cfg, pub, clients, test = tiny_case
    fed = dataclasses.replace(FedConfig(rounds=1, lora_dropout=0.0), **change)
    res = run_federated(cfg, fed, pub, clients, test, device="cpu")
    assert len(res.history) == 1
    leaves = tree_lib.leaves(res.final_lora)
    assert leaves and all(bool(torch.isfinite(x).all()) for x in leaves)
    assert isinstance(res.rollovers, int)


@pytest.mark.parametrize("change,kwargs", [
    (dict(aggregation="bogus"), {}), (dict(backend="bogus"), {}),
    (dict(robust_agg="bogus"), {}), (dict(quorum=1.5), {}),
    (dict(client_ranks=(2, 4)), {}), (dict(trim_frac=0.7), {}),
    ({}, dict(checkpoint_every=1)),
])
def test_invalid_settings_raise_value_error(tiny_case, change, kwargs):
    """The reference's value checks come first: an invalid setting raises
    ValueError (not NotImplementedError), and trim_frac=0.7 does not run."""
    cfg, pub, clients, test = tiny_case
    fed = dataclasses.replace(FedConfig(rounds=1, lora_dropout=0.0), **change)
    with pytest.raises(ValueError):
        run_federated(cfg, fed, pub, clients, test, device="cpu", **kwargs)


@pytest.mark.parametrize("make", [
    lambda: gpt2_tiny(),
    lambda: recurrentgemma_2b().reduced(n_layers=3, d_model=64),
    lambda: rwkv6_1_6b().reduced(n_layers=2, d_model=64)])
def test_empty_targets_resolve_to_default_targets(tiny_case, make,
                                                  monkeypatch):
    """``lora_targets=()`` takes ``default_targets(cfg)``, the reference's
    choice for the same config: QKV with attention, the time-mix
    projections when every layer is RG-LRU or RWKV-6."""
    jax_lora = pytest.importorskip("repro.peft.lora")
    ref_configs = pytest.importorskip("repro.configs.base")
    cfg = make()
    _, pub, clients, test = tiny_case
    seen = []
    monkeypatch.setattr(rounds, "run_program",
                        lambda *args, **kwargs: seen.append(args[4]))
    run_federated(cfg, FedConfig(rounds=1, lora_dropout=0.0,
                                 lora_targets=()), pub, clients, test,
                  device="cpu")
    ref_cfg = ref_configs.ModelConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "kernel_policy"})
    assert seen == [lora_lib.default_targets(cfg)] == \
        [jax_lora.default_targets(ref_cfg)]
    assert seen[0] == (lora_lib.RWKV_TARGETS if cfg.attention_free
                       else lora_lib.DEFAULT_TARGETS)


def test_default_targets_on_rwkv_train_nothing(tiny_case):
    """``FedConfig``'s default targets (wq, wk, wv) name no RWKV-6 weight:
    as in the reference, the run trains nothing (an empty LoRA tree, no
    LoRA bytes on the wire, the same loss every round) and does not
    crash."""
    _, pub, clients, test = tiny_case
    cfg = rwkv6_1_6b().reduced(n_layers=2, d_model=64)
    res = run_federated(cfg, FedConfig(rounds=2, lora_dropout=0.0), pub,
                        clients, test, device="cpu")
    assert res.ledger.by_name() == {"lora_params": 0}
    assert res.final_lora == {}
    assert res.history[0].loss == res.history[1].loss


def test_noise_without_clip_raises(tiny_case):
    """The reference's refusal: noise scaled by a clip of 0 bounds
    nothing."""
    cfg, pub, clients, test = tiny_case
    fed = FedConfig(rounds=1, lora_dropout=0.0,
                    privacy=PrivacyConfig(dp_noise_multiplier=1.0))
    with pytest.raises(ValueError, match="dp_clip"):
        run_federated(cfg, fed, pub, clients, test, device="cpu")


def test_checkpointing_and_unported_models_raise(tiny_case, tmp_path):
    """Checkpointing runs (a run of one round with ``checkpoint_every=1``
    writes its snapshot into ``tmp_path``).  The registry's VLM and
    encoder-decoder build, and ``run_federated``, whose batches carry no
    stub embeddings (as the reference's), runs them as the reference
    does (tests/test_torch_vlm_encdec.py holds both runs to the
    reference's): LLaVA text-only, its ``img_proj`` unused (the run
    without it is bit for bit the same), and Whisper fails on the
    missing ``enc_embeds``, a KeyError naming them."""
    cfg, pub, clients, test = tiny_case
    fed = FedConfig(rounds=1, lora_dropout=0.0)
    run_federated(cfg, fed, pub, clients, test, device="cpu",
                  checkpoint_every=1, checkpoint_dir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000001.npz", "ckpt_00000001.npz.json"]
    vlm = registry.get_config("llava-next-34b").reduced(d_model=64)
    base = build_model(vlm).init(torch.Generator().manual_seed(0), "cpu")
    res = [run_federated(vlm, fed, pub, clients, test, device="cpu",
                         base=b) for b in
           (base, {k: v for k, v in base.items() if k != "img_proj"})]
    assert "img_proj" in base and math.isfinite(res[0].history[0].loss)
    assert res[0].history[0].loss == res[1].history[0].loss
    for x, y in zip(tree_lib.leaves(res[0].final_lora),
                    tree_lib.leaves(res[1].final_lora)):
        assert torch.equal(x, y)
    audio = registry.get_config("whisper-base").reduced(d_model=64)
    with pytest.raises(KeyError, match="enc_embeds"):
        run_federated(audio, fed, pub, clients, test, device="cpu")


def test_lora_dropout_runs_on_own_generator(tiny_case):
    """Dropout > 0 is implemented (masks from torch generators), not
    ignored: it changes the trained LoRA, deterministically."""
    cfg, pub, clients, test = tiny_case

    def final_a(dropout):
        res = run_federated(cfg, FedConfig(rounds=1, lora_rank=2,
                                           lora_dropout=dropout), pub,
                            clients, test, device="cpu")
        return res.final_lora["layers"][0]["attn"]["wq"]["a"].numpy()

    with_dropout = final_a(0.5)
    np.testing.assert_array_equal(with_dropout, final_a(0.5))
    assert not np.allclose(with_dropout, final_a(0.0))


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and by the csrc headers it
    includes: an edited header gives every including source a new path
    (a stale library is never loaded), an unrelated file none."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n'
                                   '#include "shared.cuh"\nint f();\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert build.library_path("k") == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    assert build.library_path("k") != first
    assert build.library_path("k").name.startswith("libk-")
