"""The port's examples (examples/torch/*.py) run on the CPU at tiny size:
each one's ``main`` with ``--device cpu``, its data, rounds and models
shrunk through the names the example imports (the case study at scale
0.02 and one round on a two-layer GPT-2-tiny of width 64,
serve_decode's families at d_model 64), its printout checked for the
lines the reference's example prints."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_model(mod, monkeypatch):
    """The example's GPT-2-tiny at two layers and width 64."""
    tiny = mod.gpt2_tiny
    monkeypatch.setattr(mod, "gpt2_tiny", lambda *a, **kw: dataclasses.replace(
        tiny(*a, **kw), n_layers=2, d_model=64, d_ff=256))


def _tiny(mod, monkeypatch, rounds=1):
    """The case study at scale 0.02, at most ``rounds`` rounds, on
    ``_small_model``."""
    _small_model(mod, monkeypatch)
    splits, fed = mod.banking77.paper_splits, mod.FedConfig
    monkeypatch.setattr(mod.banking77, "paper_splits",
                        lambda *a, **kw: splits(*a, **dict(kw, scale=0.02)))
    monkeypatch.setattr(mod, "FedConfig", lambda **kw: fed(
        **dict(kw, rounds=min(kw.get("rounds", 1), rounds))))


@pytest.mark.parametrize("name, argv, expect", [
    ("quickstart", [], ("fedllm  acc=", "kd      acc=", "split   acc=")),
    ("fedllm_banking77", ["--rounds", "1", "--scale", "0.02"],
     ("rank=2:", "rank=4:", "rank=8:")),
    ("kd_fedllm_compressed", [], ("dense-logit KD:", "top-8 KD:",
                                  "aligned-PD KD:")),
    ("split_fedllm_quantized", [], ("split at layer", "fp32 wire:",
                                    "int8 wire:")),
    ("million_client_cohorts", ["--n-virtual", "8", "--cohort-size", "4",
                                "--lazy-demo-virtual", "1000"],
     ("population: 1,000 virtual clients", "final accuracy:")),
])
def test_case_study_examples(name, argv, expect, monkeypatch, capsys):
    mod = _load(name)
    if name != "million_client_cohorts":
        _tiny(mod, monkeypatch)
    else:
        _small_model(mod, monkeypatch)
    mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for line in expect:
        assert line in out, (line, out)


def test_dp_example(monkeypatch, capsys):
    """Five noise levels, each run's epsilon pinned to the accountant
    inside the example."""
    mod = _load("dp_fedllm")
    _small_model(mod, monkeypatch)
    mod.main(["--rounds", "1", "--scale", "0.02", "--device", "cpu"])
    out = capsys.readouterr().out
    rows = [line.split() for line in out.splitlines()
            if line.strip()[:3] in ("0.0", "0.3", "0.6", "1.2", "2.4")]
    assert [r[0] for r in rows] == ["0.0", "0.3", "0.6", "1.2", "2.4"]
    assert rows[0][1] == "inf"


def test_serve_example(monkeypatch, capsys):
    mod = _load("serve_decode")
    get = mod.get_config
    monkeypatch.setattr(mod, "get_config",
                        lambda arch: get(arch).reduced(d_model=64))
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for arch in ("qwen3-1.7b", "rwkv6-1.6b", "recurrentgemma-2b"):
        assert f"{arch}" in out and "4x24 tokens" in out


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load("serve_decode").main([])
