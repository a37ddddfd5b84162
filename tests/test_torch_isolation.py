"""The port stands alone: no module of ``hifigan_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, orbax, yaml or the JAX package, and
the entry points (the generator, the vocoder, the train state, ``cli
train``, the S2ST model, the unit vocoder, the S2ST runtime and ``cli
simulate``) run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import hifigan_tpu_torch
from hifigan_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "yaml", "hifigan_tpu"}
SOURCES = sorted((ROOT / "hifigan_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, hifigan_tpu_torch, hifigan_tpu_torch.ops.cuda.build; "
            "print(sorted(m for m in ('jax', 'flax', 'orbax', 'yaml', 'hifigan_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_entry_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hifigan_tpu_torch.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hifigan_tpu_torch.build_generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hifigan_tpu_torch.create_train_state()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--tiny", "--max_steps", "1", "--checkpoint_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()
    for build in (hifigan_tpu_torch.build_s2st, hifigan_tpu_torch.build_code_vocoder,
                  hifigan_tpu_torch.build_s2st_inference):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["simulate", "--tiny"])


def test_entry_on_cpu_runs_the_flagship():
    model, (mel, spk, emo) = hifigan_tpu_torch.entry(device="cpu")
    assert model.config == hifigan_tpu_torch.GeneratorConfig()
    with torch.no_grad():
        wav = model(mel, spk, emo)
    assert wav.shape == (2, 1, 64 * 256)
    assert bool(torch.isfinite(wav).all()) and float(wav.abs().max()) <= 1.0
