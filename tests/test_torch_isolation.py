"""The port stands alone: no module of ``hifigan_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, orbax, yaml or the JAX package, and
the entry points (the generator, the vocoder, the train state, ``cli
train``, ``cli train-encoders``, ``cli train-clone``, ``cli
train-unit-vocoder``, ``cli train-s2st``, ``cli info``, the S2ST model, the
unit vocoder, the S2ST runtime, ``cli simulate``, ``cli eval``, ``cli
eval-clone`` and the CTC judge) run on the card unless the caller asks for
the CPU (``cli eval-s2st``, ``cli serve``, the app's vocoder route, engine
and server, the waveform encoders, ``dryrun_multichip``, ``cli bench`` and
its configs' functions too)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
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


def test_beam_search_is_host_numpy():
    """The port's own copy of the beam searches imports numpy and the
    standard library only."""
    path = ROOT / "hifigan_tpu_torch" / "streaming" / "beam.py"
    assert path in SOURCES
    assert set(_imported_modules(path)) == {"__future__", "dataclasses", "typing", "numpy"}


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
    for command in ("train-encoders", "train-clone", "train-unit-vocoder", "train-s2st"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command, "--tiny", "--max_steps", "1", "--checkpoint_dir", str(tmp_path / command)])
        assert not (tmp_path / command).exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["info"])


def test_entry_on_cpu_runs_the_flagship():
    model, (mel, spk, emo) = hifigan_tpu_torch.entry(device="cpu")
    assert model.config == hifigan_tpu_torch.GeneratorConfig()
    with torch.no_grad():
        wav = model(mel, spk, emo)
    assert wav.shape == (2, 1, 64 * 256)
    assert bool(torch.isfinite(wav).all()) and float(wav.abs().max()) <= 1.0


def test_eval_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    """``cli eval``, ``cli eval-clone``, ``cli eval-s2st``, the CTC judge
    and the HF transcriber raise before they read or write a file; the
    judge gate records the error of a candidate it cannot load."""
    from hifigan_tpu_torch.eval import asr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["eval", "--tiny", "--checkpoint_dir", str(tmp_path / "ckpt")],
                 ["eval-clone", "--tiny", "--checkpoint_dir", str(tmp_path / "ckpt"),
                  "--encoders", str(tmp_path / "enc.pt")],
                 ["eval-s2st", "--checkpoint", str(tmp_path / "s2st.pt"), "--output", str(tmp_path / "r.json")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert not (tmp_path / "ckpt").exists() and not (tmp_path / "r.json").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asr.CTCTranscriber(str(tmp_path / "judge.pt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asr.HFTranscriber()
    (tmp_path / "judge.pt").write_bytes(b"")
    judge, gate = asr.load_competent_ctc([str(tmp_path / "judge.pt")], [], [])
    assert judge is None and "no CUDA device" in gate["candidates"][0]["error"]


def test_serving_without_a_card_raises(monkeypatch, tmp_path):
    """``cli serve`` raises before it binds a port or builds an engine;
    ``make_vocoder_synth``, the engine, the server and the waveform encoders
    default to the card; the source scan covers the app."""
    import socketserver

    from hifigan_tpu_torch.app import engine, server
    from hifigan_tpu_torch.models import waveform_encoders

    assert {"engine.py", "server.py", "models.py", "audio.py", "config.py", "offline.py", "desktop.py"} <= {
        p.name for p in SOURCES if p.parent.name == "app"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_bind(*args, **kwargs):
        raise AssertionError("a port was bound")

    monkeypatch.setattr(socketserver.TCPServer, "server_bind", no_bind)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--port", "8765"])
    (tmp_path / "1.pt").write_bytes(b"")
    for build in (lambda: engine.make_vocoder_synth(str(tmp_path)),
                  lambda: engine.RealTimeTranslationEngine(load_models=False),
                  lambda: server.StdlibServer(load_models=False),
                  lambda: waveform_encoders.SpeakerEncoder(),
                  lambda: waveform_encoders.Wav2Vec2Emotion(),
                  lambda: waveform_encoders.extract_mel_features(np.zeros(1024, np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_dryrun_multichip_without_a_card_raises(monkeypatch):
    """``dryrun_multichip(1)`` needs a card; asking for more CUDA ranks than
    cards raises too (NCCL places one rank on a card), before any process
    starts."""
    from hifigan_tpu_torch.entry import dryrun_multichip
    from hifigan_tpu_torch.parallel import spawn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL places one rank on a card"):
        spawn(print, 2, "cuda")


def test_bench_without_a_card_exits_3(monkeypatch, capsys):
    """``cli bench`` (``--device cuda`` by default) exits 3 with the contract
    line's ``value`` null and runs no config; each config's function raises;
    the source scan covers ``bench.py`` and ``utils/benchit.py``."""
    from hifigan_tpu_torch import bench

    package = ROOT / "hifigan_tpu_torch"
    assert {package / "bench.py", package / "utils" / "benchit.py"} <= set(SOURCES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        cli.main(["bench"])
    assert exit_.value.code == 3 and json.loads(capsys.readouterr().out)["value"] is None
    for fn in (bench.bench_flagship, bench.bench_hifigan_v1, bench.bench_conditioned, bench.bench_train_step,
               bench.bench_train_step_fused, bench.bench_train_step_production):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
