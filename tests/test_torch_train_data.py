"""``cli train``'s data sources, the port against the JAX package on the
CPU: ``augment`` and ``WavDirectoryDataset``'s crops bit for bit on written
wav files (16 kHz and resampled, with and without augmentation, from the
same seeds); ``cli train --dataset formant`` (with ``--device_data``) and
``--data_dir --augment`` at the ``--tiny`` config; a JSON ``--config`` with
the ``training:`` block of ``configs/train_config.yaml`` set up as JAX's
``cli train`` sets it up from the YAML, and the error that names the JSON
form where ``yaml`` is missing."""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from hifigan_tpu.train import data as jdata
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.eval.asr_bleu import write_wav
from hifigan_tpu_torch.train import data as tdata

ROOT = Path(__file__).resolve().parents[1]
YAML_CONFIG = ROOT / "configs" / "train_config.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tone(n, f0, seed):
    t = np.arange(n) / 16_000
    noise = np.random.default_rng(seed).normal(0, 0.01, n)
    return (0.4 * np.sin(2 * np.pi * f0 * t) + noise).astype(np.float32)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Five wav files in two directories: 16 kHz clips longer and shorter
    than a crop, and one at 22.05 kHz (resampled on read)."""
    root = tmp_path_factory.mktemp("wavs")
    (root / "sub").mkdir()
    write_wav(str(root / "b.wav"), _tone(9000, 140, 1))
    write_wav(str(root / "a.wav"), _tone(3000, 220, 2))
    write_wav(str(root / "sub" / "c.wav"), _tone(20000, 90, 3))
    write_wav(str(root / "sub" / "d.wav"), _tone(12000, 300, 4), sample_rate=22_050)
    write_wav(str(root / "sub" / "e.WAV"), _tone(4096, 180, 5))
    return root


@pytest.mark.parametrize("cfg", [dict(), dict(probability=1.0), dict(probability=1.0, noise_std=0.0)],
                         ids=["defaults", "always", "no_noise"])
def test_augment_is_jax_bit_for_bit(cfg):
    """The same audio and the same ``random.Random`` seeds: equal outputs
    (dtype and every bit) and the rng left in the same state."""
    audio = _tone(8192, 150, 0)
    for seed in range(8):
        jr, tr = random.Random(seed), random.Random(seed)
        want = jdata.augment(audio, jdata.AugmentConfig(**cfg), jr)
        got = tdata.augment(audio, tdata.AugmentConfig(**cfg), tr)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), seed
        assert jr.random() == tr.random()


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_wav_directory_crops_are_jax_bit_for_bit(wav_dir, augment):
    """``WavDirectoryDataset`` over the same files: the same file order and,
    item by item over two passes, the same crops bit for bit (reading,
    resampling, augmentation, padding and the crop offset)."""
    kw = dict(segment_samples=4096, seed=3)
    want_ds = jdata.WavDirectoryDataset(str(wav_dir), augment_cfg=jdata.AugmentConfig() if augment else None, **kw)
    got_ds = tdata.WavDirectoryDataset(str(wav_dir), augment_cfg=tdata.AugmentConfig() if augment else None, **kw)
    assert got_ds.files == want_ds.files and len(got_ds) == 5
    for i in list(range(len(got_ds))) * 2:
        got, want = got_ds[i], want_ds[i]
        assert got.shape == (4096,) and got.dtype == np.float32 and np.array_equal(got, want), i


def test_wav_directory_without_wavs_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .wav files"):
        tdata.WavDirectoryDataset(str(tmp_path))


def _summary_and_rows(directory):
    summary = json.loads((directory / "training_summary.json").read_text())
    rows = [json.loads(line) for line in (directory / "metrics.jsonl").read_text().splitlines()]
    return summary, rows


@pytest.mark.parametrize("source", ["formant", "formant_device_data", "data_dir_augment"])
def test_cli_train_data_sources(tmp_path, wav_dir, source):
    """``cli train --tiny --device cpu`` for 2 steps on the formant corpus
    (host loader and ``--device_data``) and on the wav directory with
    ``--augment``: finite losses each step, and the summary's ``data``
    names the source."""
    args = ["train", "--tiny", "--device", "cpu", "--max_steps", "2", "--log_every", "1", "--batch_size", "2",
            "--checkpoint_dir", str(tmp_path / "run")]
    if source.startswith("formant"):
        args += ["--dataset", "formant", "--dataset_size", "4"]
        if source == "formant_device_data":
            args.append("--device_data")
    else:
        args += ["--data_dir", str(wav_dir), "--augment"]
    cli.main(args)
    summary, rows = _summary_and_rows(tmp_path / "run")
    assert summary["data"] == (str(wav_dir) if source == "data_dir_augment" else "formant")
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in rows for k in ("generator_loss", "discriminator_loss", "mel_loss"))


def _jax_train_settings(monkeypatch, argv):
    """``(TrainConfig, batch size, segment)`` as JAX's ``cli train`` sets
    them up, caught at its ``create_train_state`` call."""
    import hifigan_tpu.train as jtrain
    from hifigan_tpu import cli as jcli

    seen = {}

    class Caught(Exception):
        pass

    def catch(rng, cfg, *, mel_frames, batch_size, dtype):
        seen.update(cfg=cfg, batch_size=batch_size, segment=mel_frames * cfg.mel.hop_length)
        raise Caught

    monkeypatch.setattr(jtrain, "create_train_state", catch)
    with pytest.raises(Caught):
        jcli.main(["--cpu", *argv])
    return seen["cfg"], seen["batch_size"], seen["segment"]


def test_json_config_sets_up_training_as_jax_yaml(tmp_path, monkeypatch):
    """``configs/train_config.yaml`` as a JSON file of the same keys: the
    port's learning rate, betas, warmup, batch size and segment equal what
    JAX's ``cli train --config train_config.yaml`` sets up (caught at its
    ``create_train_state``); the YAML read by the port (``yaml`` is
    installed here) gives the same."""
    raw = yaml.safe_load(YAML_CONFIG.read_text())
    path = tmp_path / "train_config.json"
    path.write_text(json.dumps(raw))
    flags = ["--batch_size", "3", "--segment_samples", "512", "--checkpoint_dir", str(tmp_path / "run")]
    jcfg, jbatch, jseg = _jax_train_settings(monkeypatch, ["train", "--config", str(YAML_CONFIG), *flags])
    for config in (path, YAML_CONFIG):
        cfg, batch, seg = cli._train_settings(cli.build_parser().parse_args(["train", "--config", str(config),
                                                                             *flags]))
        assert (batch, seg) == (jbatch, jseg) == (raw["training"]["batch_size"], raw["training"]["segment_samples"])
        for k in ("learning_rate", "beta1", "beta2", "warmup_steps", "decay_steps", "weight_decay", "grad_clip"):
            assert getattr(cfg, k) == getattr(jcfg, k), k
    assert cfg.learning_rate == raw["training"]["learning_rate"] and cfg.warmup_steps == 2000


def test_yaml_config_without_yaml_names_the_json_form(tmp_path, monkeypatch):
    """Where ``yaml`` cannot be imported (the card's machine), a ``.yaml``
    config raises SystemExit naming the JSON form, before any state is
    built."""
    real = cli.importlib.import_module

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real(name, *a, **kw)

    monkeypatch.setattr(cli.importlib, "import_module", no_yaml)
    with pytest.raises(SystemExit, match=r"write the same keys as a \.json file"):
        cli.main(["train", "--tiny", "--device", "cpu", "--config", str(YAML_CONFIG), "--max_steps", "1",
                  "--checkpoint_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()
