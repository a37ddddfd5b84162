"""``cli eval`` and ``cli eval-clone`` of the port on the CPU at tiny
widths: they run, and their reports have JAX's keys.  ``cli eval --tiny``
runs beside JAX's on the same held-out clip and the same tiny CTC judge
(written by ``test_torch_eval.write_tiny_judge``): the judge's gate report
and the reference WAVs are the same."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_eval import write_tiny_judge

from hifigan_tpu_torch import cli
from hifigan_tpu_torch.ops.stft import MelConfig
from hifigan_tpu_torch.streaming.features import read_wav
from hifigan_tpu_torch.train import create_train_state
from hifigan_tpu_torch.train.checkpoint import CheckpointManager
from hifigan_tpu_torch.train.encoder_pretrain import EncoderTrainConfig, build_models
from hifigan_tpu_torch.weights import save_encoder_checkpoint

# hifigan_tpu/cli.py cmd_eval_clone's report: evaluate_cloning_transfer's
# keys without "pairs" (unless --full_pairs), and four of its own
EVAL_CLONE_KEYS = {"n_transfer_pairs", "transfer_verified_rate", "transfer_closer_to_target_rate",
                   "transfer_sim_target_mean", "transfer_sim_source_mean", "mel_l1_to_target_rendition_mean",
                   "mel_l1_to_source_rendition_mean", "ablation", "encoder_separation", "checkpoint_dir",
                   "restored_step", "encoder_step"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(tree):
    """The nested key structure of a JSON report."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return None


def test_cli_eval_tiny_matches_jax_report(tmp_path):
    """``eval --tiny --samples 1 --save_wavs`` with the tiny judge as
    ``--asr``, the port on the CPU (also ``--compare_random``) and JAX: the
    same nested keys; the same gate report (the judge fails the gate, so
    ASR-BLEU is SKIPPED in both) apart from the candidate's path; the same
    reference WAV; synthesis WAVs of one length; finite metrics."""
    from hifigan_tpu import cli as jcli

    jdir, tfile = write_tiny_judge(tmp_path)
    args = ["eval", "--tiny", "--samples", "1"]
    cli.main([*args, "--device", "cpu", "--asr", tfile, "--output", str(tmp_path / "t.json"),
              "--save_wavs", str(tmp_path / "t_wavs"), "--compare_random"])
    # JAX's --compare_random is left out (it compiles a second generator, 20 s):
    # its key holds the same metric names as the statistics
    jcli.main([*args, "--asr", jdir, "--output", str(tmp_path / "j.json"), "--save_wavs", str(tmp_path / "j_wavs")])
    got, want = (json.loads((tmp_path / f"{s}.json").read_text()) for s in "tj")
    assert set(got.pop("random_init_control")) == set(got["statistics"])
    assert _keys(got) == _keys(want)
    gate, jgate = got["asr_judge_gate"], want["asr_judge_gate"]
    assert gate["candidates"][0]["dir"] == tfile and jgate["candidates"][0]["dir"] == jdir
    assert {**gate, "candidates": [{**c, "dir": None} for c in gate["candidates"]]} == {
        **jgate, "candidates": [{**c, "dir": None} for c in jgate["candidates"]]}
    assert got["benchmarks"]["asr_bleu"]["status"] == want["benchmarks"]["asr_bleu"]["status"] == "SKIPPED"
    assert (got["sim_encoders"], got["restored_step"], got["checkpoint_dir"]) == (
        want["sim_encoders"], want["restored_step"], want["checkpoint_dir"])
    assert all(np.isfinite(v) for v in got["raw_results"][0].values())
    assert sorted(p.name for p in (tmp_path / "t_wavs").iterdir()) == ["ref_00.wav", "synth_00.wav"]
    assert (tmp_path / "t_wavs" / "ref_00.wav").read_bytes() == (tmp_path / "j_wavs" / "ref_00.wav").read_bytes()
    synth, _ = read_wav(str(tmp_path / "t_wavs" / "synth_00.wav"))
    jsynth, _ = read_wav(str(tmp_path / "j_wavs" / "synth_00.wav"))
    assert len(synth) == len(jsynth) > 0


def test_cli_eval_tiny_synthetic(tmp_path, capsys):
    """``eval --tiny --dataset synthetic --samples 2``: no judge gate in
    the report (JAX's rule), two samples, the summary line printed."""
    cli.main(["eval", "--tiny", "--device", "cpu", "--dataset", "synthetic", "--samples", "2",
              "--segment_samples", "2048", "--output", str(tmp_path / "r.json")])
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["num_samples"] == 2 and "asr_judge_gate" not in report
    assert set(report) == {"num_samples", "raw_results", "statistics", "benchmarks", "dataset", "checkpoint_dir",
                           "restored_step", "sim_encoders"}
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["asr_bleu"] == "SKIPPED" and set(summary["stats"]) == set(report["statistics"])


def test_cli_eval_clone_tiny(tmp_path):
    """``eval-clone --tiny`` over a tiny train-state file and a tiny encoder
    file, 2 speakers × 1 content: JAX's report keys, 2 transfer pairs, the
    steps of both files; ``--full_pairs`` keeps the pairs; no train-state
    file raises."""
    cfg = cli._eval_config(tiny=True)
    state = create_train_state(cfg, torch.float32, "cpu", seed=1)
    state.step = 12
    CheckpointManager(str(tmp_path / "ckpt")).save(state, force=True)
    ecfg = EncoderTrainConfig(ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4,
                              mel=MelConfig(n_fft=32, hop_length=8, win_length=32, n_mels=16))
    save_encoder_checkpoint(str(tmp_path / "enc.pt"), ecfg, *build_models(ecfg, gen=torch.Generator().manual_seed(3)),
                            step=40)
    args = ["eval-clone", "--tiny", "--device", "cpu", "--checkpoint_dir", str(tmp_path / "ckpt"), "--encoders",
            str(tmp_path / "enc.pt"), "--n_speakers", "2", "--n_contents", "1"]
    cli.main([*args, "--output", str(tmp_path / "r.json"), "--full_pairs"])
    report = json.loads((tmp_path / "r.json").read_text())
    assert set(report) == EVAL_CLONE_KEYS | {"pairs"}
    assert report["n_transfer_pairs"] == len(report["pairs"]) == 2
    assert (report["restored_step"], report["encoder_step"]) == (12, 40)
    assert set(report["ablation"]) == {"correct_ref_sim_to_own", "zero_ref_sim_to_own", "wrong_ref_sim_to_own"}
    assert all(np.isfinite(v) for v in report["ablation"].values())
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        cli.main(["eval-clone", "--tiny", "--device", "cpu", "--checkpoint_dir", str(tmp_path / "empty"),
                  "--encoders", str(tmp_path / "enc.pt")])
    assert not Path(tmp_path / "empty").exists() or not any(Path(tmp_path / "empty").iterdir())
