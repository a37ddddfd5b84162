"""The port's training loop around the train step, on the CPU at the
``--tiny`` config: ``multi_steps`` against sequential steps, the on-device
sampler's crops, the eval step against JAX's, the ``CheckpointManager``
(round trip, retention, save cadence, duplicate saves) and ``cli train``
with ``--resume``."""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch
from test_torch_train_step import TINY_MEL, _configs, _jax_state

from hifigan_tpu.models import vocoder as jvoc
from hifigan_tpu.train.train_step import make_eval_step as jax_make_eval_step
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from hifigan_tpu_torch.train.checkpoint import CheckpointManager
from hifigan_tpu_torch.train.device_data import build_audio_bank, make_device_sampler
from hifigan_tpu_torch.weights import load_jax_train_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small ops pay for
    thread synchronisation, ten times over when test workers share the
    cores (the checkpoint test on an 8-core CPU beside six busy processes:
    112 s at 8 threads, 10 s at 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_state(seed=1):
    return create_train_state(_configs()[1], device="cpu", seed=seed)


def _audio(seed, *shape):
    return (0.4 * np.tanh(np.random.default_rng(seed).standard_normal(shape))).astype(np.float32)


def _params(state):
    return {f"{m}.{n}": p.detach().clone() for m in ("vocoder", "discriminators")
            for n, p in getattr(state, m).named_parameters()}


def test_multi_steps_equals_sequential_steps():
    """``multi_steps=2`` on a stacked batch leaves the same parameters,
    optimiser counts and step as two single steps (equal to 1e-6), and
    returns the two steps' mean metrics."""
    cfg = _configs()[1]
    audio = _audio(3, 2, 2, 128)
    fused, single = _tiny_state(), _tiny_state()
    _, m2 = make_train_step(cfg, multi_steps=2)(fused, {"audio": audio})
    step = make_train_step(cfg)
    ms = [step(single, {"audio": audio[i]})[1] for i in range(2)]
    assert fused.step == single.step == 2 and fused.gen_opt.count == single.gen_opt.count == 2
    want, got = _params(single), _params(fused)
    for name, p in got.items():
        torch.testing.assert_close(p, want[name], rtol=1e-6, atol=1e-6, msg=name)
    for k, v in m2.items():
        torch.testing.assert_close(v, (ms[0][k] + ms[1][k]) / 2, rtol=1e-6, atol=1e-6)


def test_sampled_multi_steps_equals_sequential_draws():
    """With ``sample_fn`` the step takes a seed: ``multi_steps=2`` from seed
    5 draws and trains as two single steps given one generator of seed 5."""
    cfg = _configs()[1]
    bank = torch.from_numpy(_audio(4, 6, 300))
    sample = make_device_sampler(bank, torch.full((6,), 300), 128, 2)
    fused, single = _tiny_state(), _tiny_state()
    make_train_step(cfg, multi_steps=2, sample_fn=sample)(fused, 5)
    step, gen = make_train_step(cfg, sample_fn=sample), torch.Generator().manual_seed(5)
    for _ in range(2):
        step(single, gen)
    want = _params(single)
    for name, p in _params(fused).items():
        torch.testing.assert_close(p, want[name], rtol=1e-6, atol=1e-6, msg=name)


def test_remat_step_equals_plain_step():
    """``remat=True`` (the generator's forward recomputed in its backward by
    ``torch.utils.checkpoint``) trains as the plain step: the same losses
    and parameters to 1e-6."""
    cfg = _configs()[1]
    batch = {"audio": _audio(7, 2, 128)}
    remat, plain = _tiny_state(), _tiny_state()
    _, m_remat = make_train_step(cfg, remat=True)(remat, batch)
    _, m_plain = make_train_step(cfg)(plain, batch)
    for k in m_plain:
        torch.testing.assert_close(m_remat[k], m_plain[k], rtol=1e-6, atol=1e-6)
    want = _params(plain)
    for name, p in _params(remat).items():
        torch.testing.assert_close(p, want[name], rtol=1e-6, atol=1e-6, msg=name)


def test_precomputed_embeddings_bypass_the_extractor():
    """With ``precompute_embeddings`` the batch carries the speaker and
    emotion embeddings: the extractor takes no gradient and does not move,
    the generator does, and other embeddings give another loss."""
    cfg = replace(_configs()[1], precompute_embeddings=True)
    state = _tiny_state()
    before = _params(state)
    g = np.random.default_rng(8)
    batch = {"audio": _audio(9, 2, 128), "speaker": g.standard_normal((2, 192)).astype(np.float32),
             "emotion": g.standard_normal((2, 256)).astype(np.float32)}
    _, metrics = make_train_step(cfg)(state, batch)
    for name, p in state.vocoder.named_parameters():
        moved = not torch.equal(p.detach(), before[f"vocoder.{name}"])
        if name.startswith("embedding_extractor."):
            assert p.grad is None and not moved, name
        else:
            assert p.grad is not None, name
    other = make_train_step(cfg)(_tiny_state(), {**batch, "speaker": -batch["speaker"]})[1]
    assert float(other["generator_loss"]) != float(metrics["generator_loss"])


class _Utterances:
    """Utterance i holds ``1000·i + t`` at sample t, so a crop names its
    utterance and offset; lengths range over both sides of the crop."""

    lengths = (50, 130, 128, 400, 1000, 77)

    def __len__(self):
        return len(self.lengths)

    def _utterance(self, i):
        return 1000.0 * i + np.arange(self.lengths[i], dtype=np.float32)


def test_device_sampler_crops_stay_within_each_utterance():
    """``build_audio_bank`` pads the rows to a multiple of 128 with zeros;
    every crop of 128 samples is a contiguous run of one utterance that
    ends within its true length, or starts at 0 (then zeros follow) where
    the utterance is shorter than the crop; every utterance is drawn."""
    ds = _Utterances()
    bank, lengths = build_audio_bank(ds)
    assert bank.shape == (6, 1024) and lengths.tolist() == list(ds.lengths)
    assert not bank[0, 50:].any() and bank[4, 999] == 4999
    seg = 128
    sample = make_device_sampler(torch.from_numpy(bank), torch.from_numpy(lengths), seg, 16)
    gen, seen = torch.Generator().manual_seed(0), set()
    for _ in range(40):
        crops = sample(gen).numpy()
        assert crops.shape == (16, seg)
        for c in crops:
            utt, off = int(c[0] // 1000), int(c[0] % 1000)
            n = ds.lengths[utt]
            seen.add(utt)
            if n <= seg:
                assert off == 0
                np.testing.assert_array_equal(c, np.pad(ds._utterance(utt), (0, seg - n)))
            else:
                assert off + seg <= n
                np.testing.assert_array_equal(c, ds._utterance(utt)[off: off + seg])
    assert seen == set(range(6))
    with pytest.raises(ValueError, match="shorter than a crop"):
        make_device_sampler(torch.from_numpy(bank), torch.from_numpy(lengths), 2048, 2)


def test_eval_step_matches_jax():
    """``make_eval_step`` at the tiny config on JAX's parameters: the
    waveform within 1e-5 and the mel L1 within 1e-5 relative."""
    jcfg, tcfg = _configs()
    jax_state = _jax_state(jcfg, seed=5, batch=2, frames=256 // TINY_MEL["hop_length"])
    audio = _audio(6, 2, 256)
    vocoder = jvoc.ModifiedVocoder(jcfg.generator, ecapa_channels=jcfg.ecapa_channels, emo_hidden=jcfg.emo_hidden,
                                   emo_layers=jcfg.emo_layers, emo_heads=jcfg.emo_heads)
    want = jax_make_eval_step(vocoder, jcfg)(jax_state.gen_params, {"audio": audio})
    state = load_jax_train_state(create_train_state(tcfg, device="cpu"), jax_state)
    got = make_eval_step(tcfg)(state.vocoder, {"audio": audio})
    assert got["waveform"].shape == (2, 1, 256) and not got["waveform"].requires_grad
    np.testing.assert_allclose(got["waveform"].numpy(), np.asarray(want["waveform"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got["mel_l1"]), float(want["mel_l1"]), rtol=1e-5)


def test_checkpoint_round_trip_retention_and_duplicates(tmp_path):
    """A restored state equals the saved one (parameters, both optimisers'
    moments and counts, step) and trains on identically; only multiples of
    ``save_interval`` are saved unless forced; a second save of a step (or
    an older one) writes nothing; the newest ``max_to_keep`` remain."""
    cfg = _configs()[1]
    step = make_train_step(cfg)
    state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tiny_state())
    saved = {}
    for i in range(5):
        step(state, {"audio": _audio(10 + i, 2, 128)})
        saved[state.step] = mgr.save(state, metadata={"step": state.step})
    assert saved == {1: False, 2: True, 3: False, 4: True, 5: False}
    assert mgr.save(state, metadata={"step": 5}, force=True) and not mgr.save(state, force=True)
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert json.loads((tmp_path / "meta_5.json").read_text()) == {"step": 5}

    restored = mgr.restore(_tiny_state(seed=9))
    assert restored.step == 5 and restored.gen_opt.count == restored.disc_opt.count == 5
    want = _params(state)
    for name, p in _params(restored).items():
        assert torch.equal(p, want[name]), name
    for a, b in ((state.gen_opt, restored.gen_opt), (state.disc_opt, restored.disc_opt)):
        for p, q in zip(a.params, b.params):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(a.adam.state[p][key], b.adam.state[q][key])
    batch = {"audio": _audio(20, 2, 128)}
    m1, m2 = step(state, batch)[1], step(restored, batch)[1]
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert mgr.restore(_tiny_state(), step=4).step == 4
    mgr.wait()
    mgr.close()


def test_cli_train_writes_metrics_and_checkpoints_and_resumes(tmp_path):
    """``cli train --tiny --device cpu --max_steps 2`` logs 2 metric rows and
    saves step 2; ``--resume --max_steps 3`` continues from it to step 3."""
    common = ["train", "--tiny", "--device", "cpu", "--batch_size", "2", "--log_every", "1",
              "--checkpoint_dir", str(tmp_path)]
    cli.main(common + ["--max_steps", "2"])
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in rows for k in ("generator_loss", "discriminator_loss", "mel_loss"))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    cli.main(common + ["--max_steps", "3", "--resume", "--device_data"])
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    summary = json.loads((tmp_path / "training_summary.json").read_text())
    assert summary["steps"] == 3 and summary["device"] == "cpu"
    state = CheckpointManager(str(tmp_path)).restore(create_train_state(_configs()[1], device="cpu"))
    assert state.step == 3 and state.gen_opt.count == 3
