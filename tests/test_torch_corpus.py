"""The port's formant corpus against the JAX package's, bit for bit: every
clip, phone plan, arousal, crop and evaluation WAV downstream comes from
it, so nothing less than equality will do."""

from dataclasses import astuple

import numpy as np
import pytest

from hifigan_tpu.train import corpus as jcorpus
from hifigan_tpu_torch.train import corpus as tcorpus

# (speaker, idx, keyword arguments): the evaluation clips' keys, a legacy
# training key, a forced arousal and the cloning grid's parallel content
CASES = [(0, 10_000, {}), (5, 10_005, {}), (3, 7, {}), (9, 2, {"arousal": 0.9}),
         (2, 0, {"content": 50_500_000}), (7, 0, {"content": 60_507_031, "arousal": 0.35})]


@pytest.mark.parametrize("speaker, idx, kwargs", CASES, ids=[f"{s}-{i}-{sorted(k)}" for s, i, k in CASES])
def test_utterance_is_bit_identical(speaker, idx, kwargs):
    want_audio, want_plan, want_ar = jcorpus.FormantSpeechCorpus(n_speakers=8).utterance(
        speaker, idx, return_plan=True, **kwargs)
    got_audio, got_plan, got_ar = tcorpus.FormantSpeechCorpus(n_speakers=8).utterance(
        speaker, idx, return_plan=True, **kwargs)
    assert got_audio.dtype == want_audio.dtype == np.float32
    np.testing.assert_array_equal(got_audio, want_audio)
    assert got_plan == want_plan and got_ar == want_ar
    np.testing.assert_array_equal(tcorpus.plan_phone_ids(got_plan), jcorpus.plan_phone_ids(want_plan))
    plain = tcorpus.FormantSpeechCorpus(n_speakers=8).utterance(speaker, idx, **kwargs)
    np.testing.assert_array_equal(plain, want_audio)


def test_tables_profiles_and_arousal_equal():
    assert tcorpus.PHONES == jcorpus.PHONES and tcorpus.PHONE_TO_ID == jcorpus.PHONE_TO_ID
    assert tcorpus.SAMPLE_RATE == jcorpus.SAMPLE_RATE
    for s in range(40):
        assert astuple(tcorpus.SpeakerProfile.from_id(s)) == astuple(jcorpus.SpeakerProfile.from_id(s))
    for key in (0, 10_000, 50_500_003):
        assert (tcorpus.FormantSpeechCorpus().content_arousal(key)
                == jcorpus.FormantSpeechCorpus().content_arousal(key))


def test_render_plan_is_bit_identical():
    plan = [("pau", 0.05), ("k", 0.06), ("a", 0.12), ("s", 0.08), ("m", 0.07), ("i", 0.1), ("pau", 0.08)]
    for speaker, seed in ((1, 0), (12, 3)):
        np.testing.assert_array_equal(tcorpus.FormantSpeechCorpus().render_plan(speaker, plan, seed=seed),
                                      jcorpus.FormantSpeechCorpus().render_plan(speaker, plan, seed=seed))


def test_dataset_crops_equal():
    """Crops of a 6-utterance dataset (one cache slot fewer than
    utterances, so the cache evicts), 8192 samples, seed 3: each row, and
    a segment longer than an utterance (padded)."""
    kw = dict(segment_samples=8192, size=6, n_speakers=4, seed=3, cache_utterances=5)
    got, want = tcorpus.FormantSpeechDataset(**kw), jcorpus.FormantSpeechDataset(**kw)
    assert len(got) == len(want) == 6
    for i in (0, 1, 5, 7, 2, 0):
        np.testing.assert_array_equal(got[i], want[i])
    long_kw = {**kw, "segment_samples": 70_000}
    np.testing.assert_array_equal(tcorpus.FormantSpeechDataset(**long_kw)[1],
                                  jcorpus.FormantSpeechDataset(**long_kw)[1])


def test_write_eval_clips_writes_the_same_files(tmp_path):
    got = tcorpus.write_eval_clips(str(tmp_path / "port"), n_clips=3, n_speakers=8)
    want = jcorpus.write_eval_clips(str(tmp_path / "jax"), n_clips=3, n_speakers=8)
    assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want] == [
        "eval_000.wav", "eval_001.wav", "eval_002.wav"]
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()
