"""The port's evaluation path against the JAX package's on the CPU, fp32:
the metrics (BLEU in both branches, MCD, Average Lagging), the S2ST task's
token spaces and batched fbank, the encoder pre-training helpers, the CTC
judge and its competence gate on a tiny judge carried from JAX, the
``StreamEvaluator`` and its report on a tiny vocoder carried from JAX, and
the cloning transfer grid.  Each test states its tolerance; the worst
error is printed as a share of it (``pytest -s``)."""

import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import TINY, _gen, _randomise
from test_torch_s2st import TINY_SS, assert_within, jitter
from test_torch_vocoder import TINY_EXTRACTOR

from hifigan_tpu.eval import asr as jasr
from hifigan_tpu.eval import cloning_eval as jclone
from hifigan_tpu.eval import evaluator as jevaluator
from hifigan_tpu.eval import metrics as jmetrics
from hifigan_tpu.models import embeddings as jemb
from hifigan_tpu.models import generator as jgen
from hifigan_tpu.models import streamspeech as jss
from hifigan_tpu.models import vocoder as jvoc
from hifigan_tpu.ops import stft as jstft
from hifigan_tpu.train import encoder_pretrain as jenc
from hifigan_tpu.train import s2st_task as jtask
from hifigan_tpu.train import train_step as jtrain_step
from hifigan_tpu.train.corpus import FormantSpeechCorpus as JCorpus
from hifigan_tpu_torch.eval import asr as tasr
from hifigan_tpu_torch.eval import asr_bleu as tasr_bleu
from hifigan_tpu_torch.eval import cloning_eval as tclone
from hifigan_tpu_torch.eval import evaluator as tevaluator
from hifigan_tpu_torch.eval import metrics as tmetrics
from hifigan_tpu_torch.models import embeddings as temb
from hifigan_tpu_torch.models import generator as tgen
from hifigan_tpu_torch.models import streamspeech as tss
from hifigan_tpu_torch.models import vocoder as tvoc
from hifigan_tpu_torch.ops import stft as tstft
from hifigan_tpu_torch.train import audio_to_mel
from hifigan_tpu_torch.train import encoder_pretrain as tenc
from hifigan_tpu_torch.train import s2st_task as ttask
from hifigan_tpu_torch.train.corpus import PHONES, FormantSpeechCorpus, plan_phone_ids
from hifigan_tpu_torch.train.state import TrainConfig
from hifigan_tpu_torch.weights import (
    load_ctc_judge,
    load_encoder_checkpoint,
    load_jax_params,
    save_ctc_judge,
    save_encoder_checkpoint,
)

TINY_MEL = dict(n_fft=32, hop_length=8, win_length=32, n_mels=16)  # cli.py eval --tiny
JUDGE = {**TINY_SS, "vocab_size": 32}  # the phone tokens 3..25 fit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    """A flax param tree as a state dict: dotted names → numpy arrays."""
    return {".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]}


def _clips(n, length=None):
    """``cli eval``'s held-out formant clips and their phone transcripts."""
    corpus = FormantSpeechCorpus(n_speakers=8)
    clips, refs = [], []
    for i in range(n):
        wav, plan, _ = corpus.utterance(i % 8, 10_000 + i, return_plan=True)
        clips.append(wav if length is None else wav[:length])
        refs.append(" ".join(PHONES[p] for p in plan_phone_ids(plan) if p != 0))
    return clips, refs


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def test_cosine_similarity_and_verification_match_jax():
    """Rows of random vectors, a zero row (the product floor 1e-9) and a
    row of 1e-6 vectors (each norm under the floor alone: the product, not
    each norm, is floored), along both axes; 1e-6.  ``verify_speaker``'s
    decisions equal."""
    g = np.random.default_rng(0)
    a, b = g.standard_normal((5, 192)).astype(np.float32), g.standard_normal((5, 192)).astype(np.float32)
    a[1] = 0.0
    a[2], b[2] = 1e-6 * a[2], 1e-6 * b[2]
    b[3] = a[3] * 0.9 + 0.1 * b[3]
    for axis in (-1, 0):
        assert_within(tmetrics.cosine_similarity(a, b, axis).numpy(),
                      np.asarray(jmetrics.cosine_similarity(a, b, axis)), 1e-6, f"cosine axis {axis}")
    ok, sim = tmetrics.verify_speaker(torch.from_numpy(a), torch.from_numpy(b))
    jok, jsim = jmetrics.verify_speaker(a, b)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert bool(ok[3]) and not bool(ok[0])
    embed = lambda m: m.mean(-1)  # noqa: E731
    for name in ("speaker_similarity", "emotion_similarity"):
        got = getattr(tmetrics, name)(embed, torch.from_numpy(a[None]), torch.from_numpy(b[None]))
        assert_within(got.numpy(), np.asarray(getattr(jmetrics, name)(lambda m: m.mean(-1), a[None], b[None])),
                      1e-6, name)


@pytest.mark.parametrize("src, tgt", [([], [1.0]), ([0.1, 0.5, 0.9], [0.4, 0.6, 1.5, 2.0]),
                                      ([0.32 * i for i in range(12)], [0.32 * i + 0.7 ** i for i in range(9)])])
def test_average_lagging_and_rtf_equal_jax(src, tgt):
    assert tmetrics.average_lagging(src, tgt) == jmetrics.average_lagging(src, tgt)
    for audio_s, wall_s in ((23.78, 0.0153), (5.0, 0.0)):
        assert tmetrics.real_time_factor(audio_s, wall_s) == jmetrics.real_time_factor(audio_s, wall_s)


BLEU_CASES = [
    (["a b c d e f"], ["a b c d e f"]),
    (["k a s m i t o", "n e r"], ["k a s m i p o", "n e r l"]),
    (["the cat sat on the mat", "a b"], ["the cat sat on a mat", "a b c d e"]),
    ([""], ["a b c"]),
    (["a a a a a"], ["a b a c a"]),
]


@pytest.mark.parametrize("hyps, refs", BLEU_CASES)
def test_bleu_equals_jax_in_both_branches(hyps, refs, monkeypatch):
    """``_bleu_fallback`` exactly; ``corpus_bleu`` exactly with sacrebleu
    (where it is installed) and with it hidden (the fallback, what the
    card's installation runs); ``asr_bleu`` through a ``NullTranscriber``."""
    assert tmetrics._bleu_fallback(hyps, refs) == jmetrics._bleu_fallback(hyps, refs)
    assert tmetrics.corpus_bleu(hyps, refs) == jmetrics.corpus_bleu(hyps, refs)
    audio = [np.zeros(4, np.float32)] * len(hyps)
    table = {i: h.upper() + " " for i, h in enumerate(hyps)}
    assert (tmetrics.asr_bleu(tasr.NullTranscriber(table), audio, refs)
            == jmetrics.asr_bleu(jasr.NullTranscriber(table), audio, refs))
    monkeypatch.setitem(sys.modules, "sacrebleu", None)
    got = tmetrics.corpus_bleu(hyps, refs)
    assert got == jmetrics.corpus_bleu(hyps, refs) == tmetrics._bleu_fallback(hyps, refs)


def test_mel_l1_and_mcd_equal_jax():
    """mel-L1 within 1e-6 relative; MCD (the same numpy and scipy code)
    exactly."""
    g = np.random.default_rng(1)
    a, b = g.standard_normal((1, 80, 37)).astype(np.float32), g.standard_normal((1, 80, 37)).astype(np.float32)
    got, want = tmetrics.mel_l1(torch.from_numpy(a), torch.from_numpy(b)), jmetrics.mel_l1(a, b)
    assert abs(got - want) <= 1e-6 * want
    assert tmetrics.mcd(a[0].T, b[0].T) == jmetrics.mcd(a[0].T, b[0].T) > 0
    assert tmetrics.mcd(a[0].T, a[0].T) == 0.0


# --------------------------------------------------------------------------
# the S2ST task's token spaces, fbank; the encoder pre-training helpers
# --------------------------------------------------------------------------


def test_token_spaces_translation_and_f1_equal_jax():
    assert (ttask.BLANK, ttask.BOS, ttask.EOS, ttask.TOKEN_OFFSET, ttask.N_PHONES) == (
        jtask.BLANK, jtask.BOS, jtask.EOS, jtask.TOKEN_OFFSET, jtask.N_PHONES)
    for seed in (1234, 7):
        np.testing.assert_array_equal(ttask.phone_permutation(seed), jtask.phone_permutation(seed))
    assert dataclasses.asdict(ttask.S2STTaskConfig()) == dataclasses.asdict(jtask.S2STTaskConfig())
    cfg = ttask.S2STTaskConfig()
    assert (cfg.n_frames, cfg.n_samples) == (jtask.S2STTaskConfig().n_frames, jtask.S2STTaskConfig().n_samples)
    corpus = FormantSpeechCorpus(n_speakers=32)
    for key in range(6):
        ids = plan_phone_ids(corpus.utterance(key % 32, key, return_plan=True)[1])
        for fn in ("source_tokens", "translate", "target_units"):
            np.testing.assert_array_equal(getattr(ttask, fn)(ids), getattr(jtask, fn)(ids), err_msg=fn)
        src, tgt = ttask.source_tokens(ids), ttask.translate(ids)
        for hyp, ref in ((src, tgt), (src[: len(src) // 2], src), ([], src), (tgt, tgt)):
            assert ttask.token_f1(hyp, ref) == jtask.token_f1(hyp, ref)


def _fbank_float64(audio, frames, hop, win, valid):
    """``batched_fbank`` in float64 numpy: the reference both fp32 versions
    are held to."""
    idx = np.arange(frames)[:, None] * hop + np.arange(win)[None, :]
    x = audio.astype(np.float64)[:, idx] * tstft._hann(win).astype(np.float64)
    power = np.abs(np.fft.rfft(x, n=512, axis=-1)) ** 2
    mel = np.log(np.maximum(power @ tstft.mel_filterbank(16_000, 512, 80, 20.0, 8000.0).astype(np.float64), 1e-10))
    m = (np.arange(frames)[None, :] < np.asarray(valid if valid is not None else [frames] * len(audio))[:, None])
    m = m[..., None].astype(np.float64)
    mean = (mel * m).sum(1, keepdims=True) / m.sum(1, keepdims=True)
    std = np.sqrt((np.square(mel - mean) * m).sum(1, keepdims=True) / m.sum(1, keepdims=True))
    return (mel - mean) / np.maximum(std, 1e-5) * m, mel


@pytest.mark.parametrize("valid", [None, [150, 37]], ids=["all_frames", "valid_frames"])
def test_batched_fbank_matches_jax(valid):
    """Two formant clips in a 160-frame buffer, with and without valid
    frames (the second clip's CMVN over 37 frames, the rest zeroed).

    Tolerances: 5e-5 on bins whose power is above e^-12 (the log-mel above
    -12); 2e-3 on every bin.  Not 1e-5 throughout: near the 1e-10 floor an
    fp32 FFT's rounding, relative to the frame's peak, moves the log power
    by up to 1e-3 after CMVN, and both JAX and the port lie that far from a
    float64 reference there (and 1.1e-5 from it on the strongest bins).
    So the port is also held to that reference: its worst error no more
    than 1.5 times JAX's, plus 1e-6."""
    clips, _ = _clips(2)
    cfg = ttask.S2STTaskConfig()
    frames = 160
    audio = np.zeros((2, (frames - 1) * cfg.hop + cfg.win), np.float32)
    for i, c in enumerate(clips):
        audio[i] = c[: audio.shape[1]]
    vf = None if valid is None else np.array(valid, np.int32)
    got = ttask.batched_fbank(torch.from_numpy(audio), frames, cfg.hop, cfg.win,
                              valid_frames=None if vf is None else torch.from_numpy(vf)).numpy()
    want = np.asarray(jtask.batched_fbank(jnp.asarray(audio), frames, cfg.hop, cfg.win,
                                          valid_frames=None if vf is None else jnp.asarray(vf)))
    ref, log_mel = _fbank_float64(audio, frames, cfg.hop, cfg.win, vf)
    assert got.shape == (2, frames, 80)
    strong = log_mel > -12
    assert_within(got[strong], want[strong], 5e-5, f"batched_fbank {valid}, log-mel > -12")
    assert_within(got, want, 2e-3, f"batched_fbank {valid}, every bin")
    port_err, jax_err = float(np.abs(got - ref).max()), float(np.abs(want - ref).max())
    print(f"[share] batched_fbank {valid} against float64: port {port_err:.3g}, JAX {jax_err:.3g}")
    assert port_err <= 1.5 * jax_err + 1e-6
    if valid is not None:
        assert float(np.abs(got[1, 37:]).max()) == 0.0 and float(got[1, :37].std()) > 0.5
    with pytest.raises(ValueError, match="samples"):
        ttask.batched_fbank(torch.from_numpy(audio), frames + 1, cfg.hop, cfg.win)


def test_encoder_helpers_match_jax():
    """``arousal_bin`` and ``EncoderTrainConfig`` equal; the port's
    ``build_models`` has JAX's stripped parameter tree; ``strip_classifier``
    on the flattened JAX tree equals JAX's; ``graft_into_extractor`` equals
    JAX's and loads into the port's vocoder."""
    ar = np.linspace(0.0, 1.2, 50)
    np.testing.assert_array_equal(tenc.arousal_bin(ar), jenc.arousal_bin(ar))
    assert tenc.N_AROUSAL_BINS == jenc.N_AROUSAL_BINS
    assert dataclasses.asdict(tenc.EncoderTrainConfig()) == dataclasses.asdict(jenc.EncoderTrainConfig())
    widths = dict(ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4)
    jstate = jax.eval_shape(lambda: jenc.create_encoder_state(
        jax.random.PRNGKey(0), jenc.EncoderTrainConfig(segment_samples=2048, **widths))[0])
    for tree, model in zip((jstate.ecapa_params, jstate.emo_params),
                           tenc.build_models(tenc.EncoderTrainConfig(**widths), gen=_gen())):
        flat = {".".join(str(k.key) for k in path): np.zeros(leaf.shape, np.float32)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]}
        assert any(k.startswith("classifier.") for k in flat)
        stripped = tenc.strip_classifier(flat)
        assert stripped.keys() == _flat(jenc.strip_classifier(tree)).keys()
        assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {k: v.shape for k, v in stripped.items()}
    g = np.random.default_rng(2)
    tiny80 = {**TINY, "input_channels": 80}  # the encoders' 80 mels
    gen_tree = _randomise(jax.eval_shape(jvoc.ModifiedVocoder(jgen.GeneratorConfig(**tiny80), **TINY_EXTRACTOR).init,
                                         jax.random.PRNGKey(0), np.zeros((1, 80, 8), np.float32)), 1)
    enc = {k: jax.tree_util.tree_map(lambda x: g.standard_normal(x.shape).astype(np.float32), t)
           for k, t in (("ecapa", jstate.ecapa_params), ("emo", jstate.emo_params))}
    want = _flat(jenc.graft_into_extractor(gen_tree, enc["ecapa"], enc["emo"]))
    got = tenc.graft_into_extractor(_flat(gen_tree), _flat(enc["ecapa"]), _flat(enc["emo"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    vocoder = tvoc.ModifiedVocoder(tgen.GeneratorConfig(**tiny80), gen=_gen(), **TINY_EXTRACTOR)
    vocoder.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()})


def test_encoder_and_judge_files_round_trip(tmp_path):
    """``save_encoder_checkpoint`` / ``load_encoder_checkpoint`` and
    ``save_ctc_judge`` / ``load_ctc_judge`` give back the configs, steps
    and parameters bit for bit; a file of other widths, a judge with a
    vocoder or without a transition head, and another feature revision
    raise."""
    cfg = tenc.EncoderTrainConfig(ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4,
                                  mel=tstft.MelConfig(**TINY_MEL))
    ecapa, emo = tenc.build_models(cfg, gen=torch.Generator().manual_seed(5))
    save_encoder_checkpoint(str(tmp_path / "enc.pt"), cfg, ecapa, emo, step=768)
    cfg2, ecapa2, emo2, step = load_encoder_checkpoint(str(tmp_path / "enc.pt"), "cpu")
    assert cfg2 == cfg and step == 768 and not ecapa2.training
    for a, b in ((ecapa, ecapa2), (emo, emo2)):
        for (n, p), (n2, p2) in zip(a.state_dict().items(), b.state_dict().items()):
            assert n == n2 and torch.equal(p, p2), n
    blob = torch.load(tmp_path / "enc.pt", weights_only=True)
    blob["config"]["ecapa_channels"] = 64
    torch.save(blob, tmp_path / "enc_wrong.pt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_encoder_checkpoint(str(tmp_path / "enc_wrong.pt"), "cpu")

    judge = tss.StreamSpeechS2ST(tss.StreamSpeechConfig(**JUDGE), gen=_gen(), with_vocoder=False)
    save_ctc_judge(str(tmp_path / "judge.pt"), judge, step=30)
    loaded, step = load_ctc_judge(str(tmp_path / "judge.pt"), "cpu")
    assert step == 30 and loaded.config == judge.config and loaded.transition_head is not None
    for (n, p), (n2, p2) in zip(judge.state_dict().items(), loaded.state_dict().items()):
        assert n == n2 and torch.equal(p, p2), n
    for kw in ({"with_vocoder": True}, {"with_vocoder": False, "with_transition_head": False}):
        with pytest.raises(ValueError, match="trainer's tree"):
            save_ctc_judge(str(tmp_path / "x.pt"), tss.StreamSpeechS2ST(tss.StreamSpeechConfig(**JUDGE),
                                                                        gen=_gen(), **kw))
    blob = torch.load(tmp_path / "judge.pt", weights_only=True)
    blob["streamspeech_config"]["_feature_rev"] = -1
    torch.save(blob, tmp_path / "judge_rev.pt")
    with pytest.raises(ValueError, match="feature rev"):
        load_ctc_judge(str(tmp_path / "judge_rev.pt"), "cpu")


# --------------------------------------------------------------------------
# the CTC judge
# --------------------------------------------------------------------------


def write_tiny_judge(directory, seed=3):
    """A tiny CTC judge (``JUDGE`` widths, the S2ST trainer's tree: the JAX
    initialisers' draw moved by ``jitter``, as the streaming sessions'
    model) as JAX's trainer leaves it (``<directory>/jax``: an orbax train
    state of step 7 and ``streamspeech_config.json``) and as the port's
    file (``<directory>/judge.pt``).  Returns (JAX dir, port file)."""
    from hifigan_tpu.train.checkpoint import CheckpointManager

    jcfg = jss.StreamSpeechConfig(**JUDGE)
    state, _model, _tx = jtask.create_s2st_state(jax.random.PRNGKey(seed), jcfg, jtask.S2STTaskConfig())
    state = state.replace(params=jitter(state.params, seed), step=jnp.asarray(7, jnp.int32))
    jdir = directory / "jax"
    mgr = CheckpointManager(str(jdir))
    mgr.save(state, force=True)
    mgr.wait()
    mgr.close()
    with open(jdir / "streamspeech_config.json", "w") as f:
        json.dump({**dataclasses.asdict(jcfg), "_feature_rev": jss.FEATURE_REV}, f)
    model = tss.StreamSpeechS2ST(tss.StreamSpeechConfig(**JUDGE), gen=_gen(), with_vocoder=False)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, state.params))
    save_ctc_judge(str(directory / "judge.pt"), model, step=7)
    return str(jdir), str(directory / "judge.pt")


@pytest.fixture(scope="module")
def judges(tmp_path_factory):
    """(JAX CTCTranscriber, the port's on the CPU, their paths)."""
    jdir, tfile = write_tiny_judge(tmp_path_factory.mktemp("judge"))
    return jasr.CTCTranscriber(jdir), tasr.CTCTranscriber(tfile, "cpu"), jdir, tfile


def test_ctc_judge_transcripts_equal_jax(judges):
    """Four held-out clips (buckets 256 and 400) and a 1-frame clip: the
    transcripts are the same strings, and not all empty; the valid frames'
    argmax ids equal."""
    jt, tt, _, _ = judges
    clips, _ = _clips(4)
    clips.append(clips[0][:300])
    got, want = [tt(c) for c in clips], [jt(c) for c in clips]
    print(f"[judge] transcripts: {[len(s.split()) for s in got]} phones")
    assert got == want and any(got)
    assert tt.step == jt.step == 7 and tt.model_cfg == tss.StreamSpeechConfig(**JUDGE)


def test_judge_competence_and_gate_equal_jax(judges, tmp_path):
    """``phone_cer`` on edge cases; ``judge_competence`` gives JAX's report;
    ``load_competent_ctc`` over [a missing file, an unreadable file, the
    judge] gives JAX's decision and CERs, at a gate the judge fails (0.4)
    and at one it passes (its own CER + 1e-3)."""
    for hyp, ref in (("a b c", "a b c"), ("a c", "a b c"), ("", ""), ("x", ""), ("b a", "a b d e")):
        assert tasr.phone_cer(hyp, ref) == jasr.phone_cer(hyp, ref)
    jt, tt, jdir, tfile = judges
    clips, refs = _clips(3)
    want = jasr.judge_competence(jt, clips, refs)
    assert tasr.judge_competence(tt, clips, refs) == want
    (tmp_path / "bad.pt").write_bytes(b"not a checkpoint")
    for max_cer in (0.4, want["ground_truth_cer"] + 1e-3):
        got_t, got = tasr.load_competent_ctc([str(tmp_path / "missing.pt"), str(tmp_path / "bad.pt"), tfile],
                                             clips, refs, max_cer, device="cpu")
        want_t, want_r = jasr.load_competent_ctc([str(tmp_path / "missing"), jdir], clips, refs, max_cer)
        assert (got_t is None) == (want_t is None) == (want["ground_truth_cer"] > max_cer)
        assert got["candidates"][0]["dir"] == str(tmp_path / "bad.pt") and "error" in got["candidates"][0]
        assert {**got["candidates"][1], "dir": None} == {**want_r["candidates"][0], "dir": None}
        assert got["selected"] == (None if got_t is None else tfile) and got["max_cer"] == max_cer


def test_ctc_judge_without_a_card_raises(monkeypatch, judges):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tasr.CTCTranscriber(judges[3])


def test_asr_bleu_directory_scoring_equals_jax(judges, tmp_path):
    """``run_asr_bleu`` over three ``<i>_pred.wav`` files and a manifest,
    with and without silence removal, through the tiny judges: the same
    hypotheses and BLEU; the files and pairs as JAX composes them."""
    from hifigan_tpu.eval import asr_bleu as jasr_bleu

    jt, tt, _, _ = judges
    clips, refs = _clips(3)
    for i, c in enumerate(clips):
        padded = np.concatenate([np.zeros(4000, np.float32), c, np.zeros(3000, np.float32)])
        tasr_bleu.write_wav(str(tmp_path / f"{2 - i}_pred.wav"), padded)
    (tmp_path / "refs.txt").write_text("\n".join(refs))
    assert (tasr_bleu.compose_eval_data(str(tmp_path), str(tmp_path / "refs.txt"))
            == jasr_bleu.compose_eval_data(str(tmp_path), str(tmp_path / "refs.txt")))
    audio, _ = tasr_bleu.read_wav(str(tmp_path / "0_pred.wav"))
    np.testing.assert_array_equal(tasr_bleu.remove_silence(audio), jasr_bleu.remove_silence(audio))
    assert len(tasr_bleu.remove_silence(audio)) < len(audio)
    assert tasr_bleu.postprocess_hokkien("Tsa-bo2  LANG3") == jasr_bleu.postprocess_hokkien("Tsa-bo2  LANG3")
    for rm in (False, True):
        got = tasr_bleu.run_asr_bleu("formant", str(tmp_path), str(tmp_path / "refs.txt"), transcriber=tt,
                                     rm_silence=rm, transcripts_path=str(tmp_path / "t.txt"))
        want = jasr_bleu.run_asr_bleu("formant", str(tmp_path), str(tmp_path / "refs.txt"), transcriber=jt,
                                      rm_silence=rm)
        assert got == want and got["num_samples"] == 3
        assert (tmp_path / "t.txt").read_text() == "\n".join(want["hypotheses"])


# --------------------------------------------------------------------------
# StreamEvaluator and the report
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_eval_pair():
    """The JAX and the port's evaluator functions over the same tiny
    weights: the cloning vocoder at ``TINY`` with the tiny extractor and
    the tiny-mel ECAPA and Emotion2Vec of ``cli eval --tiny``.  The
    generator's leaves are redrawn by ``_randomise``; the encoders' (and
    the vocoder's extractor's) are the JAX initialisers' draw moved by
    ``jitter``: redrawn by ``_randomise``, their biases swamp the input and
    every clip embeds to nearly one point, where no verification decision
    could be compared.  Mel by each side's ``audio_to_mel`` at the
    tiny mel config.  Returns ({"jax": fns, "port": fns}, TrainConfigs)."""
    from hifigan_tpu.train.state import TrainConfig as JTrainConfig

    jcfg = JTrainConfig(mel=jstft.MelConfig(**TINY_MEL))
    tcfg = TrainConfig(mel=tstft.MelConfig(**TINY_MEL))
    mel0 = np.zeros((1, 16, 8), np.float32)
    jv = jvoc.ModifiedVocoder(jgen.GeneratorConfig(**TINY, mrf_backend="xla"), **TINY_EXTRACTOR)
    vparams = _randomise(jax.eval_shape(jv.init, jax.random.PRNGKey(0), mel0), 11)
    vparams["params"]["embedding_extractor"] = jitter(
        jax.jit(jv.init)(jax.random.PRNGKey(0), mel0)["params"]["embedding_extractor"], 14)
    js, je = jemb.EcapaTdnn(n_mels=16, channels=32), jemb.Emotion2Vec(n_mels=16, hidden_dim=32, num_layers=1,
                                                                      num_heads=4)
    sparams = jitter(jax.jit(js.init)(jax.random.PRNGKey(1), mel0), 12)
    eparams = jitter(jax.jit(je.init)(jax.random.PRNGKey(2), mel0), 13)
    tv = load_jax_params(tvoc.ModifiedVocoder(tgen.GeneratorConfig(**TINY), gen=_gen(), **TINY_EXTRACTOR), vparams)
    ts = load_jax_params(temb.EcapaTdnn(16, 32, gen=_gen()), sparams)
    te = load_jax_params(temb.Emotion2Vec(16, 32, num_layers=1, num_heads=4, gen=_gen()), eparams)
    fns = {
        # the parameters go in as arguments: the generator indexes its
        # kernels with traced arrays, which a numpy constant cannot take
        "jax": dict(synth=functools.partial(jax.jit(lambda p, m: jv.apply(p, m)["waveform"]), vparams),
                    clone=functools.partial(jax.jit(lambda p, m, r: jv.apply(p, m, reference_mel=r)["waveform"]),
                                            vparams),
                    spk=functools.partial(jax.jit(js.apply), sparams),
                    emo=functools.partial(jax.jit(je.apply), eparams),
                    mel=jax.jit(lambda w: jtrain_step.audio_to_mel(w, jcfg)), host=jnp.asarray),
        "port": dict(synth=torch.no_grad()(lambda m: tv(m)["waveform"]),
                     clone=torch.no_grad()(lambda m, r: tv(m, reference_mel=r)["waveform"]),
                     spk=torch.no_grad()(lambda m: ts(m)), emo=torch.no_grad()(lambda m: te(m)),
                     mel=torch.no_grad()(lambda w: audio_to_mel(torch.as_tensor(w), tcfg)), host=torch.from_numpy),
    }
    return fns, (jcfg, tcfg)


# stated before the run: SIM is a cosine of fp32 unit embeddings; mel-L1 a
# mean over log-mels of O(1); MCD in dB, ~14x the log-mel differences
EVAL_TOLS = {"speaker_similarity": 1e-4, "emotion_similarity": 1e-4, "mel_l1": 1e-4, "mcd": 1e-3}


def _evaluate(side, fns, samples, transcripts):
    f = fns[side]
    ev = (jevaluator if side == "jax" else tevaluator).StreamEvaluator(
        f["synth"], f["spk"], f["emo"], f["mel"],
        (jasr if side == "jax" else tasr).NullTranscriber(transcripts))
    return ev.evaluate_batch([{**s, "mel": f["mel"](f["host"](s["audio"]))} for s in samples]), ev


def test_stream_evaluator_matches_jax(tiny_eval_pair, tmp_path):
    """Three formant clips of up to 1536 samples, zero-padded to one 2048-
    sample bucket (256 tiny-mel frames) as ``cli eval`` pads them, scored
    over their valid frames, and one scored over the whole bucket: every
    metric within ``EVAL_TOLS``; the masking moves the metrics (the
    unmasked sample differs from the same clip masked), in both.  The
    report's JSON equals JAX's apart from ``processing_time`` and ``rtf``
    (whose values are wall times; their keys and counts equal)."""
    fns, (_, tcfg) = tiny_eval_pair
    clips, refs = _clips(3, 1536)
    clips[1] = clips[1][:900]
    samples = []
    for clip, ref in zip(clips, refs):
        audio = np.zeros((1, 2048), np.float32)
        audio[0, : len(clip)] = clip
        samples.append({"audio": audio, "reference_text": ref,
                        "valid_frames": -(-len(clip) // tcfg.mel.hop_length)})
    samples.append({**samples[1], "valid_frames": None})
    transcripts = {0: refs[0], 1: " ".join(refs[1].split()[:3]), 2: "a b", 3: refs[1]}
    want, jev = _evaluate("jax", fns, samples, transcripts)
    got, tev = _evaluate("port", fns, samples, transcripts)
    keys = set(EVAL_TOLS) | {"asr_bleu", "processing_time", "rtf"}
    assert [set(r) for r in got] == [set(r) for r in want] == [keys] * 4
    for name, tol in EVAL_TOLS.items():
        assert_within([r[name] for r in got], [r[name] for r in want], tol, f"StreamEvaluator {name}")
    assert [r["asr_bleu"] for r in got] == [r["asr_bleu"] for r in want]
    assert abs(got[3]["mel_l1"] - got[1]["mel_l1"]) > 10 * EVAL_TOLS["mel_l1"]
    assert abs(want[3]["mel_l1"] - want[1]["mel_l1"]) > 10 * EVAL_TOLS["mel_l1"]
    for r in got:
        assert r["processing_time"] > 0 and r["rtf"] == pytest.approx(2048 / 16_000 / r["processing_time"])
    extra = {"dataset": "formant", "restored_step": 0}
    rep_t = tevaluator.create_evaluation_report(got, str(tmp_path / "t.json"), extra)
    rep_j = jevaluator.create_evaluation_report(want, str(tmp_path / "j.json"), extra)
    assert rep_t.keys() == rep_j.keys()

    def scrub(report):
        out = json.loads(json.dumps(report, default=float))
        for r in out["raw_results"]:
            r.pop("processing_time"), r.pop("rtf")
        for k in ("processing_time", "rtf"):
            out["statistics"][k] = {s: v for s, v in out["statistics"][k].items() if s == "count"}
        return out

    t, j = scrub(json.load(open(tmp_path / "t.json"))), scrub(json.load(open(tmp_path / "j.json")))
    for k in ("raw_results", "statistics", "benchmarks"):
        np.testing.assert_equal(jax.tree_util.tree_structure(t[k]), jax.tree_util.tree_structure(j[k]))
        for a, b in zip(jax.tree_util.tree_leaves(t[k]), jax.tree_util.tree_leaves(j[k])):
            if isinstance(b, float):
                assert abs(a - b) <= 1e-3, (k, a, b)
            else:
                assert a == b, (k, a, b)
    assert {m: b["status"] for m, b in t["benchmarks"].items()} == {m: b["status"] for m, b in j["benchmarks"].items()}
    assert tev.compute_statistics(got).keys() == jev.compute_statistics(want).keys()


def test_report_of_the_same_results_is_the_same_json(tmp_path):
    """The same per-sample results give JAX's report text exactly: PASS,
    FAIL and SKIPPED (no ASR-BLEU computed) included."""
    results = [{"speaker_similarity": 0.81, "emotion_similarity": 0.52, "mel_l1": 0.4, "mcd": 7.5,
                "processing_time": 0.01, "rtf": 812.0},
               {"speaker_similarity": 0.69, "emotion_similarity": 0.61, "mel_l1": 0.5, "mcd": 8.5,
                "processing_time": 0.02, "rtf": 406.0}]
    for rs in (results, [{**r, "asr_bleu": b} for r, b in zip(results, (31.0, 12.5))], []):
        tevaluator.create_evaluation_report(rs, str(tmp_path / "t.json"), {"sim_encoders": "trained"})
        jevaluator.create_evaluation_report(rs, str(tmp_path / "j.json"), {"sim_encoders": "trained"})
        assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tevaluator.BENCHMARKS == jevaluator.BENCHMARKS


def test_realtime_evaluator_matches_jax():
    """The same chunk function in both: equal record counts and source
    times, Average Lagging from its own records as JAX computes it."""
    outs = []
    for mod in (tevaluator, jevaluator):
        ev = mod.RealTimeEvaluator(lambda c: {"wav": c * 2, "n": 1}, chunk_duration_s=0.32)
        assert ev.compute_streaming_metrics() == {"avg_processing_time": 0.0, "average_lagging": 0.0, "chunks": 0}
        for i in range(5):
            out = ev.process_chunk(np.full(4, i, np.float32))
            assert out["n"] == 1 and out["source_time"] == pytest.approx(0.32 * (i + 1))
        m = ev.compute_streaming_metrics()
        procs = [r["processing_time"] for r in ev.records]
        assert m["average_lagging"] == pytest.approx(np.mean(procs)) and m["chunks"] == 5
        outs.append(set(m))
        ev.reset()
        assert not ev.records
    assert outs[0] == outs[1]


# --------------------------------------------------------------------------
# the cloning transfer grid
# --------------------------------------------------------------------------

COS_TOL = 1e-4  # a cosine of fp32 unit embeddings, stated before the run


def test_cloning_transfer_matches_jax(tiny_eval_pair):
    """``encoder_separation``, ``speaker_centroids`` and
    ``evaluate_cloning_transfer`` at 2 speakers × 1 content (8192-sample
    renditions, 4096-sample references: 1,024 and 512 tiny-mel frames)
    with the tiny vocoder and ECAPA: cosines and centroids within
    ``COS_TOL``, mel-L1 within 1e-4; each pair's ``verified_as_target``
    equals JAX's wherever its cosine lies more than ``COS_TOL`` from 0.7
    (the count of pairs nearer is printed)."""
    fns, _ = tiny_eval_pair
    kw = dict(n_speakers=2, segment_samples=8192)
    out = {}
    for side, mod, corpus in (("jax", jclone, JCorpus(n_speakers=32)),
                              ("port", tclone, FormantSpeechCorpus(n_speakers=32))):
        f = fns[side]
        sep = mod.encoder_separation(f["spk"], f["mel"], corpus, clips_per_speaker=2, **kw)
        cents = mod.speaker_centroids(f["spk"], f["mel"], corpus, clips_per_speaker=2, **kw)
        grid = mod.evaluate_cloning_transfer(f["clone"], f["spk"], f["mel"], f["mel"], corpus, n_contents=1,
                                             ref_samples=4096, centroids=cents, **kw)
        out[side] = (sep, cents, grid)
    (tsep, tcents, tgrid), (jsep, jcents, jgrid) = out["port"], out["jax"]
    assert tsep.keys() == jsep.keys()
    assert_within([tsep[k] for k in jsep], [jsep[k] for k in jsep], COS_TOL, "encoder_separation")
    assert_within(tcents, jcents, COS_TOL, "speaker_centroids")
    assert tgrid.keys() == jgrid.keys() and tgrid["n_transfer_pairs"] == jgrid["n_transfer_pairs"] == 2
    assert_within(list(tgrid["ablation"].values()), list(jgrid["ablation"].values()), COS_TOL, "ablation")
    near = 0
    for t, j in zip(tgrid["pairs"], jgrid["pairs"]):
        assert t.keys() == j.keys() and (t["content"], t["source"], t["target"]) == (
            j["content"], j["source"], j["target"])
        assert_within([t["sim_target"], t["sim_source"]], [j["sim_target"], j["sim_source"]], COS_TOL, "pair sims")
        assert_within([t["mel_l1_to_target_rendition"], t["mel_l1_to_source_rendition"]],
                      [j["mel_l1_to_target_rendition"], j["mel_l1_to_source_rendition"]], 1e-4, "pair mel-L1")
        if abs(j["sim_target"] - 0.7) > COS_TOL and abs(j["sim_target"] - j["sim_source"]) > 2 * COS_TOL:
            assert t["verified_as_target"] == j["verified_as_target"]
        else:
            near += 1
    print(f"[share] verified_as_target: {near} of {len(jgrid['pairs'])} pairs within the tolerance of the decision")
    for k in ("transfer_sim_target_mean", "transfer_sim_source_mean"):
        assert_within(tgrid[k], jgrid[k], COS_TOL, k)
