"""The evaluation path on the trained weights, the port against JAX on the
CPU, fp32: the CTC judge of ``runs/asr_judge/30000``, the judge encoders
of ``runs/encoders7/768000`` and the cloning vocoder of
``runs/cloning/220000``, each restored once through the JAX package and
carried into the port by ``load_jax_params``, then through the port's own
files (``save_ctc_judge``, ``save_encoder_checkpoint``) as ``cli eval``
reads them.  Skips, naming the path, if a checkpoint is missing."""

import functools
import json
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_eval import _clips
from test_torch_generator import _gen
from test_torch_s2st import assert_within
from test_torch_s2st_trained import _restore

from hifigan_tpu_torch.eval import asr as tasr
from hifigan_tpu_torch.eval import cloning_eval as tclone
from hifigan_tpu_torch.models.generator import GeneratorConfig
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder
from hifigan_tpu_torch.train import audio_to_mel
from hifigan_tpu_torch.train.corpus import FormantSpeechCorpus
from hifigan_tpu_torch.train.encoder_pretrain import EncoderTrainConfig, build_models
from hifigan_tpu_torch.train.state import TrainConfig
from hifigan_tpu_torch.weights import (
    load_encoder_checkpoint,
    load_jax_params,
    save_ctc_judge,
    save_encoder_checkpoint,
)

ROOT = Path(__file__).resolve().parents[1]
JUDGE = ROOT / "runs" / "asr_judge" / "30000"
ENCODERS = ROOT / "runs" / "encoders7" / "768000"
CLONING = ROOT / "runs" / "cloning" / "220000"
COS_TOL = 1e-4  # cosines and embeddings of fp32 unit vectors


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _require(*paths):
    for path in paths:
        if not (path / "default").is_dir():
            pytest.skip(f"the trained checkpoint {path.relative_to(ROOT)} is missing")


@pytest.fixture(scope="module")
def judges(tmp_path_factory):
    """(JAX's CTCTranscriber over ``runs/asr_judge``, the port's over a
    ``save_ctc_judge`` file of the same weights)."""
    _require(JUDGE)
    from hifigan_tpu.eval.asr import CTCTranscriber
    from hifigan_tpu_torch.models.streamspeech import StreamSpeechS2ST
    from hifigan_tpu_torch.weights import load_streamspeech_config

    jt = CTCTranscriber(str(JUDGE.parent))
    model = StreamSpeechS2ST(load_streamspeech_config(str(JUDGE.parent / "streamspeech_config.json")), gen=_gen(),
                             with_vocoder=False)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jt.params))
    path = tmp_path_factory.mktemp("judge") / "ctc_judge.pt"
    save_ctc_judge(str(path), model, step=jt.step)
    return jt, tasr.CTCTranscriber(str(path), "cpu")


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """(JAX ECAPA and Emotion2Vec functions over ``runs/encoders7``'s
    stripped trees, the port's from a ``save_encoder_checkpoint`` file)."""
    _require(ENCODERS)
    from hifigan_tpu.models.embeddings import EcapaTdnn, Emotion2Vec
    from hifigan_tpu.train import encoder_pretrain as jenc

    cfg = jenc.EncoderTrainConfig()
    state = _restore(ENCODERS, lambda: jenc.create_encoder_state(jax.random.PRNGKey(0), cfg)[0])
    spk, emo = jenc.strip_classifier(state.ecapa_params), jenc.strip_classifier(state.emo_params)
    jfns = (functools.partial(jax.jit(EcapaTdnn(channels=cfg.ecapa_channels).apply), spk),
            functools.partial(jax.jit(Emotion2Vec(hidden_dim=cfg.emo_hidden, num_layers=cfg.emo_layers,
                                                  num_heads=cfg.emo_heads).apply), emo))
    ecapa, emotion2vec = build_models(EncoderTrainConfig(), gen=_gen())
    load_jax_params(ecapa, jax.tree_util.tree_map(np.asarray, spk))
    load_jax_params(emotion2vec, jax.tree_util.tree_map(np.asarray, emo))
    path = tmp_path_factory.mktemp("encoders") / "encoders.pt"
    save_encoder_checkpoint(str(path), EncoderTrainConfig(), ecapa, emotion2vec, step=int(state.step))
    _, ecapa, emotion2vec, step = load_encoder_checkpoint(str(path), "cpu")
    assert step == int(state.step) == int(ENCODERS.name)
    return jfns, (torch.no_grad()(ecapa), torch.no_grad()(emotion2vec))


def _jax_mel():
    from hifigan_tpu.train import TrainConfig as JTrainConfig
    from hifigan_tpu.train.train_step import audio_to_mel as jaudio_to_mel

    return jax.jit(lambda w: jaudio_to_mel(w, JTrainConfig()))


def _port_mel(w):
    with torch.no_grad():
        return audio_to_mel(torch.as_tensor(np.asarray(w)), TrainConfig())


def test_trained_judge_transcripts_equal_jax(judges):
    """Two held-out formant clips (``cli eval``'s first two): the judge's
    transcripts are the same strings, and its ground-truth CER (the gate's
    number) is the same."""
    jt, tt = judges
    clips, refs = _clips(2)
    got, want = [tt(c) for c in clips], [jt(c) for c in clips]
    assert got == want and all(got)
    cer = tasr.judge_competence(tt, clips, refs)
    print(f"[judge] trained judge step {tt.step}: ground-truth CER {cer['ground_truth_cer']} on 2 clips")
    from hifigan_tpu.eval.asr import judge_competence

    assert cer == judge_competence(jt, clips, refs) and tt.step == jt.step == int(JUDGE.name)


def test_cli_eval_scores_asr_bleu_with_the_trained_judge(judges, tmp_path):
    """``cli eval --tiny --samples 1 --asr <the trained judge's file>`` on
    the CPU: the judge passes the gate on the clip, so ASR-BLEU is scored
    (PASS or FAIL, not SKIPPED), and the gate report names the file."""
    from hifigan_tpu_torch import cli

    path = str(tmp_path / "ctc_judge.pt")
    save_ctc_judge(path, judges[1].model, step=judges[1].step)
    cli.main(["eval", "--tiny", "--samples", "1", "--device", "cpu", "--asr", path, "--output",
              str(tmp_path / "r.json")])
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["asr_judge_gate"]["selected"] == path and report["asr_judge_gate"]["candidates"][0]["competent"]
    assert report["statistics"]["asr_bleu"]["count"] == 1
    assert report["benchmarks"]["asr_bleu"]["status"] in ("PASS", "FAIL")


def test_trained_encoder_embeddings_match_jax(encoders):
    """ECAPA-TDNN (512) and the judge Emotion2Vec (3 × 256) on four
    held-out clips' log-mels (each side's ``audio_to_mel``, ``TrainConfig()``):
    every embedding within 1e-4; the clips' speakers differ, so do their
    embeddings."""
    (jspk, jemo), (tspk, temo) = encoders
    clips, _ = _clips(4, 32_768)
    mel = _jax_mel()
    for name, jf, tf in (("ECAPA", jspk, tspk), ("Emotion2Vec", jemo, temo)):
        got = np.stack([tf(_port_mel(c[None]))[0].numpy() for c in clips])
        want = np.stack([np.asarray(jf(mel(c[None])))[0] for c in clips])
        assert_within(got, want, COS_TOL, f"trained {name} embeddings")
        assert float(np.abs(got[0] - got[1]).max()) > 100 * COS_TOL


def test_trained_cloning_transfer_matches_jax(encoders):
    """``encoder_separation``, ``speaker_centroids`` and
    ``evaluate_cloning_transfer`` at 2 speakers × 1 content with the
    trained cloning vocoder and ECAPA, as ``cli eval-clone`` runs them
    (32,768-sample renditions, 16,384-sample references): cosines within
    1e-4, mel-L1 within 1e-4; the verification decisions equal wherever
    the cosine lies more than 1e-4 from the decision."""
    _require(CLONING)
    from hifigan_tpu.eval import cloning_eval as jclone
    from hifigan_tpu.models import generator as jgen
    from hifigan_tpu.models import vocoder as jvoc
    from hifigan_tpu.train import TrainConfig as JTrainConfig
    from hifigan_tpu.train import create_train_state
    from hifigan_tpu.train.corpus import FormantSpeechCorpus as JCorpus

    state = _restore(CLONING, lambda: create_train_state(jax.random.PRNGKey(0), JTrainConfig(), mel_frames=32,
                                                         batch_size=1)[0])
    jm = jvoc.ModifiedVocoder(jgen.GeneratorConfig(mrf_backend="xla"))
    jsynth = functools.partial(jax.jit(lambda p, m, r: jm.apply(p, m, reference_mel=r)["waveform"]),
                               state.gen_params)
    vocoder = load_jax_params(ModifiedVocoder(GeneratorConfig(), gen=_gen()),
                              jax.tree_util.tree_map(np.asarray, state.gen_params)).eval()
    tsynth = torch.no_grad()(lambda m, r: vocoder(m, reference_mel=r)["waveform"])
    (jspk, _), (tspk, _) = encoders
    out = {}
    for side, mod, corpus, synth, spk, mel in (
            ("jax", jclone, JCorpus(n_speakers=32), jsynth, jspk, _jax_mel()),
            ("port", tclone, FormantSpeechCorpus(n_speakers=32), tsynth, tspk, _port_mel)):
        sep = mod.encoder_separation(spk, mel, corpus, n_speakers=2)
        cents = mod.speaker_centroids(spk, mel, corpus, n_speakers=2)
        out[side] = sep, cents, mod.evaluate_cloning_transfer(synth, spk, mel, mel, corpus, n_speakers=2,
                                                               n_contents=1, centroids=cents)
    (tsep, tcents, tgrid), (jsep, jcents, jgrid) = out["port"], out["jax"]
    assert_within([tsep[k] for k in jsep], [jsep[k] for k in jsep], COS_TOL, "trained encoder_separation")
    assert_within(tcents, jcents, COS_TOL, "trained centroids")
    assert_within(list(tgrid["ablation"].values()), list(jgrid["ablation"].values()), COS_TOL, "trained ablation")
    near = 0
    for t, j in zip(tgrid["pairs"], jgrid["pairs"]):
        assert_within([t["sim_target"], t["sim_source"]], [j["sim_target"], j["sim_source"]], COS_TOL,
                      "trained pair sims")
        assert_within([t["mel_l1_to_target_rendition"], t["mel_l1_to_source_rendition"]],
                      [j["mel_l1_to_target_rendition"], j["mel_l1_to_source_rendition"]], 1e-4, "trained mel-L1")
        if abs(j["sim_target"] - 0.7) > COS_TOL and abs(j["sim_target"] - j["sim_source"]) > 2 * COS_TOL:
            assert t["verified_as_target"] == j["verified_as_target"]
        else:
            near += 1
    print(f"[share] trained verified_as_target: {near} of {len(jgrid['pairs'])} pairs within the tolerance of "
          f"the decision; ablation {tgrid['ablation']}")
    assert tgrid["ablation"]["zero_ref_sim_to_own"] != tgrid["ablation"]["correct_ref_sim_to_own"]


def test_trained_checkpoints_stay_unchanged(judges):
    out = subprocess.run(["git", "status", "--porcelain", "runs/"], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=60)
    assert out.stdout == ""
