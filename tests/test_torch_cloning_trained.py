"""The training pipeline from the trained weights, JAX and the port on the
CPU, fp32:

- the encoder train state of ``runs/encoders7/768000`` (both encoders with
  their classifier heads, both optax Adam states)
  restored through the JAX package's ``CheckpointManager`` and carried into
  the port by ``load_jax_encoder_state`` (the Emotion2Vec optimiser's count
  is 384000); one encoder step of batch 4 in
  both, on the crops JAX's sampler drew with the step's key;
- the cloning train state of ``runs/cloning/220000`` carried by
  ``load_jax_train_state``; one cloning pair step in both with train-clone's
  default losses (deep feature matching, the STFT term) and the
  centroid-hinge identity term, the judge being ``runs/encoders7``'s
  ECAPA-TDNN, on JAX's pair (1 × 4096 samples, a 8192-sample reference)
  with centroids of 4 speakers at the crop length.

The losses must agree within 1e-4 relative (plus 1e-6 absolute, for
cross-entropies near 0) and every updated parameter
within 0.2·lr of JAX's: with trained moments an element's step is a smooth
function of its gradient, except where the gradient is zero but for
rounding (``ZERO_GRADIENT``, as in ``tests/test_torch_train_trained.py``).
Skips, naming the path, if a checkpoint is missing."""

import inspect
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cloning_train import _with_signal
from test_torch_encoder_pretrain import _adam, _flat
from test_torch_s2st_trained import _restore

from hifigan_tpu_torch.models.embeddings import EcapaTdnn
from hifigan_tpu_torch.train import TrainConfig, create_train_state
from hifigan_tpu_torch.train import cloning as tcl
from hifigan_tpu_torch.train import encoder_pretrain as tenc
from hifigan_tpu_torch.train.losses import LossWeights
from hifigan_tpu_torch.train.state import learning_rate
from hifigan_tpu_torch.weights import load_jax_encoder_state, load_jax_params, load_jax_train_state

ROOT = Path(__file__).resolve().parents[1]
ENCODERS = ROOT / "runs" / "encoders7" / "768000"
CLONING = ROOT / "runs" / "cloning" / "220000"
SEGMENT, REF_SEGMENT, SPEAKERS, CONTENTS = 4096, 8192, 4, 2
LOSS_RTOL = 1e-4
# The trained encoders' cross-entropies are near 0 (1e-4): the difference of
# a logsumexp and a logit of order 10, whose fp32 rounding is about 1e-6.
LOSS_ATOL = 1e-6
# Leaves whose gradient is zero but for rounding (a bias before a softmax
# along which it is constant): with trained moments of rounding noise Adam
# turns their noise into a step of up to about 2·lr, in JAX and the port.
ZERO_GRADIENT = ("asp.att2.bias", ".mha.k.bias")
CLONE_LOSSES = dict(feature_matching=10.0, mel=45.0, adversarial=1.0, multi_res_stft=1.0)  # train-clone's


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


def _assert_updates(module, before: dict, after: dict, lr: float) -> int:
    """Every parameter of ``module`` within 0.2·lr of JAX's updated value
    (ZERO_GRADIENT leaves: moved by at most 3·lr in both); returns how many
    leaves JAX moved."""
    moved = 0
    for name, p in module.named_parameters():
        got = p.detach().numpy()
        moved += bool((after[name] != before[name]).any())
        if name.endswith(ZERO_GRADIENT):
            assert max(np.abs(got - before[name]).max(), np.abs(after[name] - before[name]).max()) <= 3 * lr, name
        else:
            np.testing.assert_allclose(got, after[name], rtol=0, atol=0.2 * lr, err_msg=name)
    return moved


def _assert_losses(got, want):
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(float(v)) for v in got.values())
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def encoders():
    """JAX's restored encoder state (numpy) and the JAX config."""
    _require(ENCODERS)
    from hifigan_tpu.train import encoder_pretrain as jenc

    state = _restore(ENCODERS, lambda: jenc.create_encoder_state(jax.random.PRNGKey(0), jenc.EncoderTrainConfig())[0])
    return jax.tree_util.tree_map(np.asarray, state)


def test_trained_encoder_step_matches_jax(encoders):
    """``runs/encoders7/768000`` with its heads: the port's state carries
    the step and both update counts (768000 and 384000); one step of
    ``EncoderTrainConfig()`` at batch 4 gives JAX's losses and accuracies
    and JAX's updated parameters, ECAPA-TDNN within 0.2·1e-3 and
    Emotion2Vec within 0.2·1e-4 (its schedule's constant)."""
    import optax

    from hifigan_tpu.train import encoder_pretrain as jenc

    jcfg = replace(jenc.EncoderTrainConfig(), batch_size=4)
    bank = jenc.build_labelled_bank(n_speakers=jcfg.n_speakers, utterances_per_speaker=1)
    ecapa, emo = jenc.build_models(jcfg)
    jstep = jenc.make_encoder_train_step(ecapa, emo, jcfg, optax.adam(jcfg.learning_rate), *map(jnp.asarray, bank))
    crops, pair, spk, bins = inspect.getclosurevars(jstep).nonlocals["sample"](jax.random.PRNGKey(0),
                                                                                jnp.asarray(bank[0]))
    new, want = jax.jit(jstep)(jax.tree_util.tree_map(jnp.asarray, encoders), jax.random.PRNGKey(0))
    new = jax.tree_util.tree_map(np.asarray, new)

    cfg = replace(tenc.EncoderTrainConfig(), batch_size=4)
    state = load_jax_encoder_state(tenc.create_encoder_state(cfg, device="cpu"), encoders)
    # the checkpoint's Emotion2Vec optimiser has taken half the updates
    # (384000): the count is carried as the checkpoint holds it
    assert state.step == state.ecapa_opt.count == 768000
    assert state.emo_opt.count == int(_adam(encoders.emo_opt).count) == 384000
    assert state.ecapa.classifier is not None and state.emo.classifier is not None
    step = tenc.make_encoder_train_step(cfg, torch.from_numpy(bank[0]), *bank[1:])
    state, got = step(state, {"audio": np.asarray(crops), "pair": None, "speaker": np.asarray(spk),
                              "arousal_bin": np.asarray(bins)})
    for k in ("speaker_acc", "emotion_acc", "emotion_acc_near"):
        assert float(got[k]) == float(want[k]), k
    _assert_losses(got, want)
    assert state.step == 768001 and tenc.emo_learning_rate(cfg, state.emo_opt.count) == cfg.emo_learning_rate
    for module, tree, lr in ((state.ecapa, "ecapa_params", cfg.learning_rate),
                             (state.emo, "emo_params", cfg.emo_learning_rate)):
        before, after = dict(_flat(getattr(encoders, tree)["params"])), dict(_flat(getattr(new, tree)["params"]))
        assert _assert_updates(module, before, after, lr) > 0.9 * len(before)


@pytest.fixture(scope="module")
def cloning(encoders):
    """JAX's restored cloning state (numpy), the judges over
    ``runs/encoders7``'s stripped ECAPA-TDNN, centroids of SPEAKERS
    speakers at the crop length, the banks and JAX's pair."""
    _require(CLONING)
    from hifigan_tpu.models.embeddings import EcapaTdnn as JEcapa
    from hifigan_tpu.train import TrainConfig as JTrainConfig
    from hifigan_tpu.train import cloning as jcl
    from hifigan_tpu.train import create_train_state as jax_create_train_state
    from hifigan_tpu.train import encoder_pretrain as jenc
    from hifigan_tpu.train.losses import LossWeights as JLossWeights

    from hifigan_tpu_torch.eval.cloning_eval import speaker_centroids
    from hifigan_tpu_torch.train import audio_to_mel
    from hifigan_tpu_torch.train.corpus import FormantSpeechCorpus

    jcfg = JTrainConfig(loss_weights=JLossWeights(**CLONE_LOSSES))
    state = _restore(CLONING, lambda: jax_create_train_state(jax.random.PRNGKey(0), jcfg, mel_frames=32,
                                                            batch_size=1)[0])
    judge_params = jenc.strip_classifier(encoders.ecapa_params)
    port_judge = load_jax_params(EcapaTdnn(80, 512, gen=torch.Generator().manual_seed(0)), judge_params)
    port_judge.eval().requires_grad_(False)
    tcfg = TrainConfig(loss_weights=LossWeights(**CLONE_LOSSES))
    cents = speaker_centroids(torch.no_grad()(port_judge), torch.no_grad()(lambda w: audio_to_mel(w, tcfg)),
                              FormantSpeechCorpus(n_speakers=SPEAKERS), n_speakers=SPEAKERS,
                              segment_samples=SEGMENT)
    banks = jcl.build_cloning_banks(n_speakers=SPEAKERS, n_contents=CONTENTS)
    sampler = jcl.make_pair_sampler(jnp.asarray(banks[2]), SEGMENT, REF_SEGMENT, 1)
    key, batch = _with_signal(sampler, banks)
    judge = JEcapa(channels=512)
    return dict(jcfg=jcfg, tcfg=tcfg, state=jax.tree_util.tree_map(np.asarray, state), port_judge=port_judge,
                judge=lambda mel: judge.apply(judge_params, mel), cents=cents.astype(np.float32), banks=banks,
                sampler=sampler, key=key, batch=batch)


def test_trained_cloning_step_matches_jax(cloning):
    """One train-clone step from ``runs/cloning/220000`` with the centroid
    hinge (weight 1, margin 0.8): every loss, ``identity_loss`` and
    ``identity_cos`` within 1e-4 relative; every generator and
    discriminator parameter within 0.2·lr of JAX's, lr the schedule's at
    update 220000."""
    from hifigan_tpu.models.discriminators import Discriminators
    from hifigan_tpu.models.vocoder import ModifiedVocoder
    from hifigan_tpu.train import cloning as jcl

    jcfg, before = cloning["jcfg"], cloning["state"]
    vocoder = ModifiedVocoder(jcfg.generator, ecapa_channels=jcfg.ecapa_channels, emo_hidden=jcfg.emo_hidden,
                              emo_layers=jcfg.emo_layers, emo_heads=jcfg.emo_heads)
    jstep = jcl.make_cloning_train_step(vocoder, Discriminators(), jcfg, cloning["sampler"],
                                        identity_fn=cloning["judge"], identity_weight=1.0,
                                        identity_centroids=jnp.asarray(cloning["cents"]), identity_margin=0.8)
    banks = cloning["banks"]
    new, want = jstep(jax.tree_util.tree_map(jnp.array, before), cloning["key"], jnp.asarray(banks[0]),
                      jnp.asarray(banks[1]))
    after = jax.tree_util.tree_map(np.asarray, new)

    state = load_jax_train_state(create_train_state(cloning["tcfg"], device="cpu"), before)
    assert state.step == 220000 and state.gen_opt.count == state.disc_opt.count == 220000
    step = tcl.make_cloning_train_step(cloning["tcfg"], identity_fn=cloning["port_judge"], identity_weight=1.0,
                                       identity_centroids=torch.from_numpy(cloning["cents"]), identity_margin=0.8)
    state, got = step(state, cloning["batch"])
    _assert_losses(got, want)
    assert {"identity_loss", "identity_cos", "stft_loss"} <= set(got)
    lr = learning_rate(cloning["tcfg"], 220000)
    for module, tree in ((state.vocoder, "gen_params"), (state.discriminators, "disc_params")):
        old, new_params = dict(_flat(getattr(before, tree)["params"])), dict(_flat(getattr(after, tree)["params"]))
        assert _assert_updates(module, old, new_params, lr) > 0.9 * len(old)
