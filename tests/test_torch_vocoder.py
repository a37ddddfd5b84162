"""The port's ``ModifiedVocoder`` (generator + ECAPA-TDNN + Emotion2Vec,
the voice-cloning API) against the JAX one on the CPU, with the JAX
parameters carried over by ``load_jax_params``: on seeded weights (every
leaf redrawn by ``_randomise``) at ``TINY`` with the tiny extractor and at
``TrainConfig()`` widths, and on the trained weights of
``runs/cloning/220000``.  Also the parameter tree, the loader's strictness
and ``build_vocoder``'s device rule."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import TINY, _gen, _inputs, _randomise

import hifigan_tpu_torch
from hifigan_tpu.models import generator as jgen
from hifigan_tpu.models import vocoder as jvoc
from hifigan_tpu_torch.models import generator as tgen
from hifigan_tpu_torch.models import vocoder as tvoc
from hifigan_tpu_torch.weights import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
TINY_EXTRACTOR = dict(ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4)  # cli.py --tiny
CHECKPOINT = ROOT / "runs" / "cloning" / "220000"
OUTPUTS = ("waveform", "speaker_embedding", "emotion_embedding")
CALL_FORMS = ("mel", "reference_mel", "speaker_only", "both_embeddings")


def _call_args(form, seed, batch, n_mels, frames, ref_frames):
    """Keyword arguments of one call form, as numpy arrays."""
    mel, ref, spk, emo = _inputs(seed, (batch, n_mels, frames), (batch, n_mels, ref_frames),
                                 (batch, 192), (batch, 256))
    spk, emo = (e / np.linalg.norm(e, axis=-1, keepdims=True) for e in (spk, emo))
    return {"mel": dict(mel=mel), "reference_mel": dict(mel=mel, reference_mel=ref),
            "speaker_only": dict(mel=mel, speaker_emb=spk),
            "both_embeddings": dict(mel=mel, speaker_emb=spk, emotion_emb=emo)}[form]


def _run_both(config, jdt, tdt, params, kwargs, extractor):
    """The JAX vocoder (mrf_backend "xla", jitted) and the port on the same
    parameters and call; returns (port outputs, JAX outputs) as fp32 numpy."""
    jm = jvoc.ModifiedVocoder(jgen.GeneratorConfig(**config, mrf_backend="xla"), dtype=jdt, **extractor)
    want = jax.jit(jm.apply)(params, **kwargs)
    tm = tvoc.ModifiedVocoder(tgen.GeneratorConfig(**config), dtype=tdt, gen=_gen(), **extractor)
    load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(**{k: torch.from_numpy(v) for k, v in kwargs.items()})
    assert got.keys() == want.keys() == set(OUTPUTS)
    return ({k: got[k].float().numpy() for k in OUTPUTS},
            {k: np.asarray(want[k], np.float32) for k in OUTPUTS})


def _tiny_params(jdt):
    mel = np.zeros((1, TINY["input_channels"], 8), np.float32)
    jm = jvoc.ModifiedVocoder(jgen.GeneratorConfig(**TINY), dtype=jdt, **TINY_EXTRACTOR)
    return _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), mel), 3)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("form", CALL_FORMS)
def test_tiny_vocoder_matches_jax(form, dtype):
    """``TINY`` with the tiny extractor, 2 × 16 content frames and 2 × 21
    reference frames, in each call form.  fp32: 2e-3.  bf16: 4 bf16 ulps of
    JAX's peak for each output (as ``test_bf16_generator_matches_jax_bf16``):
    both compute in bf16 with fp32 sums, rounding in other places."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    kwargs = _call_args(form, 21, 2, TINY["input_channels"], 16, 21)
    got, want = _run_both(TINY, jdt, tdt, _tiny_params(jdt), kwargs, TINY_EXTRACTOR)
    assert got["waveform"].shape == (2, 1, 16 * 8)
    assert np.isfinite(got["waveform"]).all() and 0.005 < got["waveform"].std()
    for name in OUTPUTS:
        tol = 2e-3 if dtype == "fp32" else 4 * 2.0 ** -8 * float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=0 if dtype == "bf16" else 2e-3, atol=tol,
                                   err_msg=name)
    for name, given in (("speaker_embedding", "speaker_emb"), ("emotion_embedding", "emotion_emb")):
        if given in kwargs:
            np.testing.assert_array_equal(got[name], kwargs[given])


def test_reference_mel_conditions_the_waveform():
    """The cloning API reads ``reference_mel``, not ``mel``, when given one:
    the port with a reference equals the port given the reference's
    embeddings, and differs from the port conditioned on ``mel`` itself.
    (Under ``_randomise`` the extractor's biases swamp its input, so the
    embeddings of two clips differ only a little; the check is exact.)"""
    kwargs = _call_args("reference_mel", 22, 2, TINY["input_channels"], 16, 21)
    tm = tvoc.ModifiedVocoder(tgen.GeneratorConfig(**TINY), gen=_gen(), **TINY_EXTRACTOR)
    load_jax_params(tm, _tiny_params(jnp.float32))
    mel, ref = (torch.from_numpy(kwargs[k]) for k in ("mel", "reference_mel"))
    with torch.no_grad():
        cloned = tm(mel, reference_mel=ref)
        spk, emo = tm.embedding_extractor(ref)
        given = tm(mel, spk, emo)
        own = tm(mel)
    for name in OUTPUTS:
        assert torch.equal(cloned[name], given[name]), name
        assert not torch.equal(cloned[name], own[name]), name


def test_train_config_vocoder_matches_jax():
    """``TrainConfig()`` widths (``GeneratorConfig()``, ECAPA 512 → 192,
    Emotion2Vec d 512 × 6 layers × 8 heads → 256) in fp32, 1 × 8 content
    frames cloned from 1 × 12 reference frames; atol 1e-4, rtol 1e-3 (as
    ``test_default_config_generator_matches_jax``)."""
    kwargs = _call_args("reference_mel", 23, 1, 80, 8, 12)
    jm = jvoc.ModifiedVocoder(jgen.GeneratorConfig(mrf_backend="xla"))
    params = _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), kwargs["mel"]), 3)
    got, want = _run_both({}, jnp.float32, torch.float32, params, kwargs, {})
    assert got["waveform"].shape == (1, 1, 8 * 256)
    assert np.isfinite(got["waveform"]).all() and 10 * 1e-4 < got["waveform"].std()  # varies by 10× the atol
    for name in OUTPUTS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3, atol=1e-4, err_msg=name)


def _flat_shapes(tree):
    return {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]}


@pytest.mark.parametrize("size", ["tiny", "train_config"])
def test_parameter_names_and_shapes_match_jax_tree(size):
    config, extractor = (TINY, TINY_EXTRACTOR) if size == "tiny" else ({}, {})
    mel = np.zeros((1, config.get("input_channels", 80), 8), np.float32)
    jm = jvoc.ModifiedVocoder(jgen.GeneratorConfig(**config), **extractor)
    want = _flat_shapes(jax.eval_shape(jm.init, jax.random.PRNGKey(0), mel))
    tm = tvoc.ModifiedVocoder(tgen.GeneratorConfig(**config), gen=_gen(), **extractor)
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == want


def test_load_rejects_a_mismatched_vocoder_tree():
    """A leaf missing, a leaf the port lacks, or a leaf of another shape
    raises, and leaves the module's parameters as they were."""
    tm = tvoc.ModifiedVocoder(tgen.GeneratorConfig(**TINY), gen=_gen(), **TINY_EXTRACTOR)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tree = _randomise(jax.eval_shape(
        jvoc.ModifiedVocoder(jgen.GeneratorConfig(**TINY), **TINY_EXTRACTOR).init,
        jax.random.PRNGKey(0), np.zeros((1, 16, 8), np.float32)), 4)["params"]
    ecapa = tree["embedding_extractor"]["ecapa"]
    with pytest.raises(KeyError, match="res2_kernel_7"):
        load_jax_params(tm, {**tree, "embedding_extractor": {
            **tree["embedding_extractor"], "ecapa": {**ecapa, "block_2": {
                k: v for k, v in ecapa["block_2"].items() if k != "res2_kernel_7"}}}})
    with pytest.raises(KeyError, match="classifier"):
        load_jax_params(tm, {**tree, "embedding_extractor": {
            **tree["embedding_extractor"], "ecapa": {**ecapa, "classifier": {"kernel": np.zeros((24, 3))}}}})
    with pytest.raises(ValueError, match="stem_kernel"):
        load_jax_params(tm, {**tree, "embedding_extractor": {
            **tree["embedding_extractor"], "ecapa": {**ecapa, "stem_kernel": np.zeros((3, 16, 32))}}})
    for n, p in tm.named_parameters():
        assert torch.equal(p, before[n]), n


def test_build_vocoder_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hifigan_tpu_torch.build_vocoder()


def test_build_vocoder_on_cpu_clones_a_voice():
    """``build_vocoder`` at ``TINY`` with the tiny extractor, on the CPU,
    in bf16: the cloning call gives a finite waveform and unit embeddings."""
    model = hifigan_tpu_torch.build_vocoder(tgen.GeneratorConfig(**TINY), device="cpu", **TINY_EXTRACTOR)
    assert model.generator.dtype == torch.bfloat16
    mel, ref = (torch.from_numpy(a) for a in _inputs(24, (2, 16, 16), (2, 16, 40)))
    with torch.no_grad():
        out = model(mel, reference_mel=ref)
    assert out["waveform"].shape == (2, 1, 16 * 8) and bool(torch.isfinite(out["waveform"]).all())
    for name, dim in (("speaker_embedding", 192), ("emotion_embedding", 256)):
        assert out[name].shape == (2, dim)
        torch.testing.assert_close(out[name].norm(dim=-1), torch.ones(2), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def trained():
    """``runs/cloning/220000`` restored once through the JAX package
    (``TrainConfig()``, the template ``cli.py``'s cloning eval restores
    into, shapes only), and a content and a reference mel made as the
    cloning probe makes them: two speakers' ``FormantSpeechCorpus``
    utterances through JAX ``audio_to_mel``."""
    if not (CHECKPOINT / "default").is_dir():
        pytest.skip(f"the trained checkpoint {CHECKPOINT.relative_to(ROOT)} is missing")
    from hifigan_tpu.train import TrainConfig, create_train_state
    from hifigan_tpu.train.checkpoint import CheckpointManager
    from hifigan_tpu.train.corpus import FormantSpeechCorpus
    from hifigan_tpu.train.train_step import audio_to_mel

    cfg = TrainConfig()
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding),
        jax.eval_shape(lambda: create_train_state(jax.random.PRNGKey(0), cfg, mel_frames=32, batch_size=1)[0]))
    mgr = CheckpointManager(str(CHECKPOINT.parent))
    try:
        state = mgr.restore(template, step=int(CHECKPOINT.name))
    finally:
        mgr.close()
    hop = cfg.mel.hop_length
    corpus = FormantSpeechCorpus(n_speakers=8)
    mels = [np.array(audio_to_mel(jnp.asarray(corpus.utterance(spk, 0)[4096: 4096 + frames * hop][None]), cfg))
            for spk, frames in ((0, 24), (5, 36))]
    return cfg, state.gen_params, mels


def test_trained_cloning_vocoder_matches_jax(trained):
    """The trained ``runs/cloning/220000`` weights (38.3 M parameters) in
    fp32: speaker 0's content (24 frames) in speaker 5's voice (a 36-frame
    reference), port against JAX; atol 1e-4, rtol 1e-3.  Trained LayerNorm
    scales and attention weights are where a wrong epsilon or variance
    formula shows."""
    cfg, params, (content, reference) = trained
    kwargs = dict(mel=content, reference_mel=reference)
    got, want = _run_both({}, jnp.float32, torch.float32, params, kwargs, {})
    assert got["waveform"].shape == (1, 1, 24 * cfg.generator.upsample_ratio)
    assert np.isfinite(got["waveform"]).all() and 0.005 < got["waveform"].std()
    for name in OUTPUTS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3, atol=1e-4, err_msg=name)
