"""Encoder pre-training, the port against the JAX package on the CPU, fp32:
the classifier heads, the labelled bank (bit for bit), ``arousal_bin``, the
Emotion2Vec schedule against optax's, one encoder step against JAX's (with
and without the same-speaker pair term) on the crops JAX's own sampler drew
with the key its step uses, the fused step's averaged metrics, the port's
sampler, and ``cli train-encoders --tiny`` against JAX's, with a resume.

The encoders are the JAX initialisers' draw moved by ``jitter`` (PERF.md
§6: under ``_randomise`` their biases swamp the input).  JAX's step exposes
no gradients; from a fresh Adam state its new first moment is ``(1 − β1)·g``
exactly but for one fp32 rounding, so the gradient JAX applied is ``mu /
0.1``.  JAX's encoder step builds its models at 80 mels, so the tests keep
``MelConfig()`` and JAX ``--tiny``'s 2048-sample crops (8 frames)."""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_s2st import jitter

from hifigan_tpu.models import embeddings as jemb
from hifigan_tpu.train import encoder_pretrain as jenc
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.models import embeddings as temb
from hifigan_tpu_torch.train import encoder_pretrain as tenc
from hifigan_tpu_torch.weights import load_jax_encoder_state, load_jax_params

TINY = dict(n_speakers=4, segment_samples=2048, batch_size=4, ecapa_channels=32, emo_hidden=32, emo_layers=1,
            emo_heads=4, emo_warmup_steps=3)
UTTERANCES = 2  # per speaker, in the tests' labelled bank
GRAD_FRAC, GRAD_FLOOR = 1e-4, 1e-7  # of the leaf's max |g|, of the model's
LOSS_RTOL = 1e-4
# Leaves whose gradient is zero but for rounding: ECAPA's attentive pooling
# adds att2's bias before a softmax over time, along which it is constant;
# attention adds the key bias before a softmax over keys.  They are held to
# ZERO_GRADIENT_FLOOR of the model's max |g| (found: 3e-7 of it).
ZERO_GRADIENT = ("asp.att2.bias", ".mha.k.bias")
ZERO_GRADIENT_FLOOR = 1e-6
ACCURACIES = ("speaker_acc", "emotion_acc", "emotion_acc_near")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bank():
    return jenc.build_labelled_bank(n_speakers=TINY["n_speakers"], utterances_per_speaker=UTTERANCES)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu"))


def assert_grads_match(module, want: dict, frac=GRAD_FRAC, floor=GRAD_FLOOR) -> float:
    """Every parameter's ``.grad`` (None counts as zeros) within ``frac`` of
    its leaf's max |g| plus ``floor`` of the module's (ZERO_GRADIENT leaves: ZERO_GRADIENT_FLOOR of
    the module's); returns the worst error of the others as a share of its
    leaf's max |g|."""
    top = max(np.abs(w).max() for w in want.values())
    worst = 0.0
    for name, p in module.named_parameters():
        w = want[name]
        scale = np.abs(w).max()
        got = np.zeros(w.shape, np.float32) if p.grad is None else p.grad.numpy()  # None: no gradient
        err = np.abs(got - w).max()
        zero = name.endswith(ZERO_GRADIENT)
        tol = ZERO_GRADIENT_FLOOR * top if zero else frac * scale + floor * top
        assert err <= tol, f"{name}: max err {err:.3g} (leaf max {scale:.3g}, model {top:.3g})"
        if not zero:
            worst = max(worst, err / max(scale, 1e-30))
    return worst


def _jax_setup(cfg_kw, bank):
    """JAX's jittered tiny encoder state with fresh optimisers (numpy), its
    step and its sampler."""
    jcfg = jenc.EncoderTrainConfig(**cfg_kw)
    state, ecapa, emo, tx = jenc.create_encoder_state(jax.random.PRNGKey(0), jcfg)
    ep, mp = jitter(state.ecapa_params, 1), jitter(state.emo_params, 2)
    state = state.replace(ecapa_params=ep, emo_params=mp, ecapa_opt=tx.init(ep),
                          emo_opt=jenc.emo_optimizer(jcfg).init(mp))
    step = jenc.make_encoder_train_step(ecapa, emo, jcfg, tx, *(jnp.asarray(a) for a in bank))
    return jax.tree_util.tree_map(np.asarray, state), step, inspect.getclosurevars(step).nonlocals["sample"]


def _drawn(sample, key, bank):
    crops, pair, spk, emo = sample(key, jnp.asarray(bank[0]))
    return {"audio": np.asarray(crops), "pair": None if pair is None else np.asarray(pair),
            "speaker": np.asarray(spk), "arousal_bin": np.asarray(emo)}


def _port_state(cfg_kw, jax_state):
    return load_jax_encoder_state(tenc.create_encoder_state(tenc.EncoderTrainConfig(**cfg_kw), device="cpu"),
                                  jax_state)


def test_labelled_bank_is_jax_bit_for_bit(bank):
    """``build_labelled_bank`` (and with an ``idx_offset``): the audio,
    lengths, speakers and arousal bins equal JAX's exactly; speaker-major."""
    got = tenc.build_labelled_bank(n_speakers=TINY["n_speakers"], utterances_per_speaker=UTTERANCES)
    for g, w in zip(got, bank):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert list(got[2]) == [s for s in range(TINY["n_speakers"]) for _ in range(UTTERANCES)]
    off_j = jenc.build_labelled_bank(n_speakers=2, utterances_per_speaker=1, idx_offset=10_000)
    off_t = tenc.build_labelled_bank(n_speakers=2, utterances_per_speaker=1, idx_offset=10_000)
    assert all(np.array_equal(g, w) for g, w in zip(off_t, off_j))


def test_arousal_bin_matches_jax():
    arousal = np.linspace(0.0, 1.2, 97)
    assert np.array_equal(tenc.arousal_bin(arousal), jenc.arousal_bin(arousal))


@pytest.mark.parametrize("warmup", [500, 3, 0])
def test_emotion_schedule_matches_optax(warmup):
    """``emo_learning_rate`` against optax's ``join_schedules`` of the JAX
    ``emo_optimizer`` at counts 0, 1, warmup − 1, warmup, warmup + 1 (the
    constant from the boundary on); rtol 1e-6."""
    jcfg = jenc.EncoderTrainConfig(emo_warmup_steps=warmup)
    sched = optax.join_schedules([optax.linear_schedule(0.0, jcfg.emo_learning_rate, warmup),
                                  optax.constant_schedule(jcfg.emo_learning_rate)], [warmup])
    cfg = tenc.EncoderTrainConfig(emo_warmup_steps=warmup)
    for count in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1}):
        np.testing.assert_allclose(tenc.emo_learning_rate(cfg, count), float(sched(count)), rtol=1e-6,
                                   err_msg=f"count {count}")
    assert tenc.emo_learning_rate(cfg, warmup) == cfg.emo_learning_rate


def test_classifier_heads_match_jax():
    """ECAPA-TDNN with ``num_speakers`` and Emotion2Vec with
    ``num_emotions`` under ``train=True``: the embeddings, frames and
    logits of the same jittered weights within 1e-5; the heads are the
    ``classifier`` leaves, and ``strip_classifier`` removes exactly them."""
    mel = np.random.default_rng(3).standard_normal((2, 80, 12)).astype(np.float32)
    je = jemb.EcapaTdnn(channels=32, num_speakers=5)
    jm = jemb.Emotion2Vec(hidden_dim=32, num_layers=1, num_heads=4, num_emotions=8)
    ep = jitter(je.init(jax.random.PRNGKey(1), mel, train=True), 4)
    mp = jitter(jm.init(jax.random.PRNGKey(2), mel, train=True), 5)
    gen = torch.Generator().manual_seed(0)
    te = load_jax_params(temb.EcapaTdnn(80, 32, gen=gen, num_speakers=5), ep)
    tm = load_jax_params(temb.Emotion2Vec(80, 32, num_layers=1, num_heads=4, gen=gen, num_emotions=8), mp)
    x = torch.from_numpy(mel)
    with torch.no_grad():
        got = [*te(x, train=True), *tm(x, train=True, return_frames=True), *tm(x, train=True)]
        plain = [te(x), tm(x)]
    want = [*je.apply(ep, mel, train=True), *jm.apply(mp, mel, train=True, return_frames=True),
            *jm.apply(mp, mel, train=True)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain[0].numpy(), got[0].numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(plain[1].numpy(), got[2].numpy(), rtol=0, atol=0)
    for model in (te, tm):
        heads = {k for k in model.state_dict() if k.startswith("classifier.")}
        assert heads == {"classifier.kernel", "classifier.bias"}
        assert set(tenc.strip_classifier(model.state_dict())) == set(model.state_dict()) - heads


@pytest.mark.parametrize("pair_weight", [0.0, 0.5], ids=["aam", "aam_and_pair"])
def test_encoder_step_matches_jax(bank, pair_weight):
    """One step from JAX's jittered state on the crops JAX's sampler drew
    with the step's key: every metric's loss within LOSS_RTOL relative and
    the accuracies equal; both encoders' gradients (from the port's
    ``.grad``; JAX's from its new first moment) within GRAD_FRAC of each
    leaf's max |g| plus GRAD_FLOOR of the model's.  The head's bias is read
    by nothing: it takes no gradient and stays as it was, as JAX's (whose
    gradient is zero) does."""
    kw = dict(TINY, spk_pair_weight=pair_weight)
    jax_state, jstep, sample = _jax_setup(kw, bank)
    key = jax.random.PRNGKey(5)
    batch = _drawn(sample, key, bank)
    assert (batch["pair"] is not None) == (pair_weight > 0)
    new, want = jax.jit(jstep)(jax.tree_util.tree_map(jnp.asarray, jax_state), key)
    state = _port_state(kw, jax_state)
    step = tenc.make_encoder_train_step(tenc.EncoderTrainConfig(**kw), torch.from_numpy(bank[0]), *bank[1:])
    state, got = step(state, batch)
    assert sorted(got) == sorted(want)
    for k in want:
        if k in ACCURACIES:
            assert float(got[k]) == float(want[k]), k
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    if pair_weight == 0:
        assert float(got["speaker_pair_cos"]) == 0.0
    for module, opt in ((state.ecapa, new.ecapa_opt), (state.emo, new.emo_opt)):
        mu = {k: v / (1 - tenc.ADAM_BETAS[0]) for k, v in _flat(jax.device_get(_adam(opt).mu)["params"])}
        assert_grads_match(module, mu)
    bias = state.ecapa.classifier.bias
    assert bias.grad is None
    np.testing.assert_array_equal(bias.detach().numpy(), jax_state.ecapa_params["params"]["classifier"]["bias"])
    assert state.step == 1 and state.ecapa_opt.count == state.emo_opt.count == 1


def test_fused_step_averages_metrics_as_jax(bank):
    """``make_fused_encoder_step(step, 2)`` on the two batches JAX's fused
    step draws from its keys: the window's mean metrics within LOSS_RTOL of
    JAX's ``tree_map(mean)`` (lr 1e-5, so that the first update's lr·sign(g)
    moves the second step's losses by less than that), and the state two
    steps on."""
    kw = dict(TINY, learning_rate=1e-5, spk_pair_weight=0.5)
    jax_state, jstep, sample = _jax_setup(kw, bank)
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    _, want = jenc.make_fused_encoder_step(jstep, 2)(jax.tree_util.tree_map(jnp.asarray, jax_state), keys)
    state = _port_state(kw, jax_state)
    step = tenc.make_encoder_train_step(tenc.EncoderTrainConfig(**kw), torch.from_numpy(bank[0]), *bank[1:])
    state, got = tenc.make_fused_encoder_step(step, 2)(state, [_drawn(sample, k, bank) for k in keys])
    assert sorted(got) == sorted(want) and state.step == 2 and state.emo_opt.count == 2
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


def _locate(audio, crop):
    """The (row, offset) pairs of ``audio`` at which ``crop`` occurs, found
    from a 4-sample window at the crop's loudest sample."""
    j = min(int(np.abs(crop).argmax()), len(crop) - 4)
    hits = []
    for i, row in enumerate(audio):
        windows = np.lib.stride_tricks.sliding_window_view(row, 4)
        for pos in np.flatnonzero((windows == crop[j: j + 4]).all(-1)):
            off = pos - j
            if 0 <= off <= len(row) - len(crop) and np.array_equal(row[off: off + len(crop)], crop):
                hits.append((i, off))
    return hits


def test_port_sampler_draws_labelled_same_speaker_pairs(bank):
    """The port's own sampler (a ``torch.Generator``, not JAX's bits): crops
    of ``segment_samples`` taken at offsets within ``max(length − segment,
    1)`` of their utterance, the labels of that utterance, and each pair a
    crop of another utterance of the same speaker."""
    audio, lengths, speakers, bins = bank
    cfg = tenc.EncoderTrainConfig(**dict(TINY, batch_size=32, spk_pair_weight=1.0))
    sample = tenc.make_encoder_sampler(cfg, *(torch.as_tensor(a) for a in (lengths, speakers, bins)))
    out = sample(torch.Generator().manual_seed(0), torch.from_numpy(audio))
    seg = cfg.segment_samples
    assert out["audio"].shape == out["pair"].shape == (32, seg)
    for crop, pair, spk, emo in zip(out["audio"].numpy(), out["pair"].numpy(), out["speaker"], out["arousal_bin"]):
        rows = {i for i, off in _locate(audio, crop) if off < max(lengths[i] - seg, 1)}
        assert rows and {speakers[i] for i in rows} == {int(spk)} and {bins[i] for i in rows} == {int(emo)}
        pair_rows = {i for i, off in _locate(audio, pair) if off < max(lengths[i] - seg, 1)}
        assert pair_rows and {speakers[i] for i in pair_rows} == {int(spk)} and not pair_rows & rows


def test_cli_train_encoders_matches_jax_keys_and_resumes(tmp_path):
    """``cli train-encoders --tiny --device cpu`` and JAX's ``cli
    train-encoders --tiny`` over 4 speakers × 2 utterances: ``metrics.jsonl``
    has JAX's keys and steps; the port writes ``<step>.pt`` and
    ``encoders.pt`` (read back by ``load_encoder_checkpoint``, heads
    stripped); ``--resume`` continues from step 2 to 3 and keeps the rows."""
    from hifigan_tpu import cli as jcli
    from hifigan_tpu_torch.weights import load_encoder_checkpoint

    args = ["train-encoders", "--tiny", "--n_speakers", "4", "--utterances_per_speaker", "2", "--log_every", "1"]
    jcli.main([*args, "--max_steps", "2", "--checkpoint_dir", str(tmp_path / "jax")])
    cli.main([*args, "--device", "cpu", "--max_steps", "2", "--checkpoint_dir", str(tmp_path / "port")])
    cli.main([*args, "--device", "cpu", "--max_steps", "3", "--resume", "--checkpoint_dir", str(tmp_path / "port")])
    read = lambda d: [json.loads(line) for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]  # noqa: E731
    jrows, rows = read("jax"), read("port")
    assert [r["step"] for r in jrows] == [1, 2] and [r["step"] for r in rows] == [1, 2, 3]
    assert all(set(r) == set(jrows[0]) for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["2.pt", "3.pt", "encoders.pt", "metrics.jsonl"]
    cfg, ecapa, emo, step = load_encoder_checkpoint(str(tmp_path / "port" / "encoders.pt"), "cpu")
    assert step == 3 and cfg == tenc.EncoderTrainConfig(**{k: v for k, v in TINY.items() if k != "emo_warmup_steps"})
    assert ecapa.classifier is None and emo.classifier is None
