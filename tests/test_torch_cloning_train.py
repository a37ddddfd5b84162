"""Voice-cloning training, the port against the JAX package on the CPU,
fp32, at the ``--tiny`` config: the parallel banks (bit for bit) and the
port's cache, the port's pair sampler, one cloning step against JAX's
``make_cloning_train_step`` on the pair JAX's sampler drew with the step's
key (plain, the rendition-cosine identity term, the centroid hinge, and the
conditioning-only fine-tune), ``cli train-clone --tiny`` with
``--init_from`` and ``--resume``, and the encoder graft's shape check.

The generator and discriminators are redrawn by ``_randomise``, the
extractor and the judge are the initialisers' draw moved by ``jitter``
(PERF.md §6).  The config has a 10-step warmup, so a fresh state's first
update has learning rate 0: both packages differentiate the generator's
loss against the same discriminators, and JAX's gradient is its new first
moment over 1 − β1 = 0.2.  ``test_torch_cloning_identity.py`` holds the
centroid hinge and the fine-tune on this file's setup.  Two inputs are
kept out of the gradient checks, each for a reason in both packages alike:

- A reference crop in a row's zero padding (JAX's sampler draws the
  reference's offset over the bank's width, not the clip's length): the
  extractor then normalises a constant mel by its 1e-5 floor, and its
  gradient is rounding noise.  The tests take the first key from 11 on
  whose crops all carry signal.
- The multi-resolution STFT loss: its log-magnitude term divides by |X| at
  the formant clips' near-empty bins, so its gradient amplifies FFT
  rounding.  PR 8's train-step test holds it on broadband audio at 1e-3,
  and ``test_torch_cloning_trained.py`` holds train-clone's default
  weights, the STFT term included, from trained moments."""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_encoder_pretrain import _adam, _flat, _locate, assert_grads_match
from test_torch_generator import _randomise
from test_torch_s2st import jitter
from test_torch_train_step import _configs, _nested

from hifigan_tpu.models import discriminators as jdisc
from hifigan_tpu.models import vocoder as jvoc
from hifigan_tpu.models.embeddings import EcapaTdnn as JEcapa
from hifigan_tpu.train import cloning as jcl
from hifigan_tpu.train import state as jstate
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.models.embeddings import EcapaTdnn
from hifigan_tpu_torch.train import cloning as tcl
from hifigan_tpu_torch.train import state as tstate
from hifigan_tpu_torch.train.checkpoint import CheckpointManager
from hifigan_tpu_torch.weights import load_jax_params, load_jax_train_state

SPEAKERS, CONTENTS, SEGMENT, BATCH = 4, 2, 256, 2
LOSS_RTOL = 1e-4
B1 = 0.8  # TrainConfig().beta1
MODES = {
    "plain": dict(),
    "rendition": dict(identity_weight=1.0),
    "centroid_hinge": dict(identity_weight=1.0, centroids=True),
    "identity_finetune": dict(identity_weight=1.0, centroids=True, identity_finetune=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def banks():
    return jcl.build_cloning_banks(n_speakers=SPEAKERS, n_contents=CONTENTS)


def _with_signal(sampler, banks):
    """The first key from 11 on whose input, target and reference crops all
    peak above 0.05, and JAX's batch for it (numpy)."""
    for seed in range(11, 200):
        key = jax.random.PRNGKey(seed)
        batch = jax.tree_util.tree_map(np.asarray, sampler(key, *(jnp.asarray(b) for b in banks[:2])))
        if min(np.abs(batch[k]).max(-1).min() for k in ("input", "target", "ref")) > 0.05:
            return key, batch
    raise AssertionError("no key with signal in every crop")


def _tiny_jax_state(tcfg):
    """A JAX ``GanTrainState`` (numpy) at the tiny config with fresh
    optimisers: the generator and the discriminators redrawn by
    ``_randomise``, the extractor the initialisers' draw (the port's seeded
    draw of the same initialisers, in flax's tree) moved by ``jitter``."""
    port = tstate.create_train_state(tcfg, device="cpu", seed=0)
    gen_params = _randomise(_nested(port.vocoder), 3)
    gen_params["params"]["embedding_extractor"] = jitter(_nested(port.vocoder)["params"]["embedding_extractor"], 4)
    disc_params = _randomise(_nested(port.discriminators), 4)
    tx = jstate.make_optimizer(replace(jstate.TrainConfig(), warmup_steps=tcfg.warmup_steps,
                                       decay_steps=tcfg.decay_steps))
    return jax.tree_util.tree_map(np.asarray, jstate.GanTrainState(
        step=np.zeros((), np.int32), gen_params=gen_params, disc_params=disc_params,
        gen_opt_state=tx.init(gen_params), disc_opt_state=tx.init(disc_params)))


@pytest.fixture(scope="module")
def setup(banks):
    """The tiny configs (10-step warmup; train-clone's loss weights without
    the STFT term), JAX's state (numpy), the judges and the centroids, the
    pair sampler, a key with signal and its batch."""
    jcfg, tcfg = (replace(c, warmup_steps=10) for c in _configs())
    state = _tiny_jax_state(tcfg)
    judge = JEcapa(n_mels=16, channels=32)
    port_judge = EcapaTdnn(16, 32, gen=torch.Generator().manual_seed(7))
    judge_params = jitter(_nested(port_judge), 8)
    load_jax_params(port_judge, judge_params).eval().requires_grad_(False)
    cents = np.random.default_rng(1).standard_normal((SPEAKERS, 192)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=-1, keepdims=True)
    sampler = jcl.make_pair_sampler(jnp.asarray(banks[2]), SEGMENT, SEGMENT, BATCH)
    key, batch = _with_signal(sampler, banks)
    return dict(jcfg=jcfg, tcfg=tcfg, state=state, judge=lambda mel: judge.apply(judge_params, mel),
                port_judge=port_judge, cents=cents, sampler=sampler, key=key, batch=batch, jax_runs={})


def _jax_step(setup, mode):
    m = MODES[mode]
    jcfg = setup["jcfg"]
    vocoder = jvoc.ModifiedVocoder(jcfg.generator, ecapa_channels=jcfg.ecapa_channels, emo_hidden=jcfg.emo_hidden,
                                   emo_layers=jcfg.emo_layers, emo_heads=jcfg.emo_heads)
    kw = dict(identity_fn=setup["judge"], identity_weight=m["identity_weight"]) if m.get("identity_weight") else {}
    if m.get("centroids"):
        kw["identity_centroids"] = jnp.asarray(setup["cents"])
    return jcl.make_cloning_train_step(vocoder, jdisc.Discriminators(), jcfg, setup["sampler"],
                                       identity_finetune=m.get("identity_finetune", False), **kw)


def _port_step(setup, mode, cfg=None):
    m = MODES[mode]
    kw = dict(identity_fn=setup["port_judge"], identity_weight=m["identity_weight"]) if m.get("identity_weight") else {}
    if m.get("centroids"):
        kw["identity_centroids"] = torch.from_numpy(setup["cents"])
    return tcl.make_cloning_train_step(cfg or setup["tcfg"], identity_finetune=m.get("identity_finetune", False),
                                       **kw)


def _fresh_jax_run(setup, banks, mode):
    """JAX's step of ``mode`` from the fresh state, run once a module."""
    if mode not in setup["jax_runs"]:
        setup["jax_runs"][mode] = _run_jax(_jax_step(setup, mode), setup["state"], setup, banks)
    return setup["jax_runs"][mode]


def _run_jax(step, state, setup, banks):
    new, metrics = step(jax.tree_util.tree_map(jnp.asarray, state), setup["key"], jnp.asarray(banks[0]),
                        jnp.asarray(banks[1]))
    return jax.tree_util.tree_map(np.asarray, new), {k: float(v) for k, v in metrics.items()}


def _assert_losses(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_banks_and_cache_match_jax(banks, tmp_path, monkeypatch):
    """``build_cloning_banks`` equals JAX's bit for bit; the port's cache
    (its own file name, in ``$HIFIGAN_TPU_CACHE``) returns the saved banks
    for the same key and re-renders for a stale one; its key hashes the
    port's corpus module, not the JAX package's."""
    got = tcl.build_cloning_banks(n_speakers=SPEAKERS, n_contents=CONTENTS)
    for g, w in zip(got, banks):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    monkeypatch.setenv("HIFIGAN_TPU_CACHE", str(tmp_path))
    path = tcl.default_cache_path()
    assert path == str(tmp_path / "cloning_bank_torch.npz") and tcl.CACHE_NAME != "cloning_bank.npz"
    tcl.build_cloning_banks(n_speakers=SPEAKERS, n_contents=CONTENTS, cache_path=path)
    z = dict(np.load(path))
    assert list(z["cache_key"]) == [tcl._corpus_rev(), tcl.CONTENT_KEY_BASE, tcl.REF_KEY_BASE, SPEAKERS, CONTENTS, 128]
    assert tcl._corpus_rev() != jcl._corpus_rev()
    np.savez(path, **{**z, "content_bank": z["content_bank"] + 1})
    cached = tcl.build_cloning_banks(n_speakers=SPEAKERS, n_contents=CONTENTS, cache_path=path)
    assert np.array_equal(cached[0], banks[0] + 1)  # the cache is read when its key matches
    np.savez(path, **{**z, "content_bank": z["content_bank"] + 1, "cache_key": z["cache_key"] + 1})
    fresh = tcl.build_cloning_banks(n_speakers=SPEAKERS, n_contents=CONTENTS, cache_path=path)
    assert np.array_equal(fresh[0], banks[0]) and np.array_equal(np.load(path)["cache_key"], z["cache_key"])


def test_pair_sampler_pairs_one_content_and_offset(banks):
    """The port's sampler (a ``torch.Generator``): ``input`` and ``target``
    are one content at one offset, rendered by speakers A and B, with
    ``tgt_spk`` = B; ``ref`` is a crop of B's reference clip for that
    content at an offset within ``max(L_ref − ref, 1)``, the bank's width
    (JAX's rule: it may fall in the row's padding)."""
    content, ref, lengths = banks
    sample = tcl.make_pair_sampler(torch.from_numpy(lengths), SEGMENT, 2 * SEGMENT, 16)
    out = sample(torch.Generator().manual_seed(0), torch.from_numpy(content), torch.from_numpy(ref))
    assert out["input"].shape == out["target"].shape == (16, SEGMENT) and out["ref"].shape == (16, 2 * SEGMENT)
    rows = content.reshape(-1, content.shape[-1])
    for i in range(16):
        inp, tgt, b = out["input"][i].numpy(), out["target"][i].numpy(), int(out["tgt_spk"][i])
        if np.abs(inp).max() == 0 or np.abs(tgt).max() == 0:
            continue
        where_in = {(r % CONTENTS, off) for r, off in _locate(rows, inp)}
        where_tgt = {(r % CONTENTS, off) for r, off in _locate(rows, tgt) if r // CONTENTS == b}
        shared = {(c, off) for c, off in where_in & where_tgt if off < max(lengths[c] - SEGMENT, 1)}
        assert shared, f"row {i}: input and target are not one content at one offset"
        r = out["ref"][i].numpy()
        if np.abs(r).max() > 0:
            hits = {(c, off) for c, off in _locate(ref[b], r) if off < max(ref.shape[-1] - 2 * SEGMENT, 1)}
            assert {c for c, _ in hits} & {c for c, _ in shared}, f"row {i}: the reference is not B's for the content"


@pytest.mark.parametrize("mode", ["plain", "rendition"])
def test_cloning_step_matches_jax(setup, banks, mode):
    """One step from a fresh state on JAX's pair, plain and with the
    rendition-cosine identity term: every loss (and ``identity_cos``)
    within LOSS_RTOL relative; the generator's (extractor
    included) and the discriminators' gradients within 1e-4 of each leaf's
    max |g| plus 1e-7 of the model's (the named near-zero leaves within
    1e-6 of the model's).  The judge takes no gradient."""
    check_step(setup, banks, mode)


def check_step(setup, banks, mode):
    new, want = _fresh_jax_run(setup, banks, mode)
    state = load_jax_train_state(tstate.create_train_state(setup["tcfg"], device="cpu"), setup["state"])
    state, got = _port_step(setup, mode)(state, setup["batch"])
    _assert_losses(got, want)
    assert ("identity_loss" in got) == (mode != "plain")
    for module, opt in ((state.vocoder, new.gen_opt_state), (state.discriminators, new.disc_opt_state)):
        assert_grads_match(module, {k: v / (1 - B1) for k, v in _flat(_adam(opt).mu["params"])})
    assert all(p.grad is None for p in setup["port_judge"].parameters())


def test_cli_train_clone_tiny_init_from_and_resume(tmp_path, monkeypatch):
    """``cli train-clone --tiny --device cpu``: a first run of 2 steps, a
    second warm-started from it with ``--init_from`` (JAX's whole-state
    restore under ``--tiny``: it continues at step 2) to step 3, and a
    ``--resume`` of the second to step 4.  ``metrics.jsonl`` holds one row a
    step with JAX's step metrics (train-clone's default STFT term included,
    no probe under ``--tiny``), finite; the files are ``<step>.pt``.  The
    banks are rendered once for the three runs."""
    rendered = tcl.build_cloning_banks(n_speakers=4, n_contents=8)
    monkeypatch.setattr(tcl, "build_cloning_banks", lambda **kw: rendered)
    args = ["train-clone", "--tiny", "--device", "cpu", "--batch_size", "2", "--log_every", "1"]
    first, second = str(tmp_path / "first"), str(tmp_path / "second")
    cli.main([*args, "--max_steps", "2", "--checkpoint_dir", first])
    cli.main([*args, "--max_steps", "3", "--init_from", first, "--checkpoint_dir", second])
    cli.main([*args, "--max_steps", "4", "--resume", "--checkpoint_dir", second])
    rows = [json.loads(line) for line in (tmp_path / "second" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [3, 4]
    want = {"generator_loss", "discriminator_loss", "adv_loss", "fm_loss", "mel_loss", "stft_loss", "step", "wall_s"}
    assert all(set(r) == want and all(np.isfinite(v) for v in r.values()) for r in rows)
    assert CheckpointManager(second).all_steps() == [3, 4] and CheckpointManager(first).all_steps() == [2]


def test_graft_shape_mismatch_exits(tmp_path):
    """``--encoders`` whose widths differ from the extractor's exits with
    JAX's message (here: ``EncoderTrainConfig()``'s judge encoders into the
    ``--tiny`` extractor, as JAX's ``--tiny --encoders`` always does)."""
    from hifigan_tpu_torch.train.encoder_pretrain import EncoderTrainConfig, build_models
    from hifigan_tpu_torch.weights import save_encoder_checkpoint

    path = str(tmp_path / "encoders.pt")
    cfg = EncoderTrainConfig()
    save_encoder_checkpoint(path, cfg, *build_models(cfg, gen=torch.Generator().manual_seed(0)))
    with pytest.raises(SystemExit, match="encoder graft shape mismatch for 'ecapa': facade extractor and checkpoint"):
        cli.main(["train-clone", "--tiny", "--device", "cpu", "--encoders", path, "--max_steps", "1",
                  "--checkpoint_dir", str(tmp_path / "run")])


def test_train_package_reexports_the_losses():
    """``hifigan_tpu_torch.train`` exports the JAX package's public names,
    the four loss functions among them."""
    import hifigan_tpu.train as jtrain
    import hifigan_tpu_torch.train as ttrain

    assert set(jtrain.__all__) <= set(ttrain.__all__)
    for name in ("discriminator_loss", "generator_adversarial_loss", "feature_matching_loss", "mel_l1_loss"):
        assert getattr(ttrain, name) is getattr(__import__("hifigan_tpu_torch.train.losses", fromlist=[name]), name)


def test_cloning_multi_steps_equal_sequential_steps(banks):
    """``multi_steps=2`` with a ``torch.Generator`` draws the same two pairs
    as two single steps with a generator of the same seed, leaves the same
    parameters (to 1e-6) and returns the two steps' mean metrics."""
    _, tcfg = _configs()
    content, ref, lengths = (torch.from_numpy(b) for b in banks)
    sampler = tcl.make_pair_sampler(lengths, SEGMENT, SEGMENT, BATCH)
    fused, single = (tstate.create_train_state(tcfg, device="cpu", seed=2) for _ in range(2))
    _, m2 = tcl.make_cloning_train_step(tcfg, sampler, multi_steps=2)(fused, torch.Generator().manual_seed(5),
                                                                        content, ref)
    gen, step = torch.Generator().manual_seed(5), tcl.make_cloning_train_step(tcfg, sampler)
    ms = [step(single, gen, content, ref)[1] for _ in range(2)]
    assert fused.step == single.step == 2 and fused.gen_opt.count == single.gen_opt.count == 2
    for model in ("vocoder", "discriminators"):
        want = dict(getattr(single, model).named_parameters())
        for name, p in getattr(fused, model).named_parameters():
            torch.testing.assert_close(p, want[name], rtol=0, atol=1e-6)
    for k in m2:
        np.testing.assert_allclose(float(m2[k]), (float(ms[0][k]) + float(ms[1][k])) / 2, rtol=1e-5)
