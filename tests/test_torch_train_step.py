"""The port's GAN training path against the JAX package's on the CPU, fp32:
every loss in both adversarial types, the warmup-cosine schedule against
optax's, the port's optimiser against optax's update (Adam, AdamW,
clipping), and one train step at the ``--tiny`` config (``cli.py``) from
JAX parameters and a fresh JAX optimiser state carried over by
``load_jax_train_state``: both phases' losses and every parameter's
gradient against ``jax.value_and_grad`` of the same loss, composed below
from the JAX package's public functions.

The generator phase is differentiated against the port's updated
discriminators (carried back to JAX): a first Adam step from a fresh state
is about lr·sign(g), so the two updated discriminators differ by up to
2·lr wherever a gradient is near zero, for no fault."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_generator import TINY, _randomise
from test_torch_vocoder import TINY_EXTRACTOR

from hifigan_tpu.models import discriminators as jdisc
from hifigan_tpu.models import generator as jgen
from hifigan_tpu.models import vocoder as jvoc
from hifigan_tpu.ops import stft as jstft
from hifigan_tpu.train import losses as jloss
from hifigan_tpu.train import state as jstate
from hifigan_tpu.train.train_step import audio_to_mel as jax_audio_to_mel
from hifigan_tpu_torch.models.generator import GeneratorConfig
from hifigan_tpu_torch.ops.stft import MelConfig
from hifigan_tpu_torch.train import losses as tloss
from hifigan_tpu_torch.train import state as tstate
from hifigan_tpu_torch.train.train_step import make_train_step
from hifigan_tpu_torch.weights import load_jax_train_state

TINY_MEL = dict(n_fft=32, hop_length=8, win_length=32, n_mels=16)
TINY_TRAIN = dict(warmup_steps=0, decay_steps=1000, **TINY_EXTRACTOR)  # cli.py --tiny


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


def _outputs(seed, shapes):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


HEAD_SHAPES = [(2, 3, 7, 1), (2, 40, 1), (2, 5, 9, 1)]


@pytest.mark.parametrize("kind", ["lsgan", "hinge"])
def test_adversarial_losses_match_jax(kind):
    """The generator's adversarial loss and the discriminator loss, values
    (rtol 1e-6, atol 1e-7: the hinge loss is a sum of signed means) and
    gradients w.r.t. every head output (atol 1e-7)."""
    real, fake = _outputs(1, HEAD_SHAPES), _outputs(2, HEAD_SHAPES)
    want_g, want_gg = jax.value_and_grad(lambda f: jloss.generator_adversarial_loss(f, kind))(fake)
    want_d, want_dg = jax.value_and_grad(lambda r, f: jloss.discriminator_loss(r, f, kind), argnums=(0, 1))(real, fake)
    tr = [torch.tensor(a, requires_grad=True) for a in real]
    tf = [torch.tensor(a, requires_grad=True) for a in fake]
    got_g = tloss.generator_adversarial_loss(tf, kind)
    grads_g = torch.autograd.grad(got_g, tf)
    got_d = tloss.discriminator_loss(tr, tf, kind)
    grads_d = torch.autograd.grad(got_d, tr + tf)
    np.testing.assert_allclose(float(got_g.detach()), float(want_g), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got_d.detach()), float(want_d), rtol=1e-6, atol=1e-7)
    for got, want in zip(list(grads_g) + list(grads_d), list(want_gg) + list(want_dg[0]) + list(want_dg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)


@pytest.mark.parametrize("deep", [False, True], ids=["final_outputs", "deep"])
def test_feature_matching_and_mel_losses_match_jax(deep):
    """Feature matching on final outputs and on nested per-layer features:
    value (rtol 1e-6), gradient w.r.t. the fake side (atol 1e-7) and none
    w.r.t. the real side (``stop_gradient`` there, ``detach`` here); mel L1."""
    real, fake = _outputs(3, HEAD_SHAPES * 2), _outputs(4, HEAD_SHAPES * 2)
    nest = (lambda xs: [xs[:3], xs[3:]]) if deep else (lambda xs: xs)
    want, (want_rg, want_fg) = jax.value_and_grad(
        lambda r, f: jloss.feature_matching_loss(nest(r), nest(f)), argnums=(0, 1))(real, fake)
    tr = [torch.tensor(a, requires_grad=True) for a in real]
    tf = [torch.tensor(a, requires_grad=True) for a in fake]
    got = tloss.feature_matching_loss(nest(tr), nest(tf))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert all(t.grad is None for t in tr) and all(not np.asarray(g).any() for g in want_rg)
    for t, g in zip(tf, want_fg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=1e-7)
    a, b = _outputs(5, [(2, 16, 9), (2, 16, 9)])
    np.testing.assert_allclose(float(tloss.mel_l1_loss(torch.tensor(a), torch.tensor(b))),
                               float(jloss.mel_l1_loss(a, b)), rtol=1e-6)


@pytest.mark.parametrize("warmup,decay", [(2000, 1_000_000), (10, 100), (0, 1000)])
def test_schedule_matches_optax(warmup, decay):
    """``learning_rate`` against ``optax.warmup_cosine_decay_schedule(0, lr,
    warmup, decay, lr / 100)`` at counts 0, warmup − 1, warmup, mid-decay,
    decay and beyond; rtol 1e-6 (optax computes in fp32)."""
    cfg = tstate.TrainConfig(warmup_steps=warmup, decay_steps=decay)
    sched = optax.warmup_cosine_decay_schedule(0.0, cfg.learning_rate, warmup, decay, cfg.learning_rate * 0.01)
    counts = sorted({0, max(warmup - 1, 0), warmup, (warmup + decay) // 2, decay, decay + 7, 3 * decay})
    for c in counts:
        np.testing.assert_allclose(tstate.learning_rate(cfg, c), float(sched(c)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {c}")
    assert tstate.learning_rate(cfg, 0) == (0.0 if warmup else cfg.learning_rate)


@pytest.mark.parametrize("opt", [dict(), dict(weight_decay=0.05), dict(grad_clip=0.5), dict(grad_clip=1e3)],
                         ids=["adam", "adamw", "clipped", "clip_not_reached"])
def test_optimizer_matches_optax(opt):
    """The port's ``ScheduledAdam`` and the JAX package's optax chain on the
    same parameters and the same three rounds of gradients (lr 1e-2 through
    a 2-step warmup): parameters after each update within 2 fp32 ulps of
    optax's plus 1e-8 (1e-6 of the lr: the two round ``p − lr·m̂/(√v̂ +
    eps)`` in another order), and the Adam moments within 1e-6 relative."""
    cfg = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10, **opt)
    tx = jstate.make_optimizer(jstate.TrainConfig(**cfg))
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    params = {k: v for k, v in zip(shapes, _outputs(6, shapes.values()))}
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    topt = tstate.make_optimizer(tparams.values(), tstate.TrainConfig(**cfg))
    jparams, jopt = params, tx.init(params)
    for r in range(3):
        grads = {k: v for k, v in zip(shapes, _outputs(10 + r, shapes.values()))}
        updates, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        topt.step()
        for k, p in tparams.items():
            want = np.asarray(jparams[k])
            err = np.abs(p.detach().numpy() - want)
            assert (err <= 2 * np.spacing(np.abs(want)) + 1e-8).all(), f"round {r} {k}: max err {err.max():.3g}"
    adam = next(s for s in jax.tree_util.tree_leaves(jopt, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    assert topt.count == int(adam.count) == 3
    for k, p in tparams.items():
        st = topt.adam.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-9)


def _configs(**loss):
    """The tiny training config of both packages, with loss weights ``loss``."""
    jcfg = jstate.TrainConfig(generator=jgen.GeneratorConfig(**TINY, mrf_backend="xla"),
                              mel=jstft.MelConfig(**TINY_MEL), loss_weights=jloss.LossWeights(**loss), **TINY_TRAIN)
    tcfg = tstate.TrainConfig(generator=GeneratorConfig(**TINY), mel=MelConfig(**TINY_MEL),
                              loss_weights=tloss.LossWeights(**loss), **TINY_TRAIN)
    return jcfg, tcfg


def _jax_state(jcfg, seed, batch, frames):
    """A JAX train state at ``jcfg`` with every parameter leaf redrawn by
    ``_randomise`` and fresh optimiser states, as numpy."""
    state, _, _ = jstate.create_train_state(jax.random.PRNGKey(0), jcfg, mel_frames=frames, batch_size=batch)
    gen_params, disc_params = _randomise(state.gen_params, seed), _randomise(state.disc_params, seed + 1)
    tx = jstate.make_optimizer(jcfg)
    state = state.replace(gen_params=gen_params, disc_params=disc_params,
                          gen_opt_state=tx.init(gen_params), disc_opt_state=tx.init(disc_params))
    return jax.tree_util.tree_map(np.asarray, state)


def _jax_losses(jcfg, deep_fm):
    """The JAX train step's two losses as functions of the parameters,
    composed from the JAX package's public modules and losses."""
    vocoder = jvoc.ModifiedVocoder(jcfg.generator, ecapa_channels=jcfg.ecapa_channels, emo_hidden=jcfg.emo_hidden,
                                   emo_layers=jcfg.emo_layers, emo_heads=jcfg.emo_heads)
    discs = jdisc.Discriminators()
    w = jcfg.loss_weights

    def heads(out, key):
        return out[f"mpd_{key}"] + out[f"msd_{key}"]

    def d_loss(disc_params, fake, real):
        return jloss.discriminator_loss(heads(discs.apply(disc_params, real), "outputs"),
                                        heads(discs.apply(disc_params, fake), "outputs"), w.adversarial_type)

    def g_loss(gen_params, disc_params, mel, real):
        fake = vocoder.apply(gen_params, mel)["waveform"][:, 0, :]
        out_real, out_fake = discs.apply(disc_params, real), discs.apply(disc_params, fake)
        adv = jloss.generator_adversarial_loss(heads(out_fake, "outputs"), w.adversarial_type)
        key = "features" if deep_fm else "outputs"
        fm = jloss.feature_matching_loss(heads(out_real, key), heads(out_fake, key))
        mel_loss = jloss.mel_l1_loss(jax_audio_to_mel(fake, jcfg), mel)
        total = w.adversarial * adv + w.feature_matching * fm + w.mel * mel_loss
        aux = {"adv_loss": adv, "fm_loss": fm, "mel_loss": mel_loss}
        if w.multi_res_stft > 0:
            aux["stft_loss"] = jstft.multi_resolution_stft_loss(fake, real)
            total = total + w.multi_res_stft * aux["stft_loss"]
        return total, (aux, fake)

    return d_loss, g_loss


def _nested(module):
    """``module``'s parameters as a flax-style nested dict of numpy arrays."""
    tree = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().numpy().copy()
    return {"params": tree}


def _assert_grads_close(module, want_tree, frac):
    """Every parameter's ``.grad`` within ``frac`` of its leaf's max |g| plus
    1e-6 of the module's max |g| (for leaves whose gradient is zero but for
    rounding, such as attention's key bias under the softmax); returns the
    worst error as a share of its tolerance."""
    want = dict(_flat(want_tree["params"]))
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    worst = 0.0
    for name, p in module.named_parameters():
        w = np.asarray(want[name])
        scale = np.abs(w).max()
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - w).max()
        tol = frac * scale + 1e-6 * top
        assert err <= tol, f"{name}: max err {err:.3g} > {tol:.3g} (leaf max {scale:.3g})"
        worst = max(worst, err / tol)
    return worst


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


@pytest.fixture(scope="module")
def jax_state():
    """The JAX tiny train state the train-step tests start from (the loss
    weights play no part in it)."""
    return _jax_state(_configs()[0], seed=3, batch=2, frames=256 // TINY_MEL["hop_length"])


@pytest.mark.parametrize("loss,deep_fm", [(dict(), False), (dict(multi_res_stft=1.0), True)],
                         ids=["final_output_fm", "deep_fm_and_stft"])
def test_tiny_train_step_matches_jax(jax_state, loss, deep_fm):
    """One step of ``make_train_step`` at the tiny config from JAX's state
    (every leaf redrawn, fresh Adam) on 2 × 256 samples of seeded audio:
    the discriminator loss, the generator loss and its parts within 1e-5
    relative, and every parameter's gradient (D's from phase 2, G's —
    generator and extractor — from phase 3) within 1e-3 of its leaf's max
    |g| plus 1e-6 of the model's, against ``jax.value_and_grad`` of the
    same losses (G's against the port's updated discriminators).  Worst
    error found: 0.74 of that tolerance (the generator's first GRC block,
    where the mel L1's sign flips at near-equal bins)."""
    jcfg, tcfg = _configs(**loss)
    batch, n = 2, 256
    audio = (0.5 * np.tanh(np.random.default_rng(9).standard_normal((batch, n)))).astype(np.float32)

    state = load_jax_train_state(tstate.create_train_state(tcfg, device="cpu"), jax_state)
    state, metrics = make_train_step(tcfg, deep_feature_matching=deep_fm)(state, {"audio": audio})
    assert state.step == 1 and state.gen_opt.count == state.disc_opt.count == 1

    d_loss_fn, g_loss_fn = _jax_losses(jcfg, deep_fm)
    mel = jax_audio_to_mel(jnp.asarray(audio), jcfg)
    fake = jvoc.ModifiedVocoder(jcfg.generator, ecapa_channels=jcfg.ecapa_channels, emo_hidden=jcfg.emo_hidden,
                                emo_layers=jcfg.emo_layers, emo_heads=jcfg.emo_heads).apply(
        jax_state.gen_params, mel)["waveform"][:, 0, :]
    d_loss, d_grads = jax.jit(jax.value_and_grad(d_loss_fn))(jax_state.disc_params, fake, jnp.asarray(audio))
    updated_discs = _nested(state.discriminators)
    (g_loss, (aux, _)), g_grads = jax.jit(jax.value_and_grad(g_loss_fn, has_aux=True))(
        jax_state.gen_params, updated_discs, mel, jnp.asarray(audio))

    want = {"discriminator_loss": d_loss, "generator_loss": g_loss, **aux}
    assert metrics.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    _assert_grads_close(state.discriminators, d_grads, 1e-3)
    _assert_grads_close(state.vocoder, g_grads, 1e-3)


def test_fresh_state_loads_and_first_update_follows_the_schedule():
    """With a warmup, the first update (count 0) has learning rate 0 and
    leaves every parameter as it was, as optax's does; the second moves
    them."""
    _, tcfg = _configs()
    tcfg = replace(tcfg, warmup_steps=10)
    state = tstate.create_train_state(tcfg, device="cpu", seed=1)
    before = {n: p.detach().clone() for n, p in state.vocoder.named_parameters()}
    audio = np.random.default_rng(2).standard_normal((2, 128)).astype(np.float32) * 0.3
    step = make_train_step(tcfg)
    state, _ = step(state, {"audio": audio})
    assert all(torch.equal(p, before[n]) for n, p in state.vocoder.named_parameters())
    state, _ = step(state, {"audio": audio})
    assert any(not torch.equal(p, before[n]) for n, p in state.vocoder.named_parameters())
