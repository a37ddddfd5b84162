"""One train step from the trained ``runs/cloning/220000`` state, in JAX and
in the port, fp32 on the CPU.

The whole JAX ``GanTrainState`` (generator + extractor, discriminators,
both optax Adam states at update count 220000) is restored through the JAX
package's ``CheckpointManager`` and carried into the port by
``load_jax_train_state``.  Both take one step of ``TrainConfig()`` on the
same 1 × 4096 samples of the formant corpus; the losses and the updated
parameters of every model must agree.  From a fresh state Adam's first
step is lr·sign(g) for every element, so a near-zero gradient of either
sign moves a parameter by 2·lr between the two for no fault; with the
trained moments an element's step is a smooth function of its gradient,
except where the gradient is zero but for rounding (``ZERO_GRADIENT``)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu_torch.train import TrainConfig, create_train_state, make_train_step
from hifigan_tpu_torch.train.state import learning_rate
from hifigan_tpu_torch.weights import load_jax_train_state

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / "runs" / "cloning" / "220000"
SEGMENT = 4096


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


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


@pytest.fixture(scope="module")
def steps():
    """The restored state, the batch, and the state after one JAX step and
    after one port step (as numpy), with both steps' metrics."""
    if not (CHECKPOINT / "default").is_dir():
        pytest.skip(f"the trained checkpoint {CHECKPOINT.relative_to(ROOT)} is missing")
    from hifigan_tpu.models.discriminators import Discriminators
    from hifigan_tpu.models.vocoder import ModifiedVocoder
    from hifigan_tpu.train import TrainConfig as JaxTrainConfig
    from hifigan_tpu.train import create_train_state as jax_create_train_state
    from hifigan_tpu.train import make_train_step as jax_step
    from hifigan_tpu.train.checkpoint import CheckpointManager
    from hifigan_tpu.train.corpus import FormantSpeechCorpus

    cfg = JaxTrainConfig()
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding),
        jax.eval_shape(lambda: jax_create_train_state(jax.random.PRNGKey(0), cfg, mel_frames=32, batch_size=1)[0]))
    mgr = CheckpointManager(str(CHECKPOINT.parent))
    try:
        restored = mgr.restore(template, step=int(CHECKPOINT.name))
    finally:
        mgr.close()
    audio = np.asarray(FormantSpeechCorpus(n_speakers=8).utterance(3, 0)[4096: 4096 + SEGMENT], np.float32)[None]

    vocoder = ModifiedVocoder(cfg.generator, ecapa_channels=cfg.ecapa_channels, emo_hidden=cfg.emo_hidden,
                              emo_layers=cfg.emo_layers, emo_heads=cfg.emo_heads)
    new, jax_metrics = jax_step(vocoder, Discriminators(), cfg, donate=False)(restored, {"audio": jnp.asarray(audio)})
    before = jax.tree_util.tree_map(np.asarray, restored)
    after = jax.tree_util.tree_map(np.asarray, new)

    state = load_jax_train_state(create_train_state(TrainConfig(), device="cpu"), before)
    state, metrics = make_train_step(TrainConfig())(state, {"audio": audio})
    return before, after, state, {k: float(v) for k, v in jax_metrics.items()}, {k: float(v) for k, v in metrics.items()}


def test_trained_state_carries_over(steps):
    """``load_jax_train_state`` sets the step and both optimisers' counts to
    the checkpoint's 220000."""
    before, _, state, _, _ = steps
    assert int(before.step) == 220000
    assert state.step == 220001 and state.gen_opt.count == state.disc_opt.count == 220001


def test_trained_step_losses_match_jax(steps):
    """Every loss of the step within 1e-4 relative (found: at most 2.1e-6,
    the feature-matching loss)."""
    _, _, _, want, got = steps
    assert got.keys() == want.keys()
    assert all(np.isfinite(v) for v in got.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# Leaves whose gradient is zero but for rounding: a bias added before a
# softmax over the axis it is constant along (ECAPA's attentive pooling over
# time, the key projections' bias over keys).  With trained moments of
# rounding noise, Adam turns their noise into a step of up to about 2·lr in
# JAX and in the port alike.
ZERO_GRADIENT = ("embedding_extractor.ecapa.asp.att2.bias", ".mha.k.bias")


@pytest.mark.parametrize("model,tree", [("vocoder", "gen_params"), ("discriminators", "disc_params")])
def test_trained_step_updates_match_jax(steps, model, tree):
    """Every updated parameter within 0.2·lr of JAX's, lr = 1.776e-4 the
    schedule's at update 220000: a tenth of the largest step Adam takes
    here (about 2·lr, where this batch's gradient is large against the
    trained second moment).  Found: 0.086·lr (1.53e-5), in
    ``mpd.period_11.conv_3_kernel``.  The ZERO_GRADIENT leaves move by at
    most 3·lr in both."""
    before, after, state, _, _ = steps
    lr = learning_rate(TrainConfig(), int(before.step))
    old, new = dict(_flat(getattr(before, tree)["params"])), dict(_flat(getattr(after, tree)["params"]))
    moved = 0
    for name, p in getattr(state, model).named_parameters():
        got = p.detach().numpy()
        moved += bool((new[name] != old[name]).any())
        if name.endswith(ZERO_GRADIENT):
            assert max(np.abs(got - old[name]).max(), np.abs(new[name] - old[name]).max()) <= 3 * lr, name
        else:
            np.testing.assert_allclose(got, new[name], rtol=0, atol=0.2 * lr, err_msg=name)
    assert moved > 0.9 * len(old)
