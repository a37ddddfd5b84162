"""The app's vocoder route on the trained weights: the JAX package's
``make_vocoder_synth("runs/cloning")`` against the port's
``make_vocoder_synth`` over the same ``runs/cloning/220000`` state
converted into the port's checkpoint file, on the CPU, on one seeded
``[1, 80, 32]`` mel.

- fp32: within the tolerance ``tests/test_torch_generator.py`` holds the
  fp32 generator to at ``GeneratorConfig()`` (atol 1e-4, rtol 1e-3).
- bf16, both packages' default: the port's output no further from JAX's
  fp32 output (which the port's fp32 matches to 1e-4) than JAX's own bf16
  output is, give or take 4 bf16 ulps of the peak, the tolerance
  ``test_bf16_generator_matches_jax_bf16`` holds the two bf16 generators
  to on randomised weights.  On these weights no two bf16 programs agree
  within 4 ulps of each other at the output, JAX's own two MRF routes
  included: ``tests/test_torch_app_vocoder_layers.py`` holds each layer
  of the bf16 generator to JAX's on the same input, and the whole output
  within the spread of JAX's two routes.  ``pytest -s`` prints the
  distances.

JAX's default ``mrf_backend="auto"`` takes the XLA chain here, so the JAX
side runs no Pallas kernel; the port's CPU path is the plain chain step.

The checkpoint is restored once, in the module fixture, into an
``eval_shape`` template of JAX's ``create_train_state`` (shapes only), and
written as the port's ``<step>.pt`` with the trained vocoder and
discriminators and fresh optimisers (what ``make_vocoder_synth`` reads).
JAX's ``make_vocoder_synth`` draws a full-width ``create_train_state``
(about 26 s on an 8-core CPU) only as the template its restore fills; the
fixture hands it the same ``eval_shape`` template, and its own
``CheckpointManager`` restores into that.  The file is its own so that its
JAX compiles run on a worker of their own."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu_torch import TrainConfig, create_train_state
from hifigan_tpu_torch.app.engine import make_vocoder_synth
from hifigan_tpu_torch.train.checkpoint import CheckpointManager
from hifigan_tpu_torch.weights import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / "runs" / "cloning" / "220000"
BF16_ULPS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def restore_jax_state():
    """``(template, state)``: JAX's ``create_train_state(TrainConfig())``
    as an ``eval_shape`` template and ``runs/cloning/220000`` restored into
    it (skips the test if the checkpoint is missing)."""
    if not (CHECKPOINT / "default").is_dir():
        pytest.skip(f"the trained checkpoint {CHECKPOINT.relative_to(ROOT)} is missing")
    import hifigan_tpu.train
    from hifigan_tpu.train.checkpoint import CheckpointManager as JCheckpointManager

    jcfg = hifigan_tpu.train.TrainConfig()
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding),
        jax.eval_shape(lambda: hifigan_tpu.train.create_train_state(jax.random.PRNGKey(0), jcfg, mel_frames=32,
                                                                    batch_size=1)[0]))
    mgr = JCheckpointManager(str(CHECKPOINT.parent))
    try:
        return template, mgr.restore(template, step=int(CHECKPOINT.name))
    finally:
        mgr.close()


def seeded_mel() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((1, 80, 32)).astype(np.float32)


def ulps(a, b, like) -> float:
    """max |a - b| in bf16 ulps of the peak of ``like`` (2⁻⁸·max|like|)."""
    return float(np.abs(a.reshape(-1) - b.reshape(-1)).max()) / (2.0 ** -8 * float(np.abs(like).max()))


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """``{(package, dtype): wav}`` for the seeded mel, fp32 and bf16."""
    import hifigan_tpu.train
    from hifigan_tpu.app.engine import make_vocoder_synth as jmake_vocoder_synth

    template, js = restore_jax_state()
    directory = tmp_path_factory.mktemp("cloning")
    state = create_train_state(TrainConfig(), torch.float32, "cpu")
    load_jax_params(state.vocoder, jax.tree_util.tree_map(np.asarray, js.gen_params))
    load_jax_params(state.discriminators, jax.tree_util.tree_map(np.asarray, js.disc_params))
    state.step = int(js.step)
    CheckpointManager(str(directory)).save(state, force=True)
    del js, state

    mel = seeded_mel()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hifigan_tpu.train, "create_train_state", lambda key, cfg: (template, None, None))
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, None)):
            out["jax", tdt] = np.asarray(jmake_vocoder_synth(str(CHECKPOINT.parent), dtype=jdt)(mel))
            out["port", tdt] = make_vocoder_synth(str(directory), dtype=None if jdt is None else tdt,
                                                  device="cpu")(mel)
    return out


def test_vocoder_route_fp32_matches_jax(outputs):
    got, want = outputs["port", torch.float32], outputs["jax", torch.float32]
    assert got.shape == want.shape == (32 * 256,) and got.dtype == want.dtype == np.float32
    assert np.isfinite(got).all() and 0.005 < got.std()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_vocoder_route_bf16_as_accurate_as_jax_bf16(outputs):
    got, want = outputs["port", torch.bfloat16], outputs["jax", torch.bfloat16]
    ref = outputs["jax", torch.float32]
    assert got.shape == want.shape == (32 * 256,) and got.dtype == np.float32
    assert np.isfinite(got).all() and 0.005 < got.std()
    port_err, jax_err = ulps(got, ref, ref), ulps(want, ref, ref)
    print(f"[bf16 route] bf16 ulps of the fp32 peak from fp32: port {port_err:.2f}, JAX {jax_err:.2f}; "
          f"port vs JAX {ulps(got, want, ref):.2f}")
    assert port_err <= jax_err + BF16_ULPS
