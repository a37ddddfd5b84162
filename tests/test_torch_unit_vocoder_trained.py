"""The trained unit-vocoder run in the port's trainer against JAX's on the
CPU, fp32: the train state of ``runs/unit_vocoder/16000`` restored once
through the JAX package's ``CheckpointManager`` into a
``create_unit_vocoder_state`` template (as JAX's ``cmd_eval_s2st`` restores
it) and carried into the port by ``load_jax_unit_vocoder_state``, both Adam
states and counts included; then one train step in both packages on the
window JAX's sampler drew.  A file of its own beside
``test_torch_train_runs_trained.py`` (the S2ST run), so that the two
full-width steps run on separate test workers.  Skips, naming the path, if
the checkpoint is missing."""

import inspect
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_s2st_trained import _restore
from test_torch_train_runs_trained import _assert_updates, _flat

from hifigan_tpu_torch.models.code_vocoder import CodeVocoderConfig
from hifigan_tpu_torch.train import losses as tloss
from hifigan_tpu_torch.train import state as tstate
from hifigan_tpu_torch.train import unit_vocoder as tuv
from hifigan_tpu_torch.weights import load_jax_unit_vocoder_state

ROOT = Path(__file__).resolve().parents[1]
UNIT_VOCODER = ROOT / "runs" / "unit_vocoder" / "16000"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_trained_unit_vocoder_step_matches_jax():
    """One step from step 16000 at batch 1 x 4 units (16,384 samples) with
    JAX's CLI loss weights (``TrainConfig(warmup_steps=1000)``, feature
    matching 2, mel 45, STFT 1) on the window JAX's sampler drew with the
    step's key: every loss within 1e-3 relative, every updated parameter of
    the ``CodeVocoder`` and the discriminators within 0.2·lr of JAX's."""
    if not (UNIT_VOCODER / "default").is_dir():
        pytest.skip(f"the trained checkpoint {UNIT_VOCODER.relative_to(ROOT)} is missing")
    from hifigan_tpu.models.code_vocoder import CodeVocoderConfig as JCodeConfig
    from hifigan_tpu.train import TrainConfig as JTrainConfig
    from hifigan_tpu.train import unit_vocoder as juv
    from hifigan_tpu.train.losses import LossWeights as JLossWeights

    cd = json.loads((UNIT_VOCODER.parent / "code_config.json").read_text())
    cd["upsample_factors"] = tuple(cd["upsample_factors"])
    jtask = juv.UnitVocoderTaskConfig(n_utterances=2, window_units=4, batch_size=1, code=JCodeConfig(**cd))
    jcfg = JTrainConfig(warmup_steps=1000, loss_weights=JLossWeights(feature_matching=2.0, mel=45.0,
                                                                     multi_res_stft=1.0))
    made = {}

    def template():  # traced by eval_shape: JAX's init is not compiled
        state, made["cv"], made["discs"] = juv.create_unit_vocoder_state(jax.random.PRNGKey(0), jcfg, jtask)
        return state

    state = jax.tree_util.tree_map(np.asarray, _restore(UNIT_VOCODER, template))
    cv, discs = made["cv"], made["discs"]
    bank = juv.build_unit_vocoder_bank(jtask)
    jbank = {k: jnp.asarray(v) for k, v in bank.items()}
    step = juv.make_unit_vocoder_train_step(cv, discs, jcfg, jtask)
    key = jax.random.PRNGKey(4)
    batch = {k: np.array(v) for k, v in inspect.getclosurevars(step.__wrapped__).nonlocals["sample"](key, jbank).items()}
    new, want = step(jax.tree_util.tree_map(jnp.asarray, state), key, jbank)

    cd_t = json.loads((UNIT_VOCODER.parent / "code_config.json").read_text())
    task = tuv.UnitVocoderTaskConfig(n_utterances=2, window_units=4, batch_size=1,
                                     code=CodeVocoderConfig(**{**cd_t, "upsample_factors": tuple(cd_t["upsample_factors"])}))
    tcfg = tstate.TrainConfig(warmup_steps=1000, loss_weights=tloss.LossWeights(feature_matching=2.0, mel=45.0,
                                                                                multi_res_stft=1.0))
    port = load_jax_unit_vocoder_state(tuv.create_unit_vocoder_state(tcfg, task, device="cpu"), state)
    assert port.step == 16000 and port.gen_opt.count == port.disc_opt.count == 16000
    before = {m: {n: p.detach().numpy().copy() for n, p in getattr(port, m).named_parameters()}
              for m in ("vocoder", "discriminators")}
    lr = tstate.learning_rate(tcfg, 16000)
    port, got = tuv.make_unit_vocoder_train_step(tcfg, task)(port, batch)
    assert sorted(got) == sorted(want)
    for k in want:
        print(f"[trained unit vocoder step] {k}: port {float(got[k]):.6g} jax {float(want[k]):.6g}")
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    new = jax.device_get(new)
    for m, tree in (("vocoder", new.gen_params), ("discriminators", new.disc_params)):
        worst = _assert_updates(getattr(port, m), before[m], dict(_flat(tree["params"])), lr, m)
        print(f"[trained unit vocoder step] {m}: lr {lr:.4g}, worst update error {worst:.3g} of lr")
    assert port.step == 16001
