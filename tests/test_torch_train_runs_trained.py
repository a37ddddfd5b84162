"""The trained S2ST run in the port's trainer against JAX's on the CPU,
fp32: the train state of ``runs/s2st3/60002`` restored once through the
JAX package's ``CheckpointManager`` into a ``create_s2st_state`` template
(as JAX's ``cmd_eval_s2st`` restores it) and carried into the port by
``load_jax_s2st_state``, AdamW moments and count included; then one train
step in both packages on the same draws, and the offline greedy decode of
the first 8 held-out utterances (``cli train-s2st --eval_samples``'s set).
``test_torch_unit_vocoder_trained.py`` does the same for
``runs/unit_vocoder/16000``.  Skips, naming the path, if the checkpoint is
missing."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_s2st_train import _jax_draw
from test_torch_s2st_trained import _restore

from hifigan_tpu_torch.train import s2st_task as ttask
from hifigan_tpu_torch.weights import load_jax_s2st_state, load_streamspeech_config

ROOT = Path(__file__).resolve().parents[1]
S2ST = ROOT / "runs" / "s2st3" / "60002"
HELD_OUT = 8  # utterances decoded
UPDATE_TOL = 0.2  # of the step's learning rate, elementwise


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _need(path: Path):
    if not (path / "default").is_dir():
        pytest.skip(f"the trained checkpoint {path.relative_to(ROOT)} is missing")


@pytest.fixture(scope="module")
def s2st():
    """JAX's restored S2ST train state (numpy), model, optimiser and task."""
    _need(S2ST)
    from hifigan_tpu.cli import _load_streamspeech_config
    from hifigan_tpu.models.streamspeech import StreamSpeechConfig as JConfig
    from hifigan_tpu.train import s2st_task as jtask

    jcfg = _load_streamspeech_config(str(S2ST.parent / "streamspeech_config.json"), JConfig)
    task = jtask.S2STTaskConfig(batch_size=2)
    made = {}

    def template():  # traced by eval_shape: JAX's init is not compiled
        state, made["model"], made["tx"] = jtask.create_s2st_state(jax.random.PRNGKey(0), jcfg, task)
        return state

    state = jax.tree_util.tree_map(np.asarray, _restore(S2ST, template))
    model, tx = made["model"], made["tx"]
    return dict(state=state, model=model, tx=tx, task=task)


def _port(s2st):
    """A port state loaded from JAX's restored one."""
    cfg = load_streamspeech_config(str(S2ST.parent / "streamspeech_config.json"))
    return load_jax_s2st_state(ttask.create_s2st_state(cfg, ttask.S2STTaskConfig(batch_size=2), device="cpu"),
                               s2st["state"])


def _assert_updates(module, before: dict, want: dict, lr: float, what: str) -> float:
    """Every parameter's value after the step within UPDATE_TOL · lr of
    JAX's (elementwise); returns the worst error as a share of lr."""
    worst = 0.0
    for name, p in module.named_parameters():
        err = float(np.abs(p.detach().numpy() - want[name]).max())
        moved = float(np.abs(want[name] - before[name]).max())
        assert err <= UPDATE_TOL * lr, f"{what} {name}: {err:.3g} from JAX's update (lr {lr:.3g}, moved {moved:.3g})"
        worst = max(worst, err / lr)
    return worst


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


def test_trained_s2st_step_matches_jax(s2st):
    """One step at batch 2 from step 60002 on the draws JAX makes from its
    key (over a 4-utterance bank): the loss and its terms within 1e-3
    relative, every updated parameter within 0.2·lr of JAX's; the step and
    the update count (60000 in the checkpoint: its optimiser counted two
    steps fewer than the trainer) one more."""
    from hifigan_tpu.train import s2st_task as jtask

    task = s2st["task"]
    bank = jtask.build_s2st_bank(jtask.S2STTaskConfig(n_utterances=4), idx_offset=1_000_000)
    key = jax.random.PRNGKey(3)
    step = jtask.make_s2st_train_step(s2st["model"], s2st["tx"], task, {k: jnp.asarray(v) for k, v in bank.items()})
    new, want = step(jax.tree_util.tree_map(jnp.asarray, s2st["state"]), key)
    port = _port(s2st)
    count = int(s2st["state"].opt_state[1][0].count)
    assert port.step == 60002 and port.opt.count == count == 60000
    before = {n: p.detach().numpy().copy() for n, p in port.model.named_parameters()}
    lr = ttask.s2st_learning_rate(ttask.S2STTaskConfig(), port.opt.count)
    port, got = ttask.make_s2st_train_step(ttask.S2STTaskConfig(batch_size=2), {
        k: torch.from_numpy(v) for k, v in bank.items()})(port, _jax_draw(key, task, 4))
    for k in want:
        print(f"[trained s2st step] {k}: port {float(got[k]):.6g} jax {float(want[k]):.6g}")
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    worst = _assert_updates(port.model, before, dict(_flat(jax.device_get(new.params)["params"])), lr, "s2st")
    print(f"[trained s2st step] lr {lr:.4g}, worst update error {worst:.3g} of lr")
    assert port.step == 60003 and port.opt.count == count + 1


def test_trained_greedy_decode_matches_jax(s2st):
    """The offline greedy decode of the first 8 held-out utterances
    (``idx_offset`` 1,000,000): each utterance's tokens equal JAX's, and
    ``evaluate_token_f1`` equal to JAX's."""
    from hifigan_tpu.models.streamspeech import StreamSpeechS2ST as JStreamSpeech
    from hifigan_tpu.train import s2st_task as jtask

    held = jtask.build_s2st_bank(jtask.S2STTaskConfig(n_utterances=HELD_OUT), idx_offset=1_000_000)
    params = jax.tree_util.tree_map(jnp.asarray, s2st["state"].params)
    jmodel = JStreamSpeech(s2st["model"].config)
    task = jtask.S2STTaskConfig()
    runs = []
    real = jtask.make_greedy_translate

    def recorded(*a, **kw):  # JAX's evaluate_token_f1, its decoded tokens kept
        run = real(*a, **kw)
        return lambda *x: runs.append(np.asarray(run(*x))) or runs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtask, "make_greedy_translate", recorded)
        jf1 = jtask.evaluate_token_f1(jmodel, params, task, held)
    want = np.concatenate(runs)
    model = _port(s2st).model.eval()
    ttask_cfg = ttask.S2STTaskConfig()
    got = ttask.make_greedy_translate(model, ttask_cfg)(torch.from_numpy(held["audio"]),
                                                         torch.from_numpy(held["n_frames"])).numpy()
    differ = [i for i in range(HELD_OUT) if not np.array_equal(got[i], want[i])]
    assert not differ, f"utterances {differ} decode differently"
    tf1 = ttask.evaluate_token_f1(model, ttask_cfg, held)
    print(f"[trained greedy] JAX {jf1}, port {tf1}")
    assert tf1 == jf1 and tf1["n"] == HELD_OUT and tf1["token_f1"] > 0.5
