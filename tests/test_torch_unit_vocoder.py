"""Unit-vocoder training, the port against the JAX package on the CPU,
fp32: ``translate_plan`` and ``plan_units_durations`` on the corpus's
plans, the bank (bit for bit) on JAX's own test task
(``tests/test_unit_vocoder.py``), the window gather's clamp, one train step
against JAX's ``make_unit_vocoder_train_step`` on the windows JAX's sampler
drew with the step's key, the fused steps, the port's sampler and ``cli
train-unit-vocoder --tiny`` against JAX's, with a resume.

The ``CodeVocoder`` and the discriminators are redrawn by ``_randomise``.
The train config has a 10-step warmup, so a fresh state's first update has
learning rate 0 and both packages differentiate the generator's loss
against the same discriminators; JAX's gradients are its new first moments
over 1 − β1 = 0.2.  The STFT term is weighted 0 here: its log-magnitude
term divides by |X| at near-empty bins, and the masked real audio is zero
past its valid samples, so its gradient amplifies FFT rounding (as in
``test_torch_cloning_train.py``); ``test_torch_unit_vocoder_trained.py``
keeps JAX's CLI weights, the STFT term included."""

import inspect
import json
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_encoder_pretrain import _adam, _flat, assert_grads_match
from test_torch_generator import _randomise
from test_torch_train_step import _nested

from hifigan_tpu.models.code_vocoder import CodeVocoder as JCodeVocoder
from hifigan_tpu.models.code_vocoder import CodeVocoderConfig as JCodeConfig
from hifigan_tpu.models.discriminators import Discriminators as JDiscriminators
from hifigan_tpu.ops.stft import MelConfig as JMelConfig
from hifigan_tpu.train import losses as jloss
from hifigan_tpu.train import state as jstate
from hifigan_tpu.train import unit_vocoder as juv
from hifigan_tpu.train.corpus import FormantSpeechCorpus as JCorpus
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.models.code_vocoder import CodeVocoderConfig
from hifigan_tpu_torch.ops.stft import MelConfig
from hifigan_tpu_torch.train import losses as tloss
from hifigan_tpu_torch.train import state as tstate
from hifigan_tpu_torch.train import unit_vocoder as tuv
from hifigan_tpu_torch.weights import load_jax_unit_vocoder_state

# tests/test_unit_vocoder.py's _tiny_task
TASK = dict(n_utterances=4, n_speakers=2, max_units=64, window_units=8, batch_size=2)
CODE = dict(unit_vocab_size=32, embed_dim=16, upsample_factors=(4, 2), hidden_channels=32, max_duration_per_unit=4)
MEL = dict(n_fft=64, hop_length=16, win_length=64, n_mels=16)
TRAIN = dict(warmup_steps=10, decay_steps=100)
LOSS_RTOL = 1e-4
B1 = 0.8  # TrainConfig().beta1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tasks():
    return (juv.UnitVocoderTaskConfig(**TASK, code=JCodeConfig(**CODE)),
            tuv.UnitVocoderTaskConfig(**TASK, code=CodeVocoderConfig(**CODE)))


def _train_cfgs(**loss):
    """Both packages' train configs: JAX's test's mel and feature-matching
    weight, the STFT term off unless ``loss`` says otherwise."""
    loss = {"feature_matching": 2.0, "multi_res_stft": 0.0, **loss}
    return (jstate.TrainConfig(mel=JMelConfig(**MEL), loss_weights=jloss.LossWeights(**loss), **TRAIN),
            tstate.TrainConfig(mel=MelConfig(**MEL), loss_weights=tloss.LossWeights(**loss), **TRAIN))


@pytest.fixture(scope="module")
def bank():
    return juv.build_unit_vocoder_bank(_tasks()[0])


def _t_bank(bank):
    return {k: torch.from_numpy(v) for k, v in bank.items()}


def test_task_helpers_match_jax():
    """``translate_plan`` and ``plan_units_durations`` (at the default 16 ms
    frames and the tiny task's 2 ms) equal JAX's on eight corpus plans;
    ``upsample_ratio`` and the task config's derived sizes equal."""
    corpus = JCorpus(n_speakers=4)
    jt, tt = _tasks()
    for content in range(8):
        _w, plan, _ar = corpus.utterance(content % 4, 0, content=juv.UNIT_PLAN_KEY_BASE + content, return_plan=True)
        want = juv.translate_plan(plan)
        assert tuv.translate_plan(plan) == want
        for max_dur, frame_s in ((16, juv.FRAME_SECONDS), (4, jt.frame_seconds)):
            got_u, got_d = tuv.plan_units_durations(want, max_dur, frame_s)
            want_u, want_d = juv.plan_units_durations(want, max_dur, frame_s)
            assert np.array_equal(got_u, want_u) and np.array_equal(got_d, want_d)
            assert got_u.dtype == want_u.dtype and got_d.dtype == want_d.dtype
    for j, t in ((jt, tt), (juv.UnitVocoderTaskConfig(), tuv.UnitVocoderTaskConfig())):
        assert (t.frame_samples, t.frame_seconds, t.window_samples) == (j.frame_samples, j.frame_seconds,
                                                                         j.window_samples)
        assert tuv.upsample_ratio(t.code) == juv.upsample_ratio(j.code)
        assert asdict(t.code) == asdict(j.code)


def test_bank_is_jax_bit_for_bit(bank):
    """``build_unit_vocoder_bank`` on JAX's test task: units, durs, cumdur,
    counts and wav equal to JAX's in dtype and value."""
    got = tuv.build_unit_vocoder_bank(_tasks()[1])
    assert sorted(got) == sorted(bank)
    for k in bank:
        assert got[k].dtype == bank[k].dtype and np.array_equal(got[k], bank[k]), k


def test_window_gather_clamps_as_dynamic_slice(bank):
    """``gather_windows`` on the bank's last row, its audio cut to 1,600
    samples so that the audio start can overrun: at a drawn start (no clamp
    needed), at the last start a count allows, and at starts past the row's
    units and samples (both clamped), each window equals JAX's
    ``lax.dynamic_slice`` of the same start."""
    _, task = _tasks()
    cut = dict(bank, wav=bank["wav"][:, :1600].copy())
    row = cut["units"].shape[0] - 1
    Uw, Sw, fs = task.window_units, task.window_samples, task.frame_samples
    U, S = cut["units"].shape[1], cut["wav"].shape[1]
    starts = [0, int(cut["counts"][row]) - Uw, U - 2, U]
    got = tuv.gather_windows(_t_bank(cut), torch.full((len(starts),), row), torch.tensor(starts), task)
    for i, s in enumerate(starts):
        want_u = jax.lax.dynamic_slice(jnp.asarray(cut["units"][row]), (s,), (Uw,))
        want_d = jax.lax.dynamic_slice(jnp.asarray(cut["durs"][row]), (s,), (Uw,))
        start = jnp.asarray(cut["cumdur"])[row, s] * fs
        want_a = jax.lax.dynamic_slice(jnp.asarray(cut["wav"][row]), (start,), (Sw,))
        assert np.array_equal(got["units"][i].numpy(), np.asarray(want_u)), s
        assert np.array_equal(got["durs"][i].numpy(), np.asarray(want_d)), s
        assert np.array_equal(got["audio"][i].numpy(), np.asarray(want_a)), s
    # the last two starts needed both clamps, the first two neither
    assert all(s > U - Uw and cut["cumdur"][row, s] * fs > S - Sw for s in starts[2:])
    assert all(s <= U - Uw and cut["cumdur"][row, s] * fs <= S - Sw for s in starts[:2])


def _jax_setup(bank, **loss):
    """JAX's tiny state redrawn by ``_randomise`` with fresh optimisers
    (numpy), its step and its sampler."""
    jtask, task = _tasks()
    jcfg, tcfg = _train_cfgs(**loss)
    port = tuv.create_unit_vocoder_state(tcfg, task, device="cpu")  # JAX's tree, without compiling its init
    gen_params, disc_params = _randomise(_nested(port.vocoder), 3), _randomise(_nested(port.discriminators), 4)
    tx = jstate.make_optimizer(jcfg)
    state = jstate.GanTrainState(step=np.zeros((), np.int32), gen_params=gen_params, disc_params=disc_params,
                                 gen_opt_state=tx.init(gen_params), disc_opt_state=tx.init(disc_params))
    step = juv.make_unit_vocoder_train_step(JCodeVocoder(jtask.code), JDiscriminators(), jcfg, jtask)
    sample = inspect.getclosurevars(step.__wrapped__).nonlocals["sample"]
    return jax.tree_util.tree_map(np.asarray, state), step, sample


def _port_state(jax_state, **loss):
    _, tcfg = _train_cfgs(**loss)
    _, task = _tasks()
    state = tuv.create_unit_vocoder_state(tcfg, task, device="cpu")
    return load_jax_unit_vocoder_state(state, jax_state), tcfg, task


@pytest.fixture(scope="module")
def jax_run(bank):
    """JAX's step from the redrawn state with key 5: the windows its
    sampler drew, its metrics and its gradients (``mu / 0.2``)."""
    jax_state, step, sample = _jax_setup(bank)
    key = jax.random.PRNGKey(5)
    jbank = {k: jnp.asarray(v) for k, v in bank.items()}
    batch = {k: np.array(v) for k, v in sample(key, jbank).items()}
    new, metrics = step(jax.tree_util.tree_map(jnp.asarray, jax_state), key, jbank)
    grads = {name: {k: v / (1 - B1) for k, v in _flat(jax.device_get(_adam(opt).mu)["params"])}
             for name, opt in (("gen", new.gen_opt_state), ("disc", new.disc_opt_state))}
    return {"state": jax_state, "batch": batch, "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads}


def test_unit_vocoder_step_matches_jax(bank, jax_run):
    """One step on the windows JAX's sampler drew: every metric within
    LOSS_RTOL relative of JAX's; the ``CodeVocoder``'s and the
    discriminators' gradients within 1e-4 of each leaf's max |g| plus 1e-7
    of the model's; both update counts 1."""
    state, tcfg, task = _port_state(jax_run["state"])
    state, got = tuv.make_unit_vocoder_train_step(tcfg, task)(state, jax_run["batch"])
    want = jax_run["metrics"]
    assert sorted(got) == sorted(want) and "stft_loss" not in got
    for k in want:
        print(f"[unit vocoder step] {k}: port {float(got[k]):.7g} jax {want[k]:.7g}")
        np.testing.assert_allclose(float(got[k]), want[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for module, name in ((state.vocoder, "gen"), (state.discriminators, "disc")):
        worst = assert_grads_match(module, jax_run["grads"][name])
        print(f"[unit vocoder step] {name} worst gradient error {worst:.3g} of its leaf's peak")
    assert state.step == 1 and state.gen_opt.count == state.disc_opt.count == 1


def test_fused_steps_equal_sequential_steps(bank, jax_run):
    """``multi_steps=2`` on two drawn batches: the state of two sequential
    steps bit for bit and the metrics the two steps' means (JAX's
    ``lax.scan`` + ``tree_map(mean)``); with a generator, each fused step
    draws its own windows."""
    second = {k: v[::-1].copy() for k, v in jax_run["batch"].items()}
    fused, tcfg, task = _port_state(jax_run["state"])
    fused, got = tuv.make_unit_vocoder_train_step(tcfg, task, multi_steps=2)(fused, [jax_run["batch"], second])
    seq, _, _ = _port_state(jax_run["state"])
    step = tuv.make_unit_vocoder_train_step(tcfg, task)
    rows = [step(seq, b)[1] for b in (jax_run["batch"], second)]
    assert fused.step == seq.step == 2
    for k in got:
        np.testing.assert_allclose(float(got[k]), (float(rows[0][k]) + float(rows[1][k])) / 2, rtol=1e-6, err_msg=k)
    for a, b in ((fused.vocoder, seq.vocoder), (fused.discriminators, seq.discriminators)):
        for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), n
    state, _ = tuv.make_unit_vocoder_train_step(tcfg, task, multi_steps=2)(fused, torch.Generator().manual_seed(1),
                                                                           _t_bank(bank))
    assert state.step == 4


def test_port_sampler_draws_valid_windows(bank):
    """The port's own sampler (a ``torch.Generator``, not JAX's bits): each
    window is the units and durations of a bank row from a start within
    ``max(count − Uw, 1)``, and its audio starts at that unit's first
    sample."""
    _, task = _tasks()
    task = replace(task, batch_size=64)
    out = tuv.make_unit_vocoder_sampler(task)(torch.Generator().manual_seed(0), _t_bank(bank))
    Uw, Sw, fs = task.window_units, task.window_samples, task.frame_samples
    assert out["units"].shape == (64, Uw) and out["audio"].shape == (64, Sw)
    seen = set()
    for u, d, a in zip(out["units"].numpy(), out["durs"].numpy(), out["audio"].numpy()):
        hits = [(r, s) for r in range(bank["units"].shape[0]) for s in range(max(int(bank["counts"][r]) - Uw, 1))
                if np.array_equal(bank["units"][r, s:s + Uw], u) and np.array_equal(bank["durs"][r, s:s + Uw], d)
                and np.array_equal(bank["wav"][r, bank["cumdur"][r, s] * fs:][:Sw], a)]
        assert hits
        seen.add(hits[0][0])
    assert seen == set(range(bank["units"].shape[0]))


def test_cli_train_unit_vocoder_matches_jax_and_resumes(tmp_path):
    """``cli train-unit-vocoder --tiny --device cpu`` and JAX's ``--tiny``
    (JAX's CLI loss weights, the STFT term included): ``metrics.jsonl`` has
    JAX's keys and steps, ``code_config.json`` equals JAX's; the port writes
    ``<step>.pt``; ``--resume`` continues from step 2 to 3 and keeps the
    rows."""
    from hifigan_tpu import cli as jcli

    args = ["train-unit-vocoder", "--tiny", "--log_every", "1"]
    jcli.main(["--cpu", *args, "--max_steps", "2", "--checkpoint_dir", str(tmp_path / "jax")])
    cli.main([*args, "--device", "cpu", "--max_steps", "2", "--checkpoint_dir", str(tmp_path / "port")])
    cli.main([*args, "--device", "cpu", "--max_steps", "3", "--resume", "--checkpoint_dir", str(tmp_path / "port")])
    read = lambda d: [json.loads(line) for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]  # noqa: E731
    jrows, rows = read("jax"), read("port")
    assert [r["step"] for r in jrows] == [1, 2] and [r["step"] for r in rows] == [1, 2, 3]
    assert all(set(r) == set(jrows[0]) for r in rows) and "stft_loss" in jrows[0]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert (json.loads((tmp_path / "port" / "code_config.json").read_text())
            == json.loads((tmp_path / "jax" / "code_config.json").read_text()))
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["2.pt", "3.pt", "code_config.json",
                                                                      "metrics.jsonl"]
