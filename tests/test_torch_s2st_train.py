"""S2ST multitask training, the port against the JAX package on the CPU,
fp32: ``small_config``, the paired bank (bit for bit), the schedule
against optax's, CTC against ``optax.ctc_loss`` (with the infeasible-row
rule), one train step against JAX's ``make_s2st_train_step`` on the draws
JAX's step makes from its key (with and without prefix-masked rows), the
fused steps, the offline greedy decode and ``cli train-s2st --tiny``
against JAX's, with a resume.

The model is ``cli train-s2st --tiny``'s (d 32, one encoder and one
decoder layer) drawn by JAX's initialisers and moved by ``jitter`` (PERF.md
§6: under ``_randomise`` the biases swamp the input and the decoder writes
one token over and over).  JAX's step exposes no gradients; from a fresh
AdamW state its new first moment is ``(1 − β1)·g`` of the clipped gradient,
so the gradient JAX applied is ``mu / 0.1`` (the port's ``.grad`` after a
step is the clipped gradient too).  The schedule's first update has
learning rate 0, so both packages take the second of two fused steps from
the same parameters."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_encoder_pretrain import _adam, _flat
from test_torch_s2st import jitter

from hifigan_tpu.models.streamspeech import StreamSpeechS2ST as JStreamSpeech
from hifigan_tpu.train import s2st_task as jtask
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.train import s2st_task as ttask
from hifigan_tpu_torch.weights import load_jax_params, load_jax_s2st_state

TINY_MODEL = dict(hidden_dim=32, encoder_layers=1, decoder_layers=1, num_heads=4)  # cli train-s2st --tiny
TASK = dict(n_utterances=6, n_speakers=3, batch_size=2)
LOSS_RTOL = 1e-4
ACCURACIES = ("transition_acc", "dec_acc")
SCHEDULE_COUNTS = (0, 1, 499, 500, 501, 199_999, 200_000, 250_000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bank():
    return jtask.build_s2st_bank(jtask.S2STTaskConfig(**TASK))


def _model_cfgs():
    from dataclasses import replace

    return replace(jtask.small_config(), **TINY_MODEL), replace(ttask.small_config(), **TINY_MODEL)


def _jax_setup(bank, task_kw=None):
    """JAX's jittered tiny state with a fresh optimiser (numpy), its model,
    optimiser and task config."""
    jcfg, _ = _model_cfgs()
    task = jtask.S2STTaskConfig(**{**TASK, **(task_kw or {})})
    state, model, tx = jtask.create_s2st_state(jax.random.PRNGKey(0), jcfg, task)
    params = jitter(state.params, 3)
    state = state.replace(params=params, opt_state=tx.init(params))
    return jax.tree_util.tree_map(np.asarray, state), model, tx, task


def _port_state(jax_state, task_kw=None):
    _, tcfg = _model_cfgs()
    task = ttask.S2STTaskConfig(**{**TASK, **(task_kw or {})})
    return load_jax_s2st_state(ttask.create_s2st_state(tcfg, task, device="cpu"), jax_state), task


def _jax_draw(key, task, n_rows):
    """The draws of JAX's ``make_s2st_train_step`` from its step key."""
    k_idx, k_pref, k_cut = jax.random.split(key, 3)
    B = task.batch_size
    return {"idx": np.array(jax.random.randint(k_idx, (B,), 0, n_rows)),
            "use_prefix": np.array(jax.random.bernoulli(k_pref, task.prefix_mask_prob, (B,))),
            "frac": np.array(jax.random.uniform(k_cut, (B,), minval=task.prefix_min_frac, maxval=1.0))}


def _key_with(task, n_rows, prefix: bool):
    """The first key from 1 on whose draw has prefix rows (or none) and two
    different rows."""
    for seed in range(1, 200):
        draw = _jax_draw(jax.random.PRNGKey(seed), task, n_rows)
        if bool(draw["use_prefix"].any()) == prefix and len(set(draw["idx"])) == len(draw["idx"]):
            return jax.random.PRNGKey(seed), draw
    raise AssertionError("no such key")


def _t_bank(bank):
    return {k: torch.from_numpy(v) for k, v in bank.items()}


def test_small_config_matches_jax():
    from dataclasses import asdict

    assert asdict(ttask.small_config()) == asdict(jtask.small_config())
    assert asdict(ttask.small_config(40, 50)) == asdict(jtask.small_config(40, 50))


@pytest.mark.parametrize("kw", [dict(TASK), dict(n_utterances=3, n_speakers=2, idx_offset=1_000_000)],
                         ids=["train", "held_out"])
def test_s2st_bank_is_jax_bit_for_bit(kw, bank):
    """``build_s2st_bank`` on the tests' task and on a held-out slice
    (``idx_offset`` 1,000,000, as ``cli train-s2st --eval_samples`` builds
    it): every array equal to JAX's in dtype and value."""
    kw = dict(kw)
    offset = kw.pop("idx_offset", 0)
    want = bank if offset == 0 else jtask.build_s2st_bank(jtask.S2STTaskConfig(**kw), idx_offset=offset)
    got = ttask.build_s2st_bank(ttask.S2STTaskConfig(**kw), idx_offset=offset)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_schedule_matches_optax():
    """``s2st_learning_rate`` against JAX's ``warmup_cosine_decay_schedule(0,
    lr, 500, 200_000, lr·0.05)`` at the warmup's and the decay's edges and
    past the end: rtol 1e-6 plus one fp32 ulp of lr (optax computes in fp32,
    and at count 1 its ``1 − count / 500`` rounds by 7.6e-6 of the
    value)."""
    cfg = ttask.S2STTaskConfig()
    sched = optax.warmup_cosine_decay_schedule(0.0, cfg.learning_rate, cfg.warmup_steps, 200_000,
                                               cfg.learning_rate * 0.05)
    for count in SCHEDULE_COUNTS:
        np.testing.assert_allclose(ttask.s2st_learning_rate(cfg, count), float(sched(count)), rtol=1e-6,
                                   atol=cfg.learning_rate * 2.0 ** -23, err_msg=f"count {count}")
    assert ttask.s2st_learning_rate(cfg, 0) == 0.0


def _ctc_case():
    """Four rows of 12 frames over 6 classes: labels with repeats, right
    padded; row 3 needs more frames than it has."""
    g = np.random.default_rng(7)
    logits = g.standard_normal((4, 12, 6)).astype(np.float32)
    labels = np.array([[1, 1, 2, 0, 0], [3, 4, 4, 4, 5], [2, 2, 2, 0, 0], [5, 5, 5, 5, 1]], np.int32)
    label_pad = (labels == 0).astype(np.float32)
    frames = np.array([12, 9, 5, 6])
    logit_pad = (np.arange(12)[None, :] >= frames[:, None]).astype(np.float32)
    return logits, logit_pad, labels, label_pad, frames


def test_ctc_matches_optax_on_feasible_rows():
    """``ctc_loss`` on padded rows with repeated labels: each feasible row's
    loss within 1e-5 relative of ``optax.ctc_loss`` and the gradient of
    their sum within 1e-5 of its peak; the rule ``ctc_min_frames`` calls
    row 3 infeasible, where optax's value sits at its log-epsilon scale
    (over 1e4) and the port's is inf."""
    logits, logit_pad, labels, label_pad, frames = _ctc_case()
    want = np.asarray(optax.ctc_loss(logits, logit_pad, labels, label_pad))
    feasible = np.array([ttask.ctc_min_frames(lab[p == 0]) <= f for lab, p, f in zip(labels, label_pad, frames)])
    assert feasible.tolist() == [True, True, True, False]
    got = ttask.ctc_loss(*(torch.from_numpy(a) for a in (logits, logit_pad, labels, label_pad)))
    np.testing.assert_allclose(got.numpy()[feasible], want[feasible], rtol=1e-5)
    assert want[~feasible].min() > 1e4 and bool(torch.isinf(got[~feasible]).all())
    rows = (logits[feasible], logit_pad[feasible], labels[feasible], label_pad[feasible])
    x = torch.from_numpy(rows[0]).requires_grad_(True)
    ttask.ctc_loss(x, *(torch.from_numpy(a) for a in rows[1:])).sum().backward()
    wg = np.asarray(jax.grad(lambda z: optax.ctc_loss(z, *rows[1:]).sum())(rows[0]))
    assert np.abs(x.grad.numpy() - wg).max() <= 1e-5 * np.abs(wg).max()


def test_jax_banks_hold_no_infeasible_ctc_row(bank):
    """Every row of JAX's banks (the tests' task and a 16-utterance
    held-out set as ``cli train-s2st --eval_samples`` draws it) fits each of
    its four CTC losses' frames: source and target tokens in its frames,
    units in 8x as many, the decoder-fed units in 8x its decoder length."""
    held = jtask.build_s2st_bank(jtask.S2STTaskConfig(n_utterances=16), idx_offset=1_000_000)
    for b in (bank, held):
        for i in range(b["n_frames"].shape[0]):
            nf, n_tgt = int(b["n_frames"][i]), int((b["tgt_pad"][i] == 0).sum())
            for key, frames in (("src", nf), ("tgt", nf), ("units", 8 * nf), ("units", 8 * (n_tgt + 1))):
                labels = b[key][i][b[f"{key}_pad"][i] == 0]
                assert ttask.ctc_min_frames(labels) <= frames, (i, key)


@pytest.fixture(scope="module")
def jax_steps(bank):
    """For a key whose draw has prefix-masked rows and one whose draw has
    none: the draw, JAX's metrics and JAX's gradients (``mu / 0.1``), from
    the same jittered state (numpy)."""
    jax_state, jmodel, tx, jtask_cfg = _jax_setup(bank)
    jstep = jax.jit(jtask.make_s2st_train_step(jmodel, tx, jtask_cfg, {k: jnp.asarray(v) for k, v in bank.items()}))
    out = {"state": jax_state}
    for prefix in (True, False):
        key, draw = _key_with(jtask_cfg, bank["n_frames"].shape[0], prefix)
        new, metrics = jstep(jax.tree_util.tree_map(jnp.asarray, jax_state), key)
        grads = {k: v / (1 - ttask.ADAMW_BETAS[0]) for k, v in _flat(jax.device_get(_adam(new.opt_state).mu)["params"])}
        out[prefix] = {"draw": draw, "metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads}
    return out


def _assert_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        print(f"[s2st step] {k}: port {got[k]:.7g} jax {want[k]:.7g}")
        if k in ACCURACIES:
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def _port_step(bank, jax_state, draw):
    """The port's step from JAX's state on ``draw``: its metrics and the
    gradient of every parameter."""
    state, task = _port_state(jax_state)
    state, metrics = ttask.make_s2st_train_step(task, _t_bank(bank))(state, draw)
    assert state.step == 1 and state.opt.count == 1
    assert all(p.grad is not None for p in state.model.parameters())
    return {k: float(v) for k, v in metrics.items()}, {n: p.grad.double().numpy() for n, p in
                                                        state.model.named_parameters()}


def _float64_step(bank, jax_state, draw, monkeypatch):
    """The same step with every tensor in float64: the bank's audio and the
    fbank, the model (``Tensor.float`` keeps float64 tensors float64, so its
    fp32 heads and attention scores compute in float64 too) and the
    optimiser's clipping."""
    real_float = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t: t if t.dtype == torch.float64 else real_float(t))
    try:
        _, tcfg = _model_cfgs()
        task = ttask.S2STTaskConfig(**TASK)
        state = ttask.create_s2st_state(tcfg, task, device="cpu")  # a fresh optimiser, as JAX's state has
        load_jax_params(state.model, jax_state.params)
        state.model.double()
        for m in state.model.modules():
            if getattr(m, "dtype", None) == torch.float32:
                m.dtype = torch.float64
        bank64 = {k: v.double() if v.dtype == torch.float32 else v for k, v in _t_bank(bank).items()}
        state, metrics = ttask.make_s2st_train_step(task, bank64)(state, draw)
    finally:
        monkeypatch.undo()
    return {k: float(v) for k, v in metrics.items()}, {n: p.grad.numpy() for n, p in state.model.named_parameters()}


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix_rows", "no_prefix_rows"])
def test_s2st_step_matches_jax(bank, jax_steps, prefix, monkeypatch):
    """One step from JAX's jittered state on the draws JAX makes from the
    step's key (with prefix-masked rows, or none).

    - The loss, the six terms and the accuracies within LOSS_RTOL relative
      of JAX's (the accuracies equal); found: 1e-6.
    - Gradients: not held to JAX's at 1e-4.  At a random draw the CTC
      losses are 300-6,000 (a sum over up to 3,200 frames), and an fp32 CTC
      recursion's gradient is then off by 0.2-3% of a leaf's peak (JAX's
      here, ``test_ctc_at_the_step_scale``).  The port runs CTC in float64,
      so every leaf is held within 1e-4 of its peak (plus 1e-7 of the
      model's) of the step run wholly in float64 (``_float64_step``), and
      no further from it than JAX's; the fbank's fp32 rounding near its
      floor (``test_batched_fbank_matches_jax``) is inside that."""
    run = jax_steps[prefix]
    got, grads = _port_step(bank, jax_steps["state"], run["draw"])
    _assert_metrics(got, run["metrics"])
    ref_metrics, ref = _float64_step(bank, jax_steps["state"], run["draw"], monkeypatch)
    top = max(np.abs(r).max() for r in ref.values())
    worst = {"port": 0.0, "jax": 0.0}
    for name, r in ref.items():
        peak = np.abs(r).max()
        port_err, jax_err = np.abs(grads[name] - r).max(), np.abs(run["grads"][name] - r).max()
        assert port_err <= 1e-4 * peak + 1e-7 * top, f"{name}: {port_err:.3g} from float64 (peak {peak:.3g})"
        assert port_err <= jax_err + 1e-7 * top, f"{name}: port {port_err:.3g}, JAX {jax_err:.3g} from float64"
        if peak > 1e-4 * top:  # not a zero-gradient leaf (a bias before a softmax along which it is constant)
            worst = {"port": max(worst["port"], port_err / peak), "jax": max(worst["jax"], jax_err / peak)}
    print(f"[s2st step] gradients against the float64 step, worst share of a leaf's peak: {worst}")
    assert (got["transition_bce"] > 0) == prefix


@pytest.mark.parametrize("scale", ["small", "step"])
def test_ctc_at_the_step_scale(scale):
    """Why the port's CTC runs in float64: at the train step's scale (3,200
    frames, 32 classes, 56 labels, a loss near 1e4) ``optax.ctc_loss``'s
    fp32 gradient is off from a float64 recursion by more than 1e-3 of its
    peak, while the port's ``ctc_loss`` is within 1e-6 of it, and both
    losses within 1e-5 relative (found: optax 3.6e-2, the port 3e-8); at a
    small scale (60 frames, a loss near 200) optax's is within 1e-4 (found
    1.8e-5)."""
    T, L = (3200, 56) if scale == "step" else (60, 8)
    g = np.random.default_rng(11)
    logits = g.standard_normal((2, T, 32)).astype(np.float32)
    labels = g.integers(1, 32, (2, L)).astype(np.int32)
    label_pad = np.zeros((2, L), np.float32)
    label_pad[1, L // 2:] = 1
    logit_pad = np.zeros((2, T), np.float32)
    logit_pad[1, 3 * T // 4:] = 1
    ins = [torch.from_numpy(a) for a in (logit_pad, labels, label_pad)]

    def torch_ctc(dtype):
        x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
        logp = torch.log_softmax(x, -1).transpose(0, 1)
        loss = torch.nn.functional.ctc_loss(logp, ins[1].long(), torch.tensor([T, 3 * T // 4]),
                                            torch.tensor([L, L // 2]), reduction="none")
        loss.sum().backward()
        return loss.detach().double().numpy(), x.grad.double().numpy()

    ref_loss, ref = torch_ctc(torch.float64)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = ttask.ctc_loss(x, *ins)
    loss.sum().backward()
    jloss = np.asarray(optax.ctc_loss(logits, logit_pad, labels, label_pad))
    jgrad = np.asarray(jax.grad(lambda z: optax.ctc_loss(z, logit_pad, labels, label_pad).sum())(logits))
    peak = np.abs(ref).max()
    port_err, jax_err = np.abs(x.grad.numpy() - ref).max() / peak, np.abs(jgrad - ref).max() / peak
    print(f"[ctc {scale}] loss {ref_loss}, gradient error share of peak: port {port_err:.3g}, optax {jax_err:.3g}")
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(jloss, ref_loss, rtol=1e-5)
    assert port_err <= 1e-6
    assert jax_err > 1e-3 if scale == "step" else jax_err <= 1e-4


def test_fused_steps_equal_sequential_steps(bank, jax_steps):
    """``multi_steps=2`` on two draws: the state of two sequential steps
    (bit for bit) and the metrics the two steps' means, as JAX's ``lax.scan``
    and ``tree_map(mean)`` average them."""
    draws = [jax_steps[True]["draw"], jax_steps[False]["draw"]]
    fused, task = _port_state(jax_steps["state"])
    fused, got = ttask.make_s2st_train_step(task, _t_bank(bank), multi_steps=2)(fused, draws)
    seq, _ = _port_state(jax_steps["state"])
    step = ttask.make_s2st_train_step(task, _t_bank(bank))
    rows = [step(seq, d)[1] for d in draws]
    assert fused.step == seq.step == 2 and fused.opt.count == 2
    for k in got:
        np.testing.assert_allclose(float(got[k]), (float(rows[0][k]) + float(rows[1][k])) / 2, rtol=1e-6, err_msg=k)
    for (n, a), b in zip(fused.model.state_dict().items(), seq.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_port_sampler_draws_rows_and_prefixes():
    """The port's own sampler (a ``torch.Generator``, not JAX's bits):
    ``batch_size`` rows within the bank, ``use_prefix`` at about
    ``prefix_mask_prob`` and ``frac`` within ``[prefix_min_frac, 1)``."""
    task = ttask.S2STTaskConfig(batch_size=4096)
    out = ttask.make_s2st_sampler(task, 6)(torch.Generator().manual_seed(0))
    assert out["idx"].shape == (4096,) and 0 <= int(out["idx"].min()) and int(out["idx"].max()) == 5
    assert abs(float(out["use_prefix"].float().mean()) - task.prefix_mask_prob) < 0.03
    assert float(out["frac"].min()) >= task.prefix_min_frac and float(out["frac"].max()) < 1.0


def test_greedy_translate_matches_jax(bank, jax_steps):
    """``make_greedy_translate`` on the bank's first four rows from JAX's
    jittered weights: tokens equal to JAX's (EOS and after zeroed), and
    ``evaluate_token_f1`` equal to JAX's."""
    jcfg, _ = _model_cfgs()
    jmodel = JStreamSpeech(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jax_steps["state"].params)
    task = jtask.S2STTaskConfig(**TASK)
    rows = slice(0, 4)
    want = np.asarray(jtask.make_greedy_translate(jmodel, task, max_len=8)(
        params, jnp.asarray(bank["audio"][rows]), jnp.asarray(bank["n_frames"][rows])))
    state, ttask_cfg = _port_state(jax_steps["state"])
    model = state.model.eval()
    got = ttask.make_greedy_translate(model, ttask_cfg, max_len=8)(torch.from_numpy(bank["audio"][rows]),
                                                                    torch.from_numpy(bank["n_frames"][rows]))
    print(f"[greedy] tokens {want.tolist()}")
    assert np.array_equal(got.numpy(), want)
    small = {k: v[rows] for k, v in bank.items()}
    jf1 = jtask.evaluate_token_f1(jmodel, params, task, small, batch_size=2)
    tf1 = ttask.evaluate_token_f1(model, ttask_cfg, small, batch_size=2)
    assert tf1 == jf1


def test_cli_train_s2st_matches_jax_and_resumes(tmp_path):
    """``cli train-s2st --tiny --device cpu --batch_size 2 --eval_samples
    2`` and JAX's: ``metrics.jsonl`` has JAX's keys and steps,
    ``streamspeech_config.json`` equals JAX's, ``s2st_eval.json`` has JAX's
    keys; the port writes ``<step>.pt``; ``--resume`` continues from step 2
    to 3 and keeps the rows."""
    from hifigan_tpu import cli as jcli

    args = ["train-s2st", "--tiny", "--batch_size", "2", "--log_every", "1", "--eval_samples", "2"]
    jcli.main(["--cpu", *args, "--max_steps", "2", "--checkpoint_dir", str(tmp_path / "jax")])
    cli.main([*args, "--device", "cpu", "--max_steps", "2", "--checkpoint_dir", str(tmp_path / "port")])
    cli.main([*args, "--device", "cpu", "--max_steps", "3", "--resume", "--checkpoint_dir", str(tmp_path / "port")])
    read = lambda d: [json.loads(line) for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]  # noqa: E731
    jrows, rows = read("jax"), read("port")
    assert [r["step"] for r in jrows] == [1, 2] and [r["step"] for r in rows] == [1, 2, 3]
    assert all(set(r) == set(jrows[0]) for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    for name in ("streamspeech_config.json",):
        assert json.loads((tmp_path / "port" / name).read_text()) == json.loads((tmp_path / "jax" / name).read_text())
    jeval, teval = (json.loads((tmp_path / d / "s2st_eval.json").read_text()) for d in ("jax", "port"))
    assert set(teval) == set(jeval) == {"token_f1", "exact_match", "n", "step"} and teval["step"] == 3
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "2.pt", "3.pt", "metrics.jsonl", "s2st_eval.json", "streamspeech_config.json"]
