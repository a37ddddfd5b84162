"""``cli bench`` of the port against the JAX package's command (the root
``bench.py``) on the CPU.

* Each config's model is JAX's: equal parameter counts, JAX's taken from
  ``jax.eval_shape`` of the ``init`` calls ``bench.py`` makes (shapes only,
  nothing compiled).
* The flagship call the command times, at 1 × 8 frames on JAX's weights
  (every leaf redrawn from a seed, carried over by
  ``load_jax_generator_params``), against JAX's ``model.apply`` in the same
  dtype: fp32 within 2e-3 as in ``tests/test_pallas.py:96``, bf16 (the
  command's) within 4 bf16 ulps of the peak.
* The whole command at tiny sizes (the config list patched, ``--device
  cpu``; the call counts cut to 2 and 1 warm-up): one stdout line with the
  four keys, one stderr line with the five configs and ``vs_prev_round:
  null``, and each config's keys and arithmetic as JAX's.
* A config that raises makes the command exit 1 with the stdout line still
  printed; without a card the command exits 3 with ``value: null``.
* :func:`call_time`, the port's one timer, on the CPU: warm-up calls, then
  the window of the timed calls over their count; a card whose power limit
  ``nvidia-smi`` cannot read fails the command.
"""

import contextlib
import io
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import _randomise

from hifigan_tpu_torch import bench, cli
from hifigan_tpu_torch.utils import benchit, call_time, profiling
from hifigan_tpu_torch.weights import load_jax_generator_params

JAX_KEYS = {  # bench.py's keys, config by config
    "flagship_odconv_grc_film": {"rtf", "ms_per_call", "audio_sec"},
    "hifigan_v1": {"rtf", "ms_per_call"},
    "conditioned_auto_embeddings": {"rtf", "ms_per_call"},
    "gan_train_step": {"steps_per_sec", "ms_per_step", "audio_sec_per_step"},
    "gan_train_step_production": {"steps_per_sec", "ms_per_step", "steps_per_call", "batch", "audio_sec_per_sec"},
}
# the tiny sizes the command runs at here: (batch, frames) or (batch,
# n_samples[, k])
TINY_SIZES = {
    "flagship_odconv_grc_film": (1, 8),
    "hifigan_v1": (1, 8),
    "conditioned_auto_embeddings": (1, 8),
    "gan_train_step": (1, 1024),
    "gan_train_step_production": (2, 1024, 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: full-width models at tiny
    sizes are many small ops (as in ``tests/test_torch_train_step.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _few_calls(mp):
    """The command's call counts cut for the CPU (the arithmetic holds for
    any count)."""
    for name, value in (("INFER_CALLS", 2), ("TRAIN_CALLS", 1), ("FUSED_CALLS", 1), ("PRODUCTION_CALLS", 1),
                        ("WARMUP", 1), ("FUSED_WARMUP", 1)):
        mp.setattr(bench, name, value)


@pytest.fixture(scope="module")
def command():
    """``cli.main(["bench", "--device", "cpu"])`` over the configs at
    :data:`TINY_SIZES`: its stdout, its stderr and what each config's
    function returned."""
    returned = {}

    def tiny(name, fn):
        def run(device):
            returned[name] = fn(*TINY_SIZES[name], device=device)
            return returned[name]
        return run

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        _few_calls(mp)
        mp.setattr(bench, "CONFIGS", [(name, tiny(name, fn)) for name, fn in bench.CONFIGS])
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(["bench", "--device", "cpu"])
    return out.getvalue(), err.getvalue(), returned


def _stderr_record(err: str) -> dict:
    records = [json.loads(line) for line in err.splitlines() if line.startswith('{"configs"')]
    assert len(records) == 1, err
    return records[0]


def test_the_configs_are_the_jax_commands():
    """The port's list is ``bench.py::main``'s, in its order, with its counts."""
    assert [name for name, _ in bench.CONFIGS] == list(JAX_KEYS)
    assert (bench.INFER_CALLS, bench.TRAIN_CALLS, bench.FUSED_CALLS, bench.PRODUCTION_CALLS) == (16, 4, 5, 3)
    assert (bench.METRIC, bench.NORTH_STAR) == ("audio_sec_per_sec_per_chip_22k05_flagship_inference", 50.0)


def _n(tree) -> int:
    return sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree))


def _n_torch(module) -> int:
    return sum(p.numel() for p in module.parameters())


@pytest.mark.parametrize("config", ["flagship", "hifigan_v1", "conditioned", "train_state"])
def test_each_config_builds_the_jax_model(config):
    """Parameter counts equal JAX's for the models ``bench.py`` builds, at
    its default shapes (8 × 80 × 256 mels; the train state at 4 × 8192)."""
    from hifigan_tpu import train as jtrain
    from hifigan_tpu.models import Generator, GeneratorConfig, HiFiGANV1Generator
    from hifigan_tpu.models.vocoder import ModifiedVocoder

    key = jax.random.PRNGKey(0)
    mel = jax.ShapeDtypeStruct((8, 80, 256), jnp.float32)
    if config == "flagship":
        want = [_n(jax.eval_shape(Generator(GeneratorConfig(), dtype=jnp.bfloat16).init, key, mel,
                                  jax.ShapeDtypeStruct((8, 192), jnp.float32),
                                  jax.ShapeDtypeStruct((8, 256), jnp.float32)))]
        got = [_n_torch(bench.flagship_call(1, 8, "cpu")[0])]
    elif config == "hifigan_v1":
        want = [_n(jax.eval_shape(HiFiGANV1Generator(dtype=jnp.bfloat16).init, key, mel))]
        got = [_n_torch(bench.hifigan_v1_call(1, 8, "cpu")[0])]
    elif config == "conditioned":
        want = [_n(jax.eval_shape(ModifiedVocoder(GeneratorConfig(), dtype=jnp.bfloat16).init, key, mel))]
        got = [_n_torch(bench.conditioned_call(1, 8, "cpu")[0])]
    else:
        state = jax.eval_shape(lambda: jtrain.create_train_state(
            key, jtrain.TrainConfig(warmup_steps=0), mel_frames=8192 // 256, batch_size=4, dtype=jnp.bfloat16)[0])
        want = [_n(state.gen_params), _n(state.disc_params)]
        cfg, tstate = bench.train_state("cpu")
        got = [_n_torch(tstate.vocoder), _n_torch(tstate.discriminators)]
        assert cfg.warmup_steps == 0 and tstate.vocoder.generator.dtype == torch.bfloat16
    assert got == want and want[0] > 1e6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flagship_call_matches_jax(dtype, monkeypatch):
    """The flagship call the command times, at 1 × 8 frames (its own seeded
    inputs), on JAX's weights, against JAX's ``Generator(GeneratorConfig())
    .apply`` in the same dtype.  bf16 is the command's; the fp32 case builds
    the same call with ``build_generator``'s dtype swapped.  fp32: 2e-3, as
    ``tests/test_pallas.py:96``.  bf16: 4 bf16 ulps at JAX's peak
    (4·2⁻⁸·max|wav|, as ``tests/test_torch_generator.py`` holds the bf16
    generator): at this output's peak, about 0.57, a single bf16 rounding
    is 0.0039, above 2e-3, and XLA's fused ops and eager torch round in
    other places."""
    from hifigan_tpu.models import Generator, GeneratorConfig

    assert bench.flagship_call(1, 8, "cpu")[0].dtype == torch.bfloat16
    build = bench.build_generator
    monkeypatch.setattr(bench, "build_generator", lambda cfg, _, device, seed: build(cfg, dtype, device, seed))
    model, args = bench.flagship_call(1, 8, "cpu")
    assert model.dtype == dtype and model.config == bench.GeneratorConfig()
    inputs = [a.numpy() for a in args]
    jm = Generator(GeneratorConfig(), dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    params = _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs), 3)
    want = np.asarray(jax.jit(jm.apply)(params, *inputs))
    load_jax_generator_params(model, params)
    with torch.no_grad():
        got = model(*args).numpy()
    assert got.shape == want.shape == (1, 1, 8 * 256)
    assert np.isfinite(got).all() and 0.005 < got.std()
    tol = 2e-3 if dtype == torch.float32 else 4 * 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0 if dtype == torch.bfloat16 else 2e-3, atol=tol)


def test_cli_bench_prints_the_contract(command):
    """One stdout line with JAX's four keys, metric and unit, ``vs_baseline
    = round(value / 50, 2)``; one stderr line with the five configs, the
    device and ``vs_prev_round: null``."""
    out, err, returned = command
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert (line["metric"], line["unit"]) == ("audio_sec_per_sec_per_chip_22k05_flagship_inference", "x_realtime")
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["value"] == round(returned["flagship_odconv_grc_film"]["rtf"], 1)
    assert line["vs_baseline"] == round(line["value"] / 50, 2)
    record = _stderr_record(err)
    assert set(record) == {"configs", "device", "vs_prev_round"} and record["vs_prev_round"] is None
    assert record["device"] == {"name": "cpu"}
    assert record["configs"] == json.loads(json.dumps(returned)) and list(record["configs"]) == list(JAX_KEYS)


@pytest.mark.parametrize("name", list(JAX_KEYS))
def test_each_config_returns_jax_keys_and_arithmetic(command, name):
    """Each function at its tiny size returns exactly JAX's keys, with JAX's
    arithmetic between them (22.05 kHz × hop 256 for inference, 16 kHz for
    training)."""
    r = command[2][name]
    assert set(r) == JAX_KEYS[name]
    assert all(math.isfinite(v) and v > 0 for v in r.values())
    size = TINY_SIZES[name]
    if "rtf" in r:
        audio_sec = size[0] * size[1] * 256 / 22050
        assert r["rtf"] == pytest.approx(audio_sec / (r["ms_per_call"] / 1e3), rel=1e-12)
        if "audio_sec" in r:
            assert r["audio_sec"] == audio_sec
    else:
        assert r["steps_per_sec"] == pytest.approx(1e3 / r["ms_per_step"], rel=1e-12)
        audio_sec = size[0] * size[1] / 16000
        if "audio_sec_per_step" in r:
            assert r["audio_sec_per_step"] == audio_sec
        else:
            assert (r["steps_per_call"], r["batch"]) == (size[2], size[0])
            assert r["audio_sec_per_sec"] == pytest.approx(audio_sec * r["steps_per_sec"], rel=1e-12)


def test_fused_train_step_keys_and_arithmetic(monkeypatch):
    """``bench_train_step_fused`` (not among the configs, as in JAX): JAX's
    keys; ``steps_per_call`` is ``k``."""
    _few_calls(monkeypatch)
    r = bench.bench_train_step_fused(1, 1024, k=2, device="cpu")
    assert set(r) == {"steps_per_sec", "ms_per_step", "steps_per_call", "audio_sec_per_sec"}
    assert r["steps_per_call"] == 2
    assert r["steps_per_sec"] == pytest.approx(1e3 / r["ms_per_step"], rel=1e-12)
    assert r["audio_sec_per_sec"] == pytest.approx(1024 / 16000 * r["steps_per_sec"], rel=1e-12)


def _ok(device):
    return {"rtf": 123.456, "ms_per_call": 1.0, "audio_sec": 0.1}


def _run(monkeypatch, capsys, configs, argv=("bench", "--device", "cpu")):
    monkeypatch.setattr(bench, "CONFIGS", configs)
    with pytest.raises(SystemExit) as exit_:
        cli.main(list(argv))
    out, err = capsys.readouterr()
    return exit_.value.code, out, err


def test_a_failing_config_fails_the_command(monkeypatch, capsys):
    """A config that raises: its stderr entry holds the error, the others
    run, the stdout line is still printed, and the command exits 1."""
    def broken(device):
        raise ValueError("out of memory, say")

    ran = []
    configs = [("flagship_odconv_grc_film", _ok), ("hifigan_v1", broken),
               ("gan_train_step", lambda device: ran.append(device) or {"steps_per_sec": 1.0})]
    code, out, err = _run(monkeypatch, capsys, configs)
    assert code == 1 and len(ran) == 1
    assert json.loads(out) == {"metric": bench.METRIC, "value": 123.5, "unit": "x_realtime", "vs_baseline": 2.47}
    assert _stderr_record(err)["configs"]["hifigan_v1"] == {"error": "ValueError: out of memory, say"}

    code, out, _ = _run(monkeypatch, capsys, [("flagship_odconv_grc_film", broken), ("hifigan_v1", _ok)])
    line = json.loads(out)
    assert code == 1 and line["value"] is None and line["vs_baseline"] is None and "out of memory" in line["error"]


def test_without_a_card_the_command_exits_3(monkeypatch, capsys):
    """``cli bench`` (``--device cuda``, the default) on a machine without a
    card: the contract line with ``value: null`` and an error naming the
    missing card, exit 3, and no config run."""
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = _run(monkeypatch, capsys, [("flagship_odconv_grc_film", lambda device: ran.append(device))],
                          argv=("bench",))
    line = json.loads(out)
    assert code == 3 and not ran and '{"configs"' not in err
    assert (line["metric"], line["value"], line["vs_baseline"]) == (bench.METRIC, None, None)
    assert "no CUDA device" in line["error"]


def test_call_time_on_the_cpu():
    """``call_time`` is the port's one timer, ``device_time``: warm-up calls
    first, then the whole window of timed calls over their count, so one
    call that stalls moves the figure (a median of single calls would not
    see it); a device other than the card or the CPU raises."""
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) == 6:  # the third timed call stalls
            time.sleep(0.05)

    assert 0.05 / 5 <= call_time(fn, (7,), 5, warmup=3, device="cpu") < 0.5
    assert calls == [7] * 8
    assert call_time is profiling.device_time and benchit.call_time is call_time
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        call_time(lambda: None, (), device="meta")


def test_an_unreadable_power_limit_fails_the_command(monkeypatch, capsys):
    """On a card whose ``nvidia-smi`` is missing, the configs still run and
    both lines are printed, the stderr line's ``device`` holds the card's
    name and the error, and the command exits 1."""
    def no_smi(*args, **kwargs):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(bench, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(bench.subprocess, "run", no_smi)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "a card")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    code, out, err = _run(monkeypatch, capsys, [("flagship_odconv_grc_film", _ok)], argv=("bench",))
    assert code == 1
    assert json.loads(out)["value"] == 123.5
    device = _stderr_record(err)["device"]
    assert device["name"] == "a card" and "nvidia_smi" not in device
    assert device["error"].startswith("nvidia-smi: FileNotFoundError")
