"""The port's utilities against the JAX package's on the CPU:
``utils/tb.py`` (TensorBoard events, read back through tensorboard's own
loader and compared event by event with the JAX writer's; metrics
pruning), the ``cli train`` repair (it writes events as JAX's ``cli
train`` does, and a resumed run's ``metrics.jsonl`` is pruned) and
``utils/profiling.py``."""

import json
import os
import struct
import time

import numpy as np
import pytest
import torch

from hifigan_tpu.utils import tb as jtb
from hifigan_tpu.utils.profiling import StageTimer as JStageTimer
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.utils import profiling
from hifigan_tpu_torch.utils import tb as ttb

pytestmark = pytest.mark.skipif(not ttb.HAVE_TENSORBOARD, reason="tensorboard is not installed")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: ``cli train --tiny`` runs many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _events(logdir) -> list:
    """``(step, tag, value)`` of every scalar of the one event file in
    ``logdir``, in the file's order: its TFRecords read with each length and
    payload checked against its masked CRC-32C (tensorboard's), each payload
    parsed as an ``Event``."""
    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

    files = [f for f in os.listdir(logdir) if "tfevents" in f]
    assert len(files) == 1, files
    data, out, i = open(os.path.join(logdir, files[0]), "rb").read(), [], 0
    while i < len(data):
        header = data[i: i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8: i + 12])[0] == masked_crc32c(header)
        payload = data[i + 12: i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n: i + 16 + n])[0] == masked_crc32c(payload)
        ev = Event.FromString(payload)
        out += [(ev.step, v.tag, v.simple_value) for v in ev.summary.value]
        i += 16 + n
    return out


def _write_metrics(path, rows):
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))


def test_tb_export_matches_jax(tmp_path):
    """JAX's ``test_tb_export`` on both packages: the same rows export to
    the same events (tags, steps, fp32 values) in the same order."""
    metrics = tmp_path / "metrics.jsonl"
    _write_metrics(metrics, [{"step": s, "generator_loss": 1.0 / (s + 1), "mel_loss": 2.0, "wall_s": 1.2,
                              "note": "text"} for s in range(3)])
    assert ttb.export_metrics_jsonl(str(metrics), str(tmp_path / "torch")) == 3
    assert jtb.export_metrics_jsonl(str(metrics), str(tmp_path / "jax")) == 3
    got, want = _events(tmp_path / "torch"), _events(tmp_path / "jax")
    assert got == want
    assert {tag for _, tag, _ in got} == {"generator_loss", "mel_loss"}
    assert [(s, v) for s, tag, v in got if tag == "generator_loss"] == [(0, 1.0), (1, 0.5), (2, np.float32(1 / 3))]
    # and tensorboard's own loader reads the port's file (it imports TensorFlow where installed)
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
    from tensorboard.util.tensor_util import make_ndarray

    (name,) = os.listdir(tmp_path / "torch")
    loaded = [(ev.step, v.tag, float(make_ndarray(v.tensor))) for ev in
              EventFileLoader(str(tmp_path / "torch" / name)).Load() for v in ev.summary.value]
    assert loaded == got


def test_prune_metrics_on_resume_matches_jax(tmp_path):
    """JAX's ``test_prune_metrics_on_resume`` on both packages, the files
    byte for byte equal after each call, plus a row that does not parse and
    a blank line."""
    rows = [{"step": 4000, "mel": 0.20}, {"step": 4400, "mel": 0.19}, {"step": 4800, "mel": 0.18},
            {"step": 5200, "mel": 0.17}, {"step": 5600, "mel": 0.16},
            {"step": 4400, "mel": 0.21}, {"step": 4800, "mel": 0.20}]
    text = "".join(json.dumps(r) + "\n" for r in rows) + "\nnot json\n"
    files = {}
    for name, prune in (("torch", ttb.prune_metrics), ("jax", jtb.prune_metrics)):
        path = tmp_path / f"{name}.jsonl"
        path.write_text(text)
        assert prune(str(path), resume_step=4800) == 5  # 5200, 5600, two duplicates, the bad row
        kept = [json.loads(line) for line in open(path)]
        assert [r["step"] for r in kept] == [4000, 4400, 4800] and kept[1]["mel"] == 0.19
        before = path.read_bytes()
        assert prune(str(path), resume_step=4800) == 0 and path.read_bytes() == before
        assert prune(str(tmp_path / "absent.jsonl"), 100) == 0
        files[name] = before
    assert files["torch"] == files["jax"]


def test_writer_without_tensorboard_does_nothing(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(ttb, "HAVE_TENSORBOARD", False)
    with caplog.at_level("WARNING"):
        w = ttb.ScalarWriter(str(tmp_path / "tb"))
    w.write(1, {"loss": 1.0})
    w.flush()
    w.close()
    assert not (tmp_path / "tb").exists()
    assert sum("tensorboard not available" in r.message for r in caplog.records) == 1


def _train(directory, *extra):
    cli.main(["train", "--tiny", "--device", "cpu", "--log_every", "1", "--checkpoint_dir", str(directory), *extra])


def test_cli_train_writes_events_as_jax_does(tmp_path):
    """``cli train --tiny --device cpu --max_steps 2`` writes
    ``tensorboard/``: its events hold, step by step, what JAX's ``cli
    train`` writes for the same rows (every number of each
    ``metrics.jsonl`` row, through JAX's ``ScalarWriter``)."""
    run = tmp_path / "run"
    _train(run, "--max_steps", "2")
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    writer = jtb.ScalarWriter(str(tmp_path / "jax"))
    for r in rows:
        writer.write(r["step"], r)
    writer.close()
    got, want = _events(run / "tensorboard"), _events(tmp_path / "jax")
    assert got == want
    assert {"generator_loss", "discriminator_loss", "mel_loss", "step", "epoch", "wall_s"} <= {t for _, t, _ in got}
    for r in rows:
        for k, v in r.items():
            assert (r["step"], k, pytest.approx(v, rel=1e-6)) in got


def test_cli_train_resume_prunes_metrics(tmp_path):
    """A run resumed from an older checkpoint (``3.pt`` removed, so step 2's
    is the newest) drops the rows past step 2 before it appends: the
    log's steps stay 1, 2, 3 in order, each once."""
    run = tmp_path / "run"
    _train(run, "--max_steps", "3", "--save_steps", "1")
    first = [json.loads(line) for line in open(run / "metrics.jsonl")]
    os.remove(run / "3.pt")
    _train(run, "--max_steps", "3", "--resume")
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert rows[:2] == first[:2]
    assert not hasattr(cli, "_prune_metrics")


def test_stage_timer_summary_matches_jax():
    """The same stages give the same summary keys and counts as JAX's."""
    summaries = []
    for timer in (profiling.StageTimer(), JStageTimer()):
        for name in ("asr", "mt", "asr"):
            with timer.stage(name):
                time.sleep(0.002)
        summaries.append(timer.summary())
    got, want = summaries
    assert got.keys() == want.keys() == {"asr", "mt"}
    for name in got:
        assert got[name].keys() == want[name].keys() == {"count", "total_s", "mean_ms", "max_ms"}
        assert got[name]["count"] == want[name]["count"]
        assert got[name]["max_ms"] >= got[name]["mean_ms"] >= 2.0
    timer.reset()
    assert timer.summary() == {}


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def is_cuda(self):
        return True


def test_device_time_finds_card_tensors_at_any_depth():
    """``device_time`` times with CUDA events when a card tensor sits
    anywhere in ``args``, inside tuples, lists and dicts too (the
    generator's inputs, a train state), and with the host clock only when
    none does."""
    card, host = torch.zeros(2).as_subclass(_OnCard), torch.zeros(2)
    for args in ((card,), ((card,),), ({"state": [host, card]},), ([host, (1, {"x": card})],)):
        assert profiling._on_card(args), args
    for args in ((host,), ((host, 3),), ({"state": [host]},), ()):
        assert not profiling._on_card(args), args


def test_device_time_and_trace_on_the_cpu(tmp_path):
    """On the CPU, ``device_time`` is host time per call (one warm-up, then
    ``iters`` calls); ``trace_to`` writes a Chrome trace holding the
    ``annotate`` range."""
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.003)
        return x + 1

    s = profiling.device_time(fn, (torch.zeros(4),), iters=5)
    assert len(calls) == 6 and 0.003 <= s < 0.5
    with profiling.trace_to(str(tmp_path / "trace")):
        with profiling.annotate("serving_synth"):
            torch.ones(8) @ torch.ones(8)
    (trace,) = os.listdir(tmp_path / "trace")
    events = json.load(open(tmp_path / "trace" / trace))["traceEvents"]
    assert any(e.get("name") == "serving_synth" for e in events)
