"""``cli train`` across processes and ``dryrun_multichip`` on gloo CPU
processes.

Two ranks of one group run ``cli train --tiny --device cpu --batch_size 2``
as a launched run would (``tests/torch_parallel_ranks.py::cli_train``):
each takes one row of the seeded loader's batch, and the run's metrics
must equal a one-process run's, with rank 0 alone writing the files; a
batch of 3 raises on both ranks.  ``dryrun_multichip(4, device="cpu")``
runs the data × model step, the sequence-parallel Conformer and the
tensor-parallel StreamSpeech forward in four gloo processes."""

import concurrent.futures
import json

import numpy as np
import pytest
import torch

import torch_parallel_ranks
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.entry import dryrun_multichip
from hifigan_tpu_torch.parallel import spawn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(directory, batch=2):
    return ["train", "--tiny", "--device", "cpu", "--batch_size", str(batch), "--max_steps", "2", "--log_every", "1",
            "--checkpoint_dir", str(directory)]


def _metrics(directory):
    rows = [json.loads(line) for line in (directory / "metrics.jsonl").read_text().splitlines()]
    for row in rows:
        row.pop("wall_s")
    return rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A one-process run and a two-rank run of the same command."""
    root = tmp_path_factory.mktemp("parallel_cli")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks run while the one process does
        ranks = pool.submit(spawn, torch_parallel_ranks.cli_train, 2, "cpu", _argv(root / "two"),
                            _argv(root / "ragged", 3), timeout=300)
        cli.main(_argv(root / "one"))
        return root, ranks.result()


def test_two_ranks_train_as_one_process(runs):
    """The two-rank run's metrics equal the one-process run's (rtol 1e-5):
    the ranks split each batch of 2 and average their gradients."""
    root, _ = runs
    one, two = _metrics(root / "one"), _metrics(root / "two")
    assert [r["step"] for r in two] == [1, 2]
    assert len(one) == len(two)
    for a, b in zip(one, two):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_rank_zero_alone_writes(runs):
    """One metrics line a logged step, one checkpoint, one summary, one
    events file: nothing written twice by the second rank."""
    root, _ = runs
    two = root / "two"
    assert len((two / "metrics.jsonl").read_text().splitlines()) == 2
    assert sorted(p.name for p in two.glob("*.pt")) == ["2.pt"]
    assert json.loads((two / "training_summary.json").read_text())["steps"] == 2
    events = list((two / "tensorboard").glob("events.*"))
    assert len(events) <= 1


def test_a_batch_the_ranks_do_not_divide_raises(runs):
    root, results = runs
    for r in results:
        assert r["ragged"] and "not divisible by the 2 launched processes" in r["ragged"]
    assert not (root / "ragged" / "metrics.jsonl").exists()


def test_dryrun_multichip_on_four_gloo_processes(capfd):
    """``dryrun_multichip(4, device="cpu")``: a 2 × 2 mesh, four sequence
    shards, sharded leaves, finite metrics, and JAX's OK line."""
    r = dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip OK: mesh={'data': 2, 'model': 2} sp_shards=4" in out
    assert r["sp_err"] < 1e-3 and r["tp_partitioned"] > 0 and r["tp_err"] < 1e-4
    assert r["tp_all_reduces"] == 10
    assert all(np.isfinite(v) for v in r["metrics"].values())
