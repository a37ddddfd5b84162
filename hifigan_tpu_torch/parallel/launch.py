"""Process groups for the port's parallelism: one process per device.

The JAX package runs one program over a mesh of devices; the port runs one
process per device and joins them in a ``torch.distributed`` process group,
NCCL on the card (rank ``r`` on ``cuda:LOCAL_RANK``), gloo on the CPU.

* :func:`init_from_env` starts the group of a launched run, from the
  variables ``python -m torch.distributed.run`` sets (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, the master's address), or returns the
  group that is already there.
* :func:`spawn` runs ``fn(rank, world, *args)`` in ``world`` fresh
  processes and returns what each rank's call returned.  The processes meet
  through a ``FileStore`` in a temporary directory, not a TCP port, so
  several groups can start at once on one host.  ``fn`` is pickled by
  reference: it lives in a module that the children can import (one that
  imports torch, not JAX).
* :func:`single_process_group` is a group of one, for running the sharded
  code paths on one card.

NCCL places one rank on a card: asking for more CUDA ranks than there are
cards raises, and nothing falls back to gloo unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

STORE_ENV = "HIFIGAN_TORCH_STORE"  # a FileStore path: set by spawn, read by init_from_env


@dataclass(frozen=True)
class Rank:
    """This process's place in the group, and the device it computes on."""

    rank: int
    world: int
    local_rank: int
    device: torch.device


def _check_cards(device: torch.device, ranks: int) -> None:
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    cards = torch.cuda.device_count()
    if ranks > cards:
        raise RuntimeError(f"{ranks} CUDA ranks need {ranks} cards, and {cards} are visible: NCCL places one rank "
                           f"on a card (pass device='cpu' for gloo processes)")


def _rank_device(device: torch.device, local_rank: int) -> torch.device:
    return torch.device("cuda", local_rank) if device.type == "cuda" else torch.device("cpu")


def init_from_env(device: str | torch.device = "cuda") -> Rank | None:
    """The process group of a launched run, started here if it is not yet
    (NCCL on ``cuda:LOCAL_RANK``, gloo when ``device`` is the CPU), or None
    when the process was not launched (no ``WORLD_SIZE`` in the
    environment) and no group exists."""
    device = torch.device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local = int(os.environ.get("LOCAL_RANK", rank))
        return Rank(rank, world, local, _rank_device(device, local))
    if "WORLD_SIZE" not in os.environ:
        return None
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    _check_cards(device, local + 1)
    if device.type == "cuda":
        torch.cuda.set_device(local)
    backend = "nccl" if device.type == "cuda" else "gloo"
    store = os.environ.get(STORE_ENV)
    if store:
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return Rank(rank, world, local, _rank_device(device, local))


@contextlib.contextmanager
def single_process_group(device: str | torch.device = "cuda"):
    """A process group of one rank (NCCL on the current card, or gloo),
    destroyed on exit; yields its :class:`Rank`."""
    device = torch.device(device)
    _check_cards(device, 1)
    with tempfile.TemporaryDirectory() as tmp:
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            index = torch.cuda.current_device() if device.type == "cuda" else 0
            yield Rank(0, 1, index, _rank_device(device, index))
        finally:
            dist.destroy_process_group()


def spawn(fn, world: int, device: str | torch.device = "cuda", *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined in
    one group (NCCL on ``cuda:rank``, or gloo with one intra-op thread each
    when ``device`` is the CPU); returns the ranks' return values in rank
    order.  If a rank fails, the others are stopped and this raises with the
    end of the failed rank's standard error."""
    device = torch.device(device)
    _check_cards(device, world)
    with tempfile.TemporaryDirectory(prefix="hifigan_spawn_") as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args, device.type), f)
        path = [os.path.abspath(p) for p in sys.path if p]
        procs, logs = [], []
        try:
            for rank in range(world):
                env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                           LOCAL_WORLD_SIZE=str(world), PYTHONPATH=os.pathsep.join(path),
                           **{STORE_ENV: os.path.join(tmp, "store")})
                if device.type == "cpu":
                    env["OMP_NUM_THREADS"] = "1"
                logs.append(open(os.path.join(tmp, f"rank{rank}.err"), "w+"))
                procs.append(subprocess.Popen([sys.executable, "-c", _CHILD, tmp], env=env, stderr=logs[-1]))
            _wait(procs, logs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _wait(procs, logs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            rank = failed[0]
            logs[rank].seek(0)
            tail = logs[rank].read()[-4000:]
            raise RuntimeError(f"rank {rank} of {len(procs)} exited with code {codes[rank]}:\n{tail}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"the {len(procs)} spawned ranks did not finish within {timeout:.0f} s")
        time.sleep(0.05)


_CHILD = "import sys; from hifigan_tpu_torch.parallel.launch import _child; _child(sys.argv[1])"


def _child(directory: str) -> None:
    """A spawned rank: join the group, run the call, write its result."""
    with open(os.path.join(directory, "call.pkl"), "rb") as f:
        fn, args, device = pickle.load(f)
    if device == "cpu":
        torch.set_num_threads(1)
    me = init_from_env(device)
    try:
        result = fn(me.rank, me.world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(directory, f"result{me.rank}.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(directory, f"result{me.rank}.pkl.tmp"), os.path.join(directory, f"result{me.rank}.pkl"))
