"""What each rank of the port's parallel tests runs.

:func:`hifigan_tpu_torch.parallel.spawn` starts fresh processes that import
the function they run, so these live in a module that imports torch and the
port only (not JAX); ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_cli.py`` hand them numpy inputs and torch state
dicts, and compare what they return with JAX and with one process."""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist

from hifigan_tpu_torch import cli
from hifigan_tpu_torch.models.conformer import ChunkedConformer
from hifigan_tpu_torch.models.streamspeech import StreamSpeechS2ST
from hifigan_tpu_torch.parallel import (
    conformer_forward_seq_sharded,
    make_mesh,
    make_sharded_train_step,
    shard_params_tp,
)
from hifigan_tpu_torch.parallel import tensor as tp
from hifigan_tpu_torch.parallel.mesh import full_state_dict, load_full_state_dict
from hifigan_tpu_torch.train.state import create_train_state
from hifigan_tpu_torch.train.train_step import make_train_step


def _full(p: torch.Tensor, t: torch.Tensor) -> np.ndarray:
    """``t`` (``p``'s value or gradient, a shard when ``p`` is sharded) whole."""
    return (tp.gather(t.detach(), p.tp_shard) if hasattr(p, "tp_shard") else t.detach()).numpy().copy()


def _sequence(rank, inputs) -> dict:
    """The sequence-parallel Conformer over every rank, and a ragged T."""
    enc = ChunkedConformer(*inputs["conformer_args"], gen=torch.Generator().manual_seed(0))
    enc.load_state_dict(inputs["conformer"])
    mel = torch.from_numpy(inputs["mel"])
    out = conformer_forward_seq_sharded(enc, mel).numpy()
    try:
        conformer_forward_seq_sharded(enc, mel[:, :-1])
        ragged = None
    except ValueError as e:
        ragged = str(e)
    return {"seq_out": out, "ragged": ragged}


def _train(rank, n_model, inputs, cfg) -> dict:
    """One sharded step from the given state on the global batch; returns
    the metrics, the applied gradients and parameters (whole), the counts
    of collectives and this rank's share of the sharded elements."""
    mesh = make_mesh(n_model=n_model)
    state = create_train_state(cfg, device="cpu")
    shard_params_tp(state.vocoder, mesh)
    load_full_state_dict(state, copy.deepcopy(inputs["state"]))  # the optimiser updates what it loads
    sharded = [p for p in state.vocoder.parameters() if hasattr(p, "tp_shard")]
    local = sum(p.numel() for p in sharded)
    full = sum(p.tp_shard.shape.numel() for p in sharded)
    step = make_sharded_train_step(make_train_step(cfg), mesh)
    before = tp.counts["grad_all_reduce"]
    state, metrics = step(state, {"audio": inputs["audio"]})
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grad_all_reduces": tp.counts["grad_all_reduce"] - before,
           "sharded_local": local, "sharded_full": full, "n_sharded": len(sharded)}
    grads = {f"vocoder.{n}": _full(p, p.grad) for n, p in state.vocoder.named_parameters()}
    grads.update({f"discriminators.{n}": _full(p, p.grad) for n, p in state.discriminators.named_parameters()})
    params = {n: _full(p, p) for n, p in state.vocoder.named_parameters()}
    whole = full_state_dict(state)  # a collective: every rank gathers
    if rank == 0:
        out.update(grads=grads, params=params, state=whole)
    # a whole state loads back into the sharded one, each rank its shards
    again = create_train_state(cfg, device="cpu")
    shard_params_tp(again.vocoder, mesh)
    load_full_state_dict(again, whole)
    out["reload_equal"] = all(torch.equal(a, b) for a, b in zip(again.vocoder.parameters(),
                                                                state.vocoder.parameters()))
    out["reload_moments_equal"] = all(
        torch.equal(again.gen_opt.adam.state[a]["exp_avg"], state.gen_opt.adam.state[b]["exp_avg"])
        for a, b in zip(again.gen_opt.params, state.gen_opt.params))
    return out


def _tensor_parallel_s2st(inputs) -> dict:
    """The tensor-parallel StreamSpeech forward (text logits) on a 2-wide
    ``model`` axis, with the count of its ``model`` all-reduces."""
    mesh = make_mesh(n_model=2)
    model = StreamSpeechS2ST(inputs["s2st_config"], gen=torch.Generator().manual_seed(0), with_vocoder=False,
                             with_transition_head=False).eval()
    model.load_state_dict(inputs["s2st"])
    shard_params_tp(model, mesh)
    before = tp.counts["model_all_reduce"]
    with torch.no_grad():
        out = model(torch.from_numpy(inputs["s2st_mel"]), torch.from_numpy(inputs["s2st_tokens"]), chunked=True,
                    run_vocoder=False)
    names = sorted(n for n, p in model.named_parameters() if hasattr(p, "tp_shard"))
    return {"text_logits": out["text_logits"].numpy(), "model_all_reduces": tp.counts["model_all_reduce"] - before,
            "sharded_names": names}


def parallel_checks(rank: int, world: int, inputs: dict) -> dict:
    """Every check of one world size in one process group: sequence
    parallelism, a data-parallel step (a ``data`` × ``model`` step and its
    clipped twin when ``world`` is 4) and, at 4, the tensor-parallel
    StreamSpeech forward."""
    out = _sequence(rank, inputs)
    n_model = inputs["n_model"]
    out["step"] = _train(rank, n_model, inputs, inputs["train_config"])
    if "clip_config" in inputs:
        out["clip_step"] = _train(rank, n_model, inputs, inputs["clip_config"])
    if "s2st" in inputs:
        out["s2st"] = _tensor_parallel_s2st(inputs)
    dist.barrier()
    return out


def cli_train(rank: int, world: int, argv: list, ragged_argv: list) -> dict:
    """``cli train`` on every rank of the group, then with a batch the
    ranks do not divide (which must raise)."""
    cli.main(argv)
    try:
        cli.main(ragged_argv)
        ragged = None
    except ValueError as e:
        ragged = str(e)
    return {"ragged": ragged}
