"""Command-line interface of the port: ``train``.

    python -m hifigan_tpu_torch.cli train --max_steps 1000 --checkpoint_dir ckpt [--bf16]
    python -m hifigan_tpu_torch.cli train --tiny --device cpu --max_steps 2 --checkpoint_dir /tmp/t

Counterpart of ``hifigan_tpu/cli.py``'s ``train``: GAN-trains the vocoder
on the synthetic pseudo-speech dataset, on the card unless ``--device
cpu``, appending one JSON line of metrics every ``--log_every`` steps to
``<checkpoint_dir>/metrics.jsonl`` and saving checkpoints there
(:mod:`hifigan_tpu_torch.train.checkpoint`).  ``--config`` (YAML),
``--data_dir``/``--augment``, the formant corpus, tensorboard events and
the multi-device mesh are not ported yet.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import time
from dataclasses import replace

import numpy as np
import torch

log = logging.getLogger("hifigan_tpu_torch")


def _prune_metrics(metrics_path: str, resume_step: int) -> None:
    """Drop ``metrics.jsonl`` rows past ``resume_step`` (and rows out of
    step order), so a run resumed from an older checkpoint appends no
    duplicate steps."""
    if not os.path.exists(metrics_path):
        return
    kept, last = [], -1
    with open(metrics_path) as f:
        for line in f:
            try:
                step = int(json.loads(line).get("step", -1))
            except (json.JSONDecodeError, TypeError, ValueError):
                continue
            if last < step <= resume_step:
                kept.append(line if line.endswith("\n") else line + "\n")
                last = step
    tmp = metrics_path + ".tmp"
    with open(tmp, "w") as f:
        f.writelines(kept)
    os.replace(tmp, metrics_path)


def _config(args):
    from hifigan_tpu_torch.models.generator import GeneratorConfig
    from hifigan_tpu_torch.ops.stft import MelConfig
    from hifigan_tpu_torch.train import LossWeights, TrainConfig

    cfg = TrainConfig(loss_weights=LossWeights(
        feature_matching=args.fm_weight, mel=args.mel_weight, adversarial=args.adv_weight,
        multi_res_stft=args.stft_weight, adversarial_type=args.adv_type))
    if args.tiny:
        cfg = replace(
            cfg,
            generator=GeneratorConfig(input_channels=16, hidden_channels=32, upsample_factors=(4, 2),
                                      resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), lora_rank=4),
            mel=MelConfig(n_fft=32, hop_length=8, win_length=32, n_mels=16),
            warmup_steps=0, decay_steps=1000,
            ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4,
        )
    return cfg


def cmd_train(args) -> None:
    from hifigan_tpu_torch.train import create_train_state, make_train_step
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.data import BatchLoader, SyntheticSpeechDataset
    from hifigan_tpu_torch.train.device_data import build_audio_bank, make_device_sampler

    cfg = _config(args)
    batch_size, seg = args.batch_size, args.segment_samples
    if args.tiny:
        seg = min(seg, 256)
    dataset = SyntheticSpeechDataset(segment_samples=seg, size=max(64, batch_size * 8))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    state = create_train_state(cfg, dtype, args.device, seed=args.seed)
    device = next(state.vocoder.parameters()).device
    steps_per_call = max(1, args.steps_per_call)
    sample_fn = None
    if args.device_data:
        # the whole corpus in device memory, crops drawn there: per call
        # the host sends one seed
        bank, lengths = build_audio_bank(dataset)
        sample_fn = make_device_sampler(torch.from_numpy(bank).to(device), torch.from_numpy(lengths), seg,
                                        batch_size)
        log.info("on-device data: %d utterances (%.0f MB) in device memory", bank.shape[0], bank.nbytes / 1e6)
    step_fn = make_train_step(cfg, multi_steps=steps_per_call, sample_fn=sample_fn,
                              deep_feature_matching=args.deep_fm)

    mgr = CheckpointManager(args.checkpoint_dir, save_interval=args.save_steps)
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state)
        log.info("resumed from step %d", state.step)
    loader = BatchLoader(dataset, batch_size, seed=args.seed, num_chunks=args.num_chunks)
    metrics_path = os.path.join(args.checkpoint_dir, "metrics.jsonl")
    steps_done = state.step
    _prune_metrics(metrics_path, steps_done)
    t_start = time.time()
    n_calls = max(1, len(dataset) // batch_size // steps_per_call)

    def batches(epoch, chunk):
        if sample_fn is not None:
            # one loader epoch's worth of calls, each a seed of its own
            for i in range(n_calls):
                yield (args.seed << 32) + (epoch * args.num_chunks + chunk) * n_calls + i
            return
        pending = []
        for batch in loader.epoch(epoch, chunk):
            pending.append(batch["audio"])
            if len(pending) == steps_per_call:
                yield {"audio": pending[0] if steps_per_call == 1 else np.stack(pending)}
                pending = []

    def finish():
        mgr.save(state, force=True)
        mgr.wait()
        _write_training_summary(args, cfg, device, steps_done, time.time() - t_start)

    with open(metrics_path, "a") as mf:
        for epoch in (itertools.count() if args.max_steps else range(args.epochs)):
            for chunk in range(args.num_chunks):
                for batch in batches(epoch, chunk):
                    try:
                        state, metrics = step_fn(state, batch)
                    except Exception:
                        # restore the last checkpoint and skip the batch
                        if not args.auto_recover or mgr.latest_step() is None:
                            raise
                        log.exception("step failed; restoring the last checkpoint")
                        mgr.restore(state)
                        continue
                    steps_done += steps_per_call
                    if steps_done % args.log_every < steps_per_call:
                        m = {k: float(v) for k, v in metrics.items()}
                        m.update(step=steps_done, epoch=epoch, wall_s=round(time.time() - t_start, 1))
                        mf.write(json.dumps(m) + "\n")
                        mf.flush()
                        log.info("step %d: G=%.3f D=%.3f mel=%.3f", steps_done, m["generator_loss"],
                                 m["discriminator_loss"], m["mel_loss"])
                    mgr.save(state)
                    if args.max_steps and steps_done >= args.max_steps:
                        finish()
                        log.info("done at step %d", steps_done)
                        return
                if args.num_chunks > 1:
                    mgr.save(state, force=True)  # a checkpoint per chunk (incremental training)
    finish()


def _write_training_summary(args, cfg, device, steps, wall_s) -> None:
    """The run's provenance, ``<checkpoint_dir>/training_summary.json``."""
    summary = {
        "completed_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "wall_seconds": round(wall_s, 1),
        "steps": steps,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "dtype": "bfloat16" if args.bf16 else "float32",
        "batch_size": args.batch_size,
        "learning_rate": cfg.learning_rate,
        "betas": [cfg.beta1, cfg.beta2],
        "loss_weights": {"adversarial": cfg.loss_weights.adversarial,
                         "feature_matching": cfg.loss_weights.feature_matching, "mel": cfg.loss_weights.mel},
        "data": "synthetic",
        "checkpoint_dir": args.checkpoint_dir,
    }
    with open(os.path.join(args.checkpoint_dir, "training_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(prog="hifigan_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="GAN-train the vocoder")
    t.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    t.add_argument("--checkpoint_dir", default="checkpoints")
    t.add_argument("--batch_size", type=int, default=16)
    t.add_argument("--segment_samples", type=int, default=8192)
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--max_steps", type=int, default=0)
    t.add_argument("--save_steps", type=int, default=5000)
    t.add_argument("--log_every", type=int, default=10)
    t.add_argument("--num_chunks", type=int, default=1)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--bf16", action="store_true")
    t.add_argument("--tiny", action="store_true", help="tiny model and segment sizes for smoke runs")
    t.add_argument("--auto_recover", action="store_true",
                   help="on a failed step, restore the last checkpoint and go on")
    t.add_argument("--steps_per_call", type=int, default=1, help="optimizer steps per call of the train step")
    t.add_argument("--device_data", action="store_true",
                   help="keep the whole dataset in device memory and draw crops there")
    t.add_argument("--deep_fm", action="store_true",
                   help="feature matching over the discriminators' intermediate maps")
    t.add_argument("--fm_weight", type=float, default=10.0)
    t.add_argument("--mel_weight", type=float, default=45.0)
    t.add_argument("--adv_weight", type=float, default=1.0)
    t.add_argument("--stft_weight", type=float, default=0.0, help="multi-resolution STFT loss weight")
    t.add_argument("--adv_type", choices=["lsgan", "hinge"], default="lsgan")
    t.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
