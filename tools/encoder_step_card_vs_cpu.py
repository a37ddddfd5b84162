"""Where the fp32 encoder step on the card parts from the same step on the CPU.

    python tools/encoder_step_card_vs_cpu.py [--seeds 1 2] [--batch 4]

Runs one ``make_encoder_train_step`` of ``EncoderTrainConfig()`` at
``--batch`` from the seeded state (``create_encoder_state(seed=s)``) on the
same crops on the card and on the CPU, TF32 off, and prints per seed:

- each loss on both devices;
- the leaves whose gradient differs most, by the largest error as a share
  of the leaf's peak and by the relative L2 error, and how many leaves
  exceed 1e-4 of their peak;
- for ECAPA-TDNN's last SE-Res2 block and the layers after it, the
  relative difference of each module's output (forward) and of the
  gradient of its output (backward), with cuDNN on and off.

Needs a CUDA card; prints one JSON object a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hifigan_tpu_torch.train.encoder_pretrain import (  # noqa: E402
    EncoderTrainConfig,
    build_labelled_bank,
    create_encoder_state,
    make_encoder_sampler,
    make_encoder_train_step,
)

WATCHED = ("block_1", "block_2", "block_2.conv1x1_in", "block_2.norm_in", "block_2.conv1x1_out", "block_2.norm_out",
           "block_2.se", "expand", "asp", "embed", "embed_norm")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))


def _step(cfg, bank, batch, device: str, seed: int) -> tuple[dict, dict, dict]:
    """(metrics, gradients by leaf, ECAPA module outputs and their
    gradients) of one step on ``device``."""
    audio, lengths, speakers, bins = bank
    state = create_encoder_state(cfg, torch.float32, device, seed=seed)
    seen = {}
    for name, module in state.ecapa.named_modules():
        if name in WATCHED:
            module.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(("fwd", name), o.detach().cpu()))
            module.register_full_backward_hook(
                lambda m, gi, go, name=name: seen.__setitem__(("bwd", name), go[0].detach().cpu()))
    step = make_encoder_train_step(cfg, torch.from_numpy(audio).to(device), lengths, speakers, bins)
    _, metrics = step(state, batch)
    grads = {f"{m}.{n}": (torch.zeros_like(p) if p.grad is None else p.grad).detach().double().cpu()
             for m in ("ecapa", "emo") for n, p in getattr(state, m).named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, seen


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--utterances_per_speaker", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(EncoderTrainConfig(), batch_size=args.batch)
    bank = build_labelled_bank(n_speakers=cfg.n_speakers, utterances_per_speaker=args.utterances_per_speaker)
    audio, lengths, speakers, bins = bank
    sample = make_encoder_sampler(cfg, *(torch.from_numpy(a) for a in (lengths, speakers, bins)))
    for seed in args.seeds:
        batch = sample(torch.Generator().manual_seed(seed + 1), torch.from_numpy(audio))
        runs = {}
        for name, device, cudnn in (("cpu", "cpu", True), ("cuda", "cuda", True), ("cuda_no_cudnn", "cuda", False)):
            torch.backends.cudnn.enabled = cudnn
            runs[name] = _step(cfg, bank, batch, device, seed)
        torch.backends.cudnn.enabled = True
        cpu_metrics, cpu_grads, cpu_seen = runs["cpu"]
        report = {"seed": seed, "device": torch.cuda.get_device_name(0), "losses": {}}
        for name in ("cuda", "cuda_no_cudnn"):
            metrics, grads, seen = runs[name]
            by_max = sorted(((_rel(cpu_grads[k], grads[k]), k) for k in cpu_grads), reverse=True)
            by_l2 = sorted((((cpu_grads[k] - grads[k]).norm() / cpu_grads[k].norm().clamp_min(1e-30)).item(), k)
                           for k in cpu_grads)[::-1]
            report["losses"][name] = metrics
            report[name] = {
                "leaves_over_1e-4_of_peak": sum(r > 1e-4 for r, _ in by_max),
                "leaves": len(by_max),
                "worst_max_share_of_peak": [(f"{r:.3g}", k) for r, k in by_max[:6]],
                "worst_rel_l2": [(f"{r:.3g}", k) for r, k in by_l2[:6]],
                "ecapa_modules": {f"{kind} {mod}": f"{_rel(cpu_seen[(kind, mod)], seen[(kind, mod)]):.3g}"
                                  for kind, mod in sorted(cpu_seen) if (kind, mod) in seen},
            }
        report["losses"]["cpu"] = cpu_metrics
        print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
