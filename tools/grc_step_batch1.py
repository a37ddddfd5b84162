"""The bf16 GRC-step kernel at serving's shape, batch 1, on the card.

    python tools/grc_step_batch1.py

The serving path (`cli serve`'s vocoder route, 1 x 256 mel frames) runs the
nine MRF steps of ``GeneratorConfig()`` on ``pre [1, 65536, 32]`` bf16.  For
each (k, d) step, on ``chip_smoke.py``'s seeded inputs with normalised
statistics (``_step_inputs(batch=1)``): the kernel against its plain
version (``chip_smoke._check_step``'s limits), then the device time of the
kernel, the plain version and ``F.conv1d`` of the same dilated conv, each
from CUDA events around a CUDA graph of 10 calls, median of 25
(``chip_smoke._device_ms``), and the step's bound at batch 1
(``chip_smoke._step_bound_ms``: bytes over 3.35 TB/s, operations over the
bf16 tensor cores' 989 TFLOP/s).  Prints the card's name and power limit
and one JSON line: the rows and the nine steps' totals.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from hifigan_tpu_torch.models.generator import GeneratorConfig  # noqa: E402
from hifigan_tpu_torch.ops.cuda import build, grc_kernel  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("grc_step_batch1: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    build.load_library()
    cfg = GeneratorConfig()
    steps = [(k, d) for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations) for d in dils]
    rows = []
    with torch.no_grad():
        for i, (k, d) in enumerate(steps):
            args, lo = cs._step_inputs(k, d, torch.bfloat16, True, seed=100 * i + 1, batch=1)
            err, rel = cs._check_step(grc_kernel.grc_step(*args, lo=lo, dilation=d),
                                      grc_kernel.grc_step_reference(*args, lo=lo, dilation=d), torch.bfloat16)
            y_cf = args[0].transpose(1, 2).contiguous()
            w_lib = args[5].permute(2, 1, 0).contiguous()
            bytes_ms, ops_ms = cs._step_bound_ms(k, torch.bfloat16, batch=1)
            rows.append({"k": k, "d": d, "max_abs_err": err, "sum_rel_err": rel,
                         "ms": cs._device_ms(lambda: grc_kernel.grc_step(*args, lo=lo, dilation=d)),
                         "plain_ms": cs._device_ms(lambda: grc_kernel.grc_step_reference(*args, lo=lo, dilation=d)),
                         "library_ms": cs._device_ms(lambda: F.conv1d(y_cf, w_lib, padding=lo, dilation=d)),
                         "bytes_ms": bytes_ms, "ops_ms": ops_ms})
    totals = {key: sum(r[key] for r in rows) for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    totals["bound_ms"] = sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows)
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations"
    print(json.dumps({"shape": [1, cs.T_AUDIO, cs.C], "dtype": "bf16", "rows": rows, "totals": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
