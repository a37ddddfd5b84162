#!/usr/bin/env python3
"""Run the port's ``cli eval-clone`` on the card twice, with cuDNN's TF32
convolutions off and then on (PyTorch's default), cuBLAS TF32 off both
times, and write each report: how far the card's TF32 convolutions move
the voice-cloning figures of an fp32 model.

    python tools/eval_clone_tf32.py OUT_DIR -- --checkpoint_dir ckpt --encoders encoders.pt

Writes ``OUT_DIR/eval_clone_tf32_off.json`` and ``..._on.json`` and prints
the card's name and power limit.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hifigan_tpu_torch import cli  # noqa: E402


def main() -> None:
    out_dir, argv = sys.argv[1], sys.argv[2:]
    argv = argv[1:] if argv[:1] == ["--"] else argv
    os.makedirs(out_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        cli.main(["eval-clone", *argv, "--output", os.path.join(out_dir, f"eval_clone_tf32_{'on' if tf32 else 'off'}.json")])


if __name__ == "__main__":
    main()
