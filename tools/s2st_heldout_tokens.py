#!/usr/bin/env python3
"""Run ``cli train-s2st`` of the JAX package or of the PyTorch port, as it
is, and write the tokens its held-out evaluation (``--eval_samples``)
decodes: one JSON line per held-out utterance, its index and its greedy
tokens (zeros dropped).  ``compare`` names the utterances whose tokens
differ between two such files.

    python tools/s2st_heldout_tokens.py run jax tokens_jax.jsonl -- --cpu train-s2st \\
        --checkpoint_dir s2st3_copy --resume --max_steps 60002 --dataset_size 32 --eval_samples 32
    python tools/s2st_heldout_tokens.py run torch tokens_port.jsonl -- train-s2st \\
        --checkpoint_dir s2st3 --resume --max_steps 60002 --dataset_size 32 --eval_samples 32
    python tools/s2st_heldout_tokens.py compare tokens_jax.jsonl tokens_port.jsonl

``run jax`` imports only the JAX package, ``run torch`` only the port.  The
command writes into its ``--checkpoint_dir`` as the trainer does (its
config, ``metrics.jsonl`` pruned past the step, ``s2st_eval.json``): give
it a copy of a run.
"""

import argparse
import importlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACKAGES = {"jax": "hifigan_tpu", "torch": "hifigan_tpu_torch"}


def run(package: str, tokens_path: str, argv: list) -> None:
    task = importlib.import_module(f"{PACKAGES[package]}.train.s2st_task")
    cli = importlib.import_module(f"{PACKAGES[package]}.cli")
    real = task.make_greedy_translate
    decoded = []

    def recorded(*args, **kw):
        translate = real(*args, **kw)

        def run_batch(*batch):
            toks = translate(*batch)
            decoded.extend(np.asarray(toks.cpu() if hasattr(toks, "cpu") else toks).tolist())
            return toks

        return run_batch

    task.make_greedy_translate = recorded
    try:
        cli.main(argv)
    finally:
        task.make_greedy_translate = real
    with open(tokens_path, "w") as f:
        for i, toks in enumerate(decoded):
            f.write(json.dumps({"index": i, "tokens": [t for t in toks if t != 0]}) + "\n")
    print(f"{len(decoded)} held-out utterances decoded -> {tokens_path}")


def compare(a_path: str, b_path: str) -> int:
    read = lambda p: [json.loads(line)["tokens"] for line in open(p)]  # noqa: E731
    a, b = read(a_path), read(b_path)
    if len(a) != len(b):
        print(f"{a_path} has {len(a)} utterances, {b_path} {len(b)}")
        return 1
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    print(json.dumps({"utterances": len(a), "differ": differ}))
    return 1 if differ else 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    r = sub.add_parser("run")
    r.add_argument("package", choices=sorted(PACKAGES))
    r.add_argument("tokens")
    r.add_argument("argv", nargs=argparse.REMAINDER, help="-- then the cli arguments")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args()
    if args.what == "compare":
        return compare(args.a, args.b)
    argv = args.argv[1:] if args.argv[:1] == ["--"] else args.argv
    run(args.package, args.tokens, argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
