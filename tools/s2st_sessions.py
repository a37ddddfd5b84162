#!/usr/bin/env python3
"""Run ``cli eval-s2st`` of the JAX package or of the PyTorch port, as it is,
and write one JSON line per streaming session it runs: its order, the
agent's class and decoding, the segment size, the committed text ids, the
number of emitted units and the session's Average Lagging.  ``compare``
names the sessions whose text differs between two such files.

    python tools/s2st_sessions.py run jax sessions_jax.jsonl -- --cpu eval-s2st --samples 24 \\
        --speech_policies offline,stride1,waitk3 --output report_jax.json
    python tools/s2st_sessions.py run torch sessions_port.jsonl -- eval-s2st --checkpoint s2st.pt \\
        --asr ctc_judge.pt --samples 24 --speech_policies offline,stride1,waitk3 --output report_port.json
    python tools/s2st_sessions.py compare sessions_jax.jsonl sessions_port.jsonl --samples 24

``run jax`` imports only the JAX package, ``run torch`` only the port.
Sessions are numbered in the order the command runs them: policy by
policy, each over the samples in order.
"""

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACKAGES = {"jax": "hifigan_tpu", "torch": "hifigan_tpu_torch"}


def run(package: str, sessions_path: str, argv: list) -> None:
    streaming = importlib.import_module(f"{PACKAGES[package]}.streaming")
    cli = importlib.import_module(f"{PACKAGES[package]}.cli")
    session_fn = streaming.run_streaming_session
    out = open(sessions_path, "w")
    count = [0]

    def recorded(agent, *args, **kw):
        result = session_fn(agent, *args, **kw)
        out.write(json.dumps({
            "index": count[0],
            "agent": type(agent).__name__,
            "decode": getattr(agent, "decode", None),
            "hmt_transition": getattr(agent, "hmt_transition", None),
            "stride_n": getattr(getattr(agent, "gate", None), "stride_n", None),
            "segment_size_ms": kw.get("segment_size_ms"),
            "text_ids": [int(i) for i in getattr(agent, "committed_text_ids", [])],
            "n_units": len(getattr(agent, "emitted_units", [])),
            "average_lagging_ms": float(result.average_lagging_ms),
        }) + "\n")
        out.flush()
        count[0] += 1
        return result

    streaming.run_streaming_session = recorded
    try:
        cli.main(argv)
    finally:
        out.close()


def compare(a_path: str, b_path: str, samples: int) -> None:
    a = [json.loads(line) for line in open(a_path)]
    b = [json.loads(line) for line in open(b_path)]
    if len(a) != len(b):
        print(f"{len(a)} sessions against {len(b)}: compared as far as both go")
    differ = 0
    for x, y in zip(a, b):
        key = (x["agent"], x["decode"], x["hmt_transition"], x["stride_n"], x["segment_size_ms"])
        if key != (y["agent"], y["decode"], y["hmt_transition"], y["stride_n"], y["segment_size_ms"]):
            raise SystemExit(f"session {x['index']}: {key} against another agent {y}")
        if x["text_ids"] != y["text_ids"] or x["n_units"] != y["n_units"]:
            differ += 1
            first = next((i for i, (s, t) in enumerate(zip(x["text_ids"], y["text_ids"])) if s != t),
                         min(len(x["text_ids"]), len(y["text_ids"])))
            print(json.dumps({"index": x["index"], "sample": x["index"] % samples, "agent": key,
                              "first_differing_token": first, "a": x["text_ids"], "b": y["text_ids"],
                              "a_units": x["n_units"], "b_units": y["n_units"],
                              "a_al": x["average_lagging_ms"], "b_al": y["average_lagging_ms"]}))
    print(f"{differ} of {min(len(a), len(b))} sessions differ")


def main() -> None:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="what", required=True)
    r = sub.add_parser("run")
    r.add_argument("package", choices=sorted(PACKAGES))
    r.add_argument("sessions")
    r.add_argument("argv", nargs=argparse.REMAINDER, help="after --: the cli's own arguments")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--samples", type=int, required=True)
    args = p.parse_args()
    if args.what == "run":
        argv = args.argv[1:] if args.argv[:1] == ["--"] else args.argv
        run(args.package, args.sessions, argv)
    else:
        compare(args.a, args.b, args.samples)


if __name__ == "__main__":
    main()
