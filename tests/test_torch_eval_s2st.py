"""``cli eval-s2st`` and ``cli simulate --decode hmt`` of the port on the CPU
at tiny widths, on files of ``weights.save_s2st_checkpoint`` and
``weights.save_ctc_judge``: the report has JAX's keys, the ``--policies``
and ``--speech_policies`` errors are JAX's, and each policy's token F1 and
Average Lagging equal those of the same loop run through the JAX
package's agents, harness and ``token_f1`` on the same held-out
utterances with the same weights (``cmd_eval_s2st``'s loop,
``hifigan_tpu/cli.py:1179-1228``).  The wait-k rows are left out: JAX's
``WaitkS2TTAgent`` has no end-of-buffer stop, and the seeded decoder
writes no EOS (ROADMAP Queue 3)."""

import json

import numpy as np
import pytest
import torch
from test_torch_code_vocoder import TINY_CODE, _code_pair
from test_torch_eval import write_tiny_judge
from test_torch_s2st import TINY_SS, _s2st_pair

from hifigan_tpu_torch import cli
from hifigan_tpu_torch.weights import read_s2st_step, save_s2st_checkpoint

SAMPLES = 2
TEXT_POLICIES = "offline_greedy,stride1_greedy,hmt_confidence,hmt_learned"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny S2ST stack (the jittered draw of ``test_torch_hmt.py``, with
    the transition head) and unit vocoder as one port file of step 7, the
    tiny CTC judge's file, and the JAX trees of the same weights."""
    d = tmp_path_factory.mktemp("eval_s2st")
    jm, params, tm = _s2st_pair(TINY_SS, 8, vocoder=False, transition_head=True, draw="init_jitter")
    _jcv, _cv_params, tcv = _code_pair(TINY_CODE, 9)
    save_s2st_checkpoint(str(d / "s2st.pt"), tm, tcv, step=7)
    _jdir, judge = write_tiny_judge(d)
    return {"dir": d, "s2st": str(d / "s2st.pt"), "judge": judge, "jax": (jm, params)}


def _jax_loop(files, names):
    """``cmd_eval_s2st``'s text loop through the JAX package."""
    from hifigan_tpu.streaming import run_streaming_session
    from hifigan_tpu.streaming.agents import S2TTAgent
    from hifigan_tpu.streaming.runtime import S2STInference, S2STInferenceConfig
    from hifigan_tpu.train.corpus import FormantSpeechCorpus, plan_phone_ids
    from hifigan_tpu.train.s2st_task import token_f1, translate

    jm, params = files["jax"]
    inf = S2STInference(jm, params, cfg=S2STInferenceConfig(max_target_len=64))
    corpus = FormantSpeechCorpus(n_speakers=32)
    samples = []
    for i in range(SAMPLES):
        wav, plan, _ = corpus.utterance(i % 32, 0, content=2_000_000 + i, return_plan=True)
        samples.append((wav, translate(plan_phone_ids(plan))))
    kws = {"offline_greedy": {"stride_n": 1}, "stride1_greedy": {"stride_n": 1},
           "hmt_confidence": {"decode": "hmt", "hmt_transition": "confidence"},
           "hmt_learned": {"decode": "hmt", "hmt_transition": "learned"}}
    rows = {}
    for name in names:
        f1s, als = [], []
        for wav, ref in samples:
            agent = S2TTAgent(inf, **kws[name])
            res = run_streaming_session(agent, wav, sample_rate=16_000,
                                        segment_size_ms=1_000_000 if name == "offline_greedy" else 320)
            f1s.append(token_f1(list(agent.committed_text_ids), ref))
            als.append(res.average_lagging_ms)
        rows[name] = {"token_f1": round(float(np.mean(f1s)), 4), "average_lagging_ms": round(float(np.mean(als)), 1),
                      "n": SAMPLES}
    return rows


def test_cli_eval_s2st_matches_jax_loop(files, capsys):
    """Four text policies over 2 held-out utterances: JAX's report keys
    (the judge fails its gate, so no speech rows, as in JAX), the file's
    step as ``restored_step``, and every policy's F1 and AL equal to JAX's
    loop; the HMT rows commit text."""
    out = files["dir"] / "report.json"
    cli.main(["eval-s2st", "--device", "cpu", "--checkpoint", files["s2st"], "--asr", files["judge"],
              "--samples", str(SAMPLES), "--policies", TEXT_POLICIES, "--output", str(out)])
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert set(report) == {"checkpoint_dir", "restored_step", "policies", "asr_judge"}
    assert report["restored_step"] == 7 == read_s2st_step(files["s2st"])
    assert set(report["asr_judge"]) == {"dir", "independent", "gate"} and report["asr_judge"]["dir"] is None
    gate = report["asr_judge"]["gate"]
    assert set(gate) == {"candidates", "selected", "max_cer"} and not gate["candidates"][0]["competent"]
    want = _jax_loop(files, TEXT_POLICIES.split(","))
    print("[eval-s2st]", json.dumps(report["policies"]))
    assert report["policies"] == want
    assert all(np.isfinite(r["token_f1"]) and r["average_lagging_ms"] > 0 for r in want.values())


def test_cli_eval_s2st_speech_rows(files, monkeypatch, capsys):
    """With a judge that passes the gate (a stand-in transcriber), the
    speech rows run: ``s2st_speech_tradeoff`` per speech policy and the
    ``s2st_asr_bleu`` headline under JAX's keys, and ``--save_wavs`` writes
    the (source, output) pairs; ``--policies none`` skips the text grid."""
    from hifigan_tpu_torch.eval import asr

    heard = []

    def competent(candidates, clips, refs, max_cer=0.4, device="cuda"):
        def transcribe(wav):
            heard.append(len(wav))
            return "a e"
        return transcribe, {"candidates": [{"dir": candidates[0], "competent": True}], "selected": candidates[0],
                            "max_cer": max_cer}

    monkeypatch.setattr(asr, "load_competent_ctc", competent)
    wavs = files["dir"] / "wavs"
    cli.main(["eval-s2st", "--device", "cpu", "--checkpoint", files["s2st"], "--asr", files["judge"],
              "--samples", str(SAMPLES), "--policies", "none", "--speech_policies", "offline,stride1",
              "--save_wavs", str(wavs)])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"checkpoint_dir", "restored_step", "policies", "asr_judge", "s2st_speech_tradeoff",
                           "s2st_asr_bleu"} and report["policies"] == {}
    assert report["asr_judge"]["independent"] and list(report["s2st_speech_tradeoff"]) == ["offline", "stride1"]
    for row in report["s2st_speech_tradeoff"].values():
        assert set(row) == {"bleu", "average_lagging_ms", "n", "example_hyp", "example_ref"} and row["n"] == SAMPLES
    assert report["s2st_asr_bleu"]["policy"] == "stride1"
    assert len(heard) == 2 * SAMPLES and min(heard) > 0
    assert sorted(p.name for p in wavs.iterdir()) == [f"s2st_{i:02d}_{t}.wav" for i in range(SAMPLES)
                                                       for t in ("out", "src")]


def test_s2st_checkpoint_without_a_step_reads_as_step_0(files, tmp_path):
    """A ``save_s2st_checkpoint`` file written before the step was recorded
    reads as step 0, and still loads."""
    from hifigan_tpu_torch.weights import load_s2st_checkpoint

    ckpt = torch.load(files["s2st"], map_location="cpu", weights_only=True)
    del ckpt["step"]
    torch.save(ckpt, tmp_path / "old.pt")
    assert read_s2st_step(str(tmp_path / "old.pt")) == 0
    model, _ = load_s2st_checkpoint(str(tmp_path / "old.pt"), "cpu")
    assert model.transition_head is not None


@pytest.mark.parametrize("argv,message", [
    (["--policies", " "], "--policies needs policy names"),
    (["--policies", "none,hmt_learned"], "'none' cannot be combined"),
    (["--policies", "stride3_greedy"], "unknown policies"),
])
def test_cli_eval_s2st_policy_errors(files, argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["eval-s2st", "--device", "cpu", "--checkpoint", files["s2st"], "--samples", "1", *argv])


def test_cli_eval_s2st_speech_policy_error(files, monkeypatch):
    from hifigan_tpu_torch.eval import asr

    monkeypatch.setattr(asr, "load_competent_ctc", lambda c, *a, **k: (lambda w: "", {"selected": c[0]}))
    with pytest.raises(SystemExit, match="--speech_policies: unknown"):
        cli.main(["eval-s2st", "--device", "cpu", "--checkpoint", files["s2st"], "--asr", files["judge"],
                  "--samples", "1", "--policies", "none", "--speech_policies", "stride2"])


def test_cli_simulate_hmt_learned_matches_jax(files, capsys):
    """``simulate --decode hmt --hmt_transition learned --checkpoint``: the
    held-out utterance of ``--seed 1`` and the phone detokeniser, as JAX's
    ``cmd_simulate`` runs a trained stack; the text equals a JAX S2TT
    session over the same utterance with the same weights."""
    from hifigan_tpu.streaming import run_streaming_session
    from hifigan_tpu.streaming.agents import S2TTAgent
    from hifigan_tpu.streaming.runtime import S2STInference
    from hifigan_tpu.train.corpus import PHONES, FormantSpeechCorpus

    cli.main(["simulate", "--agent", "s2tt", "--device", "cpu", "--checkpoint", files["s2st"], "--decode", "hmt",
              "--hmt_transition", "learned", "--seed", "1"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jm, params = files["jax"]
    audio = FormantSpeechCorpus(n_speakers=32).utterance(1, 0, content=2_000_001)

    def detok(ids):
        return " ".join(PHONES[i - 2] if 1 <= i - 2 < len(PHONES) else f"<{i}>" for i in ids)

    want = run_streaming_session(S2TTAgent(S2STInference(jm, params), decode="hmt", hmt_transition="learned",
                                           detokenize=detok), audio, sample_rate=16_000, segment_size_ms=320)
    assert got["agent"] == "s2tt" and got["source_seconds"] == want.source_seconds
    assert got["text"] == want.text[:200] and got["text"].strip()
    assert got["writes"] == len(want.outputs) and got["average_lagging_ms"] == round(want.average_lagging_ms, 1)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """A ``cli train-s2st --tiny`` run and a ``cli train-unit-vocoder
    --tiny`` run of one step each (the two share 32 units)."""
    d = tmp_path_factory.mktemp("runs")
    cli.main(["train-s2st", "--tiny", "--device", "cpu", "--batch_size", "2", "--max_steps", "1", "--eval_samples",
              "0", "--checkpoint_dir", str(d / "s2st")])
    cli.main(["train-unit-vocoder", "--tiny", "--device", "cpu", "--max_steps", "1", "--checkpoint_dir",
              str(d / "uv")])
    return d


def test_cli_eval_s2st_reads_run_directories(files, run_dirs, monkeypatch, capsys):
    """``eval-s2st --checkpoint_dir <train-s2st run> --unit_vocoder
    <train-unit-vocoder run>``, with a stand-in judge that passes the gate:
    JAX's report keys, the run's step as ``restored_step``, the run
    directory as ``checkpoint_dir``, speech rows voiced by the unit vocoder;
    the same report (but for ``checkpoint_dir``) as ``--checkpoint`` on a
    ``save_s2st_checkpoint`` file of the two runs' models."""
    from hifigan_tpu_torch.eval import asr
    from hifigan_tpu_torch.weights import load_s2st_run, load_unit_vocoder_run

    heard = []

    def competent(candidates, clips, refs, max_cer=0.4, device="cuda"):
        def transcribe(wav):
            heard.append(len(wav))
            return "a e"
        return transcribe, {"candidates": [], "selected": candidates[0], "max_cer": max_cer}

    monkeypatch.setattr(asr, "load_competent_ctc", competent)
    args = ["eval-s2st", "--device", "cpu", "--asr", files["judge"], "--samples", "1", "--policies",
            "offline_greedy,hmt_learned", "--speech_policies", "stride1"]
    cli.main([*args, "--checkpoint_dir", str(run_dirs / "s2st"), "--unit_vocoder", str(run_dirs / "uv")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"checkpoint_dir", "restored_step", "policies", "asr_judge", "s2st_speech_tradeoff",
                           "s2st_asr_bleu"}
    assert report["restored_step"] == 1 and report["checkpoint_dir"] == str(run_dirs / "s2st")
    assert len(heard) == 1 and heard[0] > 0
    model, step = load_s2st_run(str(run_dirs / "s2st"), "cpu")
    code_vocoder, uv_step = load_unit_vocoder_run(str(run_dirs / "uv"), "cpu")
    assert step == uv_step == 1 and model.vocoder is None and model.transition_head is not None
    save_s2st_checkpoint(str(run_dirs / "both.pt"), model, code_vocoder, step=step)
    cli.main([*args, "--checkpoint", str(run_dirs / "both.pt")])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: v for k, v in again.items() if k != "checkpoint_dir"} == {
        k: v for k, v in report.items() if k != "checkpoint_dir"}


def test_cli_simulate_reads_run_directories(run_dirs, capsys):
    """``simulate --checkpoint_dir --unit_vocoder``: a trained stack's
    session (the held-out utterance, phone names) with output speech."""
    cli.main(["simulate", "--device", "cpu", "--checkpoint_dir", str(run_dirs / "s2st"), "--unit_vocoder",
              str(run_dirs / "uv")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["agent"] == "s2st" and got["source_seconds"] > 1 and got["output_samples"] > 0


@pytest.mark.parametrize("command,argv,message", [
    ("eval-s2st", ["--checkpoint", "x.pt", "--checkpoint_dir", "d"], "not both"),
    ("simulate", ["--checkpoint", "x.pt", "--checkpoint_dir", "d"], "not both"),
    ("eval-s2st", ["--checkpoint", "x.pt", "--unit_vocoder", "d"], "--unit_vocoder goes with --checkpoint_dir"),
])
def test_checkpoint_flags_conflict(command, argv, message, tmp_path):
    """``--checkpoint`` with ``--checkpoint_dir`` (or ``--unit_vocoder``
    without ``--checkpoint_dir``) exits with an error before reading any
    file."""
    with pytest.raises(SystemExit, match=message):
        cli.main([command, "--device", "cpu", *argv])
