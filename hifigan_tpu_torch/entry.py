"""Entry points: build the flagship generator, the voice-cloning vocoder,
the streaming S2ST stack and example inputs.

All run on the card unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import torch

from hifigan_tpu_torch.models.code_vocoder import CodeVocoder, CodeVocoderConfig
from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.models.streamspeech import StreamSpeechConfig, StreamSpeechS2ST
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder
from hifigan_tpu_torch.streaming.runtime import S2STInference, S2STInferenceConfig


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def build_generator(
    config: GeneratorConfig = GeneratorConfig(),
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> Generator:
    """A ``Generator`` with weights drawn from ``seed`` (the JAX package's
    initialisers), on ``device``, computing in ``dtype``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return Generator(config, dtype, gen=gen).to(device).eval()


def build_vocoder(
    config: GeneratorConfig = GeneratorConfig(),
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    seed: int = 0,
    ecapa_channels: int = 512,
    emo_hidden: int = 512,
    emo_layers: int = 6,
    emo_heads: int = 8,
) -> ModifiedVocoder:
    """A ``ModifiedVocoder`` (generator + ECAPA-TDNN + Emotion2Vec; the
    defaults are ``TrainConfig()``'s widths) with weights drawn from
    ``seed``, on ``device``, computing in ``dtype``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return ModifiedVocoder(config, ecapa_channels, emo_hidden, emo_layers, emo_heads, dtype,
                           gen=gen).to(device).eval()


def build_s2st(
    config: StreamSpeechConfig = StreamSpeechConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> StreamSpeechS2ST:
    """A ``StreamSpeechS2ST`` (with its vocoder and transition head) with
    weights drawn from ``seed`` (the JAX package's initialisers), fp32, in
    eval mode, on ``device``."""
    device = resolve_device(device)
    return StreamSpeechS2ST(config, gen=torch.Generator().manual_seed(seed)).to(device).eval()


def build_code_vocoder(
    config: CodeVocoderConfig = CodeVocoderConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> CodeVocoder:
    """A ``CodeVocoder`` with weights drawn from ``seed``, fp32, in eval
    mode, on ``device``."""
    device = resolve_device(device)
    return CodeVocoder(config, gen=torch.Generator().manual_seed(seed)).to(device).eval()


def build_s2st_inference(
    config: StreamSpeechConfig = StreamSpeechConfig(),
    code_config: CodeVocoderConfig | None = None,
    inference_config: S2STInferenceConfig = S2STInferenceConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> S2STInference:
    """The streaming S2ST runtime over ``build_s2st(config, seed)`` and
    ``build_code_vocoder(code_config, seed + 1)``, the pair ``cli
    simulate`` runs without a checkpoint; ``code_config`` defaults to
    ``CodeVocoderConfig()`` over ``config``'s unit vocabulary."""
    code_config = code_config or CodeVocoderConfig(unit_vocab_size=config.unit_vocab_size)
    return S2STInference(build_s2st(config, device, seed), build_code_vocoder(code_config, device, seed + 1),
                         inference_config)


def entry(device: str | torch.device = "cuda"):
    """Returns ``(model, (mel, spk, emo))``: the flagship generator (full
    config, bf16, seed 0) and a batch of 2 × 64 mel frames, the counterpart
    of ``__graft_entry__.entry()``."""
    device = resolve_device(device)
    model = build_generator(GeneratorConfig(), torch.bfloat16, device, seed=0)
    gens = [torch.Generator().manual_seed(s) for s in (0, 1, 2)]
    mel = torch.randn((2, 80, 64), generator=gens[0])
    spk = torch.randn((2, 192), generator=gens[1])
    emo = torch.randn((2, 256), generator=gens[2])
    return model, tuple(t.to(device) for t in (mel, spk, emo))


def _tiny_train_config():
    """``__graft_entry__.dryrun_multichip``'s tiny GAN config."""
    from hifigan_tpu_torch.ops.stft import MelConfig
    from hifigan_tpu_torch.train.state import TrainConfig

    return TrainConfig(
        generator=GeneratorConfig(input_channels=16, hidden_channels=32, upsample_factors=(4, 2),
                                  resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), lora_rank=4),
        mel=MelConfig(n_fft=32, hop_length=8, win_length=32, n_mels=16),
        warmup_steps=0, decay_steps=100, ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4)


DRYRUN_S2ST = StreamSpeechConfig(input_dim=16, hidden_dim=32, encoder_layers=2, decoder_layers=2, num_heads=4,
                                 vocab_size=64, unit_vocab_size=32, chunk_size=8, vocoder_hidden=32,
                                 vocoder_upsample=(4, 2), ecapa_channels=32, emo_hidden=32, emo_layers=1)


def _dryrun_rank(rank: int, world: int) -> dict:
    """One rank of :func:`dryrun_multichip`; returns its checks' numbers."""
    import torch.distributed as dist

    from hifigan_tpu_torch.models.conformer import ChunkedConformer
    from hifigan_tpu_torch.parallel import (
        conformer_forward_seq_sharded,
        make_mesh,
        make_sharded_train_step,
        shard_params_tp,
    )
    from hifigan_tpu_torch.parallel.tensor import counts
    from hifigan_tpu_torch.train.state import create_train_state
    from hifigan_tpu_torch.train.train_step import make_train_step

    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    n_model = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(world // n_model, n_model)

    # one data x model step of the tiny GAN trainer, the vocoder sharded
    cfg = _tiny_train_config()
    state = create_train_state(cfg, torch.float32, device, seed=0)
    shard_params_tp(state.vocoder, mesh)
    step = make_sharded_train_step(make_train_step(cfg), mesh)
    audio = torch.randn((max(8, world), 128), generator=torch.Generator().manual_seed(3)) * 0.1
    state, metrics = step(state, {"audio": audio.to(device)})
    assert state.step == 1
    metrics = {k: float(v) for k, v in metrics.items()}
    for k, v in metrics.items():
        assert v == v, f"non-finite metric {k}"

    # sequence parallelism: the time-sharded chunked Conformer over every
    # rank, against the unsharded forward
    enc = ChunkedConformer(16, 32, 1, 4, 8, gen=torch.Generator().manual_seed(5)).to(device).eval()
    mel = torch.randn((2, 8 * world, 16), generator=torch.Generator().manual_seed(4)).to(device)
    with torch.no_grad():
        ref = enc(mel, chunked=True)
    out = conformer_forward_seq_sharded(enc, mel)
    t = out.shape[1]
    sp_err = (out - ref[:, rank * t: (rank + 1) * t]).abs().max()
    dist.all_reduce(sp_err, op=dist.ReduceOp.MAX)
    sp_err = float(sp_err)
    assert sp_err < 1e-3, f"SP parity {sp_err}"

    # tensor parallelism over the Conformer encoder and the text decoder:
    # the rules partition leaves inside both, and the forward runs sharded
    tp_partitioned, tp_err, tp_reduces = 0, 0.0, 0
    if n_model > 1:
        ss = StreamSpeechS2ST(DRYRUN_S2ST, gen=torch.Generator().manual_seed(7), with_vocoder=False,
                              with_transition_head=False).to(device).eval()
        mel_ss = torch.randn((2, 16, 16), generator=torch.Generator().manual_seed(6)).to(device)
        tgt = torch.zeros((2, 8), dtype=torch.long, device=device)
        with torch.no_grad():
            want = ss(mel_ss, tgt, chunked=True, run_vocoder=False)["text_logits"]
        shard_params_tp(ss, mesh)
        names = [n for n, p in ss.named_parameters() if hasattr(p, "tp_shard")]
        tp_partitioned = len(names)
        for sub in ("encoder", "text_decoder"):
            assert any(n.startswith(sub + ".") for n in names), f"no model-axis sharding inside {sub}: {names[:5]}"
        assert any(".mha." in n or ".self_mha." in n for n in names), names[:5]
        assert any(".ffn1." in n for n in names), names[:5]
        before = counts["model_all_reduce"]
        with torch.no_grad():
            got = ss(mel_ss, tgt, chunked=True, run_vocoder=False)["text_logits"]
        tp_reduces = counts["model_all_reduce"] - before
        assert got.shape == (2, 8, 64)
        tp_err = float((got - want).abs().max() / want.abs().max())
        assert tp_err < 1e-4, f"TP parity {tp_err}"
    return {"mesh": {"data": world // n_model, "model": n_model}, "sp_err": sp_err,
            "tp_partitioned": tp_partitioned, "tp_err": tp_err, "tp_all_reduces": tp_reduces, "metrics": metrics}


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: in
    ``n_devices`` processes (one a card, NCCL; or gloo processes when
    ``device="cpu"``), a data × model GAN train step of the tiny config
    (``model`` 2 when ``n_devices`` is even and at least 4) on ``max(8, n)``
    × 128 samples, the sequence-parallel Conformer over every rank checked
    against the unsharded forward (< 1e-3), and, with a ``model`` axis, the
    tensor-parallel StreamSpeech encoder and text decoder forward, whose
    sharded leaves must include an attention and an ``ffn1`` inside both and
    whose text logits must match the unsharded model's within 1e-4 of their
    peak.  Prints ``dryrun_multichip OK: ...`` and returns rank 0's numbers."""
    from hifigan_tpu_torch.parallel.launch import spawn

    resolve_device(device)
    r = spawn(_dryrun_rank, n_devices, device)[0]
    print(f"dryrun_multichip OK: mesh={r['mesh']} sp_shards={n_devices} sp_err={r['sp_err']:.2e} "
          f"tp_partitioned_params={r['tp_partitioned']} "
          f"metrics={{{', '.join(f'{k}: {v:.3f}' for k, v in r['metrics'].items())}}}", flush=True)
    return r
