"""Command-line interface of the port: ``train``, ``train-encoders``,
``train-clone``, ``train-unit-vocoder``, ``train-s2st``, ``eval``,
``eval-clone``, ``eval-s2st``, ``simulate``, ``info``, ``serve`` and
``bench``.

    python -m hifigan_tpu_torch.cli train --max_steps 1000 --checkpoint_dir ckpt [--bf16]
    python -m hifigan_tpu_torch.cli train --tiny --device cpu --max_steps 2 --checkpoint_dir /tmp/t
    python -m hifigan_tpu_torch.cli train --dataset formant --dataset_size 512 --device_data [--config c.json]
    python -m hifigan_tpu_torch.cli train --data_dir wavs/ --augment
    python -m hifigan_tpu_torch.cli train-encoders --checkpoint_dir enc [--spk_pair_weight 0.5]
    python -m hifigan_tpu_torch.cli train-clone --checkpoint_dir clone --encoders enc/encoders.pt [--init_from ckpt]
    python -m hifigan_tpu_torch.cli train-unit-vocoder --checkpoint_dir uv [--bf16] [--resume]
    python -m hifigan_tpu_torch.cli train-s2st --checkpoint_dir s2st [--eval_samples 32] [--resume]
    python -m hifigan_tpu_torch.cli eval [--checkpoint_dir ckpt] [--encoders enc.pt] [--asr judge.pt]
    python -m hifigan_tpu_torch.cli eval --tiny --device cpu
    python -m hifigan_tpu_torch.cli eval-clone --checkpoint_dir ckpt --encoders enc.pt
    python -m hifigan_tpu_torch.cli eval-s2st --checkpoint_dir s2st --unit_vocoder uv --asr judge.pt [--samples 8]
    python -m hifigan_tpu_torch.cli eval-s2st --checkpoint s2st.pt --asr judge.pt
    python -m hifigan_tpu_torch.cli simulate --agent s2st [--audio in.wav] [--checkpoint_dir s2st --unit_vocoder uv]
    python -m hifigan_tpu_torch.cli simulate --tiny --device cpu [--decode hmt --hmt_transition learned]
    python -m hifigan_tpu_torch.cli info [--device cpu]
    python -m hifigan_tpu_torch.cli serve [--config app.json] [--port 8000] [--device cpu]
    python -m hifigan_tpu_torch.cli bench [--device cpu]

Counterpart of ``hifigan_tpu/cli.py``'s commands of the same names, on the
card unless ``--device cpu``.  Every command runs cuDNN and cuBLAS without
TF32 (``main`` turns PyTorch's default off), so that fp32 is fp32.

``train`` GAN-trains the vocoder on the synthetic pseudo-speech dataset,
the procedural formant corpus (``--dataset formant``) or a directory of
wav files (``--data_dir``, with ``--augment``), appending one JSON line of
metrics every ``--log_every`` steps to ``<checkpoint_dir>/metrics.jsonl``
and saving checkpoints there (:mod:`hifigan_tpu_torch.train.checkpoint`).
``--config`` reads the ``training:`` block of a JSON file (YAML only where
the ``yaml`` package is installed).  Where ``tensorboard`` is installed,
each metrics row is also a TensorBoard event in
``<checkpoint_dir>/tensorboard/``.  Launched in N processes (``python -m
torch.distributed.run --nproc_per_node N -m hifigan_tpu_torch.cli train
...``: one a card over NCCL, or gloo processes with ``--device cpu``) it
trains data-parallel: each rank takes its rows of the same seeded batch,
the gradients are averaged before each update, and rank 0 alone writes
the run's files.  The batch must divide by N; with N > 1
``--steps_per_call`` is 1 and ``--device_data`` falls back to the host
loader.

``train-encoders`` pre-trains the judge encoders on the formant corpus's
labels and writes ``encoders.pt`` at the end; ``train-clone`` trains the
cloning vocoder on parallel speaker pairs (optionally with the frozen
judge's identity loss), logging the eval-protocol probe's
``probe_eval_cos`` and ``probe_verified`` at each log step.
``train-unit-vocoder`` GAN-trains the CodeHiFiGAN unit vocoder on
translated renditions, ``train-s2st`` the StreamSpeech stack on the
paired toy-translation task (and reports the held-out token F1); each
writes its config (``code_config.json``, ``streamspeech_config.json``),
``metrics.jsonl`` and ``<step>.pt`` train states: the run directories
that ``eval-s2st`` and ``simulate`` read.

``eval`` synthesises held-out formant-corpus utterances (or synthetic
rows) with the fp32 cloning vocoder at ``TrainConfig()`` widths and writes
JAX's report: speaker and emotion SIM with the judge encoders, mel-L1, MCD,
processing time and audio-seconds a second, and ASR-BLEU when a CTC judge
passes its competence gate (else SKIPPED).  ``eval-clone`` runs the
encoder separation, the cross-speaker transfer grid and the conditioning
ablation.  Where JAX reads orbax run directories they read the port's
files: ``--checkpoint_dir`` the :mod:`hifigan_tpu_torch.train.checkpoint`
files (``eval``: the seeded draw when there are none), ``--encoders`` a
``weights.save_encoder_checkpoint`` file and ``--asr`` a
``weights.save_ctc_judge`` file.

``eval-s2st`` runs the simultaneous S2ST evaluation over held-out
formant-corpus utterances: per text policy (greedy under three strides,
wait-k, the HMT beam under the confidence and the learned gate, and the
offline anchor) the token F1 and Average Lagging, and per speech policy
the ASR-BLEU of the output speech when a CTC judge passes its gate.  It
reads JAX's ``--checkpoint_dir`` (a ``train-s2st`` run) and
``--unit_vocoder`` (a ``train-unit-vocoder`` run), or ``--checkpoint``, a
:func:`~hifigan_tpu_torch.weights.save_s2st_checkpoint` file that carries
both models, and ``--asr``, a ``weights.save_ctc_judge`` file.

``simulate`` runs one streaming session of an agent over an utterance and
prints JAX's JSON summary.  Its models are the seeded full-width pair
(``--tiny``: tiny widths), or those of ``--checkpoint`` or
``--checkpoint_dir`` / ``--unit_vocoder``; then the text is detokenised to
phone names and, without ``--audio``, the utterance is the held-out
formant-corpus one that ``--seed`` selects (else a row of the synthetic
dataset).  ``info`` prints the flagship generator's parameter breakdown.
``serve`` starts the translation app's server (:mod:`hifigan_tpu_torch.app`:
uvicorn where FastAPI is installed, else the standard library's), its
settings from a JSON ``--config`` with the JAX package's YAML keys; its TTS
runs the vocoder of ``models.vocoder_checkpoint`` (a directory of
``<step>.pt`` train states; by default the first of ``FLAGSHIP_RUNS`` that
exists, as JAX's ``cli serve`` picks it).  ``bench`` times the root
``bench.py``'s five configs on the card (:mod:`hifigan_tpu_torch.bench`) and
prints its one-line JSON contract.
The JAX package's orbax checkpoints are carried over with
``load_jax_params`` and the ``load_jax_*_state`` functions.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import itertools
import json
import logging
import os
import time
from dataclasses import replace

import numpy as np
import torch

log = logging.getLogger("hifigan_tpu_torch")


def _run_steps(args, state, mgr, step_fn, seed_offset: int, summary, *step_args) -> tuple[int, float]:
    """Step ``state`` up to ``--max_steps``, ``--steps_per_call`` steps a
    call of ``step_fn(state, gen, *step_args)``, ``gen`` a ``torch.Generator``
    on the state's device seeded from ``--seed + seed_offset`` and the steps
    done; a row of metrics in ``metrics.jsonl`` every ``--log_every`` steps
    (logged as ``summary(row)``; rows past a resumed step pruned first), a
    checkpoint at ``mgr``'s interval and at the end.  Returns the steps
    done and the wall seconds."""
    from hifigan_tpu_torch.utils.tb import prune_metrics

    spc = max(1, args.steps_per_call)
    metrics_path = os.path.join(args.checkpoint_dir, "metrics.jsonl")
    steps_done = state.step
    t0 = time.time()
    prune_metrics(metrics_path, steps_done)
    with open(metrics_path, "a") as mf:
        while steps_done < args.max_steps:
            gen = torch.Generator(state.device).manual_seed(((args.seed + seed_offset) << 32) + steps_done)
            state, m = step_fn(state, gen, *step_args)
            steps_done += spc
            if steps_done % args.log_every < spc:
                rec = {k: float(v) for k, v in m.items()}
                rec.update(step=steps_done, wall_s=round(time.time() - t0, 1))
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
                log.info("step %d: %s", steps_done, summary(rec))
            mgr.save(state)
    mgr.save(state, force=True)
    mgr.wait()
    return steps_done, time.time() - t0


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


def _read_config(path: str) -> dict:
    """A training config file: ``.json``, or YAML where the ``yaml`` package
    is installed (the card's machine has none)."""
    if path.lower().endswith(".json"):
        with open(path) as f:
            return json.load(f) or {}
    try:
        yaml = importlib.import_module("yaml")
    except ImportError:
        raise SystemExit(f"{path}: reading YAML needs the yaml package, which is not installed; write the same "
                         'keys as a .json file: {"training": {"learning_rate": 2e-4, "beta1": 0.8, "beta2": 0.99, '
                         '"warmup_steps": 2000, "batch_size": 16, "segment_samples": 8192}}') from None
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _train_settings(args):
    """``(TrainConfig, batch size, segment samples)`` of ``cli train``:
    the flags, then the config file's ``training:`` keys over them (JAX's
    rule), and ``--tiny``'s cap of 256 samples."""
    cfg = _config(args)
    training = _read_config(args.config).get("training", {}) if args.config else {}
    cfg = replace(cfg, **{k: training[k] for k in ("learning_rate", "beta1", "beta2", "warmup_steps")
                          if k in training})
    seg = training.get("segment_samples", args.segment_samples)
    return cfg, training.get("batch_size", args.batch_size), min(seg, 256) if args.tiny else seg


def cmd_train(args) -> None:
    import torch.distributed as dist

    from hifigan_tpu_torch.entry import resolve_device
    from hifigan_tpu_torch.parallel import init_from_env

    resolve_device(args.device)
    cfg, batch_size, seg = _train_settings(args)
    owns_group = not dist.is_initialized()
    me = init_from_env(args.device)
    try:
        _train(args, cfg, batch_size, seg, me)
    finally:
        if me is not None and owns_group:
            dist.destroy_process_group()


def _train(args, cfg, batch_size: int, seg: int, me) -> None:
    """``cmd_train``'s run; ``me``: this process's rank when launched (data
    parallel over the group), else None."""
    from hifigan_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from hifigan_tpu_torch.train import create_train_state, make_train_step
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.data import AugmentConfig, BatchLoader, SyntheticSpeechDataset, WavDirectoryDataset
    from hifigan_tpu_torch.train.device_data import build_audio_bank, make_device_sampler
    from hifigan_tpu_torch.utils.tb import ScalarWriter, prune_metrics

    world = me.world if me is not None else 1
    writer = me is None or me.rank == 0  # rank 0 alone writes the run's files
    if batch_size % world:
        # JAX shrinks its device count until it divides the batch; a
        # launched process cannot be dropped
        raise ValueError(f"--batch_size {batch_size} is not divisible by the {world} launched processes")
    if args.data_dir:
        dataset = WavDirectoryDataset(args.data_dir, segment_samples=seg,
                                      augment_cfg=AugmentConfig() if args.augment else None)
        data = args.data_dir
    elif args.dataset == "formant":
        from hifigan_tpu_torch.train.corpus import FormantSpeechDataset

        dataset = FormantSpeechDataset(segment_samples=seg, size=args.dataset_size, seed=args.seed)
        data = "formant"
        log.info("training on the procedural formant-speech corpus (%d utterances)", args.dataset_size)
    else:
        dataset = SyntheticSpeechDataset(segment_samples=seg, size=max(64, batch_size * 8))
        data = "synthetic"
        log.info("no --data_dir: training on the synthetic dataset")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    state = create_train_state(cfg, dtype, me.device if me is not None else args.device, seed=args.seed)
    device = state.device
    steps_per_call = max(1, args.steps_per_call) if world == 1 else 1  # the mesh path shards one batch a call
    sample_fn = None
    if args.device_data and world > 1:
        log.warning("--device_data needs a single device and a bankable dataset; falling back to the host loader")
    elif args.device_data and not isinstance(dataset, WavDirectoryDataset):
        # the whole corpus in device memory, crops drawn there: per call
        # the host sends one seed
        bank, lengths = build_audio_bank(dataset)
        sample_fn = make_device_sampler(torch.from_numpy(bank).to(device), torch.from_numpy(lengths), seg,
                                        batch_size)
        log.info("on-device data: %d utterances (%.0f MB) in device memory", bank.shape[0], bank.nbytes / 1e6)
    elif args.device_data:
        log.warning("--device_data needs a bankable dataset (the wav directory's items are random, augmented "
                    "crops): using the host loader")
    step_fn = make_train_step(cfg, multi_steps=steps_per_call, sample_fn=sample_fn,
                              deep_feature_matching=args.deep_fm)
    if me is not None:
        step_fn = make_sharded_train_step(step_fn, make_mesh(world))
        log.info("data-parallel over %d processes (rank %d, %s)", world, me.rank, device)

    mgr = CheckpointManager(args.checkpoint_dir, save_interval=args.save_steps)
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state)
        log.info("resumed from step %d", state.step)
    loader = BatchLoader(dataset, batch_size, seed=args.seed, num_chunks=args.num_chunks)
    metrics_path = os.path.join(args.checkpoint_dir, "metrics.jsonl")
    tb_writer = ScalarWriter(os.path.join(args.checkpoint_dir, "tensorboard")) if writer else None
    steps_done = state.step
    if writer:
        prune_metrics(metrics_path, steps_done)
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
        if writer:
            mgr.save(state, force=True)
            mgr.wait()
            tb_writer.close()
            _write_training_summary(args, cfg, device, steps_done, time.time() - t_start, data)

    with open(metrics_path, "a") if writer else contextlib.nullcontext() as mf:
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
                    if writer and steps_done % args.log_every < steps_per_call:
                        m = {k: float(v) for k, v in metrics.items()}
                        m.update(step=steps_done, epoch=epoch, wall_s=round(time.time() - t_start, 1))
                        mf.write(json.dumps(m) + "\n")
                        mf.flush()
                        tb_writer.write(steps_done, m)
                        log.info("step %d: G=%.3f D=%.3f mel=%.3f", steps_done, m["generator_loss"],
                                 m["discriminator_loss"], m["mel_loss"])
                    if writer:
                        mgr.save(state)
                    if args.max_steps and steps_done >= args.max_steps:
                        finish()
                        log.info("done at step %d", steps_done)
                        return
                if args.num_chunks > 1 and writer:
                    mgr.save(state, force=True)  # a checkpoint per chunk (incremental training)
    finish()


def _write_training_summary(args, cfg, device, steps, wall_s, data) -> None:
    """The run's provenance, ``<checkpoint_dir>/training_summary.json``;
    ``data`` names the source (the wav directory, "formant" or
    "synthetic")."""
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
        "data": data,
        "checkpoint_dir": args.checkpoint_dir,
    }
    with open(os.path.join(args.checkpoint_dir, "training_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


def cmd_train_encoders(args) -> None:
    """Discriminative pre-training of the conditioning encoders: speaker
    AAM-softmax over the corpus's labelled speakers and arousal-bin
    cross-entropy (:mod:`hifigan_tpu_torch.train.encoder_pretrain`).  At
    the end ``encoders.pt`` (``weights.save_encoder_checkpoint``) beside the
    train-state files: what ``eval``, ``eval-clone`` and ``train-clone``
    read."""
    from hifigan_tpu_torch.entry import resolve_device
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.encoder_pretrain import (
        EncoderTrainConfig,
        build_labelled_bank,
        create_encoder_state,
        make_encoder_train_step,
        make_fused_encoder_step,
    )
    from hifigan_tpu_torch.weights import save_encoder_checkpoint

    device = resolve_device(args.device)
    cfg = EncoderTrainConfig(n_speakers=args.n_speakers, segment_samples=args.segment_samples,
                             batch_size=args.batch_size, learning_rate=args.lr, aam_margin=args.aam_margin,
                             aam_scale=args.aam_scale, spk_pair_weight=args.spk_pair_weight)
    if args.tiny:
        cfg = EncoderTrainConfig(n_speakers=args.n_speakers, segment_samples=2048, batch_size=4,
                                 learning_rate=args.lr, ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4)
    bank_np, lens_np, spk_np, bin_np = build_labelled_bank(n_speakers=cfg.n_speakers,
                                                           utterances_per_speaker=args.utterances_per_speaker)
    log.info("labelled bank: %d utterances (%.0f MB)", bank_np.shape[0], bank_np.nbytes / 1e6)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    state = create_encoder_state(cfg, dtype, device, seed=args.seed)
    step_fn = make_encoder_train_step(cfg, torch.from_numpy(bank_np).to(device), lens_np, spk_np, bin_np)
    fused = make_fused_encoder_step(step_fn, max(1, args.steps_per_call))
    mgr = CheckpointManager(args.checkpoint_dir, save_interval=args.save_steps)
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state)
        log.info("resumed from step %d", state.step)
    steps_done, wall = _run_steps(args, state, mgr, fused, 1, lambda r: (
        f"spk_loss={r['speaker_loss']:.3f} spk_acc={r['speaker_acc']:.3f} pair_cos={r['speaker_pair_cos']:.3f} "
        f"emo_loss={r['emotion_loss']:.3f} emo_acc={r['emotion_acc']:.3f} near={r['emotion_acc_near']:.3f}"))
    save_encoder_checkpoint(os.path.join(args.checkpoint_dir, "encoders.pt"), cfg, state.ecapa, state.emo,
                            step=steps_done)
    log.info("encoder training done at step %d (%.0f s)", steps_done, wall)


def cmd_train_clone(args) -> None:
    """Voice-cloning fine-tune on parallel-content speaker pairs, which
    makes the FiLM conditioning pathway carry identity
    (:mod:`hifigan_tpu_torch.train.cloning`).  Where JAX reads orbax runs
    it reads the port's files: ``--init_from`` and ``--resume`` train-state
    files, ``--encoders`` and ``--identity_encoders``
    ``weights.save_encoder_checkpoint`` files."""
    from hifigan_tpu_torch.entry import resolve_device
    from hifigan_tpu_torch.train import TrainConfig, create_train_state
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.cloning import (
        CloningProbe,
        build_cloning_banks,
        default_cache_path,
        make_cloning_train_step,
        make_pair_sampler,
    )
    from hifigan_tpu_torch.train.encoder_pretrain import EncoderTrainConfig, graft_into_extractor
    from hifigan_tpu_torch.utils.tb import prune_metrics
    from hifigan_tpu_torch.weights import load_encoder_checkpoint

    device = resolve_device(args.device)
    cfg = replace(_config(args), learning_rate=args.lr)
    ecfg = EncoderTrainConfig()
    if args.encoders and not args.tiny:
        # the extractor is built at the encoder checkpoint's widths, so that
        # the graft replaces like with like
        cfg = replace(cfg, ecapa_channels=ecfg.ecapa_channels, emo_hidden=ecfg.emo_hidden,
                      emo_layers=ecfg.emo_layers, emo_heads=ecfg.emo_heads)
    seg = 256 if args.tiny else args.segment_samples
    rseg = 256 if args.tiny else args.ref_samples
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    state = create_train_state(cfg, dtype, device, seed=args.seed)
    mgr = CheckpointManager(args.checkpoint_dir, save_interval=args.save_steps)
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state)
        log.info("resumed cloning run from step %d", state.step)
    elif args.init_from:
        init_mgr = CheckpointManager(args.init_from)
        if args.encoders and not args.tiny:
            # the init run was trained at TrainConfig()'s extractor widths:
            # restore into a template of those, take every generator subtree
            # but the extractor (the graft replaces it) and the
            # discriminators; the optimisers start fresh
            tpl = init_mgr.restore(create_train_state(replace(TrainConfig(), learning_rate=args.lr,
                                                              loss_weights=cfg.loss_weights),
                                                      dtype, device, seed=args.seed))
            kept = {k: v for k, v in tpl.vocoder.state_dict().items() if not k.startswith("embedding_extractor.")}
            state.vocoder.load_state_dict({**state.vocoder.state_dict(), **kept})
            state.discriminators.load_state_dict(tpl.discriminators.state_dict())
            log.info("warm-started the non-extractor subtrees from %s step %d (extractor widths follow "
                     "--encoders)", args.init_from, tpl.step)
            del tpl
        else:
            init_mgr.restore(state)
            log.info("warm-started from %s step %d", args.init_from, state.step)
    if args.encoders:
        _, e_ecapa, e_emo, e_step = load_encoder_checkpoint(args.encoders, "cpu")
        current = state.vocoder.state_dict()
        for name, module in (("ecapa", e_ecapa), ("emotion2vec", e_emo)):
            want = {k[len(f"embedding_extractor.{name}."):]: tuple(v.shape) for k, v in current.items()
                    if k.startswith(f"embedding_extractor.{name}.")}
            got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
            if want != got:
                raise SystemExit(f"encoder graft shape mismatch for '{name}': facade extractor and checkpoint "
                                 f"{args.encoders} disagree — build the facade at the encoder checkpoint's dims")
        state.vocoder.load_state_dict(graft_into_extractor(current, e_ecapa.state_dict(), e_emo.state_dict()))
        log.info("grafted pretrained encoders from %s (step %d)", args.encoders, e_step)
    # the frozen speaker judge: the optional identity loss and the
    # eval-protocol probe logged at every log step
    judge = None
    if not args.tiny:
        id_path = args.identity_encoders or _first(*ENCODER_FILES, exists=os.path.isfile)
        if id_path is None and args.identity_weight > 0:
            raise SystemExit(f"--identity_weight needs a trained encoder file (none of {', '.join(ENCODER_FILES)} "
                             "exists); pass --identity_encoders")
        if id_path is not None:
            _, judge, _, j_step = load_encoder_checkpoint(id_path, device)
            judge.requires_grad_(False)
            log.info("%s: frozen judge ECAPA from %s (step %d)",
                     f"identity loss weight {args.identity_weight:.2f}" if args.identity_weight > 0
                     else "eval-protocol probe only", id_path, j_step)

    n_contents = 8 if args.tiny else args.n_contents
    n_speakers = 4 if args.tiny else 32
    content_bank, ref_bank, lengths = build_cloning_banks(
        n_speakers=n_speakers, n_contents=n_contents, cache_path=None if args.tiny else default_cache_path())
    log.info("cloning banks: content %s (%.0f MB) + ref %s (%.0f MB)", content_bank.shape,
             content_bank.nbytes / 1e6, ref_bank.shape, ref_bank.nbytes / 1e6)
    content_dev = torch.from_numpy(content_bank).to(device)
    ref_dev = torch.from_numpy(ref_bank).to(device)
    sampler = make_pair_sampler(torch.from_numpy(lengths).to(device), seg, rseg, args.batch_size)
    probe = None
    if judge is not None:
        probe = CloningProbe(judge, cfg, n_speakers=n_speakers, segment_samples=seg, device=device)
    spc = max(1, args.steps_per_call)
    step_fn = make_cloning_train_step(
        cfg, sampler, deep_feature_matching=args.deep_fm, multi_steps=spc,
        identity_fn=judge if args.identity_weight > 0 else None, identity_weight=args.identity_weight,
        identity_centroids=None if probe is None else probe.centroids_seg, identity_margin=args.identity_margin,
        identity_finetune=args.identity_finetune)
    metrics_path = os.path.join(args.checkpoint_dir, "metrics.jsonl")
    steps_done = state.step
    t0 = time.time()
    prune_metrics(metrics_path, steps_done)
    with open(metrics_path, "a") as mf:
        while steps_done < args.max_steps:
            gen = torch.Generator(device).manual_seed(((args.seed + 2) << 32) + steps_done)
            try:
                state, m = step_fn(state, gen, content_dev, ref_dev)
            except Exception:
                if not args.auto_recover or mgr.latest_step() is None:
                    raise
                log.exception("step failed; restoring the last checkpoint")
                mgr.restore(state)
                continue
            steps_done += spc
            if steps_done % args.log_every < spc:
                rec = {k: float(v) for k, v in m.items()}
                rec.update(step=steps_done, wall_s=round(time.time() - t0, 1))
                if probe is not None:
                    p_cos, p_ver = probe(state.vocoder)
                    rec["probe_eval_cos"] = round(float(p_cos), 4)
                    rec["probe_verified"] = round(float(p_ver), 4)
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
                log.info("step %d: G=%.3f D=%.3f mel=%.3f%s", steps_done, rec["generator_loss"],
                         rec["discriminator_loss"], rec["mel_loss"],
                         f" probe_cos={rec['probe_eval_cos']:.3f} ver={rec['probe_verified']:.2f}"
                         if probe is not None else "")
            mgr.save(state)
    mgr.save(state, force=True)
    mgr.wait()
    log.info("cloning training done at step %d (%.0f s)", steps_done, time.time() - t0)


def cmd_train_unit_vocoder(args) -> None:
    """GAN-train the CodeHiFiGAN unit vocoder on translated renditions
    (:mod:`hifigan_tpu_torch.train.unit_vocoder`), the bank of rendered
    utterances in device memory.  Writes ``code_config.json``,
    ``metrics.jsonl`` and ``<step>.pt`` train states."""
    from hifigan_tpu_torch.entry import resolve_device
    from hifigan_tpu_torch.models.code_vocoder import CodeVocoderConfig
    from hifigan_tpu_torch.train import LossWeights, TrainConfig
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.unit_vocoder import (
        UnitVocoderTaskConfig,
        build_unit_vocoder_bank,
        create_unit_vocoder_state,
        make_unit_vocoder_train_step,
    )

    device = resolve_device(args.device)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=1000, loss_weights=LossWeights(
        feature_matching=args.fm_weight, mel=args.mel_weight, multi_res_stft=args.stft_weight))
    task = UnitVocoderTaskConfig(n_utterances=args.dataset_size, batch_size=args.batch_size)
    if args.tiny:
        task = UnitVocoderTaskConfig(
            n_utterances=8, n_speakers=4, max_units=48, window_units=8, batch_size=2,
            code=CodeVocoderConfig(unit_vocab_size=32, embed_dim=16, upsample_factors=(4, 2), hidden_channels=32,
                                   max_duration_per_unit=4))
    bank_np = build_unit_vocoder_bank(task)
    bank = {k: torch.from_numpy(v).to(device) for k, v in bank_np.items()}
    log.info("unit-vocoder bank: %d translated utterances (%.0f MB)", bank_np["wav"].shape[0],
             bank_np["wav"].nbytes / 1e6)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    state = create_unit_vocoder_state(tcfg, task, dtype, device, seed=args.seed)
    step_fn = make_unit_vocoder_train_step(tcfg, task, multi_steps=max(1, args.steps_per_call))
    mgr = CheckpointManager(args.checkpoint_dir, save_interval=args.save_steps)
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state)
        log.info("resumed from step %d", state.step)
    with open(os.path.join(args.checkpoint_dir, "code_config.json"), "w") as f:
        json.dump(dataclasses.asdict(task.code), f, indent=2)
    steps_done, wall = _run_steps(args, state, mgr, step_fn, 4, lambda r: (
        f"G={r['generator_loss']:.3f} D={r['discriminator_loss']:.3f} mel={r['mel_loss']:.3f} "
        f"dur={r['dur_loss']:.3f}"), bank)
    log.info("unit-vocoder training done at step %d (%.0f s)", steps_done, wall)


def cmd_train_s2st(args) -> None:
    """Multitask training of the StreamSpeech stack on the corpus's paired
    toy-translation task (:mod:`hifigan_tpu_torch.train.s2st_task`), the
    bank in device memory.  Writes ``streamspeech_config.json`` (with the
    feature revision), ``metrics.jsonl`` and ``<step>.pt`` train states;
    with ``--eval_samples`` the held-out token F1 of a greedy decode in
    ``s2st_eval.json``, also printed."""
    from hifigan_tpu_torch.entry import resolve_device
    from hifigan_tpu_torch.models.streamspeech import FEATURE_REV
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.s2st_task import (
        S2STTaskConfig,
        build_s2st_bank,
        create_s2st_state,
        evaluate_token_f1,
        make_s2st_train_step,
        small_config,
    )

    device = resolve_device(args.device)
    task = S2STTaskConfig(n_utterances=args.dataset_size, batch_size=args.batch_size, learning_rate=args.lr,
                          max_seconds=args.max_seconds, prefix_mask_prob=args.prefix_mask_prob,
                          prefix_min_frac=args.prefix_min_frac)
    model_cfg = small_config()
    if args.tiny:
        model_cfg = replace(model_cfg, hidden_dim=32, encoder_layers=1, decoder_layers=1, num_heads=4)
        task = replace(task, n_utterances=max(8, args.batch_size * 2))
    bank_np = build_s2st_bank(task)
    bank = {k: torch.from_numpy(v).to(device) for k, v in bank_np.items()}
    log.info("s2st bank: %d paired utterances (%.0f MB audio)", bank_np["audio"].shape[0],
             bank_np["audio"].nbytes / 1e6)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    state = create_s2st_state(model_cfg, task, dtype, device, seed=args.seed)
    step_fn = make_s2st_train_step(task, bank, multi_steps=max(1, args.steps_per_call))
    mgr = CheckpointManager(args.checkpoint_dir, save_interval=args.save_steps)
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state)
        log.info("resumed from step %d", state.step)
    with open(os.path.join(args.checkpoint_dir, "streamspeech_config.json"), "w") as f:
        json.dump({**dataclasses.asdict(model_cfg), "_feature_rev": FEATURE_REV}, f, indent=2)
    steps_done, _ = _run_steps(args, state, mgr, step_fn, 3, lambda r: (
        f"loss={r['loss']:.3f} src={r['src_ctc']:.3f} tgt={r['tgt_ctc']:.3f} dec={r['dec_ce']:.3f} "
        f"unit={r['unit_ctc']:.3f} acc={r['dec_acc']:.3f}"))
    if args.eval_samples:
        held = build_s2st_bank(replace(task, n_utterances=args.eval_samples), idx_offset=1_000_000)
        report = evaluate_token_f1(state.model.eval(), task, held)
        report["step"] = steps_done
        with open(os.path.join(args.checkpoint_dir, "s2st_eval.json"), "w") as f:
            json.dump(report, f, indent=2)
        log.info("held-out token F1 %.3f exact %.3f (n=%d)", report["token_f1"], report["exact_match"], report["n"])
        print(json.dumps(report))


def cmd_serve(args) -> None:
    """Serve the translation app on ``--device`` (checked before anything
    binds a port)."""
    from hifigan_tpu_torch.app.config import settings, settings_from_json
    from hifigan_tpu_torch.app.server import serve
    from hifigan_tpu_torch.entry import resolve_device

    resolve_device(args.device)
    cfg = settings_from_json(args.config) if args.config else settings
    if args.port:
        cfg = replace(cfg, web=replace(cfg.web, port=args.port))
    if cfg.models.vocoder_checkpoint is None and _first(*FLAGSHIP_RUNS):
        # the shipped trained vocoder by default, as JAX's cli serve picks it
        cfg = replace(cfg, models=replace(cfg.models, vocoder_checkpoint=_first(*FLAGSHIP_RUNS)))
    serve(cfg, args.device)


def cmd_info(args) -> None:
    """The flagship generator's (``GeneratorConfig()``) parameter count,
    size and per-module breakdown, as JAX's ``cli info`` prints them."""
    from hifigan_tpu_torch.entry import build_generator
    from hifigan_tpu_torch.models.generator import GeneratorConfig
    from hifigan_tpu_torch.utils import model_info

    cfg = GeneratorConfig()
    info = model_info(build_generator(cfg, torch.float32, args.device, seed=0), cfg)
    print(json.dumps({k: info[k] for k in ("total_parameters", "parameter_mb", "per_module_parameters")}, indent=2))


def cmd_bench(args) -> None:
    """The RTF benchmark (:mod:`hifigan_tpu_torch.bench`): exits with its
    code when that is not 0."""
    from hifigan_tpu_torch import bench

    code = bench.main(args.device)
    if code:
        raise SystemExit(code)


# where the port's files live beside the JAX package's trained runs, best first
FLAGSHIP_RUNS = ("runs/flagship2", "runs/flagship")
ENCODER_FILES = ("runs/encoders7/encoders.pt", "runs/encoders/encoders.pt")
JUDGE_FILES = ("runs/asr_judge/ctc_judge.pt", "runs/s2st3/ctc_judge.pt", "runs/s2st2/ctc_judge.pt",
               "runs/s2st/ctc_judge.pt")
S2ST_FILES = ("runs/s2st3/s2st.pt", "runs/s2st2/s2st.pt", "runs/s2st/s2st.pt")


def _first(*candidates, exists=os.path.isdir):
    """The first of ``candidates`` that exists, else None."""
    return next((c for c in candidates if c and exists(c)), None)


def _eval_config(tiny: bool):
    """``TrainConfig()``; with ``tiny``, JAX's ``cli eval --tiny`` widths."""
    from hifigan_tpu_torch.models.generator import GeneratorConfig
    from hifigan_tpu_torch.ops.stft import MelConfig
    from hifigan_tpu_torch.train import TrainConfig

    cfg = TrainConfig()
    if tiny:
        cfg = replace(
            cfg,
            generator=GeneratorConfig(input_channels=16, hidden_channels=32, upsample_factors=(4, 2),
                                      resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), lora_rank=4),
            mel=MelConfig(n_fft=32, hop_length=8, win_length=32, n_mels=16),
            ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4,
        )
    return cfg


def cmd_eval(args) -> None:
    from hifigan_tpu_torch.entry import resolve_device
    from hifigan_tpu_torch.eval.asr_bleu import write_wav
    from hifigan_tpu_torch.eval.evaluator import StreamEvaluator, aggregate_statistics, create_evaluation_report
    from hifigan_tpu_torch.models.embeddings import EcapaTdnn, Emotion2Vec
    from hifigan_tpu_torch.train import audio_to_mel, create_train_state
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.data import SyntheticSpeechDataset
    from hifigan_tpu_torch.weights import load_encoder_checkpoint

    device = resolve_device(args.device)
    cfg = _eval_config(args.tiny)
    state = create_train_state(cfg, torch.float32, device, seed=0)
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir is None and not args.tiny:
        ckpt_dir = _first(*FLAGSHIP_RUNS)
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        if mgr.latest_step() is not None:
            mgr.restore(state)
            log.info("restored step %d from %s", state.step, ckpt_dir)
        else:
            log.warning("%s holds no checkpoint: evaluating the seeded draw", ckpt_dir)
    args.checkpoint_dir = ckpt_dir
    vocoder = state.vocoder.eval()
    synth = torch.no_grad()(lambda mel: vocoder(mel)["waveform"])

    n_mels = cfg.mel.n_mels
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    if args.tiny:
        spk_model = EcapaTdnn(n_mels, channels=32, gen=gens[0])
        emo_model = Emotion2Vec(n_mels, hidden_dim=32, num_layers=1, num_heads=4, gen=gens[1])
    else:
        spk_model, emo_model = EcapaTdnn(n_mels, gen=gens[0]), Emotion2Vec(n_mels, gen=gens[1])
    encoders_trained = False
    enc_path = args.encoders or _first(*ENCODER_FILES, exists=os.path.isfile)
    if not args.tiny and enc_path and os.path.isfile(enc_path):
        # SIM with trained discriminative encoders: random-init encoders map
        # every clip near one point
        try:
            _, spk_model, emo_model, enc_step = load_encoder_checkpoint(enc_path, device)
            encoders_trained = True
            log.info("SIM encoders: trained (%s step %d)", enc_path, enc_step)
        except Exception:
            log.exception("could not load the trained encoders; SIM uses random-init encoders "
                          "(non-discriminative)")
    spk_model, emo_model = spk_model.to(device).eval(), emo_model.to(device).eval()
    evaluator = StreamEvaluator(
        synthesize_fn=synth,
        speaker_embed_fn=torch.no_grad()(lambda m: spk_model(m)),
        emotion_embed_fn=torch.no_grad()(lambda m: emo_model(m)),
        mel_fn=torch.no_grad()(lambda w: audio_to_mel(w, cfg)),
    )
    reference_texts = [None] * args.samples
    judge_gate = None
    if args.dataset == "formant":
        # held-out clips (utterance ids disjoint from any training draw)
        from hifigan_tpu_torch.eval.asr import load_competent_ctc
        from hifigan_tpu_torch.train.corpus import PHONES, FormantSpeechCorpus, plan_phone_ids

        corpus = FormantSpeechCorpus(n_speakers=8)
        clips, reference_texts = [], []
        for i in range(args.samples):
            wav, plan, _ar = corpus.utterance(i % 8, 10_000 + i, return_plan=True)
            clips.append(wav)
            reference_texts.append(" ".join(PHONES[p] for p in plan_phone_ids(plan) if p != 0))
        # the offline ASR-BLEU judge, gated on ground truth: a judge that
        # cannot transcribe the clips themselves gives no score
        candidates = [args.asr] if args.asr else list(JUDGE_FILES)
        evaluator.transcribe_fn, judge_gate = load_competent_ctc(candidates, clips[:4], reference_texts[:4],
                                                                 device=device)
        if evaluator.transcribe_fn is None:
            log.error("no competent CTC judge among %s: ASR-BLEU will be SKIPPED (gate: %s)", candidates,
                      json.dumps(judge_gate))
        # whole utterances, zero-padded to one shared length: ASR-BLEU scores
        # whole synthesised utterances against whole transcripts
        seg = -(-max(len(c) for c in clips) // 1024) * 1024
    else:
        data = SyntheticSpeechDataset(segment_samples=args.segment_samples, size=args.samples)
        clips = [data[i] for i in range(args.samples)]
        seg = args.segment_samples
    samples = []
    with torch.no_grad():
        for clip, ref_text in zip(clips, reference_texts):
            audio = np.zeros(seg, np.float32)
            audio[: min(seg, len(clip))] = clip[:seg]
            samples.append({"mel": audio_to_mel(torch.from_numpy(audio[None]).to(device), cfg),
                            "reference_text": ref_text,
                            "valid_frames": -(-min(seg, len(clip)) // cfg.mel.hop_length)})
    results = evaluator.evaluate_batch(samples)
    extra = {
        "dataset": args.dataset,
        "checkpoint_dir": args.checkpoint_dir,
        "restored_step": int(state.step),
        "sim_encoders": "trained" if encoders_trained else "random-init (non-discriminative)",
    }
    if args.dataset == "formant":
        extra["asr_judge_gate"] = judge_gate
    if args.save_wavs:
        # listening pairs (reference, synthesis), the shared padding trimmed
        os.makedirs(args.save_wavs, exist_ok=True)
        for i, s in enumerate(samples):
            wav = synth(s["mel"])[0, 0].cpu().numpy()
            n = min(len(wav), int(s.get("valid_frames", 1 << 30)) * cfg.mel.hop_length)
            write_wav(os.path.join(args.save_wavs, f"synth_{i:02d}.wav"), wav[:n])
            write_wav(os.path.join(args.save_wavs, f"ref_{i:02d}.wav"), clips[i][:n])
        extra["wav_dir"] = args.save_wavs
        log.info("wrote %d (ref, synth) pairs to %s", len(samples), args.save_wavs)
    if args.compare_random:
        # fidelity control: the same clips through a random-init generator
        rnd_vocoder = create_train_state(cfg, torch.float32, device, seed=99).vocoder.eval()
        rnd_eval = StreamEvaluator(
            synthesize_fn=torch.no_grad()(lambda mel: rnd_vocoder(mel)["waveform"]),
            speaker_embed_fn=evaluator.speaker_embed_fn,
            emotion_embed_fn=evaluator.emotion_embed_fn,
            mel_fn=evaluator.mel_fn,
        )
        rnd_stats = aggregate_statistics(rnd_eval.evaluate_batch(samples))
        extra["random_init_control"] = {k: round(v["mean"], 4) for k, v in rnd_stats.items()}
    report = create_evaluation_report(results, args.output, extra=extra)
    print(json.dumps({k: report["benchmarks"][k]["status"] for k in report["benchmarks"]}
                     | {"stats": {k: round(v["mean"], 4) for k, v in report["statistics"].items()}}))


def cmd_eval_clone(args) -> None:
    """Voice-cloning demonstration: trained-encoder SIM separation, the
    cross-speaker transfer grid and the conditioning ablation
    (:mod:`hifigan_tpu_torch.eval.cloning_eval`)."""
    from hifigan_tpu_torch.entry import resolve_device
    from hifigan_tpu_torch.eval.cloning_eval import encoder_separation, evaluate_cloning_transfer, speaker_centroids
    from hifigan_tpu_torch.train import audio_to_mel, create_train_state
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.corpus import FormantSpeechCorpus
    from hifigan_tpu_torch.weights import load_encoder_checkpoint

    device = resolve_device(args.device)
    cfg = _eval_config(args.tiny)
    state = CheckpointManager(args.checkpoint_dir).restore(create_train_state(cfg, torch.float32, device, seed=0))
    log.info("cloning model: %s step %d", args.checkpoint_dir, state.step)
    # the independently trained speaker encoder measures SIM
    _, ecapa, _emo, enc_step = load_encoder_checkpoint(args.encoders, device)
    log.info("trained encoders: %s step %d", args.encoders, enc_step)
    vocoder = state.vocoder.eval()
    synth = torch.no_grad()(lambda m, r: vocoder(m, reference_mel=r)["waveform"])
    embed = torch.no_grad()(lambda m: ecapa(m))
    mel_of_wav = torch.no_grad()(lambda w: audio_to_mel(w.to(device), cfg))

    corpus = FormantSpeechCorpus(n_speakers=32)
    sep = encoder_separation(embed, mel_of_wav, corpus, n_speakers=args.n_speakers)
    log.info("encoder separation: same %.3f vs cross %.3f (delta %.3f)", sep["same_speaker_mean"],
             sep["cross_speaker_mean"], sep["separation"])
    cents = speaker_centroids(embed, mel_of_wav, corpus, n_speakers=args.n_speakers)
    report = evaluate_cloning_transfer(synth, embed, mel_of_wav, mel_of_wav, corpus, n_speakers=args.n_speakers,
                                       n_contents=args.n_contents, centroids=cents)
    report["encoder_separation"] = sep
    report["checkpoint_dir"] = args.checkpoint_dir
    report["restored_step"] = int(state.step)
    report["encoder_step"] = enc_step
    if not args.full_pairs:
        report.pop("pairs")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "pairs"}, indent=2))


def _tiny_s2st_configs():
    from hifigan_tpu_torch.models.code_vocoder import CodeVocoderConfig
    from hifigan_tpu_torch.models.streamspeech import StreamSpeechConfig

    cfg = StreamSpeechConfig(hidden_dim=32, encoder_layers=1, decoder_layers=1, num_heads=4, vocab_size=100,
                             unit_vocab_size=50, chunk_size=8, vocoder_hidden=32, vocoder_upsample=(4, 2),
                             ecapa_channels=32, emo_hidden=32, emo_layers=1)
    code = CodeVocoderConfig(unit_vocab_size=cfg.unit_vocab_size, embed_dim=16, upsample_factors=(4, 2),
                             hidden_channels=32, max_duration_per_unit=3)
    return cfg, code


def _phone_detokenizer(ids) -> str:
    """A trained stack's token ids as phone names (``<id>`` outside the
    phone set)."""
    from hifigan_tpu_torch.train.corpus import PHONES
    from hifigan_tpu_torch.train.s2st_task import TOKEN_OFFSET

    return " ".join(PHONES[i - TOKEN_OFFSET + 1] if 1 <= i - TOKEN_OFFSET + 1 < len(PHONES) else f"<{i}>"
                    for i in ids)


def _s2st_stack(args, device):
    """``(model, code_vocoder, step, source)`` of ``eval-s2st``'s and
    ``simulate``'s flags: ``--checkpoint`` (one ``save_s2st_checkpoint``
    file: both models) or ``--checkpoint_dir`` (a ``train-s2st`` run) with
    ``--unit_vocoder`` (a ``train-unit-vocoder`` run; without one, no unit
    vocoder); giving both checkpoint flags is an error.  With neither,
    ``(None, None, None, None)``."""
    from hifigan_tpu_torch.weights import (
        load_s2st_checkpoint,
        load_s2st_run,
        load_unit_vocoder_run,
        read_s2st_step,
    )

    if args.checkpoint and args.checkpoint_dir:
        raise SystemExit("pass --checkpoint (one save_s2st_checkpoint file) or --checkpoint_dir (a train-s2st run), "
                         "not both")
    if args.unit_vocoder and not args.checkpoint_dir:
        raise SystemExit("--unit_vocoder goes with --checkpoint_dir (a --checkpoint file carries its unit vocoder)")
    if args.checkpoint_dir:
        model, step = load_s2st_run(args.checkpoint_dir, device)
        log.info("s2st stack: %s step %d", args.checkpoint_dir, step)
        code_vocoder = None
        if args.unit_vocoder:
            code_vocoder, uv_step = load_unit_vocoder_run(args.unit_vocoder, device)
            log.info("unit vocoder: %s step %d", args.unit_vocoder, uv_step)
        return model, code_vocoder, step, args.checkpoint_dir
    path = args.checkpoint
    if path is None:
        return None, None, None, None
    model, code_vocoder = load_s2st_checkpoint(path, device)
    step = read_s2st_step(path)
    log.info("s2st stack: %s step %d", path, step)
    return model, code_vocoder, step, path


def cmd_eval_s2st(args) -> None:
    """The simultaneous S2ST evaluation over held-out formant utterances:
    each text policy's token F1 and Average Lagging, and each speech
    policy's ASR-BLEU of the output speech (a CTC judge that passes its
    competence gate transcribes it), as JAX's ``cmd_eval_s2st``."""
    from hifigan_tpu_torch.entry import resolve_device
    from hifigan_tpu_torch.eval.asr import load_competent_ctc
    from hifigan_tpu_torch.eval.asr_bleu import write_wav
    from hifigan_tpu_torch.eval.metrics import corpus_bleu
    from hifigan_tpu_torch.streaming import run_streaming_session
    from hifigan_tpu_torch.streaming.agents import S2STAgent, S2TTAgent, WaitkS2STAgent, WaitkS2TTAgent
    from hifigan_tpu_torch.streaming.runtime import S2STInference, S2STInferenceConfig
    from hifigan_tpu_torch.train.corpus import PHONES, FormantSpeechCorpus, plan_phone_ids
    from hifigan_tpu_torch.train.s2st_task import token_f1, translate
    device = resolve_device(args.device)
    if args.checkpoint is None and args.checkpoint_dir is None:
        args.checkpoint = _first(*S2ST_FILES, exists=os.path.isfile)
        if args.checkpoint is None:
            raise SystemExit(f"no S2ST checkpoint found (looked for {', '.join(S2ST_FILES)}); pass --checkpoint or "
                             "--checkpoint_dir")
    model, code_vocoder, step, source = _s2st_stack(args, device)
    inf = S2STInference(model, code_vocoder, S2STInferenceConfig(max_target_len=64))
    detok = _phone_detokenizer

    corpus = FormantSpeechCorpus(n_speakers=32)
    samples, src_texts = [], []
    for i in range(args.samples):
        wav, plan, _ar = corpus.utterance(i % 32, 0, content=2_000_000 + i, return_plan=True)
        src_ids = plan_phone_ids(plan)
        src_texts.append(" ".join(PHONES[p] for p in src_ids if p != 0))
        samples.append((wav, translate(src_ids)))

    policies = {
        # the latency anchor: the whole source in one segment
        "offline_greedy": (S2TTAgent, {"stride_n": 1}),
        "stride1_greedy": (S2TTAgent, {"stride_n": 1}),
        "stride2_greedy": (S2TTAgent, {"stride_n": 2}),
        "stride4_greedy": (S2TTAgent, {"stride_n": 4}),
        "waitk3": (WaitkS2TTAgent, {"k1": 3}),
        "waitk7": (WaitkS2TTAgent, {"k1": 7}),
        "hmt_confidence": (S2TTAgent, {"decode": "hmt", "hmt_transition": "confidence"}),
        "hmt_learned": (S2TTAgent, {"decode": "hmt", "hmt_transition": "learned"}),
    }
    wanted = args.policies
    if wanted is not None and not wanted.strip():
        raise SystemExit("--policies needs policy names, 'all', or 'none'")
    if wanted and wanted != "all":
        keep = {p.strip() for p in wanted.split(",") if p.strip()}
        if "none" in keep and len(keep) > 1:
            raise SystemExit("--policies 'none' cannot be combined with policy names")
        unknown = keep - set(policies) - {"none"}
        if unknown:
            raise SystemExit(f"unknown policies {sorted(unknown)}; choose from {sorted(policies)}")
        policies = {k: v for k, v in policies.items() if k in keep}
    report = {"checkpoint_dir": source, "restored_step": step, "policies": {}}
    for name, (cls, kw) in policies.items():
        f1s, als = [], []
        seg_ms = 1_000_000 if name == "offline_greedy" else args.segment_size
        for wav, ref_ids in samples:
            agent = cls(inf, detokenize=detok, **kw)
            res = run_streaming_session(agent, wav, sample_rate=16_000, segment_size_ms=seg_ms)
            f1s.append(token_f1(list(getattr(agent, "committed_text_ids", [])), ref_ids))
            als.append(res.average_lagging_ms)
        report["policies"][name] = {"token_f1": round(float(np.mean(f1s)), 4),
                                    "average_lagging_ms": round(float(np.mean(als)), 1), "n": len(samples)}
        log.info("%s: F1=%.3f AL=%.0fms", name, report["policies"][name]["token_f1"],
                 report["policies"][name]["average_lagging_ms"])

    # the output speech's ASR-BLEU, by a judge that passes its competence
    # gate on ground-truth source clips (one that cannot transcribe the
    # source gives no score)
    candidates = [args.asr] if args.asr else list(JUDGE_FILES)
    asr, judge_gate = load_competent_ctc(candidates, [w for w, _ in samples[:4]], src_texts[:4], device=device)
    sel = judge_gate.get("selected")
    report["asr_judge"] = {
        "dir": sel,
        "independent": bool(sel) and os.path.realpath(sel) != os.path.realpath(source),
        "gate": judge_gate,
    }
    if asr is None:
        log.error("no competent CTC judge among %s: s2st ASR-BLEU SKIPPED (gate: %s)", candidates,
                  json.dumps(judge_gate))
    else:
        # the speech policies; "offline" feeds the whole source as one segment
        speech_policies = {
            "offline": (S2STAgent, {}, 1_000_000),
            "stride1": (S2STAgent, {}, args.segment_size),
            "waitk3": (WaitkS2STAgent, {"k1": 3}, args.segment_size),
        }
        want_sp = [p.strip() for p in args.speech_policies.split(",") if p.strip()]
        unknown_sp = set(want_sp) - set(speech_policies)
        if not want_sp or unknown_sp:
            raise SystemExit(f"--speech_policies: unknown {sorted(unknown_sp)}; choose from {sorted(speech_policies)}")
        if args.save_wavs:
            os.makedirs(args.save_wavs, exist_ok=True)
        report["s2st_speech_tradeoff"] = {}
        for pi, pname in enumerate(want_sp):
            cls_sp, kw_sp, seg_sp = speech_policies[pname]
            hyps, refs, als = [], [], []
            for si, (wav, ref_ids) in enumerate(samples):
                agent = cls_sp(inf, detokenize=detok, **kw_sp)
                res = run_streaming_session(agent, wav, sample_rate=16_000, segment_size_ms=seg_sp)
                out = res.waveform
                hyps.append(asr(out) if len(out) else "")
                refs.append(detok(list(ref_ids)))
                als.append(res.average_lagging_ms)
                if args.save_wavs and pi == 0 and si < 8:
                    # listening pairs: (source, simultaneous output)
                    for tag, audio in (("src", wav), ("out", out)):
                        write_wav(os.path.join(args.save_wavs, f"s2st_{si:02d}_{tag}.wav"), np.asarray(audio))
            row = {"bleu": round(corpus_bleu(hyps, refs), 2), "average_lagging_ms": round(float(np.mean(als)), 1),
                   "n": len(samples), "example_hyp": hyps[0][:120], "example_ref": refs[0][:120]}
            report["s2st_speech_tradeoff"][pname] = row
            log.info("speech %s: ASR-BLEU %.2f AL=%.0fms", pname, row["bleu"], row["average_lagging_ms"])
        # the headline row: the streaming (stride1) point if run, else the first
        head = "stride1" if "stride1" in want_sp else want_sp[0]
        report["s2st_asr_bleu"] = dict(report["s2st_speech_tradeoff"][head], policy=head)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))


def cmd_simulate(args) -> None:
    from hifigan_tpu_torch.entry import build_s2st_inference, resolve_device
    from hifigan_tpu_torch.models.streamspeech import StreamSpeechConfig
    from hifigan_tpu_torch.streaming import agents, run_streaming_session
    from hifigan_tpu_torch.streaming.features import read_wav
    from hifigan_tpu_torch.streaming.runtime import S2STInference
    from hifigan_tpu_torch.train.data import SyntheticSpeechDataset

    device = resolve_device(args.device)
    model, code_vocoder, _step, trained = _s2st_stack(args, device)
    if trained:
        inf = S2STInference(model, code_vocoder)
    else:
        if args.tiny:
            cfg, code = _tiny_s2st_configs()
        else:
            cfg, code = StreamSpeechConfig(), None
            log.warning("no --checkpoint or --checkpoint_dir: simulating with random weights; the output is noise")
        inf = build_s2st_inference(cfg, code, device=device, seed=0)
    agent_cls = {"asr": agents.ASRAgent, "s2tt": agents.S2TTAgent, "s2st": agents.S2STAgent,
                 "waitk-s2tt": agents.WaitkS2TTAgent, "waitk-s2st": agents.WaitkS2STAgent}[args.agent]
    agent_kw = {}
    if args.agent in ("s2tt", "s2st") and args.decode:
        agent_kw.update(decode=args.decode, hmt_transition=args.hmt_transition)
    if trained:
        agent_kw["detokenize"] = _phone_detokenizer  # a trained stack speaks phone tokens
    agent = agent_cls(inf, **agent_kw)
    if args.audio:
        audio, sr = read_wav(args.audio)
    elif trained:
        # a held-out formant utterance, what the trained stack was trained on
        from hifigan_tpu_torch.train.corpus import FormantSpeechCorpus

        audio = FormantSpeechCorpus(n_speakers=32).utterance(args.seed % 32, 0, content=2_000_000 + args.seed)
        sr = 16_000
    else:
        audio, sr = SyntheticSpeechDataset(segment_samples=16000)[args.seed], 16000
    t0 = time.time()
    result = run_streaming_session(agent, audio, sample_rate=sr, segment_size_ms=args.segment_size)
    print(json.dumps({
        "agent": args.agent,
        "source_seconds": result.source_seconds,
        "writes": len(result.outputs),
        "text": result.text[:200],
        "output_samples": int(len(result.waveform)),
        "average_lagging_ms": round(result.average_lagging_ms, 1),
        "wall_s": round(time.time() - t0, 2),
    }))


def build_parser() -> argparse.ArgumentParser:
    """The command line's parser; each command sets ``fn``."""
    p = argparse.ArgumentParser(prog="hifigan_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="GAN-train the vocoder")
    t.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    t.add_argument("--config", default=None,
                   help="a training config's training: block (learning_rate, beta1, beta2, warmup_steps, "
                        "batch_size, segment_samples): .json, or .yaml where the yaml package is installed")
    t.add_argument("--data_dir", default=None, help="a directory of wav files (searched recursively)")
    t.add_argument("--dataset", choices=["synthetic", "formant"], default="synthetic",
                   help="built-in dataset when no --data_dir is given")
    t.add_argument("--dataset_size", type=int, default=512, help="number of procedural utterances (formant dataset)")
    t.add_argument("--augment", action="store_true", help="pitch, stretch and noise augmentation of --data_dir clips")
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

    te = sub.add_parser("train-encoders", help="pre-train the speaker and emotion encoders on the corpus's labels")
    te.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    te.add_argument("--checkpoint_dir", default="runs/encoders")
    te.add_argument("--n_speakers", type=int, default=32)
    te.add_argument("--utterances_per_speaker", type=int, default=12)
    te.add_argument("--segment_samples", type=int, default=16384)
    te.add_argument("--batch_size", type=int, default=32)
    te.add_argument("--lr", type=float, default=1e-3)
    te.add_argument("--aam_margin", type=float, default=0.2,
                    help="AAM-softmax angular margin of the speaker objective (larger: tighter intra-class cosine)")
    te.add_argument("--aam_scale", type=float, default=30.0)
    te.add_argument("--spk_pair_weight", type=float, default=0.0,
                    help="weight of the same-speaker pair-cosine pull (toward the 0.7 verification threshold)")
    te.add_argument("--max_steps", type=int, default=4000)
    te.add_argument("--save_steps", type=int, default=1000)
    te.add_argument("--steps_per_call", type=int, default=1, help="optimizer steps per call of the train step")
    te.add_argument("--log_every", type=int, default=50)
    te.add_argument("--seed", type=int, default=0)
    te.add_argument("--bf16", action="store_true")
    te.add_argument("--resume", action="store_true")
    te.add_argument("--tiny", action="store_true", help="tiny encoders and crops for smoke runs")
    te.set_defaults(fn=cmd_train_encoders)

    tc = sub.add_parser("train-clone", help="voice-cloning fine-tune on parallel-content speaker pairs")
    tc.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    tc.add_argument("--checkpoint_dir", default="runs/cloning")
    tc.add_argument("--init_from", default=None, help="warm-start from the newest train-state file of this dir")
    tc.add_argument("--encoders", default=None, help="graft the encoders of this save_encoder_checkpoint file")
    tc.add_argument("--n_contents", type=int, default=32)
    tc.add_argument("--batch_size", type=int, default=16)
    tc.add_argument("--segment_samples", type=int, default=8192)
    tc.add_argument("--ref_samples", type=int, default=16384)
    tc.add_argument("--lr", type=float, default=2e-4)
    tc.add_argument("--max_steps", type=int, default=200000)
    tc.add_argument("--save_steps", type=int, default=4000)
    tc.add_argument("--steps_per_call", type=int, default=1, help="optimizer steps per call of the train step")
    tc.add_argument("--log_every", type=int, default=100)
    tc.add_argument("--seed", type=int, default=0)
    tc.add_argument("--bf16", action="store_true")
    tc.add_argument("--resume", action="store_true")
    tc.add_argument("--auto_recover", action="store_true",
                    help="on a failed step, restore the last checkpoint and go on")
    tc.add_argument("--tiny", action="store_true", help="tiny model, 4 speakers x 8 contents, no judge")
    tc.add_argument("--deep_fm", action="store_true", default=True)
    tc.add_argument("--no_deep_fm", dest="deep_fm", action="store_false")
    tc.add_argument("--fm_weight", type=float, default=10.0)
    tc.add_argument("--mel_weight", type=float, default=45.0)
    tc.add_argument("--adv_weight", type=float, default=1.0)
    tc.add_argument("--stft_weight", type=float, default=1.0)
    tc.add_argument("--adv_type", choices=["lsgan", "hinge"], default="lsgan")
    tc.add_argument("--identity_weight", type=float, default=0.0,
                    help="weight of the frozen judge's speaker-identity loss; 0 turns it off")
    tc.add_argument("--identity_encoders", default=None,
                    help="the judge's save_encoder_checkpoint file for the identity loss and the probe (default: "
                         f"the first of {', '.join(ENCODER_FILES)} that exists)")
    tc.add_argument("--identity_margin", type=float, default=0.8,
                    help="centroid-cosine hinge margin: pairs above it get no identity gradient")
    tc.add_argument("--identity_finetune", action="store_true",
                    help="update only the conditioning pathway (embedding extractor + FiLM); the trunk stays frozen")
    tc.set_defaults(fn=cmd_train_clone)

    e = sub.add_parser("eval", help="run the evaluation suite")
    e.add_argument("--checkpoint_dir", default=None,
                   help="restore the newest train-state file from this dir (default: the first of "
                        f"{', '.join(FLAGSHIP_RUNS)} that exists; none there: the seeded draw)")
    e.add_argument("--dataset", choices=["synthetic", "formant"], default="formant",
                   help="held-out formant speech clips (default) or the synthetic tones")
    e.add_argument("--samples", type=int, default=4)
    e.add_argument("--compare_random", action="store_true",
                   help="also report a random-init generator on the same clips (fidelity control)")
    e.add_argument("--segment_samples", type=int, default=8192)
    e.add_argument("--output", default=None)
    e.add_argument("--tiny", action="store_true")
    e.add_argument("--asr", default=None,
                   help="a save_ctc_judge file for offline ASR-BLEU (default: the first of "
                        f"{', '.join(JUDGE_FILES)} that passes the gate)")
    e.add_argument("--encoders", default=None,
                   help=f"a save_encoder_checkpoint file for SIM (default: {ENCODER_FILES[0]} when present)")
    e.add_argument("--save_wavs", default=None, help="write (reference, synthesis) WAV pairs here")
    e.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    e.set_defaults(fn=cmd_eval)

    ec = sub.add_parser("eval-clone", help="voice-cloning transfer/ablation evaluation with trained encoders")
    ec.add_argument("--checkpoint_dir", default="runs/cloning", help="a dir of train-state files")
    ec.add_argument("--encoders", default=ENCODER_FILES[0], help="a save_encoder_checkpoint file")
    ec.add_argument("--n_speakers", type=int, default=8)
    ec.add_argument("--n_contents", type=int, default=4)
    ec.add_argument("--output", default=None)
    ec.add_argument("--full_pairs", action="store_true", help="keep the per-pair transfer table in the report")
    ec.add_argument("--tiny", action="store_true", help="cli eval --tiny's widths")
    ec.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    ec.set_defaults(fn=cmd_eval_clone)

    es = sub.add_parser("eval-s2st", help="streaming S2ST eval: per-policy token F1, AL and ASR-BLEU")
    es.add_argument("--checkpoint", default=None,
                    help="a save_s2st_checkpoint file: the S2ST model and the unit vocoder (default: the first of "
                         f"{', '.join(S2ST_FILES)} that exists)")
    es.add_argument("--checkpoint_dir", default=None,
                    help="a train-s2st run: its streamspeech_config.json and newest <step>.pt (not with --checkpoint)")
    es.add_argument("--unit_vocoder", default=None,
                    help="a train-unit-vocoder run for the speech rows: its code_config.json and newest <step>.pt")
    es.add_argument("--asr", default=None,
                    help="a save_ctc_judge file for the speech ASR-BLEU (default: the first of "
                         f"{', '.join(JUDGE_FILES)} that passes the gate)")
    es.add_argument("--samples", type=int, default=8)
    es.add_argument("--policies", default="all",
                    help="comma-separated subset of the text-policy grid ('none' skips it)")
    es.add_argument("--speech_policies", default="stride1",
                    help="comma-separated subset of the speech-policy grid (offline, stride1, waitk3)")
    es.add_argument("--segment_size", type=int, default=320)
    es.add_argument("--save_wavs", default=None,
                    help="write (source, simultaneous output) WAV pairs for the first 8 samples here")
    es.add_argument("--output", default=None)
    es.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    es.set_defaults(fn=cmd_eval_s2st)

    s = sub.add_parser("simulate", help="run a streaming agent session")
    s.add_argument("--agent", choices=["asr", "s2tt", "s2st", "waitk-s2tt", "waitk-s2st"], default="s2st")
    s.add_argument("--audio", default=None, help="a 16-bit or 32-bit PCM WAV file")
    s.add_argument("--segment_size", type=int, default=320, help="source segment, ms")
    s.add_argument("--tiny", action="store_true", help="tiny widths, seeded weights")
    s.add_argument("--checkpoint", default=None, help="a save_s2st_checkpoint file")
    s.add_argument("--checkpoint_dir", default=None,
                   help="a train-s2st run: its streamspeech_config.json and newest <step>.pt (not with --checkpoint)")
    s.add_argument("--unit_vocoder", default=None,
                   help="a train-unit-vocoder run: its code_config.json and newest <step>.pt (with --checkpoint_dir; "
                        "without it the stack has no unit vocoder)")
    s.add_argument("--decode", choices=["greedy", "hmt"], default=None)
    s.add_argument("--hmt_transition", choices=["confidence", "learned"], default="confidence")
    s.add_argument("--seed", type=int, default=0,
                   help="the utterance when no --audio: held-out formant (with --checkpoint) or synthetic row")
    s.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    s.set_defaults(fn=cmd_simulate)

    tu = sub.add_parser("train-unit-vocoder", help="GAN-train the CodeHiFiGAN unit vocoder on translated renditions")
    tu.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    tu.add_argument("--checkpoint_dir", default="runs/unit_vocoder")
    tu.add_argument("--dataset_size", type=int, default=256)
    tu.add_argument("--batch_size", type=int, default=8)
    tu.add_argument("--lr", type=float, default=2e-4)
    tu.add_argument("--max_steps", type=int, default=100000)
    tu.add_argument("--save_steps", type=int, default=4000)
    tu.add_argument("--steps_per_call", type=int, default=1, help="optimizer steps per call of the train step")
    tu.add_argument("--log_every", type=int, default=100)
    tu.add_argument("--seed", type=int, default=0)
    tu.add_argument("--bf16", action="store_true")
    tu.add_argument("--resume", action="store_true")
    tu.add_argument("--tiny", action="store_true", help="tiny unit vocoder, 8 utterances of 4 speakers")
    tu.add_argument("--fm_weight", type=float, default=2.0)
    tu.add_argument("--mel_weight", type=float, default=45.0)
    tu.add_argument("--stft_weight", type=float, default=1.0)
    tu.set_defaults(fn=cmd_train_unit_vocoder)

    ts = sub.add_parser("train-s2st", help="multitask-train the StreamSpeech stack on the paired toy-translation task")
    ts.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    ts.add_argument("--checkpoint_dir", default="runs/s2st")
    ts.add_argument("--dataset_size", type=int, default=512)
    ts.add_argument("--batch_size", type=int, default=16)
    ts.add_argument("--max_seconds", type=float, default=4.0)
    ts.add_argument("--lr", type=float, default=3e-4)
    ts.add_argument("--max_steps", type=int, default=20000)
    ts.add_argument("--save_steps", type=int, default=2000)
    ts.add_argument("--steps_per_call", type=int, default=1, help="optimizer steps per call of the train step")
    ts.add_argument("--log_every", type=int, default=100)
    ts.add_argument("--eval_samples", type=int, default=32, help="held-out utterances for the token F1; 0 skips it")
    ts.add_argument("--prefix_mask_prob", type=float, default=0.5,
                    help="share of the batch whose decoder cross attention sees a random source prefix only")
    ts.add_argument("--prefix_min_frac", type=float, default=0.25, help="lower bound of the sampled prefix fraction")
    ts.add_argument("--seed", type=int, default=0)
    ts.add_argument("--bf16", action="store_true")
    ts.add_argument("--resume", action="store_true")
    ts.add_argument("--tiny", action="store_true", help="tiny model (d 32, one layer each), max(8, 2 x batch) utterances")
    ts.set_defaults(fn=cmd_train_s2st)

    v = sub.add_parser("serve", help="start the translation app server")
    v.add_argument("--config", default=None, help="a JSON file of app settings (the JAX package's YAML keys)")
    v.add_argument("--port", type=int, default=0, help="the port (0: the config's)")
    v.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    v.set_defaults(fn=cmd_serve)

    b = sub.add_parser("bench", help="run the RTF benchmark")
    b.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    b.set_defaults(fn=cmd_bench)

    i = sub.add_parser("info", help="the flagship generator's parameter breakdown")
    i.add_argument("--device", default="cuda", help="torch device; the card unless 'cpu'")
    i.set_defaults(fn=cmd_info)

    return p


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    # The commands hold fp32 to fp32: cuDNN's convolutions and cuBLAS's
    # matmuls in full fp32, not PyTorch's default TF32 for cuDNN.  bf16
    # paths do not read these flags.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args.fn(args)


if __name__ == "__main__":
    main()
