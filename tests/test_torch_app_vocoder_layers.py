"""The bf16 generator on the trained ``runs/cloning/220000`` weights, layer
by layer, against the JAX package's, on the CPU, on
``test_torch_app_vocoder.py``'s seeded ``[1, 80, 32]`` mel with zero
speaker and emotion (the vocoder route's inputs).

- Each layer of the port's generator, fed the bf16 input JAX's layer was
  fed (JAX's jitted bf16 forward, its intermediates captured), lands
  within 4 bf16 ulps of the peak of JAX's output of that layer, the
  tolerance ``test_bf16_generator_matches_jax_bf16`` holds the whole
  generators to on randomised weights.  Each MRF stage (three GRC blocks
  and the residual) is held to JAX's Pallas chain (``mrf_backend="pallas"``,
  interpret mode), whose arithmetic the port's kernel and its plain version
  carry: one fp32 sum of conv, bias and residual rounded once to bf16, and
  GroupNorm's statistics from the fp32 sums.  JAX's default ``"auto"`` runs
  the blocks as separate XLA ops, which round the conv output and the
  residual sum to bf16 apart and take the statistics from the bf16 sum; the
  test prints how far that lands from the Pallas chain.  The other layers
  are held to JAX's default forward.
- End to end, a few bf16 roundings that fall the other way (about a
  hundred of the 262,144 elements of an MRF stage) grow through the later layers, so two
  bf16 programs do not agree within 4 ulps at the output: JAX's own Pallas
  and XLA routes do not.  The port's generator is held to JAX's default
  within that spread plus 4 ulps.

``pytest -s`` prints every distance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.ops.cuda.grc_kernel import grc_step_reference
from hifigan_tpu_torch.weights import load_jax_params

from test_torch_app_vocoder import BF16_ULPS, restore_jax_state, seeded_mel, ulps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gen_params():
    """The trained generator's params, as numpy."""
    _, js = restore_jax_state()
    return {"params": jax.tree_util.tree_map(np.array, js.gen_params["params"]["generator"])}


def _jax_forward(gen_params, backend: str, capture: bool):
    import hifigan_tpu.train
    from hifigan_tpu.models.generator import Generator as JGenerator

    gc = dataclasses.replace(hifigan_tpu.train.TrainConfig().generator, mrf_backend=backend)
    model = JGenerator(gc, dtype=jnp.bfloat16)
    mel = seeded_mel()
    spk, emo = np.zeros((1, gc.speaker_dim), np.float32), np.zeros((1, gc.emotion_dim), np.float32)
    if not capture:
        return jax.jit(lambda p: model.apply(p, mel, spk, emo))(gen_params)
    return jax.jit(lambda p: model.apply(
        p, mel, spk, emo, capture_intermediates=lambda m, _: (m.name or "").startswith(("film", "upsample", "mrf"))
    ))(gen_params)


@pytest.fixture(scope="module")
def jax_layers(gen_params) -> dict:
    """JAX's jitted bf16 forward (``mrf_backend="auto"``): each FiLM's and
    upsampler's output, each MRF stage's output (``stage_i``: the last
    block's output plus the stage's input, in bf16) and the waveform
    (``out``), as fp32 numpy; and each MRF stage through JAX's Pallas chain
    on the same stage input (``pallas_stage_i``)."""
    import hifigan_tpu.train
    from hifigan_tpu.models.generator import GRCLoRABlock
    from hifigan_tpu.ops.pallas import grc_chain

    gc = hifigan_tpu.train.TrainConfig().generator
    wav, state = _jax_forward(gen_params, "auto", capture=True)
    caught = {k: v["__call__"][0] for k, v in state["intermediates"].items()}
    out = {k: np.array(v.astype(jnp.float32)) for k, v in caught.items() if not k.startswith("mrf")}
    out["out"] = np.array(wav)
    n_up, ch = len(gc.upsample_factors), gc.hidden_channels >> len(gc.upsample_factors)
    for i, (ks, dils) in enumerate(zip(gc.resblock_kernel_sizes, gc.resblock_dilations)):
        x = caught[f"film_{n_up + i}"]
        out[f"stage_{i}"] = np.array((caught[f"mrf_{i}_grc_{len(dils) - 1}"] + x).astype(jnp.float32))
        fold = x.shape[-1] // ch
        comps = [GRCLoRABlock(channels=ch, kernel_size=ks, dilation=d, groups=gc.grc_groups, lora_rank=gc.lora_rank,
                              leaky_slope=gc.leaky_slope, fold=fold, dtype=jnp.bfloat16)
                 .apply({"params": gen_params["params"][f"mrf_{i}_grc_{j}"]}, x, return_fused=True)
                 for j, d in enumerate(dils)]
        y = grc_chain(x, comps, groups=gc.grc_groups, channels=ch, fold=fold, slope=gc.leaky_slope, interpret=True)
        out[f"pallas_stage_{i}"] = np.array((y + x).astype(jnp.float32))
    return out


def _port_generator(gen_params) -> Generator:
    model = Generator(GeneratorConfig(), torch.bfloat16, gen=torch.Generator().manual_seed(0))
    return load_jax_params(model, gen_params)


def _port_run(model: Generator) -> np.ndarray:
    cfg = model.config
    spk, emo = torch.zeros((1, cfg.speaker_dim)), torch.zeros((1, cfg.emotion_dim))
    with torch.no_grad():
        return model(torch.from_numpy(seeded_mel()), spk, emo, step=grc_step_reference).numpy()


def _port_layers(gen_params, jax_layers: dict) -> dict:
    """The port's bf16 generator on the CPU (the plain chain step), each
    FiLM's and upsampler's output taken and then replaced by JAX's, and each
    MRF stage's output taken where the next FiLM reads it and replaced by
    JAX's: so every layer is fed the input JAX's layer was fed."""
    model = _port_generator(gen_params)
    got = {}

    def jax_value(name, like):
        return torch.from_numpy(jax_layers[name].reshape(like.shape)).to(like.dtype)

    def after(name):
        def hook(module, args, output):
            got[name] = output.float().numpy()
            return jax_value(name, output)
        return hook

    def before(name):
        def hook(module, args):
            got[name] = args[0].float().numpy()
            return (jax_value(name, args[0]),) + args[1:]
        return hook

    for name, module in model.named_children():
        if name.startswith(("film", "upsample")):
            module.register_forward_hook(after(name))
    n_up = len(model.config.upsample_factors)
    for i in range(len(model.config.resblock_kernel_sizes)):
        getattr(model, f"film_{n_up + i + 1}").register_forward_pre_hook(before(f"stage_{i}"))
    got["out"] = _port_run(model)
    return got


def test_bf16_generator_layers_match_jax(gen_params, jax_layers):
    got = _port_layers(gen_params, jax_layers)
    stages = [k for k in got if k.startswith("stage_")]
    assert len(stages) == 3 and len(got) == 1 + 2 * 4 + 2 * 3 + 1
    far = {}
    for name, value in got.items():
        ref = jax_layers[f"pallas_{name}" if name in stages else name]
        assert value.size == ref.size and np.isfinite(value).all()
        err = ulps(value, ref, ref)
        print(f"[bf16 layer] {name}: port {err:.3f} ulps from JAX's "
              + (f"Pallas chain ({int((value.reshape(-1) != ref.reshape(-1)).sum())} of {value.size} elements "
                 f"differ); JAX's XLA blocks {ulps(jax_layers[name], ref, ref):.3f} from it" if name in stages
                 else "default forward"))
        if err > BF16_ULPS:
            far[name] = err
    assert not far, f"layers more than {BF16_ULPS} bf16 ulps from JAX on the same input: {far}"


def test_bf16_generator_within_jax_routes_spread(gen_params, jax_layers):
    want = jax_layers["out"]
    pallas = np.array(_jax_forward(gen_params, "pallas", capture=False))
    got = _port_run(_port_generator(gen_params))
    assert got.shape == want.shape == pallas.shape == (1, 1, 32 * 256)
    assert np.isfinite(got).all() and 0.005 < got.std()
    spread = ulps(pallas, want, want)
    print(f"[bf16 generator] ulps of JAX's peak: port vs JAX {ulps(got, want, want):.2f}, port vs JAX's Pallas "
          f"route {ulps(got, pallas, want):.2f}, JAX's Pallas vs its XLA route {spread:.2f}")
    assert ulps(got, want, want) <= spread + BF16_ULPS
