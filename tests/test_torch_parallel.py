"""The port's data, tensor and sequence parallelism (``hifigan_tpu_torch.
parallel``) on gloo CPU processes, held to the JAX package's meshes on the
8 virtual CPU devices and to the port's own one-process math.

One process group a world size runs every check of that size
(``tests/torch_parallel_ranks.py::parallel_checks``): at 2 ranks the
sequence-parallel Conformer (T = 64) and a data-parallel step; at 4 the
Conformer at T = 32 (8 frames a shard, so the conv's 14-frame halo takes
two hops), a 2 × 2 data × model step, its clipped twin and the
tensor-parallel StreamSpeech forward.  The tensor-parallel rules are a pure
function, held to JAX's rule by rule without processes."""

import concurrent.futures
import copy
import functools
import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Shard
from test_torch_generator import _randomise
from test_torch_train_step import _configs
from test_train_step import TINY as JAX_TINY

from hifigan_tpu.models import discriminators as jdisc
from hifigan_tpu.models import vocoder as jvoc
from hifigan_tpu.models.conformer import ChunkedConformer as JaxConformer
from hifigan_tpu.models.streamspeech import StreamSpeechConfig as JaxS2STConfig
from hifigan_tpu.models.streamspeech import StreamSpeechS2ST as JaxS2ST
from hifigan_tpu.parallel import make_mesh as jax_make_mesh
from hifigan_tpu.parallel import make_sharded_train_step as jax_make_sharded_train_step
from hifigan_tpu.parallel import shard_params_tp as jax_shard_params_tp
from hifigan_tpu.parallel.mesh import _tp_spec_for, shard_batch as jax_shard_batch
from hifigan_tpu.parallel.sequence import conformer_forward_seq_sharded as jax_seq_sharded
from hifigan_tpu.train import state as jstate
from hifigan_tpu.train.train_step import make_train_step as jax_make_train_step
from hifigan_tpu_torch.entry import DRYRUN_S2ST
from hifigan_tpu_torch.models.conformer import ChunkedConformer
from hifigan_tpu_torch.models.streamspeech import StreamSpeechConfig, StreamSpeechS2ST
from hifigan_tpu_torch.parallel import spawn, tp_spec_for
from hifigan_tpu_torch.train import state as tstate
from hifigan_tpu_torch.train.train_step import make_train_step
from hifigan_tpu_torch.weights import load_jax_params, load_jax_train_state

import torch_parallel_ranks

BATCH, SAMPLES = 8, 128
CONFORMER = dict(input_dim=16, hidden_dim=32, num_layers=2, num_heads=4, chunk_size=8)
GRAD_FRAC, GRAD_FLOOR = 1e-4, 1e-7  # of each leaf's peak |g|, of the model's
SS_CFG = dict(input_dim=16, hidden_dim=32, encoder_layers=2, decoder_layers=2, num_heads=4, vocab_size=64,
              unit_vocab_size=32, chunk_size=8, vocoder_hidden=32, vocoder_upsample=(4, 2), ecapa_channels=32,
              emo_hidden=32, emo_layers=1)  # __graft_entry__.dryrun_multichip's ss_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the tensor-parallel rules --------------------------------------------


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(str(getattr(k, "key", k)) for k in path), leaf) for path, leaf in flat]


def _spec_axis(spec):
    """The axis a JAX PartitionSpec shards over ``model``, or None."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    return axes[0] if axes else None


@functools.cache
def _rule_trees():
    mel = jnp.zeros((2, 16, 16))
    gen_params = jax.eval_shape(
        lambda: jstate.create_train_state(jax.random.PRNGKey(0), JAX_TINY, mel_frames=16, batch_size=2)[0].gen_params)
    assert DRYRUN_S2ST == StreamSpeechConfig(**SS_CFG)
    ss = JaxS2ST(JaxS2STConfig(**SS_CFG))
    ss_params = jax.eval_shape(lambda: ss.init(jax.random.PRNGKey(7), mel, jnp.zeros((2, 8), jnp.int32),
                                               run_vocoder=False))
    return {"gen_params": gen_params, "streamspeech": ss_params}


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("tree", ["gen_params", "streamspeech"])
def test_tp_rules_match_jax_leaf_by_leaf(tree, model_axis):
    """For every leaf of JAX's tiny generator tree (``tests/test_train_step.py``'s
    config) and of the dryrun's StreamSpeech tree, ``tp_spec_for`` on the
    port's dotted name shards the axis ``_tp_spec_for`` shards, or neither
    does; each tree has sharded and replicated leaves."""
    leaves = _jax_leaves(_rule_trees()[tree])
    sharded = 0
    for path, leaf in leaves:
        want = _spec_axis(_tp_spec_for(path, leaf, model_axis))
        spec = tp_spec_for(".".join(path[1:]), leaf.shape, model_axis)
        got = spec.dim if isinstance(spec, Shard) else None
        assert got == want, f"{'.'.join(path)} {leaf.shape}: port {spec}, JAX axis {want}"
        sharded += want is not None
    assert 0 < sharded < len(leaves)


# --- the process groups ---------------------------------------------------


def _conformer(seed):
    jm = JaxConformer(**CONFORMER)
    params = _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 16))), seed)
    tm = load_jax_params(ChunkedConformer(*CONFORMER.values(), gen=torch.Generator().manual_seed(0)), params)
    return jm, params, tm


def _audio():
    return (0.5 * np.tanh(np.random.default_rng(9).standard_normal((BATCH, SAMPLES)))).astype(np.float32)


def _jax_train_state():
    """JAX's tiny train state (``test_torch_train_step``'s config) with every
    parameter leaf redrawn by ``_randomise`` from its shape and fresh
    optimiser states, as numpy; the models' init is traced, not run."""
    jcfg, _ = _configs()
    shapes = jax.eval_shape(
        lambda: jstate.create_train_state(jax.random.PRNGKey(0), jcfg, mel_frames=32, batch_size=2)[0])
    gen_params, disc_params = _randomise(shapes.gen_params, 3), _randomise(shapes.disc_params, 4)
    tx = jstate.make_optimizer(jcfg)
    state = jstate.GanTrainState(step=np.zeros((), np.int32), gen_params=gen_params, disc_params=disc_params,
                                 gen_opt_state=tx.init(gen_params), disc_opt_state=tx.init(disc_params))
    return jax.tree_util.tree_map(np.asarray, state)


def _one_process(jax_train_state):
    """The port's one-process step on the whole batch, plain and clipped:
    metrics, applied gradients and updated vocoder parameters."""
    _, tcfg = _configs()
    out = {"state": load_jax_train_state(tstate.create_train_state(tcfg, device="cpu"), jax_train_state).state_dict()}
    for key, cfg in (("plain", tcfg), ("clip", replace(tcfg, grad_clip=0.05))):
        state = tstate.create_train_state(cfg, device="cpu")
        state.load_state_dict(copy.deepcopy(out["state"]))  # the optimiser would update the dict's moments
        state, metrics = make_train_step(cfg)(state, {"audio": _audio()})
        grads = {f"vocoder.{n}": p.grad.numpy().copy() for n, p in state.vocoder.named_parameters()}
        grads.update({f"discriminators.{n}": p.grad.numpy().copy()
                      for n, p in state.discriminators.named_parameters()})
        out[key] = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
                    "params": {n: p.detach().numpy().copy() for n, p in state.vocoder.named_parameters()},
                    "state": state.state_dict()}
    return out


@pytest.fixture(scope="module")
def jax_train_state():
    return _jax_train_state()


@pytest.fixture(scope="module")
def one_process(jax_train_state):
    return _one_process(jax_train_state)


def _jax_sharded_losses(jax_train_state, n_data, n_model):
    """JAX's ``make_sharded_train_step`` over an ``n_data × n_model`` mesh of
    the virtual devices (the generator tensor-parallel, as the dryrun
    places it), on the same state and batch."""
    jcfg, _ = _configs()
    vocoder = jvoc.ModifiedVocoder(jcfg.generator, ecapa_channels=jcfg.ecapa_channels, emo_hidden=jcfg.emo_hidden,
                                   emo_layers=jcfg.emo_layers, emo_heads=jcfg.emo_heads)
    discs = jdisc.Discriminators()
    mesh = jax_make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[: n_data * n_model])
    repl = NamedSharding(mesh, P())
    state = jax_train_state.replace(
        gen_params=jax_shard_params_tp(jax_train_state.gen_params, mesh),
        disc_params=jax.device_put(jax_train_state.disc_params, repl),
        gen_opt_state=jax.device_put(jax_train_state.gen_opt_state, repl),
        disc_opt_state=jax.device_put(jax_train_state.disc_opt_state, repl),
        step=jax.device_put(jax_train_state.step, repl))
    step = jax_make_sharded_train_step(jax_make_train_step(vocoder, discs, jcfg, donate=False), mesh)
    _, metrics = step(state, jax_shard_batch({"audio": jnp.asarray(_audio())}, mesh))
    return {k: float(v) for k, v in metrics.items()}


def _world_inputs(world, one_process):
    """What the ranks of a ``world`` group are given, and the JAX side of
    it: the Conformer and a mel of T = 64 (2 ranks) or 32 (4 ranks); the
    tiny train state, configs and batch; at 4 ranks the clipped config and
    the dryrun's StreamSpeech with its inputs.  Every weight is drawn by
    ``_randomise`` from the JAX tree's shapes."""
    _, tcfg = _configs()
    jm, params, tm = _conformer(seed=11)
    mel = np.random.default_rng(world).standard_normal((2, {2: 64, 4: 32}[world], 16)).astype(np.float32)
    inputs = {"conformer_args": tuple(CONFORMER.values()), "conformer": tm.state_dict(), "mel": mel,
              "n_model": world // 2, "train_config": tcfg, "state": one_process["state"], "audio": _audio()}
    jax_side = {"conformer": (jm, params, mel)}
    if world == 4:
        inputs["clip_config"] = replace(tcfg, grad_clip=0.05)
        jss = JaxS2ST(JaxS2STConfig(**SS_CFG))
        ss_mel = np.random.default_rng(6).standard_normal((2, 16, 16)).astype(np.float32)
        tokens = np.random.default_rng(8).integers(1, 64, (2, 8)).astype(np.int64)
        ss_params = _randomise(jax.eval_shape(functools.partial(jss.init, run_vocoder=False), jax.random.PRNGKey(7),
                                              jnp.asarray(ss_mel), jnp.asarray(tokens, jnp.int32)), 12)
        tss = load_jax_params(StreamSpeechS2ST(DRYRUN_S2ST, gen=torch.Generator().manual_seed(0), with_vocoder=False,
                                               with_transition_head=False), ss_params).eval()
        inputs.update(s2st_config=DRYRUN_S2ST, s2st=tss.state_dict(), s2st_mel=ss_mel, s2st_tokens=tokens)
        jax_side["s2st"] = (jss, ss_params, tss, ss_mel, tokens)
    return inputs, jax_side


def _references(world, jax_side, jax_train_state):
    """The JAX (and one-process port) references of a ``world`` group."""
    jm, params, mel = jax_side["conformer"]
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    refs = {"conformer": np.asarray(jm.apply(params, mel, chunked=True)),
            "conformer_sharded": np.asarray(jax_seq_sharded(params, mel, mesh, num_layers=2, num_heads=4,
                                                            chunk_size=8)),
            "jax_losses": _jax_sharded_losses(jax_train_state, 2, world // 2)}
    if "s2st" in jax_side:
        jss, ss_params, tss, ss_mel, tokens = jax_side["s2st"]
        with torch.no_grad():
            refs["s2st_port"] = tss(torch.from_numpy(ss_mel), torch.from_numpy(tokens), chunked=True,
                                    run_vocoder=False)["text_logits"].numpy()
        apply = jax.jit(lambda p, m, t: jss.apply(p, m, t, chunked=True, run_vocoder=False)["text_logits"])
        refs["s2st_jax"] = np.asarray(apply(ss_params, jnp.asarray(ss_mel), jnp.asarray(tokens, jnp.int32)))
    return refs


@pytest.fixture(scope="module")
def groups(jax_train_state, one_process):
    """``groups(world)``: ``(world, each rank's results, references)`` for
    the gloo groups of 2 and 4 processes, each of which runs every check of
    its size once.  Both groups run in the background while the JAX
    references of both are computed, side by side."""
    prepared = {world: _world_inputs(world, one_process) for world in (2, 4)}
    results, errors = {}, []

    def run(world):
        try:
            results[world] = spawn(torch_parallel_ranks.parallel_checks, world, "cpu", prepared[world][0],
                                   timeout=300)
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(world,)) for world in prepared]
    for t in threads:
        t.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(len(prepared)) as pool:  # XLA compiles them side by side
            futures = {world: pool.submit(_references, world, jax_side, jax_train_state)
                       for world, (_, jax_side) in prepared.items()}
            refs = {world: f.result() for world, f in futures.items()}
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return lambda world: (world, results[world], refs[world])


WORLDS = pytest.mark.parametrize("world", [2, 4])


@WORLDS
def test_sequence_parallel_conformer_matches_jax(groups, world):
    """Each rank's time shard of the sequence-parallel Conformer, put back
    together, against JAX's ``conformer_forward_seq_sharded`` at the same
    shard count and JAX's unsharded ``ChunkedConformer`` (chunked), at JAX's
    own tolerance (``tests/test_sequence_parallel.py``): rtol 2e-4, atol
    2e-5."""
    world, results, refs = groups(world)
    got = np.concatenate([r["seq_out"] for r in results], axis=1)
    assert results[0]["seq_out"].shape[1] == got.shape[1] // world
    np.testing.assert_allclose(got, refs["conformer_sharded"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, refs["conformer"], rtol=2e-4, atol=2e-5)


@WORLDS
def test_sequence_parallel_rejects_ragged_time(groups, world):
    _, results, _ = groups(world)
    assert all(r["ragged"] and "not divisible" in r["ragged"] for r in results)


@WORLDS
def test_sharded_step_losses_match_jax_sharded_step(groups, world):
    """The losses of the port's sharded step (2 × 1 at 2 ranks, 2 × 2 at 4)
    against JAX's ``make_sharded_train_step`` over the same mesh shape, on
    the same state and 8 × 128 batch, within rtol 1e-4; every rank reports
    the same metrics."""
    _, results, refs = groups(world)
    for r in results:
        assert r["step"]["metrics"] == results[0]["step"]["metrics"]
    got = results[0]["step"]["metrics"]
    assert got.keys() == refs["jax_losses"].keys()
    for k, v in refs["jax_losses"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)


def _assert_close_by_leaf(got: dict, want: dict, frac=GRAD_FRAC, floor=GRAD_FLOOR):
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        tol = frac * np.abs(w).max() + floor * top
        err = np.abs(got[name] - w).max()
        assert err <= tol, f"{name}: max err {err:.3g} > {tol:.3g}"


@WORLDS
def test_sharded_step_gradients_match_one_process(groups, world, one_process):
    """Every applied gradient of the sharded step (the vocoder's gathered
    from the shards) within 1e-4 of its leaf's peak |g| (plus 1e-7 of the
    model's, for leaves that are zero but for rounding) of the port's
    one-process step on the whole batch, and the metrics within rtol 1e-5."""
    _, results, _ = groups(world)
    step = results[0]["step"]
    _assert_close_by_leaf(step["grads"], one_process["plain"]["grads"])
    for k, v in one_process["plain"]["metrics"].items():
        np.testing.assert_allclose(step["metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


@WORLDS
def test_one_all_reduce_per_update_and_shards_held(groups, world):
    """Two optimiser updates a step, one data-parallel ``all_reduce`` each;
    under 2 × 2 each rank holds half the elements of the sharded leaves."""
    _, results, _ = groups(world)
    for r in results:
        assert r["step"]["grad_all_reduces"] == 2
        if world == 4:
            assert r["step"]["n_sharded"] > 0
            assert 2 * r["step"]["sharded_local"] == r["step"]["sharded_full"]
        else:
            assert r["step"]["n_sharded"] == 0


@WORLDS
def test_sharded_state_dict_is_whole_and_loads_into_a_plain_run(groups, world):
    """The sharded run's state dict (every rank gathers, rank 0 keeps it)
    holds whole tensors: its vocoder parameters are the ranks' shards put
    together, bit for bit; it loads strictly into a one-process state, each
    Adam moment of its parameter's full shape; loaded back into a sharded
    state, each rank gets its own shards and moments."""
    _, results, _ = groups(world)
    step = results[0]["step"]
    whole = step["state"]
    for name, value in step["params"].items():
        assert np.array_equal(whole["vocoder"][name].numpy(), value), name
    _, tcfg = _configs()
    plain = tstate.create_train_state(tcfg, device="cpu")
    plain.load_state_dict(copy.deepcopy(whole))
    for opt in (plain.gen_opt, plain.disc_opt):
        for p in opt.params:
            assert opt.adam.state[p]["exp_avg"].shape == p.shape == opt.adam.state[p]["exp_avg_sq"].shape
    for r in results:
        assert r["step"]["reload_equal"] and r["step"]["reload_moments_equal"]


def test_clipped_update_equals_one_process(groups, one_process):
    """With ``grad_clip`` 0.05 (the gradients' global norm is above it, so
    every update is clipped), the sharded step's clipped gradients equal the
    one-process step's (as the plain step's are held): the norm counts each
    shard once.  The updated parameters too: within 1e-6 where the
    one-process gradient is at least 1e-6, and within 2·lr elsewhere (a
    first Adam update is lr·g/(|g| + 1e-8), which turns a gradient's
    rounding into up to lr where |g| nears 1e-8).  Checked at 2 × 2."""
    _, results, _ = groups(4)
    step = results[0]["clip_step"]
    _assert_close_by_leaf(step["grads"], one_process["clip"]["grads"])
    lr = _configs()[1].learning_rate
    for name, want in one_process["clip"]["params"].items():
        err = np.abs(step["params"][name] - want)
        strong = np.abs(one_process["clip"]["grads"][f"vocoder.{name}"]) >= 1e-6
        assert err[strong].max(initial=0.0) <= 1e-6 and err.max() <= 2 * lr, name


def test_tensor_parallel_streamspeech_forward(groups):
    """The tensor-parallel StreamSpeech forward at 2 × 2: text logits within
    1e-4 of their peak of the unsharded port's and of JAX's unsharded
    ``apply``; one ``model`` all-reduce per attention block and per FFN (2
    encoder layers × 2, 2 decoder layers × 3); attention and FFN leaves
    sharded inside the encoder and the text decoder."""
    _, results, refs = groups(4)
    for r in results:
        out = r["s2st"]
        for ref in (refs["s2st_port"], refs["s2st_jax"]):
            assert np.abs(out["text_logits"] - ref).max() <= 1e-4 * np.abs(ref).max()
        assert out["model_all_reduces"] == 2 * 2 + 2 * 3
        names = out["sharded_names"]
        assert any(n.startswith("encoder.") and ".mha." in n for n in names)
        assert any(n.startswith("text_decoder.") and ".ffn1." in n for n in names)
