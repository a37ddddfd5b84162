"""The voice-cloning step's identity term against JAX's on the CPU, fp32,
at the ``--tiny`` config and on the pair of ``test_torch_cloning_train.py``
(whose docstring says how the states, the pair and the gradients are
made): the centroid hinge from a fresh state, and the conditioning-only
fine-tune from trained-like moments."""

import inspect

import jax
import numpy as np
import pytest
import torch
from test_torch_cloning_train import (  # noqa: F401  (the fixtures)
    B1,
    _adam,
    _assert_losses,
    _flat,
    _fresh_jax_run,
    _jax_step,
    _one_thread,
    _port_step,
    _run_jax,
    assert_grads_match,
    banks,
    check_step,
    setup,
)
from test_torch_encoder_pretrain import ZERO_GRADIENT

from hifigan_tpu_torch.train import cloning as tcl
from hifigan_tpu_torch.train import state as tstate
from hifigan_tpu_torch.weights import load_jax_train_state


def test_centroid_hinge_step_matches_jax(setup, banks):
    """The centroid-hinge identity term (4 speakers' unit centroids): as
    ``test_cloning_step_matches_jax``, losses within 1e-4 relative,
    ``identity_loss`` and ``identity_cos`` among them, and every gradient."""
    check_step(setup, banks, "centroid_hinge")


def test_identity_finetune_matches_jax(setup, banks):
    """``identity_finetune`` from trained-like moments: Adam at update count
    1 (lr 2e-5), each leaf's first moment 0.1·|g| ·N(0, 1) and second
    moment |g|²·U(0.5, 2) of its fresh-state gradient's peak, so that an
    update is a smooth function of the gradient.

    - The trainable set is JAX's ``_is_conditioning`` set: the extractor
      and the FiLM layers.
    - Every other generator parameter is bit for bit as before, in both;
      its gradient is zero and its Adam moments decayed (``exp_avg`` =
      β1·m, ``exp_avg_sq`` = β2·v, within 1e-6 relative of JAX's).
    - Losses within LOSS_RTOL; the conditioning leaves' gradients within
      1e-4 of each leaf's max |g| plus 1e-7 of the model's; updated
      parameters (conditioning and discriminators) within 0.2·lr of JAX's
      (the ZERO_GRADIENT leaves, whose gradient is rounding noise, move by
      at most 3·lr); at least one extractor and one FiLM parameter moved."""
    fresh, _ = _fresh_jax_run(setup, banks, "centroid_hinge")
    rng = np.random.default_rng(2)

    def moments(opt_state, new_opt):
        adam, sched = opt_state[0]
        peaks = jax.tree_util.tree_map(lambda m: np.abs(m).max() / (1 - B1) + 1e-12, _adam(new_opt).mu)
        mu = jax.tree_util.tree_map(lambda p, g: (0.1 * g * rng.standard_normal(p.shape)).astype(np.float32),
                                    adam.mu, peaks)
        nu = jax.tree_util.tree_map(lambda p, g: (g * g * rng.uniform(0.5, 2.0, p.shape)).astype(np.float32),
                                    adam.nu, peaks)
        one = np.ones((), np.int32)
        return ((adam._replace(count=one, mu=mu, nu=nu), sched._replace(count=one)),)

    s0 = setup["state"]
    state0 = s0.replace(gen_opt_state=moments(s0.gen_opt_state, fresh.gen_opt_state),
                        disc_opt_state=moments(s0.disc_opt_state, fresh.disc_opt_state))
    jstep = _jax_step(setup, "identity_finetune")
    new, want = _run_jax(jstep, state0, setup, banks)
    state = load_jax_train_state(tstate.create_train_state(setup["tcfg"], device="cpu"), state0)
    before = {n: p.detach().clone() for n, p in state.vocoder.named_parameters()}
    state, got = _port_step(setup, "identity_finetune")(state, setup["batch"])
    _assert_losses(got, want)
    lr = tstate.learning_rate(setup["tcfg"], 1)
    assert lr == pytest.approx(2e-5)

    mask = inspect.getclosurevars(jstep.__wrapped__).nonlocals["_mask_to_conditioning"]
    jax_is_conditioning = inspect.getclosurevars(mask).nonlocals["_is_conditioning"]
    jax_set = {".".join(str(getattr(k, "key", k)) for k in path[1:])
               for path, _ in jax.tree_util.tree_flatten_with_path(s0.gen_params)[0] if jax_is_conditioning(path)}
    port_set = {n for n in before if tcl.is_conditioning(n)}
    assert port_set == jax_set and any("film_" in n for n in port_set) and len(port_set) < len(before)

    old_mu = dict(_flat(_adam(state0.gen_opt_state).mu["params"]))
    old_nu = dict(_flat(_adam(state0.gen_opt_state).nu["params"]))
    new_mu = dict(_flat(_adam(new.gen_opt_state).mu["params"]))
    new_nu = dict(_flat(_adam(new.gen_opt_state).nu["params"]))
    new_params = dict(_flat(new.gen_params["params"]))
    grads = {}
    for name, p in state.vocoder.named_parameters():
        adam = state.gen_opt.adam.state[p]
        if name in port_set:
            grads[name] = ((new_mu[name].astype(np.float64) - B1 * old_mu[name]) / (1 - B1)).astype(np.float32)
            if name.endswith(ZERO_GRADIENT):  # rounding noise through trained moments: a step of up to ~2·lr
                assert np.abs(p.detach().numpy() - before[name].numpy()).max() <= 3 * lr, name
            else:
                np.testing.assert_allclose(p.detach().numpy(), new_params[name], rtol=0, atol=0.2 * lr,
                                           err_msg=name)
        else:
            assert torch.equal(p.detach(), before[name]) and np.array_equal(new_params[name], before[name].numpy())
            assert not p.grad.any()
            np.testing.assert_allclose(adam["exp_avg"].numpy(), new_mu[name], rtol=1e-6, atol=0, err_msg=name)
            np.testing.assert_allclose(adam["exp_avg"].numpy(), B1 * old_mu[name], rtol=1e-6, atol=0)
            np.testing.assert_allclose(adam["exp_avg_sq"].numpy(), new_nu[name], rtol=1e-6, atol=0, err_msg=name)
            np.testing.assert_allclose(adam["exp_avg_sq"].numpy(), 0.99 * old_nu[name], rtol=1e-6, atol=0)
    assert_grads_match(state.vocoder, {n: grads.get(n, np.zeros(p.shape, np.float32))
                                       for n, p in state.vocoder.named_parameters()})
    conditioning = {n: p for n, p in state.vocoder.named_parameters() if n in port_set}
    moved = {n for n, p in conditioning.items() if not torch.equal(p.detach(), before[n])}
    assert any(n.startswith("embedding_extractor.") for n in moved) and any("film_" in n for n in moved)
    new_disc = dict(_flat(new.disc_params["params"]))
    for name, p in state.discriminators.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new_disc[name], rtol=0, atol=0.2 * lr, err_msg=name)




def test_cli_train_clone_warm_start_follows_the_encoders_widths(tmp_path):
    """``cli train-clone --init_from <TrainConfig() run> --encoders <file>``
    (not ``--tiny``), no step taken: the vocoder is built at
    ``EncoderTrainConfig()``'s extractor widths; every generator parameter
    is the init run's, the extractor is the encoder file's, the
    discriminators are the init run's, and the optimisers start fresh (JAX
    ``cli.py:470-516``)."""
    from hifigan_tpu_torch import cli
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager
    from hifigan_tpu_torch.train.encoder_pretrain import EncoderTrainConfig, build_models
    from hifigan_tpu_torch.weights import save_encoder_checkpoint

    init = tstate.create_train_state(tstate.TrainConfig(), device="cpu", seed=5)
    init.step = 7
    CheckpointManager(str(tmp_path / "init")).save(init, force=True)
    ecfg = EncoderTrainConfig()
    ecapa, emo = build_models(ecfg, gen=torch.Generator().manual_seed(6))
    save_encoder_checkpoint(str(tmp_path / "encoders.pt"), ecfg, ecapa, emo, step=3)
    cli.main(["train-clone", "--device", "cpu", "--init_from", str(tmp_path / "init"), "--encoders",
              str(tmp_path / "encoders.pt"), "--n_contents", "1", "--max_steps", "0", "--batch_size", "1",
              "--checkpoint_dir", str(tmp_path / "run")])
    saved = torch.load(tmp_path / "run" / "0.pt", weights_only=True)
    voc, init_voc = saved["vocoder"], init.vocoder.state_dict()
    for k, v in voc.items():
        if k.startswith("embedding_extractor.ecapa."):
            assert torch.equal(v, ecapa.state_dict()[k[len("embedding_extractor.ecapa."):]]), k
        elif k.startswith("embedding_extractor.emotion2vec."):
            assert torch.equal(v, emo.state_dict()[k[len("embedding_extractor.emotion2vec."):]]), k
        else:
            assert torch.equal(v, init_voc[k]), k
    assert voc["embedding_extractor.emotion2vec.layer_2.mha.q.kernel"].shape[0] == ecfg.emo_hidden
    assert "embedding_extractor.emotion2vec.layer_3.mha.q.kernel" not in voc
    for k, v in saved["discriminators"].items():
        assert torch.equal(v, init.discriminators.state_dict()[k]), k
    assert saved["step"] == 0 and saved["gen_opt"]["count"] == saved["disc_opt"]["count"] == 0
