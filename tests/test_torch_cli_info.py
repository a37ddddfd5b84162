"""``cli info`` of the port against JAX's on the CPU: the same JSON for
``GeneratorConfig()``, and ``model_info``'s other keys.

JAX's ``cmd_info`` runs as it is, with ``Generator.init`` traced by
``jax.eval_shape`` (shapes and dtypes only: what ``model_info`` reads), so
that the test does not compile the flagship's init."""

import functools
import json

import jax
import torch

from hifigan_tpu_torch import cli
from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.utils import model_info


def test_cli_info_prints_jax_json(monkeypatch, capsys):
    from hifigan_tpu import cli as jcli
    from hifigan_tpu.models.generator import Generator as JGenerator

    real_init = JGenerator.init
    monkeypatch.setattr(JGenerator, "init",
                        lambda self, *a, **kw: jax.eval_shape(functools.partial(real_init, self), *a, **kw))
    jcli.main(["--cpu", "info"])
    want = capsys.readouterr().out
    cli.main(["info", "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["total_parameters"] > 1e7


def test_model_info_counts_bytes_and_config():
    """fp32 parameters take 4 bytes each; ``config`` is the config's
    string; the breakdown's keys are the first components of the
    parameter names and sum to the total."""
    model = Generator(GeneratorConfig(), torch.float32, gen=torch.Generator().manual_seed(0))
    info = model_info(model, GeneratorConfig())
    assert info["parameter_bytes"] == 4 * info["total_parameters"] == 4 * sum(p.numel() for p in model.parameters())
    assert info["parameter_mb"] == round(info["parameter_bytes"] / 1e6, 2)
    assert sum(info["per_module_parameters"].values()) == info["total_parameters"]
    assert set(info["per_module_parameters"]) == {n.split(".")[0] for n, _ in model.named_parameters()}
    assert info["config"] == str(GeneratorConfig()) and "config" not in model_info(model)
