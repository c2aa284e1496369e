"""The training loss and its gradients against the JAX package, on the
CPU, at the published widths of qwen3-1.7b and mamba2-370m with the
depth cut to 2 layers (two fp32 copies of the full depth do not fit a
test host's memory beside the rest of the suite; the card runs the full
depth): fp32 as tests/test_torch_train_models.py holds the reduced
archs, and mamba2-370m's bf16 gradients, held with a float64 run."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.configs import get_config
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch
from repro_torch.models import model_zoo as zoo
from repro_torch.tree import paths, tree_map
from test_torch_train_models import _check, _two_threads, jref  # noqa: F401 (fixtures)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m"])
def test_full_width_cut_depth_loss_and_gradients_match_jax(jref, arch):
    jcfg = dataclasses.replace(jref["configs"].get_config(arch), num_layers=2)
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    _check(jref, jcfg, cfg, 1, 32)


BF16_FLOOR, BF16_CAP, BF16_LOSS = 3e-2, 0.1, 1e-3


def _bf16_tree(tree):
    """The port's bf16 tensors as numpy bf16 arrays for the JAX package."""
    import ml_dtypes

    return tree_map(lambda t: jnp.asarray(t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)), tree)


def test_full_width_cut_depth_bf16_gradients_match_jax(jref):
    """mamba2-370m at its published widths, depth cut to 2 layers, bf16
    weights (as ``launch.train`` trains): the port's loss and gradients
    against the JAX package's on the same weights, each path against a
    float64 run of the port.  Each leaf's gradient, by the norm of its
    difference over the float64 one's norm: port vs JAX within max(3e-2,
    twice the JAX package's own distance from float64), that limit at
    most 0.1 (else float64 decides nothing); the port no further from
    float64 than 1.5 times the JAX package over the whole gradient; the
    loss by the same rule with a floor of 1e-3."""
    arch = "mamba2-370m"
    jcfg = dataclasses.replace(jref["configs"].get_config(arch), num_layers=2)
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    p16 = zoo.init_params(cfg, torch.Generator().manual_seed(11), torch.bfloat16)
    raw = batch_for_arch(cfg, SyntheticLMStream(cfg.vocab_size, 1, 32, seed=1).next_batch())
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jref["zoo"].loss_fn(p, b, jcfg, jref["perf"].PerfConfig())))(
        _bf16_tree(p16), {k: jnp.asarray(v) for k, v in raw.items()})
    theirs = {"/".join(str(k.key) for k in path): torch.from_numpy(np.asarray(g, np.float64))
              for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}

    def loss_and_grads(params):
        leaves = paths(params)
        for p in leaves.values():
            p.requires_grad_(True)
        loss = zoo.loss_fn(params, batch, cfg, PerfConfig())
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), {k: g.double() for k, g in zip(leaves, grads)}

    l64, g64 = loss_and_grads(tree_map(lambda t: t.double(), p16))
    l16, ours = loss_and_grads(p16)
    assert ours.keys() == theirs.keys() == g64.keys()

    for k, ref in g64.items():
        bound = max(BF16_FLOOR, 2 * float((theirs[k] - ref).norm() / ref.norm()))
        err = float((ours[k] - theirs[k]).norm() / ref.norm())
        assert bound <= BF16_CAP, (k, bound)
        assert err <= bound, (k, err, bound)
    norm = lambda x: math.sqrt(sum(float((x[k] - g64[k]).square().sum()) for k in g64))
    assert norm(ours) <= 1.5 * norm(theirs)
    loss_bound = max(BF16_LOSS, 2 * abs(float(jloss) - l64) / l64)
    assert abs(l16 - float(jloss)) / l64 <= loss_bound
