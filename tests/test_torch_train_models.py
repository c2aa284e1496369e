"""The training loss and its gradients against the JAX package, on the
CPU, for every registered arch at its reduced config (the published
widths: tests/test_torch_train_full_width.py).  fp32 weights drawn by
the port's init and handed to the JAX package (its own init draws the
same trees more slowly), the loss within 1e-5 relative, each leaf's
gradient within 1e-4 of its largest entry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch
from repro_torch.models import model_zoo as zoo
from repro_torch.tree import paths, tree_map
from test_torch_x64_shim import x64_shim

LOSS_REL, GRAD_REL = 1e-5, 1e-4



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    files at once on the host's cores, where more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="session")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` (imported by ``repro.core.arrivals``)
    is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        import repro.configs
        import repro.configs.perf
        from repro.models import model_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(configs=repro.configs, perf=repro.configs.perf, zoo=model_zoo)


def _check(jref, jcfg, cfg, batch_size: int, seq: int):
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    raw = batch_for_arch(cfg, SyntheticLMStream(max(cfg.vocab_size, 2), batch_size, seq, seed=1).next_batch())
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jref["zoo"].loss_fn(p, b, jcfg, jref["perf"].PerfConfig())))(
        jp, {k: jnp.asarray(v) for k, v in raw.items()})
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    del jgrads, jp
    leaves = paths(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = zoo.loss_fn(params, {k: torch.from_numpy(v) for k, v in raw.items()}, cfg, PerfConfig())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_REL)
    assert leaves.keys() == want.keys()
    for (k, g) in zip(leaves, grads):
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k                    # every leaf gets a gradient
        assert float(np.abs(g.numpy() - want[k]).max()) <= GRAD_REL * scale, k


@pytest.mark.parametrize("arch", list_archs())
def test_reduced_loss_and_gradients_match_jax(jref, arch):
    _check(jref, jref["configs"].get_config(arch, reduced=True), get_config(arch, reduced=True), 2, 32)
