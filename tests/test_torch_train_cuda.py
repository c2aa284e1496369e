"""Training through the port's kernels on the card: the flash and SSD
autograd wrappers against autograd of their plain versions, the launches a
training step makes under each remat mode, gradients through the reduced
models, and ``AsyncCheckpointer`` on card tensors.

These need a CUDA card (a CUDA kernel has no CPU mode) and skip where there
is none.  They import neither jax nor the JAX package:

    python -m pytest -m cuda tests/test_torch_train_cuda.py
"""
import pytest
import torch

from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.perf import PerfConfig
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.launch import train as train_mod
from repro_torch.models import attention, mamba2
from repro_torch.models import model_zoo as zoo
from repro_torch.tree import paths
from repro_torch.training.train_loop import make_train_step
from test_torch_kernels_cuda import SSD_TABLE, TABLE, _ssd_inputs

# the plain version's fp32 score tensor (B·H·Sq·Sk) and its autograd must fit
# beside the kernel's: mixtral's window shapes at S 4608 and 8192 (2.7 and
# 8.6 GB of scores alone) are left to the forward tests
GRAD_TABLE = [row for row in TABLE if row[0] * row[3] * row[1] * row[2] <= 1 << 28]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a: torch.Tensor, b: torch.Tensor, label: str):
    """Equal up to the last bit of the gradient's dtype, relative to the
    largest entry (the backward is the plain version's own autograd)."""
    assert a.dtype == b.dtype and a.shape == b.shape, label
    scale = float(b.float().abs().nan_to_num().max())
    ulp = 2.0 ** -8 if a.dtype == torch.bfloat16 else 1e-6
    diff = (a.float() - b.float()).abs().nan_to_num(nan=0.0)
    assert torch.equal(a.isnan(), b.isnan()), label
    assert float(diff.max()) <= ulp * max(scale, 1e-30), (label, float(diff.max()), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window,q_offset", GRAD_TABLE)
def test_flash_gradient_equals_plain_autograd(cuda, dtype, b, sq, sk, h, kvh, d, causal, window, q_offset):
    gen = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    w = torch.randn((b, sq, h, d), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, **kw)
        return out, torch.autograd.grad((out.float() * w.float()).sum(), leaves)

    before = fa.launches
    out, ours = grads(fa.attention)
    assert fa.launches == before + 1                 # the forward only
    assert out.grad_fn is not None and out.dtype == dtype
    ref_out, theirs = grads(attention_reference)
    assert fa.launches == before + 1
    for name, a, r in zip("qkv", ours, theirs):
        _close(a, r, name)
    if q_offset >= 0:                                # a fully masked row has no gradient to give
        assert all(bool(g.abs().max() > 0) for g in ours)


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,a_one", SSD_TABLE)
def test_ssd_gradient_equals_plain_autograd(cuda, b, s, h, p, g, n, chunk, a_one, with_state):
    args, init = _ssd_inputs(cuda, b, s, h, p, g, n, a_one=a_one)
    gen = torch.Generator(cuda).manual_seed(5)
    wy = torch.randn((b, s, h, p), generator=gen, device=cuda)
    ws = torch.randn((b, h, p, n), generator=gen, device=cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in args]
        st = init.clone().requires_grad_(True) if with_state else None
        y, state = fn(*leaves, chunk=chunk, init_state=st)
        loss = (y * wy).sum() + (state * ws).sum()
        return torch.autograd.grad(loss, leaves + ([st] if with_state else []))

    before = ssd_ops.launches
    ours = grads(ssd_ops.ssd)
    assert ssd_ops.launches == before + 1
    theirs = grads(ssd_chunked)
    assert len(ours) == (7 if with_state else 6)
    for name, a, r in zip(("x", "dt", "a", "b", "c", "d", "init_state"), ours, theirs):
        _close(a, r, name)
        assert bool(a.abs().max() > 0), name


@pytest.mark.cuda
def test_ssd_gradient_bf16_inputs(cuda):
    args, init = _ssd_inputs(cuda, 2, 256, 32, 64, 1, 128, a_one=True)
    args = [args[0].bfloat16(), args[1], args[2], args[3].bfloat16(), args[4].bfloat16(), args[5].bfloat16()]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in args]
        y, state = fn(*leaves, chunk=128, init_state=None)
        return torch.autograd.grad(y.float().sum() + state.sum(), leaves)

    for name, a, r in zip(("x", "dt", "a", "b", "c", "d"), grads(ssd_ops.ssd), grads(ssd_chunked)):
        _close(a, r, name)


def _plain():
    from unittest import mock

    return mock.patch.multiple(attention.attn_ops, attention=attention_reference), \
        mock.patch.multiple(mamba2.ssd_ops, ssd=ssd_chunked)


@pytest.mark.cuda
@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2), ("dots", 2)])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m", "jamba-1.5-large-398b"])
def test_training_step_launches_and_gradients(cuda, arch, remat, per_layer):
    """The loss's forward launches a mixer kernel once a layer; a
    rematerialized period launches again in the backward; the backward
    launches nothing.  fp32 gradients through the kernels within 1e-4 of
    each leaf's largest entry of the plain path's, every leaf non-zero."""
    cfg = get_config(arch, reduced=True)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    params = zoo.init_params(cfg, torch.Generator(cuda).manual_seed(0), torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda, dtype=torch.int32,
                           generator=torch.Generator(cuda).manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}
    leaves = paths(params)
    for p in leaves.values():
        p.requires_grad_(True)
    fa.launches = ssd_ops.launches = 0
    loss = zoo.loss_fn(params, batch, cfg, PerfConfig(remat=remat))
    assert (fa.launches, ssd_ops.launches) == (n_attn, cfg.num_layers - n_attn)
    ours = torch.autograd.grad(loss, list(leaves.values()))
    assert (fa.launches, ssd_ops.launches) == (per_layer * n_attn, per_layer * (cfg.num_layers - n_attn))
    first, second = _plain()
    with first, second:
        plain_loss = zoo.loss_fn(params, batch, cfg, PerfConfig(remat=remat))
        theirs = torch.autograd.grad(plain_loss, list(leaves.values()))
    assert (fa.launches, ssd_ops.launches) == (per_layer * n_attn, per_layer * (cfg.num_layers - n_attn))
    assert float(loss) == pytest.approx(float(plain_loss), rel=1e-5)
    for k, a, b in zip(leaves, ours, theirs):
        scale = float(b.abs().max())
        assert scale > 0 and bool(torch.isfinite(a).all()), k
        assert float((a - b).abs().max()) <= 1e-4 * scale, k


@pytest.mark.cuda
def test_train_runs_on_the_card(cuda):
    fa.launches = 0
    out = train_mod.train("qwen3-1.7b", steps=3, batch=2, seq=64, log_every=100)
    assert fa.launches == 3 * 2 * 2                    # 2 layers, remat full
    assert len(out["losses"]) == 3 and all(torch.isfinite(torch.tensor(out["losses"])))
    assert all(p.is_cuda for p in paths(out["state"].params).values())


@pytest.mark.cuda
def test_async_checkpointer_on_card_tensors(cuda, tmp_path):
    cfg = get_config("qwen3-1.7b", reduced=True)
    fns = make_train_step(cfg, PerfConfig(optimizer_moment_dtype="bfloat16"))
    state = fns.init_state(zoo.init_params(cfg, torch.Generator(cuda).manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda, dtype=torch.int32)
    state, _ = fns.train_step(state, {"tokens": tokens, "labels": tokens}, 1e-3)
    ckpt = AsyncCheckpointer(CheckpointManager(str(tmp_path)))
    ckpt.save(1, state)
    snapshot = {k: t.detach().clone() for k, t in paths(state.params).items()}
    state, _ = fns.train_step(state, {"tokens": tokens, "labels": tokens}, 1e-3)   # in place
    ckpt.wait()
    step, restored = ckpt.manager.restore_latest(state)
    assert step == 1 and restored.opt.step == 1
    for k, t in paths(restored.params).items():
        assert t.is_cuda and t.dtype == snapshot[k].dtype and torch.equal(t, snapshot[k]), k
    for k, t in paths(restored.opt.m).items():
        assert t.is_cuda and t.dtype == torch.bfloat16, k
