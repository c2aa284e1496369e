"""The port's training path against the JAX package, on the CPU: remat
modes, microbatched gradients, ``train()`` against a loop over the
reference's ``make_train_step`` (train steps op by op:
tests/test_torch_train_steps.py), resume, ``AsyncCheckpointer``, the
CLI, decode state; and a rehearsal of the flash and SSD autograd wrappers
with each kernel replaced by a counting plain stand-in (their launch
counts under each remat mode, their gradients), and of ``chip_smoke.py``'s
bf16 gradient check, which must fail a planted wrong SSD output."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.launch import train as train_mod
from repro_torch.models import decoder
from repro_torch.models import model_zoo as zoo
from repro_torch.training.train_loop import TrainState, _microbatch_grads, make_train_step
from repro_torch.tree import paths, tree_map

ROOT = Path(__file__).resolve().parents[1]



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
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import repro.configs
    import repro.configs.perf
    import repro.data.pipeline
    import repro.optim
    import repro.training.train_loop
    from repro.models import decoder as jdecoder
    from repro.models import model_zoo

    return dict(
        configs=repro.configs, perf=repro.configs.perf, data=repro.data.pipeline,
        optim=repro.optim, loop=repro.training.train_loop, zoo=model_zoo, decoder=jdecoder,
    )


def _carry(jref, arch, dtype=jnp.float32, seed=0):
    """The reduced config on both sides and the reference's init, carried."""
    jcfg, cfg = jref["configs"].get_config(arch, reduced=True), get_config(arch, reduced=True)
    jp = jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(seed), dtype))
    return jcfg, cfg, jp, zoo.params_from_numpy(jp, device="cpu")


def _batch(cfg, b=4, s=32, seed=1):
    raw = batch_for_arch(cfg, SyntheticLMStream(max(cfg.vocab_size, 2), b, s, seed=seed).next_batch())
    return raw, {k: torch.from_numpy(v) for k, v in raw.items()}


def _jflat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_leaves(ours: dict, theirs: dict, rel: float):
    assert ours.keys() == theirs.keys()
    for k, g in ours.items():
        ref = theirs[k]
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(g.detach().float().numpy() - ref).max())
        assert err <= rel * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# Remat and microbatches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m", "jamba-1.5-large-398b"])
def test_remat_modes_give_equal_losses_and_gradients(arch):
    cfg = get_config(arch, reduced=True)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    _, batch = _batch(cfg, b=2, s=16)
    leaves = list(paths(params).values())
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for remat in ("full", "dots", "none"):
        loss = zoo.loss_fn(params, batch, cfg, PerfConfig(remat=remat))
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
    for remat in ("dots", "none"):
        assert torch.equal(out[remat][0], out["full"][0])
        for a, b in zip(out[remat][1], out["full"][1]):
            assert torch.equal(a, b)


def test_loss_chunks_and_masked_labels(jref):
    """``loss_chunk`` below S (the last chunk ragged) and −1 labels, against
    the reference's padded scan."""
    jcfg, cfg, jp, params = _carry(jref, "qwen3-1.7b")
    raw, batch = _batch(cfg, b=2, s=40)
    raw["labels"][:, 5:9] = -1
    batch["labels"][:, 5:9] = -1
    want = jref["zoo"].loss_fn(jp, {k: jnp.asarray(v) for k, v in raw.items()}, jcfg,
                               jref["perf"].PerfConfig(loss_chunk=16))
    got = zoo.loss_fn(params, batch, cfg, PerfConfig(loss_chunk=16))
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert float(got) == pytest.approx(float(zoo.loss_fn(params, batch, cfg)), rel=1e-6)


@pytest.mark.parametrize("arch,num_micro", [("qwen3-1.7b", 1), ("qwen3-1.7b", 2), ("mamba2-370m", 2)])
def test_microbatch_grads_equal_the_reference(jref, arch, num_micro):
    jcfg, cfg, jp, params = _carry(jref, arch)
    raw, batch = _batch(cfg)
    jperf = jref["perf"].PerfConfig(num_microbatches=num_micro)
    jloss_fn = lambda p, b: jref["zoo"].loss_fn(p, b, jcfg, jperf)
    jl, jg = jax.jit(lambda p, b: jref["loop"]._microbatch_grads(jloss_fn, p, b, num_micro))(
        jp, {k: jnp.asarray(v) for k, v in raw.items()})
    perf = PerfConfig(num_microbatches=num_micro)
    loss, grads = _microbatch_grads(lambda p, b: zoo.loss_fn(p, b, cfg, perf), params, batch, num_micro)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert all(g.dtype == torch.float32 for g in grads.values())
    _close_leaves(grads, _jflat(jg), 1e-4)


# ---------------------------------------------------------------------------
# train() and resume
# ---------------------------------------------------------------------------
def test_train_equals_a_loop_over_the_reference_train_step(jref, monkeypatch):
    """``train()`` against the reference's ``make_train_step(mesh=None)``
    over the same stream at the same cosine rates, fp32 weights carried in
    place of the initial draw (the reference's ``train()`` fails under jax
    0.9.0, C-ref-2)."""
    jcfg, cfg, jp, params = _carry(jref, "qwen3-1.7b")
    monkeypatch.setattr(train_mod.zoo, "init_params", lambda *args, **kw: params)
    steps, lr, warmup = 5, 3e-3, 2
    out = train_mod.train("qwen3-1.7b", steps=steps, batch=2, seq=32, lr=lr, warmup=warmup,
                          device="cpu", log_every=100)
    fns = jref["loop"].make_train_step(jcfg, jref["perf"].PerfConfig())
    state = fns.init_state(jp)
    step_fn = jax.jit(fns.train_step)
    stream = jref["data"].SyntheticLMStream(jcfg.vocab_size, 2, 32, seed=0)
    want = []
    for step in range(steps):
        raw = jref["data"].batch_for_arch(jcfg, stream.next_batch())
        rate = jref["optim"].cosine_with_warmup(step, lr, warmup, steps)
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in raw.items()}, rate)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)


def test_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """tests/test_fault_tolerance.py::TestRestartPath on the port: 3 steps,
    a restart to 6, against 6 uninterrupted (bf16 weights, as the
    reference trains)."""
    kw = dict(steps=6, batch=2, seq=32, ckpt_every=3, log_every=100, device="cpu")
    full = train_mod.train("qwen3-1.7b", ckpt_dir=str(tmp_path / "a"), **kw)
    train_mod.train("qwen3-1.7b", ckpt_dir=str(tmp_path / "b"), **{**kw, "steps": 3})
    resumed = train_mod.train("qwen3-1.7b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(resumed["losses"]) == 3
    assert resumed["final_loss"] == pytest.approx(full["final_loss"], rel=1e-4)
    assert resumed["losses"] == full["losses"][3:]      # exact: the restore is lossless
    for k, p in paths(resumed["state"].params).items():
        assert torch.equal(p, paths(full["state"].params)[k])
    assert CheckpointManager(str(tmp_path / "b")).steps() == [3, 6]


def test_restore_latest_into_a_train_state(tmp_path):
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0))
    fns = make_train_step(cfg, PerfConfig(optimizer_moment_dtype="bfloat16"))
    state = fns.init_state(params)
    state, _ = fns.train_step(state, _batch(cfg, b=2, s=16)[1], 1e-3)
    manager = CheckpointManager(str(tmp_path))
    manager.save(1, state)
    step, restored = manager.restore_latest(state, device="cpu")
    assert step == 1 and isinstance(restored, TrainState) and restored.compress_err is None
    assert restored.opt.step == 1 and isinstance(restored.opt.step, int)
    for tree in ("params", "m", "v"):
        ours = paths(getattr(restored.opt, tree) if tree != "params" else restored.params)
        theirs = paths(getattr(state.opt, tree) if tree != "params" else state.params)
        assert ours.keys() == theirs.keys()
        for k, t in theirs.items():
            assert ours[k].dtype == t.dtype and torch.equal(ours[k], t), k


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------
def _small_state():
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": {"x": torch.ones(3)}}
    return make_train_step(get_config("qwen3-1.7b", reduced=True)).init_state(params)


def test_async_checkpointer_snapshots_then_writes(tmp_path):
    state = _small_state()
    ckpt = AsyncCheckpointer(CheckpointManager(str(tmp_path)))
    ckpt.save(7, state)
    before = state.params["w"].clone()
    with torch.no_grad():
        state.params["w"].add_(100.0)        # the next step, in place, while the write runs
    ckpt.wait()
    step, restored = ckpt.manager.restore_latest(state, device="cpu")
    assert step == 7 and torch.equal(restored.params["w"], before)
    ckpt.save(8, state)                       # waits for nothing, writes the new values
    ckpt.wait()
    assert torch.equal(ckpt.manager.restore(8, state, device="cpu").params["w"], before + 100.0)


def test_async_checkpointer_surfaces_a_failed_write(tmp_path, monkeypatch):
    manager = CheckpointManager(str(tmp_path))
    ckpt = AsyncCheckpointer(manager)

    def broken(step, state):
        raise OSError(f"disk full at step {step}")

    monkeypatch.setattr(manager, "save", broken)
    ckpt.save(1, _small_state())
    with pytest.raises(OSError, match="disk full at step 1"):
        ckpt.wait()
    ckpt.wait()                               # the error is raised once
    ckpt.save(2, _small_state())
    with pytest.raises(OSError, match="disk full at step 2"):
        ckpt.save(3, _small_state())          # save waits for the previous write
    assert manager.steps() == []


# ---------------------------------------------------------------------------
# The CLI and the decode state
# ---------------------------------------------------------------------------
def test_cli_trains_on_the_cpu(capsys):
    out = train_mod.main(["--arch", "mamba2-370m", "--reduced", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--microbatches", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "step     0  loss" in text and "step     2  loss" in text
    assert f"loss {out['first_loss']:.4f} → {out['final_loss']:.4f}" in text
    assert "s a step after the first" in text and "tokens/s" in text
    assert all(np.isfinite(out["losses"])) and len(out["step_s"]) == 3


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m", "jamba-1.5-large-398b"])
def test_init_decode_state_matches_the_reference_layout(jref, arch):
    jcfg, cfg = jref["configs"].get_config(arch, reduced=True), get_config(arch, reduced=True)
    want = jref["decoder"].init_decode_state(jcfg, 2, 24)
    got = decoder.init_decode_state(cfg, 2, 24, device="cpu")
    assert len(got.caches) == decoder.num_periods(cfg)
    for pos, jcache in want.caches.items():
        for field in jcache._fields:
            stacked = np.asarray(getattr(jcache, field))
            for period in got.caches:
                ours = getattr(period[pos], field)
                if isinstance(ours, int):            # the port's cache index is a host int
                    assert ours == int(stacked.reshape(-1)[0])
                    continue
                assert tuple(ours.shape) == stacked.shape[1:], (pos, field)
                assert ours.dtype == getattr(torch, str(stacked.dtype)), (pos, field)
                np.testing.assert_array_equal(ours.float().numpy(), stacked[0].astype(np.float32))
    assert got.caches[0]["pos0"][0].data_ptr() != got.caches[-1]["pos0"][0].data_ptr() or len(got.caches) == 1
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0))
    logits, _ = decoder.decode_step(params, got, torch.tensor([1, 2]), cfg)
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# Rehearsal of the card's autograd wrappers
# ---------------------------------------------------------------------------
@pytest.fixture
def stand_ins(monkeypatch):
    """Route CPU tensors through the card's path of both wrappers, with each
    kernel replaced by its plain version counted as a launch."""
    count = {"flash": 0, "ssd": 0}

    def flash(q, k, v, *, causal=True, window=0, q_offset=0):
        count["flash"] += 1
        return attention_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)

    def ssd(x, dt, a, b_mat, c_mat, d_vec, *, chunk=128, init_state=None):
        count["ssd"] += 1
        return ssd_chunked(x, dt, a, b_mat, c_mat, d_vec, chunk=chunk, init_state=init_state)

    monkeypatch.setattr(fa, "flash_attention_cuda", flash)
    monkeypatch.setattr(fa, "attention", lambda q, k, v, *, causal=True, window=0, q_offset=0:
                        fa._card(q, k, v, causal, window, q_offset))
    monkeypatch.setattr(ssd_ops, "ssd_cuda", ssd)
    monkeypatch.setattr(ssd_ops, "ssd", lambda *args, chunk=128, init_state=None:
                        ssd_ops._card(*args, chunk=chunk, init_state=init_state))
    return count


def test_flash_function_gradient_is_the_plain_version_s(stand_ins):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen) for s in ((2, 24, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    w = torch.randn(2, 24, 4, 16, generator=gen)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=True, window=8, q_offset=0)
        return torch.autograd.grad((out * w).sum(), leaves)

    ours = grads(fa.attention)
    assert stand_ins["flash"] == 1                      # the forward only
    for a, b in zip(ours, grads(attention_reference)):
        assert torch.equal(a, b)
    # only q wants a gradient: k and v get none
    out = fa.attention(q.clone().requires_grad_(True), k, v)
    assert out.grad_fn is not None and stand_ins["flash"] == 2
    with torch.no_grad():
        assert fa.attention(q, k, v).grad_fn is None and stand_ins["flash"] == 3


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_function_gradient_is_the_plain_version_s(stand_ins, with_state):
    gen = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(s, generator=gen)
    args = [r(2, 64, 4, 8), torch.nn.functional.softplus(r(2, 64, 4)), -torch.exp(r(4)),
            r(2, 64, 2, 16) * 0.5, r(2, 64, 2, 16) * 0.5, r(4)]
    init = r(2, 4, 8, 16) * 0.1 if with_state else None
    wy, ws = r(2, 64, 4, 8), r(2, 4, 8, 16)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in args]
        st = init.clone().requires_grad_(True) if with_state else None
        y, state = fn(*leaves, chunk=32, init_state=st)
        return torch.autograd.grad((y * wy).sum() + (state * ws).sum(), leaves + ([st] if st is not None else []))

    ours = grads(ssd_ops.ssd)
    assert stand_ins["ssd"] == 1
    theirs = grads(ssd_chunked)
    assert len(ours) == 7 if with_state else 6
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2), ("dots", 2)])
@pytest.mark.parametrize("arch,kernel", [("qwen3-1.7b", "flash"), ("mamba2-370m", "ssd")])
def test_launches_a_step_under_each_remat_mode(stand_ins, arch, kernel, remat, per_layer):
    """One launch a layer a forward; a rematerialized period launches again
    in the backward pass; the backward itself launches nothing.  Every
    leaf in front of the kernel gets a gradient."""
    cfg = get_config(arch, reduced=True)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    _, batch = _batch(cfg, b=2, s=64)
    leaves = paths(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = zoo.loss_fn(params, batch, cfg, PerfConfig(remat=remat))
    assert stand_ins[kernel] == cfg.num_layers
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert stand_ins[kernel] == per_layer * cfg.num_layers
    front = [k for k in grads if "/attn/w" in k or "/ssm/w_" in k or k == "embed"]
    assert front and all(float(grads[k].abs().max()) > 0 for k in front)


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fault", [None, "zeros", "skip dropped"])
def test_chip_smoke_layer_check_fails_a_wrong_ssd_output(monkeypatch, fault):
    """``chip_smoke.py``'s bf16 gradient check a period at a time
    (``_layer_check``), rehearsed on the CPU with the reduced mamba2-370m
    and the SSD kernel replaced by its plain version counted as a launch:
    it passes, and exits where the kernel's output is planted wrong."""
    cs = _chip_smoke()

    def kernel(x, dt, a, b_mat, c_mat, d_vec, *, chunk=128, init_state=None):
        ssd_ops.launches += 1
        y, state = ssd_chunked(x, dt, a, b_mat, c_mat, d_vec, chunk=chunk, init_state=init_state)
        if fault == "zeros":
            y = torch.zeros_like(y)
        elif fault == "skip dropped":
            y = (y.float() - x.float() * d_vec.float()[None, None, :, None]).to(y.dtype)
        return y, state

    monkeypatch.setattr(ssd_ops, "ssd_cuda", kernel)
    monkeypatch.setattr(ssd_ops, "ssd", lambda *args, chunk=128, init_state=None:
                        ssd_ops._card(*args, chunk=chunk, init_state=init_state))
    cfg = get_config("mamba2-370m", reduced=True)
    p16 = zoo.init_params(cfg, torch.Generator().manual_seed(11), torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(12))
    args = (cfg, tree_map(lambda t: t.double(), p16), p16, {"tokens": tokens, "labels": tokens},
            ssd_ops, "ssd", "cpu")
    if fault is None:
        worst = cs._layer_check(*args)
        assert worst["kernel_plain"] <= cs.TRAIN_BF16_LIMIT
    else:
        with pytest.raises(SystemExit):
            cs._layer_check(*args)
