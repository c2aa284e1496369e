"""The port's LSTM path vs the JAX package: the plain LSTM against the JAX
reference and the Pallas kernel (interpret mode), the model's logits, loss
and gradients from carried-across weights, three AdamW steps, the sensor
stream, and the quickstart's training loop.

Inputs are made with numpy from a seed and handed to both sides; weights
go from the JAX package to the port through ``params_from_numpy``.  The
tolerances are the JAX tests' own: 1e-5 on the LSTM outputs
(``tests/kernels/test_lstm.py``)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from repro_torch.configs import paper_lstm
from repro_torch.data.pipeline import TimeSeriesStream
from repro_torch.kernels.lstm import ops as lstm_ops
from repro_torch.kernels.lstm.ref import lstm_reference
from repro_torch.models import lstm as lstm_model
from repro_torch.models.model_zoo import params_from_numpy
from repro_torch.optim import adamw, clip_by_global_norm

SHAPES = [(4, 32, 6, 20), (1, 16, 3, 7), (8, 64, 12, 20)]   # tests/kernels/test_lstm.py


@pytest.fixture(scope="module")
def jref():
    from repro.data import pipeline
    from repro.kernels.lstm import kernel, ref
    from repro.models import lstm
    from repro import optim

    return dict(kernel=kernel, ref=ref, model=lstm, pipeline=pipeline, optim=optim)


def make(seed, b, s, i, h):
    """The JAX test's input scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((b, s, i)).astype(np.float32),
        (rng.standard_normal((i, 4 * h)) * 0.3).astype(np.float32),
        (rng.standard_normal((h, 4 * h)) * 0.3).astype(np.float32),
        (rng.standard_normal((4 * h,)) * 0.1).astype(np.float32),
        (rng.standard_normal((b, h)) * 0.5).astype(np.float32),
        (rng.standard_normal((b, h)) * 0.5).astype(np.float32),
    ]


def _flat(out):
    hs, (h, c) = out
    return [np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t) for t in (hs, h, c)]


def _assert_close(ours, theirs, atol):
    for a, b in zip(_flat(ours), _flat(theirs)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the LSTM op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,i,h", SHAPES)
def test_reference_matches_jax_reference_and_pallas_kernel(jref, b, s, i, h, with_state):
    arrs = make(0, b, s, i, h)
    if not with_state:
        arrs = arrs[:4]
    ours = lstm_reference(*(torch.from_numpy(a) for a in arrs))
    theirs = jref["ref"].lstm_reference(*(jnp.asarray(a) for a in arrs))
    pallas = jref["kernel"].lstm_pallas(*(jnp.asarray(a) for a in arrs), interpret=True)
    _assert_close(ours, theirs, 1e-5)
    _assert_close(ours, pallas, 1e-5)


@settings(max_examples=10, deadline=None)
@given(
    b=st.integers(1, 4),
    s=st.sampled_from([8, 24]),
    i=st.integers(2, 8),
    h=st.sampled_from([5, 20, 33]),
    seed=st.integers(0, 2**31 - 1),
)
def test_reference_matches_pallas_kernel_hypothesis(jref, b, s, i, h, seed):
    arrs = make(seed, b, s, i, h)[:4]
    ours = lstm_reference(*(torch.from_numpy(a) for a in arrs))
    pallas = jref["kernel"].lstm_pallas(*(jnp.asarray(a) for a in arrs), interpret=True)
    _assert_close(ours, pallas, 1e-5)


def test_op_takes_the_plain_version_for_cpu_tensors():
    arrs = [torch.from_numpy(a) for a in make(1, 2, 8, 6, 20)]
    before = lstm_ops.launches
    ours = lstm_ops.lstm(*arrs)
    assert lstm_ops.launches == before
    _assert_close(ours, lstm_reference(*arrs), 0.0)


def test_kernel_wrapper_refuses_cpu_tensors():
    arrs = [torch.from_numpy(a) for a in make(1, 2, 8, 6, 20)]
    with pytest.raises(ValueError, match="CUDA"):
        lstm_ops.lstm_cuda(*arrs)


@pytest.mark.parametrize("with_state", [False, True])
def test_autograd_function_forward_values_and_plain_gradient(monkeypatch, with_state):
    """The card's autograd.Function, run here with the launch swapped for
    a stand-in: the forward returns what the launch returned, and the
    backward is plain autograd of the plain version."""
    arrs = [torch.from_numpy(a) for a in make(2, 3, 12, 5, 7)]
    if not with_state:
        arrs = arrs[:4] + [None, None]
    calls = []

    def launch(*args):
        calls.append(args)
        hs, (h, c) = lstm_reference(*args)
        return hs + 1.0, h + 1.0, c + 1.0     # marked, to show which values flow

    monkeypatch.setattr(lstm_ops, "lstm_cuda", launch)
    leaves = [a.clone().requires_grad_(True) if a is not None else None for a in arrs]
    hs, h, c = lstm_ops._LstmFunction.apply(*leaves)
    assert len(calls) == 1
    ref_hs, (ref_h, ref_c) = lstm_reference(*arrs)
    np.testing.assert_array_equal(hs.detach().numpy(), ref_hs.numpy() + 1.0)
    weights = [torch.from_numpy(np.random.default_rng(3).standard_normal(t.shape).astype(np.float32))
               for t in (hs, h, c)]
    loss = sum((w * t).sum() for w, t in zip(weights, (hs, h, c)))
    wanted = [t for t in leaves if t is not None]
    got = torch.autograd.grad(loss, wanted)

    plain = [a.clone().requires_grad_(True) if a is not None else None for a in arrs]
    phs, (ph, pc) = lstm_reference(*plain)
    ploss = sum((w * t).sum() for w, t in zip(weights, (phs, ph, pc)))
    want = torch.autograd.grad(ploss, [t for t in plain if t is not None])
    assert len(calls) == 1                   # the backward launches nothing
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the model, the optimizer and the stream
# ---------------------------------------------------------------------------
def _jax_params(jref, seed=0):
    cfg = paper_lstm.full()
    return jax.device_get(jref["model"].init_params(cfg, jax.random.PRNGKey(seed)))


def _batch(seed=0, b=8):
    cfg = paper_lstm.full()
    x, y = TimeSeriesStream(cfg.input_dim, cfg.seq_len, cfg.num_classes, batch=b, seed=seed).next_batch()
    return x, y


def test_specs_and_params_from_numpy_carry_the_flat_dict(jref):
    from repro.configs import paper_lstm as jcfg

    cfg = paper_lstm.full()
    assert {k: (s.shape, s.init) for k, s in lstm_model.lstm_specs(cfg).items()} == {
        k: (s.shape, s.init) for k, s in jref["model"].lstm_specs(jcfg.full()).items()}
    jparams = _jax_params(jref)
    params = params_from_numpy(jparams, device="cpu")
    assert sorted(params) == sorted(jparams) == ["b", "b_out", "w_hh", "w_ih", "w_out"]
    for k, v in params.items():
        assert v.dtype == torch.float32 and tuple(v.shape) == jparams[k].shape
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]))
    ours = lstm_model.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in jparams.items()}
    assert float(ours["b"].abs().sum()) == 0.0 and float(ours["b_out"].abs().sum()) == 0.0


def test_config_matches_jax_without_lane_padding():
    from repro.configs import paper_lstm as jcfg

    for name in ("full", "reduced"):
        ours, theirs = getattr(paper_lstm, name)(), getattr(jcfg, name)()
        assert {f: getattr(theirs, f) for f in ours.__dataclass_fields__} == vars(ours)
    assert not hasattr(paper_lstm.full(), "padded_hidden")


def test_apply_logits_and_loss_match_jax(jref):
    jparams = _jax_params(jref, seed=1)
    params = params_from_numpy(jparams, device="cpu")
    x, y = _batch(seed=4)
    logits = lstm_model.apply(params, torch.from_numpy(x))
    jlogits = jref["model"].apply(jparams, jnp.asarray(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    loss = lstm_model.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y))
    jloss = jref["model"].loss_fn(jparams, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)


def test_loss_gradients_match_jax(jref):
    jparams = _jax_params(jref, seed=2)
    params = {k: v.requires_grad_(True) for k, v in params_from_numpy(jparams, device="cpu").items()}
    x, y = _batch(seed=5)
    loss = lstm_model.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jgrads = jax.grad(jref["model"].loss_fn)(jparams, jnp.asarray(x), jnp.asarray(y))
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(),                                  # the defaults: decay 0.1, clip at 1
    dict(weight_decay=0.0, clip_norm=1.0),   # the quickstart's
    dict(clip_norm=None),
])
def test_adamw_three_steps_match_jax(jref, kw):
    rng = np.random.default_rng(7)
    jparams = _jax_params(jref, seed=3)
    params = params_from_numpy(jparams, device="cpu")
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in jparams.items()}
             for s in (0.05, 3.0, 0.5)]      # the second step's norm is clipped
    jopt, opt = jref["optim"].adamw(**kw), adamw(**kw)
    jstate, state = jopt.init(jparams), opt.init(params)
    for g in grads:
        jparams, jstate, jnorm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                             jstate, jparams, 3e-3)
        params, state, norm = opt.update(params_from_numpy(g, device="cpu"), state, params, 3e-3)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert state.step == int(jstate.step) == 3
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(state.m[k].numpy(), np.asarray(jstate.m[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(state.v[k].numpy(), np.asarray(jstate.v[k]), atol=1e-6, rtol=0)


def test_clip_by_global_norm_matches_jax(jref):
    rng = np.random.default_rng(8)
    tree = {k: rng.standard_normal((3, 4)).astype(np.float32) for k in "ab"}
    for max_norm in (0.5, 100.0):
        clipped, norm = jref["optim"].clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        ours, onorm = clip_by_global_norm(params_from_numpy(tree, device="cpu"), max_norm)
        np.testing.assert_allclose(float(onorm), float(norm), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(clipped[k]), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(batch=32, seed=3), dict(input_dim=3, seq_len=16, batch=1)])
def test_time_series_stream_batches_are_equal(jref, kw):
    ours, theirs = TimeSeriesStream(**kw), jref["pipeline"].TimeSeriesStream(**kw)
    for _ in range(4):
        (x, y), (jx, jy) = ours.next_batch(), theirs.next_batch()
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert ours.step == theirs.step == 4


# ---------------------------------------------------------------------------
# the quickstart's training loop
# ---------------------------------------------------------------------------
def test_train_accelerator_on_cpu_matches_the_jax_step(jref, capsys):
    """Five steps of the port's loop against the reference quickstart's
    jitted step, from the same initial weights and batches."""
    from repro_torch.examples import quickstart

    steps = 5
    out = quickstart.train_accelerator(device="cpu", steps=steps)
    text = capsys.readouterr().out
    assert "step   0  loss" in text and "single inference time" in text
    assert "on cpu [cpu]" in text and "0.0281 ms on the FPGA" in text
    assert len(out["losses"]) == steps and 0.0 <= out["accuracy"] <= 1.0
    assert out["inference_ms"] > 0

    cfg = paper_lstm.full()
    init = lstm_model.init_params(cfg, torch.Generator().manual_seed(0))
    jparams = {k: jnp.asarray(v.numpy()) for k, v in init.items()}
    opt = jref["optim"].adamw(weight_decay=0.0, clip_norm=1.0)
    jstate = opt.init(jparams)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(jref["model"].loss_fn)(params, x, y)
        params, opt_state, _ = opt.update(grads, opt_state, params, 3e-3)
        return params, opt_state, loss

    stream = jref["pipeline"].TimeSeriesStream(cfg.input_dim, cfg.seq_len, cfg.num_classes, batch=32)
    jlosses = []
    for _ in range(steps):
        x, y = stream.next_batch()
        jparams, jstate, loss = step(jparams, jstate, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(loss))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
