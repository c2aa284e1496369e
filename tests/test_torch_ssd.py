"""The port's plain SSD versions vs the JAX package's: the recurrent oracle,
the chunked form, the decode step and the Pallas kernel in interpret mode,
on the same numpy inputs, at the JAX tests' own tolerances
(``tests/kernels/test_ssd.py``: 5e-4 on y, 5e-5 on the state, 2e-5 for
decode); and the wrapper's CPU route."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import (
    _expand_groups,
    _segsum,
    ssd_chunked,
    ssd_decode_step,
    ssd_recurrent_reference,
)

SHAPES = [   # tests/kernels/test_ssd.py's: b, s, h, p, g, n, chunk
    (2, 256, 4, 16, 2, 32, 64),
    (1, 128, 2, 8, 1, 16, 128),
    (2, 512, 8, 32, 2, 64, 128),
    (1, 256, 4, 64, 1, 128, 64),   # mamba2-370m-like head
]
Y_TOL, STATE_TOL, DECODE_TOL = 5e-4, 5e-5, 2e-5


@pytest.fixture(scope="session")
def jref():
    """The JAX package's SSD modules (imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains)."""
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.kernels.ssd import kernel, ref

    return dict(ref=ref, kernel=kernel)


def make_inputs(seed, b, s, h, p, g, n):
    """The reference test's input scales, drawn with numpy (fp32)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(f),
        dt=np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f),
        a=-np.exp(rng.standard_normal((h,))).astype(f),
        b_mat=(rng.standard_normal((b, s, g, n)) * 0.5).astype(f),
        c_mat=(rng.standard_normal((b, s, g, n)) * 0.5).astype(f),
        d_vec=rng.standard_normal((h,)).astype(f),
        init_state=(rng.standard_normal((b, h, p, n)) * 0.1).astype(f),
    )


ARGS = ("x", "dt", "a", "b_mat", "c_mat", "d_vec")


def _t(inp, with_state=True):
    args = [torch.from_numpy(inp[k]) for k in ARGS]
    return args, (torch.from_numpy(inp["init_state"]) if with_state else None)


def _j(inp, with_state=True):
    args = [jnp.asarray(inp[k]) for k in ARGS]
    return args, (jnp.asarray(inp["init_state"]) if with_state else None)


def _close(ours, theirs, atol):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_recurrent_oracle_matches_jax(jref, b, s, h, p, g, n, chunk, with_state):
    inp = make_inputs(0, b, s, h, p, g, n)
    (targs, tstate), (jargs, jstate) = _t(inp, with_state), _j(inp, with_state)
    y, st = ssd_recurrent_reference(*targs, init_state=tstate)
    jy, jst = jref["ref"].ssd_recurrent_reference(*jargs, init_state=jstate)
    _close(y, jy, Y_TOL)
    _close(st, jst, STATE_TOL)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_chunked_matches_jax_chunked_and_oracle(jref, b, s, h, p, g, n, chunk, with_state):
    inp = make_inputs(1, b, s, h, p, g, n)
    (targs, tstate), (jargs, jstate) = _t(inp, with_state), _j(inp, with_state)
    y, st = ssd_chunked(*targs, chunk=chunk, init_state=tstate)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    jy, jst = jref["ref"].ssd_chunked(*jargs, chunk=chunk, init_state=jstate)
    _close(y, jy, Y_TOL)
    _close(st, jst, STATE_TOL)
    oy, ost = jref["ref"].ssd_recurrent_reference(*jargs, init_state=jstate)
    _close(y, oy, Y_TOL)
    _close(st, ost, STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_chunked_matches_pallas_interpret(jref, b, s, h, p, g, n, chunk):
    """The Pallas kernel's own function, run in interpret mode on the CPU,
    is what the CUDA kernel ports; the plain chunked version is held to it."""
    inp = make_inputs(2, b, s, h, p, g, n)
    (targs, tstate), (jargs, jstate) = _t(inp), _j(inp)
    y, st = ssd_chunked(*targs, chunk=chunk, init_state=tstate)
    ky, kst = jref["kernel"].ssd_pallas(*jargs, chunk=chunk, init_state=jstate, interpret=True)
    _close(y, ky, Y_TOL)
    _close(st, kst, STATE_TOL)


def test_decode_step_matches_jax_and_the_scan(jref):
    """Tokens fed one at a time through ``ssd_decode_step`` equal the JAX
    decode step and the full-sequence oracle (the JAX test's shape)."""
    b, s, h, p, g, n = 2, 16, 4, 8, 1, 16
    inp = make_inputs(5, b, s, h, p, g, n)
    (targs, _), (jargs, _) = _t(inp), _j(inp)
    x, dt, a, bm, cm, d = targs
    jx, jdt, ja, jbm, jcm, jd = jargs
    state, jstate = torch.zeros((b, h, p, n)), jnp.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        y_t, state = ssd_decode_step(x[:, t], dt[:, t], a, bm[:, t], cm[:, t], d, state)
        jy_t, jstate = jref["ref"].ssd_decode_step(
            jx[:, t], jdt[:, t], ja, jbm[:, t], jcm[:, t], jd, jstate)
        _close(y_t, jy_t, DECODE_TOL)
        _close(state, jstate, DECODE_TOL)
        ys.append(y_t)
    y_ref, s_ref = ssd_recurrent_reference(*targs)
    _close(torch.stack(ys, 1), y_ref.numpy(), DECODE_TOL)
    _close(state, s_ref.numpy(), DECODE_TOL)


def test_state_handoff_across_chunked_calls(jref):
    """final_state of segment 1 fed as init_state of segment 2 ≡ one pass,
    and each segment equals the JAX package's."""
    inp = make_inputs(7, 1, 256, 2, 8, 1, 16)
    (targs, _), (jargs, _) = _t(inp), _j(inp)
    half = lambda args, sl: [t[:, sl] if t.dim() > 1 else t for t in args]
    y_full, s_full = ssd_chunked(*targs, chunk=64)
    y1, s1 = ssd_chunked(*half(targs, slice(0, 128)), chunk=64)
    y2, s2 = ssd_chunked(*half(targs, slice(128, None)), chunk=64, init_state=s1)
    _close(torch.cat([y1, y2], 1), y_full.numpy(), STATE_TOL)
    _close(s2, s_full.numpy(), STATE_TOL)
    jhalf = lambda args, sl: [t[:, sl] if t.ndim > 1 else t for t in args]
    jy1, js1 = jref["ref"].ssd_chunked(*jhalf(jargs, slice(0, 128)), chunk=64)
    jy2, js2 = jref["ref"].ssd_chunked(*jhalf(jargs, slice(128, None)), chunk=64, init_state=js1)
    _close(y2, jy2, Y_TOL)
    _close(s2, js2, STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_bf16_inputs_with_fp32_dt(jref, b, s, h, p, g, n, chunk):
    """x, B, C and d in bf16, dt and a in fp32, as on the served path: y
    comes out in bf16 within one bf16 ulp (plus the fp32 tolerance) of the
    JAX package's fp32 result on the same bf16 values; the state is fp32."""
    inp = make_inputs(3, b, s, h, p, g, n)
    bf = {k: torch.from_numpy(inp[k]).to(torch.bfloat16) for k in ("x", "b_mat", "c_mat", "d_vec")}
    args = [bf[k] if k in bf else torch.from_numpy(inp[k]) for k in ARGS]
    y, st = ssd_chunked(*args, chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    jargs = [jnp.asarray(t.float().numpy()) for t in args]
    jy, jst = jref["ref"].ssd_chunked(*jargs, chunk=chunk)
    jy = torch.from_numpy(np.array(jy))
    _, exp = torch.frexp(jy)
    ulp = torch.ldexp(torch.ones_like(jy), exp - 8)          # bf16 ulp of |jy|
    assert bool(((y.float() - jy).abs() <= ulp + Y_TOL).all())
    _close(st, jst, STATE_TOL)


def test_segsum_and_expand_groups_match_jax(jref):
    rng = np.random.default_rng(4)
    la = -np.abs(rng.standard_normal((2, 3, 16))).astype(np.float32)
    ours, theirs = _segsum(torch.from_numpy(la)).numpy(), np.asarray(jref["ref"]._segsum(jnp.asarray(la)))
    assert np.array_equal(np.isneginf(ours), np.isneginf(theirs))
    fin = np.isfinite(theirs)      # cumsums up to about 8: a few fp32 ulps
    np.testing.assert_allclose(ours[fin], theirs[fin], atol=1e-5, rtol=0)
    bc = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(_expand_groups(torch.from_numpy(bc), 6).numpy(),
                                  np.asarray(jref["ref"]._expand_groups(jnp.asarray(bc), 6)))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def test_wrapper_takes_the_plain_version_on_the_cpu():
    inp = make_inputs(6, 2, 256, 4, 16, 2, 32)
    args, state = _t(inp)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd(*args, chunk=64, init_state=state)
    ry, rst = ssd_chunked(*args, chunk=64, init_state=state)
    assert ssd_ops.launches == before
    assert torch.equal(y, ry) and torch.equal(st, rst)


def test_wrapper_raises_off_the_cpu_without_a_card():
    """A tensor that is on neither the CPU nor a CUDA card goes to the
    kernel's checks, which refuse it; the CPU route needs a CPU tensor."""
    args = [torch.empty(sh, device="meta") for sh in
            ((1, 64, 2, 8), (1, 64, 2), (2,), (1, 64, 1, 16), (1, 64, 1, 16), (2,))]
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_ops.ssd(*args, chunk=64)
    cpu_args = [torch.zeros(a.shape) for a in args]
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_ops.ssd_cuda(*cpu_args, chunk=64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.ssd(*cpu_args, chunk=48)


@pytest.mark.parametrize("bsz,heads,p,want", [
    (2, 32, 64, 32),     # the served prefill: 128 blocks
    (1, 32, 64, 16),     # a long prefill at batch 1: 128 blocks
    (8, 32, 64, 64),     # enough (batch, head) pairs: P stays whole
    (1, 2, 8, 8),
    (2, 4, 16, 16),
    (1, 4, 24, 8),
])
def test_p_slice_fills_the_card_and_fits_shared_memory(bsz, heads, p, want):
    ps = ssd_ops.p_slice(bsz, heads, p)
    assert ps == want and p % ps == 0
    assert ssd_ops.smem_bytes(128, 128, ps) <= 232448


def test_p_slice_rejects_a_head_dim_it_cannot_split():
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd_ops.p_slice(1, 4, 12)
