"""The port's plain SSD versions vs the JAX package's: the recurrent oracle,
the chunked form, the decode step and the Pallas kernel in interpret mode,
on the same numpy inputs, at the JAX tests' own tolerances
(``tests/kernels/test_ssd.py``: 5e-4 on y, 5e-5 on the state, 2e-5 for
decode); the wrapper's CPU route; and ``csrc/ssd.cu``'s launch geometry
and its staged numerics, emulated on the CPU and held to the JAX package."""
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


# ---------------------------------------------------------------------------
# csrc/ssd.cu's launch geometry and its numerics, emulated on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,blocks", [
    # b, s, h, p, g, n, chunk → blocks of the four kernels for bf16 inputs,
    # and of the output kernel for fp32 inputs (64 rows a block, not 128)
    ((2, 256, 32, 64, 1, 128, 128), (44, 256, 512, 128, 256)),     # the served prefill
    ((1, 2048, 32, 64, 1, 128, 128), (176, 1024, 256, 512, 1024)), # 16 chunks at once
    ((1, 256, 8, 64, 2, 128, 128), (16, 32, 64, 16, 32)),         # two groups
    ((1, 256, 8, 64, 4, 128, 128), (28, 32, 64, 16, 32)),         # four groups
    ((2, 256, 4, 16, 2, 32, 64), (24, 32, 8, 32, 32)),            # tests/kernels/test_ssd.py's
    ((1, 128, 2, 8, 1, 16, 128), (4, 2, 2, 2, 4)),                # one chunk, P and N below a tile
    ((1, 192, 2, 24, 1, 32, 96), (7, 4, 2, 4, 8)),                # a chunk of 96: part of a row tile
])
def test_geometry_runs_chunks_in_parallel_with_one_score_tile_per_group(shape, blocks):
    """One score tile per (batch, group, chunk), whatever the heads; every
    chunk's state and output in blocks of their own (the grids of
    ``csrc/ssd.cu``'s ``launch_all``)."""
    b, s, h, p, g, n, q = shape
    geo = ssd_ops.geometry(*shape)
    assert geo["scores"] == (b, g, s // q, q, q)
    assert geo["cs"] == (b, h, s)
    assert geo["states"] == (b, h, s // q, p, n)
    assert geo["entering"] == (b, h, s // q, 2, p, n)
    assert tuple(geo["blocks"].values()) == blocks[:4]
    assert ssd_ops.geometry(*shape, bf16=False)["blocks"]["output"] == blocks[4]
    assert ssd_ops.geometry(b, s, 2 * h, p, g, n, q)["scores"] == geo["scores"]


@pytest.mark.parametrize("shape,match", [
    ((1, 128, 4, 12, 1, 32, 64), "multiple of 8"),     # a head dim the tiles cannot take
    ((1, 128, 4, 16, 1, 24, 64), "power of two"),
    ((1, 128, 4, 16, 1, 32, 48), "multiple of 32"),
    ((1, 96, 4, 16, 1, 32, 64), "multiple of the chunk"),
    ((1, 128, 6, 16, 4, 32, 64), "multiple of groups"),
])
def test_geometry_refuses_what_the_kernels_do_not_take(shape, match):
    with pytest.raises(ValueError, match=match):
        ssd_ops.geometry(*shape)


def bf16_parts(v, parts):
    """The sum of ``parts`` bf16 values, each the rounding of what the ones
    before leave of v (fp32): the value the tensor cores multiply."""
    out, rest = torch.zeros_like(v), v
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part, rest - part
    return out


def emulate_ssd_kernel(x, dt, a, b_mat, c_mat, d_vec, *, chunk, init_state=None):
    """What ``csrc/ssd.cu`` computes, stage by stage, in fp32 on the CPU:

    1. cs: a·dt rounded, each of 32 lanes summing chunk/32 consecutive
       steps in order, the lane sums scanned as the shuffles do
       (Hillis–Steele), the lanes below's sum added; the score tile
       S[j][i] = B_j·C_i once per (batch, group, chunk);
    2. each chunk's own state Σ_j ((x_j·dt_j)·decay_j) ⊗ B_j, with decay_j
       = exp(Σ_{i>j} a·dt_i) summed from the chunk's end: each lane's steps
       from its last, the lanes above's sums scanned as the shuffles do;
    3. the states passed in order: slot c ← carry,
       carry ← exp(total_c)·carry + ΔH_c, from init_state or zeros;
    4. y = exp(cs_i)·(C_i·H_entering) + Σ_{j≤i} (S[j][i]·exp(cs_i − cs_j))·(x_j·dt_j)
       + D·x, rounded once to x's dtype.

    For bf16 inputs (the tensor-core path) dt moves to the fp32 side of
    the output's product, ((S[j][i]·exp(cs_i − cs_j))·dt_j)·x_j, so that x
    stays exact, and the output's fp32 operands (that one and the entering
    state) are cut to the sum of two bf16 parts, as the kernel multiplies
    them; the chunk's own state takes three parts, which sum to the fp32
    value exactly.  The sums inside a product run in another order than the
    kernel's."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q, nc, hpg = chunk, s // chunk, h // g
    lanes, per = 32, chunk // 32
    xf, dtf, af = x.float(), dt.float(), a.float()
    la = (af[None, None, :] * dtf).reshape(bsz, nc, lanes, per, h)
    part, run = [], torch.zeros((bsz, nc, lanes, h))
    for k in range(per):
        run = run + la[:, :, :, k]
        part.append(run)
    part = torch.stack(part, dim=3)
    incl = run
    for off in (1, 2, 4, 8, 16):
        below = torch.zeros_like(incl)
        below[:, :, off:] = incl[:, :, :-off]
        incl = incl + below
    before = torch.zeros_like(incl)
    before[:, :, 1:] = incl[:, :, :-1]
    cs = (part + before[:, :, :, None]).reshape(bsz, nc, q, h)
    bc = b_mat.float().reshape(bsz, nc, q, g, n)
    cc = c_mat.float().reshape(bsz, nc, q, g, n)
    scores = torch.einsum("bcjgn,bcign->bcgji", bc, cc)             # once per group
    xbar = (xf * dtf[..., None]).reshape(bsz, nc, q, h, p)
    total = cs[:, :, -1]                                              # (B, NC, H)
    after, run = [None] * per, torch.zeros((bsz, nc, lanes, h))
    for k in reversed(range(per)):
        after[k] = run                                                # the lane's steps after k
        run = run + la[:, :, :, k]
    incl = run
    for off in (1, 2, 4, 8, 16):
        above = torch.zeros_like(incl)
        above[:, :, :-off] = incl[:, :, off:]
        incl = incl + above
    above = torch.zeros_like(incl)
    above[:, :, :-1] = incl[:, :, 1:]
    decay = torch.exp(torch.stack(after, dim=3) + above[:, :, :, None]).reshape(bsz, nc, q, h)
    bh, ch = bc.repeat_interleave(hpg, dim=3), cc.repeat_interleave(hpg, dim=3)
    own = torch.einsum("bcjhp,bcjhn->bchpn", xbar * decay[..., None], bh)
    carry = torch.zeros((bsz, h, p, n)) if init_state is None else init_state.float()
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = torch.exp(total[:, c])[..., None, None] * carry + own[:, c]
    entering = torch.stack(entering, dim=1)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        entering = bf16_parts(entering, 2)
    y = torch.einsum("bcihn,bchpn->bcihp", ch, entering) * torch.exp(cs)[..., None]
    csh = cs.permute(0, 1, 3, 2)                                      # (B, NC, H, Q)
    diff = csh[..., None, :] - csh[..., :, None]                      # [j][i] = cs_i − cs_j
    below_diag = torch.ones((q, q), dtype=torch.bool).triu()          # j ≤ i
    lmat = torch.exp(diff.masked_fill(~below_diag, float("-inf")))
    sl = scores.repeat_interleave(hpg, dim=2) * lmat                  # (B, NC, H, J, I)
    if bf16:
        w = bf16_parts(sl * dtf.reshape(bsz, nc, q, h).permute(0, 1, 3, 2)[..., None], 2)
        y = y + torch.einsum("bchji,bcjhp->bcihp", w, xf.reshape(bsz, nc, q, h, p))
    else:
        y = y + torch.einsum("bchji,bcjhp->bcihp", sl, xbar)
    y = y.reshape(bsz, s, h, p) + xf * d_vec.float()[None, None, :, None]
    return y.to(x.dtype), carry


EMULATED = [   # b, s, h, p, g, n, chunk, a = -1
    *[(*row, False) for row in SHAPES],          # the reference test's, a = -exp(normal)
    (1, 1024, 4, 64, 1, 128, 64, False),         # many chunks, the state passed between them
    (1, 256, 8, 64, 4, 128, 128, True),          # four groups
    (2, 256, 32, 64, 1, 128, 128, True),         # the served prefill, the init's a = -1
    (2, 128, 256, 64, 1, 128, 128, True),        # jamba's mixer: 256 heads, one chunk
]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,a_one", EMULATED)
def test_emulated_kernel_matches_jax_oracle_and_chunked(jref, b, s, h, p, g, n, chunk, a_one, with_state):
    """The kernel's stages in fp32 stay within the reference test's limits
    of the JAX package's recurrent oracle and of its chunked form."""
    inp = make_inputs(11, b, s, h, p, g, n)
    if a_one:
        inp["a"] = -np.ones((h,), np.float32)
    (targs, tstate), (jargs, jstate) = _t(inp, with_state), _j(inp, with_state)
    y, st = emulate_ssd_kernel(*targs, chunk=chunk, init_state=tstate)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    oy, ost = jref["ref"].ssd_recurrent_reference(*jargs, init_state=jstate)
    _close(y, oy, Y_TOL)
    _close(st, ost, STATE_TOL)
    cy, cst = jref["ref"].ssd_chunked(*jargs, chunk=chunk, init_state=jstate)
    _close(y, cy, Y_TOL)
    _close(st, cst, STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,a_one", EMULATED)
def test_emulated_kernel_bf16_within_one_ulp_of_jax(jref, b, s, h, p, g, n, chunk, a_one):
    """bf16 x, B, C and d, fp32 dt and a, one rounding of y: within one bf16
    ulp (plus the fp32 tolerance) of the JAX oracle on the same values, and
    the state within the fp32 tolerance."""
    inp = make_inputs(12, b, s, h, p, g, n)
    if a_one:
        inp["a"] = -np.ones((h,), np.float32)
    bf = {k: torch.from_numpy(inp[k]).to(torch.bfloat16) for k in ("x", "b_mat", "c_mat", "d_vec")}
    args = [bf[k] if k in bf else torch.from_numpy(inp[k]) for k in ARGS]
    y, st = emulate_ssd_kernel(*args, chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    jy, jst = jref["ref"].ssd_recurrent_reference(*[jnp.asarray(t.float().numpy()) for t in args])
    jy = torch.from_numpy(np.array(jy))
    _, exp = torch.frexp(jy)
    ulp = torch.ldexp(torch.ones_like(jy), exp - 8)
    assert bool(((y.float() - jy).abs() <= ulp + Y_TOL).all())
    _close(st, jst, STATE_TOL)


@pytest.mark.parametrize("parts", [2, 3])
def test_bf16_parts_carry_an_fp32_value(parts):
    """The kernel's split of an fp32 operand for the tensor cores: three
    bf16 parts sum to the value exactly, two leave under 2^-16 of it."""
    rng = np.random.default_rng(13)
    v = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.integers(-20, 20, 100_000))
                         .astype(np.float32))
    got = bf16_parts(v, parts)
    if parts == 3:
        assert torch.equal(got, v)
    else:
        assert bool(((got - v).abs() <= v.abs() * 2.0 ** -16).all())
