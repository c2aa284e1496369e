"""The port's CUDA kernels against their plain versions on the card.

These need a CUDA card (a CUDA kernel has no CPU mode) and skip where there
is none.  They import neither jax nor the JAX package, so they run on a
card machine without them:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.dequant import ops as dq
from repro_torch.kernels.dequant.ref import dequantize_blocked_reference
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.lstm import ops as lstm_ops
from repro_torch.kernels.lstm.ref import lstm_reference
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_recurrent_reference

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the reference tests' own
TABLE = [
    (2, 256, 256, 4, 2, 64, True, 0, 0),
    (1, 128, 128, 4, 4, 32, False, 0, 0),     # MHA, bidirectional
    (2, 256, 256, 8, 2, 64, True, 64, 0),     # GQA + sliding window
    (1, 100, 100, 2, 1, 48, True, 0, 0),      # non-multiple-of-block sizes
    (1, 64, 192, 2, 2, 32, True, 0, 0),       # Sq != Sk
    (1, 32, 128, 4, 2, 32, True, 0, 96),      # q_offset
    (1, 64, 32, 2, 1, 16, True, 0, -40),      # fully masked rows
    (2, 32, 32, 16, 8, 128, True, 0, 0),      # the demo's full-width prefill
    (1, 2048, 2048, 16, 8, 128, True, 0, 0),  # a long full-width prefill
    (1, 1000, 1000, 8, 2, 128, True, 256, 0), # ragged, long, windowed
    (1, 200, 700, 4, 2, 80, True, 0, 500),    # Sq != Sk, q_offset, many key tiles
    # GQA groups that do not divide a block's 64 rows: a position's heads
    # straddle two blocks
    (1, 100, 100, 6, 2, 128, True, 0, 0),     # group 3
    (2, 130, 130, 12, 4, 64, True, 48, 0),    # group 3, window
    (1, 70, 70, 7, 1, 64, True, 0, 0),        # group 7
    (1, 77, 150, 6, 2, 96, True, 0, 73),      # group 3, q_offset, head dim 96
    (1, 50, 50, 10, 2, 16, True, 20, 0),      # group 5, window, head dim 16
    (2, 64, 64, 4, 1, 112, False, 0, 0),      # head dim 112, bidirectional
    # the dense families' groups: 8 (yi-6b 32/4, qwen3-32b 64/8) and 6
    # (internlm2-20b 48/8, which straddles blocks), at their served prefill
    (2, 32, 32, 32, 4, 128, True, 0, 0),      # group 8, yi-6b
    (2, 32, 32, 64, 8, 128, True, 0, 0),      # group 8, qwen3-32b
    (2, 32, 32, 48, 8, 128, True, 0, 0),      # group 6, internlm2-20b
    (1, 100, 100, 48, 8, 128, True, 0, 0),    # group 6, ragged
    (1, 2048, 2048, 64, 8, 128, True, 0, 0),  # group 8, a long qwen3-32b prefill
    # the MoE, hybrid and frontend families' shapes
    (2, 32, 32, 64, 4, 128, True, 0, 0),      # group 16, qwen3-moe's prefill
    (1, 100, 100, 64, 4, 128, True, 0, 0),    # group 16, ragged
    (1, 8192, 8192, 32, 8, 128, True, 4096, 0),   # mixtral's window 4096 at S 8192
    (1, 4608, 4608, 32, 8, 128, True, 4096, 0),   # mixtral's prompt beyond its window
    (2, 32, 32, 32, 8, 128, True, 4096, 0),   # mixtral's prefill: the window lets all through
    (2, 512, 512, 16, 16, 80, False, 0, 0),   # hubert: head dim 80, bidirectional, MHA
    (1, 77, 77, 16, 16, 80, False, 0, 0),     # head dim 80, bidirectional, ragged
    (2, 608, 608, 32, 8, 128, True, 0, 0),    # llava: 576 patches + 32 tokens
    (2, 32, 32, 64, 8, 128, True, 0, 0),      # jamba's attention position
]
LSTM_TABLE = [
    (4, 32, 6, 20), (1, 16, 3, 7), (8, 64, 12, 20),   # tests/kernels/test_lstm.py
    (32, 64, 6, 20), (1, 64, 6, 20),                  # the quickstart: training, inference
    (3, 24, 4, 5), (2, 24, 5, 33),                    # h in {5, 33}
    (530, 8, 3, 7), (1101, 8, 6, 20),                 # many rows, ragged last block
    (4, 16, 6, 32), (4, 16, 6, 64), (4, 16, 6, 1),    # a full warp, two units a lane, H 1
    (1, 1, 6, 20),                                    # one row, one step
    (2, 8, 40, 100),                                  # weights through L1, I > 32
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,c", [(256, 1024), (300, 384), (151936, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_kernel_bit_exact(cuda, r, c, dtype):
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randint(-127, 128, (r, c), generator=g, device=cuda, dtype=torch.int8)
    s = torch.rand((r, c // 128), generator=g, device=cuda)
    before = dq.launches
    out = dq.dequantize(q, s, dtype=dtype)
    assert dq.launches == before + 1
    assert torch.equal(out, dequantize_blocked_reference(q, s, dtype=dtype))


@pytest.mark.cuda
def test_dequant_wrapper_rejects_unaligned_rows(cuda):
    q = torch.zeros((4, 256), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        dq.dequantize(q[:, 128:], torch.ones((4, 1), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window,q_offset", TABLE)
def test_flash_kernel_matches_plain_version(cuda, dtype, b, sq, sk, h, kvh, d, causal, window, q_offset):
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.launches
    out = fa.attention(q, k, v, **kw)
    assert fa.launches == before + 1
    ref = attention_reference(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_runs_on_the_current_stream(cuda, dtype):
    g = torch.Generator(cuda).manual_seed(3)
    q, k, v = (torch.randn((2, 96, 4, 64), generator=g, device=cuda).to(dtype) for _ in range(3))
    ref = attention_reference(q, k, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # the wrapper takes the stream from this private binding
        assert torch._C._cuda_getCurrentRawStream(q.get_device()) == side.cuda_stream
        out = fa.attention(q, k, v)
    side.synchronize()
    assert torch._C._cuda_getCurrentRawStream(q.get_device()) == torch.cuda.current_stream().cuda_stream
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype]


@pytest.mark.cuda
def test_flash_kernel_reads_strided_inputs(cuda):
    g = torch.Generator(cuda).manual_seed(2)
    qkv = torch.randn((2, 40, 8 + 4 + 4, 64), generator=g, device=cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    out = fa.attention(q, k, v, causal=True)
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert float((out - ref).abs().max()) <= TOL[torch.float32]


@pytest.mark.cuda
def test_flash_bf16_kernel_reads_strided_inputs(cuda):
    g = torch.Generator(cuda).manual_seed(2)
    qkv = torch.randn((2, 40, 8 + 4 + 4, 64), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    out = fa.attention(q, k, v, causal=True)
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref.float()).abs().max()) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_flash_bf16_wrapper_rejects_unaligned_views(cuda):
    flat = torch.zeros(1 + 8 * 2 * 64, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(1, 8, 2, 64)          # starts 2 bytes past a 16-byte boundary
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.attention(x, x, x)
    y = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):   # head stride 68
        fa.attention(y, y, y)
    assert fa.launches == before


@pytest.mark.cuda
def test_flash_wrapper_rejects_unsupported_head_dim(cuda):
    x = torch.zeros((1, 8, 2, 24), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.attention(x, x, x)


def _lstm_inputs(device, b, s, i, h, seed=0):
    """The reference test's input scales: x, w_ih, w_hh, b, h0, c0."""
    g = torch.Generator(device).manual_seed(seed)
    shapes = ((b, s, i), (i, 4 * h), (h, 4 * h), (4 * h,), (b, h), (b, h))
    scales = (1.0, 0.3, 0.3, 0.1, 0.5, 0.5)
    return [torch.randn(sh, generator=g, device=device) * sc for sh, sc in zip(shapes, scales)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,i,h", LSTM_TABLE)
def test_lstm_kernel_matches_plain_version_fp32(cuda, b, s, i, h, with_state):
    args = _lstm_inputs(cuda, b, s, i, h)
    if not with_state:
        args = args[:4]
    before = lstm_ops.launches
    hs, (hn, cn) = lstm_ops.lstm(*args)
    assert lstm_ops.launches == before + 1
    rhs, (rh, rc) = lstm_reference(*args)
    for out, ref in ((hs, rhs), (hn, rh), (cn, rc)):
        assert out.dtype == torch.float32 and out.shape == ref.shape
        assert float((out - ref).abs().max()) <= 1e-5    # the reference test's atol


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,i,h", [(32, 64, 6, 20), (1, 64, 6, 20), (2, 24, 5, 33)])
def test_lstm_kernel_bf16_within_half_an_ulp(cuda, b, s, i, h, with_state):
    """bf16 in and out, fp32 inside: the kernel rounds once, at the output,
    so it is within half a bf16 ulp (2**-8 relative) of the fp32 plain
    version on the same bf16-rounded inputs, plus the fp32 atol."""
    args = [t.to(torch.bfloat16) for t in _lstm_inputs(cuda, b, s, i, h, seed=1)]
    if not with_state:
        args = args[:4]
    hs, (hn, cn) = lstm_ops.lstm(*args)
    rhs, (rh, rc) = lstm_reference(*(t.float() for t in args))
    for out, ref in ((hs, rhs), (hn, rh), (cn, rc)):
        assert out.dtype == torch.bfloat16
        assert bool(((out.float() - ref).abs() <= 2.0 ** -8 * ref.abs() + 1e-5).all())


@pytest.mark.cuda
def test_lstm_kernel_reads_strided_x(cuda):
    x, w_ih, w_hh, b, _, _ = _lstm_inputs(cuda, 4, 64, 6, 20, seed=2)
    wide = torch.randn((64, 4, 10), device=cuda)
    wide[:, :, 2:8] = x.transpose(0, 1)
    xs = wide[:, :, 2:8].transpose(0, 1)             # (B, S, I), not contiguous
    assert not xs.is_contiguous()
    hs, _ = lstm_ops.lstm(xs, w_ih, w_hh, b)
    rhs, _ = lstm_reference(x, w_ih, w_hh, b)
    assert float((hs - rhs).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_gradient_equals_plain_autograd(cuda, with_state):
    args = _lstm_inputs(cuda, 32, 64, 6, 20, seed=3)
    if not with_state:
        args = args[:4]
    g = torch.Generator(cuda).manual_seed(4)
    ws = [torch.randn(sh, generator=g, device=cuda) for sh in ((32, 64, 20), (32, 20), (32, 20))]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in args]
        hs, (h, c) = fn(*leaves)
        loss = sum((w * t).sum() for w, t in zip(ws, (hs, h, c)))
        return torch.autograd.grad(loss, leaves)

    before = lstm_ops.launches
    ours = grads(lstm_ops.lstm)
    assert lstm_ops.launches == before + 1          # the forward only
    for a, b in zip(ours, grads(lstm_reference)):
        assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lstm", "ssd"])
def test_lstm_and_ssd_kernels_run_on_the_current_stream(cuda, kernel):
    """The wrappers take the stream from the private binding the flash
    wrapper uses: inside a side stream they launch there."""
    if kernel == "lstm":
        args = _lstm_inputs(cuda, 4, 32, 6, 20)[:4]
        run, plain = (lambda: lstm_ops.lstm_cuda(*args)[0]), (lambda: lstm_reference(*args)[0])
        tol = 1e-5
    else:
        args, _ = _ssd_inputs(cuda, 2, 256, 4, 16, 2, 32)
        run, plain = (lambda: ssd_ops.ssd_cuda(*args, chunk=64)[0]), (lambda: ssd_recurrent_reference(*args)[0])
        tol = SSD_Y
    ref = plain()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert torch._C._cuda_getCurrentRawStream(args[0].get_device()) == side.cuda_stream
        out = run()
    side.synchronize()
    assert float((out - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_lstm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, w_ih, w_hh, b, h0, c0 = _lstm_inputs(cuda, 2, 8, 6, 20)
    with pytest.raises(TypeError, match="one dtype"):
        lstm_ops.lstm(x, w_ih.to(torch.bfloat16), w_hh, b)
    with pytest.raises(ValueError, match="shape"):
        lstm_ops.lstm(x, w_ih[:5], w_hh, b)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_ops.lstm(x, w_ih, w_hh, b, h0.t().contiguous().t(), c0)
    with pytest.raises(ValueError, match="CUDA device"):
        lstm_ops.lstm(x, w_ih.cpu(), w_hh, b)


SSD_TABLE = [   # b, s, h, p, g, n, chunk, a = -1
    # tests/kernels/test_ssd.py's, with its a = -exp(normal)
    (2, 256, 4, 16, 2, 32, 64, False), (1, 128, 2, 8, 1, 16, 128, False),
    (2, 512, 8, 32, 2, 64, 128, False), (1, 256, 4, 64, 1, 128, 64, False),
    # the model's, with its init's a = -1: a = -exp(normal) at chunk 128 takes
    # the in-chunk cumsum into the thousands, where the chunked form's fp32
    # exp(cs_i - cs_j) can stray past 5e-4 from the recurrence (PERF.md)
    (2, 256, 32, 64, 1, 128, 128, True),                       # the served prefill
    (1, 256, 8, 64, 2, 128, 128, True),                        # two groups under eight heads
    (1, 2048, 32, 64, 1, 128, 128, True),                      # a long prefill: 16 chunks
    # the redesign's stages: many chunks and the state passed between them,
    # one chunk (no passing), and four groups
    (1, 1024, 4, 64, 1, 128, 64, False),
    (1, 128, 4, 64, 1, 128, 128, True),
    (1, 256, 8, 64, 4, 128, 128, True),
    # jamba's mixer: 256 heads, a prompt of 32 padded to one chunk of 128
    (2, 128, 256, 64, 1, 128, 128, True),
    (1, 256, 256, 64, 1, 128, 128, True),
]
SSD_Y, SSD_STATE = 5e-4, 5e-5      # tests/kernels/test_ssd.py:49-50


def _ssd_inputs(dev, b, s, h, p, g, n, seed=0, a_one=False):
    """The reference test's scales: x, dt, a, B, C, d and an initial state."""
    gen = torch.Generator(dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    a = -torch.exp(r(h))
    args = [r(b, s, h, p), torch.nn.functional.softplus(r(b, s, h)),
            -torch.ones_like(a) if a_one else a, r(b, s, g, n) * 0.5, r(b, s, g, n) * 0.5, r(h)]
    return args, r(b, h, p, n) * 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,a_one", SSD_TABLE)
def test_ssd_kernel_matches_plain_version_fp32(cuda, b, s, h, p, g, n, chunk, a_one, with_state):
    args, init = _ssd_inputs(cuda, b, s, h, p, g, n, a_one=a_one)
    init = init if with_state else None
    before = ssd_ops.launches
    y, st = ssd_ops.ssd(*args, chunk=chunk, init_state=init)
    assert ssd_ops.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    ry, rst = ssd_recurrent_reference(*args, init_state=init)
    assert float((y - ry).abs().max()) <= SSD_Y
    assert float((st - rst).abs().max()) <= SSD_STATE


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,a_one", SSD_TABLE)
def test_ssd_kernel_bf16_within_one_ulp(cuda, b, s, h, p, g, n, chunk, a_one):
    """bf16 x, B, C and d with fp32 dt and a: fp32 inside, one rounding of
    y at the output, so y is within one bf16 ulp (plus the fp32 tolerance)
    of the recurrent oracle in fp32 on the same bf16 values.  (Against the
    plain chunked version the margin is thinner: its own fp32 error and the
    kernel's, each within 5e-4 of the oracle, can add up past it.)"""
    args, _ = _ssd_inputs(cuda, b, s, h, p, g, n, seed=1, a_one=a_one)
    for i in (0, 3, 4, 5):
        args[i] = args[i].to(torch.bfloat16)
    y, st = ssd_ops.ssd(*args, chunk=chunk)
    ry, rst = ssd_recurrent_reference(*(t.float() for t in args))
    _, exp = torch.frexp(ry)
    ulp = torch.ldexp(torch.ones_like(ry), exp - 8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert bool(((y.float() - ry).abs() <= ulp + SSD_Y).all())
    assert float((st - rst).abs().max()) <= SSD_STATE


@pytest.mark.cuda
def test_ssd_kernel_hands_the_state_across_calls(cuda):
    args, _ = _ssd_inputs(cuda, 1, 256, 2, 8, 1, 16, seed=2)
    first = [t[:, :128] if t.dim() > 1 else t for t in args]
    second = [t[:, 128:] if t.dim() > 1 else t for t in args]
    y1, s1 = ssd_ops.ssd(*first, chunk=64)
    y2, s2 = ssd_ops.ssd(*second, chunk=64, init_state=s1)
    ry, rs = ssd_recurrent_reference(*args)
    assert float((torch.cat([y1, y2], 1) - ry).abs().max()) <= SSD_Y
    assert float((s2 - rs).abs().max()) <= SSD_STATE


@pytest.mark.cuda
def test_ssd_kernel_reads_the_models_strided_views(cuda):
    """x, B and C as the model hands them: reshaped slices of one
    (B, S, d_inner + 2·N) tensor, read through their strides."""
    b, s, h, p, n = 2, 256, 4, 16, 32
    gen = torch.Generator(cuda).manual_seed(3)
    xbc = torch.randn((b, s, h * p + 2 * n), generator=gen, device=cuda)
    x, bm, cm = torch.split(xbc, [h * p, n, n], dim=-1)
    args, _ = _ssd_inputs(cuda, b, s, h, p, 1, n, seed=4)
    args[0], args[3], args[4] = x.reshape(b, s, h, p), bm.reshape(b, s, 1, n), cm.reshape(b, s, 1, n)
    assert not args[0].is_contiguous()
    y, st = ssd_ops.ssd(*args, chunk=64)
    ry, rst = ssd_recurrent_reference(*args)
    assert float((y - ry).abs().max()) <= SSD_Y
    assert float((st - rst).abs().max()) <= SSD_STATE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_views_that_are_not_16_byte_aligned(cuda, dtype):
    """x, B and C whose rows do not start on 16 bytes go through plain
    loads instead of cp.async, with the same result."""
    b, s, h, p, n = 1, 256, 4, 16, 32
    gen = torch.Generator(cuda).manual_seed(5)
    xbc = torch.randn((b, s, 1 + h * p + 2 * n), generator=gen, device=cuda).to(dtype)
    x, bm, cm = torch.split(xbc[..., 1:], [h * p, n, n], dim=-1)
    args, init = _ssd_inputs(cuda, b, s, h, p, 1, n, seed=6)
    args[0], args[3], args[4] = x.reshape(b, s, h, p), bm.reshape(b, s, 1, n), cm.reshape(b, s, 1, n)
    args[5] = args[5].to(dtype)
    assert args[0].data_ptr() % 16
    y, st = ssd_ops.ssd(*args, chunk=64, init_state=init)
    ry, rst = ssd_recurrent_reference(*(t.float() for t in args), init_state=init)
    _, exp = torch.frexp(ry)
    ulp = torch.ldexp(torch.ones_like(ry), exp - 8) if dtype == torch.bfloat16 else 0.0
    assert bool(((y.float() - ry).abs() <= ulp + SSD_Y).all())
    assert float((st - rst).abs().max()) <= SSD_STATE


@pytest.mark.cuda
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args, init = _ssd_inputs(cuda, 1, 128, 2, 16, 1, 32)
    x, dt, a, bm, cm, d = args
    with pytest.raises(TypeError, match="one of fp32 or bf16"):
        ssd_ops.ssd(x.to(torch.bfloat16), dt, a, bm, cm, d)
    with pytest.raises(TypeError, match="dt and a in fp32"):
        ssd_ops.ssd(x, dt.to(torch.bfloat16), a, bm, cm, d)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.ssd(x[:, :96], dt[:, :96], a, bm[:, :96], cm[:, :96], d, chunk=64)
    with pytest.raises(ValueError, match="multiple of 32"):
        ssd_ops.ssd(x, dt, a, bm, cm, d, chunk=48)
    with pytest.raises(ValueError, match="power of two"):
        ssd_ops.ssd(x, dt, a, bm[..., :24], cm[..., :24], d)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_ops.ssd(x, dt, a, bm.cpu(), cm, d)
    with pytest.raises(ValueError, match="shape"):
        ssd_ops.ssd(x, dt, a, bm, cm, d, init_state=init[:, :1])
