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
def test_flash_kernel_reads_strided_inputs(cuda):
    g = torch.Generator(cuda).manual_seed(2)
    qkv = torch.randn((2, 40, 8 + 4 + 4, 64), generator=g, device=cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    out = fa.attention(q, k, v, causal=True)
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert float((out - ref).abs().max()) <= TOL[torch.float32]


@pytest.mark.cuda
def test_flash_wrapper_rejects_unsupported_head_dim(cuda):
    x = torch.zeros((1, 8, 2, 24), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.attention(x, x, x)
