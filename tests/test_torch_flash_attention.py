"""Port's plain attention vs the JAX Pallas kernel (interpret mode) and the
JAX reference, over tests/kernels/test_flash_attention.py's shape table,
plus ring-buffer decode with ``kv_positions``.

Inputs are made with numpy from a seed and handed to both sides; bf16
inputs are rounded from the same fp32 values on both sides."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_reference

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference tests' own
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TABLE = [
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 32, False, 0),     # MHA, bidirectional (hubert)
    (2, 256, 256, 8, 2, 64, True, 64),     # GQA + sliding window (mixtral)
    (1, 100, 100, 2, 1, 48, True, 0),      # non-multiple-of-block sizes
    (1, 64, 192, 2, 2, 32, True, 0),       # Sq != Sk
]


@pytest.fixture(scope="module")
def jref():
    from repro.kernels.flash_attention import kernel, ref

    return kernel, ref


def make_qkv(seed, b, sq, sk, h, kvh, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d))]
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a).astype(jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", TABLE)
def test_matches_pallas_kernel_and_reference(jref, dtype, b, sq, sk, h, kvh, d, causal, window):
    kernel, ref = jref
    (jq, jk, jv), (q, k, v) = make_qkv(0, b, sq, sk, h, kvh, d, dtype)
    ours = fa.attention(q, k, v, causal=causal, window=window)
    assert ours.dtype == q.dtype and ours.shape == q.shape
    pallas = kernel.flash_attention(jq, jk, jv, causal=causal, window=window, interpret=True)
    theirs = ref.attention_reference(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(ours), _np(pallas), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=TOL[dtype], rtol=0)


def test_q_offset_block_equals_slice_of_full(jref):
    kernel, _ = jref
    (jq, jk, jv), (q, k, v) = make_qkv(1, 1, 128, 128, 4, 2, 32, "float32")
    full = fa.attention(q, k, v, causal=True)
    tail = fa.attention(q[:, 96:], k, v, causal=True, q_offset=96)
    np.testing.assert_allclose(_np(tail), _np(full[:, 96:]), atol=3e-5, rtol=0)
    pallas = kernel.flash_attention(jq[:, 96:], jk, jv, causal=True, q_offset=96, interpret=True)
    np.testing.assert_allclose(_np(tail), _np(pallas), atol=2e-5, rtol=0)


def test_fully_masked_rows_are_zero(jref):
    _, ref = jref
    (jq, jk, jv), (q, k, v) = make_qkv(3, 1, 8, 8, 2, 2, 16, "float32")
    out = attention_reference(q, k, v, causal=True, kv_positions=torch.full((8,), -1, dtype=torch.int32))
    assert torch.all(out == 0)
    # a negative q_offset masks every key for the first rows, in both
    ours = fa.attention(q, k, v, causal=True, q_offset=-3)
    theirs = ref.attention_reference(jq, jk, jv, causal=True, q_offset=-3)
    assert torch.all(ours[:, :3] == 0)
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "positions,index,window",
    [
        ([0, 1, 2, 3, 4, -1, -1, -1], 4, 0),           # linear cache, part filled
        ([8, 9, 10, 11, 4, 5, 6, 7], 11, 8),           # ring buffer under SWA
        ([8, 9, 10, 3, 4, 5, 6, 7], 10, 6),            # window narrower than cache
        ([0, 1, 2, 3, 4, 5, 6, 9], 9, 0),              # overwritten last slot
    ],
)
def test_ring_buffer_decode_matches_reference(jref, dtype, positions, index, window):
    _, ref = jref
    (jq, jk, jv), (q, k, v) = make_qkv(4, 2, 1, 8, 4, 2, 32, dtype)
    pos = np.asarray(positions, np.int32)
    kw = dict(causal=True, window=window, q_offset=index)
    ours = attention_reference(q, k, v, kv_positions=torch.from_numpy(pos), **kw)
    theirs = ref.attention_reference(jq, jk, jv, kv_positions=jnp.asarray(pos), **kw)
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=TOL[dtype], rtol=0)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    _, (q, k, v) = make_qkv(5, 1, 16, 16, 2, 1, 16, "float32")
    before = fa.launches
    out = fa.attention(q, k, v)
    assert fa.launches == before
    torch.testing.assert_close(out, attention_reference(q, k, v), rtol=0, atol=0)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _, (q, k, v) = make_qkv(6, 1, 16, 16, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
