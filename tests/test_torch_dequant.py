"""Port's blocked int8 quantize/dequantize vs the JAX reference: bit-equal.

Inputs are made with numpy from a seed and handed to both sides."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro_torch.kernels.dequant import ops as dq
from repro_torch.kernels.dequant.ref import (
    dequantize_blocked_reference,
    quantize_blocked,
)

# tests/kernels/test_dequant.py's shapes
SHAPES = [(256, 1024, 128), (128, 512, 128), (64, 256, 64)]
DTYPES = [("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(scope="module")
def jref():
    from repro.kernels.dequant import kernel, ref

    return kernel, ref


def _bits(x) -> np.ndarray:
    """Raw bits of an fp32 or bf16 JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.cpu().view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _weights(r, c, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((r, c)) * scale).astype(np.float32)


@pytest.mark.parametrize("r,c,group", SHAPES)
def test_quantize_bit_equal(jref, r, c, group):
    _, ref = jref
    w = _weights(r, c)
    jq, js = ref.quantize_blocked(jnp.asarray(w), group=group)
    tq, ts = quantize_blocked(torch.from_numpy(w), group=group)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(_bits(js), _bits(ts))


@pytest.mark.parametrize("r,c,group", SHAPES)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_dequant_bit_equal_to_reference_and_pallas_kernel(jref, r, c, group, name, jdt, tdt):
    kernel, ref = jref
    jq, js = ref.quantize_blocked(jnp.asarray(_weights(r, c, seed=1)), group=group)
    q, s = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))
    ours = dequantize_blocked_reference(q, s, group=group, dtype=tdt)
    assert ours.dtype == tdt
    theirs = ref.dequantize_blocked_reference(jq, js, group=group, dtype=jdt)
    pallas = kernel.dequantize_blocked(
        jq, js, group=group, dtype=jdt, interpret=True, block_r=64, block_c=max(group, 128)
    )
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))
    np.testing.assert_array_equal(_bits(ours), _bits(pallas))
    # the public op takes the plain version for CPU tensors, without a launch
    before = dq.launches
    np.testing.assert_array_equal(_bits(dq.dequantize(q, s, group=group, dtype=tdt)), _bits(ours))
    assert dq.launches == before


@pytest.mark.parametrize("r,c", [(300, 384), (1187, 256), (5, 128)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_ragged_shapes_against_jax_reference(jref, r, c, name, jdt, tdt):
    """Row counts that are no multiple of the TPU kernel's 256-row block
    (its assert rejects them; the port's kernel masks them)."""
    _, ref = jref
    w = _weights(r, c, seed=2, scale=3.0)
    jq, js = ref.quantize_blocked(jnp.asarray(w))
    tq, ts = quantize_blocked(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(
        _bits(ref.dequantize_blocked_reference(jq, js, dtype=jdt)),
        _bits(dq.dequantize(tq, ts, dtype=tdt)),
    )


def test_quantize_preserves_zero_and_extremes():
    w = torch.tensor([[0.0] * 64 + [1.0] * 32 + [-1.0] * 32])
    q, s = quantize_blocked(w, group=128)
    back = dequantize_blocked_reference(q, s, group=128, dtype=torch.float32)
    assert torch.all(back[0, :64] == 0)
    torch.testing.assert_close(back[0, 64:], w[0, 64:], rtol=1e-2, atol=0)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((4, 128), dtype=torch.int8)
    s = torch.ones((4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        dq.dequantize_cuda(q, s)
    with pytest.raises(ValueError):
        quantize_blocked(torch.zeros((4, 100)))
