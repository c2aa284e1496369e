"""Port's plain attention vs the JAX Pallas kernel (interpret mode) and the
JAX reference, over tests/kernels/test_flash_attention.py's shape table,
plus ring-buffer decode with ``kv_positions``.

Inputs are made with numpy from a seed and handed to both sides; bf16
inputs are rounded from the same fp32 values on both sides."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's numerics, emulated on the CPU
# ---------------------------------------------------------------------------
def emulate_bf16_kernel(q, k, v, *, causal, window, q_offset, bq=64, bk=64):
    """What ``csrc/flash_attention.cu``'s bf16 kernel computes, step by step:
    blocks of ``bq`` rows that pack the H/KVH query heads of one kv head
    (row r = position r // group, head r % group), the block's key tiles of
    ``bk`` from its first to its last unmasked tile, S in fp32 from bf16
    inputs, the online softmax in fp32 in base 2, P in two bf16 parts (its
    rounding and the rounding of the rest) for P·V, the denominator summed
    over the two parts, fp32 sums, and l == 0 giving 0.  The row blocks of
    one kv head go together: at each key tile, every block whose range
    holds it (each row's tiles in the same order as the kernel's).  q, k,
    v are bf16 tensors; returns bf16."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    rows = sq * group
    nb = -(-rows // bq)
    scale_log2 = d ** -0.5 * 1.4426950408889634
    qpos = torch.arange(nb * bq).reshape(nb, bq) // group + q_offset
    r0 = torch.arange(nb) * bq
    pos_first, pos_last = r0 // group, (torch.clamp(r0 + bq, max=rows) - 1) // group
    k_hi = torch.clamp(pos_last + q_offset + 1, max=sk) if causal else torch.full((nb,), sk)
    k_lo = torch.clamp(pos_first + q_offset - window + 1, min=0) if window else torch.zeros(nb, dtype=torch.long)
    t_lo = torch.div(k_lo, bk, rounding_mode="floor")
    t_end = torch.where(k_hi > k_lo, -torch.div(-k_hi, bk, rounding_mode="floor"), t_lo)
    out = torch.zeros((b, sq, h, d), dtype=torch.float32)
    pr = torch.arange(rows)
    for bi in range(b):
        for g in range(kvh):
            qp = q[bi, :, g * group:(g + 1) * group].float().reshape(rows, d)
            qb = F.pad(qp, (0, 0, 0, nb * bq - rows)).reshape(nb, bq, d)
            kg, vg = k[bi, :, g].float(), v[bi, :, g].float()
            m = torch.full((nb, bq), float("-inf"))
            l = torch.zeros((nb, bq))
            acc = torch.zeros((nb, bq, d))
            for t in range(int(t_lo.min()), int(t_end.max())):
                blk = torch.nonzero((t >= t_lo) & (t < t_end))[:, 0]     # the blocks that read tile t
                kj = torch.arange(t * bk, (t + 1) * bk)
                valid = kj < sk
                kt = torch.where(valid[:, None], kg[kj.clamp(max=sk - 1)], 0.0)
                vt = torch.where(valid[:, None], vg[kj.clamp(max=sk - 1)], 0.0)
                s = (qb[blk] @ kt.T) * scale_log2
                ok = valid.expand(len(blk), bq, bk)
                if causal:
                    ok = ok & (kj <= qpos[blk, :, None])
                if window:
                    ok = ok & (kj > qpos[blk, :, None] - window)
                s = torch.where(ok, s, float("-inf"))
                mb = m[blk]
                mx = torch.maximum(mb, s.max(dim=-1).values)
                mu = torch.where(mx == float("-inf"), 0.0, mx)
                alpha = torch.exp2(mb - mu)
                p = torch.exp2(s - mu[..., None])
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                l[blk] = l[blk] * alpha + (hi + lo).sum(dim=-1)
                acc[blk] = acc[blk] * alpha[..., None] + lo @ vt + hi @ vt
                m[blk] = mx
            o = (acc * torch.where(l == 0, 0.0, 1.0 / l)[..., None]).reshape(nb * bq, d)[:rows]
            out[bi, pr // group, g * group + pr % group] = o
    return out.to(torch.bfloat16)


EMULATED = [
    # (b, sq, sk, h, kvh, d, causal, window, q_offset)
    *[(*row, 0) for row in TABLE],
    (1, 32, 128, 4, 2, 32, True, 0, 96),      # q_offset
    (1, 64, 32, 2, 1, 16, True, 0, -40),      # fully masked rows
    (2, 32, 32, 16, 8, 128, True, 0, 0),      # the served prefill
    (1, 300, 300, 4, 2, 64, True, 96, 0),     # ragged, windowed, several tiles
    (1, 1000, 1000, 8, 2, 128, True, 256, 0), # ragged, long, windowed
    (1, 200, 700, 4, 2, 80, True, 0, 500),    # Sq != Sk, q_offset, many key tiles
    (2, 32, 32, 4, 2, 16, True, 0, 0),        # the reduced qwen3's prefill
    # GQA groups that do not divide a block's 64 rows: a position's heads
    # straddle two blocks
    (1, 100, 100, 6, 2, 128, True, 0, 0),     # group 3
    (2, 130, 130, 12, 4, 64, True, 48, 0),    # group 3, window
    (1, 70, 70, 7, 1, 64, True, 0, 0),        # group 7
    (1, 77, 150, 6, 2, 96, True, 0, 73),      # group 3, q_offset
    (1, 50, 50, 10, 2, 16, True, 20, 0),      # group 5, window
    (3, 33, 33, 9, 3, 32, True, 0, 0),        # group 3, three batch rows
    (1, 40, 100, 6, 2, 48, True, 30, 60),     # group 3, window and q_offset
    (1, 60, 20, 6, 2, 64, True, 0, -30),      # group 3, fully masked rows
    (2, 64, 64, 4, 1, 112, False, 0, 0),      # group 4, bidirectional
    # the dense families' groups: 8 (yi-6b, qwen3-32b) and 6 (internlm2-20b)
    (2, 32, 32, 32, 4, 128, True, 0, 0),      # group 8, yi-6b's prefill
    (2, 32, 32, 64, 8, 128, True, 0, 0),      # group 8, qwen3-32b's prefill
    (2, 32, 32, 48, 8, 128, True, 0, 0),      # group 6, internlm2-20b's prefill
    (1, 100, 100, 48, 8, 128, True, 0, 0),    # group 6, ragged
    (1, 2048, 2048, 64, 8, 128, True, 0, 0),  # group 8, a long qwen3-32b prefill
]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window,q_offset", EMULATED)
def test_bf16_kernel_numerics_match_jax_reference(jref, b, sq, sk, h, kvh, d, causal, window, q_offset):
    """P in two bf16 parts for P·V, fp32 everywhere else, stays within the
    reference tests' bf16 limit of the JAX package's plain attention."""
    _, ref = jref
    (jq, jk, jv), (q, k, v) = make_qkv(7, b, sq, sk, h, kvh, d, "bfloat16")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ours = emulate_bf16_kernel(q, k, v, **kw)
    theirs = ref.attention_reference(jq, jk, jv, **kw)
    assert bool(torch.isfinite(ours.float()).all())
    np.testing.assert_allclose(_np(ours), _np(theirs), atol=TOL["bfloat16"], rtol=0)
    if q_offset < 0:
        assert torch.all(ours[:, :-q_offset] == 0)

