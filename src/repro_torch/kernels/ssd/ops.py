"""Public SSD op: the CUDA kernel for CUDA tensors, the plain chunked
version for CPU tensors (port of ``repro.kernels.ssd.ops``).

When grad is enabled and an input requires it, the op on the card is a
``torch.autograd.Function``: its forward launches the kernels, so y and the
final state are the kernels'; its backward recomputes the plain chunked
form (``ref.ssd_chunked``, what the JAX package differentiates off the
TPU) from the saved inputs under autograd and returns the gradients of x,
dt, a, B, C, D and ``init_state``, with no launch.

Decode is not this op's job: as in the reference, one token's state
update goes through the plain ``ssd_decode_step`` (exported here)."""
from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_decode_step

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64                # rows and columns of the kernels' product tiles
_PREP_WARPS = 4           # chunk cumsums one block of the first kernel runs
_PASS_ELEMENTS = 1024     # state elements one block of the third kernel passes
ALL_STAGES = 0b1111

#: calls that launched the kernels since the count was last set to 0 (one
#: call of ``ssd_cuda`` runs the four kernels of ``csrc/ssd.cu``)
launches = 0


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    d_vec: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space-duality scan.  x (B,S,H,P) → (y, final_state)."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, b_mat, c_mat, d_vec, chunk=chunk, init_state=init_state)
    return _card(x, dt, a, b_mat, c_mat, d_vec, chunk=chunk, init_state=init_state)


def _card(x, dt, a, b_mat, c_mat, d_vec, *, chunk, init_state):
    """The card's path: the autograd Function where a gradient is wanted,
    else the kernels alone."""
    inputs = (x, dt, a, b_mat, c_mat, d_vec, init_state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _SsdFunction.apply(*inputs, chunk)
    return ssd_cuda(x, dt, a, b_mat, c_mat, d_vec, chunk=chunk, init_state=init_state)


class _SsdFunction(torch.autograd.Function):
    """Forward: the kernels.  Backward: autograd of ``ssd_chunked``,
    recomputed from the saved inputs (no launch)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, d_vec, init_state, chunk):
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, d_vec, init_state)
        ctx.chunk = chunk
        return ssd_cuda(x, dt, a, b_mat, c_mat, d_vec, chunk=chunk, init_state=init_state)

    @staticmethod
    def backward(ctx, d_y, d_state):
        saved = ctx.saved_tensors
        wanted = [t is not None and need for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) if t is not None else None
                      for t, w in zip(saved, wanted)]
            y, state = ssd_chunked(*inputs[:6], chunk=ctx.chunk, init_state=inputs[6])
            found = iter(torch.autograd.grad(
                (y, state), [t for t, w in zip(inputs, wanted) if w], (d_y, d_state),
                allow_unused=True))
        return (*(next(found) if w else None for w in wanted), None)


@functools.lru_cache(maxsize=64)
def geometry(bsz: int, seq: int, heads: int, p: int, groups: int, n: int,
             chunk: int, bf16: bool = True) -> dict:
    """Scratch shapes and blocks of one call of ``csrc/ssd.cu``'s four
    kernels for bf16 (tensor cores) or fp32 inputs (its ``launch_all``
    computes the same grids); raises on a shape the kernels do not take.

    * ``scores`` (B, G, nc, Q, Q): one C·Bᵀ tile per (batch, group, chunk);
    * ``cs`` (B, H, S): the in-chunk cumsum of a·dt;
    * ``states`` (B, H, nc, P, N): each chunk's own state, then (fp32
      inputs) the state entering it;
    * ``entering`` (B, H, nc, 2, P, N), bf16 inputs only: the state
      entering each chunk as two bf16 parts, within 2^-16 of it.
    """
    if chunk < 32 or chunk > 256 or chunk % 32:
        raise ValueError(f"ssd kernel takes a chunk that is a multiple of 32 up to 256, got {chunk}")
    if seq % chunk:
        raise ValueError(f"sequence {seq} is not a multiple of the chunk {chunk}")
    if n not in (16, 32, 64, 128):
        raise ValueError(f"ssd kernel takes a state size N that is a power of two from 16 to 128, got {n}")
    if p < 8 or p % 8:
        raise ValueError(f"ssd kernel needs a head dim P that is a multiple of 8, got {p}")
    if groups < 1 or heads % groups:
        raise ValueError(f"heads {heads} are not a multiple of groups {groups}")
    nc = seq // chunk
    tiles = -(-chunk // _TILE)
    p_tiles, n_tiles = -(-p // _TILE), -(-n // _TILE)
    items = bsz * heads * nc
    pass_y = -(-p * n // _PASS_ELEMENTS)
    if items >= 2 ** 31 or pass_y > 65535:
        raise ValueError(f"batch {bsz}, heads {heads}, {nc} chunks or P·N {p * n} exceed the grid")
    return {
        "scores": (bsz, groups, nc, chunk, chunk),
        "cs": (bsz, heads, seq),
        "states": (bsz, heads, nc, p, n),
        "entering": (bsz, heads, nc, 2, p, n),
        "blocks": {
            "prep": bsz * groups * nc * tiles * (tiles + 1) // 2 + -(-items // _PREP_WARPS),
            "chunk_state": items * p_tiles * n_tiles,
            "state_pass": bsz * heads * pass_y,
            "output": items * -(-chunk // (2 * _TILE if bf16 else _TILE)) * p_tiles,
        },
    }


def ssd_cuda(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    d_vec: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ssd.cu`` (its four kernels, in order) on the current
    stream → (y in x's dtype, final state fp32); raises on any input the
    kernels do not take."""
    global launches
    call = prepare(x, dt, a, b_mat, c_mat, d_vec, chunk=chunk, init_state=init_state)
    launch_stages(call, ALL_STAGES)
    launches += 1
    return call["y"], call["state"]


def prepare(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    d_vec: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> dict:
    """Check the inputs and allocate the outputs and scratch of one call:
    → {"y", "state", "args"} for :func:`launch_stages`."""
    named = {"x": x, "dt": dt, "a": a, "b_mat": b_mat, "c_mat": c_mat, "d_vec": d_vec,
             "init_state": init_state}
    given = {k: t for k, t in named.items() if t is not None}
    if x.device.type != "cuda" or any(t.device != x.device for t in given.values()):
        raise ValueError(
            "ssd kernel needs every input on one CUDA device, got "
            + ", ".join(f"{k} on {t.device}" for k, t in given.items())
        )
    if x.dtype not in _DTYPES or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(
            f"ssd kernel takes x, b_mat, c_mat in one of fp32 or bf16, got "
            f"{x.dtype}, {b_mat.dtype}, {c_mat.dtype}"
        )
    if dt.dtype != torch.float32 or a.dtype != torch.float32 or d_vec.dtype not in _DTYPES:
        raise TypeError(
            f"ssd kernel takes dt and a in fp32 and d_vec in fp32 or bf16, got "
            f"{dt.dtype}, {a.dtype}, {d_vec.dtype}"
        )
    if init_state is not None and init_state.dtype != torch.float32:
        raise TypeError(f"init_state must be fp32, got {init_state.dtype}")
    if x.dim() != 4 or b_mat.dim() != 4:
        raise ValueError(f"need x (B,S,H,P) and b_mat (B,S,G,N), got {tuple(x.shape)}, {tuple(b_mat.shape)}")
    bsz, seq, heads, p = x.shape
    groups, n = b_mat.shape[2], b_mat.shape[3]
    want = {"dt": (bsz, seq, heads), "a": (heads,), "b_mat": (bsz, seq, groups, n),
            "c_mat": (bsz, seq, groups, n), "d_vec": (heads,),
            "init_state": (bsz, heads, p, n)}
    for k, shape in want.items():
        t = given.get(k)
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{k} has shape {tuple(t.shape)}, want {shape}")
    if x.stride(3) != 1 or b_mat.stride(3) != 1 or c_mat.stride(3) != 1 or dt.stride(2) != 1:
        raise ValueError("ssd kernel needs the last dim of x, b_mat, c_mat and dt contiguous")
    if not a.is_contiguous() or not d_vec.is_contiguous() or (
            init_state is not None and not init_state.is_contiguous()):
        raise ValueError("ssd kernel needs a, d_vec and init_state contiguous")
    bf16 = x.dtype == torch.bfloat16
    geo = geometry(bsz, seq, heads, p, groups, n, chunk, bf16)
    dev = x.device
    y = torch.empty((bsz, seq, heads, p), dtype=x.dtype, device=dev)
    state = torch.empty((bsz, heads, p, n), dtype=torch.float32, device=dev)
    # the scratch in one allocation (each part a multiple of 16 bytes):
    # scores, cs and states in fp32, and for bf16 the entering state's parts
    sizes = [math.prod(geo[k]) * 4 for k in ("scores", "cs", "states")]
    if bf16:
        sizes.append(math.prod(geo["entering"]) * 2)
    scratch = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    parts = list(itertools.accumulate(sizes[:-1], initial=scratch.data_ptr()))
    if not bf16:
        parts.append(None)
    strides = [*x.stride()[:3], *dt.stride(), *b_mat.stride()[:3], *c_mat.stride()[:3]]
    # 16-byte cp.async copies need every row of x, B and C to start on 16 bytes
    per16 = 16 // x.element_size()
    vec = all(t.data_ptr() % 16 == 0 for t in (x, b_mat, c_mat)) and all(
        st % per16 == 0 for st in strides[:3] + strides[6:])
    args = (
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        d_vec.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), *parts, _DTYPES[x.dtype], int(d_vec.dtype == torch.bfloat16),
        bsz, seq, heads, p, groups, n, chunk, int(vec),
    )
    return {"y": y, "state": state, "args": args, "scratch": scratch,
            "strides": (ctypes.c_longlong * 12)(*strides), "device": x.get_device()}


def launch_stages(call: dict, stages: int) -> None:
    """Launch the kernels of ``stages`` (bit k: kernel k + 1 of
    ``csrc/ssd.cu``) for a prepared call.  ``ssd_cuda`` launches all four;
    one stage alone is for timing it, on the scratch a whole call filled."""
    # the current stream's handle, without building a Stream object (the
    # private binding the flash wrapper uses; card tests hold it equal)
    stream = torch._C._cuda_getCurrentRawStream(call["device"])
    err = _lib.library().repro_ssd(*call["args"], stages, call["strides"], stream)
    _lib.check(err, "ssd")


__all__ = ["ssd", "ssd_cuda", "ssd_decode_step"]
