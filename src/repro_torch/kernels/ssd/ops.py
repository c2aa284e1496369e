"""Public SSD op: the CUDA kernel for CUDA tensors, the plain chunked
version for CPU tensors (port of ``repro.kernels.ssd.ops``).

Decode is not this op's job: as in the reference, one token's state
update goes through the plain ``ssd_decode_step`` (exported here)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_decode_step

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448      # bytes of shared memory one block may use on Hopper
_SMS = 132                # the H100's SMs: P is split until the grid covers them

#: kernel launches since the count was last set to 0
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
    return ssd_cuda(x, dt, a, b_mat, c_mat, d_vec, chunk=chunk, init_state=init_state)


def p_slice(bsz: int, heads: int, p: int) -> int:
    """Columns of P one block takes: the largest power of two up to 64 that
    divides P, halved (down to 16) while twice the blocks still fit in one
    wave over the card's SMs (one block a SM: its shared memory)."""
    ps = 64
    while ps > 8 and p % ps:
        ps //= 2
    if p % ps:
        raise ValueError(f"ssd kernel needs a head dim P that is a multiple of 8, got {p}")
    while ps > 16 and 2 * bsz * heads * (p // ps) <= _SMS:
        ps //= 2
    return ps


def smem_bytes(chunk: int, n: int, ps: int) -> int:
    """Shared memory of one block (the layout of ``csrc/ssd.cu``)."""
    rt = 32
    return 4 * (chunk * (n + 1) + rt * (n + 1) + ps * (n + 1) + chunk * ps
                + rt * (chunk + 1) + chunk)


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
    """Launch ``csrc/ssd.cu`` on the current stream → (y in x's dtype,
    final state fp32); raises on any input the kernel does not take."""
    global launches
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
    if groups == 0 or heads % groups:
        raise ValueError(f"heads {heads} are not a multiple of groups {groups}")
    if chunk < 32 or chunk > 256 or chunk % 32:
        raise ValueError(f"ssd kernel takes a chunk that is a multiple of 32 up to 256, got {chunk}")
    if seq % chunk:
        raise ValueError(f"sequence {seq} is not a multiple of the chunk {chunk}")
    if n not in (16, 32, 64, 128):
        raise ValueError(f"ssd kernel takes a state size N that is a power of two from 16 to 128, got {n}")
    if bsz > 65535 or heads > 65535:
        raise ValueError(f"batch {bsz} or heads {heads} exceed the grid's 65535")
    if x.stride(3) != 1 or b_mat.stride(3) != 1 or c_mat.stride(3) != 1 or dt.stride(2) != 1:
        raise ValueError("ssd kernel needs the last dim of x, b_mat, c_mat and dt contiguous")
    if not a.is_contiguous() or not d_vec.is_contiguous() or (
            init_state is not None and not init_state.is_contiguous()):
        raise ValueError("ssd kernel needs a, d_vec and init_state contiguous")
    ps = p_slice(bsz, heads, p)
    if smem_bytes(chunk, n, ps) > _SMEM_LIMIT:
        raise ValueError(f"chunk {chunk}, N {n}: {smem_bytes(chunk, n, ps)} bytes of shared "
                         f"memory exceed the {_SMEM_LIMIT} a block may use")
    y = torch.empty((bsz, seq, heads, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, heads, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 12)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        b_mat.stride(0), b_mat.stride(1), b_mat.stride(2),
        c_mat.stride(0), c_mat.stride(1), c_mat.stride(2),
    )
    lib = _lib.library()
    err = lib.repro_ssd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        d_vec.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype], int(d_vec.dtype == torch.bfloat16),
        bsz, seq, heads, p, groups, n, chunk, ps, strides,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _lib.check(err, "ssd")
    launches += 1
    return y, state


__all__ = ["ssd", "ssd_cuda", "ssd_decode_step"]
