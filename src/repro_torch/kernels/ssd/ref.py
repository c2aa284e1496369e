"""Plain PyTorch Mamba-2 SSD (state-space duality) — port of
``repro.kernels.ssd.ref``.

Two implementations of the same function:

* :func:`ssd_recurrent_reference` — the O(S) sequential recurrence; the
  ground-truth oracle (slow, exact).
* :func:`ssd_chunked` — the chunked SSD form (dense intra-chunk products +
  an inter-chunk recurrence over S/Q steps).  It is what the JAX package
  runs off the TPU, and the plain version of ``csrc/ssd.cu``.

Semantics (per head h, state dim n, head dim p):

    a_t = exp(A_h · dt_t)                (scalar decay, A_h < 0)
    h_t = a_t · h_{t−1} + dt_t · B_t ⊗ x_t        (n × p state)
    y_t = C_t · h_t + D_h · x_t

B_t, C_t are shared across heads within a group (g groups, h heads,
heads-per-group = h/g).  Every sum is in fp32 (in float64 in the recurrent
oracle when x is float64); y comes out in x's dtype and the final state in
fp32.
"""
from __future__ import annotations

import torch


def _expand_groups(bc: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, G, N) → (B, S, H, N)."""
    g = bc.shape[2]
    if g == num_heads:
        return bc
    return torch.repeat_interleave(bc, num_heads // g, dim=2)


def _init_state(x: torch.Tensor, n: int, init_state: torch.Tensor | None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    bsz, _, h, p = x.shape
    if init_state is None:
        return torch.zeros((bsz, h, p, n), dtype=dtype, device=x.device)
    return init_state.to(dtype)


def ssd_recurrent_reference(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)      (already softplus'd, > 0)
    a: torch.Tensor,      # (H,)           negative decay rates
    b_mat: torch.Tensor,  # (B, S, G, N)
    c_mat: torch.Tensor,  # (B, S, G, N)
    d_vec: torch.Tensor,  # (H,)
    init_state: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle, in fp32 (float64 when x is float64).  Returns
    (y (B,S,H,P), final_state (B,H,P,N))."""
    h = x.shape[2]
    ct = torch.promote_types(x.dtype, torch.float32)
    bm = _expand_groups(b_mat, h).to(ct)
    cm = _expand_groups(c_mat, h).to(ct)
    xf, dtf, af = x.to(ct), dt.to(ct), a.to(ct)
    state = _init_state(x, b_mat.shape[-1], init_state, ct)
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(af[None, :] * dtf[:, t])                       # (B,H)
        upd = torch.einsum("bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None], bm[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cm[:, t]))
    y = torch.stack(ys, dim=1) + xf * d_vec.to(ct)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(
    x: torch.Tensor,      # (B, H, P)   one token
    dt: torch.Tensor,     # (B, H)
    a: torch.Tensor,      # (H,)
    b_t: torch.Tensor,    # (B, G, N)
    c_t: torch.Tensor,    # (B, G, N)
    d_vec: torch.Tensor,  # (H,)
    state: torch.Tensor,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(1) single-token state update (serving decode path)."""
    h = x.shape[1]
    bm = _expand_groups(b_t[:, None], h)[:, 0].float()
    cm = _expand_groups(c_t[:, None], h)[:, 0].float()
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(a.float()[None, :] * dtf)
    upd = torch.einsum("bhp,bhn->bhpn", xf * dtf[..., None], bm)
    new_state = state.float() * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, cm)
    y = y + xf * d_vec.float()[None, :, None]
    return y.to(x.dtype), new_state


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = Σ_{j<t≤i} log_a[..., t]
    (−inf for j > i).  log_a: (..., Q) → (..., Q, Q)."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # Σ_{j<t≤i}
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)
    a: torch.Tensor,      # (H,)
    b_mat: torch.Tensor,  # (B, S, G, N)
    c_mat: torch.Tensor,  # (B, S, G, N)
    d_vec: torch.Tensor,  # (H,)
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: dense intra-chunk products + an inter-chunk recurrence
    of length S/chunk.  Matches the recurrent oracle to fp32 tolerance.
    Returns (y, final_state)."""
    bsz, s, h, p = x.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc, q = s // chunk, chunk
    n = b_mat.shape[-1]

    bm = _expand_groups(b_mat, h).float()
    cm = _expand_groups(c_mat, h).float()
    xf = x.float() * dt.float()[..., None]                        # dt-scaled x
    la = a.float()[None, None, :] * dt.float()                    # (B,S,H) log-decay

    # chunked views: (B, NC, Q, ...)
    xc = xf.reshape(bsz, nc, q, h, p)
    bc = bm.reshape(bsz, nc, q, h, n)
    cc = cm.reshape(bsz, nc, q, h, n)
    lac = la.reshape(bsz, nc, q, h)

    cs = torch.cumsum(lac, dim=2)                    # (B,NC,Q,H) within-chunk
    total = cs[:, :, -1:, :]                         # (B,NC,1,H)

    # 1) intra-chunk (diagonal blocks): Y_ij = C_i·B_j · exp(cs_i − cs_j) · x_j
    lmat = _segsum(lac.movedim(3, 2))                # (B,NC,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * torch.exp(lmat), xc)

    # 2) chunk summaries: state contributed by each chunk
    decay_to_end = torch.exp(total - cs)             # (B,NC,Q,H)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bc, decay_to_end, xc)

    # 3) inter-chunk recurrence (length NC), keeping the state entering
    #    each chunk
    chunk_decay = torch.exp(total[:, :, 0, :])       # (B,NC,H)
    carry = _init_state(x, n, init_state)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)          # (B,NC,H,P,N)

    # 4) inter-chunk output: y_off_i = C_i · (exp(cs_i) · H_entering)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cc, entering, torch.exp(cs))

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    y = y + x.float() * d_vec.float()[None, None, :, None]
    return y.to(x.dtype), carry
