"""Plain PyTorch LSTM cell and sequence (port of ``repro.kernels.lstm.ref``;
the paper's accelerator [13]).

Gate order: i, f, g, o  (input, forget, cell, output).  The weights hold
the gates as four unpadded H-wide column blocks ``[i|f|g|o]``.
"""
from __future__ import annotations

import torch


def lstm_cell_reference(
    x_t: torch.Tensor,     # (B, I)
    h: torch.Tensor,       # (B, H)
    c: torch.Tensor,       # (B, H)
    w_ih: torch.Tensor,    # (I, 4H)
    w_hh: torch.Tensor,    # (H, 4H)
    b: torch.Tensor,       # (4H,)
) -> tuple[torch.Tensor, torch.Tensor]:
    gates = x_t @ w_ih + h @ w_hh + b[None, :]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def lstm_reference(
    x: torch.Tensor,       # (B, S, I)
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    b: torch.Tensor,
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence LSTM → (hs (B,S,H), (h_final, c_final)): a Python
    loop over time, in ``x.dtype`` like the reference."""
    bsz, s, _ = x.shape
    hdim = w_hh.shape[0]
    h = torch.zeros((bsz, hdim), dtype=x.dtype, device=x.device) if h0 is None else h0
    c = torch.zeros((bsz, hdim), dtype=x.dtype, device=x.device) if c0 is None else c0
    hs = []
    for t in range(s):
        h, c = lstm_cell_reference(x[:, t], h, c, w_ih, w_hh, b)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)
