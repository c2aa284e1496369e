"""The four hand-written kernels as ``torch.library`` ops for the ``meta``
device: the roofline counter's view of them (``launch/roofline.py``).

Each op has a ``Meta`` implementation only: it returns outputs of the
kernel's shapes and dtypes and computes nothing.  Each wrapper
(``kernels/*/ops.py``) sends its inputs here when, and only when, they lie
on ``meta``; a CUDA tensor still launches the kernel and a CPU tensor still
takes the plain version, with or without a counter around the call.

Beside each op, its FLOP and byte counts from ``costs/counts.py`` (the
conventions ``tests/test_roofline_conformance.py`` pins against the HLO
parser): attention 4·B·H·Sq·Sk_eff·D dot FLOPs and Q, K, V read once, O
written once; the SSD's output contraction 2·B·S·H·P·N; the LSTM's
8·B·S·H·(I+H) with its recurrent weights re-read every step; dequant no
FLOPs and int8 + scales in, the output written.  ``register_flop_formula``
gives the FLOPs to ``FlopCounterMode``; :data:`BYTES` gives the bytes to
the counter's dispatch mode.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.costs.counts import attention_counts, dequant_counts, lstm_counts, ssd_counts

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window, int q_offset) -> Tensor")
_LIB.define("ssd(Tensor x, Tensor dt, Tensor a, Tensor b_mat, Tensor c_mat, Tensor d_vec, int chunk, "
            "Tensor? init_state) -> (Tensor, Tensor)")
_LIB.define("lstm(Tensor x, Tensor w_ih, Tensor w_hh, Tensor b, Tensor? h0, Tensor? c0) -> (Tensor, Tensor, Tensor)")
_LIB.define("dequantize(Tensor q, Tensor scales, int group, ScalarType dtype) -> Tensor")


def _flash(q, k, v, causal, window, q_offset):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _ssd(x, dt, a, b_mat, c_mat, d_vec, chunk, init_state):
    b, _, h, p = x.shape
    return torch.empty_like(x), x.new_empty((b, h, p, b_mat.shape[-1]), dtype=torch.float32)


def _lstm(x, w_ih, w_hh, b, h0, c0):
    bsz, seq, _ = x.shape
    hidden = w_hh.shape[0]
    return x.new_empty((bsz, seq, hidden)), x.new_empty((bsz, hidden)), x.new_empty((bsz, hidden))


def _dequantize(q, scales, group, dtype):
    return q.new_empty(q.shape, dtype=dtype)


for _name, _fn in (("flash_attention", _flash), ("ssd", _ssd), ("lstm", _lstm), ("dequantize", _dequantize)):
    _LIB.impl(_name, _fn, "Meta")

flash_attention = torch.ops.repro_torch.flash_attention
ssd = torch.ops.repro_torch.ssd
lstm = torch.ops.repro_torch.lstm
dequantize = torch.ops.repro_torch.dequantize


def _attention(q, k, window):
    b, sq, h, d = q.shape
    return attention_counts(b, sq, k.shape[1], h, d, num_kv_heads=k.shape[2], window=window,
                            dtype_bytes=q.element_size())


def _ssd_counts(x, b_mat):
    b, s, h, p = x.shape
    return ssd_counts(b, s, h, p, b_mat.shape[-1], num_groups=b_mat.shape[2], dtype_bytes=x.element_size())


def _lstm_counts(x, w_hh):
    b, s, i = x.shape
    return lstm_counts(b, s, i, w_hh.shape[0], dtype_bytes=x.element_size())


def _dequant_bytes(q, scales, group, out_bytes):
    r, c = q.shape
    base = dequant_counts(r, c, group)           # a bf16 output
    return base.hbm_bytes + r * c * (out_bytes - 2)


@register_flop_formula(flash_attention)
def _flash_flops(q, k, v, causal, window, q_offset, *args, out_shape=None, **kwargs) -> int:
    b, sq, h, d = q
    return int(attention_counts(b, sq, k[1], h, d, num_kv_heads=k[2], window=window).flops)


@register_flop_formula(ssd)
def _ssd_flops(x, dt, a, b_mat, c_mat, d_vec, chunk, init_state, *args, out_shape=None, **kwargs) -> int:
    b, s, h, p = x
    return int(ssd_counts(b, s, h, p, b_mat[-1], num_groups=b_mat[2]).flops)


@register_flop_formula(lstm)
def _lstm_flops(x, w_ih, w_hh, b, h0, c0, *args, out_shape=None, **kwargs) -> int:
    bsz, seq, i = x
    return int(lstm_counts(bsz, seq, i, w_hh[0]).flops)


@register_flop_formula(dequantize)
def _dequant_flops(*args, out_shape=None, **kwargs) -> int:
    return 0


#: {op packet: (args, outputs) → HBM bytes} for the kernels' ops
BYTES = {
    flash_attention: lambda a, out: _attention(a[0], a[1], a[4]).hbm_bytes,
    ssd: lambda a, out: _ssd_counts(a[0], a[3]).hbm_bytes,
    lstm: lambda a, out: _lstm_counts(a[0], a[2]).hbm_bytes,
    dequantize: lambda a, out: _dequant_bytes(a[0], a[1], a[2], out.element_size()),
}
