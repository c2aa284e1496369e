#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. preflight — torch/CUDA versions and the card's name and power limit; no
   card, no run;
2. build — compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at the reference tests' shapes, with times
   (dequant; flash attention: bf16 through the tensor-core (wgmma) kernel
   and fp32 through the CUDA-core kernel, timed at the served prefill, at
   the reduced qwen3's prefill and at S 2048 beside SDPA);
4. lstm — the LSTM kernel (one warp a batch row, the weights in registers
   where they fit, no block barrier in the step loop) against its plain
   version (fp32 and bf16, with and without an initial state, H from 1 to
   100 and the reference test's shapes) and its gradient against plain
   autograd; then the quickstart (``repro_torch.examples.quickstart``):
   Experiments 1–3 against the reference's lines, and the paper's LSTM
   trained for 300 steps and timed through the kernel, with the launch
   count checked and the first losses held against a plain-trained run;
   then the kernel (device time, call time and µs a step), its plain
   version and cuDNN's ``nn.LSTM`` timed at batch 32 and 1;
5. serving — full-width qwen3-1.7b under the duty-cycle controller with the
   On-Off and Idle-Waiting strategies, through ``launch.serve.build_demo``;
   the launch counts show that bring-up went through the dequant kernel and
   prefill through the flash-attention kernel; the output is checked
   against the plain path;
6. ssd — the SSD kernel (four launches a call, chunks in parallel: the
   score tile C·Bᵀ once per group on the tensor cores, with the in-chunk
   cumsums; each chunk's own state; the states passed between chunks; the
   output; for bf16 the chunk states and the output on warpgroup MMAs with
   their fp32 operand in bf16 parts) against the plain recurrent version
   at the reference test's shapes (with and without an initial state),
   across two calls, with many chunks, at the served prefill's shape and
   with two and four groups, in fp32 and bf16; timed at the served shape
   and at a 2048-step prefill, with the device time split over the four
   kernels;
7. mamba2 serving — full-width mamba2-370m through ``build_demo`` under
   On-Off and Idle-Waiting (prompt 200: two chunks, the second ragged);
   the launch counts show 9 dequant launches per bring-up and 48 SSD
   launches per prefill; the fp32 logits of the 48 layers are checked
   against the plain path, and bf16 layer by layer;
8. the ``kernels`` JSON line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"

# H100 SXM published peaks (dense): HBM bytes/s, and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

ARCH = "qwen3-1.7b"
REQUESTS = 3
PERIOD_S = 0.5
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference tests' own
LSTM_ATOL = 1e-5                            # tests/kernels/test_lstm.py
SSD_TOL = {"y": 5e-4, "state": 5e-5}        # tests/kernels/test_ssd.py:49-50
SSD_STAGES = ("scores and cumsums", "chunk states", "state passing", "output")   # csrc/ssd.cu
MAMBA = "mamba2-370m"
MAMBA_PROMPT, MAMBA_MAX_LEN = 200, 208      # two chunks of 128, the second ragged
CKPT_DIR_MAMBA = ROOT / "build" / "chip_smoke_ckpt_mamba2"
TRAIN_STEPS = 300                           # examples/quickstart.py
# Experiments 1-3 as the reference quickstart prints them
EXPERIMENT_LINES = [
    "== Experiment 1: configuration-phase parameter optimization ==",
    "  worst (single SPI, 3 MHz, raw):     475.56 mJ",
    "  best  ConfigParams(buswidth=4, clock_mhz=66, compression=True):    11.85 mJ",
    "  reduction: 40.12×   (paper: 40.13×)",
    "",
    "== Experiment 2: Idle-Waiting vs On-Off ==",
    "  cross point: 89.22 ms   (paper: 89.21 ms)",
    "  T_req= 40.0 ms: IW   771,805 items vs OnOff   346,073 → idle-waiting",
    "  T_req= 89.0 ms: IW   346,918 items vs OnOff   346,073 → idle-waiting",
    "  T_req=120.0 ms: IW   257,304 items vs OnOff   346,073 → on-off",
    "",
    "== Experiment 3: idle power-saving methods ==",
    "  baseline    :   771,805 items,   8.58 h  (2.23× vs On-Off)",
    "  method 1    : 3,020,121 items,  33.56 h  (8.73× vs On-Off)",
    "  method 1+2  : 4,295,042 items,  47.72 h  (12.41× vs On-Off)",
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, target_ms: float = 40.0) -> float:
    """Mean device time of ``fn`` over a run of launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = max(3, min(200, int(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(n_bytes: float, n_ops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def dequant_phase(card: str) -> dict:
    import torch

    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.dequant.ref import dequantize_blocked_reference

    gen = torch.Generator("cuda").manual_seed(0)

    def make(r, c, group=128):
        q = torch.randint(-127, 128, (r, c), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((r, c // group), generator=gen, device="cuda") * 1e-2 + 1e-4
        return q, s

    for (r, c) in [(256, 1024), (151936, 2048), (57344, 6144)]:
        q, s = make(r, c)
        for dtype in (torch.bfloat16, torch.float32):
            out = dq.dequantize(q, s, dtype=dtype)
            ref = dequantize_blocked_reference(q, s, dtype=dtype)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            check(torch.equal(out, ref), f"dequant ({r},{c}) {dtype} is not bit-exact")
            print(f"  dequant ({r},{c}) {str(dtype)[6:]}: bit-exact, max_abs_err {err}")
        del q, s, out, ref

    rows = {arch: _dequant_bring_up(arch, make, card) for arch in (ARCH, MAMBA)}
    r = rows[ARCH]
    return {
        "name": "dequantize_blocked",
        "route": "cuda",
        "source": "src/repro_torch/csrc/dequant.cu",
        "replaces": "src/repro/kernels/dequant/kernel.py:25",
        "launches": 0,
        "max_abs_err": max(row["max_abs_err"] for row in rows.values()),
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
        "per": f"{ARCH} bring-up ({r['leaves']} launches, one per quantized leaf, bf16 out)",
        "per_bring_up": rows,
    }


def _dequant_bring_up(arch: str, make, card: str) -> dict:
    """One bring-up's launches: every leaf the checkpoint of ``arch``
    quantizes, in bf16, each bit-exact and timed."""
    import torch

    from repro_torch.checkpoint.serializer import _should_quantize, flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.dequant.ref import dequantize_blocked_reference
    from repro_torch.models import model_zoo as zoo

    shapes = []
    for path, meta in flatten(zoo.param_shapes(get_config(arch))):
        if _should_quantize(meta):
            shapes.append((path, meta.numel() // meta.shape[-1], meta.shape[-1]))
    ms = plain = n_bytes = n_ops = max_err = 0.0
    for path, r, c in shapes:
        q, s = make(r, c)
        out = dq.dequantize(q, s)
        ref = dequantize_blocked_reference(q, s)
        max_err = max(max_err, float((out.float() - ref.float()).abs().max()))
        check(torch.equal(out, ref), f"dequant {arch} {path} ({r},{c}) is not bit-exact")
        k_ms = time_ms(lambda: dq.dequantize(q, s))
        p_ms = time_ms(lambda: dequantize_blocked_reference(q, s))
        ms += k_ms
        plain += p_ms
        n_bytes += q.numel() + s.numel() * 4 + out.numel() * 2
        n_ops += q.numel()
        print(f"  dequant {arch} {path} ({r},{c}) bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")
        del q, s, out, ref
    b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
    print(
        f"dequantize_blocked per {arch} bring-up ({len(shapes)} launches): max_abs_err {max_err} "
        f"(bit-exact), kernel {ms:.4f} ms, plain {plain:.4f} ms, library n/a, "
        f"bound {b_ms:.4f} ms by {b_by} ({n_bytes / 1e9:.3f} GB) [{card}]"
    )
    return dict(leaves=len(shapes), max_abs_err=max_err, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by)


def _attention_pairs(sq, sk, causal, window, q_offset) -> int:
    """(query, key) pairs the mask lets through, for one batch row and head."""
    import torch

    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(sk)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return int(ok.sum())


def flash_phase(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_reference

    gen = torch.Generator("cuda").manual_seed(0)

    def make(b, sq, sk, h, kvh, d, dtype):
        shape_q, shape_kv = (b, sq, h, d), (b, sk, kvh, d)
        return tuple(
            torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in (shape_q, shape_kv, shape_kv)
        )

    # (b, sq, sk, h, kvh, d, causal, window, q_offset, label)
    cases = [
        (2, 256, 256, 4, 2, 64, True, 0, 0, "test table"),
        (1, 128, 128, 4, 4, 32, False, 0, 0, "test table: MHA, bidirectional"),
        (2, 256, 256, 8, 2, 64, True, 64, 0, "test table: GQA + window"),
        (1, 100, 100, 2, 1, 48, True, 0, 0, "test table: non-block sizes"),
        (1, 64, 192, 2, 2, 32, True, 0, 0, "test table: Sq != Sk"),
        (1, 32, 128, 4, 2, 32, True, 0, 96, "q_offset"),
        (1, 64, 32, 2, 1, 16, True, 0, -40, "fully masked rows"),
        (1, 1000, 1000, 8, 2, 128, True, 256, 0, "ragged long window"),
        (1, 200, 700, 4, 2, 80, True, 0, 500, "Sq != Sk, q_offset, many key tiles"),
        (1, 100, 100, 6, 2, 128, True, 0, 0, "GQA group 3 (heads straddle blocks)"),
        (2, 130, 130, 12, 4, 64, True, 48, 0, "GQA group 3 + window"),
        (1, 77, 150, 6, 2, 96, True, 0, 73, "GQA group 3, q_offset, head dim 96"),
        (2, 32, 32, 16, 8, 128, True, 0, 0, "demo prefill (main path)"),
        (2, 32, 32, 4, 2, 16, True, 0, 0, "reduced qwen3 prefill"),
        (1, 2048, 2048, 16, 8, 128, True, 0, 0, "long prefill"),
    ]
    entry, timed = None, {}
    for (b, sq, sk, h, kvh, d, causal, window, q_offset, label) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            bf16 = dtype == torch.bfloat16
            q, k, v = make(b, sq, sk, h, kvh, d, dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            ref = attention_reference(q, k, v, **kw)
            out = fa.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            check(bool(torch.isfinite(out).all()), f"flash {label} {dname}: non-finite output")
            check(err <= TOL[dname], f"flash {label} {dname}: max err {err:.3g} > {TOL[dname]}")
            if label == "fully masked rows":
                check(bool((out[:, :40] == 0).all()), "fully masked rows are not 0")
            kernel = "wgmma" if bf16 else "CUDA-core fp32"
            line = f"  flash {label} {(b, sq, sk, h, kvh, d)} {dname}: max_abs_err {err:.3g} ({kernel})"
            if "prefill" in label:
                k_ms = time_ms(lambda: fa.attention(q, k, v, **kw))
                p_ms = time_ms(lambda: attention_reference(q, k, v, **kw))
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

                l_ms = time_ms(sdpa)
                pairs = _attention_pairs(sq, sk, causal, window, q_offset)
                n_ops = 4.0 * b * h * d * pairs
                n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
                b_ms, b_by = bound_ms(n_bytes, n_ops, dname)
                line += (
                    f"; {kernel} kernel {k_ms:.4f} ms a call, plain {p_ms:.4f} ms, library (sdpa) "
                    f"{l_ms:.4f} ms a call, bound {b_ms:.5f} ms by {b_by}; kernel at "
                    f"{n_ops / k_ms / 1e9:.1f} TFLOP/s, {b_ms / k_ms:.2%} of its bound, "
                    f"{k_ms / l_ms:.3f}x sdpa's time a call"
                )
                if bf16:   # fp32 sdpa runs cuBLAS, which keeps a workspace per capture stream
                    k_dev, l_dev = (graph_ms(f) for f in (lambda: fa.attention(q, k, v, **kw), sdpa))
                    line += (
                        f"; on the device (CUDA graph) wgmma {k_dev:.4f} ms, "
                        f"sdpa {l_dev:.4f} ms, wgmma {k_dev / l_dev:.3f}x sdpa"
                    )
                    row = {
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": l_ms, "device_ms": k_dev,
                        "library_device_ms": l_dev,
                    }
                    if label.startswith("demo"):
                        entry = {
                            "name": "flash_attention",
                            "route": "cuda",
                            "source": "src/repro_torch/csrc/flash_attention.cu",
                            "replaces": "src/repro/kernels/flash_attention/kernel.py:93",
                            "launches": 0,
                            **row,
                            "per": "launch (B=2, S=32, H=16, KVH=8, D=128, causal, bf16)",
                        }
                    else:
                        timed[label] = {"shape": f"B={b}, S={sq}, H={h}, KVH={kvh}, D={d}, causal, bf16",
                                        "tflops": n_ops / k_ms / 1e9, **row}
                line += f" [{card}]"
            print(line)
    entry["long_prefill"] = timed["long prefill"]
    entry["reduced_prefill"] = timed["reduced qwen3 prefill"]
    return entry


# ---------------------------------------------------------------------------
# Phase 4: the LSTM kernel and the quickstart
# ---------------------------------------------------------------------------
def _lstm_inputs(b, s, i, h, seed=0):
    """The reference test's input scales: x, w_ih, w_hh, b, h0, c0."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    shapes = ((b, s, i), (i, 4 * h), (h, 4 * h), (4 * h,), (b, h), (b, h))
    scales = (1.0, 0.3, 0.3, 0.1, 0.5, 0.5)
    return [torch.randn(sh, generator=g, device="cuda") * sc for sh, sc in zip(shapes, scales)]


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, so no host enqueue time is counted."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay) / reps


def lstm_kernel_checks() -> float:
    """The kernel against its plain version, and its gradient against
    plain autograd; returns the largest fp32 error at the path's shapes."""
    import torch

    from repro_torch.kernels.lstm import ops as lo
    from repro_torch.kernels.lstm.ref import lstm_reference

    path_err = 0.0
    shapes = [(4, 32, 6, 20), (1, 16, 3, 7), (8, 64, 12, 20),   # the reference test's
              (32, 64, 6, 20), (1, 64, 6, 20),                  # the path's
              (3, 24, 4, 5), (2, 24, 5, 33),                    # h in {5, 33}
              (530, 8, 3, 7), (1101, 8, 6, 20),                 # many rows, ragged blocks
              (4, 16, 6, 32), (4, 16, 6, 64), (4, 16, 6, 1),    # a full warp, two units a lane, H 1
              (1, 1, 6, 20), (2, 8, 40, 100)]                   # one step; I > 32
    for shape in shapes:
        for with_state in (False, True):
            args = _lstm_inputs(*shape, seed=int(with_state))
            if not with_state:
                args = args[:4]
            hs, h, c = lo.lstm_cuda(*args)
            rhs, (rh, rc) = lstm_reference(*args)
            torch.cuda.synchronize()
            err = max(float((a - r).abs().max()) for a, r in ((hs, rhs), (h, rh), (c, rc)))
            check(err <= LSTM_ATOL, f"lstm {shape} h0/c0={with_state} fp32: max err {err:.3g} > {LSTM_ATOL}")
            if shape in ((32, 64, 6, 20), (1, 64, 6, 20)):
                path_err = max(path_err, err)
            # bf16 in and out, fp32 inside: one rounding at the output, so
            # within half a bf16 ulp (2**-8 relative) of the fp32 plain
            # version on the same bf16 inputs, plus the fp32 atol
            bargs = [t.to(torch.bfloat16) for t in args]
            bhs, bh, bc = lo.lstm_cuda(*bargs)
            fhs, (fh, fc) = lstm_reference(*(t.float() for t in bargs))
            torch.cuda.synchronize()
            berr = max(float((a.float() - r).abs().max()) for a, r in ((bhs, fhs), (bh, fh), (bc, fc)))
            ok = all(bool(((a.float() - r).abs() <= 2.0 ** -8 * r.abs() + LSTM_ATOL).all())
                     for a, r in ((bhs, fhs), (bh, fh), (bc, fc)))
            check(ok, f"lstm {shape} h0/c0={with_state} bf16: beyond half an ulp (max err {berr:.3g})")
            print(f"  lstm {shape} h0/c0={with_state}: max_abs_err fp32 {err:.3g}, "
                  f"bf16 {berr:.3g} (vs fp32 plain on the bf16 inputs)")

    for with_state in (False, True):
        args = _lstm_inputs(32, 64, 6, 20, seed=9)
        if not with_state:
            args = args[:4]
        g = torch.Generator("cuda").manual_seed(10)
        ws = [torch.randn(sh, generator=g, device="cuda") for sh in ((32, 64, 20), (32, 20), (32, 20))]

        def grads(fn):
            leaves = [t.clone().requires_grad_(True) for t in args]
            hs, (h, c) = fn(*leaves)
            loss = sum((w * t).sum() for w, t in zip(ws, (hs, h, c)))
            return torch.autograd.grad(loss, leaves)

        gerr = max(float((a - b).abs().max()) for a, b in zip(grads(lo.lstm), grads(lstm_reference)))
        check(gerr <= LSTM_ATOL, f"lstm gradient h0/c0={with_state}: max err {gerr:.3g} > {LSTM_ATOL}")
        print(f"  lstm gradient (32,64,6,20) h0/c0={with_state}, autograd.Function vs plain "
              f"autograd: max_abs_err {gerr:.3g}")
    return path_err


def quickstart_path(card: str) -> int:
    """The quickstart on the card: Experiments 1-3, then 300 training steps
    and one timed inference through the kernel.  Returns the launches."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels.lstm import ops as lo
    from repro_torch.kernels.lstm.ref import lstm_reference
    from repro_torch.models import lstm as lstm_model

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        quickstart.exp1()
        quickstart.exp2()
        quickstart.exp3()
    lines = buf.getvalue().splitlines()
    print("\n".join(lines))
    check(lines == EXPERIMENT_LINES, "Experiments 1-3 differ from the reference quickstart's lines")

    lo.launches = 0
    t0 = time.perf_counter()
    out = quickstart.train_accelerator(device="cuda", steps=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    n = lo.launches
    want = TRAIN_STEPS + 3       # a forward per step, the evaluation, a warm-up, the timed one
    print(f"  train_accelerator: {wall:.3f} s for {TRAIN_STEPS} steps, lstm launches {n} "
          f"(expected {want}), single inference {out['inference_ms']:.4f} ms [{card}]")
    check(n == want, f"lstm launches {n} != {want}")
    losses = out["losses"]
    check(all(math.isfinite(v) for v in losses), "non-finite training loss")
    check(losses[-1] < losses[0], f"final loss {losses[-1]:.4f} is not below the first {losses[0]:.4f}")

    # the same 10 steps through the plain version, on the card
    with mock.patch.object(lstm_model.lstm_ops, "lstm", lstm_reference), \
            contextlib.redirect_stdout(io.StringIO()):
        plain = quickstart.train_accelerator(device="cuda", steps=10)
    check(lo.launches == n, "the plain-trained run launched the kernel")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:10], plain["losses"]))
    print(f"  first 10 losses, kernel vs plain training on the card: max relative difference {rel:.3g}")
    check(rel <= 1e-4, f"kernel-trained and plain-trained losses differ by {rel:.3g} (limit 1e-4)")
    return n


def lstm_times(card: str) -> dict:
    """Kernel, plain version and cuDNN nn.LSTM at the path's two shapes."""
    import torch

    from repro_torch.kernels.lstm import ops as lo
    from repro_torch.kernels.lstm.ref import lstm_reference

    print(f"  cuDNN {torch.backends.cudnn.version()}, enabled {torch.backends.cudnn.enabled}")
    rows = {}
    for bsz in (32, 1):
        s, i, h = 64, 6, 20
        x, w_ih, w_hh, b, _, _ = _lstm_inputs(bsz, s, i, h, seed=11)
        net = torch.nn.LSTM(i, h, batch_first=True).cuda()
        with torch.no_grad():       # same weights; PyTorch's gate order is i, f, g, o too
            net.weight_ih_l0.copy_(w_ih.t())
            net.weight_hh_l0.copy_(w_hh.t())
            net.bias_ih_l0.copy_(b)
            net.bias_hh_l0.zero_()
            lib_hs, _ = net(x)
            rhs, _ = lstm_reference(x, w_ih, w_hh, b)
            hs, _, _ = lo.lstm_cuda(x, w_ih, w_hh, b)
            torch.cuda.synchronize()
            lib_err = float((lib_hs - rhs).abs().max())
            err = float((hs - rhs).abs().max())
            check(lib_err <= LSTM_ATOL, f"nn.LSTM does not compute the same function ({lib_err:.3g})")
            k_ms = time_ms(lambda: lo.lstm_cuda(x, w_ih, w_hh, b))
            k_dev = graph_ms(lambda: lo.lstm_cuda(x, w_ih, w_hh, b))
            p_ms = time_ms(lambda: lstm_reference(x, w_ih, w_hh, b))
            l_ms = time_ms(lambda: net(x))
        n_ops = bsz * s * (8 * h * (i + h) + 4 * h + 10 * h)
        n_bytes = 4 * (x.numel() + w_ih.numel() + w_hh.numel() + b.numel() + hs.numel() + 2 * bsz * h)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
        print(f"  lstm B={bsz} S={s} I={i} H={h} fp32: kernel {k_ms:.4f} ms per call "
              f"({k_dev:.4f} ms of device time, CUDA graph; {k_dev / s * 1e3:.4f} us a step on "
              f"the device, {k_ms / s * 1e3:.4f} us a step a call), plain {p_ms:.4f} ms, library "
              f"(nn.LSTM, cuDNN) {l_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} "
              f"({n_ops / 1e6:.3f} MFLOP, {n_bytes / 1e6:.4f} MB); max_abs_err kernel {err:.3g}, "
              f"nn.LSTM {lib_err:.3g} [{card}]")
        rows[bsz] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by, device_us_per_step=k_dev / s * 1e3)
    return rows


def lstm_phase(card: str) -> dict:
    path_err = lstm_kernel_checks()
    n = quickstart_path(card)
    rows = lstm_times(card)
    r = rows[32]
    return {
        "name": "lstm_pallas",
        "route": "cuda",
        "source": "src/repro_torch/csrc/lstm.cu",
        "replaces": "src/repro/kernels/lstm/kernel.py:67",
        "launches": n,
        "max_abs_err": path_err,
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "device_ms": r["device_ms"],
        "device_us_per_step": r["device_us_per_step"],
        "at_batch_1": rows[1],
        "per": "launch (training forward: B=32, S=64, I=6, H=20, fp32)",
    }


# ---------------------------------------------------------------------------
# Phase 5: serving
# ---------------------------------------------------------------------------
def output_check() -> None:
    """The kernel path against the plain path on the same weights: a small
    fp32 model, and the full-width model in fp32 and in bf16.  The plain
    path is the same prefill with the flash-attention wrapper swapped for
    its plain version inside this function only.  fp32 is held to 1e-4 of
    the largest logit; bf16, whose roundings of the two paths drift apart
    over 28 layers of random weights, to equal argmax and 3e-2 of the
    largest logit (the readings are in PERF.md)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.serializer import flatten, unflatten_like
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.models import attention
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import bring_up_from_checkpoint

    def plain_prefill(*args):
        with mock.patch.object(attention.attn_ops, "attention", attention_reference):
            return zoo.prefill_fn(*args)

    small = get_config(ARCH, reduced=True)
    params = zoo.init_params(small, torch.Generator("cuda").manual_seed(1), torch.float32)
    tokens = torch.randint(0, small.vocab_size, (2, 32), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    with torch.inference_mode():
        a, _ = zoo.prefill_fn(params, {"tokens": tokens}, small, 48)
        b, _ = plain_prefill(params, {"tokens": tokens}, small, 48)
    err = float((a - b).abs().max())
    check(err <= 1e-4, f"reduced fp32 prefill logits: kernel vs plain differ by {err:.3g}")
    print(f"  reduced fp32 prefill logits, kernel vs plain path: max_abs_err {err:.3g}")

    # full width: the restored bf16 weights, and the same weights in fp32,
    # where the two paths differ only by the kernel's fp32 rounding
    cfg = get_config(ARCH)
    engine = bring_up_from_checkpoint(cfg, CheckpointManager(str(CKPT_DIR)), 96)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    p32 = unflatten_like(engine.params, [t.float() for _, t in flatten(engine.params)])
    for name, params in (("bf16", engine.params), ("fp32", p32)):
        with torch.inference_mode():
            a, _ = zoo.prefill_fn(params, {"tokens": tokens}, cfg, 96)
            b, _ = plain_prefill(params, {"tokens": tokens}, cfg, 96)
        check(a.shape == (2, cfg.vocab_size) and bool(torch.isfinite(a).all()),
              f"full-width {name} logits: shape {tuple(a.shape)} or non-finite")
        err = float((a - b).abs().max())
        rel = err / float(b.abs().max())
        same = int((a.argmax(-1) == b.argmax(-1)).sum())
        print(f"  full-width {name} prefill logits, kernel vs plain path: max_abs_err "
              f"{err:.3g}, relative error {rel:.3g} (max |logit| {float(b.abs().max()):.4g}), "
              f"argmax equal in {same} of 2")
        limit = 1e-4 if name == "fp32" else 3e-2
        check(rel <= limit, f"full-width {name} prefill logits: kernel vs plain differ by "
                            f"{rel:.3g} of the largest logit, limit {limit}")
        check(same == 2, f"full-width {name} prefill: argmax differs in {2 - same} of 2 rows")
    del p32
    engine.release()


def configuration_split(card: str, arch: str = ARCH, ckpt_dir: Path = CKPT_DIR) -> None:
    """Where one bring-up's time goes: file read, msgpack unpack, zlib
    inflate, and the rest of a restore onto the card (host-to-device copies
    and the dequant kernels)."""
    import torch
    import zlib

    from repro_torch.checkpoint import _msgpack, serializer
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo

    path = sorted(ckpt_dir.glob("step_*.ckpt"))[-1]
    t0 = time.perf_counter()
    data = path.read_bytes()
    t1 = time.perf_counter()
    payload = _msgpack.unpackb(data)
    t2 = time.perf_counter()
    n_raw = 0
    for record in payload["leaves"]:
        blobs = [record["quant"]["q"], record["quant"]["scales"]] if "quant" in record else [record["data"]]
        n_raw += sum(len(zlib.decompress(b)) for b in blobs)
    t3 = time.perf_counter()
    del payload
    params = serializer.deserialize(data, zoo.param_shapes(get_config(arch)), device="cuda")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    rest = (t4 - t3) - (t2 - t1) - (t3 - t2)
    print(f"  {arch} configuration split ({len(data) / 1e9:.3f} GB file, {n_raw / 1e9:.3f} GB inflated): "
          f"read {t1 - t0:.3f} s, msgpack unpack {t2 - t1:.3f} s, zlib inflate {t3 - t2:.3f} s, "
          f"restore onto the card {t4 - t3:.3f} s of which copies + dequant + other "
          f"{rest:.3f} s [{card}]")


def serving_phase(card: str) -> tuple[int, int]:
    import torch

    from repro_torch.core.phases import CONFIGURATION, INFERENCE
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import build_demo
    from repro_torch.serving.scheduler import run_schedule

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    cfg_layers = 28
    results = {}
    launches = {"dequant": 0, "flash": 0}
    for strategy in ("on_off", "idle_waiting"):
        t0 = time.perf_counter()
        controller, make_request = build_demo(
            ARCH, reduced=False, device="cuda", ckpt_dir=str(CKPT_DIR), strategy=strategy
        )
        print(f"  {strategy}: build_demo {time.perf_counter() - t0:.3f} s "
              f"(writes the checkpoint on first use: "
              f"{sum(f.stat().st_size for f in CKPT_DIR.iterdir()) / 1e9:.3f} GB)")
        requests = [make_request() for _ in range(REQUESTS)]
        torch.cuda.reset_peak_memory_stats()
        dq.launches = 0
        fa.launches = 0
        res = run_schedule(controller, iter(requests), period_s=PERIOD_S)
        n_dq, n_fa = dq.launches, fa.launches
        if controller.handle is not None:     # idle-waiting keeps it resident
            controller.release_fn(controller.handle)
            controller.handle = None
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        after = torch.cuda.memory_allocated()
        launches["dequant"] += n_dq
        launches["flash"] += n_fa
        prefills = res.n_requests + res.n_configurations   # + bring-up warm-ups
        check(n_dq == 8 * res.n_configurations,
              f"{strategy}: {n_dq} dequant launches for {res.n_configurations} bring-ups")
        check(n_fa == cfg_layers * prefills,
              f"{strategy}: {n_fa} flash launches for {prefills} prefills")
        check(res.n_requests == REQUESTS, f"{strategy}: served {res.n_requests} requests")
        cfg_s = [r.wall_s for r in controller.records if r.name == CONFIGURATION]
        inf_s = [r.wall_s for r in controller.records if r.name == INFERENCE]
        print(f"  {strategy}: {res.n_requests} requests, {res.n_configurations} configurations, "
              f"energy {res.energy_mj:.1f} mJ, by phase "
              f"{ {k: round(v, 1) for k, v in res.energy_by_phase_mj.items()} }, "
              f"measured crossover {res.crossover_ms} ms")
        print(f"  {strategy}: configuration s {cfg_s}, inference s {inf_s}, wall {res.wall_s:.3f} s")
        print(f"  {strategy}: dequant launches {n_dq} (8 per bring-up), flash launches "
              f"{n_fa} (28 per prefill, {prefills} prefills)")
        print(f"  {strategy}: max_memory_allocated {peak / 1e9:.3f} GB, "
              f"memory_allocated after release {after / 1e9:.6f} GB [{card}]")
        check(after < 1e8, f"{strategy}: {after} bytes still allocated after release")
        results[strategy] = res
    oo, iw = results["on_off"], results["idle_waiting"]
    print(f"  energy ratio On-Off / Idle-Waiting: {oo.energy_mj / iw.energy_mj:.4f}")
    check(iw.energy_mj < oo.energy_mj, "Idle-Waiting must use less energy than On-Off at 0.5 s")
    configuration_split(card)
    output_check()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return launches["dequant"], launches["flash"]


# ---------------------------------------------------------------------------
# Phase 6: the SSD kernel
# ---------------------------------------------------------------------------
def _ssd_inputs(b, s, h, p, g, n, seed, a_minus_one=False):
    """The reference test's inputs (``make_inputs``): x, dt, a, B, C, d and
    an initial state; ``a = -1`` is the init's ``a_log = 0``."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, dt, a = randn(b, s, h, p), F.softplus(randn(b, s, h)), -torch.exp(randn(h))
    if a_minus_one:
        a = -torch.ones(h, device="cuda")
    bm, cm, d = randn(b, s, g, n) * 0.5, randn(b, s, g, n) * 0.5, randn(h)
    return [x, dt, a, bm, cm, d], randn(b, h, p, n) * 0.1


def _bf16(args):
    """x, B, C and d in bf16; dt and a stay fp32, as on the served path."""
    import torch

    x, dt, a, bm, cm, d = args
    return [x.to(torch.bfloat16), dt, a, bm.to(torch.bfloat16), cm.to(torch.bfloat16),
            d.to(torch.bfloat16)]


def _within_bf16_ulp(out, ref) -> bool:
    """|out − ref| ≤ one bf16 ulp of ref plus the fp32 tolerance."""
    import torch

    _, exp = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)
    return bool(((out.float() - ref).abs() <= ulp + SSD_TOL["y"]).all())


def _ssd_case(label, args, init, chunk) -> tuple[float, float]:
    """The kernel against the plain recurrent version in fp32 (the test's
    limits) and on bf16 inputs (one bf16 ulp on y); → the bf16 errors."""
    import torch

    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd.ref import ssd_recurrent_reference

    y, st = so.ssd_cuda(*args, chunk=chunk, init_state=init)
    ry, rst = ssd_recurrent_reference(*args, init_state=init)
    torch.cuda.synchronize()
    ey, es = float((y - ry).abs().max()), float((st - rst).abs().max())
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()), f"ssd {label}: non-finite")
    check(ey <= SSD_TOL["y"] and es <= SSD_TOL["state"],
          f"ssd {label} fp32: max err y {ey:.3g}, state {es:.3g} (limits {SSD_TOL})")
    bargs = _bf16(args)
    by, bst = so.ssd_cuda(*bargs, chunk=chunk, init_state=init)
    fy, fst = ssd_recurrent_reference(*(t.float() for t in bargs), init_state=init)
    torch.cuda.synchronize()
    bey, bes = float((by.float() - fy).abs().max()), float((bst - fst).abs().max())
    check(by.dtype == torch.bfloat16 and _within_bf16_ulp(by, fy),
          f"ssd {label} bf16: y beyond one bf16 ulp (max err {bey:.3g})")
    check(bes <= SSD_TOL["state"], f"ssd {label} bf16: state err {bes:.3g} > {SSD_TOL['state']}")
    print(f"  ssd {label}: fp32 max_abs_err y {ey:.3g}, state {es:.3g}; bf16 y {bey:.3g} "
          f"(within one bf16 ulp), state {bes:.3g}")
    return bey, bes


def _ssd_work(b, s, h, p, g, n, q, elem, with_init) -> tuple[float, float]:
    """(bytes, operations) of one call: every input read once, every output
    written once; the four products' multiply-adds, the causal half of the
    two (Q, Q) ones, each counted as two operations."""
    nc = s // q
    tri = q * (q + 1) / 2
    ops = 2.0 * b * h * nc * (tri * n + tri * p + 2.0 * q * n * p)
    n_bytes = (2 * b * s * h * p + 2 * b * s * g * n + h) * elem + (b * s * h + h) * 4
    n_bytes += b * h * p * n * 4 * (2 if with_init else 1)
    return n_bytes, ops


def _ssd_timed(label, b, s, h, p, g, n, q, card) -> dict:
    """Kernel, its CUDA-graph device time and the plain chunked version at
    one shape in bf16, beside the bound; the kernel held to the recurrent
    oracle on the same inputs."""
    import torch

    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_recurrent_reference

    args, _ = _ssd_inputs(b, s, h, p, g, n, seed=21, a_minus_one=True)
    bargs = _bf16(args)
    y, st = so.ssd_cuda(*bargs, chunk=q)
    fy, fst = ssd_recurrent_reference(*(t.float() for t in bargs))
    torch.cuda.synchronize()
    ey, es = float((y.float() - fy).abs().max()), float((st - fst).abs().max())
    check(_within_bf16_ulp(y, fy) and es <= SSD_TOL["state"],
          f"ssd {label} bf16: y err {ey:.3g}, state err {es:.3g}")
    k_ms = time_ms(lambda: so.ssd_cuda(*bargs, chunk=q))
    k_dev = graph_ms(lambda: so.ssd_cuda(*bargs, chunk=q))
    # each of the four kernels alone, on the scratch of one whole call
    call = so.prepare(*bargs, chunk=q)
    so.launch_stages(call, so.ALL_STAGES)
    stages = {name: graph_ms(lambda: so.launch_stages(call, 1 << k))
              for k, name in enumerate(SSD_STAGES)}
    p_ms = time_ms(lambda: ssd_chunked(*bargs, chunk=q))
    n_bytes, n_ops = _ssd_work(b, s, h, p, g, n, q, 2, False)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    floor = n_ops / PEAK_OPS["float32"] * 1e3
    print(f"  ssd {label} B {b}, S {s}, H {h}, P {p}, G {g}, N {n}, chunk {q}, bf16: max_abs_err "
          f"y {ey:.3g} (within one bf16 ulp), state {es:.3g}; kernel {k_ms:.4f} ms a call "
          f"({k_dev:.4f} ms of device time, CUDA graph), plain {p_ms:.4f} ms, library none "
          f"exists, bound {b_ms:.5f} ms by {b_by} ({n_ops / 1e9:.4f} GFLOP at bf16's 989 TFLOP/s, "
          f"{n_bytes / 1e6:.3f} MB at 3.35 TB/s); fp32 CUDA-core floor {floor:.5f} ms "
          f"(at 67 TFLOP/s) [{card}]")
    print(f"  ssd {label} device time by kernel (each alone, CUDA graph): "
          + ", ".join(f"{name} {t:.4f} ms" for name, t in stages.items())
          + f"; sum {sum(stages.values()):.4f} ms against {k_dev:.4f} ms for the four together")
    return dict(max_abs_err=ey, max_abs_err_state=es, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, fp32_cuda_core_floor_ms=floor,
                stage_device_ms=stages)


def ssd_phase(card: str) -> dict:
    import torch

    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd.ref import ssd_recurrent_reference

    # tests/kernels/test_ssd.py's shapes (b, s, h, p, g, n, chunk), the
    # served prefill's (a = -1), and two groups under eight heads
    cases = [(2, 256, 4, 16, 2, 32, 64), (1, 128, 2, 8, 1, 16, 128),
             (2, 512, 8, 32, 2, 64, 128), (1, 256, 4, 64, 1, 128, 64)]
    for i, (b, s, h, p, g, n, q) in enumerate(cases):
        args, init = _ssd_inputs(b, s, h, p, g, n, seed=i)
        for with_init in (True, False):
            _ssd_case(f"test shape {(b, s, h, p, g, n)} chunk {q} init_state={with_init}",
                      args, init if with_init else None, q)
    args, _ = _ssd_inputs(2, 256, 32, 64, 1, 128, seed=7, a_minus_one=True)
    path_err = _ssd_case("path shape (2, 256, 32, 64, 1, 128) chunk 128, a = -1", args, None, 128)
    # a = -1 as the init gives: with a = -exp(normal) and chunk 128 the
    # in-chunk cumsum reaches the thousands, where the chunked form's fp32
    # exp(total - cs) (the plain version's as well) can stray from the
    # recurrence past the test's 5e-5 on the state
    args, init = _ssd_inputs(1, 256, 8, 64, 2, 128, seed=8, a_minus_one=True)
    _ssd_case("groups G 2 < H 8 (1, 256, 8, 64, 2, 128) chunk 128, a = -1", args, init, 128)
    args, init = _ssd_inputs(1, 256, 8, 64, 4, 128, seed=10, a_minus_one=True)
    _ssd_case("groups G 4 < H 8 (1, 256, 8, 64, 4, 128) chunk 128, a = -1", args, init, 128)
    # sixteen chunks in parallel, the state handed between them, a = -exp(normal)
    args, init = _ssd_inputs(1, 1024, 4, 64, 1, 128, seed=11)
    _ssd_case("many chunks (1, 1024, 4, 64, 1, 128) chunk 64", args, init, 64)
    # one chunk (no state passed), and a long prefill (sixteen chunks at the
    # served widths): the card tests' other rows
    args, init = _ssd_inputs(1, 128, 4, 64, 1, 128, seed=12, a_minus_one=True)
    _ssd_case("one chunk (1, 128, 4, 64, 1, 128) chunk 128, a = -1", args, init, 128)
    args, init = _ssd_inputs(1, 2048, 32, 64, 1, 128, seed=13, a_minus_one=True)
    _ssd_case("long prefill (1, 2048, 32, 64, 1, 128) chunk 128, a = -1", args, init, 128)

    # the state handed across two calls (tests/kernels/test_ssd.py:95)
    args, _ = _ssd_inputs(1, 256, 2, 8, 1, 16, seed=9)
    halves = [[t[:, sl] if t.dim() > 1 else t for t in args] for sl in (slice(0, 128), slice(128, None))]
    y1, s1 = so.ssd_cuda(*halves[0], chunk=64)
    y2, s2 = so.ssd_cuda(*halves[1], chunk=64, init_state=s1)
    ry, rs = ssd_recurrent_reference(*args)
    torch.cuda.synchronize()
    ey, es = float((torch.cat([y1, y2], 1) - ry).abs().max()), float((s2 - rs).abs().max())
    check(ey <= SSD_TOL["y"] and es <= SSD_TOL["state"],
          f"ssd state handoff: max err y {ey:.3g}, state {es:.3g}")
    print(f"  ssd state handed across two calls (1, 256, 2, 8, 1, 16) chunk 64: max_abs_err "
          f"y {ey:.3g}, state {es:.3g}")

    row = _ssd_timed("served prefill", 2, 256, 32, 64, 1, 128, 128, card)
    long = _ssd_timed("long prefill", 1, 2048, 32, 64, 1, 128, 128, card)
    return {
        "name": "ssd_pallas",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:89",
        "launches": 0,
        "max_abs_err": max(row["max_abs_err"], path_err[0]),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "device_ms": row["device_ms"],
        "fp32_cuda_core_floor_ms": row["fp32_cuda_core_floor_ms"],
        "max_abs_err_state": row["max_abs_err_state"],
        "at_long_prefill": long,
        "per": "launch (prefill: B=2, S=200 padded to 256, H=32, P=64, G=1, N=128, chunk 128, bf16)",
    }


# ---------------------------------------------------------------------------
# Phase 7: mamba2-370m serving
# ---------------------------------------------------------------------------
def mamba2_output_check(card: str) -> None:
    """The full-width 48-layer prefill logits through the kernel against
    the plain path (the wrapper swapped for the plain chunked version inside
    this function only), on the restored weights cast to fp32: within 1e-4
    of the largest logit, equal argmax, finite, and spread (standard
    deviation over the vocabulary at least 0.1 in every row).  In bf16 the
    kernel is held to the plain recurrent scan layer by layer, on each
    layer's own inputs; the bf16 end-to-end difference is printed, not gated
    (the roundings of two bf16 paths drift apart over 48 layers)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.serializer import flatten, unflatten_like
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_recurrent_reference
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import bring_up_from_checkpoint

    def plain_prefill(*args):
        with mock.patch.object(m2.ssd_ops, "ssd", ssd_chunked):
            return zoo.prefill_fn(*args)

    cfg = get_config(MAMBA)
    engine = bring_up_from_checkpoint(cfg, CheckpointManager(str(CKPT_DIR_MAMBA)), MAMBA_MAX_LEN,
                                      device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, MAMBA_PROMPT), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    batch = {"tokens": tokens}
    p32 = unflatten_like(engine.params, [t.float() for _, t in flatten(engine.params)])
    with torch.inference_mode():
        a, _ = zoo.prefill_fn(p32, batch, cfg, MAMBA_MAX_LEN)
        b, _ = plain_prefill(p32, batch, cfg, MAMBA_MAX_LEN)
    del p32
    check(a.shape == (2, cfg.vocab_size) and bool(torch.isfinite(a).all()),
          f"mamba2 fp32 logits: shape {tuple(a.shape)} or non-finite")
    err, top = float((a - b).abs().max()), float(b.abs().max())
    rel = err / top
    same = int((a.argmax(-1) == b.argmax(-1)).sum())
    spread = [float(v) for v in a.std(-1)]
    print(f"  {MAMBA} full-width fp32 prefill logits (48 layers, prompt {MAMBA_PROMPT}), kernel vs "
          f"plain path: max_abs_err {err:.3g}, relative error {rel:.3g} (max |logit| {top:.4g}), "
          f"argmax equal in {same} of 2, logit std over the vocabulary {[round(v, 4) for v in spread]}")
    check(rel <= 1e-4, f"mamba2 fp32 logits: kernel vs plain differ by {rel:.3g} of the largest logit")
    check(same == 2, f"mamba2 fp32 logits: argmax differs in {2 - same} of 2 rows")
    check(min(spread) >= 0.1, f"mamba2 fp32 logits collapsed: std over the vocabulary {spread}")

    # bf16: each layer's own SSD inputs, captured on the served (bf16) path
    captured = []
    wrapper = so.ssd

    def capture(*args, **kw):
        captured.append(([t.clone() for t in args], kw))
        return wrapper(*args, **kw)

    with torch.inference_mode():
        with mock.patch.object(m2.ssd_ops, "ssd", capture):
            a16, _ = zoo.prefill_fn(engine.params, batch, cfg, MAMBA_MAX_LEN)
        b16, _ = plain_prefill(engine.params, batch, cfg, MAMBA_MAX_LEN)
    check(len(captured) == cfg.num_layers, f"captured {len(captured)} SSD calls, not {cfg.num_layers}")
    ey = es = 0.0
    for i, (args, kw) in enumerate(captured):
        y, st = so.ssd_cuda(*args, **kw)
        fy, fst = ssd_recurrent_reference(*(t.float() for t in args), init_state=kw["init_state"])
        torch.cuda.synchronize()
        ey = max(ey, float((y.float() - fy).abs().max()))
        es = max(es, float(((st - fst).abs() / (1.0 + fst.abs())).max()))
        check(y.dtype == torch.bfloat16 and _within_bf16_ulp(y, fy),
              f"mamba2 bf16 layer {i}: kernel beyond one bf16 ulp of the plain scan")
        check(es <= SSD_TOL["state"], f"mamba2 bf16 layer {i}: state differs by {es:.3g} (relative)")
    del captured
    e2e = float((a16 - b16).abs().max())
    same16 = int((a16.argmax(-1) == b16.argmax(-1)).sum())
    print(f"  {MAMBA} bf16, kernel vs plain recurrent scan on each layer's own inputs (48 layers): max_abs_err "
          f"y {ey:.3g} (within one bf16 ulp), state {es:.3g} (relative to 1 + |state|)")
    print(f"  {MAMBA} bf16 prefill logits end to end, kernel vs plain path (not gated): max_abs_err "
          f"{e2e:.3g} (max |logit| {float(b16.abs().max()):.4g}), argmax equal in {same16} of 2 [{card}]")
    engine.release()


def mamba2_serving_phase(card: str) -> tuple[int, int]:
    """Full-width mamba2-370m under On-Off and Idle-Waiting → (dequant
    launches, SSD launches) of the two runs."""
    import torch

    from repro_torch.core.phases import CONFIGURATION, INFERENCE
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.launch.serve import build_demo
    from repro_torch.serving.scheduler import run_schedule

    shutil.rmtree(CKPT_DIR_MAMBA, ignore_errors=True)
    layers = 48
    results = {}
    launches = {"dequant": 0, "ssd": 0}
    for strategy in ("on_off", "idle_waiting"):
        t0 = time.perf_counter()
        controller, make_request = build_demo(
            MAMBA, reduced=False, device="cuda", ckpt_dir=str(CKPT_DIR_MAMBA), strategy=strategy,
            prompt_len=MAMBA_PROMPT, max_len=MAMBA_MAX_LEN,
        )
        print(f"  {MAMBA} {strategy}: build_demo {time.perf_counter() - t0:.3f} s "
              f"(writes the checkpoint on first use: "
              f"{sum(f.stat().st_size for f in CKPT_DIR_MAMBA.iterdir()) / 1e9:.3f} GB)")
        requests = [make_request() for _ in range(REQUESTS)]
        torch.cuda.reset_peak_memory_stats()
        dq.launches = 0
        so.launches = 0
        res = run_schedule(controller, iter(requests), period_s=PERIOD_S)
        n_dq, n_ssd = dq.launches, so.launches
        if controller.handle is not None:     # idle-waiting keeps it resident
            controller.release_fn(controller.handle)
            controller.handle = None
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        after = torch.cuda.memory_allocated()
        launches["dequant"] += n_dq
        launches["ssd"] += n_ssd
        prefills = res.n_requests + res.n_configurations   # + bring-up warm-ups
        check(n_dq == 9 * res.n_configurations,
              f"{MAMBA} {strategy}: {n_dq} dequant launches for {res.n_configurations} bring-ups")
        check(n_ssd == layers * prefills,
              f"{MAMBA} {strategy}: {n_ssd} ssd launches for {prefills} prefills")
        check(res.n_requests == REQUESTS, f"{MAMBA} {strategy}: served {res.n_requests} requests")
        cfg_s = [r.wall_s for r in controller.records if r.name == CONFIGURATION]
        inf_s = [r.wall_s for r in controller.records if r.name == INFERENCE]
        print(f"  {MAMBA} {strategy}: {res.n_requests} requests, {res.n_configurations} "
              f"configurations, energy {res.energy_mj:.1f} mJ, by phase "
              f"{ {k: round(v, 1) for k, v in res.energy_by_phase_mj.items()} }, "
              f"measured crossover {res.crossover_ms} ms")
        print(f"  {MAMBA} {strategy}: configuration s {cfg_s}, inference s {inf_s}, "
              f"wall {res.wall_s:.3f} s")
        print(f"  {MAMBA} {strategy}: dequant launches {n_dq} (9 per bring-up), ssd launches "
              f"{n_ssd} (48 per prefill, {prefills} prefills)")
        print(f"  {MAMBA} {strategy}: max_memory_allocated {peak / 1e9:.3f} GB, "
              f"memory_allocated after release {after / 1e9:.6f} GB [{card}]")
        check(after < 1e8, f"{MAMBA} {strategy}: {after} bytes still allocated after release")
        results[strategy] = res
    oo, iw = results["on_off"], results["idle_waiting"]
    print(f"  {MAMBA} energy ratio On-Off / Idle-Waiting: {oo.energy_mj / iw.energy_mj:.4f}")
    check(iw.energy_mj < oo.energy_mj, "Idle-Waiting must use less energy than On-Off at 0.5 s")
    configuration_split(card, MAMBA, CKPT_DIR_MAMBA)
    mamba2_output_check(card)
    shutil.rmtree(CKPT_DIR_MAMBA, ignore_errors=True)
    return launches["dequant"], launches["ssd"]


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    print("== preflight")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on the card")
    card = card_line()
    print(f"card: {card}, devices: {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== build")
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    _lib.library()
    print(f"kernel library built in {time.perf_counter() - t0:.2f} s "
          f"(cached: {_lib.last_build['cached']})")
    for line in _lib.last_build["log"].splitlines():
        if "registers" in line or "==" in line or "spill" in line:
            print(f"  {line.strip()}")

    print("== kernels vs plain versions")
    dq_entry = dequant_phase(card)
    fa_entry = flash_phase(card)

    print("== lstm")
    lstm_entry = lstm_phase(card)
    check(lstm_entry["launches"] > 0, "the LSTM kernel was never launched on the quickstart path")

    print("== serving")
    n_dq, n_fa = serving_phase(card)
    dq_entry["launches"], fa_entry["launches"] = n_dq, n_fa
    check(n_dq > 0 and n_fa > 0, "a kernel of the main path was never launched")

    print("== ssd")
    ssd_entry = ssd_phase(card)

    print("== mamba2 serving")
    n_dq_mamba, n_ssd = mamba2_serving_phase(card)
    dq_entry["launches"] += n_dq_mamba
    ssd_entry["launches"] = n_ssd
    check(n_dq_mamba > 0 and n_ssd > 0, "a kernel of the mamba2 path was never launched")

    print(card)
    print(json.dumps({"kernels": [dq_entry, fa_entry, lstm_entry, ssd_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
