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
   and fp32 through the CUDA-core kernel, timed at the served prefills of
   qwen3-1.7b, yi-6b, internlm2-20b and qwen3-32b (GQA groups 2, 8, 6, 8),
   at the reduced qwen3's prefill, at S 2048 beside SDPA, and at the new
   families' shapes: qwen3-moe's group 16, mixtral's window 4096 at 4608
   and 8192 tokens (SDPA with an explicit mask), hubert's bidirectional
   head dim 80, llava's 608 tokens and jamba's attention position; and
   in fp32 at one rank's share of the mesh train step, B 4, S 128, and of
   the sharded prefill, B 2, S 128, each 8 of qwen3-1.7b's query heads
   and 4 KV heads);
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
5. decide — the adaptive-serving example (the 499.06 ms crossover and the
   three traffic shapes) and the deployment planner at the paper's
   operating point, held to the reference values 499.0607 ms and 12.4108×;
6. duty-cycle example — ``repro_torch.examples.duty_cycle_serving`` on the
   card at the reduced width, with its asserts and its flash launches
   counted;
7. serving — full-width qwen3-1.7b under the duty-cycle controller with the
   On-Off, Idle-Waiting and auto strategies, through
   ``launch.serve.build_demo``, held to the duty-cycle example's ordering
   (at full width 0.5 s lies below the crossover: the reference example's
   asserts); the launch counts show that bring-up went through the dequant
   kernel and prefill through the flash-attention kernel; then
   ``run_process_schedule`` with Poisson arrivals under Idle-Waiting on the
   same checkpoint, the engine already up (its offsets held to the
   process's arrival times, each request served on time); the output is
   checked against the plain path;
8. multi-tenant — ``repro_torch.examples.multi_tenant_serving`` on the card
   at the reduced width; then two full-width tenants, qwen3-1.7b (the
   serving phase's checkpoint) and yi-6b cut to 2 layers (a checkpoint of
   its own), under a budget that holds the larger alone and one that holds
   both: the example's asserts, the card's memory after every release, and
   the dequant and flash launches of every bring-up and prefill;
9. ssd — the SSD kernel (four launches a call, chunks in parallel: the
   score tile C·Bᵀ once per group on the tensor cores, with the in-chunk
   cumsums; each chunk's own state; the states passed between chunks; the
   output; for bf16 the chunk states and the output on warpgroup MMAs with
   their fp32 operand in bf16 parts) against the plain recurrent version
   at the reference test's shapes (with and without an initial state),
   across two calls, with many chunks, at the served prefill's shape, at
   jamba's 256 heads and with two and four groups, in fp32 and bf16; timed
   at the served shape, at a 2048-step prefill and at jamba's, with the
   device time split over the four kernels;
10. mamba2 serving — full-width mamba2-370m through ``build_demo`` under
   On-Off and Idle-Waiting (prompt 200: two chunks, the second ragged);
   the launch counts show 9 dequant launches per bring-up and 48 SSD
   launches per prefill; the fp32 logits of the 48 layers are checked
   against the plain path, and bf16 layer by layer;
11. train — gradients through the kernels at full width and depth: the
   training loss of qwen3-1.7b (28 layers, B 2, S 128) through the flash
   kernel and of mamba2-370m (48 layers) through the SSD kernel against the
   plain path on the same weights, in fp32 (the loss within 1e-5 relative,
   each leaf within 1e-4 of its largest entry, or twice the plain path's
   distance from a float64 run where that is larger) and bf16 (by
   ``_bf16_rule``'s terms), every leaf's gradient non-zero; launches exact:
   one a layer a forward, two a step under ``remat="full"``, one under
   ``none`` (the backward launches nothing); then ``python -m
   repro_torch.launch.train`` at full width (qwen3-1.7b 5 steps,
   mamba2-370m 3, B 8, S 128, no checkpoint directory: finite losses, s a
   step, tokens/s, peak memory, launches exact) and one step of each split
   into forward, backward and AdamW; the 100M example (``train_lm``'s twin)
   for 20 steps with its checkpoint; the reduced qwen3 resumed at step 3
   against 6 uninterrupted steps (the final loss within 1e-4);
12. dense families — yi-6b, internlm2-20b and qwen3-32b at full published
   depth and width in bf16 (random weights drawn on the card): prefill at
   batch 2, prompt 32 (eight token draws) through the kernels against the
   plain path, one flash launch a layer; the bf16 argmax on the rows a
   float64 forward (the decoder's per-position step on each layer's
   widened weights) shows bf16 can decide, at least two; in fp32 at full
   depth (yi-6b) or half depth;
13. moe families — mixtral-8x7b (22 of 32 layers in bf16, 11 in fp32) and
   qwen3-moe-235b-a22b (12 of 94, 6) at their published widths, held as
   the dense families are (the float64 forward widens one expert at a
   time), every routing flip between the two bf16 paths shown to sit on a
   near-tie; 8 greedy decode steps through ``ServingEngine.generate``; a
   mixtral request of 4608 tokens, beyond its 4096 window, and 8 decode
   steps, the ring-aligned cache checked and the logits held against the
   plain path;
14. jamba — one period of jamba-1.5-large-398b at its published widths
   (88.1 GB in bf16, more than the card), streamed: each layer drawn on the
   card, run through the per-position prefill step (SSD kernel, flash
   kernel, MoE dispatch) and freed, in fp32 and bf16, held as the dense
   families are; then the reduced jamba served through the engine;
15. frontends — hubert-xlarge (48 layers) through ``encode_fn`` on 512
   frames and llava-next-mistral-7b (32 layers) with 576 patch tokens and
   32 text tokens, then 8 decode steps, in bf16 and fp32, held as the dense
   families are;
16. moe serving — the reduced mixtral under the duty-cycle controller from
   a ``zstd+int8`` checkpoint whose 4-D expert stacks are the dequant
   kernel's first 4-D leaves (bit-exact against its plain version), the
   card's memory checked after the release;
17. sweep — ``core/batch_eval.sweep_batch`` over the full Table-1 strategy
   grid (both devices × 3 buswidths × 11 clocks × 2 compression × request
   periods 1–1000 ms × 3 idle methods × 16 budgets, 6,336,000 points) on
   the card: every field held bit for bit to the scalar oracle on 2400
   points covering every axis and to the CPU on every tenth period; the
   configuration and strategy Pareto frontiers (~10^5 points) and the
   crossover surface equal to the CPU's; the paper item's crossover
   499.0607 ms;
18. fleet — ``python -m repro_torch.launch.fleet`` (4096 devices, 10 s
   routed, round-robin, the strategy mix, the looped baseline and the N=1
   self-check) in this process; N=1 against ``simulate(mode="step")`` and
   ``simulate_trace``; the CUDA-graph tick loop against the eager one and
   the card against the CPU at 4096 devices (three routers, direct
   streams, periodic), a chunked continuation; 1,048,576 devices periodic
   at a 2 J budget until every device has died, and routed with
   power_aware at load 0.5 with requests conserved exactly; the batched
   Poisson and MMPP samplers at 10^5 streams against their moments, and
   their tick bins card against CPU; ticks/s and device-steps/s of both
   loops at both sizes;
19. optimize — descent at ``launch.optimize``'s defaults (16 starts × 250
   steps) for the minimum configuration energy and the maximum adaptive
   lifetime on both FPGA devices, held to the exhaustive sweeps and to the
   CPU's answers; the clock axis densified to 11, 101, 10,001 and
   1,000,001 points (descent against the sweep); the λ-traced frontier of
   the XC7S15 against the exact one; the budget planner on a
   1,048,576-device periodic fleet (the fleet phase's mix, 3600 s of
   requests, N × 4147 J × 0.05) under both objectives, host seconds, its
   replay through ``run_periodic`` on the card bit for bit and its
   device-steps/s; ``python -m repro_torch.launch.optimize --smoke``;
20. policy — the learned timeout policy: ``python -m
   repro_torch.launch.policy --smoke --calibrated --policy-out ...`` (``train_policy``
   at ``TrainSettings.smoke()`` on the card, the stationary limit exact,
   the nonstationary wins), its saved policy loaded back (the hard
   objective 5 % better, the flash crowd 5 % more items than the hybrid),
   a short run twice (bit for bit) and against the CPU (1e-9), the default
   sizes trained or, when the smoke time puts them above 120 s, 10 BP and
   10 ES steps timed on the card and the host and extrapolated; the
   rollout against ``simulate_trace`` (counts exact, energies 1e-9
   untrained, 1e-6 trained); 1,048,576 MMPP streams × 512 gaps
   (policy-steps/s, peak memory, 64 strided streams against the CPU, the
   ledger's conservation); then ``REQUESTS`` requests at ``PERIOD_S`` to full-width
   qwen3-1.7b under ``strategy="adaptive"`` with the trained policy, on
   the serving phase's checkpoint: 8 dequant launches a bring-up and 28
   flash launches a prefill counted, the configurations equal to what a
   fresh copy of the policy decides from the gaps and phases the
   controller measured;
21. obs — an On-Off request pair of full-width qwen3-1.7b from the serving
   phase's checkpoint with a ``MetricsRegistry`` on the engine: bring-ups,
   generate calls, tokens, releases and residency held to the
   controller's, the latency histograms' p50 and p99 printed, the dequant
   and flash launches counted; then ``python -m repro_torch.launch.obs`` at
   its defaults (256 devices, 10 s), every conservation self-check within
   1e-9 and its Chrome trace valid;
22. mc — ``python -m repro_torch.launch.mc`` at its defaults (1024 seeds,
   9 devices, 2000 steps): the zero-jitter band exactly 499.0607 ms and
   12.4108×, delta and MC within 10 %; the periodic ensemble at 1024 seeds
   × 4096 devices × 2000 steps (seeds/s, device-steps/s, peak memory), a
   strided slice of its seeds held to the CPU on the same gaps bit for
   bit; a one-seed routed ensemble held to ``run_routed``;
23. costs — ``python -m repro_torch.launch.costs`` at its defaults (every
   zoo model at batches 1 and 8, the 64-device model mix with 64 seeds,
   the golden section: Table 2's item, 499.06 ms and 12.41×) whose
   calibration section times the four kernels at the reference's pinned
   benchmark shapes against the card's ceilings; each kernel held to its
   plain version there (``launch.costs.calibration_accuracy``: dequant
   bit-exact, LSTM 1e-5, flash and the SSD in bf16 within twice the plain
   version's own distance from float64, relative to the largest output,
   the SSD also on fp32 inputs against a float64 recurrence), no kernel
   faster than its bound, each timed beside its device time, its plain
   version and the library call (SDPA, ``nn.LSTM``); the calibration's
   launches go into the ``kernels`` line;
24. control — the hierarchical control plane, no kernel: ``python -m
   repro_torch.launch.control --smoke --ticks 512 --fleet-budget-mj
   50000`` (2 × 2 × 4 devices, 2 faults, the five-policy sweep, the
   planner) on the card and on the CPU, the card's payload equal to the
   CPU's (counts exact, energies and latencies bit for bit, the same
   frontier and plan) and both self-checks held; the wide
   topology's copy at 512 devices a rack and 512 ticks, card against
   CPU bit for bit; one 64-tick ``run_routed`` call timed through graphs
   and eagerly, split into capture, replay and host, and the CLI's
   default day sim estimated from it (run only below 120 s); 2 regions ×
   8 racks × 16,384 devices (262,144) for 512 ticks (1,024 until PR 24,
   cut to make room for the mesh phase) with the crossover
   autoscaler, 4 faults, pack routing and the idle tail: requests
   conserved at every level, energy within 1e-9, its power events and
   device-ticks/s with the calls' capture, replay and host share; one
   rack of 1,048,576 devices for 512 ticks against one ``run_routed``
   call, every state field and the latency multiset equal, with peaks;
25. mesh — the multi-rank runtime, no kernel (``distributed/ranks.py``:
   ranks spawned as processes, gloo with every collective staged through
   pinned host memory, all four ranks on the one card, so each rate
   measures the runtime, not scale-out): ``python -m
   repro_torch.launch.fleet --smoke --mode periodic --mesh 4
   --acceptance-devices 1048576`` (2 J a device, the strategy mix; run in
   this process, its ranks spawned all the same): the sharded scan bit
   for bit ``run_periodic`` on the card over the same fleet and step cap,
   every budget exhausted, the ledger within 1e-9, both rates and the
   spawn time; then one spawn of four ranks: the periodic ensemble of the
   mc phase (1024 seeds × 4096 devices × 2000 steps, 64 seeds a chunk) on
   a 2 × 2 (fleet, seed) mesh bit for bit against the unsharded run on
   the card; one full-width MoE layer of qwen3-moe-235b-a22b (the
   expert-parallel body) and mixtral-8x7b (the f-sharded body), B 2, S
   64, on (data 1, model 4) in fp32 and bf16 at both capacity factors and
   on (data 2, model 2) in fp32 at capacity factor 1 (``MOE_MESH_RUNS``:
   the train step took the phase's time), each rank
   drawing only its own weight blocks: at capacity factor 64 (nothing
   dropped) against the single-card dropless ``moe_block``, at 1 (slots
   dropped, counted) against ``moe_capacity_reference`` on the card,
   within ``MOE_DISPATCH_LIMIT``, with the ranks' host and card memory
   peaks; ``compress_psum`` over (pod 2) on one qwen3-1.7b decoder
   layer's gradient tree (50.3 M fp32 values) within 0.02 of the exact
   mean and bit for bit against two CPU ranks; ``launch.mc --smoke
   --mesh 2x2``'s ensemble section equal to ``--mesh 1``'s; in the same
   spawn, the GSPMD train step (``training/train_loop.py`` on a mesh of
   ranks): (e) qwen3-1.7b at its published widths cut to 2 layers, fp32,
   B 8, S 128 from ``SyntheticLMStream``, on (data 2, model 2), remat
   full, 2 steps with ``gather_weights_once`` off and 2 with it on, the
   flash kernel on each rank's local heads (launches exact: 2 a layer a
   step a rank), held by rank 0 to the single-card step on the same
   weights and batches (loss and grad norm within 1e-5 relative, step 1's
   gathered gradients within max(1e-4, twice the plain path's distance
   from float64) of each leaf's largest entry, the parameters after step
   1 by the C-ref-9 rule), a step split into weight gather / forward /
   backward / gradient reduce / tensor-parallel sums / AdamW with the bytes
   each rank stages through the host, the ranks' memory peaks; (f) the
   compressed cross-pod step (the reduced yi-6b on (pod 2, data 1, model
   2), 3 steps at lr 1e-2) within the reference's bounds of the exact
   one and within 1e-6 of four CPU ranks; (g) the reduced qwen3 through
   ``launch.train.train(mesh=)``: 2 steps on (data 2, model 2), a
   checkpoint, 2 more on ``plan_elastic_mesh``'s (data 1, model 2),
   within 1e-4 of 4 uninterrupted steps, the checkpoint equal to a
   single-card save of the gathered state bit for bit; (h) the sharded
   prefill and decode of the dense decoders (``model_zoo.prefill_fn`` /
   ``decode_fn`` with ``mesh=``): qwen3-1.7b at its published widths cut
   to 2 layers, fp32, B 4, prompt 128, then 4 greedy decode steps on (data
   2, model 2), the flash kernel on each rank's local heads (launches
   exact: 2 a prefill a rank, none in decode), each rank's logits within
   1e-4 of the largest of one card's run on the same weights and tokens
   and its greedy tokens equal, the bytes each rank stages by tag equal to
   the roofline counter's dry count of the same cell on ``meta``; (i) the
   other families on the same kind of mesh (``_mesh_families``):
   full-width mamba2-370m (48 layers, the SSD kernel on each rank's 16
   heads, 48 launches a prefill a rank), one full-width mixtral-8x7b layer
   (the f-sharded MoE body), qwen3-1.7b with its KV cache split over
   ``model``, the reduced jamba with ``long_context`` at B 1, llava,
   hubert and qwen3-moe on (data 1, model 4), each held the same way,
   mamba2's rank 0 also to a float64 run of the plain path;
26. roofline — the cells the card ran, counted by ``launch/roofline.py``
   on ``meta`` at a 1×1 mesh: ``launch.train``'s qwen3-1.7b and
   mamba2-370m steps, the served prefill and decode step of qwen3-1.7b,
   and the sharded prefill of (h) at the gloo rate its ranks measured, each
   bound on the card's own ceilings against the time measured above (fail
   above 1); then ``python -m repro_torch.launch.dryrun --all --mesh both``
   over the 80 cells of both production meshes on ``meta`` (run in the
   mesh phase, by a process beside the ranks): every prefill and decode
   cell and the dense train cells ``ok`` (52), the other families' 12
   train cells errors naming their ROADMAP item;
27. the phases' seconds, the ``kernels`` JSON line (the flash and SSD
   entries with their ``train_launches`` and gradient checks, flash's
   ``mesh_train_launches`` and ``mesh_serve_launches``), the card
   line, and the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Any
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
PROCESS_SEED = 5                            # the process-schedule phase's arrivals
SERVE_MARGIN_S = 0.05                       # its bound on a request's wait once due and free
TENANT_YI_LAYERS = 2                        # yi-6b's depth as the second full-width tenant (two
                                            # layers keep the script inside its time limit)
CKPT_DIR_YI = ROOT / "build" / "chip_smoke_ckpt_yi6b"
DENSE = {"yi-6b": 32, "internlm2-20b": 24, "qwen3-32b": 32}   # arch → depth of the fp32 check
DENSE_DRAWS = 8                             # token draws (B 2, prompt 32) a dense model
DENSE_DECIDED = 2                           # fewest bf16-decided rows its argmax check may hold
MOE = {"mixtral-8x7b": (22, 11), "qwen3-moe-235b-a22b": (12, 6)}   # arch → depth in bf16, fp32
MOE_DISPATCH_LIMIT = {"bfloat16": 3e-2, "float32": 1e-5}   # grouped dispatch vs dense oracle, one layer
MOE_WINDOW_PROMPT = 4608                    # mixtral's request beyond its 4096 window
CKPT_DIR_MOE = ROOT / "build" / "chip_smoke_ckpt_mixtral"
JAMBA = "jamba-1.5-large-398b"
HUBERT, LLAVA = "hubert-xlarge", "llava-next-mistral-7b"
HUBERT_FRAMES = 512                         # frames of each of hubert's two inputs
AFTER_RELEASE_GB = 0.07                     # the card's memory once a model's weights are dropped
GRAPH_WARM = 70                             # ticks of the 1M routed warm-up run
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
        (2, 32, 32, 32, 4, 128, True, 0, 0, "yi-6b prefill, GQA group 8"),
        (2, 32, 32, 48, 8, 128, True, 0, 0, "internlm2-20b prefill, GQA group 6"),
        (2, 32, 32, 64, 8, 128, True, 0, 0, "qwen3-32b prefill, GQA group 8"),
        (1, 100, 100, 48, 8, 128, True, 0, 0, "GQA group 6, ragged"),
        (1, 2048, 2048, 64, 8, 128, True, 0, 0, "GQA group 8 at S 2048"),
        # the MoE, hybrid and frontend families' prefills
        (2, 32, 32, 64, 4, 128, True, 0, 0, "qwen3-moe prefill, GQA group 16"),
        (1, 100, 100, 64, 4, 128, True, 0, 0, "GQA group 16, ragged"),
        (2, 32, 32, 32, 8, 128, True, 4096, 0, "mixtral prefill, window 4096"),
        (1, MOE_WINDOW_PROMPT, MOE_WINDOW_PROMPT, 32, 8, 128, True, 4096, 0,
         "mixtral prefill beyond its window"),
        (1, 8192, 8192, 32, 8, 128, True, 4096, 0, "window 4096 at S 8192 prefill"),
        (2, HUBERT_FRAMES, HUBERT_FRAMES, 16, 16, 80, False, 0, 0, "hubert prefill, D 80 bidirectional"),
        (2, 608, 608, 32, 8, 128, True, 0, 0, "llava prefill, 576 patches + 32 tokens"),
        (2, 32, 32, 64, 8, 128, True, 0, 0, "jamba prefill, GQA group 8"),
        (TRAIN_CLI_BATCH, TRAIN_CLI_SEQ, TRAIN_CLI_SEQ, 16, 8, 128, True, 0, 0,
         "training prefill of launch.train's qwen3-1.7b"),
        (MESH_TRAIN_TOKENS[0] // MESH_TRAIN_SHAPE[0], MESH_TRAIN_TOKENS[1], MESH_TRAIN_TOKENS[1],
         16 // MESH_TRAIN_SHAPE[1], 8 // MESH_TRAIN_SHAPE[1], 128, True, 0, 0,
         "mesh training prefill: a rank's rows and heads of qwen3-1.7b"),
        (MESH_SERVE_TOKENS[0] // MESH_TRAIN_SHAPE[0], MESH_SERVE_TOKENS[1], MESH_SERVE_TOKENS[1],
         16 // MESH_TRAIN_SHAPE[1], 8 // MESH_TRAIN_SHAPE[1], 128, True, 0, 0,
         "mesh serving prefill: a rank's rows and heads of qwen3-1.7b"),
        (MESH_FAMILY_CASES["mixtral-8x7b, 1 layer"][5] // 2, MESH_FAMILY_CASES["mixtral-8x7b, 1 layer"][6],
         MESH_FAMILY_CASES["mixtral-8x7b, 1 layer"][6], 32 // 2, 8 // 2, 128, True, 4096, 0,
         "mesh serving prefill: a rank's rows and heads of mixtral-8x7b"),
    ]
    new_families = {"qwen3-moe", "mixtral", "window", "hubert", "llava", "jamba"}
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
                # a window needs an explicit mask, which takes SDPA off its
                # flash backend (to the memory-efficient or math one)
                mask = None
                if window:
                    qpos = torch.arange(sq, device="cuda")[:, None] + q_offset
                    kpos = torch.arange(sk, device="cuda")[None, :]
                    mask = (kpos <= qpos) & (kpos > qpos - window)

                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          is_causal=causal and mask is None, enable_gqa=True)

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
                if label.startswith("mesh") and not bf16:     # the mesh steps run in fp32
                    win = f", window {window}" if window else ""
                    timed[f"{label}, fp32"] = {"shape": f"B={b}, S={sq}, H={h}, KVH={kvh}, D={d}, causal{win}, fp32",
                                    "tflops": n_ops / k_ms / 1e9, "max_abs_err": err, "ms": k_ms,
                                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms}
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
                        mask_name = ("causal" if causal else "bidirectional") + (f", window {window}" if window else "")
                        timed[label] = {"shape": f"B={b}, S={sq}, H={h}, KVH={kvh}, D={d}, {mask_name}, bf16",
                                        "tflops": n_ops / k_ms / 1e9, **row}
                        if window:
                            timed[label]["library"] = "sdpa with an explicit window mask (not its flash backend)"
                line += f" [{card}]"
            print(line)
    entry["long_prefill"] = timed["long prefill"]
    entry["reduced_prefill"] = timed["reduced qwen3 prefill"]
    entry["training_prefill"] = timed["training prefill of launch.train's qwen3-1.7b"]
    entry["mesh_training_prefill"] = timed["mesh training prefill: a rank's rows and heads of qwen3-1.7b, fp32"]
    entry["mesh_serving_prefill"] = timed["mesh serving prefill: a rank's rows and heads of qwen3-1.7b, fp32"]
    entry["mesh_moe_serving_prefill"] = timed["mesh serving prefill: a rank's rows and heads of mixtral-8x7b, fp32"]
    entry["dense_prefills"] = {label.split()[0]: row for label, row in timed.items()
                               if label.split()[0] in DENSE}
    entry["new_family_prefills"] = {label: row for label, row in timed.items()
                                    if label.split()[0] in new_families}
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
# Phase 5: decide, and Phase 6: the duty-cycle example
# ---------------------------------------------------------------------------
def decide_phase() -> None:
    """The adaptive-serving example and the planner at the paper's operating
    point (40 ms, methods 1+2), against the reference values."""
    from repro_torch.core import energy_model as em
    from repro_torch.core import planner
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.examples import adaptive_serving

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = adaptive_serving.main()
    lines = buf.getvalue().splitlines()
    print("\n".join(f"  {line}" for line in lines))
    check(lines[0] == "analytical crossover: 499.06 ms (paper: 499.06 ms)", "adaptive_serving's first line")
    check(round(out["crossover_ms"], 4) == 499.0607, f"crossover {out['crossover_ms']!r} != 499.0607 ms")
    item, cal = paper_lstm_item(), em.CALIBRATED_POWERUP_OVERHEAD_MJ
    plan = planner.plan(item, 40.0, target_lifetime_h=45.0, powerup_overhead_mj=cal)
    ratio = plan.lifetime_h / em.evaluate_onoff(item, 40.0, powerup_overhead_mj=cal).lifetime_hours
    print(f"  planner at 40 ms, 45 h target: {plan.strategy}, {plan.method}, {plan.n_items} items, "
          f"{plan.lifetime_h:.4f} h, lifetime {ratio:.4f}x On-Off's, idle power needed "
          f"{plan.required_idle_power_mw:.4f} mW")
    check(plan.strategy == "idle_waiting" and plan.method == "method1+2", f"planner chose {plan}")
    check(round(ratio, 4) == 12.4108, f"lifetime ratio {ratio!r} != 12.4108")


def duty_cycle_example_phase(card: str) -> int:
    """``duty_cycle_serving`` on the card at the reduced width, with its
    asserts → its flash launches (two a prefill: one per layer)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import duty_cycle_serving
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa

    layers = get_config(duty_cycle_serving.ARCH, reduced=True).num_layers
    dq.launches = 0
    fa.launches = 0
    out = duty_cycle_serving.main([])
    n_fa, n_dq = fa.launches, dq.launches
    prefills = sum(out[k].n_requests + out[k].n_configurations for k in ("on_off", "idle_waiting", "auto"))
    print(f"  flash launches {n_fa} ({layers} a prefill, {prefills} prefills), dequant launches {n_dq} "
          f"(the reduced leaves are below the quantization floor) [{card}]")
    check(n_fa == layers * prefills, f"duty-cycle example: {n_fa} flash launches for {prefills} prefills")
    check(n_dq == 0, f"duty-cycle example: {n_dq} dequant launches")
    return n_fa


# ---------------------------------------------------------------------------
# Phase 7: serving
# ---------------------------------------------------------------------------
def output_check(restored: dict) -> None:
    """The kernel path against the plain path on the same weights: a small
    fp32 model, and the full-width model in fp32 and in bf16 (``restored``:
    the serving checkpoint's weights, restored onto the card).  The plain
    path is the same prefill with the flash-attention wrapper swapped for
    its plain version inside this function only.  fp32 is held to 1e-4 of
    the largest logit; bf16, whose roundings of the two paths drift apart
    over 28 layers of random weights, to equal argmax and 3e-2 of the
    largest logit (the readings are in PERF.md)."""
    import torch

    from repro_torch.checkpoint.serializer import flatten, unflatten_like
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.models import attention
    from repro_torch.models import model_zoo as zoo

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
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    p32 = unflatten_like(restored, [t.float() for _, t in flatten(restored)])
    for name, params in (("bf16", restored), ("fp32", p32)):
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


def configuration_split(card: str, arch: str = ARCH, ckpt_dir: Path = CKPT_DIR) -> dict:
    """Where one bring-up's time goes: file read, msgpack unpack, inflate
    by the blob's codec (on the reader's threads, as the restore inflates),
    and the rest
    of a restore onto the card (host-to-device copies and the dequant
    kernels) → the restored weights, as a bring-up holds them."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch.checkpoint import _msgpack, serializer
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo

    path = sorted(ckpt_dir.glob("step_*.ckpt"))[-1]
    t0 = time.perf_counter()
    data = path.read_bytes()
    t1 = time.perf_counter()
    payload = _msgpack.unpackb(data)
    t2 = time.perf_counter()
    codec = payload["codec"]
    blobs = [b for record in payload["leaves"]
             for b in ([record["quant"]["q"], record["quant"]["scales"]] if "quant" in record else [record["data"]])]
    with ThreadPoolExecutor(serializer._ZLIB_THREADS) as pool:
        n_raw = sum(len(raw) for raw in serializer._inflated(pool, payload["codec"], blobs))
    t3 = time.perf_counter()
    del payload
    params = serializer.deserialize(data, zoo.param_shapes(get_config(arch)), device="cuda")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    rest = (t4 - t3) - (t2 - t1) - (t3 - t2)
    print(f"  {arch} configuration split ({len(data) / 1e9:.3f} GB file, {n_raw / 1e9:.3f} GB inflated; codec "
          f"{codec}: 'zstandard' {'installed' if serializer.HAVE_ZSTD else 'not installed'} on this host): "
          f"read {t1 - t0:.3f} s, msgpack unpack {t2 - t1:.3f} s, {codec} inflate on "
          f"{serializer._ZLIB_THREADS} threads {t3 - t2:.3f} s, "
          f"restore onto the card {t4 - t3:.3f} s of which copies + dequant + other "
          f"{rest:.3f} s; restore s by codec {({codec: round(t4 - t3, 3)})} [{card}]")
    return params


def serving_phase(card: str) -> tuple[int, int]:
    """Full-width qwen3-1.7b from its zstd+int8 checkpoint, ``REQUESTS``
    requests at ``PERIOD_S`` under On-Off, Idle-Waiting and auto, held to
    the duty-cycle example's ordering: at full width the bring-up is
    seconds, so 0.5 s lies below the crossover and the reference example's
    asserts apply (Idle-Waiting wins, ``auto`` at most 2 configurations)
    → (dequant, flash launches)."""
    import torch

    from repro_torch.core.phases import CONFIGURATION, INFERENCE
    from repro_torch.examples import duty_cycle_serving
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import build_demo
    from repro_torch.serving.scheduler import run_schedule

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    cfg_layers = 28
    results, controllers = {}, {}
    launches = {"dequant": 0, "flash": 0}
    for strategy in ("on_off", "idle_waiting", "auto"):
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
        if controller.handle is not None:     # idle-waiting and auto keep it resident
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
        results[strategy], controllers[strategy] = res, controller
    oo, iw, auto = (results[k] for k in ("on_off", "idle_waiting", "auto"))
    cross, oo_shared, iw_shared = duty_cycle_serving.shared_results(
        {k: (results[k], controllers[k]) for k in ("on_off", "idle_waiting")})
    print(f"  energy ratio On-Off / Idle-Waiting: {oo.energy_mj / iw.energy_mj:.4f} live, "
          f"{oo_shared.energy_mj / iw_shared.energy_mj:.4f} at the shared median phases, median "
          f"measured crossover {cross:.1f} ms")
    side = duty_cycle_serving.check_ordering(PERIOD_S, cross, oo_shared, iw_shared, auto)
    check(side == "below", f"{PERIOD_S} s lies {side} the full-width crossover of {cross:.1f} ms")
    output_check(configuration_split(card))
    torch.cuda.empty_cache()
    n_dq, n_fa = process_schedule(card)
    launches["dequant"] += n_dq
    launches["flash"] += n_fa
    return launches["dequant"], launches["flash"]


def process_schedule(card: str) -> tuple[int, int]:
    """``run_process_schedule`` with Poisson arrivals (mean 500 ms) under
    Idle-Waiting on the serving phase's checkpoint, the engine brought up
    by one request before the schedule starts: the offsets it waits for
    are the process's arrival times in seconds, and each request is served
    no earlier than its offset and within ``SERVE_MARGIN_S`` of the later
    of its offset and the previous request's end; one bring-up →
    (dequant, flash launches)."""
    import torch

    from repro_torch.core.arrivals import PoissonArrivals
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import build_demo
    from repro_torch.serving import scheduler

    process = PoissonArrivals(500.0)
    controller, make_request = build_demo(
        ARCH, reduced=False, device="cuda", ckpt_dir=str(CKPT_DIR), strategy="idle_waiting"
    )
    requests = [make_request() for _ in range(REQUESTS + 1)]
    seen = {}
    inner = scheduler.run_arrival_schedule

    def recording(controller, requests, offsets, sleep, clock):
        seen["offsets"] = list(offsets)
        seen["t0"] = clock()
        return inner(controller, requests, seen["offsets"], sleep, clock)

    served, done = [], []
    infer = controller.infer_fn

    def timed_infer(handle, x):
        served.append(time.perf_counter())
        out = infer(handle, x)
        done.append(time.perf_counter())
        return out

    controller.infer_fn = timed_infer
    dq.launches = 0
    fa.launches = 0
    t0 = time.perf_counter()
    controller.submit(requests[0])                 # brings the engine up
    up_s = time.perf_counter() - t0
    with mock.patch.object(scheduler, "run_arrival_schedule", recording):
        res = scheduler.run_process_schedule(controller, iter(requests[1:]), process, seed=PROCESS_SEED)
    n_dq, n_fa = dq.launches, fa.launches
    controller.release_fn(controller.handle)
    controller.handle = None
    torch.cuda.synchronize()
    want = [float(t) / 1000.0 for t in process.arrival_times(REQUESTS, PROCESS_SEED)]
    due = [seen["t0"] + o for o in want]
    late = [t - d for t, d in zip(served[1:], due)]
    wait = [t - max(d, prev) for t, d, prev in zip(served[1:], due, done)]
    print(f"  process schedule (Poisson, mean 500 ms, seed {PROCESS_SEED}), idle_waiting, brought up by "
          f"one request in {up_s:.3f} s: offsets {[float(o) for o in seen['offsets']]} s (arrival_times / "
          f"1000: {want}), served {[round(x, 4) for x in late]} s after them and "
          f"{[round(x, 4) for x in wait]} s after the later of the offset and the previous request's end, "
          f"inference s {[round(e - b, 4) for b, e in zip(served, done)]}, {res.n_requests} requests, "
          f"{res.n_configurations} configurations, energy {res.energy_mj:.1f} mJ, wall {res.wall_s:.3f} s; "
          f"dequant launches {n_dq}, flash launches {n_fa} [{card}]")
    check(seen["offsets"] == want, "run_process_schedule's offsets differ from arrival_times / 1000")
    check(res.n_requests == REQUESTS and res.n_configurations == 1, f"process schedule: {res}")
    check(len(served) == REQUESTS + 1 and min(late) >= 0.0, f"a request was served before its offset: {late}")
    check(max(wait) <= SERVE_MARGIN_S, f"a request was served more than {SERVE_MARGIN_S} s late: {wait}")
    check(n_dq == 8 and n_fa == 28 * (REQUESTS + 2),
          f"process schedule: {n_dq} dequant and {n_fa} flash launches for one bring-up and "
          f"{REQUESTS + 1} requests")
    return n_dq, n_fa


# ---------------------------------------------------------------------------
# Phase 8: multi-tenant serving
# ---------------------------------------------------------------------------
def multi_tenant_example(card: str) -> int:
    """``multi_tenant_serving`` on the card at the reduced width, with its
    asserts → its flash launches (two a prefill)."""
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.examples import multi_tenant_serving

    dq.launches = 0
    fa.launches = 0
    s1, s2, timeouts = multi_tenant_serving.main([])
    n_fa, n_dq = fa.launches, dq.launches
    prefills = s1["configurations"] + s2["configurations"] + 2 * multi_tenant_serving.N_REQUESTS
    print(f"  reduced: break-even releases {timeouts}, flash launches {n_fa} (2 a prefill, {prefills} "
          f"prefills), dequant launches {n_dq} (zstd checkpoints) [{card}]")
    check(n_fa == 2 * prefills and n_dq == 0,
          f"multi-tenant example: {n_fa} flash and {n_dq} dequant launches for {prefills} prefills")
    return n_fa


def multi_tenant_full_width(card: str) -> tuple[int, int]:
    """Two full-width tenants on the card: qwen3-1.7b from the serving
    phase's zstd+int8 checkpoint and yi-6b cut to 2 layers from a checkpoint
    of its own, each with its bf16 weight bytes as its footprint, under a
    budget that holds the larger alone and one that holds both.  The
    example's asserts hold, exactly two bring-ups under the roomy budget;
    after every release the card holds no more than the resident tenants'
    weights and 0.5 GB; every bring-up launches one dequant per quantized
    leaf and every prefill (the bring-up's warm-up and each request's) one
    flash a layer → (dequant, flash launches)."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.serializer import _should_quantize, flatten
    from repro_torch.configs import get_config
    from repro_torch.examples.multi_tenant_serving import N_REQUESTS, live_tenant, serve_alternating
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import model_zoo as zoo

    cfgs = {ARCH: get_config(ARCH),
            "yi-6b": dataclasses.replace(get_config("yi-6b"), num_layers=TENANT_YI_LAYERS)}
    shutil.rmtree(CKPT_DIR_YI, ignore_errors=True)
    t0 = time.perf_counter()
    params = zoo.init_params(cfgs["yi-6b"], torch.Generator("cuda").manual_seed(0))
    CheckpointManager(str(CKPT_DIR_YI), mode="zstd+int8").save(0, params)
    del params
    torch.cuda.empty_cache()
    print(f"  yi-6b at {TENANT_YI_LAYERS} layers: checkpoint written in {time.perf_counter() - t0:.3f} s "
          f"({sum(f.stat().st_size for f in CKPT_DIR_YI.iterdir()) / 1e9:.3f} GB)")
    managers = {ARCH: CheckpointManager(str(CKPT_DIR)), "yi-6b": CheckpointManager(str(CKPT_DIR_YI))}
    shapes = {name: flatten(zoo.param_shapes(cfg)) for name, cfg in cfgs.items()}
    weight_bytes = {name: sum(t.numel() * t.element_size() for _, t in leaves)
                    for name, leaves in shapes.items()}
    leaves = {name: sum(_should_quantize(t) for _, t in ls) for name, ls in shapes.items()}
    big, small = sorted(weight_bytes.values(), reverse=True)
    tight_gb, roomy_gb = (big + small / 2) / 1e9, (big + small) / 1e9 + 1.0
    log = {"bring_up_s": {n: [] for n in cfgs}, "prefill_s": {n: [] for n in cfgs},
           "after_release_gb": []}

    def make_tenants():
        tenants = []

        def watch(name, cfg):
            def bring_up():
                d0, f0, c0 = dq.launches, fa.launches, time.perf_counter()
                engine = inner_bring_up()
                log["bring_up_s"][name].append(time.perf_counter() - c0)
                got = engine.param_bytes()
                check(got == weight_bytes[name], f"{name}: {got} weight bytes, not {weight_bytes[name]}")
                check(dq.launches - d0 == leaves[name] and fa.launches - f0 == cfg.num_layers,
                      f"{name} bring-up: {dq.launches - d0} dequant, {fa.launches - f0} flash launches")
                return engine

            def infer(engine, x):
                d0, f0 = dq.launches, fa.launches
                out = inner_infer(engine, x)
                log["prefill_s"][name].append(out.prefill_s)
                check(dq.launches == d0 and fa.launches - f0 == cfg.num_layers,
                      f"{name} request: {dq.launches - d0} dequant, {fa.launches - f0} flash launches")
                return out

            def release(engine):
                inner_release(engine)
                torch.cuda.synchronize()
                held = sum(weight_bytes[t.name] for t in tenants
                           if t.handle is not None and t.handle is not engine)
                after = torch.cuda.memory_allocated()
                log["after_release_gb"].append(after / 1e9)
                check(after <= held + 0.5e9, f"after releasing {name}: {after} bytes allocated, "
                                             f"{held} held by the resident tenants")

            t = live_tenant(cfg, managers[name], weight_bytes[name] / 1e9, "cuda")
            inner_bring_up, inner_infer, inner_release = t.bring_up, t.infer, t.release
            t.bring_up, t.infer, t.release = bring_up, infer, release
            return t

        for name, cfg in cfgs.items():
            tenants.append(watch(name, cfg))
        return tenants

    torch.cuda.reset_peak_memory_stats()
    dq.launches = 0
    fa.launches = 0
    s1, s2, timeouts = serve_alternating(make_tenants, tight_gb, roomy_gb)
    n_dq, n_fa = dq.launches, fa.launches
    peak = torch.cuda.max_memory_allocated()
    configs = s1["configurations"] + s2["configurations"]
    print(f"  full width: weight bytes {weight_bytes} (dequant leaves {leaves}); budgets "
          f"{tight_gb:.3f} / {roomy_gb:.3f} GB; tight: {s1['configurations']} configurations, "
          f"{s1['evictions']} evictions, {s1['energy_mj']:.1f} mJ; roomy: {s2['configurations']} "
          f"configurations, {s2['evictions']} evictions, {s2['energy_mj']:.1f} mJ, break-even releases "
          f"{timeouts}")
    print(f"  full width: bring-up s {log['bring_up_s']}; prefill s (requests) {log['prefill_s']}")
    print(f"  full width: dequant launches {n_dq}, flash launches {n_fa} over {configs} bring-ups and "
          f"{2 * N_REQUESTS} requests; max_memory_allocated {peak / 1e9:.3f} GB, memory_allocated after each release "
          f"{[round(x, 6) for x in log['after_release_gb']]} GB [{card}]")
    check(timeouts == 0 and s2["configurations"] == 2,
          f"full width: {s2['configurations']} bring-ups under the roomy budget, {timeouts} break-even releases")
    shutil.rmtree(CKPT_DIR_YI, ignore_errors=True)
    return n_dq, n_fa


# ---------------------------------------------------------------------------
# Phase 9: the SSD kernel
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


def _ssd_timed(label, b, s, h, p, g, n, q, card, dtype: str = "bfloat16") -> dict:
    """Kernel, its CUDA-graph device time and the plain chunked version at
    one shape in bf16 (or fp32, as a mesh rank serves), beside the bound;
    the kernel held to the recurrent oracle on the same inputs (bf16:
    within one ulp; fp32: the reference test's tolerances)."""
    import torch

    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_recurrent_reference

    args, _ = _ssd_inputs(b, s, h, p, g, n, seed=21, a_minus_one=True)
    bf16 = dtype == "bfloat16"
    bargs = _bf16(args) if bf16 else args
    y, st = so.ssd_cuda(*bargs, chunk=q)
    fy, fst = ssd_recurrent_reference(*(t.float() for t in bargs))
    torch.cuda.synchronize()
    ey, es = float((y.float() - fy).abs().max()), float((st - fst).abs().max())
    close = _within_bf16_ulp(y, fy) if bf16 else ey <= SSD_TOL["y"]
    check(close and es <= SSD_TOL["state"], f"ssd {label} {dtype}: y err {ey:.3g}, state err {es:.3g}")
    k_ms = time_ms(lambda: so.ssd_cuda(*bargs, chunk=q))
    k_dev = graph_ms(lambda: so.ssd_cuda(*bargs, chunk=q))
    # each of the four kernels alone, on the scratch of one whole call
    call = so.prepare(*bargs, chunk=q)
    so.launch_stages(call, so.ALL_STAGES)
    stages = {name: graph_ms(lambda: so.launch_stages(call, 1 << k))
              for k, name in enumerate(SSD_STAGES)}
    p_ms = time_ms(lambda: ssd_chunked(*bargs, chunk=q))
    n_bytes, n_ops = _ssd_work(b, s, h, p, g, n, q, 2 if bf16 else 4, False)
    b_ms, b_by = bound_ms(n_bytes, n_ops, dtype)
    floor = n_ops / PEAK_OPS["float32"] * 1e3
    print(f"  ssd {label} B {b}, S {s}, H {h}, P {p}, G {g}, N {n}, chunk {q}, {dtype}: max_abs_err "
          f"y {ey:.3g} ({'within one bf16 ulp' if bf16 else 'limit ' + str(SSD_TOL['y'])}), state {es:.3g}; "
          f"kernel {k_ms:.4f} ms a call "
          f"({k_dev:.4f} ms of device time, CUDA graph), plain {p_ms:.4f} ms, library none "
          f"exists, bound {b_ms:.5f} ms by {b_by} ({n_ops / 1e9:.4f} GFLOP at {PEAK_OPS[dtype] / 1e12:g} "
          f"TFLOP/s, {n_bytes / 1e6:.3f} MB at 3.35 TB/s); fp32 CUDA-core floor {floor:.5f} ms "
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
    # jamba's mixer: 256 heads, its prompt of 32 padded to one chunk
    args, init = _ssd_inputs(2, 128, 256, 64, 1, 128, seed=14, a_minus_one=True)
    _ssd_case("jamba prefill (2, 128, 256, 64, 1, 128) chunk 128, a = -1", args, init, 128)

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
    jamba = _ssd_timed("jamba prefill", 2, 128, 256, 64, 1, 128, 128, card)
    train = _ssd_timed("training prefill of launch.train's mamba2-370m", TRAIN_CLI_BATCH, TRAIN_CLI_SEQ,
                       32, 64, 1, 128, 128, card)
    # the mesh phase's (i): a rank's 2 rows and 16 of 32 heads of mamba2-370m, fp32
    mesh = _ssd_timed("mesh serving prefill: a rank's rows and heads of mamba2-370m", 2, 256, 16, 64, 1, 128, 128,
                      card, "float32")
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
        "at_jamba_prefill": jamba,
        "at_training_prefill": train,
        "at_mesh_serving_prefill": mesh,
        "per": "launch (prefill: B=2, S=200 padded to 256, H=32, P=64, G=1, N=128, chunk 128, bf16)",
    }


# ---------------------------------------------------------------------------
# Phase 10: mamba2-370m serving
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
    torch.cuda.empty_cache()
    mamba2_output_check(card)
    shutil.rmtree(CKPT_DIR_MAMBA, ignore_errors=True)
    return launches["dequant"], launches["ssd"]


# ---------------------------------------------------------------------------
# Phase 11: training (launch.train) through the flash and SSD kernels
# ---------------------------------------------------------------------------
TRAIN_GRAD_BATCH, TRAIN_GRAD_SEQ = 2, 128   # the full-depth gradient checks
TRAIN_LOSS_LIMIT, TRAIN_GRAD_LIMIT = 1e-5, 1e-4   # fp32, relative to the loss and each leaf's largest entry
TRAIN_BF16_LIMIT = 3e-2                     # bf16: _bf16_rule's floor
TRAIN_BF16_CAP = 0.1                        # bf16: the largest limit float64 still decides (a plain
                                            # path twice as far from it would pass a wrong kernel)
TRAIN_CLI_STEPS = {ARCH: 5, MAMBA: 3}       # launch.train at full width, B 8, S 128
TRAIN_CLI_BATCH, TRAIN_CLI_SEQ = 8, 128
TRAIN_LM_STEPS = 20                         # the 100M example: one checkpoint, the loop's last (a
                                            # --ckpt-every above the steps; each write ~12 s of zlib)
TRAIN_LM_DIR = ROOT / "build" / "chip_smoke_train_lm"
TRAIN_RESUME_DIR = ROOT / "build" / "chip_smoke_train_resume"


def _kernel_ops(cfg):
    """The wrapper module of the kernel the model's mixer layers run, and
    the number of those layers."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as so

    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    return (fa, n_attn) if n_attn else (so, cfg.num_layers)


def _loss_and_grads(cfg, params, batch, ops, perf=None, plain=False):
    """The training loss and every leaf's gradient → (loss, {path: grad},
    launches in the forward, launches in forward and backward)."""
    import torch

    from repro_torch.configs.perf import BASELINE
    from repro_torch.models import model_zoo as zoo
    from repro_torch.tree import paths

    leaves = paths(params)
    for p in leaves.values():
        p.requires_grad_(True)
    ops.launches = 0
    with plain_path() if plain else contextlib.nullcontext():
        loss = zoo.loss_fn(params, batch, cfg, perf or BASELINE)
        fwd = ops.launches
        grads = torch.autograd.grad(loss, list(leaves.values()))
    for p in leaves.values():
        p.requires_grad_(False)
    return loss.detach(), dict(zip(leaves, grads)), fwd, ops.launches


def _period_grads(pp, x, d_out, cfg, plain: bool):
    """One period's output and the gradients of ⟨output, ``d_out``⟩ with
    respect to its input (``"input"``) and every leaf → {name: tensor}."""
    import torch

    from repro_torch.configs.perf import BASELINE
    from repro_torch.models import decoder
    from repro_torch.tree import paths, unflatten_like

    leaves = {k: t.detach().requires_grad_(True) for k, t in paths(pp).items()}
    x = x.detach().requires_grad_(True)
    with plain_path() if plain else contextlib.nullcontext():
        out, _ = decoder._period_forward(unflatten_like(pp, leaves.values()), x,
                                         torch.zeros((), device=x.device), cfg, BASELINE)
        grads = torch.autograd.grad(out, [x, *leaves.values()], d_out)
    return {"output": out.detach(), **dict(zip(["input", *leaves], grads))}


def _layer_check(cfg, p64, p16, batch, ops, name: str, card: str) -> dict:
    """bf16 gradients a layer at a time.  A float64 run of the plain path
    gives every period's input and the loss's gradient at its output; each
    period then runs alone from those, in bf16 through the kernel and on
    the plain path, and in float64.  Per period, its output and the
    gradients of its input and of each leaf, each by the norm of a
    difference over the float64 one's norm (a leaf's largest entry is too
    few sums to decide: conv_w's lay 5 % from float64 on the plain path):
    kernel vs plain within max(3e-2, twice the plain path's distance from
    float64); that limit at most ``TRAIN_BF16_CAP`` (else float64 decides
    nothing); and the kernel no further from float64 than 1.5 times the
    plain path, by the norm over the period.  Through many random layers
    bf16 rounding grows from layer to layer on both paths, so the whole
    model's bf16 gradient cannot hold a kernel (PERF.md); one period from
    exact inputs can."""
    import torch

    from repro_torch.configs.perf import PerfConfig
    from repro_torch.models import decoder
    from repro_torch.models import model_zoo as zoo
    from repro_torch.tree import paths

    real, record = decoder._period_forward, []

    def recording(pp, x, aux, *rest):
        out = real(pp, x, aux, *rest)
        record.append((x, out[0]))
        return out

    leaves = list(paths(p64).values())
    for t in leaves:
        t.requires_grad_(True)
    with mock.patch.object(decoder, "_period_forward", recording), plain_path():
        loss = zoo.loss_fn(p64, batch, cfg, PerfConfig(remat="none"))
        d_outs = torch.autograd.grad(loss, [out for _, out in record])
    for t in leaves:
        t.requires_grad_(False)
    periods, record = [(x.detach(), out.detach()) for x, out in record], []
    with mock.patch.object(decoder, "_period_forward", recording), plain_path(), torch.no_grad():
        zoo.loss_fn(p16, batch, cfg)            # bf16 through the whole depth: its residual's drift
    drift = [float((out.double() - ref).norm() / ref.norm()) for (_, out), (_, ref) in zip(record, periods)]
    worst = {"kernel_plain": 0.0, "plain_f64": 0.0, "kernel_f64_norm": 0.0, "plain_f64_norm": 0.0}
    by_period = []
    ops.launches = 0
    for i, ((x, _), d_out) in enumerate(zip(periods, d_outs)):
        ref = _period_grads(decoder._layer(p64["periods"], i), x, d_out, cfg, plain=True)
        l16, x16, d16 = decoder._layer(p16["periods"], i), x.to(torch.bfloat16), d_out.to(torch.bfloat16)
        ker = _period_grads(l16, x16, d16, cfg, plain=False)
        pla = _period_grads(l16, x16, d16, cfg, plain=True)
        scale = {k: float(r.norm()) for k, r in ref.items()}
        e_kp = {k: float((ker[k].double() - pla[k].double()).norm()) / scale[k] for k in ref}
        e_p = {k: float((pla[k].double() - ref[k]).norm()) / scale[k] for k in ref}
        norm = math.sqrt(sum(float(r.square().sum()) for r in ref.values()))
        n_k, n_p = (math.sqrt(sum(float((y[k].double() - ref[k]).square().sum()) for k in ref)) / norm
                    for y in (ker, pla))
        for k in ref:
            bound = max(TRAIN_BF16_LIMIT, 2 * e_p[k])
            check(bound <= TRAIN_BF16_CAP,
                  f"{name} layer {i} bf16 {k}: the plain path lies {e_p[k]:.3g} from float64, so float64 "
                  f"decides no limit up to {TRAIN_BF16_CAP}")
            check(e_kp[k] <= bound, f"{name} layer {i} bf16 {k}: kernel vs plain {e_kp[k]:.3g}, limit {bound:.3g}")
        check(n_k <= 1.5 * n_p, f"{name} layer {i} bf16: kernel {n_k:.3g} from float64 by norm, plain {n_p:.3g}")
        for key, v in (("kernel_plain", max(e_kp.values())), ("plain_f64", max(e_p.values())),
                       ("kernel_f64_norm", n_k), ("plain_f64_norm", n_p)):
            worst[key] = max(worst[key], v)
        by_period.append(n_p)
    check(ops.launches == len(periods), f"{name} layer check: {ops.launches} launches for {len(periods)} periods")
    depths = sorted({d for d in (1, 2, 4, 8, 16, 32, len(drift)) if d <= len(drift)})
    print(f"  {name} bf16 a layer at a time ({len(periods)} periods, each from the float64 run's input and "
          f"output gradient; its output and the gradients of its input and leaves, each by the norm of its "
          f"difference over the float64 one's): worst kernel vs plain {worst['kernel_plain']:.3g}, plain from float64 "
          f"{worst['plain_f64']:.3g} (limit max({TRAIN_BF16_LIMIT}, twice that), at most {TRAIN_BF16_CAP}); "
          f"by the norm over a period, from float64 kernel {worst['kernel_f64_norm']:.3g}, plain "
          f"{worst['plain_f64_norm']:.3g} (worst periods; plain by period {[round(v, 4) for v in by_period]}); "
          f"the bf16 forward's residual through the whole depth, relative distance from float64 after "
          f"{depths} periods: {[round(drift[d - 1], 4) for d in depths]} [{card}]")
    return {**worst, "residual_drift": {d: drift[d - 1] for d in depths}}


def _grad_check(arch: str, card: str) -> dict:
    """Full-width, full-depth loss and gradients through the kernel against
    the plain path on the same weights (drawn in bf16), in fp32 and bf16,
    each against a float64 run of the plain path (its norms and SSD sums
    round to fp32 inside, as the model's code does).  fp32: the loss within
    max(1e-5, twice the plain path's distance from float64) relative, each
    leaf within max(1e-4, twice that distance) of its largest entry.  bf16:
    the loss within max(3e-2, twice the plain path's distance); the
    gradients a layer at a time (``_layer_check``), and through the whole
    depth where float64 decides them (a limit of max(3e-2, twice the plain
    path's distance) at most ``TRAIN_BF16_CAP``; then the kernel no further
    than 1.5 times the plain path from float64).  Every
    leaf's gradient non-zero and finite; launches exact: one a mixer layer
    a forward, twice that a step under ``remat="full"``, and the forward's
    alone under ``remat="none"`` (the backward launches nothing)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.perf import PerfConfig
    from repro_torch.models import model_zoo as zoo
    from repro_torch.tree import paths, tree_map

    cfg = get_config(arch)
    ops, layers = _kernel_ops(cfg)
    name = "flash" if ops.__name__.endswith("flash_attention.ops") else "ssd"
    p16 = zoo.init_params(cfg, torch.Generator(DEV).manual_seed(11), torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_GRAD_BATCH, TRAIN_GRAD_SEQ), device=DEV,
                           dtype=torch.int32, generator=torch.Generator(DEV).manual_seed(12))
    batch = {"tokens": tokens, "labels": tokens}
    t0 = time.perf_counter()
    p64 = tree_map(lambda t: t.double(), p16)
    l64, g64, _, n = _loss_and_grads(cfg, p64, batch, ops, plain=True)
    check(n == 0, f"{arch}: the plain float64 path launched {n} kernels")
    report = {"layers": layers, "kernel": name,
              "bf16_by_layer": _layer_check(cfg, p64, p16, batch, ops, name, card)}
    del p64
    scale = {k: float(g.abs().max()) for k, g in g64.items()}
    for dtype, params in (("fp32", tree_map(lambda t: t.float(), p16)), ("bf16", p16)):
        lk, gk, fwd, n_step = _loss_and_grads(cfg, params, batch, ops)
        check(fwd == layers and n_step == 2 * layers,
              f"{arch} {dtype}: {fwd} {name} launches a forward and {n_step} a step, "
              f"not {layers} and {2 * layers} (remat full)")
        lp, gp, _, n = _loss_and_grads(cfg, params, batch, ops, plain=True)
        check(n == 0, f"{arch} {dtype}: the plain path launched {n} kernels")
        per_leaf = {}                          # path → (kernel vs plain, kernel vs f64, plain vs f64)
        dtypes = {k: t.dtype for k, t in paths(params).items()}
        for k, g in gk.items():
            check(g.dtype == dtypes[k] and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                  f"{arch} {dtype}: gradient of {k} is zero or not finite")
            per_leaf[k] = (float((g.float() - gp[k].float()).abs().max()) / scale[k],
                           float((g.double() - g64[k]).abs().max()) / scale[k],
                           float((gp[k].double() - g64[k]).abs().max()) / scale[k])
        (e_kp, e_k, e_p), worst = (max(v[i] for v in per_leaf.values()) for i in range(3)), \
            max(per_leaf, key=lambda k: per_leaf[k][0])
        # the whole gradient: the norm of the difference over the norm of the float64 one
        norm64 = math.sqrt(sum(float(g.square().sum()) for g in g64.values()))
        whole = [math.sqrt(sum(float((x[k].double() - y[k]).square().sum()) for k in g64)) / norm64
                 for x, y in ((gk, {k: gp[k].double() for k in gp}), (gk, g64), (gp, g64))]
        loss_kp = abs(float(lk) - float(lp)) / abs(float(l64))
        loss_p = abs(float(lp) - float(l64)) / abs(float(l64))
        floor = (TRAIN_LOSS_LIMIT, TRAIN_GRAD_LIMIT) if dtype == "fp32" else (TRAIN_BF16_LIMIT,) * 2
        b_loss, b_grad = max(floor[0], 2 * loss_p), max(floor[1], 2 * e_p)
        # bf16 through the whole depth: float64 decides only while the plain
        # path lies well inside the scale; else the layer check holds it
        decided = dtype == "fp32" or b_grad <= TRAIN_BF16_CAP
        print(f"  {arch} {dtype} (full width, {cfg.num_layers} layers, B {TRAIN_GRAD_BATCH}, S {TRAIN_GRAD_SEQ}): "
              f"loss {float(lk):.6f} kernel vs {float(lp):.6f} plain vs {float(l64):.6f} float64, relative "
              f"{loss_kp:.3g} (limit {b_loss:.3g}); gradients, worst leaf relative to its largest entry: "
              f"kernel vs plain {e_kp:.3g} (limit {b_grad:.3g}; {worst}), from float64 kernel {e_k:.3g}, "
              f"plain {e_p:.3g}; the whole gradient's relative norm: kernel vs plain {whole[0]:.3g}, from "
              f"float64 kernel {whole[1]:.3g}, plain {whole[2]:.3g}; {name} launches {fwd} a forward, "
              f"{n_step} a step; all {len(gk)} leaves non-zero [{card}]")
        check(loss_kp <= b_loss, f"{arch} {dtype}: loss kernel vs plain {loss_kp:.3g}, limit {b_loss:.3g}")
        if decided:
            check(e_kp <= b_grad, f"{arch} {dtype}: gradients kernel vs plain {e_kp:.3g}, limit {b_grad:.3g}")
        if dtype == "bf16" and decided:
            check(e_k <= 1.5 * e_p, f"{arch} bf16: kernel {e_k:.3g} from float64, plain {e_p:.3g}")
        if not decided:
            print(f"  {arch} bf16: the plain path lies {e_p:.3g} of a leaf's largest entry from float64 "
                  f"through {cfg.num_layers} layers, so float64 does not decide the whole gradient (a limit "
                  f"of {b_grad:.3g} is above {TRAIN_BF16_CAP}); the layer check above holds it")
        report[dtype] = {"loss_rel": loss_kp, "grad_rel": e_kp, "kernel_f64": e_k, "plain_f64": e_p,
                         "worst_leaf": worst, "norm_rel": whole[0], "decided": decided}
        del gk, gp
    _, _, fwd, n_step = _loss_and_grads(cfg, p16, batch, ops, PerfConfig(remat="none"))
    check(fwd == n_step == layers, f"{arch}: remat none launched {fwd} a forward, {n_step} a step")
    print(f"  {arch}: remat none, {fwd} {name} launches a forward and {n_step} a step (none in the "
          f"backward); the checks took {time.perf_counter() - t0:.1f} s")
    del g64, p16
    _empty_cache()
    return report


def _train_cli(arch: str, card: str) -> tuple[int, int]:
    """``python -m repro_torch.launch.train --arch <arch>`` at full width,
    in this process so its launches are counted → (flash, SSD) launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.launch import train as train_mod

    steps = TRAIN_CLI_STEPS[arch]
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(TRAIN_CLI_BATCH), "--seq", str(TRAIN_CLI_SEQ),
            "--device", DEV]
    ops, layers = _kernel_ops(get_config(arch))
    fa.launches = so.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_mod.main(argv)
    print("\n".join(f"  {line}" for line in buf.getvalue().strip().splitlines()))
    n_fa, n_ssd = fa.launches, so.launches
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}: {time.perf_counter() - t0:.1f} s "
          f"with set-up; step s {[round(s, 4) for s in out['step_s']]}; flash launches {n_fa}, "
          f"SSD launches {n_ssd} [{card}]")
    check(all(math.isfinite(v) for v in out["losses"]) and len(out["losses"]) == steps,
          f"launch.train {arch}: losses {out['losses']}")
    check(ops.launches == 2 * layers * steps and (n_fa == 0 or n_ssd == 0),
          f"launch.train {arch}: {ops.launches} launches, not {2 * layers} a step × {steps}")
    del out
    _empty_cache()
    return n_fa, n_ssd


def _train_step_split(arch: str, card: str) -> dict:
    """One training step of ``launch.train``'s setting (bf16 weights, fp32
    moments, B 8, S 128, remat full) split into the loss's forward, the
    backward and the AdamW update, each between two synchronizations, after
    a warm-up step; with the peak memory of the step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch, shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim.adamw import adamw
    from repro_torch.tree import paths

    cfg = get_config(arch)
    params = zoo.init_params(cfg, torch.Generator(DEV).manual_seed(0))
    opt = adamw()
    state = opt.init(params)
    leaves = paths(params)
    for p in leaves.values():
        p.requires_grad_(True)
    stream = SyntheticLMStream(cfg.vocab_size, TRAIN_CLI_BATCH, TRAIN_CLI_SEQ)
    split = {}
    for rep in range(2):                       # a warm-up step, then the timed one
        batch = shard_batch(batch_for_arch(cfg, stream.next_batch()), make_host_mesh(DEV))
        _sync()
        _reset_peak()
        marks = [time.perf_counter()]
        loss = zoo.loss_fn(params, batch, cfg)
        _sync()
        marks.append(time.perf_counter())
        grads = torch.autograd.grad(loss, list(leaves.values()))
        _sync()
        marks.append(time.perf_counter())
        _, state, _ = opt.update(dict(zip(leaves, [g.float() for g in grads])), state, params, 3e-4)
        _sync()
        marks.append(time.perf_counter())
        split = dict(zip(("forward", "backward", "update"), (b - a for a, b in zip(marks, marks[1:]))))
        del grads, loss
    peak = _peak() / 1e9 if DEV == "cuda" else float("nan")
    print(f"  {arch} one step split (bf16 weights, fp32 moments, B {TRAIN_CLI_BATCH}, S {TRAIN_CLI_SEQ}, "
          f"remat full): forward {split['forward']:.4f} s, backward (with the recomputed forward) "
          f"{split['backward']:.4f} s, AdamW {split['update']:.4f} s; peak memory {peak:.2f} GB [{card}]")
    del params, state, leaves
    _empty_cache()
    return split


def _train_lm_example(card: str) -> int:
    """The 100M example (``examples/train_lm.py``'s twin), with its
    checkpoints → flash launches."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import base as cfg_base
    from repro_torch.examples import train_lm
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.tree import paths

    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)
    registry = dict(cfg_base._REGISTRY), dict(cfg_base._REDUCED)
    fa.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_lm.main(["--steps", str(TRAIN_LM_STEPS), "--ckpt-every", str(TRAIN_LM_STEPS + 1),
                             "--ckpt-dir", str(TRAIN_LM_DIR), "--device", DEV])
    cfg_base._REGISTRY, cfg_base._REDUCED = registry
    n = fa.launches
    print("\n".join(f"  {line}" for line in buf.getvalue().strip().splitlines()))
    manager = CheckpointManager(str(TRAIN_LM_DIR))
    step, restored = manager.restore_latest(out["state"], device=DEV)
    same = all(bool((a == paths(restored.params)[k]).all()) for k, a in paths(out["state"].params).items())
    print(f"  train_lm: {TRAIN_LM_STEPS} steps in {time.perf_counter() - t0:.1f} s with its checkpoints "
          f"(steps {manager.steps()}), step s after the first {sum(out['step_s'][1:]) / (TRAIN_LM_STEPS - 1):.4f}; "
          f"flash launches {n}; the newest checkpoint restores the final state exactly: {same} [{card}]")
    check(all(math.isfinite(v) for v in out["losses"]), f"train_lm losses {out['losses']}")
    check(n == TRAIN_LM_STEPS * 2 * 8 * 2, f"train_lm: {n} flash launches, not 32 a step")
    check(manager.steps() == [TRAIN_LM_STEPS] and step == TRAIN_LM_STEPS and same,
          f"train_lm checkpoints {manager.steps()}, restored step {step}, equal {same}")
    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)
    return n


def _train_resume(card: str) -> int:
    """The reduced qwen3, 3 steps and a restart to 6, against 6 steps
    uninterrupted: the final loss within rel 1e-4
    (tests/test_fault_tolerance.py:197-217) → flash launches."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import train as train_mod

    shutil.rmtree(TRAIN_RESUME_DIR, ignore_errors=True)
    kw = dict(steps=6, batch=2, seq=32, ckpt_every=3, log_every=100, device=DEV)
    fa.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        full = train_mod.train(ARCH, ckpt_dir=str(TRAIN_RESUME_DIR / "a"), **kw)
        train_mod.train(ARCH, ckpt_dir=str(TRAIN_RESUME_DIR / "b"), **{**kw, "steps": 3})
        resumed = train_mod.train(ARCH, ckpt_dir=str(TRAIN_RESUME_DIR / "b"), **kw)
    n = fa.launches
    rel = abs(resumed["final_loss"] - full["final_loss"]) / abs(full["final_loss"])
    print(f"  resume ({ARCH} reduced, 3 steps + restart to 6 against 6): final loss {resumed['final_loss']:.6f} "
          f"against {full['final_loss']:.6f}, relative {rel:.3g} (limit 1e-4); losses after the restart "
          f"{[round(v, 6) for v in resumed['losses']]} against {[round(v, 6) for v in full['losses'][3:]]}; "
          f"flash launches {n} [{card}]")
    check(len(resumed["losses"]) == 3 and rel <= 1e-4, f"resume: final loss relative {rel:.3g}")
    check(n == 2 * 2 * (6 + 3 + 3), f"resume: {n} flash launches, not 4 a step over 12 steps")
    shutil.rmtree(TRAIN_RESUME_DIR, ignore_errors=True)
    return n


def _empty_cache() -> None:
    import torch

    if DEV == "cuda":
        torch.cuda.empty_cache()


def train_phase(card: str) -> tuple[int, int, dict]:
    """Gradient checks at full width through both kernels, ``launch.train``
    at full width on qwen3-1.7b and mamba2-370m, the 100M example and the
    resume check → (flash, SSD launches of the training runs, the gradient
    checks' report).  On ``DEV``: a CPU rehearsal sets ``DEV = "cpu"`` and
    routes the wrappers' card path to counting plain stand-ins."""
    report = {arch: _grad_check(arch, card) for arch in (ARCH, MAMBA)}
    n_fa, n_ssd = 0, 0
    for arch in (ARCH, MAMBA):
        a, b = _train_cli(arch, card)
        n_fa, n_ssd = n_fa + a, n_ssd + b
        report[arch]["step_split_s"] = _train_step_split(arch, card)
    n_fa += _train_lm_example(card)
    n_fa += _train_resume(card)
    return n_fa, n_ssd, report


# ---------------------------------------------------------------------------
# Phase 12: the dense families at full width and depth
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_path():
    """The model's kernel ops swapped for their plain versions (flash
    attention and the SSD), inside the ``with`` block only."""
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.models import attention, mamba2

    with mock.patch.object(attention.attn_ops, "attention", attention_reference), \
            mock.patch.object(mamba2.ssd_ops, "ssd", ssd_chunked):
        yield


class _PerExpert:
    """An expert stack (E, ·, ·) whose experts are widened to float64 one at
    a time, as the MoE block reads them (a float64 MoE layer of qwen3-moe
    would take 19.9 GB)."""

    def __init__(self, stack):
        self.stack = stack

    def __getitem__(self, e):
        return self.stack[e].double()


def _widen(tree):
    """One block's parameters in float64; an MoE FFN's experts widened as
    they are read, its router as the model reads it (routing runs in fp32)."""
    if not isinstance(tree, dict):
        return tree.double()
    if "router" in tree:
        return {k: v if k == "router" else _PerExpert(v) for k, v in tree.items()}
    return {k: _widen(v) for k, v in tree.items()}


def _head64(params, cfg, x):
    """Final norm and head in float64, 16384 vocabulary columns at a time."""
    import torch

    from repro_torch.models import decoder
    from repro_torch.models.common import rms_norm

    x = rms_norm(x, params["final_norm"].double(), cfg.norm_eps)
    head = decoder._lm_head(params)
    out = torch.empty((*x.shape[:-1], head.shape[1]), dtype=torch.float64, device=x.device)
    for c0 in range(0, head.shape[1], 16384):
        out[..., c0:c0 + 16384] = x @ head[:, c0:c0 + 16384].double()
    return out


@contextlib.contextmanager
def recorded_routes():
    """Every ``moe.route`` call's fp32 router logits and expert ids, in call
    order, into the yielded list."""
    from repro_torch.models import moe

    log, inner = [], moe.route

    def recording(xt, router, k):
        out = inner(xt, router, k)
        log.append((xt.float() @ router.float(), out[1]))
        return out

    with mock.patch.object(moe, "route", recording):
        yield log


@contextlib.contextmanager
def pinned_routes(ids: list):
    """``moe.route`` with each call's experts taken, in call order, from
    ``ids`` (another run's routing); the weights are this run's own
    probabilities at those experts, renormalized, as ``route`` makes them."""
    import torch

    from repro_torch.models import moe

    inner, chosen = moe.route, iter(ids)

    def pinned(xt, router, k):
        _, own, aux = inner(xt, router, k)
        pick = next(chosen).to(own.device)
        w = torch.softmax(xt.float() @ router.float(), dim=-1).gather(-1, pick)
        return w / torch.sum(w, dim=-1, keepdim=True), pick, aux

    with mock.patch.object(moe, "route", pinned):
        yield


def _routing_flips(kernel: list, plain: list, cfg, label: str) -> int:
    """Tokens whose experts differ between the kernel path's and the plain
    path's routing, each printed with its MoE layer, call and token, the
    plain path's top-k margin (k-th minus (k+1)-th router logit) and the
    spread of the two paths' router-logit difference on that token (largest
    minus smallest).  A flip moves the gap between a taken and a dropped
    expert by at least the margin, and no gap moves by more than the spread:
    a flip whose margin exceeds the spread sat on no near-tie, and fails."""
    check(len(kernel) == len(plain), f"{label}: {len(kernel)} and {len(plain)} routing calls")
    k = cfg.experts_per_token
    per_call = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    flips = []
    for n, ((lk, ik), (lp, ip)) in enumerate(zip(kernel, plain)):
        differ = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        for t in differ.nonzero()[:, 0].tolist():
            top = lp[t].topk(k + 1).values
            delta = lk[t] - lp[t]
            flips.append((n % per_call, n // per_call, t, float(top[k - 1] - top[k]),
                          float(delta.max() - delta.min())))
    routed = sum(int(ik.shape[0]) for _, ik in kernel)
    print(f"  {label}: routing flips between the kernel and plain paths: {len(flips)} of {routed} "
          f"token routings" + "".join(
              f"\n    MoE layer {layer}, call {c}, token {t}: top-{k} margin {m:.4g}, router-logit "
              f"difference spread {s:.4g}" for layer, c, t, m, s in flips))
    bad = [f for f in flips if f[3] > f[4]]
    check(not bad, f"{label}: {len(bad)} routing flips off a near-tie: {bad[:4]}")
    return len(flips)


def _bf16_rule(a, b, ref, limit: float) -> tuple[list, str, list]:
    """The bf16 gates against the float64 forward's logits ``ref``, in one
    place: the kernel path ``a`` within ``limit`` of the plain path ``b``
    (relative to the largest logit), or within twice the plain path's own
    distance from ``ref`` where that is larger; ``a`` no further from ``ref``
    than 1.5 times ``b``; at least ``DENSE_DECIDED`` rows that bf16 can
    decide (top-two margin in ``ref`` above twice the larger of the two
    paths' errors on that row), and both paths' argmax equal to ``ref``'s
    on them → (decided rows, printed summary, gates).

    Two bf16 paths that each lie d from the exact logits may lie 2d apart,
    so a limit below 2d cannot tell a sound kernel from a broken one: at
    full depth llava's plain path lay 3.3 % of the largest logit from the
    float64 forward and jamba's period 6.7 % (PERF.md)."""
    n_rows, many = a.shape[0], a.shape[0] > 32
    top = float(b.abs().max())
    e_kernel, e_plain = ((x.double() - ref).abs().amax(-1) for x in (a, b))
    top2 = ref.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    rows = [r for r in range(n_rows) if margin[r] > 2 * max(float(e_kernel[r]), float(e_plain[r]))]
    same_ref = [int(x.argmax(-1)[r] == ref.argmax(-1)[r]) for x in (a, b) for r in rows]
    by_row = "" if many else (f" (by row: kernel {[round(float(v), 4) for v in e_kernel]}, "
                              f"plain {[round(float(v), 4) for v in e_plain]})")
    e_kernel, e_plain = float(e_kernel.max()), float(e_plain.max())
    err, bound = float((a - b).abs().max()) / top, max(limit, 2 * e_plain / top)
    line = (f"; limit {bound:.4g} = max({limit}, twice the plain path's {e_plain / top:.4g} of the largest "
            f"logit from the float64 forward); against the float64 forward: kernel {e_kernel:.4g}, plain "
            f"{e_plain:.4g} ({e_kernel / e_plain:.3f}x){by_row}, top-2 margins "
            f"{f'smallest {min(margin):.4g}' if many else [round(m, 5) for m in margin]}, "
            f"rows bf16 can decide {f'{len(rows)} of {n_rows}' if many else rows}")
    gates = [(err <= bound, f"kernel vs plain differ by {err:.3g} of the largest logit, limit {bound:.3g}"),
             (e_kernel <= 1.5 * e_plain, f"kernel {e_kernel:.3g} from the float64 forward, plain {e_plain:.3g}"),
             (len(rows) >= DENSE_DECIDED, f"bf16 decides {len(rows)} of {n_rows} rows, fewer than {DENSE_DECIDED}"),
             (all(same_ref), "argmax differs from the float64 forward's on a row bf16 decides")]
    return rows, line, gates


def _prefill_check(cfg, params, batches, label: str, limit: float, card: str, blocks=None) -> dict:
    """Prefill (for the encoder, ``encode_fn``'s forward) through the
    kernels against the plain path (the kernel ops swapped for their plain
    versions here only) on the same weights, a block at a time over every
    input batch: one flash launch per attention layer and one SSD launch per
    Mamba-2 layer a batch, and the logits at the end.  In fp32 they agree
    within ``limit`` of the largest logit, with equal argmax.  In bf16 they
    are held by ``_bf16_rule`` against a float64 forward of the same weights
    (each block widened as it runs, an MoE layer one expert at a time): at
    48 and 64 layers of random weights a row's top two logits lay 0.06 % and
    0.14 % of the largest logit apart, far inside either bf16 path's 2 %
    drift, so the argmax is held on the rows bf16 can decide.

    ``params`` is the whole model, first run twice through its entry point
    (``prefill_fn``, or ``encode_fn``) for the timing; or, with ``blocks``
    (an iterator of (position, block parameters) that draws each block when
    asked for it), only its embedding, final norm and head: a model streamed
    a block at a time, each block then also held alone in bf16, on the plain
    path's input, against the plain path and the float64 forward.

    Where the model routes tokens (MoE), a routing flip moves a token's FFN
    output by a share of its size, and the flips of one layer change the
    next layer's routing: two bf16 runs of 22 layers of random weights
    routed 663 of 11264 token slots apart, and their logits 19 % of the
    largest apart.  So every flip between the two paths' own runs is
    printed and must sit on a near-tie, and the gated comparisons above run
    with the routing pinned: each MoE layer of both paths takes the experts
    the float64 forward chose (fp32: that the kernel path chose), with its
    own weights at them."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.models import decoder
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.common import rms_norm

    encode = not cfg.decode_supported
    bf16, moe, streamed = params["final_norm"].dtype == torch.bfloat16, bool(cfg.num_experts), blocks is not None

    def steps(bp, xs, pos):
        if encode:
            return [decoder.forward_block(bp, x, cfg, pos)[0] for x in xs]
        return [decoder.prefill_block(bp, x, cfg, pos, max(48, x.shape[1]))[0] for x in xs]

    def logits(xs):
        return torch.cat([decoder.logits_at(params, rms_norm(x if encode else x[:, -1:], params["final_norm"],
                                                               cfg.norm_eps), cfg).flatten(0, 1) for x in xs])

    small = {k: params[k] for k in ("embed",) if k in params}
    if "frontend_proj" in params:
        small["frontend_proj"] = params["frontend_proj"].double()
    times, routes_of = [], {"kernel": [], "plain": [], "float64": []}     # per MoE layer, a route a batch
    fa.launches = so.launches = 0
    with torch.inference_mode():
        if not streamed:
            for _ in range(2):                  # the first call warms up cuBLAS
                t0 = time.perf_counter()
                if encode:
                    zoo.encode_fn(params, batches[0], cfg)
                else:
                    seq = decoder.embed_inputs(params, batches[0], cfg).shape[1]
                    zoo.prefill_fn(params, batches[0], cfg, max(48, seq))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            blocks = decoder.blocks(params, cfg)
        n_fa, n_ssd = fa.launches, so.launches
        x0 = [decoder.embed_inputs(params, x, cfg) for x in batches]
        xs = {k: x0 for k in ("kernel", "plain", "kernel_free", "plain_free")}
        if bf16:
            xs["float64"] = [decoder.embed_inputs(small, x, cfg).double() for x in batches]
    alone = []                                  # a streamed bf16 block held alone: (pos, e_kp, e_k, e_p)
    for pos, bp in blocks:
        with torch.inference_mode():
            with recorded_routes() as routes:
                fa0, ssd0, t0 = fa.launches, so.launches, time.perf_counter()
                xs["kernel_free"] = steps(bp, xs["kernel_free"], pos)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                got = (fa.launches - fa0, so.launches - ssd0)
                kernel_r = routes[:]
                routes.clear()
                with plain_path():
                    xs["plain_free"] = steps(bp, xs["plain_free"], pos)
                plain_r = routes[:]
                routes.clear()
                if bf16:
                    wide = _widen(bp)
                    with plain_path():
                        xs["float64"] = [decoder.forward_block(wide, x, cfg, pos)[0] for x in xs["float64"]]
                ref_r = routes[:]
                routes.clear()
                if streamed and bf16:
                    inputs = xs["plain"]
                    with plain_path():
                        ref = [decoder.forward_block(wide, x.double(), cfg, pos)[0] for x in inputs]
                    alone_pin = [ids for _, ids in routes]
            if moe:                             # the gated paths, their routing pinned
                pin = [ids for _, ids in (ref_r if bf16 else kernel_r)]
                with pinned_routes(pin):
                    xs["kernel"] = steps(bp, xs["kernel"], pos)
                with pinned_routes(pin), plain_path():
                    xs["plain"] = steps(bp, xs["plain"], pos)
            else:
                xs["kernel"], xs["plain"] = xs["kernel_free"], xs["plain_free"]
            if streamed and bf16:
                with pinned_routes(alone_pin):
                    k1 = steps(bp, inputs, pos)
                with pinned_routes(alone_pin), plain_path():
                    p1 = steps(bp, inputs, pos)
                c_k, c_p, c_r = (torch.cat([(y.double() - x.double()) for y, x in zip(ys, inputs)])
                                 for ys in (k1, p1, ref))
                alone.append((pos, float((c_k - c_p).abs().max()) / float(c_p.abs().max()),
                              float((c_k - c_r).abs().max()), float((c_p - c_r).abs().max())))
                del inputs, ref, k1, p1, c_k, c_p, c_r
        for k, r in (("kernel", kernel_r), ("plain", plain_r), ("float64", ref_r)):
            if r:
                routes_of[k].append(r)
        want = (len(batches), 0) if cfg.layer_kind(pos) == "attn" else (0, len(batches))
        if streamed:
            kind = ("attention" if cfg.layer_kind(pos) == "attn" else "mamba-2") + (
                " + MoE" if cfg.layer_is_moe(pos) else " + dense FFN")
            print(f"  {label}: position {pos} ({kind}, {_weight_gb(bp):.3f} GB): {len(batches)} kernel "
                  f"prefill steps {run_s:.4f} s, flash / ssd launches {got}")
        check(got == want, f"{label}: position {pos}: flash / ssd launches {got}, not {want}")
        n_fa, n_ssd = n_fa + got[0], n_ssd + got[1]
        bp = wide = None                        # a streamed block goes before the next is drawn
    with torch.inference_mode():
        a, b, a_free, b_free = (logits(xs[k]) for k in ("kernel", "plain", "kernel_free", "plain_free"))
        if bf16:
            ref = torch.cat([_head64(params, cfg, x if encode else x[:, -1]).flatten(0, -2)
                             for x in xs["float64"]])
    # the routes came a layer at a time; _routing_flips reads them a call at a time
    kernel_routes, plain_routes, ref_routes = (
        [layer[c] for c in range(len(batches)) for layer in routes_of[k]] for k in ("kernel", "plain", "float64"))
    n_rows = a.shape[0]
    finite = a.shape == (n_rows, cfg.vocab_size) and bool(torch.isfinite(a).all())
    err, top = float((a - b).abs().max()), float(b.abs().max())
    same = (a.argmax(-1) == b.argmax(-1)).int().tolist()
    many = n_rows > 32
    if bf16:
        rows, line, gates = _bf16_rule(a, b, ref, limit)
    else:
        rows, line = list(range(n_rows)), f", limit {limit}"
        gates = [(err / top <= limit, f"kernel vs plain differ by {err / top:.3g} of the largest logit")]
    if moe:
        free = float((a_free - b_free).abs().max())
        line = (f"; routing pinned to the {'float64 forward' if bf16 else 'kernel path'}'s choices{line}; "
                f"unpinned, each path routing for itself: max_abs_err {free:.3g}, relative error "
                f"{free / top:.3g}, argmax equal in {int((a_free.argmax(-1) == b_free.argmax(-1)).sum())} "
                f"of {n_rows} rows")
        if bf16:
            line += (f", token routings that differ from the float64 forward's: kernel "
                     f"{_route_differences(kernel_routes, ref_routes)}, plain "
                     f"{_route_differences(plain_routes, ref_routes)}")
    std = a.std(-1)
    spread = (f"{float(std.min()):.4f}–{float(std.max()):.4f} over {n_rows} rows" if many
              else [round(float(v), 4) for v in std])
    attn_layers = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    ssm_layers = cfg.num_layers - attn_layers
    calls = len(batches) + (0 if streamed else 2)
    by_row = "" if many else f" (by row {[round(float(v) / top, 4) for v in (a - b).abs().amax(-1)]})"
    timing = "" if streamed else f"two calls {[round(t, 4) for t in times]} s, then "
    print(f"  {label}: {timing}one for each of {len(batches)} input draws, a block at a time; flash launches "
          f"{n_fa}, ssd launches {n_ssd}; logits, kernel vs plain path: max_abs_err {err:.3g}, relative "
          f"error {err / top:.3g}{by_row} (max |logit| {top:.4g}), argmax equal in {sum(same)} of {n_rows} "
          f"rows, logit std {spread}{line} [{card}]")
    for pos, e_kp, e_k, e_p in alone:
        print(f"  {label}: position {pos} alone on the plain path's input, routing pinned to the float64 "
              f"forward's: its contribution (output − input), kernel vs plain path, relative error "
              f"{e_kp:.3g} (limit {limit}); against the float64 forward: kernel {e_k:.4g}, plain {e_p:.4g} "
              f"({e_k / e_p:.3f}x)")
        gates += [(e_kp <= limit, f"position {pos}: kernel vs plain differ by {e_kp:.3g}"),
                  (e_k <= 1.5 * e_p, f"position {pos}: kernel {e_k:.3g} from the float64 forward, plain {e_p:.3g}")]
    flips = _routing_flips(kernel_routes, plain_routes, cfg, label) if moe else 0
    check(finite, f"{label}: logits of shape {tuple(a.shape)} or non-finite")
    for ok, msg in gates:
        check(ok, f"{label}: {msg}")
    check(n_fa == calls * attn_layers and n_ssd == calls * ssm_layers,
          f"{label}: {n_fa} flash and {n_ssd} ssd launches for {calls} calls of {cfg.num_layers} layers")
    check(all(same[r] for r in rows), f"{label}: argmax differs between the paths on a row bf16 decides")
    return dict(prefill_s=times[-1] if times else None, rel_err=err / top, flips=flips,
                flash_launches=n_fa, ssd_launches=n_ssd)


def _route_differences(one: list, other: list) -> int:
    """Token routings (over every call of every MoE layer) whose experts
    differ between two runs of the same calls."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for (_, x), (_, y) in zip(one, other))


def _draw_on_card(cfg, seed: int, dtype):
    """Random weights of ``cfg`` drawn on the card, a matrix at a time → (params, s)."""
    import torch

    from repro_torch.models import model_zoo as zoo

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = zoo.init_params(cfg, torch.Generator("cuda").manual_seed(seed), dtype)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _weight_gb(params) -> float:
    from repro_torch.checkpoint.serializer import flatten

    return sum(t.numel() * t.element_size() for _, t in flatten(params)) / 1e9


def _released(label: str, card: str) -> None:
    """The card's peak since the weights were drawn, and its memory once
    they are dropped: at most ``AFTER_RELEASE_GB``."""
    import torch

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    print(f"  {label}: max_memory_allocated {peak / 1e9:.3f} GB, memory_allocated after "
          f"release {after / 1e9:.6f} GB [{card}]")
    check(after <= AFTER_RELEASE_GB * 1e9, f"{label}: {after} bytes still allocated after release")


def _token_draws(cfg, seed: int, n: int = DENSE_DRAWS, batch: int = 2, prompt: int = 32) -> list:
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    return [{"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt), device="cuda", generator=gen)}
            for _ in range(n)]


def dense_phase(card: str) -> int:
    """yi-6b, internlm2-20b and qwen3-32b at their published widths and
    depths in bf16, random weights drawn on the card; then in fp32 at the
    depth ``DENSE`` gives (the full depth where fp32 fits the card) → the
    flash launches of the kernel prefills."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    total = 0
    for i, (arch, fp32_layers) in enumerate(DENSE.items()):
        cfg = get_config(arch)
        draws = _token_draws(cfg, 100 + i)
        for dtype, layers, limit in ((torch.bfloat16, cfg.num_layers, 3e-2),
                                     (torch.float32, fp32_layers, 1e-4)):
            c = dataclasses.replace(cfg, num_layers=layers)
            params, init_s = _draw_on_card(c, i, dtype)
            label = f"{arch} {str(dtype)[6:]} at {layers} of {cfg.num_layers} layers"
            print(f"  {label}: {_weight_gb(params):.3f} GB of weights drawn on the card in {init_s:.3f} s")
            total += _prefill_check(c, params, draws, label, limit, card)["flash_launches"]
            del params
            _released(label, card)
    return total


# ---------------------------------------------------------------------------
# Phase 13: the MoE families at full width
# ---------------------------------------------------------------------------
def _generate(cfg, params, batch, max_len, label, card, n_new=8) -> tuple:
    """``ServingEngine.generate`` (prefill, then ``n_new`` greedy decode
    steps) → (result, flash launches, ssd launches)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.serving.engine import ServingEngine

    engine = ServingEngine(cfg, params, max_len)
    fa.launches = so.launches = 0
    out = engine.generate(batch, n_new=n_new)
    n_fa, n_ssd = fa.launches, so.launches
    check(out.tokens.shape == (batch["tokens"].shape[0], n_new) and out.tokens.dtype == torch.int32,
          f"{label}: generated tokens of shape {tuple(out.tokens.shape)}")
    print(f"  {label}: generate, prefill {out.prefill_s:.4f} s, {n_new} decode steps {out.decode_s:.4f} s "
          f"({out.decode_s / n_new * 1e3:.2f} ms a step), flash launches {n_fa}, ssd launches {n_ssd}, "
          f"tokens {out.tokens.tolist()} [{card}]")
    return out, n_fa, n_ssd


def _window_request(cfg, params, label, card) -> int:
    """One mixtral request whose prompt (``MOE_WINDOW_PROMPT`` tokens) is
    longer than the 4096 window, then 8 decode steps: the prefill keeps the
    last 4096 keys ring-aligned (slot = position mod 4096), and decode wraps
    around the ring.  The logits of the prefill and of the decode steps
    (each path fed the kernel path's tokens) are held against the plain
    path's, its routing pinned to the kernel path's (``_prefill_check``
    says why); the flips of its own routing are shown on near-ties → flash
    launches (the generated request's and the kernel path's prefill)."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import model_zoo as zoo

    gen = torch.Generator("cuda").manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, MOE_WINDOW_PROMPT), device="cuda", generator=gen)}
    max_len = MOE_WINDOW_PROMPT + 8
    out, n_fa, _ = _generate(cfg, params, batch, max_len, f"{label}, prompt {MOE_WINDOW_PROMPT}", card)
    check(n_fa == cfg.num_layers, f"{label}: {n_fa} flash launches for a prefill of {cfg.num_layers} layers")
    def run():
        first, state = zoo.prefill_fn(params, batch, cfg, max_len)
        steps = [first]
        for i in range(8):
            step, state = zoo.decode_fn(params, state, out.tokens[:, i], cfg)
            steps.append(step)
        return torch.cat(steps), state.caches[0]["pos0"]

    with torch.inference_mode(), recorded_routes() as routes:
        a, cache = run()
        kernel_routes = routes[:]
        routes.clear()
        with plain_path():
            b_free, _ = run()
        plain_routes = routes[:]
        with pinned_routes([ids for _, ids in kernel_routes]), plain_path():
            b, _ = run()
    n_fa = fa.launches
    window = cfg.sliding_window
    slots = cache.positions.long()
    check(cache.k.shape[1] == window and cache.index == max_len, f"{label}: cache {tuple(cache.k.shape)}")
    check(bool((slots % window == torch.arange(window, device=slots.device)).all())
          and int(slots.max()) == max_len - 1 and int(slots.min()) == max_len - window,
          f"{label}: the ring cache is not aligned to slot = position mod {window}")
    err, top = float((a - b).abs().max()), float(b.abs().max())
    free = float((a - b_free).abs().max())
    same = (a.argmax(-1) == b.argmax(-1)).int().tolist()
    print(f"  {label}, prompt {MOE_WINDOW_PROMPT} > window {window}: ring cache aligned (positions "
          f"{max_len - window}..{max_len - 1}); prefill and 8 decode steps, kernel vs plain path with its "
          f"routing pinned to the kernel path's: max_abs_err {err:.3g}, relative error {err / top:.3g} "
          f"(max |logit| {top:.4g}, limit 3e-2), argmax equal {same}; unpinned: max_abs_err {free:.3g}, "
          f"relative error {free / top:.3g} [{card}]")
    _routing_flips(kernel_routes, plain_routes, cfg, f"{label}, prompt {MOE_WINDOW_PROMPT}")
    check(bool(torch.isfinite(a).all()) and err / top <= 3e-2,
          f"{label}: window request, kernel vs plain differ by {err / top:.3g} of the largest logit")
    return n_fa


def _moe_layer(cfg, params, label, card) -> dict:
    """The first MoE layer's FFN on a normal input at the prefill's 64
    tokens and a decode step's 2: the grouped dispatch (the model's path; it
    reads the per-expert counts on the host) held to the dense oracle on the
    same input, within ``MOE_DISPATCH_LIMIT`` of the oracle's largest
    output, and timed beside it and beside the bound of reading the weights
    of the experts the tokens touch."""
    import torch

    from repro_torch.models import decoder, moe

    bp = next(bp for pos, bp in decoder.blocks(params, cfg) if cfg.layer_is_moe(pos))["moe"]
    dtype = params["final_norm"].dtype
    limit = MOE_DISPATCH_LIMIT[str(dtype)[6:]]
    gen = torch.Generator("cuda").manual_seed(9)
    out = {}
    for name, tokens in (("prefill", 32), ("decode", 1)):
        h = torch.randn((2, tokens, cfg.d_model), generator=gen, device="cuda").to(dtype)
        with torch.inference_mode():
            _, ids, _ = moe.route(h.reshape(-1, cfg.d_model), bp["router"], cfg.experts_per_token)
            touched = len(set(ids.flatten().tolist()))
            got, want = moe.moe_block(bp, h, cfg)[0], moe.moe_reference(bp, h, cfg)[0]
            k_ms = time_ms(lambda: moe.moe_block(bp, h, cfg))
            d_ms = time_ms(lambda: moe.moe_reference(bp, h, cfg))
        err, top = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
        expert_bytes = 3 * cfg.d_model * cfg.d_ff * h.element_size()
        b_ms, b_by = bound_ms(touched * expert_bytes, 6.0 * 2 * tokens * cfg.experts_per_token * cfg.d_model
                              * cfg.d_ff, str(dtype)[6:])
        print(f"  {label}: one MoE layer at {2 * tokens} tokens ({touched} of {cfg.num_experts} experts "
              f"touched): grouped dispatch vs dense oracle max_abs_err {err:.3g}, relative error "
              f"{err / top:.3g} (max |output| {top:.4g}, limit {limit}); grouped dispatch {k_ms:.4f} ms a "
              f"call, dense oracle {d_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} (the touched experts' "
              f"weights, {touched * expert_bytes / 1e9:.3f} GB) [{card}]")
        check(got.shape == h.shape and bool(torch.isfinite(got).all()) and err / top <= limit,
              f"{label}: grouped dispatch and dense oracle differ by {err / top:.3g} at {2 * tokens} tokens")
        out[f"moe_{name}_ms"], out[f"moe_{name}_dense_ms"], out[f"moe_{name}_bound_ms"] = k_ms, d_ms, b_ms
        out[f"moe_{name}_rel_err"] = err / top
    return out


def moe_phase(card: str) -> tuple[int, dict]:
    """mixtral-8x7b and qwen3-moe-235b-a22b at their published widths, cut to
    the depths ``MOE`` gives (the bf16 and fp32 depths that fit the card),
    random weights drawn on the card: the prefill check of the dense
    families with every routing flip shown on a near-tie; 8 greedy decode
    steps through ``ServingEngine.generate`` in bf16; and mixtral's request
    beyond its window → (flash launches, prefill seconds by label)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    total, rows = 0, {}
    for i, (arch, depths) in enumerate(MOE.items()):
        cfg = get_config(arch)
        draws = _token_draws(cfg, 200 + i)
        for dtype, layers, limit in zip((torch.bfloat16, torch.float32), depths, (3e-2, 1e-4)):
            c = dataclasses.replace(cfg, num_layers=layers)
            params, init_s = _draw_on_card(c, 20 + i, dtype)
            label = f"{arch} {str(dtype)[6:]} at {layers} of {cfg.num_layers} layers"
            print(f"  {label}: {_weight_gb(params):.3f} GB of weights drawn on the card in {init_s:.3f} s")
            row = _prefill_check(c, params, draws, label, limit, card)
            row.update(_moe_layer(c, params, label, card))
            total += row["flash_launches"]
            if dtype == torch.bfloat16:
                out, n_fa, _ = _generate(c, params, draws[0], 48, label, card)
                check(n_fa == layers, f"{label}: {n_fa} flash launches for a prefill")
                row["decode_step_s"] = out.decode_s / 8
                total += n_fa
                if c.sliding_window:
                    total += _window_request(c, params, label, card)
            rows[label] = row
            del params
            _released(label, card)
    return total, rows


# ---------------------------------------------------------------------------
# Phase 14: jamba, streamed a layer at a time
# ---------------------------------------------------------------------------
def _draw_block(cfg, pos: int, gen, dtype, label: str) -> dict:
    """The parameters of the block at position ``pos``, drawn on the card."""
    import torch

    from repro_torch.models import decoder
    from repro_torch.models.common import init_from_specs, stack_specs

    t0 = time.perf_counter()
    bp = decoder._layer(init_from_specs(stack_specs({"b": decoder._block_specs(cfg, pos)}, 1), gen, dtype), 0)["b"]
    torch.cuda.synchronize()
    print(f"  {label}: position {pos} drawn on the card in {time.perf_counter() - t0:.3f} s")
    return bp


def jamba_phase(card: str) -> tuple[int, int]:
    """One period of jamba-1.5-large-398b at its published widths, which no
    card holds whole (88.1 GB in bf16), streamed through ``_prefill_check``:
    each of its eight layers drawn on the card in turn, run through the
    decoder's per-position prefill step (the SSD kernel at positions 0-3 and
    5-7 with 256 heads, flash at 4, the MoE dispatch at the odd positions)
    on every token draw (B 2, prompt 32 padded to one chunk of 128), on the
    plain path and, in bf16, on the float64 forward (an expert at a time),
    then freed; in fp32 (a 40.3 GB MoE layer) and bf16 (20.2 GB).  Then the
    reduced jamba through ``ServingEngine.generate``: prefill and 8 decode
    steps, kernel against plain path → (flash, ssd launches)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    from repro_torch.models.common import init_from_specs

    cfg = dataclasses.replace(get_config(JAMBA), num_layers=8)
    draws = _token_draws(cfg, 300)
    outer_specs = {k: v for k, v in decoder.decoder_specs(cfg).items() if k != "periods"}
    n_fa = n_ssd = 0
    for dtype, limit in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        label = f"{JAMBA} {str(dtype)[6:]}, one period streamed"
        gen = torch.Generator("cuda").manual_seed(30)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        outer = init_from_specs(outer_specs, gen, dtype)
        row = _prefill_check(cfg, outer, draws, label, limit, card,
                             blocks=((pos, _draw_block(cfg, pos, gen, dtype, label)) for pos in range(8)))
        n_fa, n_ssd = n_fa + row["flash_launches"], n_ssd + row["ssd_launches"]
        del outer
        _released(label, card)

    small = get_config(JAMBA, reduced=True)
    params, _ = _draw_on_card(small, 31, torch.float32)
    batch = _token_draws(small, 301, n=1)[0]
    label = f"{small.name} fp32"
    out, fa1, ssd1 = _generate(small, params, batch, 48, label, card)
    with plain_path():
        plain, _, _ = _generate(small, params, batch, 48, f"{label}, plain path", card)
    check((fa1, ssd1) == (1, 7), f"{label}: flash / ssd launches {(fa1, ssd1)} for a prefill, not (1, 7)")
    check(torch.equal(out.tokens, plain.tokens), f"{label}: kernel and plain paths generate different tokens")
    del params
    _released(label, card)
    return n_fa + fa1, n_ssd + ssd1


# ---------------------------------------------------------------------------
# Phase 15: the frontends: hubert (encoder) and llava (vision)
# ---------------------------------------------------------------------------
def frontends_phase(card: str) -> int:
    """hubert-xlarge at full depth (48 layers) through ``encode_fn``, B 2 ×
    ``HUBERT_FRAMES`` frames (flash at head dim 80 without a causal mask),
    and llava-next-mistral-7b at full depth (32 layers) with 576 patch
    tokens and 32 text tokens, prefill held to the plain path and then
    through ``ServingEngine.generate`` (8 decode steps): in bf16 by the dense
    families' rule, in fp32 within 1e-4 → flash launches.  llava in bf16
    runs on two weight draws and a second set of inputs: the spread of its
    readings against the bf16 limit (PERF.md)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo

    bf16, fp32 = (torch.bfloat16, 3e-2), (torch.float32, 1e-4)
    runs = {HUBERT: [(bf16, 40, (400,)), (fp32, 40, (400,))],      # (dtype and limit, weights, inputs)
            LLAVA: [(bf16, 41, (401, 411)), (bf16, 51, (411,)), (fp32, 41, (401,))]}
    total = 0
    for arch, arch_runs in runs.items():
        cfg = get_config(arch)
        served = not cfg.decode_supported
        for (dtype, limit), weights, inputs in arch_runs:
            params, init_s = _draw_on_card(cfg, weights, dtype)
            label = f"{arch} {str(dtype)[6:]} at {cfg.num_layers} layers"
            print(f"  {label}: {_weight_gb(params):.3f} GB of weights (seed {weights}) drawn on the card in "
                  f"{init_s:.3f} s")
            for seed in inputs:
                gen = torch.Generator("cuda").manual_seed(seed)
                if arch == HUBERT:
                    batches = [zoo.make_batch(cfg, 2, HUBERT_FRAMES, gen)]
                else:
                    batches = [zoo.make_batch(cfg, 2, cfg.frontend_tokens + 32, gen) for _ in range(DENSE_DRAWS)]
                total += _prefill_check(cfg, params, batches, f"{label}, weights {weights}, inputs {seed}",
                                        limit, card)["flash_launches"]
            if not served:
                _, n_fa, _ = _generate(cfg, params, batches[0], cfg.frontend_tokens + 48, label, card)
                check(n_fa == cfg.num_layers, f"{label}: {n_fa} flash launches for a prefill")
                total += n_fa
                served = True
            del params, batches
            _released(label, card)
    return total


# ---------------------------------------------------------------------------
# Phase 16: the MoE main path under the duty-cycle controller
# ---------------------------------------------------------------------------
def moe_serving_phase(card: str) -> tuple[int, int, dict]:
    """The reduced mixtral-8x7b through ``build_demo`` under On-Off:
    a ``zstd+int8`` checkpoint whose expert stacks w_gate and w_up,
    (2, 4, 64, 128), are the dequant kernel's first 4-D leaves (each
    bring-up launches it twice, bit-exact against its plain version on the
    checkpoint's own blobs), ``REQUESTS`` requests generated, and after the
    release at most ``AFTER_RELEASE_GB`` on the card → (dequant launches,
    flash launches, the 4-D leaves' dequant row)."""
    import zlib

    import torch

    from repro_torch.checkpoint import _msgpack
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.dequant.ref import dequantize_blocked_reference
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import build_demo
    from repro_torch.serving.scheduler import run_schedule

    shutil.rmtree(CKPT_DIR_MOE, ignore_errors=True)
    controller, make_request = build_demo("mixtral-8x7b", reduced=True, device="cuda",
                                          ckpt_dir=str(CKPT_DIR_MOE), strategy="on_off")
    payload = _msgpack.unpackb(sorted(CKPT_DIR_MOE.glob("step_*.ckpt"))[-1].read_bytes())
    quant = [r for r in payload["leaves"] if "quant" in r]
    check([r["path"] for r in quant] == ["periods/pos0/moe/w_gate", "periods/pos0/moe/w_up"]
          and all(r["shape"] == [2, 4, 64, 128] for r in quant),
          f"mixtral checkpoint quantizes {[(r['path'], r['shape']) for r in quant]}")
    err = k_ms = p_ms = 0.0
    for r in quant:
        q = torch.frombuffer(bytearray(zlib.decompress(r["quant"]["q"])), dtype=torch.int8)
        s = torch.frombuffer(bytearray(zlib.decompress(r["quant"]["scales"])), dtype=torch.float32)
        q, s = q.reshape(r["quant"]["rows"], -1).cuda(), s.reshape(r["quant"]["rows"], -1).cuda()
        out, ref = dq.dequantize(q, s), dequantize_blocked_reference(q, s)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"dequant of the 4-D leaf {r['path']} is not bit-exact")
        err = max(err, float((out.float() - ref.float()).abs().max()))
        k_ms += time_ms(lambda: dq.dequantize(q, s))
        p_ms += time_ms(lambda: dequantize_blocked_reference(q, s))
    n_bytes = sum(r["quant"]["rows"] * 128 * (1 + 2) + r["quant"]["rows"] * 4 for r in quant)
    b_ms, b_by = bound_ms(n_bytes, sum(r["quant"]["rows"] * 128 for r in quant), "float32")
    print(f"  dequant of the reduced mixtral's 4-D expert leaves {[r['shape'] for r in quant]} as (512, 128) "
          f"matrices: bit-exact, max_abs_err {err}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms by {b_by} [{card}]")
    requests = [make_request() for _ in range(REQUESTS)]
    dq.launches = fa.launches = 0
    res = run_schedule(controller, iter(requests), period_s=PERIOD_S)
    n_dq, n_fa = dq.launches, fa.launches
    if controller.handle is not None:
        controller.release_fn(controller.handle)
        controller.handle = None
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    prefills = res.n_requests + res.n_configurations
    print(f"  mixtral-8x7b-reduced on_off: {res.n_requests} requests, {res.n_configurations} configurations, "
          f"energy {res.energy_mj:.1f} mJ, wall {res.wall_s:.3f} s; dequant launches {n_dq} (2 per bring-up), "
          f"flash launches {n_fa} (2 per prefill, {prefills} prefills); memory_allocated after release "
          f"{after / 1e9:.6f} GB [{card}]")
    check(res.n_requests == REQUESTS and n_dq == 2 * res.n_configurations and n_fa == 2 * prefills,
          f"mixtral serving: {n_dq} dequant and {n_fa} flash launches for {res.n_configurations} bring-ups")
    check(after <= AFTER_RELEASE_GB * 1e9, f"mixtral serving: {after} bytes allocated after release")
    shutil.rmtree(CKPT_DIR_MOE, ignore_errors=True)
    return n_dq, n_fa, dict(leaves=[r["shape"] for r in quant], max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                            bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# Phase 17: sweep (the vectorized closed forms and Pareto frontiers)
# ---------------------------------------------------------------------------
DEV = "cuda"                                # the device of the sweep and fleet phases


def torch_device():
    import torch

    return torch.device(DEV)


def _sync():
    from repro_torch.device import synchronize

    synchronize(torch_device())


def _reset_peak():
    import torch

    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak() -> int:
    import torch

    return torch.cuda.max_memory_allocated() if DEV == "cuda" else 0


def _allocated() -> int:
    import torch

    return torch.cuda.memory_allocated() if DEV == "cuda" else 0


SWEEP_PERIODS_MS = tuple(float(t) for t in range(1, 1001))   # 1–1000 ms in steps of 1
SWEEP_BUDGETS_J = 16                        # budgets from 1 J to 4147 J, geometric
SWEEP_SAMPLE = 2400                         # grid points held to the scalar oracle
SWEEP_CPU_STRIDE = 10                       # the CPU reruns every 10th request period
PARETO_PERIOD_STEP = 4                      # strategy frontier over ~10^5 points
CROSSOVER_IDLE_MW = (134.3, 34.2, 24.0)     # launch/sweep.py's default idle powers


def _sweep_oracle(grid, ix) -> dict:
    """Every GRID_QUANTITIES value at grid point ``ix`` through the port's
    scalar closed forms, on the per-point constructed WorkloadItem."""
    from repro_torch.core import energy_model as em
    from repro_torch.core.config_phase import ConfigParams
    from repro_torch.core.phases import CONFIGURATION, WorkloadItem
    from repro_torch.core.strategies import IdleWaitingStrategy, OnOffStrategy

    d, w, f, c, t, m, b = ix
    base = grid.item()
    params = ConfigParams(grid.buswidths[w], grid.clocks_mhz[f], grid.compression[c])
    item = WorkloadItem(base.name, (grid.devices[d].config_phase(params),)
                        + tuple(p for p in base.phases if p.name != CONFIGURATION), base.idle_power_mw)
    period, budget, ovh = grid.request_periods_ms[t], grid.e_budgets_mj[b], grid.powerup_overhead_mj
    iw_strat = IdleWaitingStrategy(item, ovh, method=grid.idle_methods[m])
    iw, oo = iw_strat.evaluate(period, budget), OnOffStrategy(item, ovh).evaluate(period, budget)
    cross = em.crossover_period_ms(item, iw_strat.idle_power_mw, ovh)
    pick = period <= cross
    return {
        "config_time_ms": item.config_time_ms, "config_energy_mj": grid.devices[d].config_energy_mj(params),
        "onoff_n_max": oo.n_max, "onoff_lifetime_ms": oo.lifetime_ms,
        "onoff_energy_per_item_mj": oo.energy_per_item_mj, "onoff_feasible": oo.feasible,
        "iw_n_max": iw.n_max, "iw_lifetime_ms": iw.lifetime_ms,
        "iw_energy_per_item_mj": iw.energy_per_item_mj, "iw_feasible": iw.feasible,
        "crossover_ms": cross, "adaptive_n_max": iw.n_max if pick else oo.n_max,
        "adaptive_lifetime_ms": iw.lifetime_ms if pick else oo.lifetime_ms, "adaptive_picks_iw": pick,
    }


def sweep_phase(card: str) -> None:
    """The full Table-1 strategy grid (both devices × 3 buswidths × 11 clocks
    × 2 compression × request periods 1–1000 ms × 3 idle methods × 16
    budgets, 6,336,000 points) through ``sweep_batch`` on the card: every
    field held bit for bit to the scalar oracle on a sample over every axis
    and to the port's CPU run on a strided tenth; the Pareto frontiers and
    the crossover surface against the CPU's."""
    import numpy as np
    import torch

    from repro_torch.core import batch_eval as be
    from repro_torch.core import energy_model as em
    from repro_torch.core import pareto
    from repro_torch.core.config_phase import DEVICES
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.strategies import IdlePowerMethod

    cal = em.CALIBRATED_POWERUP_OVERHEAD_MJ
    budgets = tuple(float(b) for b in np.geomspace(1000.0, em.PAPER_ENERGY_BUDGET_MJ, SWEEP_BUDGETS_J))
    grid = be.SweepGrid(devices=tuple(DEVICES.values()), request_periods_ms=SWEEP_PERIODS_MS,
                        idle_methods=tuple(IdlePowerMethod), e_budgets_mj=budgets, powerup_overhead_mj=cal)
    check(grid.size == 6_336_000, f"sweep grid has {grid.size} points")
    be.sweep_batch(grid, device=DEV)        # warm-up: allocator and kernels
    _sync()
    _reset_peak()
    base_mem = _allocated()
    t0 = time.perf_counter()
    res = be.sweep_batch(grid, device=DEV)
    _sync()
    card_s = time.perf_counter() - t0
    held = sum(v.untyped_storage().nbytes() for v in res.arrays.values())
    print(f"  sweep_batch: {grid.size} points in {card_s * 1e3:.3f} ms on the card, "
          f"{grid.size / card_s:.4e} points/s; result {held / 1e9:.4f} GB held (the quantities "
          f"that vary over fewer axes stay broadcast views), peak {(_peak() - base_mem) / 1e9:.4f} GB [{card}]")

    # the scalar oracle on a sample that covers every value of every axis
    primes = (1, 7, 13, 17, 389, 5, 11)
    sample = [tuple((i * p + i // 97) % n for p, n in zip(primes, grid.shape)) for i in range(SWEEP_SAMPLE)]
    for k, n in enumerate(grid.shape):
        check(len({ix[k] for ix in sample}) == min(n, SWEEP_SAMPLE), f"sweep sample misses values of axis {k}")
    idx = tuple(torch.tensor([ix[k] for ix in sample], device=DEV) for k in range(len(grid.shape)))
    got = {k: v.expand(grid.shape)[idx].cpu().numpy() for k, v in res.arrays.items()}
    t0 = time.perf_counter()
    bad = 0
    for j, ix in enumerate(sample):
        want = _sweep_oracle(grid, ix)
        bad += sum(got[k][j] != want[k] for k in be.GRID_QUANTITIES)
    print(f"  scalar oracle at {SWEEP_SAMPLE} points over every axis: {bad} of "
          f"{SWEEP_SAMPLE * len(be.GRID_QUANTITIES)} values differ ({time.perf_counter() - t0:.2f} s)")
    check(bad == 0, f"sweep_batch on the card differs from the scalar oracle in {bad} values")

    # the port's CPU run on every SWEEP_CPU_STRIDE-th period
    tenth = dataclasses.replace(grid, request_periods_ms=SWEEP_PERIODS_MS[::SWEEP_CPU_STRIDE])
    t0 = time.perf_counter()
    cpu = be.sweep_batch(tenth, device="cpu")
    cpu_s = time.perf_counter() - t0
    diff = 0
    for k in be.GRID_QUANTITIES:
        card_k = res[k].expand(grid.shape)[:, :, :, :, ::SWEEP_CPU_STRIDE].cpu()
        diff += int((card_k != cpu[k].expand(tenth.shape)).sum())
    print(f"  against the CPU on every {SWEEP_CPU_STRIDE}th period ({tenth.size} points, CPU "
          f"{tenth.size / cpu_s:.4e} points/s): {diff} values differ")
    check(diff == 0, f"sweep_batch: the card and the CPU differ in {diff} values")
    del res, cpu

    # frontiers and the crossover surface, card against CPU
    front = {dev: pareto.config_pareto(tuple(DEVICES.values()), device=dev) for dev in (DEV, "cpu")}
    check(front[DEV] == front["cpu"], "config_pareto: the card's frontier differs from the CPU's")
    sub = dataclasses.replace(grid, request_periods_ms=SWEEP_PERIODS_MS[::PARETO_PERIOD_STEP], e_budgets_mj=(budgets[-1],))
    for strategy in ("iw", "adaptive"):
        t0 = time.perf_counter()
        on_card = pareto.strategy_pareto(be.sweep_batch(sub, device=DEV), strategy)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = pareto.strategy_pareto(be.sweep_batch(sub, device="cpu"), strategy)
        print(f"  strategy_pareto({strategy}) over {sub.size} points: {len(on_card)} on the frontier, "
              f"card {card_s:.3f} s, CPU {time.perf_counter() - t0:.3f} s")
        check(on_card and on_card == on_cpu, f"strategy_pareto({strategy}): card and CPU frontiers differ")
    print(f"  config_pareto: {len(front[DEV])} settings on the frontier, equal on card and CPU")
    item = paper_lstm_item()
    surf = {dev: pareto.crossover_surface(item, tuple(DEVICES.values()), CROSSOVER_IDLE_MW,
                                          powerup_overhead_mj=cal, device=dev)["crossover_ms"].cpu()
            for dev in (DEV, "cpu")}
    check(torch.equal(surf[DEV], surf["cpu"]), "crossover_surface: card and CPU differ")
    cell = float(surf[DEV][0, -1, -1, 1, 2])
    want = _sweep_oracle(be.SweepGrid(buswidths=(4,), clocks_mhz=(66,), compression=(True,),
                                      idle_methods=(IdlePowerMethod.METHOD1_2,), powerup_overhead_mj=cal),
                         (0,) * 7)["crossover_ms"]
    paper = float(be.crossover_batch(item, [24.0], cal, device=DEV)[0])
    print(f"  crossover surface {tuple(surf[DEV].shape)}: the paper's cell (xc7s15, quad, 66 MHz, "
          f"compressed, 24 mW) {cell!r} ms from the device model (scalar oracle {want!r}); the paper "
          f"item's Table-2 phases give {paper:.4f} ms")
    check(cell == want, f"crossover surface cell {cell!r} != scalar oracle {want!r}")
    check(round(paper, 4) == 499.0607, f"crossover_batch of the paper item {paper!r} != 499.0607 ms")


# ---------------------------------------------------------------------------
# Phase 18: fleet (periodic and routed tick loops, CUDA graphs)
# ---------------------------------------------------------------------------
FLEET_N = 4096                              # launch/fleet.py's default fleet
FLEET_BIG = 1 << 20                         # 1,048,576 devices
FLEET_BIG_BUDGET_J = 2.0                    # the reference's acceptance budget
FLEET_BIG_TICKS = 250                       # 10 s of 40 ms ticks
ARRIVAL_STREAMS = 100_000
ARRIVAL_GAPS = 400                          # gaps a stream, as tests/test_arrivals_stats.py draws


def _timed(fn):
    from repro_torch.device import synchronize

    synchronize(torch_device())
    t0 = time.perf_counter()
    out = fn()
    synchronize(torch_device())
    return out, time.perf_counter() - t0


def _same(a, b, fields, label):
    import torch

    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        check(torch.equal(x.cpu(), y.cpu()), f"{label}: {f} differs")


def _rates(label, n_dev, ticks, eager_s, graph_s, card):
    print(f"  {label}: eager {ticks / eager_s:.1f} ticks/s, {n_dev * ticks / eager_s:.4e} device-steps/s; "
          f"graph {ticks / graph_s:.1f} ticks/s, {n_dev * ticks / graph_s:.4e} device-steps/s "
          f"({eager_s / graph_s:.2f}x) [{card}]")


def _fleet_cli(card: str) -> None:
    payload = _launcher("fleet", ROOT / "build" / "chip_smoke_fleet.json")
    sc = payload["oracle_self_check"]
    tp = payload["throughput"]
    print(f"  the CLI's default: self-check {json.dumps(sc)}; periodic "
          f"{tp['periodic']['fleet']['device_steps_per_s']} and routed "
          f"{tp['routed']['fleet']['device_steps_per_s']} device-steps/s [{card}]")
    check(all(v["agrees"] and not v["energy_abs_diff_mj"] for v in sc.values()),
          f"the fleet CLI's oracle self-check failed: {sc}")


def fleet_phase(card: str) -> None:
    """The fleet CLI's default run; N=1 against the scalar simulators; the
    CUDA-graph tick loop against the eager one and the card against the CPU
    at 4096 devices; a chunked continuation; 1,048,576 devices periodic
    until every device has died and routed with power_aware at load 0.5;
    the batched arrival samplers at 10^5 streams."""
    import numpy as np
    import torch

    from repro_torch.core import arrivals as pa
    from repro_torch.core import energy_model as em
    from repro_torch.core.adaptive import FixedTimeoutPolicy, StaticPolicy, break_even_timeout_ms
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.simulator import simulate, simulate_trace
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.core.workload import ExperimentSpec, WorkloadSpec
    from repro_torch.fleet import DeviceSpec, FleetParams, FleetState, run_periodic, run_routed, uniform_fleet

    cal = em.CALIBRATED_POWERUP_OVERHEAD_MJ
    item = paper_lstm_item()
    state_fields = [f.name for f in dataclasses.fields(FleetState)]
    per_fields = ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time")

    _fleet_cli(card)

    # ---- N = 1 against the scalar simulators, on the card --------------------
    worst = 0.0
    for strategy in ("on_off", "idle_waiting"):
        for period in (40.0, 89.0, 120.0):
            spec = ExperimentSpec(workload=WorkloadSpec(41.47, period), item=item, strategy_kind=strategy,
                                  method=IdlePowerMethod.METHOD1_2, powerup_overhead_mj=cal)
            step = simulate(spec, mode="step")
            fl = run_periodic(FleetParams.from_specs([DeviceSpec.from_experiment(spec)], DEV), step.n_items + 10)
            check(int(fl.n_items[0]) == step.n_items and float(fl.energy_mj[0]) == step.energy_used_mj
                  and float(fl.lifetime_ms[0]) == step.lifetime_ms,
                  f"N=1 periodic {strategy} at {period} ms differs from simulate(mode='step')")
        for period, budget in ((80.0, 3000.0), (120.0, 1e6)):
            policy = StaticPolicy(strategy, item)
            oracle = simulate_trace(item, [i * period for i in range(400)], policy, budget)
            counts = np.zeros(int(400 * period / 40.0), np.int32)
            counts[:: int(period / 40.0)] = 1
            p1 = FleetParams.from_specs([DeviceSpec(item, strategy=strategy, request_period_ms=period,
                                                    e_budget_mj=budget)], DEV)
            st = run_routed(p1, counts, 40.0).state
            check(int(st.n_served[0]) == oracle.n_items and int(st.n_configs[0]) == oracle.configurations
                  and int(st.n_released[0]) == oracle.releases,
                  f"N=1 routed {strategy} at {period} ms: counts differ from simulate_trace")
            worst = max(worst, abs(float(st.energy_mj[0]) - oracle.energy_used_mj))
    adaptive = FixedTimeoutPolicy(break_even_timeout_ms(item, item.idle_power_mw), item.idle_power_mw)
    oracle = simulate_trace(item, [i * 80.0 for i in range(400)], adaptive, 3000.0)
    counts = np.zeros(800, np.int32)
    counts[::2] = 1
    st = run_routed(FleetParams.from_specs([DeviceSpec(item, strategy="adaptive", request_period_ms=80.0,
                                                       e_budget_mj=3000.0)], DEV), counts, 40.0).state
    check(int(st.n_served[0]) == oracle.n_items and int(st.n_released[0]) == oracle.releases,
          "N=1 routed adaptive: counts differ from simulate_trace")
    worst = max(worst, abs(float(st.energy_mj[0]) - oracle.energy_used_mj))
    print(f"  N=1: periodic equals simulate(mode='step') bit for bit (6 cases); routed counts equal "
          f"simulate_trace's exactly, energies within {worst:.3e} mJ (phase-by-phase sums; limit 1e-9)")
    check(worst <= 1e-9, f"N=1 routed energies {worst} mJ from simulate_trace")

    # ---- 4096 devices: graph against eager, card against CPU -----------------
    def fleet(n, dev, budget):
        return uniform_fleet(n, strategies=("on_off", "idle_waiting", "adaptive"),
                             method=IdlePowerMethod.METHOD1_2, e_budget_mj=budget, powerup_overhead_mj=cal,
                             device=dev)

    params = fleet(FLEET_N, DEV, 300.0)
    rng = np.random.default_rng(0)
    glob = rng.poisson(0.5 * FLEET_N, FLEET_BIG_TICKS).astype(np.int32)
    for router in ("round_robin", "least_loaded", "power_aware"):
        kw = dict(router=router, collect_events=True)
        run_routed(params, glob, 40.0, **kw)                       # capture and caches once
        graph, g_s = _timed(lambda: run_routed(params, glob, 40.0, **kw))
        eager, e_s = _timed(lambda: run_routed(params, glob, 40.0, jit=False, **kw))
        _same(graph.state, eager.state, state_fields, f"graph vs eager ({router})")
        _same(graph, eager, ("alive_over_time", "served_over_time", "queued_over_time", "latency_ms",
                             "served_mask", "reconfig_mask", "released_mask", "queue_depth",
                             "dropped_per_tick"), f"graph vs eager ({router})")
        cpu = run_routed(fleet(FLEET_N, "cpu", 300.0), glob, 40.0, **kw)
        _same(graph.state, cpu.state, state_fields, f"card vs CPU ({router})")
        _same(graph, cpu, ("alive_over_time", "served_over_time", "latency_ms"), f"card vs CPU ({router})")
        e_card, e_cpu = float(graph.energy_mj.sum()), float(cpu.energy_mj.sum())
        check(abs(e_card - e_cpu) <= 1e-12 * abs(e_cpu), f"fleet energy card {e_card!r} vs CPU {e_cpu!r}")
        _rates(f"routed {router}, {FLEET_N} devices, {FLEET_BIG_TICKS} ticks", FLEET_N, FLEET_BIG_TICKS,
               e_s, g_s, card)
    direct = torch.from_numpy(rng.poisson(0.4, (FLEET_BIG_TICKS, FLEET_N)).astype(np.int32))
    graph = run_routed(params, direct, 40.0, router=None)
    _same(graph.state, run_routed(params, direct, 40.0, router=None, jit=False).state, state_fields,
          "graph vs eager (direct)")
    _same(graph.state, run_routed(fleet(FLEET_N, "cpu", 300.0), direct, 40.0, router=None).state,
          state_fields, "card vs CPU (direct)")
    state, start = None, 0
    for size in (100, 37, 113):
        state = run_routed(params, glob[start:start + size], 40.0, router="power_aware", state0=state,
                           start_tick=start).state
        start += size
    _same(state, run_routed(params, glob, 40.0, router="power_aware").state, state_fields,
          "chunked continuation")
    periodic = fleet(FLEET_N, DEV, 2000.0)
    steps = 2500
    run_periodic(periodic, steps)
    graph, g_s = _timed(lambda: run_periodic(periodic, steps))
    eager, e_s = _timed(lambda: run_periodic(periodic, steps, jit=False))
    _same(graph, eager, per_fields, "periodic graph vs eager")
    _same(graph, run_periodic(fleet(FLEET_N, "cpu", 2000.0), steps), per_fields, "periodic card vs CPU")
    _rates(f"periodic, {FLEET_N} devices, {steps} steps", FLEET_N, steps, e_s, g_s, card)
    print(f"  {FLEET_N} devices: graph = eager and card = CPU in every per-device field and trajectory "
          f"(three routers, direct streams, periodic); a 100 + 37 + 113-tick continuation = one run")

    # ---- 1,048,576 devices, periodic at 2 J until every device has died -------
    _reset_peak()
    big = fleet(FLEET_BIG, DEV, FLEET_BIG_BUDGET_J * 1000.0)
    limit = (big.e_budget_mj + em.FLOOR_EPS * (big.e_item_mj + big.e_idle_mj)).cpu().numpy()
    e_item, e_idle = big.e_item_mj.cpu().numpy(), big.e_idle_mj.cpu().numpy()
    per = np.where(big.is_onoff.cpu().numpy(), e_item, e_item + e_idle)
    n_cap = -(-(int(np.ceil(np.max((limit + e_idle) / per))) + 2) // 4096) * 4096
    run_periodic(big, n_cap)
    graph, g_s = _timed(lambda: run_periodic(big, n_cap))
    eager, e_s = _timed(lambda: run_periodic(big, n_cap, jit=False))
    _same(graph, eager, per_fields, "1M periodic graph vs eager")
    check(not bool(graph.alive.any()), "1M periodic: devices still alive at the step cap")
    n_items = graph.n_items.cpu().numpy()
    want = {"on_off": em.onoff_n_max(item, FLEET_BIG_BUDGET_J * 1000.0, cal),
            "idle_waiting": em.idlewait_n_max(item, 40.0, FLEET_BIG_BUDGET_J * 1000.0, 24.0, cal)}
    want["adaptive"] = want["idle_waiting"]      # 40 ms lies below the crossover: Idle-Waiting
    for k, name in enumerate(("on_off", "idle_waiting", "adaptive")):
        check(bool((n_items[k::3] == want[name]).all()), f"1M periodic {name}: counts differ from the closed form")
    led_err = graph.ledger().assert_conserves(graph.energy_mj.cpu().numpy())
    _rates(f"periodic, {FLEET_BIG} devices, {n_cap} steps (all dead after "
           f"{int((graph.alive_over_time > 0).sum())})", FLEET_BIG, n_cap, e_s, g_s, card)
    print(f"  1M periodic at {FLEET_BIG_BUDGET_J} J: items {want} per strategy as the closed forms; ledger "
          f"conservation {led_err:.3e}; peak {_peak() / 1e9:.4f} GB [{card}]")
    del graph, eager

    # ---- 1,048,576 devices routed: power_aware, Poisson at load 0.5 -----------
    _reset_peak()
    big = fleet(FLEET_BIG, DEV, em.PAPER_ENERGY_BUDGET_MJ)
    glob = np.random.default_rng(1).poisson(0.5 * FLEET_BIG, FLEET_BIG_TICKS).astype(np.int32)
    kw = dict(router="power_aware", queue_capacity=16, collect_latency=False)
    run_routed(big, glob[:GRAPH_WARM], 40.0, **kw)            # allocator and sort workspaces
    graph, g_s = _timed(lambda: run_routed(big, glob, 40.0, **kw))
    eager, e_s = _timed(lambda: run_routed(big, glob, 40.0, jit=False, **kw))
    _same(graph.state, eager.state, state_fields, "1M routed graph vs eager")
    s = graph.state
    served, queued, dropped = int(s.n_served.sum()), int(s.q_len.sum()), int(s.n_dropped.sum())
    arrived = int(glob.astype(np.int64).sum())
    print(f"  1M routed power_aware: arrived {arrived} = served {served} + queued {queued} + dropped "
          f"{dropped}; peak {_peak() / 1e9:.4f} GB")
    check(arrived == served + queued + dropped, "1M routed: requests not conserved")
    _rates(f"routed power_aware, {FLEET_BIG} devices, {FLEET_BIG_TICKS} ticks", FLEET_BIG,
           FLEET_BIG_TICKS, e_s, g_s, card)
    del big, graph, eager, s

    # ---- batched arrivals at 10^5 streams -------------------------------------
    gen = torch.Generator(DEV)
    g = pa.PoissonArrivals(40.0).sample_gaps(gen.manual_seed(0), ARRIVAL_STREAMS, ARRIVAL_GAPS).cpu().numpy().ravel()
    check(abs(g.mean() - 40.0) < 4.0 * 40.0 / math.sqrt(g.size), f"Poisson mean {g.mean()}")
    check(abs(g.var(ddof=1) - 1600.0) < 5.0 * 1600.0 * math.sqrt(8.0 / g.size), f"Poisson variance {g.var()}")
    mmpp = pa.MMPPArrivals(5.0, 500.0, mean_burst_len=8.0, mean_quiet_len=2.0)
    gm = mmpp.sample_gaps(gen.manual_seed(1), ARRIVAL_STREAMS, ARRIVAL_GAPS).cpu().numpy().ravel()
    pb = 0.8
    m1, m2 = pb * 5.0 + 0.2 * 500.0, pb * 2.0 * 25.0 + 0.2 * 2.0 * 250_000.0
    cv2 = gm.var(ddof=1) / gm.mean() ** 2
    check(abs(gm.mean() / mmpp.mean_period_ms() - 1.0) < 0.05 and abs(cv2 / (m2 / m1**2 - 1.0) - 1.0) < 0.2,
          f"MMPP mean {gm.mean()} / CV² {cv2}")
    print(f"  10^5 streams: Poisson mean {g.mean():.4f} (40), variance {g.var(ddof=1):.2f} (1600); MMPP mean "
          f"{gm.mean():.4f} ({mmpp.mean_period_ms():.4f}), CV² {cv2:.4f} ({m2 / m1**2 - 1.0:.4f})")
    for proc in (pa.PoissonArrivals(40.0), mmpp):
        horizon, m = 4000.0, 192
        draws = proc._draws(gen.manual_seed(2), ARRIVAL_STREAMS, m - 1)
        t_card = torch.cat([torch.zeros((ARRIVAL_STREAMS, 1), dtype=torch.float64, device=DEV),
                            torch.cumsum(proc._gaps_from_draws(*draws), dim=1)], dim=1).cpu()
        gaps_cpu = proc._gaps_from_draws(*(d.cpu() for d in draws))
        t_cpu = torch.cat([torch.zeros((ARRIVAL_STREAMS, 1), dtype=torch.float64), torch.cumsum(gaps_cpu, 1)], 1)
        inside = (t_cpu < horizon) | (t_card < horizon)
        moved = inside & (torch.floor(t_card / 40.0) != torch.floor(t_cpu / 40.0))
        edge = torch.abs(t_cpu - 40.0 * torch.round(t_cpu / 40.0)) < 1e-9
        bins = int((pa.bin_arrival_counts(torch.where(t_card < horizon, t_card, torch.inf), horizon, 40.0)
                    != pa.bin_arrival_counts(torch.where(t_cpu < horizon, t_cpu, torch.inf), horizon, 40.0)).sum())
        rel = float(((t_card - t_cpu).abs() / t_cpu.clamp_min(1e-300))[inside].max())
        print(f"  {proc.name}: card against CPU from the same draws, {int(inside.sum())} arrivals: times "
              f"within {rel:.3e} relative; {int(moved.sum())} arrivals change tick ({int((moved & edge).sum())} "
              f"within 1e-9 ms of an edge), {bins} bin counts differ")
        check(bool((moved <= edge).all()), f"{proc.name}: an arrival away from a tick edge changed tick")

# ---------------------------------------------------------------------------
# The optimizer and the learned timeout policy
# ---------------------------------------------------------------------------
OPT_STARTS, OPT_STEPS = 16, 250             # launch/optimize.py's defaults
OPT_DENSIFY = (11, 101, 10_001, 1_000_001)  # its --densify default
PLAN_DEVICES = 1 << 20                      # the fleet phase's mix, 1,048,576 devices
PLAN_HORIZON_S = 3600.0                     # launch/optimize.py's planner horizon
PLAN_BUDGET_SCALE = 0.05                    # and its budget: N × 4147 J × 0.05
POLICY_STREAMS = 1 << 20                    # streams of the big rollout
POLICY_GAPS = 512                           # MMPP gaps a stream
POLICY_CPU_STRIDE = POLICY_STREAMS // 64    # the CPU reruns 64 of them
POLICY_TIMED_STEPS = 5                      # BP and ES steps timed at TrainSettings()'s sizes (10 until
                                            # the mesh phase's (j) needed the time)
POLICY_DEFAULT_LIMIT_S = 120.0              # train at the default sizes only below this estimate


def _optimize_cli() -> dict:
    """``python -m repro_torch.launch.optimize --smoke`` on ``DEV`` → its
    payload, every section's self-check held."""
    p = _launcher("optimize", ROOT / "build" / "chip_smoke_optimize.json", "--smoke")
    check(p["config"]["exact_match"] and p["lifetime"]["exact_match"], "launch.optimize: descent != sweep")
    check(all(r["agree"] for r in p["densify"]["rows"]), "launch.optimize: a densified row disagrees")
    check(p["frontier"]["covers_exact_frontier"], "launch.optimize: the traced frontier misses a point")
    check(all(s["replay"]["exact"] for s in p["planner"]["objectives"].values()), "launch.optimize: replay")
    return p


def optimize_phase(card: str) -> None:
    """Descent at the CLI's defaults (16 starts × 250 steps) on both FPGA
    devices against the exhaustive sweeps and the CPU; the densified clock
    axes; the λ-traced frontier against the exact one; the budget planner on a 1,048,576-device periodic fleet under both
    objectives, replayed through ``run_periodic`` on the card bit for bit;
    ``launch.optimize --smoke`` in this process."""
    import numpy as np
    import torch

    from repro_torch.core import energy_model as em
    from repro_torch.core.batch_eval import SweepGrid, config_phase_grid, sweep_batch
    from repro_torch.core.config_phase import DEVICES, SPARTAN7_XC7S15, SPI_CLOCKS_MHZ
    from repro_torch.core.pareto import config_pareto
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.fleet import uniform_fleet
    from repro_torch.optimize import (
        DescentSettings,
        optimize_config,
        optimize_lifetime,
        plan_budgets,
        replay_allocation,
        trace_config_frontier,
    )

    cal = em.CALIBRATED_POWERUP_OVERHEAD_MJ
    st = DescentSettings(n_starts=OPT_STARTS, steps=OPT_STEPS)
    for dev in DEVICES.values():
        e = config_phase_grid(dev, device=DEV)["config_energy_mj"].cpu().numpy()
        ix = np.unravel_index(np.argmin(e), e.shape)
        res, s_cfg = _timed(lambda: optimize_config(dev, settings=st, torch_device=DEV))
        cpu = optimize_config(dev, settings=st, torch_device="cpu")
        grid = SweepGrid(devices=(dev,), request_periods_ms=(40.0,), idle_methods=(IdlePowerMethod.METHOD1_2,),
                         powerup_overhead_mj=cal)
        lt = sweep_batch(grid, device=DEV)["adaptive_lifetime_ms"].cpu().numpy()
        jx = np.unravel_index(np.argmax(lt), lt.shape)
        life, s_life = _timed(lambda: optimize_lifetime(dev, powerup_overhead_mj=cal, settings=st,
                                                        torch_device=DEV))
        cpu_life = optimize_lifetime(dev, powerup_overhead_mj=cal, settings=st, torch_device="cpu")
        print(f"  {dev.name}: config argmin {res.best} in {s_cfg:.3f} s ({len(res.candidates)} candidates, "
              f"{OPT_STARTS}×{OPT_STEPS}); adaptive-lifetime argmax at 40 ms {life.best} in {s_life:.3f} s [{card}]")
        check(res.best == {"buswidth": (1, 2, 4)[ix[1]], "clock_mhz": float(SPI_CLOCKS_MHZ[ix[2]]),
                           "compression": bool(ix[3]), "config_energy_mj": float(e[ix])},
              f"{dev.name}: descent's config argmin differs from the 66-point sweep")
        check(life.best["lifetime_ms"] == float(lt[jx]) and life.best["clock_mhz"] == float(SPI_CLOCKS_MHZ[jx[2]]),
              f"{dev.name}: descent's lifetime argmax differs from the sweep")
        check(res.best == cpu.best and life.best == cpu_life.best, f"{dev.name}: card and CPU answers differ")
        check(bool(np.allclose(res.loss_curve, cpu.loss_curve, rtol=1e-9, atol=0.0)),
              f"{dev.name}: the card's loss curve departs from the CPU's")

    dev = SPARTAN7_XC7S15
    lo, hi = min(SPI_CLOCKS_MHZ), max(SPI_CLOCKS_MHZ)
    for n in OPT_DENSIFY:
        clocks = tuple(np.linspace(lo, hi, n))
        g, s_sweep = _timed(lambda: config_phase_grid(dev, clocks_mhz=clocks, device=DEV)["config_energy_mj"])
        ix = np.unravel_index(int(torch.argmin(g)), g.shape)
        res, s_opt = _timed(lambda: optimize_config(dev, clocks_mhz=clocks, settings=st, torch_device=DEV))
        print(f"  densified {n} clocks ({6 * n} points): sweep {s_sweep:.4f} s, descent {s_opt:.3f} s, "
              f"best {res.best['config_energy_mj']!r} mJ at {res.best['clock_mhz']!r} MHz [{card}]")
        check(res.best["clock_mhz"] == float(clocks[ix[2]]) and res.best["config_energy_mj"] == float(g[ix]),
              f"densified {n}: descent's argmin differs from the sweep's")

    traced, s_tr = _timed(lambda: trace_config_frontier(dev, settings=st, torch_device=DEV))
    exact = {(r["buswidth"], r["clock_mhz"], r["compression"]) for r in config_pareto(dev, device=DEV)}
    got = {(r["buswidth"], r["clock_mhz"], r["compression"]) for r in traced["points"]}
    print(f"  {dev.name} frontier: 13 λ × {OPT_STARTS} starts × {OPT_STEPS} steps in {s_tr:.3f} s, "
          f"{traced['traced_points']} traced, {len(got)} on the front, exact front {len(exact)} [{card}]")
    check(exact <= got, f"{dev.name}: the traced frontier misses an exact frontier point")

    _reset_peak()
    fleet = uniform_fleet(PLAN_DEVICES, strategies=("on_off", "idle_waiting", "adaptive"),
                          method=IdlePowerMethod.METHOD1_2, powerup_overhead_mj=cal, device=DEV)
    caps = np.maximum(np.floor(PLAN_HORIZON_S * 1000.0 / fleet.period_ms.cpu().numpy()), 0.0).astype(np.int64)
    budget = PLAN_DEVICES * em.PAPER_ENERGY_BUDGET_MJ * PLAN_BUDGET_SCALE
    for objective in ("min_lifetime", "total_requests"):
        t0 = time.perf_counter()
        alloc = plan_budgets(fleet, budget, caps, objective=objective)
        plan_s = time.perf_counter() - t0
        rep, rep_s = _timed(lambda: replay_allocation(fleet, alloc))
        steps = rep["n_steps"]
        print(f"  plan {objective}, {PLAN_DEVICES} devices: {alloc.total_requests} requests, lifetimes "
              f"{alloc.min_lifetime_ms!r}–{float(alloc.predicted_lifetime_ms.max())!r} ms, leftover "
              f"{alloc.leftover_mj!r} mJ; host {plan_s:.3f} s; replay {steps} steps in {rep_s:.3f} s, "
              f"{PLAN_DEVICES * steps / rep_s:.4e} device-steps/s, exact {rep['exact']}; peak "
              f"{_peak() / 1e9:.4f} GB [{card}]")
        check(rep["exact"] and rep["n_items_match"], f"1M plan {objective}: the replay is not exact")
        check(float(alloc.budgets_mj.sum()) + alloc.leftover_mj == budget and alloc.leftover_mj >= 0.0,
              f"1M plan {objective}: budget not conserved")
        del rep
    del fleet

    p = _optimize_cli()
    print(f"  launch.optimize --smoke: config {p['config']['descent_argmin']}, densify "
          f"{[r['grid_points'] for r in p['densify']['rows']]} agree, planner "
          f"{ {k: v['total_requests'] for k, v in p['planner']['objectives'].items()} } requests replayed exactly")


def _flash_crowd_gain(trained, item, cal) -> tuple[int, int]:
    """Items served within 1500 mJ by the learned policy and the analytical
    hybrid on six flash-crowd traces (the reference's acceptance test)."""
    import numpy as np
    import torch

    from repro_torch.core.adaptive import PolicyController
    from repro_torch.core.arrivals import FlashCrowdArrivals
    from repro_torch.core.simulator import simulate_trace
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.policy import LearnedTimeoutPolicy

    t = trained.t_be_ms
    proc = FlashCrowdArrivals(quiet_ms=6.0 * t, flash_gap_ms=0.02 * t, flash_len=32, flash_every=4.0)
    learned = hybrid = 0
    for seed in range(6):
        gaps = proc.sample_gaps(torch.Generator().manual_seed(seed), 1, 999)[0].numpy()
        trace = np.concatenate([[0.0], np.cumsum(gaps)])
        learned += simulate_trace(item, trace, LearnedTimeoutPolicy(trained, item=item), 1500.0, cal).n_items
        hybrid += simulate_trace(item, trace, PolicyController(item=item, method=IdlePowerMethod.METHOD1_2,
                                                               powerup_overhead_mj=cal), 1500.0, cal).n_items
    return learned, hybrid


def _policy_training(card: str, item, cal):
    """``launch.policy --smoke`` (``train_policy`` at ``TrainSettings.smoke()``
    on the card, the stationary and nonstationary checks, the throughput
    block), its trained policy loaded back from the JSON it writes and held
    to the reference's criteria; determinism and card = CPU on a short run;
    the default sizes trained, or timed over a few steps on the card and
    the host → the trained policy."""
    import numpy as np
    import torch

    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.policy import TrainedPolicy, TrainSettings, train_policy
    from repro_torch.policy import net as N
    from repro_torch.policy.rollout import make_consts
    from repro_torch.policy.train import _bp_run, _es_run, sample_training_gaps, training_processes

    m12 = IdlePowerMethod.METHOD1_2
    saved = ROOT / "build" / "chip_smoke_trained_policy.json"
    # calibrated: the power-up overhead of the reference's acceptance tests
    p = _launcher("policy", ROOT / "build" / "chip_smoke_policy.json", "--smoke", "--calibrated",
                  "--policy-out", str(saved))
    tr, ns = p["train"], p["nonstationary"]
    smoke_s = tr["train_s"]
    print(f"  launch.policy --smoke: train_policy at TrainSettings.smoke() {smoke_s} s ({tr['improvement_frac']:+.2%}), "
          f"stationary exact {p['stationary']['all_exact']}, nonstationary wins {ns['wins_vs_hybrid']} "
          f"({[round(w['lifetime_gain_vs_hybrid'], 3) for w in ns['workloads']]}x), throughput "
          f"{p['throughput']['rollout']['steps_per_s']:.4e} policy-steps/s (64 × 256) [{card}]")
    check(p["stationary"]["all_exact"], "launch.policy: stationary-limit equivalence violated")
    check(ns["acceptance_met"], "launch.policy: the learned policy did not beat the hybrid on both workloads")
    trained = TrainedPolicy.from_json_dict(json.loads(saved.read_text()))
    check(trained.meta["powerup_overhead_mj"] == cal, "the saved policy was trained for another overhead")
    h = trained.history
    learned, hybrid = _flash_crowd_gain(trained, item, cal)
    print(f"  its saved policy: hard cost {h['baseline_hard']:.6f} → {h['final_hard']:.6f} "
          f"({1.0 - h['final_hard'] / h['baseline_hard']:+.2%}); flash crowd: learned {learned} items, hybrid "
          f"{hybrid} ({learned / hybrid:.3f}x)")
    check(h["final_hard"] < 0.95 * h["baseline_hard"], "smoke training improved the hard objective by < 5 %")
    check(learned > 1.05 * hybrid, "the learned policy beat the hybrid on the flash crowd by < 5 %")

    tiny = TrainSettings(hidden=(8,), n_streams=8, n_gaps=48, bp_steps=3, es_steps=2, es_pop=4)
    a, b = (train_policy(item, m12, cal, settings=tiny, device=DEV) for _ in range(2))
    c = train_policy(item, m12, cal, settings=tiny, device="cpu")
    check(all(np.array_equal(x["w"], y["w"]) and np.array_equal(x["b"], y["b"]) for x, y in zip(a.params, b.params)),
          "training is not deterministic in its seed")
    err = max(float(np.max(np.abs(x[k] - y[k]))) for x, y in zip(a.params, c.params) for k in ("w", "b"))
    print(f"  a short run (3 BP + 2 ES steps) twice on {DEV}: bit for bit; against the CPU: {err:.3e} [{card}]")
    check(err <= 1e-9, f"short training: {DEV} {err} from the CPU")

    full = TrainSettings()
    estimate = smoke_s * (full.n_gaps / 256) * max(full.bp_steps / 150, full.es_steps / 40)
    if estimate <= POLICY_DEFAULT_LIMIT_S:
        full_trained, full_s = _timed(lambda: train_policy(item, m12, cal, settings=full, device=DEV))
        print(f"  train_policy at TrainSettings(): {full_s:.2f} s, hard cost "
              f"{full_trained.history['final_hard']:.6f} [{card}]")
        return trained
    consts = make_consts(item, m12, cal)
    for where in dict.fromkeys((DEV, "cpu")):
        dev = torch.device(where)
        gaps = sample_training_gaps(training_processes(consts["t_be"]), full.n_streams, full.n_gaps, 0, dev)
        params = N.to_tensors(N.init_mlp(torch.Generator().manual_seed(0), hidden=full.hidden), dev)
        bp_lr, es_lr = (torch.tensor(x, dtype=torch.float64, device=dev) for x in (full.bp_lr, full.es_lr))
        _, bp_s = _timed(lambda: _bp_run(params, gaps, consts, bp_lr, POLICY_TIMED_STEPS))
        _, es_s = _timed(lambda: _es_run(params, gaps, consts, es_lr, full.es_sigma, POLICY_TIMED_STEPS,
                                         full.es_pop // 2, generator=torch.Generator().manual_seed(1)))
        bp_step, es_step = bp_s / POLICY_TIMED_STEPS, es_s / POLICY_TIMED_STEPS
        print(f"  TrainSettings() on {where} ({full.n_streams} streams × {full.n_gaps} gaps, hidden {full.hidden}; "
              f"the smoke time puts it at ~{estimate:.0f} s > {POLICY_DEFAULT_LIMIT_S:.0f} s): {POLICY_TIMED_STEPS} BP "
              f"steps {bp_s:.3f} s ({bp_step * 1e3:.2f} ms a step), {POLICY_TIMED_STEPS} ES steps {es_s:.3f} s "
              f"({es_step * 1e3:.2f} ms a step, population {full.es_pop}): {full.bp_steps} + {full.es_steps} "
              f"steps extrapolate to {full.bp_steps * bp_step + full.es_steps * es_step:.1f} s "
              f"[{card if where == 'cuda' else 'the host CPU'}]")
    return trained


def _policy_rollouts(card: str, item, cal, trained) -> None:
    """The rollout against ``simulate_trace``, and the 1M-stream rollout
    (policy-steps/s, peak memory, a strided slice against the CPU, the
    ledger's conservation)."""
    import math

    import numpy as np
    import torch

    from repro_torch.core.adaptive import FixedTimeoutPolicy
    from repro_torch.core.arrivals import MMPPArrivals
    from repro_torch.core.simulator import simulate_trace
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.obs import ledger_from_rollout
    from repro_torch.policy import LearnedTimeoutPolicy, untrained_policy
    from repro_torch.policy.rollout import rollout

    proc = MMPPArrivals(burst_ms=2.0, quiet_ms=4000.0, mean_burst_len=12.0, mean_quiet_len=3.0)
    gaps = proc.sample_gaps(torch.Generator(DEV).manual_seed(0), 16, 300)
    host = gaps.cpu().numpy()
    untrained = untrained_policy(item, method=IdlePowerMethod[trained.meta["method"]], powerup_overhead_mj=cal)
    worst = {}
    for label, pol, tol in (("untrained", untrained, 1e-9), ("trained", trained, 1e-6)):
        c = dict(pol.consts, budget=400.0)
        out = {k: v.cpu().numpy() for k, v in rollout(pol.params, gaps, c, device=DEV).items()}
        err = 0.0
        for i in range(host.shape[0]):
            policy = (FixedTimeoutPolicy(timeout_ms=pol.t_be_ms, idle_power_mw=pol.consts["p_idle"])
                      if label == "untrained" else
                      LearnedTimeoutPolicy(pol, item=item, guard=False, snap_lo=0.0, snap_hi=math.inf))
            res = simulate_trace(item, np.concatenate([[0.0], np.cumsum(host[i])]), policy, 400.0, cal)
            check((res.n_items, res.configurations, res.releases) == (int(out["n_items"][i]),
                                                                      int(out["configurations"][i]),
                                                                      int(out["releases"][i])),
                  f"{label} rollout stream {i}: counts differ from simulate_trace")
            err = max(err, abs(res.energy_used_mj - out["energy_mj"][i]) / max(abs(res.energy_used_mj), 1e-300))
        worst[label] = err
        check(err <= tol, f"{label} rollout: energy {err} from simulate_trace (limit {tol})")
    print(f"  rollout on the card against simulate_trace, 16 MMPP streams × 300 gaps at 400 mJ: counts exact, "
          f"energies within {worst['untrained']:.3e} (untrained, limit 1e-9) and {worst['trained']:.3e} "
          f"(trained, limit 1e-6) relative")

    _reset_peak()
    big = MMPPArrivals(burst_ms=20.0, quiet_ms=4000.0, mean_burst_len=12.0, mean_quiet_len=3.0)
    gaps, gap_s = _timed(lambda: big.sample_gaps(torch.Generator(DEV).manual_seed(1), POLICY_STREAMS, POLICY_GAPS))
    sample_peak = _peak()
    c = dict(trained.consts, budget=1500.0)
    rollout(trained.params, gaps[:1024, :8], c, device=DEV)         # warm-up
    _reset_peak()
    base = _allocated()
    out, roll_s = _timed(lambda: rollout(trained.params, gaps, c, device=DEV))
    steps = POLICY_STREAMS * POLICY_GAPS
    print(f"  rollout of {POLICY_STREAMS} streams × {POLICY_GAPS} MMPP gaps ({gaps.numel() * 8 / 1e9:.2f} GB of "
          f"gaps, sampled in {gap_s:.3f} s, sampler peak {sample_peak / 1e9:.3f} GB): {roll_s:.3f} s, "
          f"{steps / roll_s:.4e} policy-steps/s, peak {(_peak() - base) / 1e9:.4f} GB above the gaps [{card}]")
    cpu = rollout(trained.params, gaps[::POLICY_CPU_STRIDE].cpu(), c, device="cpu")
    err = 0.0
    for k, v in cpu.items():
        mine = out[k][::POLICY_CPU_STRIDE].cpu()
        if k in ("n_items", "configurations", "releases"):
            check(torch.equal(mine, v), f"1M rollout: {k} on the card differs from the CPU's")
        else:
            err = max(err, float(((mine - v).abs() / v.abs().clamp_min(1e-300)).max()))
    led = ledger_from_rollout(out, c)
    cons = led.assert_conserves(out["energy_mj"].cpu().numpy(), rtol=1e-9)
    print(f"  its {POLICY_STREAMS // POLICY_CPU_STRIDE} strided streams on the CPU: counts equal, energies within "
          f"{err:.3e} relative; ledger conservation {cons:.3e}; mean {float(out['n_items'].mean()):.2f} items, "
          f"{float(out['configurations'].mean()):.2f} configurations a stream")
    check(err <= 1e-9, f"1M rollout: energies {err} from the CPU's")
    del gaps, out


def _learned_serving(card: str, trained) -> tuple[int, int]:
    """``REQUESTS`` requests at ``PERIOD_S`` to full-width qwen3-1.7b under
    ``strategy="adaptive"`` with the trained policy, on the serving phase's
    checkpoint; the configurations held to a fresh copy of the policy fed
    the gaps and the measured phases the controller saw → (dequant, flash
    launches)."""
    import torch

    from repro_torch.core.adaptive import controller_timeout_s, measured_workload_item
    from repro_torch.core.phases import CONFIGURATION, INFERENCE
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.serve import build_demo
    from repro_torch.policy import LearnedTimeoutPolicy
    from repro_torch.serving.scheduler import run_schedule

    check(any(CKPT_DIR.glob("step_*.ckpt")), f"no serving-phase checkpoint in {CKPT_DIR}")
    make = lambda: LearnedTimeoutPolicy(trained, method=IdlePowerMethod.BASELINE)  # noqa: E731
    controller, make_request = build_demo(ARCH, reduced=False, device="cuda", ckpt_dir=str(CKPT_DIR),
                                          strategy="adaptive", policy=make())
    requests = [make_request() for _ in range(REQUESTS)]
    dq.launches = 0
    fa.launches = 0
    res = run_schedule(controller, iter(requests), period_s=PERIOD_S)
    n_dq, n_fa = dq.launches, fa.launches
    if controller.handle is not None:
        controller.release_fn(controller.handle)
        controller.handle = None
    torch.cuda.synchronize()
    prefills = res.n_requests + res.n_configurations            # + bring-up warm-ups

    # a fresh copy, fed what the controller saw, request by request
    fresh, power, recs = make(), controller.power, controller.records
    infs = [i for i, r in enumerate(recs) if r.name == INFERENCE]
    periods = controller._observed_periods
    predicted, decided = 1, []
    for k in range(len(infs) - 1):
        if k >= 1:
            fresh.observe_gap(periods[k - 1] * 1000.0)
        cfg = [recs[i] for i in range(infs[k]) if recs[i].name == CONFIGURATION][-1]
        item = measured_workload_item("measured", power.config_mw, cfg.wall_s, power.infer_mw,
                                      recs[infs[k]].wall_s, power.idle_mw)
        timeout = controller_timeout_s(fresh, item)
        span = sum(r.wall_s for r in recs[infs[k] + 1:infs[k + 1]] if r.name != CONFIGURATION)
        release = timeout is not None and span >= timeout
        predicted += release
        decided.append((round(span, 4), None if timeout is None else round(timeout, 4), fresh.regime()))
    print(f"  learned policy serving full-width {ARCH}: {res.n_requests} requests at {PERIOD_S} s, "
          f"{res.n_configurations} configurations (a fresh copy of the policy predicts {predicted}: "
          f"(idle span s, timeout s, regime) {decided}), energy {res.energy_mj:.1f} mJ, wall {res.wall_s:.3f} s, "
          f"summary {controller.policy.summary()}; dequant launches {n_dq}, flash launches {n_fa} [{card}]")
    check(res.n_requests == REQUESTS, f"learned serving: {res.n_requests} requests")
    check(res.n_configurations == predicted, "learned serving: configurations differ from the policy's decisions")
    check(n_dq == 8 * res.n_configurations and n_dq >= 8,
          f"learned serving: {n_dq} dequant launches for {res.n_configurations} bring-ups")
    check(n_fa == 28 * prefills, f"learned serving: {n_fa} flash launches for {prefills} prefills")
    check(torch.cuda.memory_allocated() < 1e8, "learned serving: memory still allocated after the release")
    return n_dq, n_fa


def policy_phase(card: str) -> tuple[int, int]:
    """The learned timeout policy on the card: ``launch.policy --smoke``
    (training, its criteria, its time), the rollout against
    ``simulate_trace`` and at 1,048,576 streams, then the trained policy
    serving full-width qwen3-1.7b → (dequant, flash launches)."""
    from repro_torch.core import energy_model as em
    from repro_torch.core.phases import paper_lstm_item

    item, cal = paper_lstm_item(), em.CALIBRATED_POWERUP_OVERHEAD_MJ
    trained = _policy_training(card, item, cal)
    _policy_rollouts(card, item, cal, trained)
    if DEV == "cpu":                                  # a CPU rehearsal serves nothing
        return 0, 0
    return _learned_serving(card, trained)


# ---------------------------------------------------------------------------
# Observability, Monte Carlo and the cost zoo
# ---------------------------------------------------------------------------
OBS_REQUESTS = 2                            # one On-Off request pair
OBS_NEW = 8                                 # tokens a request generates (launch.serve's default)
MC_SEEDS = 1024
MC_DEVICES = 4096
MC_STEPS = 2000
MC_CHUNK = 128                              # seeds a chunk: a 8.4 GB gap buffer
MC_CPU_STRIDE = 16                          # the CPU reruns every 16th seed of chunk 0


def _launcher(module: str, out: Path, *extra: str, device: str | None = None) -> dict:
    """``python -m repro_torch.launch.<module>`` at its defaults on ``device``
    (the card, ``DEV``, unless given), its JSON written to ``out`` → the
    payload.  The CLI's ``main`` runs in this process, its standard output
    printed indented: a process of its own would spend seconds importing
    torch and starting CUDA before its first kernel."""
    import gc
    import importlib

    import torch

    device = device or DEV
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    said = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(said):
            rc = importlib.import_module(f"repro_torch.launch.{module}").main(
                ["--device", device, "--out", str(out), *extra])
    finally:
        print("\n".join(f"  {line}" for line in said.getvalue().strip().splitlines()))
    check(rc in (0, None), f"python -m repro_torch.launch.{module} exited {rc}")
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    print(f"  launch.{module} {' '.join(extra)} on {device}: {time.perf_counter() - t0:.1f} s in this process")
    payload = json.loads(out.read_text())
    check(device == "cpu" or payload["manifest"]["card"] is not None, f"the {module} CLI's manifest has no card")
    return payload


def obs_phase(card: str) -> tuple[int, int, dict]:
    """An On-Off request pair of full-width qwen3-1.7b from the serving
    phase's checkpoint with a ``MetricsRegistry`` on the engine, its counts
    held to the controller's; then ``launch.obs`` at its defaults and its
    Chrome trace validated → (dequant, flash launches, the mean prefill and
    decode step seconds the registry measured)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.duty_cycle import DutyCycleController, PowerModel
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.obs import MetricsRegistry, validate_chrome_trace
    from repro_torch.serving.engine import bring_up_from_checkpoint
    from repro_torch.serving.scheduler import run_schedule

    cfg = get_config(ARCH)
    manager = CheckpointManager(str(CKPT_DIR), mode="zstd+int8")
    check(bool(manager.steps()), f"no serving-phase checkpoint in {CKPT_DIR}")
    reg = MetricsRegistry()
    rng = np.random.default_rng(7)
    batch = 2
    requests = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 32)),
                                           dtype=torch.int32, device="cuda")}
                for _ in range(OBS_REQUESTS)]
    controller = DutyCycleController(
        lambda: bring_up_from_checkpoint(cfg, manager, 96, device="cuda", metrics=reg),
        lambda engine, request: engine.generate(request, n_new=OBS_NEW),
        lambda engine: engine.release(),
        PowerModel(config_mw=90_000.0, infer_mw=200_000.0, idle_mw=65_000.0),
        "on_off",
    )
    dq.launches = 0
    fa.launches = 0
    res = run_schedule(controller, iter(requests), period_s=PERIOD_S)
    n_dq, n_fa = dq.launches, fa.launches
    torch.cuda.synchronize()
    d = reg.to_dict()
    print(f"  {res.n_requests} On-Off requests, {res.n_configurations} configurations; registry: "
          + ", ".join(f"{k} {m['value']}" for k, m in d.items() if m["type"] != "histogram"))
    for k, m in d.items():
        if m["type"] == "histogram":
            print(f"  {k}: n {m['total']}, mean {m['mean']:.3f} ms, p50 {m['p50']:.3f} ms, "
                  f"p99 {m['p99']:.3f} ms [{card}]")
    calls = d["engine_generate_calls"]["value"]
    check(res.n_requests == OBS_REQUESTS and calls == OBS_REQUESTS, f"generate calls {calls}")
    check(d["engine_bring_ups"]["value"] == res.n_configurations == OBS_REQUESTS,
          f"engine_bring_ups {d['engine_bring_ups']['value']} for {res.n_configurations} configurations")
    check(d["engine_tokens_generated"]["value"] == batch * OBS_NEW * calls,
          f"engine_tokens_generated {d['engine_tokens_generated']['value']}")
    check(d["engine_releases"]["value"] == res.n_configurations and d["engine_resident"]["value"] == 0,
          "engine_releases / engine_resident after the release")
    check(all(d[k]["total"] == n for k, n in (("engine_prefill_ms", calls), ("engine_decode_ms", calls),
                                              ("engine_bring_up_ms", res.n_configurations))),
          "histogram totals")
    check(n_dq == 8 * res.n_configurations and n_fa == 28 * calls,
          f"{n_dq} dequant and {n_fa} flash launches for {res.n_configurations} bring-ups, {calls} prefills")
    check(torch.cuda.memory_allocated() < 1e8, "memory still allocated after the release")

    out, trace = ROOT / "build" / "chip_smoke_obs.json", ROOT / "build" / "chip_smoke_obs_trace.json"
    payload = _launcher("obs", out, "--trace-out", str(trace))
    cons = payload["conservation"]
    check(all(err <= 1e-9 for err in cons.values()), f"obs self-checks: {cons}")
    problems = validate_chrome_trace(json.loads(trace.read_text()))
    check(problems == [], f"the obs Chrome trace is malformed: {problems[:3]}")
    tp = payload["throughput"]["periodic"]["fleet"]
    print(f"  launch.obs: conservation {json.dumps(cons)} (limit 1e-9); trace {payload['trace']['n_events']} "
          f"events on {payload['trace']['n_tracks']} tracks, valid; observability-off periodic "
          f"{tp['device_steps_per_s']} device-steps/s [{card}]")
    served = {"prefill_s": d["engine_prefill_ms"]["mean"] / 1e3,
              "decode_step_s": d["engine_decode_ms"]["mean"] / 1e3 / OBS_NEW, "batch": batch, "prompt": 32,
              "max_len": 96}
    return n_dq, n_fa, served


def mc_phase(card: str) -> None:
    """``launch.mc`` at its defaults; the periodic ensemble at 1024 seeds ×
    4096 devices × 2000 steps, a strided slice of its seeds held to the CPU
    on the same gaps; a one-seed routed ensemble held to ``run_routed``."""
    import numpy as np
    import torch

    from repro_torch.core import energy_model as em
    from repro_torch.core.arrivals import PoissonArrivals
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.fleet import run_routed, uniform_fleet
    from repro_torch.mc import periodic_ensemble, routed_ensemble, run_periodic_ensemble
    from repro_torch.mc.ensemble import chunk_seed

    payload = _launcher("mc", ROOT / "build" / "chip_smoke_mc.json")
    h = payload["headline"]
    ref = h["deterministic_reference"]
    check(round(ref["crossover_ms"], 4) == 499.0607 and round(ref["lifetime_ratio"], 4) == 12.4108,
          f"zero-jitter band {ref['crossover_ms']} ms, {ref['lifetime_ratio']}x")
    check(all(ref[k] for k in ("crossover_exact", "lifetime_ratio_exact", "energy_per_request_exact")),
          f"zero-jitter exactness: {ref}")
    agree = {k: v["delta"]["rel_disagreement"] for k, v in h.items() if isinstance(v, dict) and "delta" in v}
    check(all(x < 0.10 for x in agree.values()), f"delta and MC disagree: {agree}")
    tp = payload["throughput"]
    print(f"  launch.mc: zero-jitter {ref['crossover_ms']!r} ms and {ref['lifetime_ratio']!r}x exact; "
          f"delta/MC disagreement {json.dumps({k: round(v, 4) for k, v in agree.items()})} (limit 0.10); "
          f"ensemble {tp['ensemble']['seeds_per_s']} seeds/s against the looped baseline's "
          f"{tp['looped_baseline']['seeds_per_s']} ({tp['speedup_seeds_per_s']}x) [{card}]")

    def fleet(n, dev, budget_mj=1500.0):
        return uniform_fleet(n, strategies=("on_off", "idle_waiting", "adaptive"),
                             method=IdlePowerMethod.METHOD1_2, e_budget_mj=budget_mj,
                             powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ, device=dev)

    params, process = fleet(MC_DEVICES, DEV), PoissonArrivals(40.0)
    run_periodic_ensemble(params, process, 64, MC_CHUNK, seed_chunk=MC_CHUNK)    # caches and captures
    _reset_peak()
    ens, s = _timed(lambda: run_periodic_ensemble(params, process, MC_STEPS, MC_SEEDS, seed=0,
                                                  seed_chunk=MC_CHUNK))
    steps = MC_SEEDS * MC_DEVICES * MC_STEPS
    print(f"  periodic ensemble, {MC_SEEDS} seeds x {MC_DEVICES} devices x {MC_STEPS} steps "
          f"(Poisson 40 ms, 1.5 J, the strategy mix; {MC_CHUNK} seeds a chunk, sampling included): "
          f"{s:.3f} s, {MC_SEEDS / s:.1f} seeds/s, {steps / s:.4e} device-steps/s, peak "
          f"{_peak() / 1e9:.3f} GB; lifetime {ens.lifetime_ms.mean():.2f} ms mean over seeds "
          f"(std {ens.lifetime_ms.std(ddof=1):.3f}), {int(ens.total_items.sum())} requests [{card}]")
    check(ens.n_seeds == MC_SEEDS and bool(np.isfinite(ens.lifetime_ms).all()), "ensemble aggregates")
    ens.ledger.assert_conserves(ens.total_energy_mj)

    # chunk 0's gaps again, from its generator: a strided slice of its seeds on the card and the CPU
    gen = torch.Generator(DEV).manual_seed(chunk_seed(0, 0))
    gaps = process.sample_gaps(gen, MC_CHUNK * MC_DEVICES, MC_STEPS).view(MC_CHUNK, MC_DEVICES, MC_STEPS)
    idx = np.arange(0, MC_CHUNK, MC_CPU_STRIDE)
    sl = gaps[idx].permute(0, 2, 1).contiguous()
    card_s = periodic_ensemble(params, sl, keep_device_samples=True)
    cpu_s = periodic_ensemble(fleet(MC_DEVICES, "cpu"), sl.cpu(), keep_device_samples=True)
    for f in ("per_device_items", "per_device_energy_mj", "per_device_lifetime_ms"):
        check(np.array_equal(getattr(card_s, f), getattr(cpu_s, f)), f"ensemble card vs CPU: {f} differs")
    for f in ("lifetime_ms", "total_items", "total_energy_mj"):
        check(np.array_equal(getattr(ens, f)[idx], getattr(card_s, f)), f"ensemble slice vs the full run: {f}")
    print(f"  {idx.size} seeds of chunk 0 (every {MC_CPU_STRIDE}th): card = CPU bit for bit in counts, "
          f"energies and lifetimes, and = the full run's per-seed aggregates")
    del gaps, sl

    counts = np.random.default_rng(2).poisson(0.4, (1, FLEET_BIG_TICKS, MC_DEVICES)).astype(np.int32)
    r_params = fleet(MC_DEVICES, DEV, em.PAPER_ENERGY_BUDGET_MJ)
    one = routed_ensemble(r_params, counts, 40.0, keep_device_samples=True)
    direct = run_routed(r_params, counts[0], 40.0, router=None)
    lat = direct.latency_ms.cpu().numpy().astype(np.float64)[direct.served_mask.cpu().numpy()]
    check(np.array_equal(one.per_device_served[0], direct.n_served.cpu().numpy())
          and np.array_equal(one.per_device_energy_mj[0], direct.energy_mj.cpu().numpy())
          and one.p99_latency_ms[0] == np.percentile(lat, 99.0),
          "one-seed routed ensemble differs from run_routed")
    print(f"  one-seed routed ensemble, {MC_DEVICES} devices x {FLEET_BIG_TICKS} ticks = run_routed bit for "
          f"bit (served {int(one.served[0])}, p99 {one.p99_latency_ms[0]:.3f} ms)")


def costs_phase(card: str) -> dict:
    """``launch.costs`` at its defaults (its calibration section times the
    four kernels at the reference's pinned shapes); each kernel held to its
    plain version at that shape and timed beside it and the library call →
    the calibration's launches and rows, by kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.launch import costs as costs_cli

    payload = _launcher("costs", ROOT / "build" / "chip_smoke_costs.json")
    g = payload["golden"]
    check(g["item_matches_table2"] and g["crossover_ms"] == 499.06 and g["lifetime_ratio_40ms"] == 12.41,
          f"golden section {g}")
    cal = payload["calibration"]
    check(cal["device"] == "cuda" and cal["card"] is not None, f"calibration ran on {cal['device']}")
    fl = payload["fleet"]
    print(f"  launch.costs: {payload['size']} (model x batch) costs; fleet {fl['devices']} devices x "
          f"{fl['n_steps']} steps, ensemble {fl['ensemble']['n_seeds']} seeds; golden {json.dumps(g)}; "
          f"calibration on {cal['card']}")

    rows = {}
    for name, row in cal["kernels"].items():
        checks = costs_cli.calibration_accuracy(name, DEV)
        torch.cuda.synchronize()
        for what, c in checks.items():
            rel = f", rel_err {c['rel_err']:.4g} of max |plain|" if "rel_err" in c else ""
            print(f"  {name} at the pinned shape, {what}: {c['measure']}: max_abs_err {c['max_abs_err']:.4g}"
                  f"{rel} (limit {c['limit']:.4g} on {c['limit_on']})"
                  + "".join(f", {k} {c[k]:.4g}" for k in ("kernel_vs_float64", "plain_vs_float64",
                                                          "kernel_vs_plain", "max_abs_y") if k in c)
                  + f" [{card}]")
            check(c["ok"], f"{name} at the pinned shape ({what}): {c}")
        kernel, plain = costs_cli.calibration_inputs(name, DEV)
        k_ms, k_dev, p_ms = time_ms(kernel), graph_ms(kernel), time_ms(plain)
        lib_ms = None
        if name == "flash_attention":
            q, kk, v = (torch.randn((1, 1024, hh, 64), device=DEV, dtype=torch.bfloat16).transpose(1, 2)
                        for hh in (8, 2, 2))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, kk, v, is_causal=True, enable_gqa=True))
        elif name == "lstm":
            net = torch.nn.LSTM(6, 20, batch_first=True).cuda()
            x = torch.randn((1, 64, 6), device=DEV)
            with torch.no_grad():
                lib_ms = time_ms(lambda: net(x))
        bound = row["bound_us"] / 1e3
        print(f"  {name} {json.dumps(row['shape'])}: CLI {row['us']:.3f} us, kernel {k_ms:.5f} ms "
              f"({k_dev:.5f} ms of device time, CUDA graph), plain {p_ms:.5f} ms, library "
              f"{'none exists' if lib_ms is None else f'{lib_ms:.5f} ms'}, bound {bound:.6f} ms by "
              f"{row['bound_by']} ({row['flops'] / 1e9:.4f} G{row['op_dtype']} operations, "
              f"{row['hbm_bytes'] / 1e6:.4f} MB), efficiency {row['efficiency']:.4f} (at device time "
              f"{bound / k_dev:.4f}), launches {row['launches']} [{card}]")
        check(row["efficiency"] <= 1.0 and bound <= k_dev, f"{name}: faster than its bound, a count is wrong")
        main_check = checks["fp32" if name == "lstm" else "bf16"]
        rows[name] = dict(row, max_abs_err=main_check["max_abs_err"], limit=main_check["limit"],
                          limit_on=main_check["limit_on"], accuracy=checks, ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms)
    check(all(r["launches"] > 0 for r in rows.values()), "a kernel was not launched by the calibration")
    return rows


CONTROL_BUDGET_MJ = 50000.0                 # the CLI run's fleet budget (8 of the 16 devices admitted)
CONTROL_CLI_TICKS = 512                     # the CLI run: --smoke at 512 ticks, with the planner
CONTROL_WIDE = (2, 8, 16384)                # regions x racks x devices a rack: 262,144 devices
CONTROL_WIDE_TICKS = 512                    # 1024 until the mesh phase needed the time
CONTROL_WIDE_FAULTS = 4
CONTROL_WIDE_SMALL = (512, 512)             # devices a rack and ticks of its card-vs-CPU copy
CONTROL_DEVICES_PER_STREAM = 4              # the wide streams: one per 4 devices, each at 1/streams of the rate
CONTROL_SPINE = (1 << 20, 512)              # devices and ticks of the 1-region/1-rack collapse
CONTROL_DAY_TICKS = 86400                   # launch.control's default horizon (one diurnal day)
CONTROL_DEFAULT_LIMIT_S = 120.0             # run the CLI's defaults only below this estimate
CONTROL_SPLIT_CALLS = 5                     # 64-tick calls timed a path and a rack size
_STATE_FIELDS = ("energy_mj", "idle_energy_mj", "n_served", "n_configs", "n_released", "n_dropped",
                 "resident", "alive", "completion_ms", "queue_ms", "q_head", "q_len", "rr_ptr")


def _wide_args(seed: int = 0):
    """``launch.control``'s stream settings at their defaults (load 0.5)."""
    return types.SimpleNamespace(load=0.5, days=1.0, amplitude=0.8, flash_every=64.0,
                                 flash_len=256, seed=seed)


def _wide_topology(devices_per_rack: int, dev):
    """The CLI's rack configuration (Idle-Waiting devices, the calibrated
    power-up, a 2 s / 200 mJ rack bring-up, model axis 2) at the wide
    topology's 2 regions x 8 racks."""
    from repro_torch.control import uniform_topology
    from repro_torch.core import energy_model as em

    regions, racks, _ = CONTROL_WIDE
    return uniform_topology(regions, racks, devices_per_rack, strategies=("idle_waiting",),
                            request_period_ms=100.0,
                            powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ,
                            bringup_ms=2000.0, bringup_mj=200.0, model_axis=2, device=dev)


def _wide_run(topo, counts, n_ticks: int):
    """The CLI's main run on ``topo``: the crossover autoscaler, seeded
    faults, pack routing, the idle tail."""
    from repro_torch.control import CrossoverAutoscaler, random_schedule, run_hierarchy

    return run_hierarchy(topo, counts, 100.0, epoch_ticks=64,
                         autoscaler_factory=CrossoverAutoscaler.for_rack,
                         faults=random_schedule(topo, n_ticks, CONTROL_WIDE_FAULTS, seed=0),
                         heartbeat_timeout_s=2.0 * 64 * 100.0 / 1000.0,
                         rack_routing="pack", charge_idle_tail=True)


def _wide_small(counts, dev: str) -> tuple[dict, float]:
    """The wide topology at ``CONTROL_WIDE_SMALL`` on ``dev`` → every
    rack's state, the latencies and the reports as host arrays and JSON,
    and its seconds."""
    from repro_torch.control import hierarchy_report, verify_hierarchy

    per_rack, n_ticks = CONTROL_WIDE_SMALL
    topo = _wide_topology(per_rack, dev)
    res, s = _timed(lambda: _wide_run(topo, counts, n_ticks))
    out = {"latency_ms": res.latency_ms,
           "report": json.dumps({"report": hierarchy_report(res), "conservation": verify_hierarchy(res)})}
    for name, r in res.racks.items():
        for f in _STATE_FIELDS:
            out[f"{name}/{f}"] = getattr(r.state, f).cpu().numpy()
    return out, s


class _CallTimes:
    """Sums of the routed calls' wall time, CUDA-graph capture and replay."""

    def __init__(self):
        self.call = self.capture = self.replay = 0.0
        self.calls = self.captures = self.replays = 0


class _TimedGraph:
    def __init__(self, graph, times: _CallTimes):
        self.graph, self.times = graph, times

    def replay(self):
        _sync()
        t0 = time.perf_counter()
        self.graph.replay()
        _sync()
        self.times.replay += time.perf_counter() - t0
        self.times.replays += 1


@contextlib.contextmanager
def _timed_calls(times: _CallTimes):
    """Time every ``run_routed`` call the control plane makes, and each
    graph's capture and replay inside it, each between two synchronisations."""
    import repro_torch.control.simulate as sim
    import repro_torch.fleet.step as step

    capture, routed = step._capture, sim.run_routed

    def timed_capture(*a, **k):
        _sync()
        t0 = time.perf_counter()
        graph, static_x, static_y = capture(*a, **k)
        _sync()
        times.capture += time.perf_counter() - t0
        times.captures += 1
        return _TimedGraph(graph, times), static_x, static_y

    def timed_routed(*a, **k):
        _sync()
        t0 = time.perf_counter()
        out = routed(*a, **k)
        _sync()
        times.call += time.perf_counter() - t0
        times.calls += 1
        return out

    step._capture, sim.run_routed = timed_capture, timed_routed
    try:
        yield times
    finally:
        step._capture, sim.run_routed = capture, routed


def _call_split(devices_per_rack: int, jit: bool) -> _CallTimes:
    """``CONTROL_SPLIT_CALLS`` 64-tick epochs of one rack of the CLI's
    configuration at load 0.5, each a ``run_routed`` call of the carry."""
    import numpy as np

    import repro_torch.control.simulate as sim

    rack = _wide_topology(devices_per_rack, DEV).regions[0].racks[0]
    counts = np.random.default_rng(0).poisson(0.5 * devices_per_rack, 64 * (CONTROL_SPLIT_CALLS + 1))
    times, state = _CallTimes(), None
    for i in range(CONTROL_SPLIT_CALLS + 1):
        with _timed_calls(times if i else _CallTimes()):    # the first call warms the allocator up
            state = sim.run_routed(rack.params, counts[64 * i:64 * (i + 1)], 100.0, jit=jit,
                                   state0=state, start_tick=64 * i).state
    return times


def _same_payload(card: dict, cpu: dict, label: str) -> None:
    for key in ("kind", "config", "planner", "report", "self_check", "pareto"):
        check(card[key] == cpu[key], f"{label}: the card's {key} differs from the CPU's")
    check(card["throughput"]["hierarchy"]["device_ticks"] == cpu["throughput"]["hierarchy"]["device_ticks"],
          f"{label}: device ticks differ")
    check(DEV == "cpu" or card["manifest"]["card"] is not None and card["meta"]["device"] == DEV,
          f"{label}: the card's run has no card in its manifest")


def control_phase(card: str) -> None:
    """The CLI at ``--smoke --ticks 512 --fleet-budget-mj``, card against
    CPU (both self-checks, counts exact, energies bit for bit, the same
    frontier and plan); the wide topology's small copy card against CPU; a
    call's capture, replay and host time and the default day sim's
    estimate; the wide topology (262,144 devices) conserving within 1e-9;
    the 1,048,576-device spine bit for bit."""
    import numpy as np
    import torch

    from repro_torch.control import run_hierarchy, uniform_topology, verify_hierarchy
    from repro_torch.fleet import run_routed
    from repro_torch.launch.control import _global_counts

    cli_args = ("--smoke", "--ticks", str(CONTROL_CLI_TICKS), "--fleet-budget-mj", str(CONTROL_BUDGET_MJ))
    payloads = {dev: _launcher("control", ROOT / "build" / f"chip_smoke_control_{dev}.json", *cli_args,
                               device=dev)
                for dev in dict.fromkeys((DEV, "cpu"))}
    smoke = payloads[DEV]
    sc = smoke["self_check"]
    check(sc["collapse"]["bit_identical_to_run_routed"] and sc["collapse"]["latency_multiset_identical"]
          and sc["conservation"]["energy_error_total"] <= 1e-9, f"the CLI's self-checks: {sc}")
    _same_payload(smoke, payloads["cpu"], "launch.control")
    ev, slo = smoke["report"]["power_events"], smoke["report"]["slo"]
    print(f"  launch.control {' '.join(cli_args)}: card = CPU in counts, energies, latencies, frontier "
          f"and plan; collapse "
          f"{json.dumps(sc['collapse'])}; energy error {sc['conservation']['energy_error_total']:.3e}; "
          f"events {json.dumps(ev)}; served {slo['served']} of {slo['arrived']}, p99 "
          f"{slo['latency_p99_ms']} ms; frontier "
          f"{[smoke['pareto']['points'][i]['policy'] for i in smoke['pareto']['frontier']]}; planner "
          f"{json.dumps(smoke['planner'])}; main run {smoke['throughput']['hierarchy']['device_ticks_per_s']} "
          f"device-ticks/s [{card}]")

    per_rack, small_ticks = CONTROL_WIDE_SMALL
    n_small = CONTROL_WIDE[0] * CONTROL_WIDE[1] * per_rack
    counts = _global_counts(_wide_args(), small_ticks, 100.0, n_small,
                            streams=n_small // CONTROL_DEVICES_PER_STREAM)
    small = {dev: _wide_small(counts, dev) for dev in dict.fromkeys((DEV, "cpu"))}
    (ours, s_card), (theirs, s_cpu) = small[DEV], small["cpu"]
    check(ours.keys() == theirs.keys(), "the wide copy's saved fields differ")
    for key in ours:
        check(np.array_equal(ours[key], theirs[key]), f"the wide copy, card vs CPU: {key} differs")
    wide_report = json.loads(ours["report"])
    print(f"  the wide topology at {per_rack} devices a rack ({n_small} devices, {small_ticks} ticks): card "
          f"{s_card:.1f} s, CPU {s_cpu:.1f} s; card = CPU bit for bit in every rack's state, the latencies "
          f"({ours['latency_ms'].size}) and the reports; events {json.dumps(wide_report['report']['power_events'])}")
    del small, ours, theirs

    # a call's capture, replay and host time, alone on the card
    calls_per_day = 6 * 4 * (CONTROL_DAY_TICKS // 64)     # 6 runs x 4 racks x the epochs, at most
    split = {}
    for per_rack in (4, 8):
        for jit in (True, False):
            t = _call_split(per_rack, jit)
            n = t.calls
            split[per_rack, jit] = t.call / n
            print(f"  one 64-tick run_routed call, {per_rack} devices ({'graph' if jit else 'eager'}): "
                  f"{t.call / n * 1e3:.2f} ms, capture {t.capture / n * 1e3:.2f} ms, replay "
                  f"{t.replay / n * 1e3:.2f} ms, host {(t.call - t.capture - t.replay) / n * 1e3:.2f} ms "
                  f"(mean of {n}) [{card}]")
    day_s = calls_per_day * split[8, True]
    print(f"  the CLI's defaults (2 x 2 x 8 devices, {CONTROL_DAY_TICKS} ticks, 6 runs): about "
          f"{calls_per_day} calls x {split[8, True] * 1e3:.2f} ms = {day_s:.0f} s through graphs captured "
          f"in every call ({calls_per_day * split[8, False]:.0f} s eager) [{card}]")
    if day_s < CONTROL_DEFAULT_LIMIT_S:
        payload = _launcher("control", ROOT / "build" / "chip_smoke_control_day.json")
        print(f"  the defaults: {json.dumps(payload['self_check'])}")
    else:
        print(f"  the defaults not run (above {CONTROL_DEFAULT_LIMIT_S:.0f} s): the day sim waits for "
              f"graphs kept across calls")

    # the wide topology: 2 x 8 x 16384 devices
    regions, racks, per_rack = CONTROL_WIDE
    topo = _wide_topology(per_rack, DEV)
    counts, s_counts = _timed(lambda: _global_counts(
        _wide_args(), CONTROL_WIDE_TICKS, 100.0, topo.n_devices,
        streams=topo.n_devices // CONTROL_DEVICES_PER_STREAM))
    _reset_peak()
    times = _CallTimes()
    with _timed_calls(times):
        res, s = _timed(lambda: _wide_run(topo, counts, CONTROL_WIDE_TICKS))
    con = verify_hierarchy(res)
    check(res.arrived == int(counts.sum()) and res.served + res.dropped + res.in_flight == res.arrived,
          "the wide topology does not conserve requests")
    check(con["energy_error_total"] <= 1e-9 and con["energy_error_rack_max"] <= 1e-9,
          f"the wide topology's energy: {con}")
    events = {k: sum(getattr(r, k) for r in res.racks.values())
              for k in ("n_power_offs", "n_power_ons", "n_restarts")}
    host_in = times.call - times.capture - times.replay
    print(f"  wide topology {regions} x {racks} x {per_rack} = {topo.n_devices} devices, "
          f"{CONTROL_WIDE_TICKS} ticks of 100 ms (load 0.5, {topo.n_devices // CONTROL_DEVICES_PER_STREAM} "
          f"streams drawn on the host in {s_counts:.2f} s, {res.arrived} requests), crossover autoscaler, "
          f"pack routing, the idle tail, {res.injector.n_crashes} faults ({res.injector.n_detected} "
          f"detected): {s:.2f} s, {res.device_ticks / s:.4e} device-ticks/s; {times.calls} run_routed calls "
          f"{times.call:.2f} s = capture {times.capture:.2f} s ({times.capture / times.call:.1%}) + replay "
          f"{times.replay:.2f} s ({times.replay / times.call:.1%}) + host {host_in:.2f} s "
          f"({host_in / times.call:.1%}); the control loop's host {s - times.call:.2f} s; "
          f"power-offs {events['n_power_offs']}, power-ons {events['n_power_ons']}, restarts "
          f"{events['n_restarts']}; served {res.served}, dropped {res.dropped}, in flight {res.in_flight}; "
          f"conservation {json.dumps(con)}; peak {_peak() / 1e9:.3f} GB [{card}]")
    del res, counts
    if DEV == "cuda":
        torch.cuda.empty_cache()

    # the spine: one rack of 1,048,576 devices collapses onto one run_routed call
    n, ticks = CONTROL_SPINE
    topo = uniform_topology(1, 1, n, request_period_ms=120.0, device=DEV)
    rack = topo.regions[0].racks[0]
    counts = np.random.default_rng(0).poisson(0.5 * n, ticks).astype(np.int64)
    _reset_peak()
    res, s_h = _timed(lambda: run_hierarchy(topo, counts, 100.0, epoch_ticks=64))
    peak_h = _peak()
    _reset_peak()
    ref, s_r = _timed(lambda: run_routed(rack.params, counts, 100.0, router=rack.router,
                                         queue_capacity=rack.queue_capacity))
    peak_r = _peak()
    state = res.racks[rack.name].state
    for f in _STATE_FIELDS:
        check(torch.equal(getattr(ref.state, f), getattr(state, f)), f"the spine: {f} differs from run_routed")
    ours = torch.sort(torch.from_numpy(res.latency_ms).to(DEV)).values
    theirs = torch.sort(ref.latency_ms[ref.served_mask]).values
    check(torch.equal(ours, theirs), "the spine: the latency multiset differs from run_routed")
    res.assert_conserves()
    print(f"  spine, 1 x 1 x {n} devices, {ticks} ticks (Poisson, load 0.5): run_hierarchy in epochs of 64 "
          f"{s_h:.2f} s (peak {peak_h / 1e9:.3f} GB, {res.latency_ms.nbytes / 1e9:.3f} GB of latencies on the "
          f"host) = one run_routed call {s_r:.2f} s (peak {peak_r / 1e9:.3f} GB) bit for bit in every state "
          f"field, the latency multiset equal ({ours.numel()} served) [{card}]")


# ---------------------------------------------------------------------------
# Phase 25: the multi-rank runtime (ranks on one card, gloo staged on the host)
# ---------------------------------------------------------------------------
MESH_RANKS = 4                              # launch.fleet --mesh 4: four ranks, all on cuda:0
MESH_ACCEPTANCE = 1 << 20                   # --acceptance-devices (2 J a device, the strategy mix)
MESH_ENS = (2, 2)                           # (fleet, seed) mesh of the sharded ensemble
MESH_ENS_CHUNK = 64                         # seeds a chunk there: every rank draws a whole chunk (4.2 GB)
MOE_MESH_ARCHS = ("qwen3-moe-235b-a22b", "mixtral-8x7b")   # the EP and the f-TP branch at full width
MOE_MESH_REDUCED = False                    # a CPU rehearsal sets True (and DEV = "cpu")
MOE_MESHES = ((1, 4), (2, 2))               # (data, model)
MOE_MESH_TOKENS = (2, 64)                   # B, S
MOE_MESH_SKEW = 0.5                         # a shared input direction, so that the routing piles up
MOE_CF = (64.0, 1.0)                        # capacity factors: nothing drops; slots drop
# (dtype, capacity factor) run on each mesh: (data 2, model 2) in fp32 at capacity factor 1 alone (its FSDP
# gathers through gloo on the host take 2–11 s a call; the train step took the phase's time)
MOE_MESH_RUNS = {(1, 4): (("float32", 64.0), ("float32", 1.0), ("bfloat16", 64.0), ("bfloat16", 1.0)),
                 (2, 2): (("float32", 1.0),)}


def _moe_cfs(shape, name: str) -> list:
    return [cf for dtype, cf in MOE_MESH_RUNS[shape] if dtype == name]
COMPRESS_LIMIT = 0.02                       # tests/test_multidevice.py::test_grad_compression_close_to_exact


def _moe_leaf(cfg, leaf: str, experts, rows, cols, dtype, device):
    """Experts ``experts`` of a full-width MoE weight stack, rows ``rows``
    and columns ``cols`` of each expert's matrix: each matrix is drawn as
    4 x 4 blocks, every block from its own seed, so a rank draws only the
    blocks of its shard and the whole stack is the same draw."""
    import torch

    d, f = cfg.d_model, cfg.d_ff
    r_all, c_all = (d, f) if leaf in ("w_gate", "w_up") else (f, d)
    std = 1.0 / math.sqrt(r_all)
    rb, cb = r_all // 4, c_all // 4
    out = torch.empty((len(experts), rows.stop - rows.start, cols.stop - cols.start), dtype=dtype, device=device)
    code = ("w_gate", "w_up", "w_down").index(leaf)
    for n, e in enumerate(experts):
        for i in range(rows.start // rb, rows.stop // rb):
            for j in range(cols.start // cb, cols.stop // cb):
                gen = torch.Generator(device).manual_seed(((code * cfg.num_experts + e) * 4 + i) * 4 + j + 1000)
                blk = torch.randn((rb, cb), generator=gen, device=device).mul_(std)
                out[n, i * rb - rows.start:(i + 1) * rb - rows.start,
                    j * cb - cols.start:(j + 1) * cb - cols.start] = blk.to(dtype)
    return out


def _moe_router_and_input(cfg, dtype, device):
    import torch

    gen = torch.Generator(device).manual_seed(7)
    router = (torch.randn((cfg.d_model, cfg.num_experts), generator=gen, device=device) * 0.02).to(dtype)
    b, s = MOE_MESH_TOKENS
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    x = x + MOE_MESH_SKEW * torch.randn((cfg.d_model,), generator=gen, device=device)
    return router, x.to(dtype)


def _moe_params(cfg, dtype, device, pspecs=None, mesh=None) -> dict:
    """The layer's weights: all of them, or (``pspecs`` on ``mesh``) only
    this rank's blocks."""
    router, _ = _moe_router_and_input(cfg, dtype, device)
    params = {"router": router}
    for leaf in ("w_gate", "w_up", "w_down"):
        shape = (cfg.num_experts,) + ((cfg.d_model, cfg.d_ff) if leaf != "w_down" else (cfg.d_ff, cfg.d_model))
        ranges = []
        for dim, n in enumerate(shape):
            entry = pspecs[leaf][dim] if pspecs is not None and dim < len(pspecs[leaf]) else None
            axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
            k = math.prod(mesh.shape[a] for a in axes) if axes else 1
            i = mesh.index(axes) if axes else 0
            ranges.append(range(i * n // k, (i + 1) * n // k))
        params[leaf] = _moe_leaf(cfg, leaf, ranges[0], ranges[1], ranges[2], dtype, device)
    return params


def _moe_mesh_cases(archs, reduced: bool) -> dict:
    """Every rank: each MoE layer, dtype and mesh with only this rank's
    weight blocks, both capacity factors; rank 0 keeps the whole outputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import synchronize
    from repro_torch.distributed import ranks
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import moe

    dev = ranks.device()
    meshes = {shape: make_rank_mesh(shape) for shape in MOE_MESHES}
    out, seconds = {}, {}
    for arch in archs:
        cfg = get_config(arch, reduced=reduced)
        for dtype in (torch.float32, torch.bfloat16):
            for shape, mesh in meshes.items():
                if not _moe_cfs(shape, str(dtype)[6:]):
                    continue
                _, x = _moe_router_and_input(cfg, dtype, dev)
                specs = moe.moe_pspecs(cfg, mesh, x.shape)
                params = _moe_params(cfg, dtype, dev, specs, mesh)
                xl = ranks.shard(x, specs["x"], mesh)
                for cf in _moe_cfs(shape, str(dtype)[6:]):
                    synchronize(dev)
                    t0 = time.perf_counter()
                    with shd.use_sharding(mesh), torch.inference_mode():
                        y, aux = moe.moe_block(params, xl, cfg, capacity_factor=cf)
                    synchronize(dev)
                    seconds[arch, str(dtype)[6:], shape, cf] = time.perf_counter() - t0
                    out[arch, str(dtype)[6:], shape, cf] = (ranks.unshard(y, specs["x"], mesh).cpu(), float(aux))
                del params
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    return {"out": out, "seconds": seconds}


def _compress_grads(pod: int, device):
    """A gradient tree shaped like one full-width qwen3-1.7b decoder layer,
    drawn with numpy from (0, pod), each leaf at its own scale."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.tree import paths

    layer = zoo.specs(get_config(ARCH))["periods"]["pos0"]
    rng = np.random.default_rng((0, pod))
    out = {}
    for i, (k, spec) in enumerate(sorted(paths(layer).items())):
        scale = 10.0 ** (-3 + 3 * (i % 4) / 3)
        out[k] = torch.from_numpy(rng.standard_normal(spec.shape[1:], dtype=np.float32) * np.float32(scale)).to(device)
    return out


def _compress_case() -> dict | None:
    """Every rank: ``compress_psum`` over a (pod 2) mesh of the first two
    ranks (the others hold no block and return None)."""
    from repro_torch.device import synchronize
    from repro_torch.distributed import ranks
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.optim import grad_compress as gc

    mesh = make_rank_mesh((2,), ("pod",))
    if not mesh.is_member:
        return None
    grads = _compress_grads(mesh.index("pod"), ranks.device())
    err = gc.init_error(grads)
    gc.compress_psum(grads, err, "pod", mesh)               # warm-up
    synchronize(ranks.device())
    t0 = time.perf_counter()
    out, new = gc.compress_psum(grads, err, "pod", mesh)
    synchronize(ranks.device())
    return {"out": out, "err": new.error, "s": time.perf_counter() - t0}


def _ensemble_case(n_seeds: int, chunk: int, n_devices: int, n_steps: int) -> dict:
    from repro_torch.core.arrivals import PoissonArrivals
    from repro_torch.distributed import ranks
    from repro_torch.fleet.shard import fleet_mesh
    from repro_torch.mc import run_periodic_ensemble

    mesh = fleet_mesh(*MESH_ENS)
    params = _mc_fleet(n_devices, ranks.device())
    t0 = time.perf_counter()
    ens = run_periodic_ensemble(params, PoissonArrivals(40.0), n_steps, n_seeds, seed=0, seed_chunk=chunk,
                                mesh=mesh)
    return {"ens": ens, "s": time.perf_counter() - t0}


MESH_TRAIN_LAYERS = 2                       # qwen3-1.7b at its published widths, cut to 2 layers: the
                                            # gloo-on-host gathers of its 311 M-parameter embedding
MESH_TRAIN_SHAPE = (2, 2)                   # (data, model)
MESH_TRAIN_TOKENS = (8, 128)                # B, S from SyntheticLMStream
MESH_TRAIN_STEPS = 2                        # a run: one with gather_weights_once off, one with it on
MESH_TRAIN_LR = 3e-4                        # launch.train's default
MESH_TRAIN_SEED = 21
MESH_TRAIN_LIMIT = {"loss": 1e-5, "grad_norm": 1e-5, "grad": 1e-4}   # relative; a gradient to its leaf's largest
MESH_UPDATE_REL = 1e-6                      # parameters after step 1 where the update is decided (_decided), else 2·lr
MESH_COMPRESS_SHAPE = (2, 1, 2)             # (pod, data, model): the reduced yi-6b, tests/test_multidevice.py:257-297
MESH_COMPRESS_STEPS, MESH_COMPRESS_LR = 3, 1e-2
MESH_COMPRESS_CPU = (1e-6, 1e-5)            # the card's losses against the CPU ranks', relative: the first (one
                                            # forward on equal weights); the later ones, after AdamW steps at lr
                                            # 1e-2 that carry the two devices' fp32 roundings and the int8
                                            # roundings they flip (1.79e-6 at step 3 on an H100, PERF.md)
MESH_ELASTIC = (4, 2)                       # uninterrupted steps on (data 2, model 2), then 2 + 2 across the re-mesh
MESH_ELASTIC_LIMIT = 1e-4                   # the losses across the re-mesh (the reference allows 2e-3)
MESH_ELASTIC_DIR = ROOT / "build" / "chip_smoke_elastic"
MESH_SERVE_TOKENS = (4, 128)                # B, prompt of the sharded prefill (qwen3-1.7b at MESH_TRAIN_LAYERS
                                            # layers, fp32, on MESH_TRAIN_SHAPE)
MESH_SERVE_NEW = 2                          # greedy decode steps after it (8 until phase (i) joined the spawn, 4
                                            # until (j) did)
MESH_SERVE_LIMIT = 1e-4                     # each rank's logits against one card's, of the largest logit
MESH_SERVE_SEED = 23


def _mesh_train_cfg(reduced: bool):
    from repro_torch.configs import get_config

    cfg = get_config(ARCH, reduced=reduced)
    return cfg if reduced else dataclasses.replace(cfg, num_layers=MESH_TRAIN_LAYERS)


def _mesh_train_params(cfg, dev, dtype):
    import torch

    from repro_torch.models import model_zoo as zoo

    return zoo.init_params(cfg, torch.Generator(dev).manual_seed(MESH_TRAIN_SEED), dtype)


def _mesh_train_batches(cfg, dev, mesh=None) -> list:
    from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch, shard_batch
    from repro_torch.launch.mesh import make_host_mesh

    stream = SyntheticLMStream(cfg.vocab_size, *MESH_TRAIN_TOKENS, seed=MESH_TRAIN_SEED)
    return [shard_batch(batch_for_arch(cfg, stream.next_batch()), mesh if mesh is not None else make_host_mesh(dev))
            for _ in range(MESH_TRAIN_STEPS)]


def _sync_rank() -> None:
    import torch

    from repro_torch.distributed import ranks

    if ranks.device().type == "cuda":
        torch.cuda.synchronize(ranks.device())


def _stats_sum(stats: dict, key: str, tags=None) -> float:
    return sum(v[key] for tag, v in stats.items() if tags is None or tag in tags)


def _mesh_train_run(cfg, perf, mesh) -> dict:
    """One run of ``MESH_TRAIN_STEPS`` steps on ``mesh``; the last step
    split into weight gather / forward / backward / gradient reduce /
    AdamW by the collectives' own seconds (``ranks.stats``).  A run with
    ``gather_weights_once`` off keeps this rank's blocks of step 1's
    gradients and of the parameters and second moments after it."""
    import copy

    import torch

    from repro_torch.distributed import ranks
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model_zoo as zoo
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import paths

    dev = ranks.device()
    with shd.use_sharding(mesh):
        fns = make_train_step(cfg, perf, mesh=mesh)
        state = fns.init_state(_mesh_train_params(cfg, dev, torch.float32))
    real_loss, marks = zoo.loss_fn, {}

    def loss_fn(*args, **kw):                   # the end of the forward, for the split
        out = real_loss(*args, **kw)
        if ranks.stats is not None:
            _sync_rank()
            marks["forward"], marks["stats"] = time.perf_counter(), copy.deepcopy(ranks.stats)
        return out

    out = {"loss": [], "grad_norm": [], "step_s": [], "specs": paths(fns.param_pspecs)}
    keep = not perf.gather_weights_once
    with mock.patch.object(zoo, "loss_fn", loss_fn):
        for step, batch in enumerate(_mesh_train_batches(cfg, dev, mesh)):
            if step == MESH_TRAIN_STEPS - 1:
                ranks.stats = {}
            _sync_rank()
            t0 = time.perf_counter()
            loss, grads = fns.loss_and_grads(state.params, batch)
            _sync_rank()
            t1 = time.perf_counter()
            if step == 0 and keep:
                out["grads"] = {k: g.clone() for k, g in grads.items()}
            state, m = fns.apply_grads(state, loss, grads, MESH_TRAIN_LR)
            _sync_rank()
            t2 = time.perf_counter()
            del grads
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["step_s"].append(t2 - t0)
            if step == 0 and keep:
                out["params"] = {k: t.detach().clone() for k, t in paths(state.params).items()}
                out["v"] = {k: t.clone() for k, t in paths(state.opt.v).items()}
            if ranks.stats is not None:
                stats, fwd_stats = ranks.stats, marks["stats"]
                ranks.stats = None
                fwd_coll = _stats_sum(fwd_stats, "s")
                bwd_coll = _stats_sum(stats, "s", set(stats) - {"grad norm"}) - fwd_coll
                out["split"] = {
                    "step": t2 - t0,
                    "weight gather": _stats_sum(stats, "s", {"weight gather"}),
                    "forward": marks["forward"] - t0 - fwd_coll,
                    "backward": t1 - marks["forward"] - bwd_coll,
                    "gradient reduce": _stats_sum(stats, "s", {"gradient reduce"}),
                    "tensor parallel": _stats_sum(stats, "s", {"tensor parallel", "loss"}),
                    "AdamW": t2 - t1,
                    "host bytes": _stats_sum(stats, "bytes"),
                    "by tag": stats,
                }
    return out


def _decided(v, grad_diff: float):
    """The elements of a leaf whose first AdamW step is decided (C-ref-9):
    ``sqrt(v̂) ≥ 1e3·eps`` and at least 100 times the largest gradient
    difference between the two runs compared.  Elsewhere a rounding of
    the gradient moves the element by a different part of ``lr`` (its
    sign may flip), so the update is held within 2·lr."""
    import torch

    root = torch.sqrt(v / (1 - 0.95))
    return (root >= 1e3 * 1e-8) & (root >= 100 * grad_diff)


def _mesh_train_reference(cfg, runs: dict, mesh) -> dict:
    """This rank, alone on the card: the single-card step on the same
    weights and batches (through the flash kernel), and step 1's
    gradients on the plain path in fp32 and float64; the mesh runs held
    to them, this rank's blocks against the same blocks of the single-card
    tensors (no gather)."""
    import torch

    from repro_torch.configs.perf import PerfConfig
    from repro_torch.distributed import ranks
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import paths, tree_map

    dev = ranks.device()
    specs = runs[False]["specs"]
    block = lambda k, t: ranks.shard(t, specs[k], mesh)  # noqa: E731
    fns = make_train_step(cfg, PerfConfig())
    state = fns.init_state(_mesh_train_params(cfg, dev, torch.float32))
    ref = {"loss": [], "grad_norm": []}
    batches = _mesh_train_batches(cfg, dev)
    for step, batch in enumerate(batches):
        loss, grads = fns.loss_and_grads(state.params, batch)
        if step == 0:
            ref["scale"] = {k: float(g.abs().max()) for k, g in grads.items()}
            ref["grads"] = {k: block(k, g).clone() for k, g in grads.items()}
        state, m = fns.apply_grads(state, loss, grads, MESH_TRAIN_LR)
        del grads
        ref["loss"].append(float(m["loss"]))
        ref["grad_norm"].append(float(m["grad_norm"]))
        if step == 0:
            ref["params"] = {k: block(k, t.detach()).clone() for k, t in paths(state.params).items()}
            ref["p_scale"] = {k: float(t.detach().abs().max()) for k, t in paths(state.params).items()}
    del state
    _empty_rank_cache()
    plain = {}
    for dtype in (torch.float32, torch.float64):
        params = tree_map(lambda t: t.to(dtype), _mesh_train_params(cfg, dev, torch.float32))
        with plain_path():
            _, g = make_train_step(cfg, PerfConfig()).loss_and_grads(params, batches[0])
        plain[dtype] = {k: block(k, t).clone() for k, t in g.items()}
        del params, g
        _empty_rank_cache()
    report = {}
    for once, got in runs.items():
        rel = {key: max(abs(a - b) / abs(b) for a, b in zip(got[key], ref[key])) for key in ("loss", "grad_norm")}
        entry = {"loss": got["loss"], "grad_norm": got["grad_norm"], "rel": rel,
                 "ref_loss": ref["loss"], "ref_grad_norm": ref["grad_norm"]}
        if "grads" in got:
            leaves = {}
            for k, g in ref["grads"].items():
                dist64 = float((plain[torch.float32][k].double() - plain[torch.float64][k]).abs().max()) / ref["scale"][k]
                diff = float((got["grads"][k] - g).abs().max())
                decided = _decided(got["v"][k], diff)
                err = (got["params"][k] - ref["params"][k]).abs()
                leaves[k] = {"grad": diff / ref["scale"][k], "bound": max(MESH_TRAIN_LIMIT["grad"], 2 * dist64),
                             "dist64": dist64,
                             "decided": float(torch.where(decided, err, 0).max()) / ref["p_scale"][k],
                             "other": float(torch.where(decided, 0, err).max())}
            entry["leaves"] = leaves
        report[once] = entry
    return report


def _empty_rank_cache() -> None:
    import torch

    from repro_torch.distributed import ranks

    if ranks.device().type == "cuda":
        torch.cuda.empty_cache()


def _mesh_train_case(reduced: bool) -> dict | None:
    """(e) every rank: full-width qwen3-1.7b (2 layers), fp32, on (data 2,
    model 2), 2 steps with ``gather_weights_once`` off and 2 with it on;
    then each rank in turn holds its blocks to the single-card step."""
    import resource

    import torch
    import torch.distributed as dist

    from repro_torch.configs.perf import PerfConfig
    from repro_torch.distributed import ranks
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_rank_mesh

    dev = ranks.device()
    cfg = _mesh_train_cfg(reduced)
    mesh = make_rank_mesh(MESH_TRAIN_SHAPE)
    _empty_rank_cache()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fa.launches = 0
    t0 = time.perf_counter()
    runs = {once: _mesh_train_run(cfg, PerfConfig(gather_weights_once=once), mesh) for once in (False, True)}
    launches, seconds = fa.launches, time.perf_counter() - t0
    peak = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
            torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0)
    t1 = time.perf_counter()
    check_ = None
    for r in range(ranks.world_size()):         # one rank at a time: each holds a single-card model meanwhile
        if r == ranks.rank():
            check_ = _mesh_train_reference(cfg, runs, mesh)
        ranks.barrier(mesh)
    mine = {"launches": launches, "peak": peak, "split": {once: run["split"] for once, run in runs.items()},
            "check": check_, "step_s": {once: run["step_s"] for once, run in runs.items()}}
    everyone = [None] * ranks.world_size()
    dist.all_gather_object(everyone, mine)
    del runs
    _empty_rank_cache()
    return {"ranks": everyone, "s": seconds, "reference_s": time.perf_counter() - t1}


def _mesh_compress_train(params_np: dict, batch_np: dict) -> dict | None:
    """(f) the compressed cross-pod step: the reduced yi-6b on (pod 2, data
    1, model 2) under ``perf_rules``, 3 steps, compressed and not → rank
    0's losses (on the card or the CPU, by the spawn's device)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.perf import PerfConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import ranks
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config("yi-6b", reduced=True)
    mesh = make_rank_mesh(MESH_COMPRESS_SHAPE)
    if not mesh.is_member:
        return None
    t0 = time.perf_counter()
    batch = shard_batch(batch_np, mesh)
    out = {}
    for compress in (False, True):
        perf = PerfConfig(grad_compress_pod=compress)
        with shd.use_sharding(mesh, dryrun_lib.perf_rules(perf)):
            fns = make_train_step(cfg, perf, mesh=mesh)
            state = fns.init_state(zoo.params_from_numpy(params_np, device=ranks.device()))
            losses = []
            for _ in range(MESH_COMPRESS_STEPS):
                state, m = fns.train_step(state, batch, MESH_COMPRESS_LR)
                losses.append(float(m["loss"]))
        out[compress] = {"losses": losses, "err": state.compress_err is not None}
    out["s"] = time.perf_counter() - t0
    return out


def _mesh_compress_inputs() -> tuple:
    """The reduced yi-6b's fp32 weights and a (8, 32) batch, drawn with
    numpy, so the card and the CPU ranks start alike."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.tree import paths, unflatten_like

    cfg = get_config("yi-6b", reduced=True)
    rng = np.random.default_rng(MESH_TRAIN_SEED)
    shapes = zoo.param_shapes(cfg)
    leaves = []
    for k, t in paths(shapes).items():
        if "norm" in k or k.endswith("ln1") or k.endswith("ln2"):
            leaves.append(np.ones(t.shape, np.float32))
        else:
            leaves.append((rng.standard_normal(t.shape) / math.sqrt(t.shape[-2])).astype(np.float32))
    batch = {k: rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32) for k in ("tokens", "labels")}
    return unflatten_like(shapes, leaves), batch


def _mesh_elastic() -> dict | None:
    """(g) the reduced qwen3 through ``launch.train.train(mesh=)``: 4 steps
    on (data 2, model 2) uninterrupted; 2 steps and a checkpoint, then a
    resume on ``plan_elastic_mesh(survivors=2, model_axis=2)`` for 2 more.
    Rank 0 also saves the gathered state of step 2 on one device, to hold
    the blob bit for bit."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import ranks
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.fault_tolerance import plan_elastic_mesh
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.training.train_loop import state_pspecs
    from repro_torch.tree import paths, unflatten_like

    dev = ranks.device()
    t0 = time.perf_counter()
    full_steps, first_steps = MESH_ELASTIC
    kw = dict(batch=4, seq=32, seed=3, log_every=100, device=dev)
    mesh_a = make_rank_mesh(MESH_TRAIN_SHAPE)
    run_dir = MESH_ELASTIC_DIR / "run"
    if ranks.rank() == 0:
        shutil.rmtree(MESH_ELASTIC_DIR, ignore_errors=True)
    ranks.barrier(mesh_a)
    with contextlib.redirect_stdout(io.StringIO()):
        full = train_mod.train(ARCH, steps=full_steps, mesh=mesh_a, **kw)
        first = train_mod.train(ARCH, steps=first_steps, mesh=mesh_a, ckpt_dir=str(run_dir), ckpt_every=first_steps,
                                **kw)
    with shd.use_sharding(mesh_a):
        specs = paths(state_pspecs(first["state"], zoo.param_pspecs(get_config(ARCH, reduced=True), mesh_a)))
    whole = [ranks.unshard(t, specs[k], mesh_a) if isinstance(t, torch.Tensor) else t
             for k, t in paths(first["state"]).items()]
    plan = plan_elastic_mesh(survivors=2, model_axis=2)
    mesh_b = make_rank_mesh((plan.data, plan.model))
    with contextlib.redirect_stdout(io.StringIO()):
        second = train_mod.train(ARCH, steps=full_steps, mesh=mesh_b, ckpt_dir=str(run_dir), **kw)
    if ranks.rank() != 0:
        return None
    CheckpointManager(str(MESH_ELASTIC_DIR / "single")).save(first_steps, unflatten_like(first["state"], whole))
    name = f"step_{first_steps}.ckpt"
    same = (run_dir / name).read_bytes() == (MESH_ELASTIC_DIR / "single" / name).read_bytes()
    shutil.rmtree(MESH_ELASTIC_DIR, ignore_errors=True)
    return {"full": full["losses"], "first": first["losses"], "second": second["losses"],
            "plan": (plan.data, plan.model), "blob_equal": same, "s": time.perf_counter() - t0}


def _tagged(stats: dict) -> dict:
    return {tag: (v["calls"], v["bytes"]) for tag, v in stats.items()}


def _mesh_serve_case(reduced: bool) -> dict | None:
    """(h) every rank: the sharded prefill (``MESH_SERVE_TOKENS``) and
    ``MESH_SERVE_NEW`` greedy decode steps of qwen3-1.7b at its published
    widths cut to ``MESH_TRAIN_LAYERS`` layers, fp32, on (data 2, model
    2), the prefill and the decode steps timed apart with the bytes each
    stages through the host by tag; the same cell on ``meta`` at this
    rank's coordinate (the roofline counter's dry mode), whose staged bytes
    must equal those; then each rank's rows against one card's run of the
    same weights and tokens (all ranks at once: 1.65 GB of fp32 weights a
    rank)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import ranks
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import dryrun_lib, roofline
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import model_zoo as zoo

    dev = ranks.device()
    cfg = _mesh_train_cfg(reduced)
    mesh = make_rank_mesh(MESH_TRAIN_SHAPE)
    b, s = MESH_SERVE_TOKENS
    max_len = s + MESH_SERVE_NEW
    whole = _mesh_train_params(cfg, dev, torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator(dev).manual_seed(MESH_SERVE_SEED),
                           device=dev, dtype=torch.int32)
    rows = ranks.shard(tokens, shd.P("data"), mesh)
    with shd.use_sharding(mesh):
        blocks = zoo.shard_params(whole, cfg, mesh)
    ranks.barrier(mesh)
    with torch.no_grad():
        fa.launches = 0
        ranks.stats = {}
        _sync_rank()
        t0 = time.perf_counter()
        logits, state = zoo.prefill_fn(blocks, {"tokens": rows}, cfg, max_len, mesh=mesh)
        _sync_rank()
        t1 = time.perf_counter()
        pre_stats, ranks.stats = ranks.stats, {}
        pre_launches = fa.launches
        outs = [logits]
        for _ in range(MESH_SERVE_NEW):
            logits, state = zoo.decode_fn(blocks, state, torch.argmax(logits, -1).to(torch.int32), cfg, mesh=mesh)
            outs.append(logits)
        _sync_rank()
        t2 = time.perf_counter()
        dec_stats, ranks.stats = ranks.stats, None
        launches = (pre_launches, fa.launches - pre_launches)
        del state
        # the same cell on meta, at this rank's coordinate
        dry = dryrun_lib.dry_mesh(shd.Mesh(mesh.axis_sizes, mesh.axis_names), mesh.coordinate)
        with shd.use_sharding(dry):
            meta_blocks = zoo.shard_params(zoo.param_shapes(cfg, torch.float32), cfg, dry)
            meta_rows = torch.empty(tuple(rows.shape), dtype=torch.int32, device="meta")
            (m_logits, m_state), pre_cost = roofline.count(zoo.prefill_fn, meta_blocks, {"tokens": meta_rows}, cfg,
                                                           max_len, mesh=dry)

            def decode(x, st):
                for _ in range(MESH_SERVE_NEW):
                    x, st = zoo.decode_fn(meta_blocks, st, torch.argmax(x, -1).to(torch.int32), cfg, mesh=dry)
                return x

            _, dec_cost = roofline.count(decode, m_logits, m_state)
        # one card: the whole batch on the whole weights
        ref, lo = [], mesh.index("data") * rows.shape[0]
        logits, state = zoo.prefill_fn(whole, {"tokens": tokens}, cfg, max_len)
        ref.append(logits)
        for _ in range(MESH_SERVE_NEW):
            logits, state = zoo.decode_fn(whole, state, torch.argmax(logits, -1).to(torch.int32), cfg)
            ref.append(logits)
        mine = [r[lo:lo + rows.shape[0]] for r in ref]
        err = max(float((a - w).abs().max()) / float(w.abs().max()) for a, w in zip(outs, mine))
        same_tokens = all(bool(torch.equal(a.argmax(-1), w.argmax(-1))) for a, w in zip(outs, mine))
        spread = min(float(w.std()) for w in mine)
        finite = all(bool(torch.isfinite(a).all()) for a in outs)
    del whole, blocks, ref, outs
    _empty_rank_cache()
    rec = {"launches": launches, "prefill_s": t1 - t0, "decode_s": t2 - t1,
           "live": {"prefill": _tagged(pre_stats), "decode": _tagged(dec_stats)},
           "seconds": {"prefill": _stats_sum(pre_stats, "s"), "decode": _stats_sum(dec_stats, "s")},
           "dry": {"prefill": _tagged(pre_cost.staged), "decode": _tagged(dec_cost.staged)},
           "cost": {"flops": pre_cost.flops, "hbm_bytes": pre_cost.hbm_bytes,
                    "ring_bytes": pre_cost.collective_bytes, "by_kind": pre_cost.coll_bytes},
           "err": err, "same_tokens": same_tokens, "spread": spread, "finite": finite}
    everyone = [None] * ranks.world_size()
    dist.all_gather_object(everyone, rec)
    return {"ranks": everyone}


MESH_FAMILY_LIMIT = 1e-4                    # each rank's logits against one card's, of the largest logit
MESH_FAMILY_F64 = "mamba2-370m"             # the case whose rank 0 also runs one card in float64: through 48
                                            # random fp32 layers one card lies ~5e-5 from it, and so may the mesh
MESH_FAMILY_SEED = 29
DROPLESS = "dropless"                       # a case's capacity factor E / k: an expert's slots a rank hold
                                            # every token the rank routes, so no slot drops
#: (i) case → (arch, reduced config only, (data, model), PerfConfig fields, config changes, B, prompt,
#: greedy decode steps, long_context); at full width unless named reduced (all reduced in a CPU
#: rehearsal); the qwen3 case takes (h)'s weights.  Every FSDP gather goes through the host
#: (0.5-0.7 GB/s a rank), so the full-width cases run 1 / 1 / 2 decode steps, not 4 / 2 / 4,
#: to keep the script inside its 1,200 s on slower hosts (with 4 / 2 / 4 and 8 steps in (h) it
#: took 1023.2 s of phases on an NVIDIA H100 80GB HBM3 host whose CPU ran 1.2x slower than others;
#: 2 / 1 / 2 until (j) joined the spawn); the split cache's 128 + 2 positions must divide over model
MESH_FAMILY_CASES = {
    "mamba2-370m": (MAMBA, False, (2, 2), dict(gather_weights_once=True), {}, 4, MAMBA_PROMPT, 1, False),
    "mixtral-8x7b, 1 layer": ("mixtral-8x7b", False, (2, 2), dict(moe_capacity_factor=DROPLESS),
                              dict(num_layers=1), 4, 128, 1, False),
    "qwen3-1.7b, cache split over model": (ARCH, False, (2, 2), dict(shard_cache_seq_over_model=True),
                                           dict(num_layers=MESH_TRAIN_LAYERS), 4, 128, 2, False),
    "jamba, long context (reduced)": (JAMBA, True, (2, 2), dict(moe_capacity_factor=DROPLESS), {}, 1,
                                      64, 2, True),
    "llava (reduced)": (LLAVA, True, (2, 2), {}, {}, 4, 32, 2, False),
    "hubert (reduced)": (HUBERT, True, (2, 2), {}, {}, 4, 32, 0, False),
    "qwen3-moe, 16 experts (reduced)": ("qwen3-moe-235b-a22b", True, (1, 4),
                                        dict(moe_capacity_factor=DROPLESS),
                                        dict(num_experts=16, experts_per_token=2), 4, 32, 2, False),
}


def _family_cfg(name: str, reduced: bool):
    from repro_torch.configs import get_config

    arch, small, _, _, changes, _, _, _, _ = MESH_FAMILY_CASES[name]
    return dataclasses.replace(get_config(arch, reduced=reduced or small), **changes)


def _family_perf(name: str, cfg):
    """The case's ``PerfConfig``, ``DROPLESS`` resolved for ``cfg``."""
    return _resolved_perf(MESH_FAMILY_CASES[name][3], cfg)


def _resolved_perf(fields: dict, cfg):
    """``PerfConfig(**fields)`` with ``DROPLESS`` resolved for ``cfg``."""
    from repro_torch.configs.perf import PerfConfig

    kw = dict(fields)
    if kw.get("moe_capacity_factor") == DROPLESS:
        kw["moe_capacity_factor"] = cfg.num_experts / cfg.experts_per_token
    return PerfConfig(**kw)


def _family_batch(cfg, b: int, prompt: int, dev) -> dict:
    """A prompt batch of ``b`` rows on ``dev`` from the case's seed, in the
    reference's layout."""
    import torch

    gen = torch.Generator(dev).manual_seed(MESH_FAMILY_SEED)
    if cfg.frontend == "audio":
        return {"features": torch.randn((b, prompt, cfg.frontend_dim), generator=gen, device=dev)}
    n = prompt - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device=dev, dtype=torch.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = torch.randn((b, cfg.frontend_tokens, cfg.frontend_dim), generator=gen, device=dev)
    return out


def _family_steps(params, batch, cfg, perf, mesh, steps: int, long_context: bool, replicated: bool, marks=None):
    """The prefill (hubert: the encoder) and ``steps`` greedy decode steps
    → (each step's logits, the last decode state); ``marks`` (a list), when
    given, takes each kernel's launches and ``ranks.stats`` once the
    prefill is done, and the seconds."""
    import torch

    from repro_torch.distributed import ranks
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import model_zoo as zoo

    on = dict(mesh=mesh, replicated_batch=replicated)
    max_len = next(iter(batch.values())).shape[1] + (cfg.frontend_tokens if cfg.frontend == "vision" else 0) + steps
    t0 = time.perf_counter()
    if not cfg.decode_supported:
        outs, state = [zoo.encode_fn(params, batch, cfg, perf, **on)], None
    else:
        logits, state = zoo.prefill_fn(params, batch, cfg, max_len, perf, long_context, **on)
        outs = [logits]
    if marks is not None:
        _sync_rank()
        marks.append((fa.launches, ssd_ops.launches, ranks.stats, time.perf_counter() - t0))
        ranks.stats = {} if ranks.stats is not None else None
        t0 = time.perf_counter()
    for _ in range(steps):
        logits, state = zoo.decode_fn(params, state, torch.argmax(logits, -1).to(torch.int32), cfg, perf,
                                      long_context, **on)
        outs.append(logits)
    if marks is not None:
        _sync_rank()
        marks.append((fa.launches, ssd_ops.launches, ranks.stats, time.perf_counter() - t0))
    return outs, state


def _mesh_family_case(name: str, reduced: bool) -> dict:
    """One case of (i) on every rank: the sharded serving step, timed, its
    flash and SSD launches and staged bytes by tag apart for the prefill
    and the decode steps; the same step on ``meta`` at this rank's
    coordinate (its staged bytes must equal those); this rank's rows
    against one card's run of the same weights and inputs."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import ranks
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import model_zoo as zoo

    _, _, shape, _, _, b, prompt, steps, long_context = MESH_FAMILY_CASES[name]
    dev = ranks.device()
    cfg = _family_cfg(name, reduced)
    perf = _family_perf(name, cfg)
    mesh = make_rank_mesh(shape)
    replicated = b % shape[0] != 0
    seed = MESH_TRAIN_SEED if cfg.name.startswith(ARCH) else MESH_FAMILY_SEED
    whole = zoo.init_params(cfg, torch.Generator(dev).manual_seed(seed), torch.float32)
    batch = _family_batch(cfg, b, prompt, dev)
    rows = batch if replicated else {k: ranks.shard(v, shd.P("data"), mesh) for k, v in batch.items()}
    with shd.use_sharding(mesh):
        blocks = zoo.shard_params(whole, cfg, mesh)
    ranks.barrier(mesh)
    marks: list = []
    with torch.no_grad():
        fa.launches = ssd_ops.launches = 0
        ranks.stats = {}
        outs, state = _family_steps(blocks, rows, cfg, perf, mesh, steps, long_context, replicated, marks)
        ranks.stats = None
        (fa_pre, ssd_pre, pre_stats, pre_s), (fa_all, ssd_all, dec_stats, dec_s) = marks
        kv = {pos: tuple(c.k.shape) for pos, c in state.caches[0].items() if hasattr(c, "k")} if state else {}
        del state
        dry = dryrun_lib.dry_mesh(shd.Mesh(mesh.axis_sizes, mesh.axis_names), mesh.coordinate)
        with shd.use_sharding(dry):
            meta_blocks = zoo.shard_params(zoo.param_shapes(cfg, torch.float32), cfg, dry)
            meta_rows = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta") for k, v in rows.items()}
            dry_marks: list = []
            ranks.stats = {}
            _family_steps(meta_blocks, meta_rows, cfg, perf, dry, steps, long_context, replicated, dry_marks)
            ranks.stats = None
        # one card: the whole batch on the whole weights
        ref, _ = _family_steps(whole, batch, cfg, perf, None, steps, long_context, False)
        lo = 0 if replicated else mesh.index("data") * next(iter(rows.values())).shape[0]
        n = next(iter(rows.values())).shape[0]
        mine = [r[lo:lo + n] for r in ref]
        err = max(float((a - w).abs().max()) / float(w.abs().max()) for a, w in zip(outs, mine))
        same_tokens = all(bool(torch.equal(a.argmax(-1), w.argmax(-1))) for a, w in zip(outs, mine))
        spread = min(float(w.std()) for w in mine)
        finite = all(bool(torch.isfinite(a).all()) for a in outs)
        f64 = _float64_distance(whole, batch, cfg, ref, outs, lo) if name == MESH_FAMILY_F64 and ranks.rank() == 0 \
            else None
    del whole, blocks, ref, outs
    _empty_rank_cache()
    rec = {"launches": {"flash": (fa_pre, fa_all - fa_pre), "ssd": (ssd_pre, ssd_all - ssd_pre)},
           "prefill_s": pre_s, "decode_s": dec_s,
           "live": {"prefill": _tagged(pre_stats), "decode": _tagged(dec_stats)},
           "dry": {"prefill": _tagged(dry_marks[0][2]), "decode": _tagged(dry_marks[1][2])},
           "seconds": {"prefill": _stats_sum(pre_stats, "s"), "decode": _stats_sum(dec_stats, "s")},
           "kv": kv, "err": err, "same_tokens": same_tokens, "spread": spread, "finite": finite, "f64": f64}
    everyone = [None] * ranks.world_size()
    dist.all_gather_object(everyone, rec)
    return {"ranks": everyone}


def _float64_distance(whole, batch, cfg, ref, outs, lo: int) -> tuple[float, float]:
    """One card in float64 on the same inputs (the plain path: the kernels
    take fp32 and bf16), each decode step fed the fp32 run's greedy token →
    (one card's fp32 logits, this rank's mesh logits: each one's largest
    distance from it over the largest logit)."""
    import torch

    from repro_torch.models import model_zoo as zoo
    from repro_torch.tree import paths, unflatten_like

    wide = unflatten_like(whole, [t.double() for t in paths(whole).values()])
    max_len = next(iter(batch.values())).shape[1] + len(ref) - 1
    with plain_path():
        logits, state = zoo.prefill_fn(wide, batch, cfg, max_len)
        f64 = [logits]
        for step in ref[:-1]:
            logits, state = zoo.decode_fn(wide, state, torch.argmax(step, -1).to(torch.int32), cfg)
            f64.append(logits)
    del wide, state
    n = outs[0].shape[0]
    rel = lambda a, w: float((a.double() - w).abs().max() / w.abs().max())  # noqa: E731
    return (max(rel(a, w) for a, w in zip(ref, f64)),
            max(rel(a, w[lo:lo + n]) for a, w in zip(outs, f64)))


def _mesh_families(reduced: bool) -> dict:
    """(i) every case of ``MESH_FAMILY_CASES`` in turn, with its seconds."""
    out = {}
    for name in MESH_FAMILY_CASES:
        t0 = time.perf_counter()
        out[name] = _mesh_family_case(name, reduced)
        out[name]["s"] = time.perf_counter() - t0
    return out


def _family_layers(cfg) -> tuple[int, int]:
    """(attention layers, Mamba-2 layers) of ``cfg``."""
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    return attn, cfg.num_layers - attn


def _mesh_families_report(card: str, got: dict, runtime: dict) -> tuple[int, int]:
    """(i) each case against one card and against the dry mode's count,
    its launches exact → (its flash launches, its SSD launches, all
    ranks)."""
    n_fa = n_ssd = 0
    print(f"  (i) serving on (data, model) meshes of the other families and the cache split over its sequence, "
          f"fp32, {runtime['ranks']} ranks on one card [{card}; one card: the runtime, not scale-out]")
    for name, case in got.items():
        arch, _, shape, perf_kw, _, b, prompt, steps, long_context = MESH_FAMILY_CASES[name]
        cfg = _family_cfg(name, MOE_MESH_REDUCED)
        n_attn, n_ssm = _family_layers(cfg)
        on_card = DEV == "cuda"
        want = {"flash": (n_attn if on_card else 0, 0), "ssd": (n_ssm if on_card else 0, 0)}
        changed = {k: v for k, v in dataclasses.asdict(_family_perf(name, cfg)).items()
                   if k in perf_kw} or "baseline"
        print(f"    {name}: {cfg.name}, {cfg.num_layers} layers, (data {shape[0]}, model {shape[1]}), B {b}, prompt "
              f"{prompt}, {steps} decode steps, {changed}{', long context' if long_context else ''}; "
              f"{case['s']:.1f} s")
        for r, rank in enumerate(case["ranks"]):
            live, dry = rank["live"], rank["dry"]
            staged = {k: sum(v[1] for v in live[k].values()) for k in live}
            print(f"      rank {r}: prefill {rank['prefill_s']:.3f} s, decode {rank['decode_s']:.3f} s; staged "
                  f"{staged['prefill'] / 1e9:.4g} / {staged['decode'] / 1e9:.4g} GB through the host in "
                  f"{rank['seconds']['prefill']:.3f} / {rank['seconds']['decode']:.3f} s ({live['prefill']}, "
                  f"{live['decode']}); logits against one card's rows {rank['err']:.3g} of the largest (limit "
                  f"{MESH_FAMILY_LIMIT}), tokens equal {rank['same_tokens']}; launches prefill / decode "
                  f"{rank['launches']} (expected {want}); KV blocks {rank['kv'] or 'none'}; the dry mode's count "
                  f"equal: {dry == live}")
            check(rank["finite"] and rank["spread"] > 0 and rank["err"] <= MESH_FAMILY_LIMIT and rank["same_tokens"],
                  f"(i) {name}, rank {r}: the sharded step departs from one card's ({rank['err']:.3g})")
            check({k: tuple(v) for k, v in rank["launches"].items()} == want,
                  f"(i) {name}, rank {r}: launches {rank['launches']}, not {want}")
            check(dry == live, f"(i) {name}, rank {r}: the dry mode counts {dry}, the run staged {live}")
            if rank["f64"] is not None:
                one, mine = rank["f64"]
                print(f"      rank {r} against one card in float64: one card's fp32 logits {one:.3g}, this rank's "
                      f"{mine:.3g} of the largest (limit twice one card's)")
                check(mine <= 2 * one, f"(i) {name}, rank {r}: {mine:.3g} from float64, one card {one:.3g}")
            if perf_kw.get("shard_cache_seq_over_model"):
                block = (b // shape[0], (prompt + steps) // shape[1], cfg.num_kv_heads, cfg.head_dim)
                check(all(v == block for v in rank["kv"].values()),
                      f"(i) {name}, rank {r}: KV blocks {rank['kv']}, not {block}")
            n_fa += sum(rank["launches"]["flash"])
            n_ssd += sum(rank["launches"]["ssd"])
    return n_fa, n_ssd


MESH_FAMILY_TRAIN_LIMIT = {"loss": 1e-6, "grad_norm": 1e-5, "grad": 1e-5, "aux": 1e-5}
#: (j) case → (arch, reduced config only, (data, model), PerfConfig fields, config changes, B, S): one
#: train step, fp32, on the ranks; at full width unless named reduced (all reduced in a CPU rehearsal).
#: Depth is cut for time only: mamba2-370m to 4 of its 48 layers, mixtral-8x7b to 1 of 32 (its
#: once-gathered experts and their gradient's reduce stage ~12 GB a rank through the host a step)
MESH_FAMILY_TRAIN = {
    "mamba2-370m, 4 layers": (MAMBA, False, (2, 2), dict(gather_weights_once=True), dict(num_layers=4), 8, 128),
    "mixtral-8x7b, 1 layer": ("mixtral-8x7b", False, (2, 2),
                              dict(moe_capacity_factor=DROPLESS, gather_weights_once=True), dict(num_layers=1),
                              4, 128),
    "jamba (reduced)": (JAMBA, True, (2, 2), dict(moe_capacity_factor=DROPLESS), {}, 4, 64),
    "llava (reduced)": (LLAVA, True, (2, 2), {}, {}, 4, 32),
    "hubert (reduced)": (HUBERT, True, (2, 2), {}, {}, 4, 32),
    "qwen3-moe, 16 experts (reduced)": ("qwen3-moe-235b-a22b", True, (1, 4), dict(moe_capacity_factor=DROPLESS),
                                        dict(num_experts=16, experts_per_token=2), 4, 32),
}


def _family_train_cfg(name: str, reduced: bool):
    from repro_torch.configs import get_config

    arch, small, _, _, changes, _, _ = MESH_FAMILY_TRAIN[name]
    return dataclasses.replace(get_config(arch, reduced=reduced or small), **changes)


def _family_train_batch(cfg, b: int, s: int) -> dict:
    """One train batch as numpy from the case's seed, in the reference's
    layout (``batch_for_arch``: a frontend's inputs, labels over every
    position)."""
    from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch

    return batch_for_arch(cfg, SyntheticLMStream(max(cfg.vocab_size, 2), b, s, seed=MESH_FAMILY_SEED).next_batch())


@contextlib.contextmanager
def _capacity_moe(mesh_shape: dict):
    """``moe_block`` on one device as the sharded bodies compute it on a
    mesh of ``mesh_shape``: ``moe_capacity_reference`` (each token block's
    routing, drops and aux, the aux their mean)."""
    from repro_torch.models import moe as moe_mod

    def moe_block(params, x, cfg, capacity_factor=None, layout=None):
        cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
        y, aux, _ = moe_mod.moe_capacity_reference(params, x, cfg, cf, mesh_shape)
        return y, aux

    with mock.patch.object(moe_mod, "moe_block", moe_block):
        yield


@contextlib.contextmanager
def _aux_recorded(box: list):
    """``decoder.forward_hidden`` appending each call's aux loss to ``box``."""
    from repro_torch.models import decoder

    real = decoder.forward_hidden

    def forward_hidden(*args, **kw):
        hidden, aux = real(*args, **kw)
        box.append(aux.detach())
        return hidden, aux

    with mock.patch.object(decoder, "forward_hidden", forward_hidden):
        yield


def _card_peak(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def _mesh_family_train_case(name: str, reduced: bool) -> dict:
    """One case of (j) on every rank: one train step on the mesh, timed, its
    flash and SSD launches and staged bytes by tag; the same step on
    ``meta`` at this rank's coordinate (its staged bytes must equal those);
    the MoE's aux (the ranks' terms summed over the batch axes); then each
    rank in turn, its mesh state freed, holds its blocks to one card's step
    (``_mesh_family_train_reference``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import ranks
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import dryrun_lib, roofline
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import paths

    _, _, shape, fields, _, b, s = MESH_FAMILY_TRAIN[name]
    dev = ranks.device()
    cfg = _family_train_cfg(name, reduced)
    perf = _resolved_perf(fields, cfg)
    mesh = make_rank_mesh(shape)
    raw = _family_train_batch(cfg, b, s)
    moe = any(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    _empty_rank_cache()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with shd.use_sharding(mesh):
        fns = make_train_step(cfg, perf, mesh=mesh)
        state = fns.init_state(zoo.init_params(cfg, torch.Generator(dev).manual_seed(MESH_FAMILY_SEED), torch.float32))
        specs = paths(fns.param_pspecs)
        batch = shard_batch(raw, mesh)
        ranks.barrier(mesh)
        auxes: list = []
        fa.launches = ssd_ops.launches = 0
        ranks.stats = {}
        _sync_rank()
        t0 = time.perf_counter()
        with _aux_recorded(auxes):
            loss, grads = fns.loss_and_grads(state.params, batch)
        _sync_rank()
        t1 = time.perf_counter()
        kept = {"grads": {k: g.clone() for k, g in grads.items()}}
        state, m = fns.apply_grads(state, loss, grads, MESH_TRAIN_LR)
        _sync_rank()
        t2 = time.perf_counter()
        stats, ranks.stats = ranks.stats, None
        launches = {"flash": fa.launches, "ssd": ssd_ops.launches}
        batch_axes = tuple(a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1)
        aux = float(ranks.psum(sum(auxes), batch_axes, mesh)) if moe else None
        kept["params"] = {k: t.detach() for k, t in paths(state.params).items()}
        kept["v"] = dict(paths(state.opt.v))
        # on the host while the ranks take the card in turn (mixtral's one-card step peaks at 55 GB)
        kept = {part: {k: t.cpu() for k, t in leaves.items()} for part, leaves in kept.items()}
        got = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "aux": aux}
        del state, grads, fns, batch
        mesh_peak = _card_peak(dev)
        # the same step on meta, on the descriptor mesh at this rank's coordinate
        dry = dryrun_lib.dry_mesh(shd.Mesh(mesh.axis_sizes, mesh.axis_names), mesh.coordinate)
    with shd.use_sharding(dry):
        dry_fns = make_train_step(cfg, perf, mesh=dry)
        dry_state = dry_fns.init_state(zoo.param_shapes(cfg, torch.float32))
        meta = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta") for k, v in shard_batch(raw, mesh).items()}
        _, cost = roofline.count(dry_fns.train_step, dry_state, meta, MESH_TRAIN_LR)
    del dry_state
    _empty_rank_cache()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t3 = time.perf_counter()
    check_ = None
    for r in range(ranks.world_size()):         # one rank at a time: each holds one card's model meanwhile
        if r == ranks.rank():
            check_ = _mesh_family_train_reference(cfg, perf, raw, got, kept, specs, mesh)
            _empty_rank_cache()                 # the next rank takes the card
        ranks.barrier(mesh)
    ref_peak = _card_peak(dev)
    del kept
    _empty_rank_cache()
    rec = {"launches": launches, "step_s": t2 - t0, "loss_and_grads_s": t1 - t0, "AdamW_s": t2 - t1,
           "live": _tagged(stats), "seconds": _stats_sum(stats, "s"), "dry": _tagged(cost.staged),
           "check": check_, "peaks": (mesh_peak, ref_peak), "reference_s": time.perf_counter() - t3}
    everyone = [None] * ranks.world_size()
    dist.all_gather_object(everyone, rec)
    return {"ranks": everyone}


def _mesh_family_train_reference(cfg, perf, raw, got, kept, specs, mesh) -> dict:
    """This rank, alone on the card: one card's step on the same weights
    and batch (through the kernels; each MoE layer through
    ``moe_capacity_reference`` at the mesh's shape, so that its aux and
    drops are the bodies'), and its gradients on the plain path in float64;
    this rank's blocks (``kept``, on the host) held to the same blocks of
    one card's, each gradient within ``MESH_FAMILY_TRAIN_LIMIT["grad"]`` of
    its leaf's largest entry or twice one card's own distance from the
    float64 run (the SSD kernel's fp32 rounds ~1e-4 of its output, PERF.md
    §6, more than the plain path does), which runs only where a leaf is
    past the first limit (its distance 0 otherwise)."""
    import torch

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import ranks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import paths, tree_map

    dev = ranks.device()
    block = lambda k, t: ranks.shard(t, specs[k], mesh)  # noqa: E731
    batch = shard_batch(raw, make_host_mesh(dev))

    def params():
        return zoo.init_params(cfg, torch.Generator(dev).manual_seed(MESH_FAMILY_SEED), torch.float32)

    moe_shape = dict(zip(mesh.axis_names, mesh.axis_sizes))
    t0 = time.perf_counter()
    with _capacity_moe(moe_shape):
        fns = make_train_step(cfg, perf)
        state = fns.init_state(params())
        auxes: list = []
        with _aux_recorded(auxes):
            loss, grads = fns.loss_and_grads(state.params, batch)
        scale = {k: float(g.abs().max()) for k, g in grads.items()}
        ref_grads = {k: block(k, g).clone() for k, g in grads.items()}
        state, m = fns.apply_grads(state, loss, grads, MESH_TRAIN_LR)
        del grads
        ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "aux": float(sum(auxes)) if auxes and got["aux"] is not None else None}
        ref_params = {k: block(k, t.detach()).clone() for k, t in paths(state.params).items()}
        p_scale = {k: float(t.detach().abs().max()) for k, t in paths(state.params).items()}
        del state, fns
        _empty_rank_cache()
        diffs = {k: float((kept["grads"][k].to(dev) - g).abs().max()) for k, g in ref_grads.items()}
        dist64 = dict.fromkeys(ref_grads, 0.0)
        if any(diffs[k] > MESH_FAMILY_TRAIN_LIMIT["grad"] * scale[k] for k in diffs):    # float64 decides
            wide = tree_map(lambda t: t.double(), params())
            with plain_path():
                _, g64 = make_train_step(cfg, perf).loss_and_grads(wide, batch)
            dist64 = {k: float((g.double() - block(k, g64[k])).abs().max()) / scale[k] for k, g in ref_grads.items()}
            del wide, g64
            _empty_rank_cache()
    leaves = {}
    for k, g in ref_grads.items():
        decided = _decided(kept["v"][k].to(dev), diffs[k])
        err = (kept["params"][k].to(dev) - ref_params[k]).abs()
        leaves[k] = {"grad": diffs[k] / scale[k], "bound": max(MESH_FAMILY_TRAIN_LIMIT["grad"], 2 * dist64[k]),
                     "dist64": dist64[k], "decided": float(torch.where(decided, err, 0).max()) / p_scale[k],
                     "other": float(torch.where(decided, 0, err).max())}
    rel = {key: abs(got[key] - ref[key]) / abs(ref[key]) for key in ("loss", "grad_norm")}
    if ref["aux"] is not None:
        rel["aux"] = abs(got["aux"] - ref["aux"]) / abs(ref["aux"])
    return {"got": got, "ref": ref, "rel": rel, "leaves": leaves, "s": time.perf_counter() - t0}


def _mesh_families_train(reduced: bool) -> dict:
    """(j) every case of ``MESH_FAMILY_TRAIN`` in turn, with its seconds."""
    out = {}
    for name in MESH_FAMILY_TRAIN:
        t0 = time.perf_counter()
        out[name] = _mesh_family_train_case(name, reduced)
        out[name]["s"] = time.perf_counter() - t0
    return out


def _mesh_families_train_report(card: str, got: dict, runtime: dict) -> tuple[int, int]:
    """(j) each case's ranks against one card and against the dry mode's
    count, launches exact → (its flash launches, its SSD launches, all
    ranks)."""
    n_fa = n_ssd = 0
    lim = MESH_FAMILY_TRAIN_LIMIT
    print(f"  (j) the train step on (data, model) meshes of the MoE, Mamba-2, hybrid and frontend families, fp32, "
          f"one step, remat full, {runtime['ranks']} ranks on one card, each rank held to one card's step [{card}; "
          f"one card: the runtime, not scale-out]")
    for name, case in got.items():
        _, _, shape, fields, _, b, s = MESH_FAMILY_TRAIN[name]
        cfg = _family_train_cfg(name, MOE_MESH_REDUCED)
        n_attn, n_ssm = _family_layers(cfg)
        on_card = DEV == "cuda"
        want = {"flash": 2 * n_attn if on_card else 0, "ssd": 2 * n_ssm if on_card else 0}
        changed = {k: v for k, v in dataclasses.asdict(_resolved_perf(fields, cfg)).items() if k in fields}
        print(f"    {name}: {cfg.name}, {cfg.num_layers} layers, (data {shape[0]}, model {shape[1]}), B {b}, S {s}, "
              f"{changed or 'baseline'}; {case['s']:.1f} s")
        for r, rank in enumerate(case["ranks"]):
            live, dry, chk = rank["live"], rank["dry"], rank["check"]
            staged = sum(v[1] for v in live.values())
            rate = staged / rank["seconds"] / 1e9 if rank["seconds"] else 0.0
            leaves = chk["leaves"]
            worst_k = max(leaves, key=lambda k: leaves[k]["grad"] / leaves[k]["bound"])
            worst = leaves[worst_k]
            decided = max(v["decided"] for v in leaves.values())
            other = max(v["other"] for v in leaves.values())
            aux = (f"; aux {chk['got']['aux']:.8g} against moe_capacity_reference's mean of the blocks "
                   f"{chk['ref']['aux']:.8g} ({chk['rel']['aux']:.3g}, limit {lim['aux']})"
                   if "aux" in chk["rel"] else "")
            print(f"      rank {r}: step {rank['step_s']:.3f} s (loss and gradients {rank['loss_and_grads_s']:.3f}, "
                  f"AdamW {rank['AdamW_s']:.3f}); staged {staged / 1e9:.4g} GB through the host in "
                  f"{rank['seconds']:.3f} s ({rate:.2f} GB/s; {live}); the dry mode's count equal: {dry == live}; "
                  f"launches {rank['launches']} (expected {want}); card memory peak {rank['peaks'][0]:.2f} GB in the "
                  f"mesh step, {rank['peaks'][1]:.2f} GB in the one-card references; one card's step "
                  f"{chk['s']:.1f} s")
            print(f"        loss {chk['got']['loss']:.8g} against one card {chk['ref']['loss']:.8g} "
                  f"({chk['rel']['loss']:.3g}, limit {lim['loss']}), grad norm {chk['rel']['grad_norm']:.3g} (limit "
                  f"{lim['grad_norm']}){aux}; worst gradient {worst_k} {worst['grad']:.3g} of its largest entry "
                  f"(limit {worst['bound']:.3g} = max({lim['grad']}, twice one card's distance from the plain path "
                  f"in float64 {worst['dist64']:.3g}, 0 where not run)); parameters after the step {decided:.3g} "
                  f"of a leaf's largest entry where decided (limit {MESH_UPDATE_REL}), {other:.3g} elsewhere (limit "
                  f"{2 * MESH_TRAIN_LR:g})")
            check(all(math.isfinite(chk["got"][k]) for k in ("loss", "grad_norm"))
                  and chk["rel"]["loss"] <= lim["loss"] and chk["rel"]["grad_norm"] <= lim["grad_norm"]
                  and chk["rel"].get("aux", 0.0) <= lim["aux"],
                  f"(j) {name}, rank {r}: the mesh step departs from one card's ({chk['rel']})")
            check(all(v["grad"] <= v["bound"] for v in leaves.values()),
                  f"(j) {name}, rank {r}: the gradient of {worst_k} is {worst['grad']:.3g} from one card's")
            check(decided <= MESH_UPDATE_REL and other <= 2 * MESH_TRAIN_LR,
                  f"(j) {name}, rank {r}: the parameters after the step: {decided:.3g}, {other:.3g}")
            check(rank["launches"] == want, f"(j) {name}, rank {r}: launches {rank['launches']}, not {want}")
            check(dry == live, f"(j) {name}, rank {r}: the dry mode counts {dry}, the run staged {live}")
            n_fa += rank["launches"]["flash"]
            n_ssd += rank["launches"]["ssd"]
    return n_fa, n_ssd


def _mesh_train_ranks(reduced: bool, compress_inputs: tuple, timeline: dict | None = None,
                      t0: float | None = None) -> dict:
    """The train step's share of the phase's spawn: (e), (f), (g), with
    the flash launches a rank of each; then the sharded serving step (h),
    the other families' (i) and their train step (j); ``timeline`` takes
    each one's end, in seconds from ``t0`` (this call's start by
    default)."""
    from repro_torch.kernels.flash_attention import ops as fa

    timeline = {} if timeline is None else timeline
    t0 = time.perf_counter() if t0 is None else t0
    out = {"train": _mesh_train_case(reduced)}
    timeline["(e)"] = time.perf_counter() - t0
    fa.launches = 0
    out["compress_train"] = _mesh_compress_train(*compress_inputs)
    out["elastic"] = _mesh_elastic()
    out["other_launches"] = fa.launches
    timeline["(f), (g)"] = time.perf_counter() - t0
    out["serve"] = _mesh_serve_case(reduced)
    timeline["(h)"] = time.perf_counter() - t0
    out["families"] = _mesh_families(reduced)
    timeline["(i)"] = time.perf_counter() - t0
    out["family_train"] = _mesh_families_train(reduced)
    timeline["(j)"] = time.perf_counter() - t0
    out["timeline"] = {k: round(v, 1) for k, v in timeline.items()}
    return out


def _mesh_ranks(ens_args: tuple, archs, reduced: bool, train_reduced: bool, compress_inputs: tuple) -> dict:
    """The phase's one spawn: the sharded ensemble, the MoE layers,
    ``compress_psum`` and the train step, each rank's host and card memory
    peaks."""
    import resource

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import ranks

    dev = ranks.device()
    t0 = time.perf_counter()
    out = {"ensemble": _ensemble_case(*ens_args), "runtime": ranks.info()}
    out["timeline"] = {"ensemble": time.perf_counter() - t0}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    out["moe"] = _moe_mesh_cases(archs, reduced)
    peaks = [None] * ranks.world_size()
    dist.all_gather_object(peaks, (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
                                   torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0))
    out["moe"]["peaks"] = peaks
    out["compress"] = _compress_case()
    out["timeline"]["MoE layers, compress_psum"] = time.perf_counter() - t0
    out.update(_mesh_train_ranks(train_reduced, compress_inputs, out["timeline"], t0))
    return out


def _mc_fleet(n, dev, budget_mj=1500.0):
    from repro_torch.core import energy_model as em
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.fleet import uniform_fleet

    return uniform_fleet(n, strategies=("on_off", "idle_waiting", "adaptive"),
                         method=IdlePowerMethod.METHOD1_2, e_budget_mj=budget_mj,
                         powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ, device=dev)


def _mesh_acceptance(card: str) -> None:
    """(a) ``launch.fleet --mesh 4 --acceptance-devices 1048576``."""
    payload = _launcher("fleet", ROOT / "build" / "chip_smoke_fleet_mesh.json", "--smoke", "--mode",
                        "periodic", "--mesh", str(MESH_RANKS), "--acceptance-devices", str(MESH_ACCEPTANCE))
    acc, sh = payload["sharded_acceptance"], payload["throughput"]["sharded"]
    con, ref, rt = acc["ledger_conservation"], acc["unsharded"], acc["runtime"]
    print(f"  sharded acceptance: {acc['devices']} devices on a {acc['mesh']} mesh ({rt['ranks']} ranks, "
          f"{rt['ranks_per_card']} a card, {rt['backend']} staged on the {rt['staged']}, spawn "
          f"{rt['spawn_s']:.2f} s), 2 J a device, cap {acc['n_steps_cap']} steps, {acc['steps_executed']} run: "
          f"{acc['elapsed_s']} s, {acc['device_steps_per_s']:.4e} device-steps/s; run_periodic on {DEV} "
          f"{ref['elapsed_s']} s, {ref['device_steps_per_s']:.4e} device-steps/s; bit for bit "
          f"{ref['bit_identical']}; every budget exhausted {acc['all_budget_exhausted']}; conservation "
          f"per device {con['per_device_max_rel_err']:.3g}, aggregate {con['aggregate_rel_err']:.3g} "
          f"[{card}; one card: the runtime, not scale-out]")
    print(f"  sharded periodic ({payload['config']['devices']} devices, {sh['mesh']}): "
          f"{sh['fleet']['device_steps_per_s']:.4e} device-steps/s, bit for bit {sh['bit_identical_to_unsharded']}")
    check(ref["bit_identical"] and sh["bit_identical_to_unsharded"], "the sharded fleet differs from run_periodic")
    check(acc["all_budget_exhausted"], "the acceptance scan left budgets unspent")
    check(con["within_1e-9"], f"the acceptance scan's ledger: {con}")
    check(rt["ranks"] == MESH_RANKS and rt["ranks_per_card"] == (MESH_RANKS if DEV == "cuda" else None),
          f"the runtime: {rt}")


def _mesh_ensemble(card: str, got: dict, runtime: dict) -> None:
    """(b) the periodic ensemble on a 2 x 2 (fleet, seed) mesh against the
    unsharded run; ``launch.mc --smoke --mesh 2x2`` against ``--mesh 1``."""
    import numpy as np
    import torch

    from repro_torch.core.arrivals import PoissonArrivals
    from repro_torch.mc import run_periodic_ensemble
    from repro_torch.obs.ledger import AXES

    ens = got["ens"]
    params = _mc_fleet(MC_DEVICES, DEV)
    _reset_peak()
    ref, s_ref = _timed(lambda: run_periodic_ensemble(params, PoissonArrivals(40.0), MC_STEPS, MC_SEEDS, seed=0,
                                                      seed_chunk=MESH_ENS_CHUNK))
    steps = MC_SEEDS * MC_DEVICES * MC_STEPS
    for f in ("lifetime_ms", "total_items", "total_energy_mj", "energy_per_request_mj"):
        check(np.array_equal(getattr(ref, f), getattr(ens, f), equal_nan=True), f"the 2x2 ensemble: {f} differs")
    for w in ("device_lifetime_ms", "device_energy_mj", "device_items"):
        for m in ("mean", "m2"):
            check(np.array_equal(getattr(getattr(ref, w), m), getattr(getattr(ens, w), m)),
                  f"the 2x2 ensemble: {w}.{m} differs")
    for ax in AXES:
        check(np.array_equal(getattr(ref.ledger, f"{ax}_mj"), getattr(ens.ledger, f"{ax}_mj")),
              f"the 2x2 ensemble's ledger: {ax} differs")
    print(f"  periodic ensemble {MC_SEEDS} seeds x {MC_DEVICES} devices x {MC_STEPS} steps ({MESH_ENS_CHUNK} seeds "
          f"a chunk) on a {MESH_ENS[0]}x{MESH_ENS[1]} (fleet, seed) mesh, {runtime['ranks']} ranks on one card: "
          f"{got['s']:.2f} s in the ranks, {steps / got['s']:.4e} device-steps/s; unsharded {s_ref:.2f} s, "
          f"{steps / s_ref:.4e} device-steps/s (peak {_peak() / 1e9:.2f} GB); bit for bit in every aggregate, "
          f"Welford moment and ledger axis [{card}]")
    del ref, ens, params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    one = _launcher("mc", ROOT / "build" / "chip_smoke_mc_mesh1.json", "--smoke", "--section", "ensemble")
    two = _launcher("mc", ROOT / "build" / "chip_smoke_mc_mesh2x2.json", "--smoke", "--section", "ensemble",
                    "--mesh", "2x2")
    a, b = dict(one["ensemble"]), dict(two["ensemble"])
    for blk in (a, b):
        for k in ("elapsed_s", "mesh", "runtime"):
            blk.pop(k)
    check(a == b, "launch.mc --mesh 2x2's ensemble differs from --mesh 1's")
    print(f"  launch.mc --smoke --mesh 2x2: the ensemble section equals --mesh 1's "
          f"({two['ensemble']['runtime']['ranks']} ranks, spawn {two['ensemble']['runtime']['spawn_s']:.2f} s) "
          f"[{card}]")


def _moe_references() -> dict:
    """Each MoE layer's single-card outputs on the whole weights: the
    dropless ``moe_block``, and ``moe_capacity_reference`` (with its dropped
    slots) for every mesh and capacity factor of the ranks' cases."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.models import moe

    refs = {}
    for arch in MOE_MESH_ARCHS:
        cfg = get_config(arch, reduced=MOE_MESH_REDUCED)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            params = _moe_params(cfg, dtype, DEV)
            _, x = _moe_router_and_input(cfg, dtype, DEV)
            with torch.inference_mode():
                refs[arch, name, "dropless"] = moe.moe_block(params, x, cfg)[0].float().cpu()
                for shape in MOE_MESHES:
                    refs[arch, name, shape, "branch"] = moe._branch(cfg, Mesh(shape, ("data", "model")))
                    for cf in _moe_cfs(shape, name):
                        capped, _, dropped = moe.moe_capacity_reference(params, x, cfg, cf,
                                                                       dict(zip(("data", "model"), shape)))
                        refs[arch, name, shape, cf] = (capped.float().cpu(), dropped)
            refs[arch, name, "shape"] = tuple(x.shape)
            del params, x
            if DEV == "cuda":
                torch.cuda.empty_cache()
    return refs


def _mesh_moe(card: str, got: dict, runtime: dict, refs: dict) -> None:
    """(c) one full-width MoE layer a branch, fp32 and bf16, on (data 1,
    model 4) and (data 2, model 2): nothing dropped against the dropless
    ``moe_block``, slots dropped against ``moe_capacity_reference``."""
    import resource

    import torch

    peaks = got["peaks"]
    print(f"  MoE layers: {runtime['ranks']} ranks on one card, each drawing only its own weight blocks; "
          f"host memory peak a rank {max(p[0] for p in peaks):.2f} GB, card memory peak a rank "
          f"{max(p[1] for p in peaks):.2f} GB; this process {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB")
    for arch in MOE_MESH_ARCHS:
        for name in ("float32", "bfloat16"):
            limit = MOE_DISPATCH_LIMIT[name]
            for shape in MOE_MESHES:
                branch = refs[arch, name, shape, "branch"]
                for cf in _moe_cfs(shape, name):
                    y, _ = got["out"][arch, name, shape, cf]
                    capped, dropped = refs[arch, name, shape, cf]
                    if cf == MOE_CF[0]:
                        want, against = refs[arch, name, "dropless"], "dropless moe_block"
                    else:
                        want, against = capped, "moe_capacity_reference"
                    err = float((y.float() - want).abs().max())
                    top = float(want.abs().max())
                    s = got["seconds"][arch, name, shape, cf]
                    print(f"  {arch} ({branch}) {name} on (data {shape[0]}, model {shape[1]}), capacity factor "
                          f"{cf:g}: {dropped} slots dropped; against {against} relative error {err / top:.3g} "
                          f"(limit {limit}); the sharded layer {s * 1e3:.1f} ms [{card}]")
                    check(tuple(y.shape) == refs[arch, name, "shape"] and bool(torch.isfinite(y).all())
                          and err / top <= limit, f"{arch} {name} {shape} cf {cf}: the sharded MoE is {err / top:.3g} off")
                    check((dropped == 0) if cf == MOE_CF[0] else (dropped > 0),
                          f"{arch} {shape} cf {cf}: {dropped} slots dropped")


def _mesh_compress(card: str, card_run: dict, cpu_run: dict) -> None:
    """(d) ``compress_psum`` over a (pod 2) mesh on one qwen3-1.7b decoder
    layer's gradient tree: against the exact mean, and the card against the
    CPU."""
    import torch

    g0, g1 = _compress_grads(0, "cpu"), _compress_grads(1, "cpu")
    worst, n_values, diffs = 0.0, 0, []
    for k in g0:
        exact = (g0[k].double() + g1[k].double()) / 2
        out = card_run["out"][k]
        worst = max(worst, float((out.double() - exact).abs().max() / exact.abs().max()))
        n_values += out.numel()
        for what in ("out", "err"):
            a, b = card_run[what][k], cpu_run[what][k]
            if not torch.equal(a, b):
                diffs.append(f"{what}[{k}]: {int((a != b).sum())} of {a.numel()} differ, by at most "
                             f"{float((a - b).abs().max()):.3g}")
    print(f"  compress_psum over (pod 2), one {ARCH} decoder layer's gradients ({n_values} fp32 values, "
          f"{len(g0)} leaves): worst leaf {worst:.4g} of its largest exact mean (limit {COMPRESS_LIMIT}); "
          f"{card_run['s'] * 1e3:.1f} ms on the card's ranks, {cpu_run['s'] * 1e3:.1f} ms on the CPU's; card = "
          f"CPU bit for bit: {not diffs} [{card}]")
    for line in diffs:
        print(f"    {line}")
    check(worst <= COMPRESS_LIMIT, f"compress_psum is {worst:.3g} from the exact mean")
    check(n_values > 45_000_000, f"the gradient tree holds {n_values} values")


def _mesh_train_report(card: str, got: dict, runtime: dict) -> int:
    """(e) the full-width train step on (data 2, model 2) against the
    single-card step → its flash launches, all ranks."""
    train = got["train"]
    per = train["ranks"]
    cfg = _mesh_train_cfg(MOE_MESH_REDUCED)
    per_rank = 2 * cfg.num_layers * 2 * MESH_TRAIN_STEPS if DEV == "cuda" else 0
    b, s = MESH_TRAIN_TOKENS
    print(f"  train step on (data {MESH_TRAIN_SHAPE[0]}, model {MESH_TRAIN_SHAPE[1]}): {ARCH} at its published "
          f"widths, {cfg.num_layers} layers (the cut keeps the gloo-on-host gathers of the {cfg.vocab_size} x "
          f"{cfg.d_model} embedding inside the phase), fp32, B {b}, S {s}, remat full, {runtime['ranks']} ranks on "
          f"one card (spawn {runtime['spawn_s']:.2f} s); {train['s']:.1f} s for both runs, each rank's single-card "
          f"reference in turn {train['reference_s']:.1f} s [{card}; one card: the runtime, not scale-out]")
    for once in (False, True):
        entry = per[0]["check"][once]
        rel = {key: max(r["check"][once]["rel"][key] for r in per) for key in ("loss", "grad_norm")}
        label = f"gather_weights_once={once}"
        print(f"    {label}: losses {entry['loss']} against one card {entry['ref_loss']}, grad norms "
              f"{entry['grad_norm']} against {entry['ref_grad_norm']}; worst relative loss {rel['loss']:.3g}, "
              f"grad norm {rel['grad_norm']:.3g} over the ranks (limits {MESH_TRAIN_LIMIT['loss']}, "
              f"{MESH_TRAIN_LIMIT['grad_norm']}); step s {[round(v, 3) for v in per[0]['step_s'][once]]}")
        check(rel["loss"] <= MESH_TRAIN_LIMIT["loss"] and rel["grad_norm"] <= MESH_TRAIN_LIMIT["grad_norm"]
              and all(math.isfinite(v) for v in entry["loss"]), f"the mesh train step ({label}) departs from one card")
    leaves = [(r, k, v) for r, rank in enumerate(per) for k, v in rank["check"][False]["leaves"].items()]
    r, leaf, worst = max(leaves, key=lambda x: x[2]["grad"] / x[2]["bound"])
    decided = max(v["decided"] for _, _, v in leaves)
    other = max(v["other"] for _, _, v in leaves)
    print(f"    step 1's gradients, each rank's blocks against one card's: worst leaf {leaf} (rank {r}) "
          f"{worst['grad']:.3g} of its largest entry (limit {worst['bound']:.3g} = max({MESH_TRAIN_LIMIT['grad']}, "
          f"twice the plain path's distance from float64; the largest such distance "
          f"{max(v['dist64'] for _, _, v in leaves):.3g}); parameters after step 1: {decided:.3g} of a leaf's largest "
          f"entry where the update is decided (limit {MESH_UPDATE_REL}), {other:.3g} elsewhere (limit "
          f"{2 * MESH_TRAIN_LR:g} = 2 lr)")
    check(all(v["grad"] <= v["bound"] for _, _, v in leaves),
          f"the mesh step's gradient of {leaf} is {worst['grad']:.3g} from one card's (limit {worst['bound']:.3g})")
    check(decided <= MESH_UPDATE_REL and other <= 2 * MESH_TRAIN_LR,
          f"the mesh step's parameters after step 1: {decided:.3g}, {other:.3g}")
    for once in (False, True):
        sp = per[0]["split"][once]
        top = max(range(len(per)), key=lambda i: per[i]["split"][once]["step"])
        print(f"    gather_weights_once={once}, step 2 on rank 0: {sp['step']:.3f} s = weight gather "
              f"{sp['weight gather']:.3f} + forward {sp['forward']:.3f} + backward (with the recomputed forward) "
              f"{sp['backward']:.3f} + gradient reduce {sp['gradient reduce']:.3f} + tensor-parallel and loss sums "
              f"{sp['tensor parallel']:.3f} + AdamW {sp['AdamW']:.3f}; {sp['host bytes'] / 1e9:.3f} GB through "
              f"the host a rank a step ({ {k: round(v['bytes'] / 1e9, 4) for k, v in sp['by tag'].items()} } GB by "
              f"tag); slowest rank {top}, {per[top]['split'][once]['step']:.3f} s")
    counts = [rank["launches"] for rank in per]
    print(f"    during the mesh runs: host memory peak a rank {max(rank['peak'][0] for rank in per):.2f} GB, card "
          f"memory peak a rank {[round(rank['peak'][1], 2) for rank in per]} GB; flash launches a rank {counts} "
          f"(expected {per_rank}: 2 a layer a step under remat full)")
    check(all(n == per_rank for n in counts), f"mesh train flash launches {counts}, not {per_rank}")
    return sum(counts)


def _mesh_compress_report(card: str, got: dict, cpu: dict) -> None:
    """(f) the compressed cross-pod step against the uncompressed one and
    the CPU ranks."""
    exact, comp = got[False]["losses"], got[True]["losses"]
    gaps = [[abs(a - b) / abs(b) for a, b in zip(got[run]["losses"], cpu[run]["losses"])] for run in (False, True)]
    first, later = max(g[0] for g in gaps), max(v for g in gaps for v in g[1:])
    print(f"  compressed cross-pod step, reduced yi-6b on (pod {MESH_COMPRESS_SHAPE[0]}, data {MESH_COMPRESS_SHAPE[1]}, "
          f"model {MESH_COMPRESS_SHAPE[2]}), {MESH_COMPRESS_STEPS} steps at lr {MESH_COMPRESS_LR}: compressed {comp}, "
          f"exact {exact}; first {abs(comp[0] - exact[0]):.3g} (limit 1e-3), last {abs(comp[-1] - exact[-1]):.3g} "
          f"(limit 0.05); the card's losses against four CPU ranks', relative: the first {first:.3g} (limit "
          f"{MESH_COMPRESS_CPU[0]}), the later ones {later:.3g} (limit {MESH_COMPRESS_CPU[1]}); {got['s']:.1f} s "
          f"[{card}]")
    check(all(math.isfinite(v) for v in comp) and abs(comp[0] - exact[0]) < 1e-3 and abs(comp[-1] - exact[-1]) < 0.05,
          "the compressed cross-pod step departs from the exact one")
    check(got[True]["err"], "the compressed step kept no error-feedback state")
    check(first <= MESH_COMPRESS_CPU[0] and later <= MESH_COMPRESS_CPU[1],
          f"the card's cross-pod losses are {first:.3g}, {later:.3g} from the CPU's")


def _mesh_elastic_report(card: str, got: dict) -> None:
    """(g) the elastic resume across a re-mesh."""
    resumed = got["first"] + got["second"]
    err = max(abs(a - b) for a, b in zip(resumed, got["full"]))
    print(f"  elastic resume, reduced {ARCH} through launch.train.train(mesh=): {got['first']} on (data 2, model 2), "
          f"a checkpoint, then {got['second']} on the survivors' (data {got['plan'][0]}, model {got['plan'][1]}) "
          f"against {got['full']} uninterrupted: {err:.3g} (limit {MESH_ELASTIC_LIMIT}); the checkpoint equals a "
          f"single-card save of the gathered state bit for bit: {got['blob_equal']}; {got['s']:.1f} s [{card}]")
    check(got["plan"] == (1, 2) and len(resumed) == len(got["full"]) and err <= MESH_ELASTIC_LIMIT,
          f"the elastic resume departs by {err:.3g}")
    check(got["blob_equal"], "the mesh checkpoint differs from a single-card save of the same state")


def _mesh_serve_report(card: str, got: dict, runtime: dict) -> tuple[int, dict]:
    """(h) the sharded prefill and decode against one card and against the
    dry mode's count → (their flash launches, all ranks; what the roofline
    phase needs of the sharded prefill)."""
    per = got["serve"]["ranks"]
    cfg = _mesh_train_cfg(MOE_MESH_REDUCED)
    b, s = MESH_SERVE_TOKENS
    want = (cfg.num_layers if DEV == "cuda" else 0, 0)
    print(f"  sharded prefill and decode on (data {MESH_TRAIN_SHAPE[0]}, model {MESH_TRAIN_SHAPE[1]}): {ARCH} at its "
          f"published widths, {cfg.num_layers} layers, fp32, B {b}, prompt {s}, {MESH_SERVE_NEW} greedy decode steps, "
          f"{runtime['ranks']} ranks on one card [{card}; one card: the runtime, not scale-out]")
    for r, rank in enumerate(per):
        live, dry = rank["live"], rank["dry"]
        rate = {k: sum(v[1] for v in live[k].values()) / rank["seconds"][k] / 1e9 if rank["seconds"][k] else 0.0
                for k in live}
        print(f"    rank {r}: prefill {rank['prefill_s']:.3f} s, {MESH_SERVE_NEW} decode steps {rank['decode_s']:.3f} s "
              f"({rank['decode_s'] / MESH_SERVE_NEW * 1e3:.1f} ms a step); logits against one card's rows "
              f"{rank['err']:.3g} of the largest (limit {MESH_SERVE_LIMIT}), greedy tokens equal {rank['same_tokens']}; "
              f"flash launches prefill / decode {rank['launches']} (expected {want}); staged through the host "
              f"(calls, bytes) by tag: prefill {live['prefill']}, decode {live['decode']}, at "
              f"{rate['prefill']:.2f} / {rate['decode']:.2f} GB/s; the dry mode's count equal: "
              f"{dry == live}")
        check(rank["finite"] and rank["spread"] > 0 and rank["err"] <= MESH_SERVE_LIMIT and rank["same_tokens"],
              f"rank {r}'s sharded prefill and decode depart from one card's ({rank['err']:.3g})")
        check(tuple(rank["launches"]) == want, f"rank {r}: flash launches {rank['launches']}, not {want}")
        check(dry == live, f"rank {r}: the dry mode counts {dry}, the run staged {live}")
    return sum(sum(rank["launches"]) for rank in per), {"ranks": per, "cfg": cfg}


def mesh_phase(card: str, meanwhile: tuple = ()) -> tuple[int, int, int, int, dict, list]:
    """The multi-rank runtime on one card: the sharded acceptance scan
    through ``launch.fleet``; then one spawn of four ranks for the sharded
    ensemble, the MoE's two sharded bodies at full width,
    ``compress_psum`` and the GSPMD train step (full-width qwen3-1.7b, the
    compressed cross-pod step, the elastic resume), while this process
    computes the MoE layers' single-card references and runs
    ``compress_psum`` and the cross-pod step on CPU ranks; each sharded
    result held to its single-device version; then the sharded prefill
    and decode (h), the other families' serving (i) and their train step
    (j).  Beside them a process a task calls each of ``meanwhile``
    (``(fn, *args)`` each: the roofline phase's counts on ``meta``, no
    card) → (the train steps' flash launches, the serving steps', the
    serving steps' SSD launches, the train step's, what the roofline phase
    needs of the sharded prefill, what each task of ``meanwhile``
    returned)."""
    import threading
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from repro_torch.distributed import ranks

    if DEV == "cuda":
        torch.cuda.empty_cache()
    _mesh_acceptance(card)
    box: dict = {}
    compress_inputs = _mesh_compress_inputs()

    def run_ranks():
        try:
            box["got"] = ranks.spawn(MESH_RANKS, _mesh_ranks, (MC_SEEDS, MESH_ENS_CHUNK, MC_DEVICES, MC_STEPS),
                                     MOE_MESH_ARCHS, MOE_MESH_REDUCED, MOE_MESH_REDUCED, compress_inputs, device=DEV)
        except BaseException as e:              # re-raised below, once this process's share is done
            box["error"] = e
        box["s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    thread = threading.Thread(target=run_ranks)
    thread.start()
    with ProcessPoolExecutor(max(1, len(meanwhile)), mp_context=ranks.process_context()) as pool:
        counting = [pool.submit(_clocked, *task) for task in meanwhile]
        refs = _moe_references()
        cpu_compress = ranks.spawn(2, _compress_case, device="cpu")
        cpu_crosspod = ranks.spawn(math.prod(MESH_COMPRESS_SHAPE), _mesh_compress_train, *compress_inputs,
                                   device="cpu")
        s_here = time.perf_counter() - t0
        extras = [c.result() for c in counting]
    thread.join()
    if "error" in box:
        raise box["error"]
    got = box["got"]
    rt = got["runtime"]
    print(f"  the phase's ranks: {rt['ranks']} ({rt['ranks_per_card']} a card, {rt['backend']} staged on the "
          f"{rt['staged']}), spawned in {rt['spawn_s']:.2f} s, done in {box['s']:.1f} s (rank 0's parts, s from "
          f"the spawn: {got['timeline']}); meanwhile here the single-card MoE references and the CPU's "
          f"compress_psum and cross-pod step ({s_here:.1f} s), and in {len(extras)} processes beside them the "
          f"roofline phase's counts on meta ({[round(s, 1) for _, s in extras]} s); the phase's spawn and counts "
          f"done in {time.perf_counter() - t0:.1f} s")
    _mesh_ensemble(card, got["ensemble"], rt)
    _mesh_moe(card, got["moe"], rt, refs)
    _mesh_compress(card, got["compress"], cpu_compress)
    launches = _mesh_train_report(card, got, rt)
    _mesh_compress_report(card, got["compress_train"], cpu_crosspod)
    _mesh_elastic_report(card, got["elastic"])
    print(f"  flash launches of the compressed and elastic runs, rank 0: {got['other_launches']}")
    serve_launches, serve = _mesh_serve_report(card, got, rt)
    family_fa, family_ssd = _mesh_families_report(card, got["families"], rt)
    train_fa, train_ssd = _mesh_families_train_report(card, got["family_train"], rt)
    return launches + train_fa, serve_launches + family_fa, family_ssd, train_ssd, serve, [r for r, _ in extras]


DENSE_DECODERS = ("qwen3-1.7b", "yi-6b", "internlm2-20b", "qwen3-32b")
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun_{}.json"


def _dryrun_cli(mesh: str) -> dict:
    """``python -m repro_torch.launch.dryrun --all --mesh <mesh>`` in this
    process, on ``meta`` → its cells, seconds and exit code."""
    from repro_torch.launch import dryrun

    out = Path(str(DRYRUN_OUT).format(mesh))
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    rc = dryrun.main(["--all", "--mesh", mesh, "--out", str(out)])
    return {"got": json.loads(out.read_text()), "s": time.perf_counter() - t0, "rc": rc}


def _dryrun_merged(parts) -> dict:
    """The dry run's halves (``_dryrun_cli``'s, run side by side) as one
    ``--mesh both`` run: every cell, the longer half's seconds, the worse
    exit code."""
    return {"got": {k: v for part in parts for k, v in part["got"].items()},
            "s": max(part["s"] for part in parts), "rc": max(part["rc"] for part in parts)}


def _roofline_line(label: str, terms, measured_s: float, card: str) -> float:
    """Print one counted cell's terms beside the time measured → bound /
    time."""
    ratio = terms.step_time_lower_bound_s / measured_s
    print(f"  {label}: {terms.flops_per_device:.4g} FLOPs, {terms.bytes_per_device / 1e9:.4g} GB HBM, "
          f"{terms.collective_bytes_per_device / 1e9:.4g} GB collective (ring model) → compute "
          f"{terms.compute_s * 1e3:.4g} ms (peak {terms.peak_flops / 1e12:g} TFLOP/s), memory "
          f"{terms.memory_s * 1e3:.4g} ms, collective {terms.collective_s * 1e3:.4g} ms (at "
          f"{terms.collective_bw / 1e9:.3g} GB/s); dominant {terms.dominant}; bound "
          f"{terms.step_time_lower_bound_s * 1e3:.4g} ms against {measured_s * 1e3:.4g} ms measured: bound / time "
          f"{ratio:.4g}, mfu_bound {terms.mfu_bound:.4g}, measured MFU "
          f"{terms.model_flops / (terms.chips * terms.peak_flops * measured_s):.4g} [{card}]")
    check(ratio <= 1.0, f"{label}: the bound {terms.step_time_lower_bound_s:.4g} s exceeds the measured "
                        f"{measured_s:.4g} s: a counting error")
    return ratio


def _clocked(fn, *args):
    """``fn(*args)`` and its seconds on the host's clock."""
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def roofline_counts(train_step_s: dict, served: dict) -> dict:
    """What the roofline phase holds to the card's times, counted on
    ``meta`` with no card, so that the mesh phase can run it in a process
    of its own while its ranks work: (b)'s cells at a 1×1 mesh
    (``dryrun_lib.lower_cell``; ``train_step_s``: ``launch.train``'s step
    by arch) and (c) ``python -m repro_torch.launch.dryrun --all --mesh
    single`` (``--mesh multi`` counts in another process beside it) → each
    cell's (label, roofline, measured seconds, counting seconds) and the
    dry run's half."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import dryrun_lib

    one = Mesh((1, 1), ("data", "model"))
    cells = [
        (f"{ARCH} launch.train step (B {TRAIN_CLI_BATCH}, S {TRAIN_CLI_SEQ}, bf16)", ARCH,
         ShapeSpec("train", TRAIN_CLI_SEQ, TRAIN_CLI_BATCH, "train"), train_step_s[ARCH]),
        (f"{MAMBA} launch.train step (B {TRAIN_CLI_BATCH}, S {TRAIN_CLI_SEQ}, bf16)", MAMBA,
         ShapeSpec("train", TRAIN_CLI_SEQ, TRAIN_CLI_BATCH, "train"), train_step_s[MAMBA]),
        (f"{ARCH} served prefill (B {served['batch']}, S {served['prompt']}, bf16)", ARCH,
         ShapeSpec("prefill", served["prompt"], served["batch"], "prefill"), served["prefill_s"]),
        (f"{ARCH} served decode step (B {served['batch']}, cache {served['max_len']}, bf16)", ARCH,
         ShapeSpec("decode", served["max_len"], served["batch"], "decode"), served["decode_step_s"]),
    ]
    counted = []
    for label, arch, shape, measured in cells:
        t0 = time.perf_counter()
        res = dryrun_lib.lower_cell(arch, shape.name, mesh=one, shape=shape)
        check(res.status == "ok", f"{label}: {res.status} {res.reason}")
        counted.append((label, res.roofline, measured, time.perf_counter() - t0))
    return {"cells": counted, "dryrun": _dryrun_cli("single")}


def roofline_phase(card: str, counted: dict, mesh_serve: dict) -> dict:
    """(b) the cells the card ran, counted by ``launch/roofline.py`` on
    ``meta`` (``roofline_counts``, which the mesh phase ran in this process
    while its ranks worked) and held to the times the earlier phases
    measured: ``launch.train``'s step of qwen3-1.7b and mamba2-370m (B 8,
    S 128, bf16; ``_train_step_split``), the served prefill (B 2, S 32)
    and decode step (cache 96) of qwen3-1.7b (the obs phase's registry
    means), and the mesh phase's sharded prefill (each rank's counts times
    the ranks sharing the card, its collectives at the gloo rate that rank
    measured): bound / time at most 1 on the card's own ceilings; (c)
    ``python -m repro_torch.launch.dryrun --all --mesh both``: every
    prefill and decode cell and every family's train cells ``ok`` on both
    meshes, the rest skipped → the ratios."""
    from repro_torch.launch import roofline as rf

    ratios = {}
    for label, r, measured, secs in counted["cells"]:
        terms = rf.RooflineTerms(r["flops_per_device"], r["bytes_per_device"], r["collective_bytes_per_device"],
                                 r["chips"], r["model_flops"], peak_flops=rf.PEAK_FLOPS_BF16)
        ratios[label] = _roofline_line(f"{label}, counted in {secs:.1f} s", terms, measured, card)
    cfg, per = mesh_serve["cfg"], mesh_serve["ranks"]
    b, s = MESH_SERVE_TOKENS
    worst = 0.0
    for i, rank in enumerate(per):
        live = rank["live"]["prefill"]
        rate = sum(v[1] for v in live.values()) / rank["seconds"]["prefill"]
        cost = rank["cost"]
        terms = rf.RooflineTerms(cost["flops"] * len(per), cost["hbm_bytes"] * len(per), cost["ring_bytes"], 1,
                                 cfg.model_flops_per_token(False) * b * s, peak_flops=rf.PEAK_FLOPS_FP32,
                                 collective_bw=rate)
        worst = max(worst, _roofline_line(
            f"sharded prefill, rank {i} of {len(per)} on the card ({ARCH}, {cfg.num_layers} layers, fp32, B {b}, "
            f"S {s}; ring bytes by kind {cost['by_kind']})", terms, rank["prefill_s"], card))
    ratios["sharded prefill (worst rank)"] = worst

    got, secs, rc = (counted["dryrun"][k] for k in ("got", "s", "rc"))
    status = {k: v["status"] for k, v in got.items()}
    count = {st: sum(v == st for v in status.values()) for st in ("ok", "skipped", "error")}
    dense = [k for k in got if k.split("|")[0] in DENSE_DECODERS and k.split("|")[1] != "long_500k"]
    served = [k for k in got if k.split("|")[1] != "train_4k" and status[k] != "skipped"]
    trains = [k for k in got if k.split("|")[1] == "train_4k" and k.split("|")[0] not in DENSE_DECODERS]
    errors = [v["reason"] for v in got.values() if v["status"] == "error"]
    print(f"  launch.dryrun --all --mesh both: {len(got)} cells, {count['ok']} ok, {count['skipped']} skipped, "
          f"{count['error']} error, {secs:.1f} s on meta during the mesh phase (exit {rc})")
    for k in dense + trains + [k for k in served if k not in dense]:
        v = got[k]
        if v["status"] == "ok":
            r = v["roofline"]
            print(f"    {k}: dominant {r['dominant']}, bound {r['step_time_lower_bound_s']:.4g} s (compute "
                  f"{r['compute_s']:.4g}, memory {r['memory_s']:.4g}, collective {r['collective_s']:.4g}), "
                  f"mfu_bound {r['mfu_bound']:.4g}, {v['memory']['per_device_total_gb']:.3f} GB a rank")
    check(len(got) == 80 and sum(count.values()) == 80, f"the dry run covered {len(got)} cells, not 80")
    check(len(dense) == 24 and all(status[k] == "ok" for k in dense),
          f"dense cells not ok: {[k for k in dense if status[k] != 'ok']}")
    check(len(served) == 44 and all(status[k] == "ok" for k in served),
          f"prefill and decode cells not ok: {[k for k in served if status[k] != 'ok']}")
    check(len(trains) == 12 and all(status[k] == "ok" for k in trains),
          f"the other families' train cells not ok: {[k for k in trains if status[k] != 'ok']}")
    check(count == {"ok": 64, "skipped": 16, "error": 0}, f"the dry run's statuses {count}, errors {errors}")
    check(rc == 0, f"launch.dryrun exited {rc}")
    return ratios


@contextlib.contextmanager
def timed_phase(name: str, seconds: dict):
    """Print the phase's header, and its seconds when it ends."""
    print(f"== {name}")
    t0 = time.perf_counter()
    yield
    seconds[name] = round(time.perf_counter() - t0, 1)
    print(f"  ({name}: {seconds[name]} s)")


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
    seconds: dict = {}

    with timed_phase("build", seconds):
        from repro_torch.kernels import _lib

        t0 = time.perf_counter()
        _lib.library()
        print(f"kernel library built in {time.perf_counter() - t0:.2f} s "
              f"(cached: {_lib.last_build['cached']})")
        for line in _lib.last_build["log"].splitlines():
            if "registers" in line or "==" in line or "spill" in line:
                print(f"  {line.strip()}")

    with timed_phase("kernels vs plain versions", seconds):
        dq_entry = dequant_phase(card)
        fa_entry = flash_phase(card)

    with timed_phase("lstm", seconds):
        lstm_entry = lstm_phase(card)
        check(lstm_entry["launches"] > 0, "the LSTM kernel was never launched on the quickstart path")

    with timed_phase("decide", seconds):
        decide_phase()

    with timed_phase("duty-cycle example", seconds):
        fa_entry["launches"] += duty_cycle_example_phase(card)

    with timed_phase("serving", seconds):
        n_dq, n_fa = serving_phase(card)
        dq_entry["launches"] += n_dq
        fa_entry["launches"] += n_fa
        check(n_dq > 0 and n_fa > 0, "a kernel of the main path was never launched")

    with timed_phase("multi-tenant", seconds):
        fa_entry["launches"] += multi_tenant_example(card)
        n_dq, n_fa = multi_tenant_full_width(card)
        dq_entry["launches"] += n_dq
        fa_entry["launches"] += n_fa
        check(n_dq > 0 and n_fa > 0, "a kernel of the multi-tenant path was never launched")

    with timed_phase("ssd", seconds):
        ssd_entry = ssd_phase(card)

    with timed_phase("mamba2 serving", seconds):
        n_dq_mamba, n_ssd = mamba2_serving_phase(card)
        dq_entry["launches"] += n_dq_mamba
        ssd_entry["launches"] = n_ssd
        check(n_dq_mamba > 0 and n_ssd > 0, "a kernel of the mamba2 path was never launched")

    with timed_phase("train", seconds):
        n_fa, n_ssd, train_report = train_phase(card)
        fa_entry["launches"] += n_fa
        ssd_entry["launches"] += n_ssd
        fa_entry["train_launches"], ssd_entry["train_launches"] = n_fa, n_ssd
        fa_entry["train_gradients"] = train_report[ARCH]
        ssd_entry["train_gradients"] = train_report[MAMBA]
        check(n_fa > 0 and n_ssd > 0, "a kernel of the training path was never launched")

    with timed_phase("dense families", seconds):
        n_fa = dense_phase(card)
        fa_entry["launches"] += n_fa
        check(n_fa > 0, "the flash kernel was never launched on the dense families' path")

    with timed_phase("moe families", seconds):
        n_fa, fa_entry["moe_prefills"] = moe_phase(card)
        fa_entry["launches"] += n_fa
        check(n_fa > 0, "the flash kernel was never launched on the MoE families' path")

    with timed_phase("jamba", seconds):
        n_fa, n_ssd = jamba_phase(card)
        fa_entry["launches"] += n_fa
        ssd_entry["launches"] += n_ssd
        check(n_fa > 0 and n_ssd > 0, "a kernel of the hybrid path was never launched")

    with timed_phase("frontends", seconds):
        n_fa = frontends_phase(card)
        fa_entry["launches"] += n_fa
        check(n_fa > 0, "the flash kernel was never launched on the frontends' path")

    with timed_phase("moe serving", seconds):
        n_dq, n_fa, dq_entry["moe_expert_leaves"] = moe_serving_phase(card)
        dq_entry["launches"] += n_dq
        fa_entry["launches"] += n_fa
        check(n_dq > 0 and n_fa > 0, "a kernel of the MoE serving path was never launched")

    with timed_phase("sweep", seconds):
        sweep_phase(card)

    with timed_phase("fleet", seconds):
        fleet_phase(card)

    with timed_phase("optimize", seconds):
        optimize_phase(card)

    with timed_phase("policy", seconds):
        n_dq, n_fa = policy_phase(card)
        dq_entry["launches"] += n_dq
        fa_entry["launches"] += n_fa
        check(n_dq > 0 and n_fa > 0, "a kernel of the learned-policy serving path was never launched")

    with timed_phase("obs", seconds):
        n_dq, n_fa, served = obs_phase(card)
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        dq_entry["launches"] += n_dq
        fa_entry["launches"] += n_fa
        check(n_dq > 0 and n_fa > 0, "a kernel of the engine-metrics path was never launched")

    with timed_phase("mc", seconds):
        mc_phase(card)

    with timed_phase("costs", seconds):
        cal = costs_phase(card)
        for entry, name in ((dq_entry, "dequant"), (fa_entry, "flash_attention"), (lstm_entry, "lstm"),
                            (ssd_entry, "ssd")):
            entry["launches"] += cal[name]["launches"]
            entry["calibration"] = cal[name]

    with timed_phase("control", seconds):
        control_phase(card)

    with timed_phase("mesh", seconds):
        train_step_s = {arch: sum(train_report[arch]["step_split_s"].values()) for arch in (ARCH, MAMBA)}
        # the dry run's two meshes count side by side (one process each), the (b) cells beside the first
        n_fa, n_serve, n_ssd, n_ssd_train, mesh_serve, (counted, multi) = mesh_phase(
            card, ((roofline_counts, train_step_s, served), (_dryrun_cli, "multi")))
        counted["dryrun"] = _dryrun_merged([counted["dryrun"], multi])
        fa_entry["launches"] += n_fa + n_serve
        fa_entry["mesh_train_launches"] = n_fa
        fa_entry["mesh_serve_launches"] = n_serve
        ssd_entry["launches"] += n_ssd + n_ssd_train
        ssd_entry["mesh_serve_launches"] = n_ssd
        ssd_entry["mesh_train_launches"] = n_ssd_train
        check(n_fa > 0, "the flash kernel was never launched on the mesh train step's path")
        check(n_serve > 0, "the flash kernel was never launched on the sharded prefill's path")
        check(n_ssd > 0, "the SSD kernel was never launched on the sharded Mamba-2 prefill's path")
        check(n_ssd_train > 0, "the SSD kernel was never launched on the sharded Mamba-2 train step's path")

    with timed_phase("roofline", seconds):
        roofline_phase(card, counted, mesh_serve)

    print(f"phase seconds: {json.dumps(seconds)}")
    print(card)
    print(json.dumps({"kernels": [dq_entry, fa_entry, lstm_entry, ssd_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
