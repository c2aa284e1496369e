"""Per-model request-cost CLI — the model zoo priced for the simulator
(port of ``repro.launch.costs``).

Emits ``BENCH_costs.json``:

    costs        per (model × batch) roofline-calibrated request costs:
                 FLOPs/bytes, latency, energy, config phase, crossover period
    fleet        a heterogeneous model mix (≥3 real architectures) through
                 ``fleet.run_periodic`` AND the MC ensemble with per-device
                 traffic periods — the end-to-end acceptance path
    calibration  the port's own four kernels (``kernels/*/ops.py``: the CUDA
                 kernels on the card, their plain versions on the CPU) timed
                 at the reference's pinned benchmark shapes, against the
                 least time the card could take for their work
                 (``calibration_counts`` on the card's ceilings) →
                 achieved-efficiency fractions, unclipped
    golden       the zero-calibration limit: the paper LSTM's request cost is
                 the measured Table-2 item, reproducing 499.06 ms / 12.39×

Usage::

    PYTHONPATH=src python -m repro_torch.launch.costs --smoke
    PYTHONPATH=src python -m repro_torch.launch.costs --models mixtral-8x7b,qwen3-32b \
        --batches 1,4,16 --profile tpu-v5e-like
    PYTHONPATH=src python -m repro_torch.launch.costs --no-kernels --out -

Runs on the card (``--device cuda``, the default; raises on a host without
one); ``--device cpu`` runs the same program on the host, where the
calibration section times the plain versions and says ``"device": "cpu"``.
"""
from __future__ import annotations

import sys
import time

from repro_torch.launch._cli import Timer, emit, finish_payload, make_parser, parse_axis

#: The default heterogeneous mix: datacenter MoE + edge SSM + small dense.
DEFAULT_FLEET_MODELS = "mixtral-8x7b,mamba2-370m:2,qwen3-1.7b"

#: The card's ceilings the calibration divides by: HBM3 bandwidth and the
#: dense peaks by operation type (bf16 tensor cores, fp32) of the NVIDIA
#: H100 SXM (its spec sheet; the constants ``chip_smoke.py`` bounds every
#: kernel with).
H100_HBM_BW = 3.35e12                                      # B/s
H100_PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}     # operations/s

#: The reference's pinned kernel-benchmark shapes
#: (``benchmarks/bench_kernels.py::KERNEL_SHAPES``), keyed by the port's
#: kernel names; ``replaces`` names the reference's row.
KERNEL_SHAPES: dict[str, dict] = {
    "flash_attention": dict(batch=1, seq=1024, heads=8, kv_heads=2, head_dim=64),
    "ssd": dict(batch=1, seq=2048, heads=8, head_dim=64, groups=1, state=64),
    "lstm": dict(batch=1, seq=64, input_dim=6, hidden=20),
    "dequant": dict(rows=1024, cols=4096),
}
_REPLACES = {"flash_attention": "flash_attention_xla", "ssd": "ssd_chunked_xla",
             "lstm": "lstm_xla", "dequant": "dequant_int8_xla"}


def parse_models(spec: str) -> list[tuple[str, int]]:
    """'a,b:2,c' → [(a,1), (b,2), (c,1)] — names with optional replicas."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, _, reps = tok.partition(":")
        out.append((name, int(reps) if reps else 1))
    if not out:
        raise SystemExit(f"--models parsed to nothing: {spec!r}")
    return out


def _section_costs(args) -> dict:
    from repro_torch.costs import model_names, model_request_cost

    models = ([m for m, _ in parse_models(args.models)] if args.models
              else model_names())
    batches = [int(b) for b in parse_axis(args.batches)]
    records = []
    with Timer() as t:
        for m in models:
            for b in batches:
                rc = model_request_cost(
                    m, batch=b, prefill_len=args.prefill, decode_len=args.decode,
                    profile=args.profile, efficiency=args.efficiency,
                )
                records.append(rc.to_dict())
    return {
        "prefill_len": args.prefill,
        "decode_len": args.decode,
        "efficiency": args.efficiency,
        "records": records,
        "throughput": {
            "points": len(records),
            "elapsed_s": round(t.elapsed_s, 6),
            "pts_per_s": round(len(records) / t.elapsed_s, 1)
            if t.elapsed_s > 0 else None,
        },
    }


def _section_fleet(args) -> dict:
    """The acceptance path: a ≥3-model mix end-to-end through the periodic
    kernel and the MC ensemble, each device at its own model's period."""
    import numpy as np

    from repro_torch.core.arrivals import JitteredArrivals
    from repro_torch.costs import model_mix_fleet
    from repro_torch.device import synchronize
    from repro_torch.fleet import fleet_summary, run_periodic
    from repro_torch.fleet.step import _np
    from repro_torch.mc import ci_dict, run_periodic_ensemble

    mix = parse_models(args.fleet_models)
    params = model_mix_fleet(
        mix,
        n_devices=args.devices,
        device=args.device,
        e_budget_mj=args.budget_j * 1000.0,
        utilization=args.utilization,
        prefill_len=args.prefill,
        decode_len=args.decode,
        efficiency=args.efficiency,
    )
    n_steps = args.fleet_steps
    run_periodic(params, n_steps)                       # warm-up: capture once
    synchronize(params.device)
    with Timer() as t:
        res = run_periodic(params, n_steps)
        synchronize(params.device)
    summary = fleet_summary(res)

    period = _np(params.period_ms)
    process = JitteredArrivals(float(period.mean()), args.jitter)
    with Timer() as t_ens:
        ens = run_periodic_ensemble(
            params, process, n_steps, args.n_seeds, seed=args.seed,
            scale_to_device_periods=True,
        )
    return {
        "models": [{"name": m, "replicas": r} for m, r in mix],
        "devices": params.n_devices,
        "n_steps": n_steps,
        "period_ms_range": [float(np.min(period)), float(np.max(period))],
        "summary": summary,
        "throughput": {
            "elapsed_s": round(t.elapsed_s, 6),
            "devices_per_s": round(params.n_devices / t.elapsed_s, 1)
            if t.elapsed_s > 0 else None,
        },
        "ensemble": {
            "process": process.name,
            "jitter": args.jitter,
            "n_seeds": ens.n_seeds,
            "scale_to_device_periods": True,
            "total_items": ci_dict(ens.total_items),
            "lifetime_ms": ci_dict(ens.lifetime_ms),
            "energy_per_request_mj": ci_dict(ens.energy_per_request_mj),
            "throughput": {
                "elapsed_s": round(t_ens.elapsed_s, 6),
                "seeds_per_s": round(ens.n_seeds / t_ens.elapsed_s, 1)
                if t_ens.elapsed_s > 0 else None,
            },
        },
    }


def _calibration_args(name: str, device, dtype=None) -> tuple:
    """The inputs of one of the port's kernels at its pinned shape, drawn on
    ``device`` from seed 0 — the reference benchmark's recipe (bf16
    attention and SSD, fp32 LSTM with 0.3-scaled weights, a blocked-int8
    quantized normal matrix).  ``dtype`` overrides the attention's and the
    SSD's x, B and C dtype."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.dequant import ops as dq

    gen = torch.Generator(device).manual_seed(0)
    s = KERNEL_SHAPES[name]

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    lo = dtype or torch.bfloat16
    if name == "flash_attention":
        b, n, h, kvh, d = s["batch"], s["seq"], s["heads"], s["kv_heads"], s["head_dim"]
        return randn(b, n, h, d, dtype=lo), randn(b, n, kvh, d, dtype=lo), randn(b, n, kvh, d, dtype=lo)
    if name == "ssd":
        b, n, h, p, g, st = s["batch"], s["seq"], s["heads"], s["head_dim"], s["groups"], s["state"]
        return (randn(b, n, h, p, dtype=lo), F.softplus(randn(b, n, h)), -torch.exp(randn(h)),
                randn(b, n, g, st, dtype=lo), randn(b, n, g, st, dtype=lo), randn(h))
    if name == "lstm":
        b, n, i, hd = s["batch"], s["seq"], s["input_dim"], s["hidden"]
        return (randn(b, n, i), randn(i, 4 * hd) * 0.3, randn(hd, 4 * hd) * 0.3,
                torch.zeros(4 * hd, device=device))
    if name == "dequant":
        return dq.quantize_blocked(randn(s["rows"], s["cols"]))
    raise KeyError(f"unknown kernel {name!r}; known: {sorted(KERNEL_SHAPES)}")


def calibration_inputs(name: str, device):
    """``(kernel, plain)`` calls of one of the port's kernels at its pinned
    shape on :func:`_calibration_args`' inputs.  ``kernel`` goes through the
    op (the CUDA kernel for CUDA tensors, the plain version for CPU ones);
    ``plain`` is the plain PyTorch version on the same inputs."""
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.dequant.ref import dequantize_blocked_reference
    from repro_torch.kernels.flash_attention import ops as attn
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.kernels.lstm import ops as lstm
    from repro_torch.kernels.lstm.ref import lstm_reference
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked

    args = _calibration_args(name, device)
    if name == "flash_attention":
        return (lambda: attn.attention(*args)), (lambda: attention_reference(*args))
    if name == "ssd":
        return (lambda: ssd.ssd(*args)[0]), (lambda: ssd_chunked(*args)[0])
    if name == "lstm":
        return (lambda: lstm.lstm(*args)[0]), (lambda: lstm_reference(*args)[0])
    return (lambda: dq.dequantize(*args)), (lambda: dequantize_blocked_reference(*args))


def _against_float64(got, plain, exact, inputs: str) -> dict:
    """A bf16 kernel against its plain version, relative to the plain
    output's largest value, within twice the plain version's own distance
    from the float64 function ``exact`` (on bf16 outputs that distance is
    about half a bf16 step at the largest values)."""
    scale = float(plain.double().abs().max())
    err = float((got.double() - plain.double()).abs().max())
    own = float((plain.double() - exact).abs().max()) / scale
    return {"inputs": inputs, "max_abs_err": err, "rel_err": err / scale, "limit": 2.0 * own,
            "limit_on": "rel_err",
            "measure": "max |kernel - plain| / max |plain|, limit twice max |plain - float64| / max |plain|",
            "kernel_vs_float64": float((got.double() - exact).abs().max()) / scale,
            "ok": err / scale <= 2.0 * own}


def _ssd_fp32_recipes(device) -> dict:
    """The SSD at the pinned shape on fp32 inputs, on the reference test's
    recipe (B and C scaled by 0.5) with the served model's a = −1, and on
    the benchmark's (unscaled, a = −exp(normal)), each against the
    recurrence in float64 within max(5e-4, twice the plain fp32 version's
    own distance from it): at this shape y reaches ±231, where the plain
    chunked version's fp32 exponentials stray from float64 (ROADMAP
    C-ref-5), so the reference test's 5e-4 holds only where fp32 allows."""
    import torch

    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_recurrent_reference

    out = {}
    for recipe, bc_scale in (("fp32, the test's recipe, a = -1", 0.5),
                             ("fp32, the benchmark's recipe, a = -exp(normal)", 1.0)):
        x, dt, a, bm, cm, d = _calibration_args("ssd", device, torch.float32)
        if bc_scale != 1.0:
            a, bm, cm = -torch.ones_like(a), bm * bc_scale, cm * bc_scale
        args = (x, dt, a, bm, cm, d)
        y, plain = ssd.ssd(*args)[0], ssd_chunked(*args)[0]
        y64 = ssd_recurrent_reference(*(t.double() for t in args))[0]
        err = float((y.double() - y64).abs().max())
        own = float((plain.double() - y64).abs().max())
        limit = max(5e-4, 2.0 * own)
        out[recipe] = {"inputs": recipe, "max_abs_err": err, "limit": limit, "limit_on": "max_abs_err",
                       "measure": "max |kernel - float64|, limit max(5e-4, twice max |plain - float64|)",
                       "plain_vs_float64": own, "kernel_vs_plain": float((y - plain).abs().max()),
                       "max_abs_y": float(y64.abs().max()), "ok": err <= limit}
    return out


def calibration_accuracy(name: str, device) -> dict:
    """One of the port's kernels against its plain version at the pinned
    shape → {check: {max_abs_err, limit, limit_on, measure, ok, ...}}.  On the
    calibration's own inputs: dequant bit for bit, the LSTM within 1e-5
    (the reference tests' limits), flash and the SSD in bf16 by
    :func:`_against_float64`; the SSD also on fp32 inputs
    (:func:`_ssd_fp32_recipes`)."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.kernels.ssd.ref import ssd_recurrent_reference

    kernel, plain = calibration_inputs(name, device)
    got, want = kernel(), plain()
    if name == "dequant":
        err = float((got.float() - want.float()).abs().max())
        return {"bf16": {"inputs": "bf16 out", "max_abs_err": err, "limit": 0.0, "limit_on": "max_abs_err",
                         "measure": "bit for bit", "ok": bool(torch.equal(got, want))}}
    if name == "lstm":
        err = float((got - want).abs().max())
        return {"fp32": {"inputs": "fp32", "max_abs_err": err, "limit": 1e-5, "limit_on": "max_abs_err",
                         "measure": "max |kernel - plain|", "ok": err <= 1e-5}}
    args64 = [t.double() for t in _calibration_args(name, device)]
    if name == "flash_attention":
        return {"bf16": _against_float64(got, want, attention_reference(*args64), "bf16")}
    return {"bf16": _against_float64(got, want, ssd_recurrent_reference(*args64)[0], "bf16"),
            **_ssd_fp32_recipes(device)}


def _time_us(fn, device, reps: int) -> float:
    """Mean microseconds a call: CUDA events around ``reps`` back-to-back
    calls on the card (after one warm-up call), the host clock on the CPU."""
    import torch

    from repro_torch.device import synchronize

    fn()
    synchronize(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def calibration_counts(name: str):
    """What one kernel must do at its pinned shape → (:class:`OpCounts`,
    the dtype of its operations): each input read once and each output
    written once, and the operations of its function — the causal half of
    the attention square, the LSTM's weights read once.  ``costs/counts.py``
    prices models as the reference does (the full square, the LSTM's
    weights re-read every step) and would flatter the kernels here."""
    from repro_torch.costs import OpCounts

    s = KERNEL_SHAPES[name]
    if name == "flash_attention":
        b, n, h, kvh, d = s["batch"], s["seq"], s["heads"], s["kv_heads"], s["head_dim"]
        pairs = n * (n + 1) / 2                                # keys at or before each query
        return OpCounts(4.0 * b * h * d * pairs,              # QKᵀ and PV
                        2.0 * b * n * d * (2 * h + 2 * kvh)), "bfloat16"   # q, k, v in; o out
    if name == "ssd":
        b, n, h, p, g, st = s["batch"], s["seq"], s["heads"], s["head_dim"], s["groups"], s["state"]
        nbytes = (2.0 * (2 * b * n * h * p + 2 * b * n * g * st)    # bf16 x, y, B, C
                  + 4.0 * (b * n * h + 2 * h + b * h * p * st))     # fp32 dt, a, D, final state
        return OpCounts(4.0 * b * n * h * p * st, nbytes), "bfloat16"   # state update, y_t = C_t·h_t
    if name == "lstm":
        b, n, i, hd = s["batch"], s["seq"], s["input_dim"], s["hidden"]
        return OpCounts(8.0 * b * n * hd * (i + hd),          # x_t·W_ih + h·W_hh
                        4.0 * (4 * hd * (i + hd + 1)          # W_ih, W_hh and b once
                               + b * n * (i + hd) + 2 * b * hd)), "float32"  # x in; hs, h, c out
    r, c = s["rows"], s["cols"]
    return OpCounts(float(r * c), r * c * 1.0 + r * (c // 128) * 4.0 + r * c * 2.0), "float32"


def _section_calibration(args) -> dict:
    """The port's own kernels timed at the pinned shapes vs the least time
    the card could take for the same work (:func:`calibration_counts` on
    the card's ceilings) → achieved-efficiency fraction per kernel,
    unclipped (above 1 would mean a count is wrong), with each kernel's
    launches in this section."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels.dequant import ops as dq
    from repro_torch.kernels.flash_attention import ops as attn
    from repro_torch.kernels.lstm import ops as lstm
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.launch._cli import card_name_and_power_limit

    device = resolve_device(args.device)
    modules = {"flash_attention": attn, "ssd": ssd, "lstm": lstm, "dequant": dq}
    reps = 2 if args.smoke else 20
    measured_us, launches = {}, {}
    with Timer() as t:
        for name, mod in modules.items():
            kernel, _ = calibration_inputs(name, device)
            before = mod.launches
            measured_us[name] = _time_us(kernel, device, reps)
            launches[name] = mod.launches - before
    on_card = device.type == "cuda"
    rows = {}
    for name in modules:
        counts, op_dtype = calibration_counts(name)
        t_ops, t_bytes = counts.flops / H100_PEAK_OPS[op_dtype], counts.hbm_bytes / H100_HBM_BW
        bound_us = max(t_ops, t_bytes) * 1e6
        rows[name] = {
            "replaces": _REPLACES[name],
            "us": measured_us[name],
            "shape": dict(KERNEL_SHAPES[name]),
            "flops": counts.flops,
            "op_dtype": op_dtype,
            "hbm_bytes": counts.hbm_bytes,
            "bound_us": bound_us,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "efficiency": bound_us / measured_us[name],
            "launches": launches[name],
        }
    return {
        "note": ("the port's CUDA kernels timed on the card (CUDA events) against the card's "
                 "ceilings" if on_card else
                 "the plain versions timed on the host against the card's ceilings: "
                 "no device efficiency"),
        "device": device.type,
        "card": card_name_and_power_limit() if on_card else None,
        "ceilings": {"hbm_bytes_per_s": H100_HBM_BW, "peak_ops_per_s": dict(H100_PEAK_OPS),
                     "source": "NVIDIA H100 SXM spec sheet"},
        "elapsed_s": round(t.elapsed_s, 6),
        "kernels": rows,
    }


def _section_golden() -> dict:
    """Zero-calibration limit: the paper LSTM's cost IS Table 2."""
    from repro_torch.core import energy_model as em
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.costs import PAPER_LSTM_MODEL, model_request_cost

    rc = model_request_cost(PAPER_LSTM_MODEL)
    item = paper_lstm_item()
    return {
        "model": PAPER_LSTM_MODEL,
        "source": rc.source,
        "item_matches_table2": rc.item == item,
        "crossover_ms": round(
            em.crossover_period_ms(
                item, idle_power_mw=24.0,
                powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ,
            ), 2,
        ),
        "lifetime_ratio_40ms": round(
            em.lifetime_ratio(
                item, 40.0, idle_power_mw=24.0,
                powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ,
            ), 2,
        ),
    }


def main(argv=None) -> int:
    ap = make_parser(
        prog="python -m repro_torch.launch.costs",
        description="Roofline-calibrated per-model request costs (BENCH_costs.json).",
        out_default="BENCH_costs.json",
    )
    ap.add_argument("--models", default=None,
                    help="comma list for the cost table (default: all zoo models)")
    ap.add_argument("--batches", default="1,8", help="batch axis: list or a:b:step")
    ap.add_argument("--prefill", type=int, default=2048)
    ap.add_argument("--decode", type=int, default=128)
    ap.add_argument("--profile", default=None,
                    help="force one accelerator profile (default: per-model)")
    ap.add_argument("--efficiency", type=float, default=None,
                    help="achieved roofline fraction (default 0.5)")
    ap.add_argument("--fleet-models", default=DEFAULT_FLEET_MODELS,
                    help="heterogeneous mix, name[:replicas] comma list")
    ap.add_argument("--devices", type=int, default=64,
                    help="fleet size (mix tiled cyclically)")
    ap.add_argument("--fleet-steps", type=int, default=200,
                    help="request periods per device in the fleet section")
    ap.add_argument("--utilization", type=float, default=0.25,
                    help="per-device busy fraction setting each model's period")
    ap.add_argument("--budget-j", type=float, default=50_000.0,
                    help="per-device energy budget (J)")
    ap.add_argument("--jitter", type=float, default=0.1,
                    help="request-timing jitter in the MC ensemble section")
    ap.add_argument("--n-seeds", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-kernels", dest="kernels", action="store_false",
                    help="skip the measured-kernel calibration section")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: tiny fleet, few seeds, 2-rep kernels")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.efficiency is None:
        from repro_torch.costs import DEFAULT_EFFICIENCY

        args.efficiency = DEFAULT_EFFICIENCY
    if args.smoke:
        args.devices = min(args.devices, 16)
        args.fleet_steps = min(args.fleet_steps, 50)
        args.n_seeds = min(args.n_seeds, 16)

    with Timer() as total:
        payload: dict = {
            "kind": "costs",
            "config": {
                k: getattr(args, k)
                for k in ("models", "batches", "prefill", "decode", "profile",
                          "efficiency", "fleet_models", "devices", "fleet_steps",
                          "utilization", "budget_j", "jitter", "n_seeds", "seed",
                          "kernels", "smoke")
            },
            "costs": _section_costs(args),
            "fleet": _section_fleet(args),
            "golden": _section_golden(),
        }
        if args.kernels:
            payload["calibration"] = _section_calibration(args)

    payload["size"] = payload["costs"]["throughput"]["points"]
    finish_payload(payload, total.elapsed_s)
    emit(payload, None if args.out == "-" else args.out, label="cost table", device=device)
    g = payload["golden"]
    print(
        f"costs: {payload['size']} (model x batch) points | fleet "
        f"{payload['fleet']['devices']} devices x {payload['fleet']['n_steps']} steps "
        f"({len(payload['fleet']['models'])}-model mix) | golden: table2 match="
        f"{g['item_matches_table2']} crossover={g['crossover_ms']} ms "
        f"lifetime={g['lifetime_ratio_40ms']}x"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
