#!/usr/bin/env python3
"""Time the port's kernels in two checkouts on one NVIDIA card.

    python3 kernel_ab.py <checkout A> <checkout B> [flash] [ssd] [lstm]

(all three when none is named).  Both checkouts' kernel libraries are built
at once; then each checkout is timed in a process of its own, in the order
A, B, B, A, so that a drift of the card shows as a difference between one
checkout's two runs.  Every run calls the checkout's wrappers, as the
models call them, on inputs made from a seed:

* flash: ``flash_attention.ops.attention``, bf16, causal, at the served
  qwen3 prefill's shape, the reduced qwen3's, and S 2048 at every head dim
  the wrapper takes;
* ssd: ``ssd.ops.ssd``, bf16 with the init's a = -1, at the served mamba2
  prefill (B 2, S 256) and at S 2048; and its largest fp32 errors against
  the recurrent oracle over the card tests' rows, a = -exp(normal) included;
* lstm: ``lstm.ops.lstm_cuda``, fp32, at the quickstart's B 32 and B 1, and
  the quickstart's single inference (``single_inference_ms``, the median of
  21 after a warm-up, on untrained weights).

A device time is one call's share of 50 calls captured in one CUDA graph
(``chip_smoke.graph_ms``); a call time is the mean over a run of calls
between CUDA events, host enqueue included (``chip_smoke.time_ms``).
Prints the card's name and power limit, then one line per measurement: A's
two values, B's two, and B's mean over A's.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = ("flash", "ssd", "lstm")
# (B, S, H, KVH, D): the served prefill, the reduced qwen3's, then S 2048
FLASH_SHAPES = [(2, 32, 16, 8, 128), (2, 32, 4, 2, 16)] + [
    (1, 2048, 16, 8, d) for d in (16, 32, 48, 64, 80, 96, 112, 128)]
# (B, S, H, P, G, N, chunk): the served prefill, then S 2048
SSD_SHAPES = [(2, 256, 32, 64, 1, 128, 128), (1, 2048, 32, 64, 1, 128, 128)]
# (B, S, H, P, G, N, chunk, a = -1): the reference test's rows and the model's
SSD_ERROR_ROWS = [
    (2, 256, 4, 16, 2, 32, 64, False), (1, 128, 2, 8, 1, 16, 128, False),
    (2, 512, 8, 32, 2, 64, 128, False), (1, 256, 4, 64, 1, 128, 64, False),
    (2, 256, 32, 64, 1, 128, 128, True), (1, 256, 8, 64, 2, 128, 128, True),
    (1, 2048, 32, 64, 1, 128, 128, True),
]


def _flash(out: dict) -> None:
    import torch

    from chip_smoke import graph_ms
    from repro_torch.kernels.flash_attention import ops as fa

    gen = torch.Generator("cuda").manual_seed(0)
    for (b, s, h, kvh, d) in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
        out[f"flash {(b, s, h, kvh, d)} device ms"] = graph_ms(lambda: fa.attention(q, k, v, causal=True))


def _ssd(out: dict) -> None:
    import torch

    from chip_smoke import _bf16, _ssd_inputs, graph_ms, time_ms
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd.ref import ssd_recurrent_reference

    for (b, s, h, p, g, n, q) in SSD_SHAPES:
        args, _ = _ssd_inputs(b, s, h, p, g, n, seed=21, a_minus_one=True)
        bargs = _bf16(args)
        out[f"ssd {(b, s, h, p, g, n)} bf16 device ms"] = graph_ms(lambda: so.ssd(*bargs, chunk=q))
        out[f"ssd {(b, s, h, p, g, n)} bf16 call ms"] = time_ms(lambda: so.ssd(*bargs, chunk=q))
    ey = es = 0.0
    for i, (b, s, h, p, g, n, q, a_one) in enumerate(SSD_ERROR_ROWS):
        args, init = _ssd_inputs(b, s, h, p, g, n, seed=i, a_minus_one=a_one)
        for state in (init, None):
            y, st = so.ssd(*args, chunk=q, init_state=state)
            ry, rst = ssd_recurrent_reference(*args, init_state=state)
            ey = max(ey, float((y - ry).abs().max()))
            es = max(es, float((st - rst).abs().max()))
    out["ssd fp32 largest y error over the card rows"] = ey
    out["ssd fp32 largest state error over the card rows"] = es


def _lstm(out: dict) -> None:
    import torch

    from chip_smoke import _lstm_inputs, graph_ms, time_ms
    from repro_torch.configs import paper_lstm
    from repro_torch.examples import quickstart
    from repro_torch.kernels.lstm import ops as lo
    from repro_torch.models import lstm as lstm_model

    for bsz in (32, 1):
        x, w_ih, w_hh, b, _, _ = _lstm_inputs(bsz, 64, 6, 20, seed=11)
        out[f"lstm B {bsz} device ms"] = graph_ms(lambda: lo.lstm_cuda(x, w_ih, w_hh, b))
        out[f"lstm B {bsz} call ms"] = time_ms(lambda: lo.lstm_cuda(x, w_ih, w_hh, b))
    cfg = paper_lstm.full()
    params = {k: t.to("cuda") for k, t in
              lstm_model.init_params(cfg, torch.Generator().manual_seed(0)).items()}
    x = torch.randn((1, cfg.seq_len, cfg.input_dim), device="cuda")
    with torch.no_grad():
        lstm_model.apply(params, x)
        runs = [quickstart.single_inference_ms(params, x) for _ in range(21)]
    out["lstm single inference ms (median of 21)"] = statistics.median(runs)


def worker(checkout: str, kernels: list[str], build_only: bool) -> None:
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    from repro_torch.kernels import _lib

    _lib.library()
    if build_only:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name in kernels:
        {"flash": _flash, "ssd": _ssd, "lstm": _lstm}[name](out)
    print(json.dumps(out))


def run(args: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, __file__, "--worker", *args],
                          capture_output=True, text=True, timeout=900)


def main(a: str, b: str, kernels: list[str]) -> None:
    builds = [subprocess.Popen([sys.executable, __file__, "--worker", c, "--build-only"])
              for c in (a, b)]
    if any(p.wait(timeout=900) for p in builds):
        sys.exit("a kernel library did not build")
    runs = {a: [], b: []}
    for c in (a, b, b, a):
        out = run([c, *kernels])
        if out.returncode:
            sys.exit(f"timing {c} failed:\n{out.stderr}")
        runs[c].append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print("measurement | A | B | B/A")
    for key in runs[a][0]:
        ta, tb = [r[key] for r in runs[a]], [r[key] for r in runs[b]]
        print(f"{key} | {ta[0]:.5g} {ta[1]:.5g} | {tb[0]:.5g} {tb[1]:.5g} | {sum(tb) / sum(ta):.3f}")


if __name__ == "__main__":
    names = [v for v in sys.argv[1:] if v in KERNELS]
    paths = [v for v in sys.argv[1:] if v not in KERNELS and not v.startswith("--")]
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2], names, "--build-only" in sys.argv)
    elif len(paths) == 2:
        main(paths[0], paths[1], names or list(KERNELS))
    else:
        sys.exit(__doc__)
