#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel of two checkouts on one NVIDIA card.

    python3 flash_ab.py <checkout A> <checkout B>

Both checkouts' kernel libraries are built at once; then each checkout is
timed in a process of its own, in the order A, B, B, A, so that a drift of
the card shows as a difference between one checkout's two runs.  A run
calls ``repro_torch.kernels.flash_attention.ops.attention`` (the wrapper, as
the model calls it) on bf16 causal inputs made from a seed: the served
qwen3 prefill's shape, the reduced qwen3's, and S 2048 at every head dim
the wrapper takes.  A time is the device time of one launch, from 50
launches in one CUDA graph (``chip_smoke.graph_ms``).  Prints the card's
name and power limit, then one line per shape: A's two times, B's two, and
B's mean over A's.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# (B, S, H, KVH, D): the served prefill, the reduced qwen3's, then S 2048
SHAPES = [(2, 32, 16, 8, 128), (2, 32, 4, 2, 16)] + [
    (1, 2048, 16, 8, d) for d in (16, 32, 48, 64, 80, 96, 112, 128)]


def worker(checkout: str, build_only: bool) -> None:
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    from chip_smoke import graph_ms
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import ops as fa

    _lib.library()
    if build_only:
        return
    gen = torch.Generator("cuda").manual_seed(0)
    times = {}
    for (b, s, h, kvh, d) in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
        times[str((b, s, h, kvh, d))] = graph_ms(lambda: fa.attention(q, k, v, causal=True))
    print(json.dumps(times))


def run(args: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, __file__, "--worker", *args],
                          capture_output=True, text=True, timeout=900)


def main(a: str, b: str) -> None:
    builds = [subprocess.Popen([sys.executable, __file__, "--worker", c, "--build-only"])
              for c in (a, b)]
    if any(p.wait(timeout=900) for p in builds):
        sys.exit("a kernel library did not build")
    runs = {a: [], b: []}
    for c in (a, b, b, a):
        out = run([c])
        if out.returncode:
            sys.exit(f"timing {c} failed:\n{out.stderr}")
        runs[c].append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print("(B, S, H, KVH, D) | A ms | B ms | B/A")
    for key in runs[a][0]:
        ta, tb = [r[key] for r in runs[a]], [r[key] for r in runs[b]]
        print(f"{key} | {ta[0]:.5f} {ta[1]:.5f} | {tb[0]:.5f} {tb[1]:.5f} | {sum(tb) / sum(ta):.3f}")


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2], "--build-only" in sys.argv)
    elif len(sys.argv) == 3:
        main(sys.argv[1], sys.argv[2])
    else:
        sys.exit(__doc__)
