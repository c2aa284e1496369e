"""Multi-pod dry-run entry point (port of ``repro.launch.dryrun``).

Counts every (architecture × input shape) cell for the single-pod 16×16
mesh and the 2×16×16 multi-pod mesh on one rank's ``meta`` step
(``launch/dryrun_lib.py``): memory a rank, FLOPs, HBM bytes, collective
bytes and the roofline terms on the card's ceilings.  It needs no card, no
process group and no ``XLA_FLAGS``.  Results go to stdout as JSON unless
``--out`` names a file, which then also serves as the cache of ``--all``
(a cell found there ``ok`` or ``skipped`` is not counted again); one line
a cell goes to stderr.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch.json
"""
import argparse
import dataclasses
import json
import os
import sys


def main(argv=None) -> int:
    from repro_torch.configs import LM_SHAPES, list_archs
    from repro_torch.configs.perf import BASELINE, PerfConfig
    from repro_torch.launch.dryrun_lib import lower_cell, run_cells

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch × shape) cell")
    ap.add_argument("--out", default=None, help="JSON file (and --all's cache); stdout if omitted")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--perf", default=None, help="JSON dict of PerfConfig overrides")
    args = ap.parse_args(argv)

    perf = BASELINE
    if args.perf:
        perf = PerfConfig(**{**dataclasses.asdict(BASELINE), **json.loads(args.perf)})

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    if args.all:
        cells = [
            (a, s.name, m)
            for m in meshes
            for a in list_archs()
            for s in LM_SHAPES
        ]
        results = run_cells(cells, args.out, perf=perf, tag=args.tag)
        if not args.out:
            json.dump({"|".join((r.arch, r.shape, "multi" if m else "single", args.tag)): r.to_json()
                       for (_, _, m), r in zip(cells, results)}, sys.stdout, indent=1)
            print()
        bad = [r for r in results if r.status == "error"]
        print(f"\n{len(results)} cells: {len(bad)} errors", file=sys.stderr)
        return 1 if bad else 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required unless --all")
    rc = 0
    out = []
    for m in meshes:
        res = lower_cell(args.arch, args.shape, multi_pod=m, perf=perf)
        out.append(res.to_json())
        rc |= res.status == "error"
    text = json.dumps(out[0] if len(out) == 1 else out, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return rc


if __name__ == "__main__":
    sys.exit(main())
