"""Batch design-space sweep CLI (the vectorized engine's front door; port
of ``repro.launch.sweep``).

Evaluates the paper's entire design space — (device × SPI buswidth × SPI
clock × compression × request period × idle-power method × energy budget) —
in one vectorized call (:mod:`repro_torch.core.batch_eval`) on the card and
emits a JSON grid with the reference CLI's keys.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.sweep --kind strategies \
        --periods 10:120:10 --methods baseline,method1+2 --calibrated \
        --out build/sweep.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --kind config --devices both
    PYTHONPATH=src python -m repro_torch.launch.sweep --kind pareto
    PYTHONPATH=src python -m repro_torch.launch.sweep --kind crossover --idle-powers 134.3,34.2,24.0

Runs on the card (``--device cuda``, the default; raises on a host without
one); ``--device cpu`` runs the same program on the host.  Without
``--out`` the JSON goes to stdout.

Kinds:

    config      Exp.-1 configuration-phase grid (time/power/energy)
    strategies  full 7-axis strategy grid (n_max, lifetime, crossover, ...)
    pareto      (energy, time) frontier of the configuration space plus the
                (energy/item, period, lifetime) frontier of the strategy grid
    crossover   T_cross(device, buswidth, clock, compression, P_idle) surface

Axis syntax: comma lists (``--periods 10,20,40``) or ``start:stop:step``
ranges (``--periods 10:120:10``, stop inclusive).
"""
from __future__ import annotations

import sys

from repro_torch.launch._cli import (
    Timer,
    emit,
    finish_payload,
    make_parser,
    parse_axis as _parse_axis,
    powerup_overhead_mj,
    resolve_devices as _resolve_devices,
    resolve_methods as _resolve_methods,
)


def _config_axes(args) -> tuple[tuple, tuple, tuple]:
    """(buswidths, clocks, compression) from CLI args — the one place the
    configuration-space axes are parsed, shared by every --kind."""
    from repro_torch.core.config_phase import (
        COMPRESSION_OPTIONS,
        SPI_BUSWIDTHS,
        SPI_CLOCKS_MHZ,
    )

    buswidths = (
        tuple(int(w) for w in _parse_axis(args.buswidths)) if args.buswidths else SPI_BUSWIDTHS
    )
    clocks = tuple(_parse_axis(args.clocks)) if args.clocks else SPI_CLOCKS_MHZ
    return buswidths, clocks, COMPRESSION_OPTIONS


def build_grid(args) -> "SweepGrid":  # noqa: F821 (forward ref for --help speed)
    from repro_torch.core.batch_eval import SweepGrid

    buswidths, clocks, compression = _config_axes(args)
    return SweepGrid(
        devices=_resolve_devices(args.devices),
        buswidths=buswidths,
        clocks_mhz=clocks,
        compression=compression,
        request_periods_ms=tuple(_parse_axis(args.periods)),
        idle_methods=_resolve_methods(args.methods),
        e_budgets_mj=tuple(b * 1000.0 for b in _parse_axis(args.budgets_j)),
        powerup_overhead_mj=powerup_overhead_mj(args),
    )


def main(argv=None) -> int:
    ap = make_parser(
        prog="python -m repro_torch.launch.sweep",
        description="Vectorized design-space sweeps (JSON grids).",
    )
    ap.add_argument("--kind", choices=["config", "strategies", "pareto", "crossover"],
                    default="strategies")
    ap.add_argument("--devices", default="spartan7-xc7s15",
                    help="comma list of device names, or 'both'")
    ap.add_argument("--buswidths", default=None, help="e.g. 1,2,4 (default: Table 1)")
    ap.add_argument("--clocks", default=None, help="MHz list/range (default: Table 1)")
    ap.add_argument("--periods", default="10:120:10", help="request periods, ms")
    ap.add_argument("--methods", default="baseline,method1,method1+2",
                    help="idle-power methods (Table 3 names)")
    ap.add_argument("--budgets-j", default="4147", help="energy budgets, J")
    ap.add_argument("--idle-powers", default="134.3,34.2,24.0",
                    help="idle powers (mW) for --kind crossover")
    ap.add_argument("--limit", type=int, default=None, help="cap emitted records")
    args = ap.parse_args(argv)

    from repro_torch.core.batch_eval import config_phase_grid, sweep_batch
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.device import resolve_device, synchronize

    device = resolve_device(args.device)
    payload: dict = {"kind": args.kind}
    timer = Timer().__enter__()

    if args.kind == "config":
        devices = _resolve_devices(args.devices)
        buswidths, clocks, compression = _config_axes(args)
        g = config_phase_grid(devices, buswidths, clocks, compression, device=device)
        g = {k: v.cpu().numpy() for k, v in g.items()}
        names = ("device", "buswidth", "clock_mhz", "compression")
        labels = {
            "device": [d.name for d in devices],
            "buswidth": list(buswidths),
            "clock_mhz": list(clocks),
            "compression": [bool(c) for c in compression],
        }
        import numpy as np

        shape = g["config_energy_mj"].shape
        idx = np.indices(shape).reshape(len(shape), -1).T
        records = []
        for ix in map(tuple, idx[: args.limit]):
            rec = {n: labels[n][ix[i]] for i, n in enumerate(names)}
            rec.update({k: float(v[ix]) for k, v in g.items()})
            records.append(rec)
        payload.update({"axes": labels, "size": int(np.prod(shape)), "records": records})

    elif args.kind == "strategies":
        grid = build_grid(args)
        res = sweep_batch(grid, device=device)
        payload.update(res.to_json_dict(args.limit))

    elif args.kind == "pareto":
        from repro_torch.core.pareto import config_pareto, strategy_pareto

        devices = _resolve_devices(args.devices)
        grid = build_grid(args)
        res = sweep_batch(grid, device=device)
        payload.update(
            {
                # both frontiers describe the SAME user-selected design space
                "config_frontier": config_pareto(
                    devices, device=device, buswidths=grid.buswidths, clocks_mhz=grid.clocks_mhz
                ),
                "strategy_frontier": strategy_pareto(res, "iw")[: args.limit],
                "axes": grid.axis_labels(),
            }
        )

    else:  # crossover
        from repro_torch.core.pareto import crossover_surface

        devices = _resolve_devices(args.devices)
        surf = crossover_surface(
            paper_lstm_item(),
            devices,
            _parse_axis(args.idle_powers),
            powerup_overhead_mj=powerup_overhead_mj(args),
            device=device,
        )
        payload.update(
            {"axes": surf["axes"], "crossover_ms": surf["crossover_ms"].tolist()}
        )

    synchronize(device)
    timer.__exit__()
    finish_payload(
        payload, timer.elapsed_s, device=str(device), calibrated=bool(args.calibrated)
    )
    emit(payload, args.out, label=f"{args.kind} grid", device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
