"""End-to-end driver: serve a small model with batched requests under the
paper's duty-cycle strategies — LIVE, on the card (port of the JAX
package's ``examples/duty_cycle_serving.py``).

bring_up  = restore a zstd+int8-compressed checkpoint onto the device +
            one warm-up generation (the 'configuration phase')
infer     = prefill + 8-token batched generation (the 'workload item')
release   = drop all device buffers (the 'power-off')

The controller measures each phase, computes the analytical cross point
from its OWN measurements, and the 'auto' strategy becomes the paper's
configuration-aware policy.  Energy ratios between strategies are
wall-clock-based and power-model independent.

The paper's ordering depends on which side of the crossover the period
lies, and the crossover on the measured configuration phase.  The JAX
package's bring-up re-jits its functions (about 1.5 s for the reduced
model on a CPU, a measured crossover near 1.8 s), so its 0.5 s period lies
below its crossover, and its example asserts that
Idle-Waiting wins and ``auto`` stays resident.  Here nothing is compiled:
the reduced model's bring-up takes milliseconds and its crossover is tens
of ms, so at 0.5 s the paper's rule says On-Off wins and ``auto`` releases
in every gap.  The example asserts the side that the measured phase
times give; below the crossover those are the reference's asserts.

The side and the energies it compares come from the same measured phases:
the median configuration and inference times over the On-Off and
Idle-Waiting runs' records (:func:`shared_phases`) give the crossover, and
each run's ledger is compared with its configuration and inference phases
charged at those medians and its idle phases as it measured them
(:func:`shared_energy_mj`).  A load spike in one phase of one run then
moves neither the side nor one energy alone.

Run:  python -m repro_torch.examples.duty_cycle_serving              (card)
      python -m repro_torch.examples.duty_cycle_serving --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import tempfile

from repro_torch.core import adaptive, energy_model as em
from repro_torch.core.duty_cycle import DutyCycleController
from repro_torch.core.phases import CONFIGURATION, INFERENCE
from repro_torch.launch.serve import build_demo
from repro_torch.serving.scheduler import run_schedule

ARCH = "qwen3-1.7b"
N_REQ = 8
PERIOD_S = 0.5


def run(strategy: str, period_s: float, device="cuda", ckpt_dir: str | None = None):
    controller, make_request = build_demo(
        ARCH, strategy=strategy, device=device, ckpt_dir=ckpt_dir
    )
    res = run_schedule(
        controller, (make_request() for _ in range(N_REQ)), period_s=period_s
    )
    print(
        f"  {strategy:12s}: {res.n_requests} requests, "
        f"{res.n_configurations} configurations, energy {res.energy_mj:9.1f} mJ"
        + (f", measured crossover {res.crossover_ms:.0f} ms" if res.crossover_ms else "")
    )
    return res, controller


def shared_phases(*controllers: DutyCycleController) -> tuple[float, float]:
    """(configuration s, inference s): the medians over every record of
    the given runs (one phase's outlier does not move them)."""
    def median(phase):
        return statistics.median(r.wall_s for c in controllers for r in c.records if r.name == phase)

    return median(CONFIGURATION), median(INFERENCE)


def median_crossover_ms(*controllers: DutyCycleController) -> float:
    """The crossover of :func:`shared_phases` of the given runs, at the
    first run's powers."""
    config_s, infer_s = shared_phases(*controllers)
    p = controllers[0].power
    item = adaptive.measured_workload_item(
        "measured", p.config_mw, config_s, p.infer_mw, infer_s, p.idle_mw,
    )
    return em.crossover_period_ms(item)


def shared_energy_mj(controller: DutyCycleController, config_s: float, infer_s: float) -> float:
    """The run's energy ledger with every configuration and inference phase
    charged at ``config_s`` / ``infer_s`` and every other phase (idle, off)
    as the run measured it."""
    p = controller.power
    at = {CONFIGURATION: (p.config_mw, config_s), INFERENCE: (p.infer_mw, infer_s)}
    return sum(at[r.name][0] * at[r.name][1] if r.name in at else p.energy_mj(r)
               for r in controller.records)


def shared_results(runs: dict) -> tuple[float, object, object]:
    """(crossover ms, On-Off result, Idle-Waiting result) from the same
    measured phases: ``runs`` maps ``on_off`` and ``idle_waiting`` to
    (``ScheduleResult``, controller); each result comes back with
    ``energy_mj`` = :func:`shared_energy_mj` of its run."""
    ctls = [runs[k][1] for k in ("on_off", "idle_waiting")]
    cross = median_crossover_ms(*ctls)
    config_s, infer_s = shared_phases(*ctls)
    oo, iw = (dataclasses.replace(runs[k][0], energy_mj=shared_energy_mj(runs[k][1], config_s, infer_s))
              for k in ("on_off", "idle_waiting"))
    return cross, oo, iw


def check_ordering(period_s: float, crossover_ms: float, oo, iw, auto) -> str:
    """Assert the paper's ordering on the side of ``crossover_ms`` where
    ``period_s`` lies; returns that side."""
    if period_s * 1000.0 < crossover_ms:
        assert iw.energy_mj < oo.energy_mj, "Idle-Waiting must win below the crossover"
        # 'auto' should have converged to idle-waiting (few configurations)
        assert auto.n_configurations <= 2
        return "below"
    assert oo.energy_mj < iw.energy_mj, "On-Off must win above the crossover"
    # 'auto' releases once a gap outlasts its break-even timeout
    assert auto.n_configurations > 2
    return "above"


def main(argv: list[str] | None = None) -> dict:
    """Serve ``N_REQ`` requests at ``PERIOD_S`` under On-Off, Idle-Waiting
    and auto, print each and assert the paper's ordering; returns the three
    ``ScheduleResult``s by strategy."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"== duty-cycle serving of {ARCH} (reduced), period = {PERIOD_S} s ==")
    with tempfile.TemporaryDirectory(prefix="repro-torch-duty-cycle-") as ckpt_dir:
        runs = {s: run(s, PERIOD_S, args.device, ckpt_dir)
                for s in ("on_off", "idle_waiting", "auto")}
    oo, iw, auto = (runs[s][0] for s in ("on_off", "idle_waiting", "auto"))
    cross, oo_shared, iw_shared = shared_results(runs)
    print(f"  energy ratio On-Off / Idle-Waiting: {oo.energy_mj / iw.energy_mj:.2f}× live, "
          f"{oo_shared.energy_mj / iw_shared.energy_mj:.2f}× at the shared median phases")
    side = check_ordering(PERIOD_S, cross, oo_shared, iw_shared, auto)
    print(f"  ✓ live measurements agree with the paper's strategy ordering "
          f"({PERIOD_S} s is {side} the median measured crossover, {cross:.0f} ms)")
    return {"on_off": oo, "idle_waiting": iw, "auto": auto, "crossover_ms": cross,
            "side": side}


if __name__ == "__main__":
    main()
