"""Hierarchical serving control plane: device → rack → region → global
(port of ``repro.control``).

The paper's idle-vs-off rule is *scale-free*: a rack is a "device" one
level up, whose configuration phase is the rack bring-up and whose idle
power is the sum of its children's draws.  This package composes the
routed fleet kernel (:mod:`repro_torch.fleet.step`), the crossover
autoscaler (:mod:`repro_torch.control.autoscaler`), the fault-tolerance
primitives (:mod:`repro_torch.distributed.fault_tolerance`), and the energy
ledger (:mod:`repro_torch.obs.ledger`) into a planet-scale serving
simulation with a differential-testing spine — every level collapses
bit-for-bit onto the layer below (``tests/test_torch_control.py``).  The
racks' fleets run on the card unless the topology is built with
``device="cpu"``, as here.

Walkthrough: one rack powers off at night, the region survives a flash
crowd.  A region with two 4-device racks sees a busy day, a dead-quiet
night, then a flash crowd.  The autoscaler watches each rack's
inter-arrival gap against the *rack-level* crossover (the same closed form
as the device rule, fed the bring-up energy and the summed idle power):

>>> import numpy as np
>>> from repro_torch.control import (CrossoverAutoscaler, run_hierarchy,
...                                  uniform_topology)
>>> topo = uniform_topology(n_regions=1, racks_per_region=2,
...                         devices_per_rack=4, request_period_ms=100.0,
...                         bringup_ms=100.0, bringup_mj=50.0, device="cpu")
>>> day = np.full(64, 4); night = np.zeros(64, int); flash = np.full(32, 12)
>>> counts = np.concatenate([day, night, flash])
>>> res = run_hierarchy(topo, counts, dt_ms=50.0, epoch_ticks=16,
...                     autoscaler_factory=CrossoverAutoscaler.for_rack)

At night the first rack's gap estimate crosses the rack crossover, its
queue drains, and the autoscaler powers it off (the second stays — the
region keeps ``keep_min=1`` serving).  The flash crowd then overwhelms one
rack, and the control plane powers the first back on, paying the bring-up
as a reconfiguration:

>>> res.racks["r0k0"].n_power_offs, res.racks["r0k0"].n_power_ons
(1, 1)
>>> res.racks["r0k1"].n_power_offs
0

Requests are conserved at every level — served + dropped + in-flight is
exactly what arrived — and the hierarchical energy ledger sums to the flat
per-device energy plus the rack bring-up charges within 1e-9:

>>> res.served + res.dropped + res.in_flight == res.arrived == 640
True
>>> sorted(res.assert_conserves())
['global_requests', 'rack_energy', 'rack_requests', 'region_requests', 'total_energy']
"""
from repro_torch.control.autoscaler import (
    CrossoverAutoscaler,
    PolicyAutoscaler,
    rack_break_even_ms,
    rack_crossover_ms,
    rack_idle_power_mw,
    rack_reconfig_energy_mj,
    rack_workload_item,
)
from repro_torch.control.faults import (
    FaultInjector,
    FaultSchedule,
    RackFault,
    SimClock,
    random_schedule,
)
from repro_torch.control.hierarchy import (
    RackSpec,
    RegionSpec,
    TopologySpec,
    concat_params,
    uniform_topology,
)
from repro_torch.control.report import (
    hierarchy_report,
    pareto_section,
    slo_metrics,
    verify_hierarchy,
)
from repro_torch.control.simulate import (
    HierarchyResult,
    RackResult,
    proportional_split,
    run_hierarchy,
    run_rack_periodic,
)

__all__ = [
    "CrossoverAutoscaler",
    "FaultInjector",
    "FaultSchedule",
    "HierarchyResult",
    "PolicyAutoscaler",
    "RackFault",
    "RackResult",
    "RackSpec",
    "RegionSpec",
    "SimClock",
    "TopologySpec",
    "concat_params",
    "hierarchy_report",
    "pareto_section",
    "proportional_split",
    "rack_break_even_ms",
    "rack_crossover_ms",
    "rack_idle_power_mw",
    "rack_reconfig_energy_mj",
    "rack_workload_item",
    "random_schedule",
    "run_hierarchy",
    "run_rack_periodic",
    "slo_metrics",
    "uniform_topology",
    "verify_hierarchy",
]
