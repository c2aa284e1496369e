"""Phase-resolved observability, ported so far: the energy ledger
(:mod:`repro_torch.obs.ledger`).  Traces, metrics and reports come with
the observability slice (ROADMAP A8).

>>> from repro_torch.obs import EnergyLedger
>>> led = EnergyLedger.from_axes(configure=11.5, compute=2.25, idle=1.0)
>>> led.total_mj
14.75
>>> led.assert_conserves(14.75)
0.0
"""
from repro_torch.obs.ledger import AXES, PHASE_TO_AXIS, EnergyLedger, axis_of_phase

__all__ = ["AXES", "PHASE_TO_AXIS", "EnergyLedger", "axis_of_phase"]
