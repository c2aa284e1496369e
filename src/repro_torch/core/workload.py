"""YAML workload / workload-item descriptions (paper §5.1); a copy of
``repro.core.workload`` for the port.  PyYAML is imported only by the
YAML round-trip (:func:`dumps`, :func:`loads`), so the rest of the module
imports without it.

The paper's simulator consumes two descriptions:

1. **workload**: the energy budget (J) and the constant request period (ms);
2. **workload item**: each phase's average power (mW) and duration (ms).

We reproduce that interface so extensive experiments are YAML-driven, and
extend it with optional strategy/power-method fields.

Example::

    workload:
      energy_budget_j: 4147
      request_period_ms: 40.0
    item:
      name: lstm_accelerator_h20
      idle_power_mw: 134.3
      phases:
        - {name: configuration,   power_mw: 327.9, time_ms: 36.145}
        - {name: data_loading,    power_mw: 138.7, time_ms: 0.0100}
        - {name: inference,       power_mw: 171.4, time_ms: 0.0281}
        - {name: data_offloading, power_mw: 144.1, time_ms: 0.0020}
    strategy:
      kind: idle_waiting          # or on_off
      method: baseline            # baseline | method1 | method1+2
      powerup_overhead_mj: 0.12375

An item may instead name a cost-zoo model (`repro_torch.costs`) — the
phases are then the model's roofline-calibrated request cost::

    item:
      model: mixtral-8x7b
      batch: 8
"""
from __future__ import annotations

import dataclasses
import io
from typing import Mapping, Union

from repro_torch.core import energy_model as em
from repro_torch.core.phases import WorkloadItem, paper_lstm_item
from repro_torch.core.strategies import (
    IdlePowerMethod,
    IdleWaitingStrategy,
    OnOffStrategy,
    Strategy,
)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """The paper's 'workload description'."""

    energy_budget_j: float
    request_period_ms: float

    @property
    def energy_budget_mj(self) -> float:
        return self.energy_budget_j * 1000.0

    def to_dict(self) -> dict:
        return {
            "energy_budget_j": self.energy_budget_j,
            "request_period_ms": self.request_period_ms,
        }

    @staticmethod
    def from_dict(d: Mapping) -> "WorkloadSpec":
        return WorkloadSpec(
            energy_budget_j=float(d["energy_budget_j"]),
            request_period_ms=float(d["request_period_ms"]),
        )


PAPER_WORKLOAD = WorkloadSpec(energy_budget_j=4147.0, request_period_ms=40.0)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Workload + item + strategy: one fully-specified simulator run."""

    workload: WorkloadSpec
    item: WorkloadItem
    strategy_kind: str = "idle_waiting"           # "on_off" | "idle_waiting"
    method: IdlePowerMethod = IdlePowerMethod.BASELINE
    powerup_overhead_mj: float = 0.0

    def build_strategy(self) -> Strategy:
        if self.strategy_kind == "on_off":
            return OnOffStrategy(self.item, self.powerup_overhead_mj)
        if self.strategy_kind == "idle_waiting":
            return IdleWaitingStrategy(
                self.item, self.powerup_overhead_mj, method=self.method
            )
        raise ValueError(f"unknown strategy kind {self.strategy_kind!r}")

    def to_dict(self) -> dict:
        return {
            "workload": self.workload.to_dict(),
            "item": self.item.to_dict(),
            "strategy": {
                "kind": self.strategy_kind,
                "method": self.method.value,
                "powerup_overhead_mj": self.powerup_overhead_mj,
            },
        }

    @staticmethod
    def from_dict(d: Mapping) -> "ExperimentSpec":
        strat = d.get("strategy", {})
        return ExperimentSpec(
            workload=WorkloadSpec.from_dict(d["workload"]),
            item=_item_from_dict(d["item"]),
            strategy_kind=str(strat.get("kind", "idle_waiting")),
            method=IdlePowerMethod(strat.get("method", "baseline")),
            powerup_overhead_mj=float(strat.get("powerup_overhead_mj", 0.0)),
        )


def _item_from_dict(d: Mapping) -> WorkloadItem:
    """Item from either explicit phases or a cost-zoo model reference.

    The model form prices the item through :mod:`repro_torch.costs`::

        item:
          model: mixtral-8x7b      # registered arch or the paper LSTM
          batch: 8                 # optional; plus prefill_len, decode_len,
          profile: tpu-v5e-like    # profile, efficiency
    """
    if "model" in d:
        if "phases" in d:
            raise ValueError("item: give either 'model' or 'phases', not both")
        from repro_torch.costs import model_workload_item  # deferred: costs imports core

        kwargs = {k: d[k] for k in
                  ("batch", "prefill_len", "decode_len", "profile", "efficiency")
                  if k in d}
        return model_workload_item(str(d["model"]), **kwargs)
    return WorkloadItem.from_dict(d)


# ---------------------------------------------------------------------------
# YAML round-trip
# ---------------------------------------------------------------------------
def dumps(spec: ExperimentSpec) -> str:
    import yaml

    return yaml.safe_dump(spec.to_dict(), sort_keys=False)


def loads(text: str) -> ExperimentSpec:
    import yaml

    return ExperimentSpec.from_dict(yaml.safe_load(text))


def dump(spec: ExperimentSpec, fp: Union[str, io.IOBase]) -> None:
    if isinstance(fp, str):
        with open(fp, "w") as f:
            f.write(dumps(spec))
    else:
        fp.write(dumps(spec))


def load(fp: Union[str, io.IOBase]) -> ExperimentSpec:
    if isinstance(fp, str):
        with open(fp) as f:
            return loads(f.read())
    return loads(fp.read())


def paper_experiment(
    strategy_kind: str = "idle_waiting",
    request_period_ms: float = 40.0,
    method: IdlePowerMethod = IdlePowerMethod.BASELINE,
    calibrated: bool = True,
) -> ExperimentSpec:
    """The paper's Experiment-2/3 setup (Table 2 item, 4147 J budget)."""
    return ExperimentSpec(
        workload=WorkloadSpec(4147.0, request_period_ms),
        item=paper_lstm_item(),
        strategy_kind=strategy_kind,
        method=method,
        powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ if calibrated else 0.0,
    )
