"""Routing policies: distribute a global request stream across the fleet
(port of ``repro.fleet.router``).

A router is a **pure function** from (requests this tick, observable fleet
state) to per-device arrival counts — no Python loops over devices and no
host synchronisation, so it runs inside the tick loop and its CUDA graph.
All policies share one shape:

* every *alive* device receives ``base = r // n_alive`` requests;
* the remainder ``r mod n_alive`` goes one request each to the ``rem``
  highest-priority devices (a water-filling approximation of sequential
  dispatch — exact for round-robin, one-request-per-device greedy for the
  stateful policies);
* dead devices receive nothing (their share is dropped at the gate and
  counted by the caller).

Priorities (lower cost = served first):

    round_robin   cost = (device_index − rr_ptr) mod N; the pointer advances
                  by the remainder each tick, so extras rotate fairly.
    least_loaded  cost = queue depth (ties broken by device index, stable).
    power_aware   cost = energy already spent ÷ budget — requests flow to the
                  devices with the most *remaining* energy, equalizing
                  depletion so the fleet's devices-alive curve falls as a
                  cliff instead of a slope.

Ties go to the lower device index: the stateful policies sort with
``torch.argsort(..., stable=True)`` (``topk`` is not stable).
"""
from __future__ import annotations

import torch

__all__ = ["ROUTER_CODES", "route_counts"]

#: Router names → integer codes (fixed when the tick loop is built).
ROUTER_CODES = {"round_robin": 0, "least_loaded": 1, "power_aware": 2}


def route_counts(
    n_requests: torch.Tensor,
    router_code: int,
    alive: torch.Tensor,
    q_len: torch.Tensor,
    energy_mj: torch.Tensor,
    e_budget_mj: torch.Tensor,
    rr_ptr: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``n_requests`` (0-d int tensor) across devices.

    Returns ``(counts, rr_ptr_next)``: int32 ``counts`` sum to
    ``n_requests`` when any device is alive, else to 0 (the caller records
    the rest as dropped).  ``router_code`` is a Python int (one of
    :data:`ROUTER_CODES`): round-robin is sort-free (a rotation), the
    stateful policies pay one stable argsort.
    """
    n = alive.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=alive.device)
    if router_code == ROUTER_CODES["round_robin"]:
        # perm[p] = device served p-th: rr_ptr, rr_ptr+1, … (no sort needed)
        perm = (idx + rr_ptr) % n
    else:
        if router_code == ROUTER_CODES["least_loaded"]:
            cost = q_len
        elif router_code == ROUTER_CODES["power_aware"]:
            cost = torch.div(energy_mj, torch.clamp_min(e_budget_mj, 1e-30))
        else:
            raise ValueError(f"unknown router code {router_code}")
        perm = torch.argsort(cost, stable=True)
    alive_perm = alive[perm]
    # rank among *alive* devices at each permuted position (exclusive scan)
    alive_i = alive_perm.to(torch.int64)
    rank_perm = torch.cumsum(alive_i, dim=0) - alive_i
    n_alive = alive.sum()
    r = n_requests.to(torch.int64)
    base = torch.where(n_alive > 0, torch.div(r, torch.clamp_min(n_alive, 1), rounding_mode="floor"), 0)
    rem = torch.where(n_alive > 0, r - base * n_alive, 0)
    extras_perm = alive_perm & (rank_perm < rem)
    extras = torch.zeros(n, dtype=torch.int32, device=alive.device).scatter_(
        0, perm, extras_perm.to(torch.int32)
    )
    counts = torch.where(alive, base.to(torch.int32) + extras, 0)
    if router_code == ROUTER_CODES["round_robin"]:
        rr_next = ((rr_ptr + rem) % n).to(torch.int32)
    else:
        rr_next = rr_ptr
    return counts, rr_next
