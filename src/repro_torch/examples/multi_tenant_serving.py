"""Multi-tenant duty-cycling LIVE: two reduced models share one card under
a memory budget, with per-model break-even (ski-rental) eviction — the
accelerator version of Temporal Accelerators (paper rel. [5]); port of the
JAX package's ``examples/multi_tenant_serving.py``.

The JAX package's example asserts that the roomy budget pays exactly two
bring-ups.  That holds while each tenant's break-even timeout (its
configuration energy over its idle power) outlasts the other tenant's
bring-up and request, which its bring-up's re-jit (about 1.5 s for a
reduced model on a CPU) makes true.  The reduced models' bring-up here
takes milliseconds, so a tenant may be released by its timeout between
its requests; the example then asserts that every extra bring-up followed
such a release (no evictions: the budget forced none).  At full width the
timeouts are tens of seconds and the count is exactly two.

Run:  python -m repro_torch.examples.multi_tenant_serving              (card)
      python -m repro_torch.examples.multi_tenant_serving --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import bring_up_from_checkpoint
from repro_torch.serving.multi_tenant import MultiTenantScheduler, Tenant

ARCHS = ("qwen3-1.7b", "yi-6b")
N_REQUESTS = 6


def live_tenant(
    cfg: ArchConfig,
    manager: CheckpointManager,
    hbm_gb: float,
    device,
) -> Tenant:
    """A tenant that brings ``cfg`` up from ``manager``'s checkpoint onto
    ``device`` and answers a request (``None``: a fresh random prompt of 16
    tokens, from seed 0) with 4 greedy tokens."""
    rng = np.random.default_rng(0)

    def prompt():
        tokens = rng.integers(0, cfg.vocab_size, (1, 16))
        return {"tokens": torch.as_tensor(tokens, dtype=torch.int32, device=device)}

    return Tenant(
        name=cfg.name,
        bring_up=lambda: bring_up_from_checkpoint(
            cfg, manager, max_len=32, warmup_batch=prompt(), device=device
        ),
        infer=lambda eng, x: eng.generate(x if x is not None else prompt(), n_new=4),
        release=lambda eng: eng.release(),
        hbm_gb=hbm_gb,
        config_mw=90_000.0, infer_mw=200_000.0, idle_mw=65_000.0,
    )


def _log_releases(tenants: list[Tenant], log: list[str]) -> None:
    for t in tenants:
        def release(handle, inner=t.release, name=t.name):
            log.append(name)
            inner(handle)

        t.release = release


def serve_alternating(
    make_tenants: Callable[[], list[Tenant]], tight_gb: float, roomy_gb: float,
    clock: Callable[[], float] = time.perf_counter,
) -> tuple[dict, dict, int]:
    """Alternate ``N_REQUESTS`` between two tenants under a budget that fits
    one at a time, then (fresh tenants) under one that fits both; print both
    summaries and assert that eviction pays reconfiguration exactly when the
    budget forces it.  Returns both summaries and the roomy run's releases
    by break-even timeout."""
    tenants = make_tenants()
    # budget fits only ONE model at a time → every switch pays bring-up
    tight = MultiTenantScheduler(tenants, hbm_budget_gb=tight_gb, clock=clock)
    for i in range(N_REQUESTS):
        tight.submit(tenants[i % 2].name, None)
    s1 = tight.summary()
    print(f"tight budget ({tight_gb:g} GB):  configs={s1['configurations']} "
          f"evictions={s1['evictions']} energy={s1['energy_mj']:.0f} mJ")
    for t in tenants:                      # hand the card back before the next run
        if t.handle is not None:
            t.release(t.handle)
            t.handle = None

    tenants2 = make_tenants()
    released: list[str] = []
    _log_releases(tenants2, released)
    roomy = MultiTenantScheduler(tenants2, hbm_budget_gb=roomy_gb, clock=clock)
    for i in range(N_REQUESTS):
        roomy.submit(tenants2[i % 2].name, None)
    s2 = roomy.summary()
    timeouts = len(released)        # no evictions: every release was a timeout
    print(f"roomy budget ({roomy_gb:g} GB):  configs={s2['configurations']} "
          f"evictions={s2['evictions']} energy={s2['energy_mj']:.0f} mJ "
          f"(break-even releases {timeouts})")
    for t in tenants2:
        if t.handle is not None:
            t.release(t.handle)
            t.handle = None
    assert s1["evictions"] > 0 and s2["evictions"] == 0
    assert s2["configurations"] == 2 + timeouts
    print("✓ eviction pays reconfiguration exactly when the budget forces it")
    return s1, s2, timeouts


def main(argv: list[str] | None = None) -> tuple[dict, dict, int]:
    """Reduced qwen3-1.7b and yi-6b, ``zstd`` checkpoints of random weights
    (seed 0), 10 GB each against budgets of 12 GB and 24 GB."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="repro-torch-multi-tenant-") as root:
        managers = {}
        for arch in ARCHS:
            cfg = get_config(arch, reduced=True)
            managers[arch] = (cfg, CheckpointManager(f"{root}/{arch}", mode="zstd"))
            managers[arch][1].save(0, zoo.init_params(cfg, torch.Generator(device).manual_seed(0)))

        def make_tenants():
            return [live_tenant(cfg, m, 10.0, device) for cfg, m in managers.values()]

        return serve_alternating(make_tenants, tight_gb=12.0, roomy_gb=24.0)


if __name__ == "__main__":
    main()
