"""The port's sharded fleet (``repro_torch.fleet.shard``) against its own
unsharded runners and against the JAX package's sharded runners, on the
CPU: twins of ``tests/test_fleet_sharded.py``.

The contract is **bit-identity**: for any mesh shape, any non-divisible
fleet size and heterogeneous mixes, ``run_periodic_sharded`` and the
sharded ensemble return the bytes the unsharded runners return — padding
masked out of every total — and the per-shard and aggregated ledgers
conserve within 1e-9.

Multi-rank cases run in one spawn of 8 gloo ranks on the CPU
(``multi_rank``, module-scoped), the JAX package's in one subprocess with 8
fake devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, the
``enable_x64`` shim inside its code), started before the spawn and read
after it.  The sharded ensembles are fed the same numpy gaps on both sides
(the two packages' generators differ); their energies agree within 1e-9,
where XLA fuses the idle product into its sums (ROADMAP C-ref-8), and the
counts exactly.  The 1×1 collapse and the pure-Python properties run in
this process, against the JAX package's 1×1 mesh.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.arrivals import JitteredArrivals
from repro_torch.core.phases import paper_lstm_item
from repro_torch.distributed import ranks
from repro_torch.fleet import (
    DeviceSpec,
    FleetParams,
    fleet_mesh,
    run_periodic,
    run_periodic_sharded,
    uniform_fleet,
)
from repro_torch.fleet.shard import (
    pad_fleet,
    parse_mesh_spec,
    run_periodic_ensemble_sharded,
    shard_slices,
)
from repro_torch.mc import periodic_ensemble, run_periodic_ensemble
from repro_torch.obs.ledger import AXES, EnergyLedger
from test_torch_x64_shim import x64_shim

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PERIODIC_FIELDS = ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time")
STRATEGIES = ("idle_waiting", "on_off", "adaptive")
PERIODS = (40.0, 60.0, 90.0)
SWEEP = [(f, s) for f in (1, 2, 4) for s in (1, 2)]
ENS_MESHES = ((2, 1), (1, 2), (2, 2), (4, 2))
ENS_GAPS = (7, 100, 13)          # seeds, steps, devices of the fed-gap ensemble


def mixed_params(n=13, budget_mj=2500.0) -> FleetParams:
    item = paper_lstm_item()
    return FleetParams.from_specs([
        DeviceSpec(item=item, strategy=STRATEGIES[i % 3], request_period_ms=PERIODS[(i // 3) % 3],
                   e_budget_mj=budget_mj, powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ)
        for i in range(n)
    ], device="cpu")


def ens_gaps() -> np.ndarray:
    return np.random.default_rng(11).exponential(40.0, ENS_GAPS)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_periodic_equal(a, b):
    for f in PERIODIC_FIELDS:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)), err_msg=f)


# ---------------------------------------------------------------------------
# The multi-rank side (8 gloo ranks) and the JAX package's (8 fake devices)
# ---------------------------------------------------------------------------
def _ranks_body() -> dict:
    """Every multi-rank case of this file, run by every rank."""
    out = {"sweep": {}, "ens_gaps": {}, "ens_sampled": {}}
    for n in (8, 13):
        params = mixed_params(n)
        for f, s in SWEEP:
            res = run_periodic_sharded(params, 400, mesh=fleet_mesh(f, s))
            if res is not None:
                out["sweep"][n, f, s] = res
    params = uniform_fleet(ENS_GAPS[2], strategies=STRATEGIES, e_budget_mj=800.0, device="cpu")
    for f, s in ENS_MESHES:
        mesh = fleet_mesh(f, s)
        res = periodic_ensemble(params, ens_gaps(), keep_device_samples=True, mesh=mesh)
        if res is not None:
            out["ens_gaps"][f, s] = res
        res = run_periodic_ensemble_sharded(params, JitteredArrivals(40.0, 0.25), 100, 7, mesh=mesh, seed=5)
        if res is not None:
            out["ens_sampled"][f, s] = res
    big = uniform_fleet(4096, strategies=STRATEGIES, e_budget_mj=2500.0, device="cpu")
    out["n4096"] = run_periodic_sharded(big, 250, mesh=fleet_mesh(4, 1))
    out["runtime"] = ranks.info()
    return out


_JAX_CODE = """
import pickle, sys
import numpy as np
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
from repro.core import energy_model as em
from repro.core.phases import paper_lstm_item
from repro.fleet import DeviceSpec, FleetParams, fleet_mesh, run_periodic_sharded, uniform_fleet
from repro.mc import periodic_ensemble

STRATEGIES, PERIODS = {strategies!r}, {periods!r}
def mixed(n, budget=2500.0):
    item = paper_lstm_item()
    return FleetParams.from_specs([
        DeviceSpec(item=item, strategy=STRATEGIES[i % 3], request_period_ms=PERIODS[(i // 3) % 3],
                   e_budget_mj=budget, powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ)
        for i in range(n)])
F = ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time")
out = {{"sweep": {{}}, "ens": {{}}}}
for n in (8, 13):
    p = mixed(n)
    for f, s in {sweep!r}:
        r = run_periodic_sharded(p, 400, mesh=fleet_mesh(f, s))
        out["sweep"][n, f, s] = {{k: np.asarray(getattr(r, k)) for k in F}}
gaps = np.random.default_rng(11).exponential(40.0, {ens_gaps!r})
p = uniform_fleet({ens_gaps!r}[2], strategies=STRATEGIES, e_budget_mj=800.0)
for f, s in {ens_meshes!r}:
    e = periodic_ensemble(p, gaps, keep_device_samples=True, mesh=fleet_mesh(f, s))
    out["ens"][f, s] = {{k: np.asarray(getattr(e, k)) for k in
                        ("per_device_items", "per_device_energy_mj", "per_device_lifetime_ms")}}
big = uniform_fleet(4096, strategies=STRATEGIES, e_budget_mj=2500.0)
r = run_periodic_sharded(big, 250, mesh=fleet_mesh(4, 1))
out["n4096"] = {{k: np.asarray(getattr(r, k)) for k in F}}
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """The port's multi-rank cases (one spawn) and the JAX package's sharded
    runs (one subprocess, running meanwhile)."""
    path = tmp_path_factory.mktemp("jax_sharded") / "out.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC,
               JAX_PLATFORMS="cpu")
    code = _JAX_CODE.format(strategies=STRATEGIES, periods=PERIODS, sweep=SWEEP, ens_gaps=ENS_GAPS,
                            ens_meshes=ENS_MESHES)
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ours = ranks.spawn(8, _ranks_body, device="cpu", timeout_s=240)
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as fh:
        theirs = pickle.load(fh)
    return ours, theirs


@pytest.fixture(scope="module")
def jref():
    """The JAX package's sharded fleet in this process (one CPU device: the
    1×1 mesh), under jax 0.9.0 with the ``enable_x64`` shim."""
    with x64_shim():
        import repro.fleet
        import repro.fleet.shard
        from repro.core import phases

    return dict(fleet=repro.fleet, shard=repro.fleet.shard, phases=phases)


def _jmixed(jref, n, budget_mj=2500.0):
    item = jref["phases"].paper_lstm_item()
    return jref["fleet"].FleetParams.from_specs([
        jref["fleet"].DeviceSpec(item=item, strategy=STRATEGIES[i % 3], request_period_ms=PERIODS[(i // 3) % 3],
                                 e_budget_mj=budget_mj, powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ)
        for i in range(n)
    ])


# ---------------------------------------------------------------------------
# In-process: 1x1 collapse, padding, chunking, error paths
# ---------------------------------------------------------------------------
class TestOneByOneCollapse:
    def test_periodic_bit_identical(self, jref):
        params = mixed_params(9)
        got = run_periodic_sharded(params, 400, mesh=fleet_mesh(1, 1))
        assert_periodic_equal(run_periodic(params, 400), got)
        want = jref["fleet"].run_periodic_sharded(_jmixed(jref, 9), 400, mesh=jref["shard"].fleet_mesh(1, 1))
        assert_periodic_equal(got, want)
        assert got.mesh_shape == want.mesh_shape == (1, 1) and got.runtime["ranks"] == 1

    def test_periodic_n_steps_zero(self):
        params = mixed_params(5)
        assert_periodic_equal(run_periodic(params, 0), run_periodic_sharded(params, 0, mesh=fleet_mesh(1, 1)))

    def test_chunk_boundaries_cannot_perturb(self):
        """Any step_chunk gives the same bytes (the carry is exact)."""
        params = mixed_params(7, budget_mj=500.0)
        ref = run_periodic(params, 300)
        for chunk in (1, 7, 128, 300, 1000):
            assert_periodic_equal(ref, run_periodic_sharded(params, 300, mesh=fleet_mesh(1, 1), step_chunk=chunk))

    def test_early_exit_full_budget_lifetime(self, jref):
        """A horizon far past fleet death early-exits with exact zeros."""
        params = mixed_params(6, budget_mj=200.0)
        ref = run_periodic(params, 4000)
        assert not ref.alive.any(), "test needs a budget the horizon exhausts"
        sh = run_periodic_sharded(params, 4000, mesh=fleet_mesh(1, 1), step_chunk=64)
        assert_periodic_equal(ref, sh)
        assert sh.steps_executed < sh.n_steps and len(sh.alive_over_time) == sh.n_steps
        want = jref["fleet"].run_periodic_sharded(_jmixed(jref, 6, 200.0), 4000,
                                                  mesh=jref["shard"].fleet_mesh(1, 1), step_chunk=64)
        assert_periodic_equal(sh, want)
        assert sh.steps_executed == want.steps_executed

    def test_ensemble_bit_identical(self):
        params = mixed_params(5, budget_mj=800.0)
        proc = JitteredArrivals(40.0, 0.2)
        a = run_periodic_ensemble(params, proc, 120, 7, seed=3)
        b = run_periodic_ensemble_sharded(params, proc, 120, 7, mesh=fleet_mesh(1, 1), seed=3)
        for f in ("total_items", "total_energy_mj", "lifetime_ms"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.device_items.mean, b.device_items.mean)
        np.testing.assert_array_equal(a.device_energy_mj.m2, b.device_energy_mj.m2)
        for ax in AXES:
            np.testing.assert_array_equal(getattr(a.ledger, f"{ax}_mj"), getattr(b.ledger, f"{ax}_mj"), err_msg=ax)

    def test_heterogeneous_model_mix_fleet(self, jref):
        """Cost-zoo model mix (different periods/energies per device)."""
        from repro.costs import model_mix_fleet as jmix

        from repro_torch.costs import model_mix_fleet

        models = ["mixtral-8x7b", "mamba2-370m", "paper-lstm-h20"]
        params = model_mix_fleet(models, n_devices=11, device="cpu", strategy="adaptive", e_budget_mj=5000.0)
        got = run_periodic_sharded(params, 250, mesh=fleet_mesh(1, 1))
        assert_periodic_equal(run_periodic(params, 250), got)
        want = jref["fleet"].run_periodic_sharded(jmix(models, n_devices=11, strategy="adaptive",
                                                       e_budget_mj=5000.0), 250,
                                                  mesh=jref["shard"].fleet_mesh(1, 1))
        assert_periodic_equal(got, want)

    def test_result_feeds_fleet_metrics_unchanged(self):
        """ShardedPeriodicResult is a PeriodicFleetResult: summaries work."""
        from repro_torch.fleet import periodic_summary

        params = mixed_params(9, budget_mj=500.0)
        a = periodic_summary(run_periodic(params, 300))
        b = periodic_summary(run_periodic_sharded(params, 300, mesh=fleet_mesh(1, 1)))
        assert a == b


class TestPadding:
    def test_pad_counts_and_inertness(self, jref):
        params = mixed_params(9)
        padded, pad = pad_fleet(params, 4)
        assert (padded.n_devices, pad) == (12, 3)
        assert not padded.feasible[9:].any() and float(padded.e_budget_mj[9:].sum()) == 0.0
        jpadded, _ = jref["shard"].pad_fleet(_jmixed(jref, 9), 4)
        for f in ("strategy", "is_onoff", "feasible", "period_ms", "e_budget_mj", "e_item_mj", "t_exec_ms"):
            np.testing.assert_array_equal(_np(getattr(padded, f)), np.asarray(getattr(jpadded, f)), err_msg=f)
        # the padded fleet run unsharded equals the original on every real
        # device AND on every fleet-wide total (padding masked out exactly)
        a, b = run_periodic(params, 400), run_periodic(padded, 400)
        np.testing.assert_array_equal(_np(a.n_items), _np(b.n_items)[:9])
        np.testing.assert_array_equal(_np(a.energy_mj), _np(b.energy_mj)[:9])
        np.testing.assert_array_equal(_np(a.alive_over_time), _np(b.alive_over_time))
        assert int(b.n_items[9:].sum()) == 0 and float(b.energy_mj[9:].sum()) == 0.0

    def test_pad_noop_when_divisible(self):
        params = mixed_params(8)
        padded, pad = pad_fleet(params, 4)
        assert pad == 0 and padded is params

    def test_shard_slices_cover_real_devices_once(self, jref):
        for n, k in [(9, 4), (13, 8), (4, 4), (3, 8)]:
            sls = shard_slices(n, k)
            assert sls == jref["shard"].shard_slices(n, k) and len(sls) == k
            idx = np.concatenate([np.arange(s.start, s.stop) for s in sls])
            np.testing.assert_array_equal(idx, np.arange(n))

    def test_pad_rejects_bad_multiple(self):
        with pytest.raises(ValueError, match="multiple"):
            pad_fleet(mixed_params(3), 0)


class TestMeshSpec:
    def test_parse(self, jref):
        for spec in ("4", "2x2", " 8X1 "):
            assert parse_mesh_spec(spec) == jref["shard"].parse_mesh_spec(spec)
        assert parse_mesh_spec("auto") == (1, 1)  # a host with no card

    @pytest.mark.parametrize("bad", ["", "x", "2x2x2", "axb", "-"])
    def test_parse_rejects(self, bad):
        with pytest.raises(ValueError, match="mesh spec"):
            parse_mesh_spec(bad)

    def test_mesh_too_large_names_the_fix(self):
        with pytest.raises(ValueError, match=r"ranks\.spawn\(128"):
            fleet_mesh(64, 2)

    def test_overflow_guard(self):
        with pytest.raises(OverflowError, match="int32"):
            run_periodic_sharded(mixed_params(3), 2**31, mesh=fleet_mesh(1, 1))


class TestLedgerConservation:
    def test_per_shard_and_aggregate(self):
        """Conservation holds per shard slice and after aggregation."""
        params = mixed_params(13, budget_mj=500.0)
        res = run_periodic_sharded(params, 600, mesh=fleet_mesh(1, 1))
        led = res.ledger()
        energy = _np(res.energy_mj)
        led.assert_conserves(energy)
        for k in (2, 4, 8):
            shard_sum = None
            for sl in shard_slices(params.n_devices, k):
                sub = EnergyLedger(**{f"{ax}_mj": np.asarray(getattr(led, f"{ax}_mj"))[sl] for ax in AXES})
                if energy[sl].size:
                    sub.assert_conserves(energy[sl])
                agg = sub.aggregate()
                shard_sum = agg if shard_sum is None else shard_sum + agg
            shard_sum.assert_conserves(float(energy.sum()))


# ---------------------------------------------------------------------------
# Multi-rank: 8 gloo ranks, against the unsharded runners and the JAX
# package's sharded runners on 8 fake devices
# ---------------------------------------------------------------------------
def test_mesh_sweep_differential_multidevice(multi_rank):
    """Sharded ≡ unsharded ≡ the JAX package's sharded, across mesh shapes
    {1,2,4}×{1,2} on non-divisible heterogeneous fleets, with per-shard
    and aggregated ledger conservation."""
    ours, theirs = multi_rank
    assert ours["runtime"] == {"ranks": 8, "backend": "gloo", "staged": "host", "ranks_per_card": None,
                               "spawn_s": ours["runtime"]["spawn_s"]}
    for n in (8, 13):
        ref = run_periodic(mixed_params(n), 400)
        for f, s in SWEEP:
            res = ours["sweep"][n, f, s]
            assert res.mesh_shape == (f, s) and res.n_shards == f * s
            assert res.n_padding == (-n) % (f * s)
            assert_periodic_equal(ref, res)
            for k in PERIODIC_FIELDS:
                np.testing.assert_array_equal(_np(getattr(res, k)), theirs["sweep"][n, f, s][k],
                                              err_msg=f"N={n} mesh={f}x{s} {k}")
            led = res.ledger()
            energy = _np(res.energy_mj)
            led.assert_conserves(energy)
            for sl in shard_slices(n, res.n_shards):
                if energy[sl].size:
                    EnergyLedger(**{f"{ax}_mj": np.asarray(getattr(led, f"{ax}_mj"))[sl]
                                    for ax in AXES}).assert_conserves(energy[sl])
            led.aggregate().assert_conserves(float(energy.sum()))


def test_ensemble_sharded_multidevice(multi_rank):
    """Seed+device sharded ensemble ≡ unsharded, incl. Welford moments and
    the per-seed ledger, across mesh shapes (non-divisible axes); on the
    same gaps ≡ the JAX package's sharded ensemble (energies within 1e-9,
    ROADMAP C-ref-8)."""
    ours, theirs = multi_rank
    params = uniform_fleet(ENS_GAPS[2], strategies=STRATEGIES, e_budget_mj=800.0, device="cpu")
    fed = periodic_ensemble(params, ens_gaps(), keep_device_samples=True)
    proc = JitteredArrivals(40.0, 0.25)
    sampled = run_periodic_ensemble(params, proc, 100, 7, seed=5)
    for f, s in ENS_MESHES:
        for ref, e in ((fed, ours["ens_gaps"][f, s]), (sampled, ours["ens_sampled"][f, s])):
            for k in ("total_items", "total_energy_mj", "lifetime_ms"):
                np.testing.assert_array_equal(getattr(ref, k), getattr(e, k), err_msg=f"{f}x{s} {k}")
            np.testing.assert_array_equal(ref.device_items.mean, e.device_items.mean)
            np.testing.assert_array_equal(ref.device_energy_mj.m2, e.device_energy_mj.m2)
            for ax in AXES:
                np.testing.assert_array_equal(getattr(ref.ledger, f"{ax}_mj"), getattr(e.ledger, f"{ax}_mj"),
                                              err_msg=ax)
            e.ledger.assert_conserves(e.total_energy_mj)
        got, want = ours["ens_gaps"][f, s], theirs["ens"][f, s]
        np.testing.assert_array_equal(got.per_device_items, want["per_device_items"])
        for k in ("per_device_energy_mj", "per_device_lifetime_ms"):
            np.testing.assert_allclose(getattr(got, k), want[k], rtol=1e-9, atol=0, err_msg=k)


def test_acceptance_4way_mesh_n4096(multi_rank):
    """The reference's acceptance bar: a 4-way mesh is bit-identical to
    run_periodic at N=4096, and to the JAX package's 4-way run."""
    ours, theirs = multi_rank
    res = ours["n4096"]
    params = uniform_fleet(4096, strategies=STRATEGIES, e_budget_mj=2500.0, device="cpu")
    assert_periodic_equal(run_periodic(params, 250), res)
    for k in PERIODIC_FIELDS:
        np.testing.assert_array_equal(_np(getattr(res, k)), theirs["n4096"][k], err_msg=k)
    assert res.n_shards == 4 and res.n_padding == 0
