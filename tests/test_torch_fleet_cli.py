"""The port's CLIs, ``repro_torch.launch.sweep`` and
``repro_torch.launch.fleet``, against the JAX package's on the same
arguments, on the CPU (``--device cpu``).

The payloads carry the same keys and values; timing and manifest keys are
excepted (``meta``, ``manifest``, the throughput blocks' times and rates),
and the port's additions to the sharded blocks (``runtime``, the
acceptance scan's ``unsharded`` replay).  ``--mesh 2`` spawns two gloo
ranks on the CPU; its blocks equal the reference's ``--mesh 1`` (the one
mesh a one-device JAX process has) apart from the mesh and shard count.
The sweep payloads' phase-sum quantities follow the scalar oracle where
the reference departs from it (ROADMAP C-ref-6,
``tests/test_torch_batch_eval.py``)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import batch_eval as be
from repro_torch.core import energy_model as em
from repro_torch.core.config_phase import DEVICES
from repro_torch.launch import _cli, fleet, sweep
from test_torch_batch_eval import (
    _departs,
    _derived_item,
    assert_records_equal_to_reference,
)
from test_torch_x64_shim import x64_shim

TIMING = ("elapsed_s", "devices_per_s", "device_steps_per_s", "speedup_devices_per_s")


@pytest.fixture(scope="module")
def jref():
    """The JAX package's CLIs, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        from repro.launch import fleet as jfleet, sweep as jsweep

    return dict(sweep=jsweep, fleet=jfleet)


def _run(main, argv, path) -> dict:
    assert main(argv + ["--out", str(path)]) == 0
    return json.loads(path.read_text())


def _grid(argv) -> be.SweepGrid:
    ap = _cli.make_parser("x", "x")
    for flag, default in (("--kind", "strategies"), ("--devices", "spartan7-xc7s15"),
                          ("--buswidths", None), ("--clocks", None), ("--periods", "10:120:10"),
                          ("--methods", "baseline,method1,method1+2"), ("--budgets-j", "4147"),
                          ("--idle-powers", "134.3,34.2,24.0"), ("--limit", None)):
        ap.add_argument(flag, default=default)
    return sweep.build_grid(ap.parse_args(argv))


SWEEPS = {
    "config": ["--kind", "config", "--devices", "both"],
    "strategies": ["--kind", "strategies", "--calibrated", "--periods", "10:200:10"],
    "strategies_both": ["--kind", "strategies", "--devices", "both", "--buswidths", "1,4",
                        "--clocks", "3,33,66", "--budgets-j", "2,4147", "--limit", "500"],
    "pareto": ["--kind", "pareto", "--calibrated", "--methods", "baseline,method1+2"],
    "crossover": ["--kind", "crossover", "--devices", "both", "--calibrated"],
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_cli_gives_the_reference_payload(jref, tmp_path, name):
    argv = SWEEPS[name]
    ours = _run(sweep.main, argv + ["--device", "cpu"], tmp_path / "ours.json")
    ref = _run(jref["sweep"].main, argv, tmp_path / "ref.json")
    assert ours.keys() == ref.keys()
    assert ours["meta"].keys() - {"device"} == ref["meta"].keys() - {"jit"}
    assert ours["manifest"]["backend"] == "cpu" and ours["manifest"]["versions"]["torch"]
    grid = _grid(argv)
    for key in ours.keys() - {"meta", "manifest"}:
        a, b = ours[key], ref[key]
        if key in ("records", "strategy_frontier"):
            assert_records_equal_to_reference(grid, a, b)
        elif key == "crossover_ms":
            a, b = np.asarray(a), np.asarray(b)
            powers = [134.3, 34.2, 24.0]
            for d, w, f, c, p in map(tuple, np.argwhere(a != b)):
                item = _derived_item(be.SweepGrid(devices=tuple(DEVICES.values())), d, w, f, c)
                want = em.crossover_period_ms(item, powers[p], em.CALIBRATED_POWERUP_OVERHEAD_MJ)
                assert _departs(a[d, w, f, c, p], b[d, w, f, c, p], want)
        else:
            assert a == b, key


def _strip(throughput: dict) -> dict:
    return {mode: {k: ({kk: vv for kk, vv in v.items() if kk not in TIMING} if isinstance(v, dict) else v)
                   for k, v in block.items() if k not in TIMING + PORT_ONLY}
            for mode, block in throughput.items()}


PORT_ONLY = ("runtime", "unsharded")


FLEETS = {
    "routed": ["--smoke", "--devices", "48"],
    "routed_power_aware": ["--smoke", "--devices", "40", "--router", "power_aware", "--process",
                           "poisson", "--load", "0.5", "--dt-ms", "20", "--budget-j", "2"],
    "periodic": ["--smoke", "--devices", "30", "--mode", "periodic", "--budget-j", "5",
                 "--strategy", "idle_waiting", "--horizon", "40"],
}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_cli_gives_the_reference_payload(jref, tmp_path, name):
    argv = FLEETS[name]
    ours = _run(fleet.main, argv + ["--device", "cpu"], tmp_path / "ours.json")
    ref = _run(jref["fleet"].main, argv, tmp_path / "ref.json")
    assert ours.keys() == ref.keys()
    for key in ("kind", "config", "summary", "n_steps", "oracle_self_check"):
        assert ours[key] == ref[key], key
    assert _strip(ours["throughput"]) == _strip(ref["throughput"])
    assert all(v["agrees"] for v in ours["oracle_self_check"].values())


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "2x2x2"], "bad mesh spec"),
    (["--mesh", "axb"], "bad mesh spec"),
    (["--mesh", "0"], "both axes must be >= 1"),
    (["--mesh", "2x0"], "both axes must be >= 1"),
])
def test_fleet_cli_features_not_ported_raise(argv, item):
    """Every feature of the reference's fleet CLI is ported (``--mesh`` and
    ``--acceptance-devices`` since the multi-rank runtime); what still
    raises is a mesh no rank count can hold, before any rank is spawned."""
    with pytest.raises(ValueError, match=item):
        fleet.main(["--device", "cpu", "--smoke", "--devices", "8"] + argv)


def test_fleet_cli_mesh_2_acceptance_equals_the_reference(jref, tmp_path):
    """``--mesh 2 --acceptance-devices 4096`` on two CPU ranks: the sharded
    blocks bit for bit against ``run_periodic`` and equal to the
    reference's (its ``--mesh 1``), every budget exhausted, the ledger
    conserving within 1e-9, the runtime reported."""
    argv = ["--smoke", "--devices", "30", "--mode", "periodic", "--budget-j", "5", "--horizon", "40",
            "--acceptance-devices", "4096"]
    ours = _run(fleet.main, argv + ["--device", "cpu", "--mesh", "2"], tmp_path / "ours.json")
    ref = _run(jref["fleet"].main, argv + ["--mesh", "1"], tmp_path / "ref.json")
    assert ours.keys() == ref.keys()
    for key in ("kind", "config", "summary", "n_steps", "oracle_self_check"):
        assert ours[key] == ref[key], key
    sh, rsh = ours["throughput"]["sharded"], ref["throughput"]["sharded"]
    assert (sh["mesh"], sh["n_shards"], rsh["mesh"]) == ("2x1", 2, "1x1")
    assert sh["bit_identical_to_unsharded"] and rsh["bit_identical_to_unsharded"]
    runtime = {"ranks": 2, "backend": "gloo", "staged": "host", "ranks_per_card": None}
    assert {k: sh["runtime"][k] for k in runtime} == runtime and sh["runtime"]["spawn_s"] > 0
    acc, racc = ours["sharded_acceptance"], ref["sharded_acceptance"]
    same = set(racc) - set(TIMING) - {"mesh", "n_shards"}
    assert {k: acc[k] for k in same} == {k: racc[k] for k in same}
    assert acc["all_budget_exhausted"] and acc["ledger_conservation"]["within_1e-9"]
    assert acc["unsharded"]["bit_identical"] and acc["runtime"]["ranks"] == 2
    assert acc["steps_executed"] == acc["n_steps_cap"] == 4096


def test_clis_default_to_the_card_and_raise_without_it(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (sweep.main, fleet.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
    assert capsys.readouterr().out == ""


def test_parse_axis_and_manifest():
    assert _cli.parse_axis("10:40:10") == [10.0, 20.0, 30.0, 40.0]
    assert _cli.parse_axis("3,6,9") == [3.0, 6.0, 9.0]
    m = _cli.run_manifest(seed=3, device="cpu")
    assert m["seed"] == 3 and m["card"] is None and "jax" not in m["versions"]
    assert m["versions"]["torch"] == torch.__version__
