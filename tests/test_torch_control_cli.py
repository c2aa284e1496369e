"""The port's control-plane CLI, ``repro_torch.launch.control``, against the
JAX package's ``repro.launch.control`` on the CPU (``--device cpu``).

The reference draws its request stream from ``jax.random``, the port from
host ``torch.Generator``\\ s, so for parity both CLIs are fed the port's
counts; the port's stream is held to its distribution instead.  Apart from
timings and the manifest the payloads are equal: counts exact, energies
and latencies bit for bit, the same frontier."""
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import control as cli
from test_torch_x64_shim import x64_shim

ROOT = Path(__file__).resolve().parents[1]
TIMING = ("elapsed_s", "device_ticks_per_s")


@pytest.fixture(scope="module")
def jcli():
    """The JAX package's CLI, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        from repro.launch import control as jcli

    return jcli


def _ours_and_reference(jcli, argv, tmp_path, monkeypatch, capsys) -> tuple[dict, dict]:
    drawn = {}
    draw = cli._global_counts

    def counts(args, n_ticks, dt_ms, n_devices, **kw):
        drawn["counts"] = draw(args, n_ticks, dt_ms, n_devices, **kw)
        return drawn["counts"]

    monkeypatch.setattr(cli, "_global_counts", counts)
    monkeypatch.setattr(jcli, "_global_counts", lambda args, n_ticks, dt_ms, n_devices: drawn["counts"])
    assert cli.main(argv + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out)
    jcli.main(argv + ["--out", str(tmp_path / "ref.json")])
    return ours, json.loads((tmp_path / "ref.json").read_text())


def _assert_payloads_equal(ours, ref):
    assert ours.keys() == ref.keys()
    assert ours["manifest"]["backend"] == "cpu" and ours["meta"]["device"] == "cpu"
    for key in ours.keys() - {"meta", "manifest", "throughput"}:
        assert ours[key] == ref[key], key
    a, b = ours["throughput"]["hierarchy"], ref["throughput"]["hierarchy"]
    assert a.keys() == b.keys()
    assert {k: v for k, v in a.items() if k not in TIMING} == {
        k: v for k, v in b.items() if k not in TIMING}


def test_smoke_payload_equals_the_reference(jcli, tmp_path, monkeypatch, capsys):
    ours, ref = _ours_and_reference(jcli, ["--smoke"], tmp_path, monkeypatch, capsys)
    _assert_payloads_equal(ours, ref)
    assert ours["config"]["ticks"] == 4096 and ours["config"]["n_devices"] == 16
    sc = ours["self_check"]
    assert sc["collapse"]["bit_identical_to_run_routed"] and sc["collapse"]["latency_multiset_identical"]
    assert sc["conservation"]["energy_error_total"] <= 1e-9
    assert ours["report"]["power_events"]["crashes"] == 2
    assert [p["policy"] for p in ours["pareto"]["points"]][:2] == ["always_on", "crossover"]


def test_planner_block_equals_the_reference(jcli, tmp_path, monkeypatch, capsys):
    ours, ref = _ours_and_reference(
        jcli, ["--smoke", "--ticks", "1024", "--fleet-budget-mj", "50000"], tmp_path, monkeypatch, capsys)
    _assert_payloads_equal(ours, ref)
    plan = ours["planner"]
    assert plan == ref["planner"]
    assert plan["objective"] == "total_requests" and 0 < plan["admitted_devices"] < 16


def test_json_goes_to_stdout_and_no_file_without_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    before = sorted(p.name for p in ROOT.iterdir())
    assert cli.main(["--device", "cpu", "--smoke", "--ticks", "128", "--faults", "1"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["kind"] == "control" and payload["config"]["ticks"] == 128
    assert list(tmp_path.iterdir()) == []
    assert sorted(p.name for p in ROOT.iterdir()) == before
    out = tmp_path / "control.json"
    assert cli.main(["--device", "cpu", "--smoke", "--ticks", "64", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["config"]["ticks"] == 64
    assert capsys.readouterr().out == ""


def test_cli_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--smoke"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("failure", ["collapse", "conservation"])
def test_a_failed_self_check_exits_3_and_emits_nothing(monkeypatch, capsys, failure):
    import repro_torch.control as control

    if failure == "collapse":
        monkeypatch.setattr(cli, "_collapse_self_check", lambda *a, **k: {
            "bit_identical_to_run_routed": False, "latency_multiset_identical": True, "served": 0})
    else:
        def broken(result, rtol=1e-9):
            raise AssertionError("hierarchy conservation violated: rack requests {'r0k0': 1}")
        monkeypatch.setattr(control, "verify_hierarchy", broken)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu", "--smoke", "--ticks", "64"])
    assert exc.value.code == 3
    captured = capsys.readouterr()
    assert captured.out == "" and "SELF-CHECK FAILED" in captured.err


def _args(**over):
    base = dict(load=0.5, days=1.0, amplitude=0.8, flash_every=0.0, flash_len=256, seed=0)
    return types.SimpleNamespace(**{**base, **over})


@pytest.mark.parametrize("streams", [1, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_diurnal_stream_total_within_5_sigma(streams, seed):
    """The diurnal carrier alone (no flash overlay) is an inhomogeneous
    Poisson stream whose rate integrates to load × devices per tick over
    whole days: its total lies within 5σ = 5·sqrt(mean) of that, for one
    stream and for 64 superposed at 1/64 of the rate each."""
    n_ticks, n_devices = 4096, 16
    counts = cli._global_counts(_args(seed=seed), n_ticks, 100.0, n_devices, streams=streams)
    assert counts.shape == (n_ticks,) and counts.dtype == np.int64 and (counts >= 0).all()
    mean = 0.5 * n_devices * n_ticks
    assert abs(int(counts.sum()) - mean) <= 5.0 * math.sqrt(mean)
    # the day shape: the first half-day (sin > 0) carries more than the second
    assert counts[: n_ticks // 2].sum() > counts[n_ticks // 2:].sum()


def test_stream_is_seeded_and_the_flash_overlay_adds_arrivals():
    a = cli._global_counts(_args(flash_every=64.0), 1024, 100.0, 16)
    b = cli._global_counts(_args(flash_every=64.0), 1024, 100.0, 16)
    c = cli._global_counts(_args(flash_every=64.0, seed=1), 1024, 100.0, 16)
    base = cli._global_counts(_args(), 1024, 100.0, 16)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert (a >= base).all() and a.sum() > base.sum()
