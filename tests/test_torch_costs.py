"""The port's cost zoo (``costs/counts.py``, ``costs/calibrate.py``,
``costs/zoo.py``, ``launch/costs.py``), ``core/tpu_energy.py`` and the
stubs they lift (``DeviceSpec.from_model``, ``FleetTenantSpec.from_model``,
the ``model:`` item form, ``launch.fleet --models/--n-seeds``) against the
JAX package, on the CPU.

Everything here is float arithmetic on the same constants in the same
order, so every field equals the reference's exactly."""
import dataclasses
import json

import numpy as np
import pytest

from repro_torch.costs import (
    EDGE_ACCEL,
    PAPER_LSTM_MODEL,
    PROFILES,
    TPU_V5E_LIKE,
    attention_counts,
    dequant_counts,
    ffn_counts,
    lstm_counts,
    matmul_counts,
    measured_efficiency,
    model_mix_fleet,
    model_names,
    model_request_cost,
    request_counts,
    request_item,
    roofline_time_ms,
    ssd_counts,
)
from repro_torch.core import tpu_energy
from repro_torch.core import workload as wl
from repro_torch.fleet import DeviceSpec
from repro_torch.launch import costs as costs_cli
from repro_torch.launch import fleet as fleet_cli
from test_torch_x64_shim import x64_shim

TIMING = ("elapsed_s", "devices_per_s", "device_steps_per_s", "speedup_devices_per_s",
          "seeds_per_s", "pts_per_s")


@pytest.fixture(scope="module")
def jref():
    """The JAX package's cost zoo, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains.
    Submodules come by ``from`` imports: a JAX-package test file that failed
    to import on the same worker leaves them in ``sys.modules`` without
    their attribute on a re-imported parent package."""
    with x64_shim():
        from repro import configs, costs, fleet
        from repro.core import tpu_energy, workload
        from repro.launch import costs as launch_costs
        from repro.launch import fleet as launch_fleet
        from repro.serving import fleet_backend

    return dict(costs=costs, configs=configs, tpu=tpu_energy, wl=workload, fleet=fleet,
                backend=fleet_backend, launch_costs=launch_costs, launch_fleet=launch_fleet)


def _item_dict(item):
    return dataclasses.asdict(item)


@pytest.mark.parametrize("batch", [1, 8])
def test_model_request_cost_equals_the_reference_for_every_zoo_model(jref, batch):
    assert model_names() == jref["costs"].model_names()
    assert len(model_names()) == 11 and PAPER_LSTM_MODEL in model_names()
    for model in model_names():
        rc = model_request_cost(model, batch=batch)
        jrc = jref["costs"].model_request_cost(model, batch=batch)
        assert rc.to_dict() == jrc.to_dict(), model
        assert _item_dict(rc.item) == _item_dict(jrc.item), model
        assert dataclasses.asdict(rc.counts) == dataclasses.asdict(jrc.counts), model
        assert rc.latency_ms == jrc.latency_ms and rc.crossover_ms == jrc.crossover_ms


@pytest.mark.parametrize("model", ["mixtral-8x7b", "mamba2-370m", "jamba-1.5-large-398b"])
def test_profiles_and_request_shapes_equal_the_reference(jref, model):
    jc = jref["costs"]
    assert {k: p.to_dict() for k, p in PROFILES.items()} == {k: p.to_dict() for k, p in jc.PROFILES.items()}
    assert (TPU_V5E_LIKE.peak_flops, TPU_V5E_LIKE.hbm_bw) == (197e12, 819e9)
    for kw in (dict(profile="edge-accel"), dict(profile="tpu-v5e-like", efficiency=0.8),
               dict(prefill_len=512, decode_len=0), dict(profile=dataclasses.replace(EDGE_ACCEL, name="x"))):
        jkw = dict(kw)
        if dataclasses.is_dataclass(kw.get("profile")):
            jkw["profile"] = jc.AcceleratorProfile(**kw["profile"].to_dict())
        assert model_request_cost(model, **kw).to_dict() == jc.model_request_cost(model, **jkw).to_dict()
    with pytest.raises(KeyError):
        model_request_cost("no-such-model")
    with pytest.raises(KeyError):
        model_request_cost(model, profile="no-such-profile")


def test_counters_and_calibration_equal_the_reference(jref):
    jc = jref["costs"]
    for fn, jfn, args in (
        (matmul_counts, jc.matmul_counts, (7, 64, 96, 3)),
        (attention_counts, jc.attention_counts, (1, 1024, 1024, 8, 64, 2)),
        (ssd_counts, jc.ssd_counts, (1, 2048, 8, 64, 64, 1)),
        (lstm_counts, jc.lstm_counts, (1, 64, 6, 20)),
        (dequant_counts, jc.dequant_counts, (1024, 4096)),
        (ffn_counts, jc.ffn_counts, (2, 16, 4096, 14336, "swiglu", 2, 8)),
    ):
        assert dataclasses.asdict(fn(*args)) == dataclasses.asdict(jfn(*args))
    from repro_torch.configs import get_config

    for arch in ("qwen3-32b", "mixtral-8x7b"):
        rc = request_counts(get_config(arch), batch=4, prefill_len=300, decode_len=17)
        jrc = jc.request_counts(jref["configs"].get_config(arch), batch=4, prefill_len=300, decode_len=17)
        assert rc.to_dict() == jrc.to_dict()
        for prof, jprof in ((TPU_V5E_LIKE, jc.TPU_V5E_LIKE), (EDGE_ACCEL, jc.EDGE_ACCEL)):
            assert roofline_time_ms(rc.total, prof, 0.3) == jc.roofline_time_ms(jrc.total, jprof, 0.3)
            assert _item_dict(request_item(rc, prof)) == _item_dict(jc.request_item(jrc, jprof))
    analytic = {"a": attention_counts(1, 1024, 1024, 8, 64, 2), "d": dequant_counts(1024, 4096)}
    janalytic = {"a": jc.attention_counts(1, 1024, 1024, 8, 64, 2), "d": jc.dequant_counts(1024, 4096)}
    us = {"a": 50.0, "d": 4.0, "x": 1.0}
    assert (measured_efficiency(analytic, us, 989e12, 3.35e12)
            == jc.measured_efficiency(janalytic, us, 989e12, 3.35e12))


def test_tpu_energy_sweep_equals_the_reference(jref):
    jt = jref["tpu"]
    from repro_torch.configs import get_config

    for arch, chips in (("qwen3-32b", 4), ("mamba2-370m", 1)):
        roof = {"step_time_lower_bound_s": 0.0123}
        cell = tpu_energy.cell_from_roofline(get_config(arch), chips, roof)
        jcell = jt.cell_from_roofline(jref["configs"].get_config(arch), chips, roof)
        assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
        assert tpu_energy.sweep_config_space(cell) == jt.sweep_config_space(jcell)
        assert len(tpu_energy.sweep_config_space(cell)) == 3 * 3 * 3   # lanes × link tiers × compression
        for tier in ("baseline", "method1", "method1+2"):
            assert tpu_energy.crossover_ms(cell, idle_tier=tier) == jt.crossover_ms(jcell, idle_tier=tier)
        assert tpu_energy.energy_reduction_factor(cell) == jt.energy_reduction_factor(jcell)


# ---------------------------------------------------------------------------
# The lifted stubs
# ---------------------------------------------------------------------------
def test_device_and_tenant_specs_from_the_zoo_equal_the_reference(jref):
    from repro_torch.serving.fleet_backend import FleetBackend, FleetTenantSpec

    for model, kw in (("mixtral-8x7b", dict(utilization=0.5)),
                      ("mamba2-370m", dict(strategy="on_off", batch=8)),
                      (PAPER_LSTM_MODEL, dict(request_period_ms=40.0))):
        spec = DeviceSpec.from_model(model, **kw)
        jspec = jref["fleet"].DeviceSpec.from_model(model, **kw)
        assert spec.scalar_columns() == jspec.scalar_columns()
        assert spec.strategy == jspec.strategy and spec.request_period_ms == jspec.request_period_ms
    for model, kw in (("qwen3-1.7b", dict(replicas=2)), ("yi-6b", dict(policy="on_off", batch=4))):
        t = FleetTenantSpec.from_model(model, **kw)
        jt = jref["backend"].FleetTenantSpec.from_model(model, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(jt)
        assert t.device_spec().scalar_columns() == jt.device_spec().scalar_columns()
    backend = FleetBackend([FleetTenantSpec.from_model("qwen3-1.7b", replicas=2)], device="cpu")
    assert backend.n_devices == 2
    with pytest.raises(ValueError, match="utilization"):
        FleetTenantSpec.from_model("qwen3-1.7b", utilization=0.0)


def test_model_mix_fleet_equals_the_reference(jref):
    mix = [("mixtral-8x7b", 1), ("mamba2-370m", 2), "qwen3-1.7b"]
    params = model_mix_fleet(mix, n_devices=10, e_budget_mj=5e7, device="cpu")
    jparams = jref["costs"].model_mix_fleet(mix, n_devices=10, e_budget_mj=5e7)
    for f in dataclasses.fields(params):
        np.testing.assert_array_equal(getattr(params, f.name).numpy(), np.asarray(getattr(jparams, f.name)))
    with pytest.raises(ValueError):
        model_mix_fleet([("qwen3-1.7b", 0)], device="cpu")


def test_the_model_item_form_equals_the_reference(jref):
    text = """
workload:
  energy_budget_j: 4147.0
  request_period_ms: 60000.0
item:
  model: mixtral-8x7b
  batch: 8
  profile: tpu-v5e-like
strategy:
  kind: idle_waiting
"""
    spec, jspec = wl.loads(text), jref["wl"].loads(text)
    assert spec.to_dict() == jspec.to_dict()
    assert spec.item == model_request_cost("mixtral-8x7b", batch=8, profile="tpu-v5e-like").item
    with pytest.raises(ValueError, match="not both"):
        wl._item_from_dict({"model": "qwen3-1.7b", "phases": []})


def _strip(d, drop=TIMING):
    if isinstance(d, dict):
        return {k: _strip(v, drop) for k, v in d.items() if k not in drop}
    if isinstance(d, list):
        return [_strip(v, drop) for v in d]
    return d


def test_costs_cli_payload_equals_the_reference(jref, tmp_path):
    argv = ["--smoke", "--no-kernels", "--out"]
    assert costs_cli.main(argv + [str(tmp_path / "p.json"), "--device", "cpu"]) == 0
    assert jref["launch_costs"].main(argv + [str(tmp_path / "r.json")]) == 0
    p, r = (json.loads((tmp_path / f).read_text()) for f in ("p.json", "r.json"))
    assert set(p) == set(r) and "calibration" not in p
    for key in ("config", "costs", "golden", "size"):
        assert _strip(p[key]) == _strip(r[key]), key
    pf, rf = dict(p["fleet"]), dict(r["fleet"])
    pe, re_ = pf.pop("ensemble"), rf.pop("ensemble")
    assert _strip(pf) == _strip(rf)
    # the ensemble draws from each package's own generator: same layout
    assert _strip(pe).keys() == _strip(re_).keys() and pe["n_seeds"] == re_["n_seeds"] == 16
    assert p["golden"] == {"model": PAPER_LSTM_MODEL, "source": "measured",
                           "item_matches_table2": True, "crossover_ms": 499.06,
                           "lifetime_ratio_40ms": 12.41}


def test_costs_cli_calibration_section_on_the_cpu(tmp_path):
    import benchmarks.bench_kernels as bk

    assert costs_cli.main(["--smoke", "--device", "cpu", "--models", "qwen3-1.7b", "--batches", "1",
                           "--out", str(tmp_path / "p.json")]) == 0
    cal = json.loads((tmp_path / "p.json").read_text())["calibration"]
    assert cal["device"] == "cpu" and cal["card"] is None
    assert set(cal["kernels"]) == {"flash_attention", "ssd", "lstm", "dequant"}
    for name, row in cal["kernels"].items():
        assert row["shape"] == bk.KERNEL_SHAPES[row["replaces"]]
        counts, op_dtype = costs_cli.calibration_counts(name)
        assert (row["flops"], row["hbm_bytes"], row["op_dtype"]) == (counts.flops, counts.hbm_bytes, op_dtype)
        t_ops, t_bytes = row["flops"] / costs_cli.H100_PEAK_OPS[op_dtype], row["hbm_bytes"] / 3.35e12
        assert row["bound_us"] == max(t_ops, t_bytes) * 1e6
        assert row["bound_by"] == ("operations" if t_ops > t_bytes else "bytes")
        assert row["launches"] == 0 and row["us"] > 0 and row["efficiency"] == row["bound_us"] / row["us"]
    assert {n: r["bound_by"] for n, r in cal["kernels"].items()} == {
        "flash_attention": "operations", "ssd": "bytes", "lstm": "bytes", "dequant": "bytes"}


def test_calibration_counts_are_what_each_kernel_must_do():
    """The causal half of the attention square, and the LSTM's weights read
    once — not the model pricing's full square and per-step re-reads."""
    fa, _ = costs_cli.calibration_counts("flash_attention")
    assert fa.flops == 4 * 8 * 64 * (1024 * 1025 // 2)
    assert attention_counts(1, 1024, 1024, 8, 64, 2).flops == 4 * 8 * 64 * 1024 * 1024
    assert fa.hbm_bytes == attention_counts(1, 1024, 1024, 8, 64, 2).hbm_bytes == 2 * 1024 * 64 * (8 + 4 + 8)
    lstm, dtype = costs_cli.calibration_counts("lstm")
    assert dtype == "float32" and lstm.flops == lstm_counts(1, 64, 6, 20).flops
    assert lstm.hbm_bytes == 4 * (80 * 27 + 64 * 26 + 40) < lstm_counts(1, 64, 6, 20).hbm_bytes / 30
    ssd, _ = costs_cli.calibration_counts("ssd")
    assert ssd.hbm_bytes == 2 * (2 * 2048 * 8 * 64 + 2 * 2048 * 64) + 4 * (2048 * 8 + 16 + 8 * 64 * 64)
    dq, _ = costs_cli.calibration_counts("dequant")
    assert dq.hbm_bytes == dequant_counts(1024, 4096).hbm_bytes


def test_calibration_accuracy_on_the_cpu_and_against_a_dropped_key_tile(monkeypatch):
    """On the CPU the op is the plain version, so every check passes at
    zero error; a flash that drops the last 64 keys fails its check."""
    import torch

    from repro_torch.kernels.flash_attention import ops as attn
    from repro_torch.kernels.flash_attention.ref import attention_reference

    for name in ("dequant", "lstm", "flash_attention"):
        for what, c in costs_cli.calibration_accuracy(name, "cpu").items():
            assert c["ok"] and c["max_abs_err"] == 0.0, (name, what)
    bf16 = costs_cli.calibration_accuracy("flash_attention", "cpu")["bf16"]
    assert 5e-4 < bf16["limit"] < 1e-2               # twice half a bf16 step at the largest values

    def dropped(q, k, v):
        pos = torch.arange(k.shape[1], dtype=torch.int32)
        return attention_reference(q, k, v, kv_positions=torch.where(pos >= 960, -1, pos))

    monkeypatch.setattr(attn, "attention", dropped)
    bad = costs_cli.calibration_accuracy("flash_attention", "cpu")["bf16"]
    assert not bad["ok"] and bad["rel_err"] > 2 * bad["limit"]


def test_calibration_inputs_hold_each_plain_version():
    """On the CPU the op is the plain version: the two calls agree exactly."""
    for name in costs_cli.KERNEL_SHAPES:
        kernel, plain = costs_cli.calibration_inputs(name, "cpu")
        a, b = kernel(), plain()
        assert a.shape == b.shape and bool((a == b).all()), name


def test_fleet_cli_models_and_seeds_equal_the_reference(jref, tmp_path):
    argv = ["--models", "mixtral-8x7b,mamba2-370m:2,qwen3-1.7b", "--devices", "12", "--mode",
            "periodic", "--horizon", "600", "--budget-j", "50000", "--n-seeds", "4", "--smoke"]
    assert fleet_cli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")]) == 0
    assert jref["launch_fleet"].main(argv + ["--out", str(tmp_path / "r.json")]) == 0
    p, r = (json.loads((tmp_path / f).read_text()) for f in ("p.json", "r.json"))
    r["throughput"].pop("sharded")
    for key in ("config", "summary", "n_steps", "oracle_self_check", "uncertainty"):
        assert _strip(p[key]) == _strip(r[key]), key
    assert set(p["throughput"]["periodic"]) == set(r["throughput"]["periodic"]) == {"fleet"}
    assert p["uncertainty"]["lifetime_ms"]["lo"] == p["uncertainty"]["lifetime_ms"]["hi"]
