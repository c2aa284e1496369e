"""The port's observability (``obs/metrics.py``, ``obs/trace.py``,
``obs/report.py``, the engine's ``metrics=`` registry, ``launch/obs.py``)
against the JAX package, on the CPU.

Histogram counts are exact, ties on bucket edges included; traces are the
same Chrome event lists; the obs CLI's deterministic fields are equal, the
conservation errors (rounding residues of two sums) within 1e-12."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.adaptive import FixedTimeoutPolicy, StaticPolicy, break_even_timeout_ms
from repro_torch.core.phases import paper_lstm_item
from repro_torch.core.simulator import simulate_trace
from repro_torch.fleet import run_routed, uniform_fleet
from repro_torch.obs import (
    Histogram,
    MetricsRegistry,
    TraceRecorder,
    default_latency_edges_ms,
    fleet_queue_depth_edges,
    hist_update,
    render_markdown,
    routed_metrics,
    routed_timeline,
    run_report,
    scan_histogram,
    trace_summary,
    validate_chrome_trace,
)
from test_torch_x64_shim import x64_shim

CAL = em.CALIBRATED_POWERUP_OVERHEAD_MJ
STRATEGIES = ("on_off", "idle_waiting", "adaptive")


@pytest.fixture(scope="module")
def jref():
    """The JAX package's observability, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains.
    Submodules come by ``from`` imports: a JAX-package test file that failed
    to import on the same worker leaves them in ``sys.modules`` without
    their attribute on a re-imported parent package."""
    with x64_shim():
        from repro import fleet, obs
        from repro.core import adaptive, phases, simulator
        from repro.launch import obs as launch_obs

    return dict(obs=obs, fleet=fleet, sim=simulator, adaptive=adaptive, phases=phases,
                launch_obs=launch_obs)


def _values(seed, shape=(40, 16), edges=None):
    """Lognormal latencies with a share of them set exactly on the edges."""
    rng = np.random.default_rng(seed)
    values = rng.lognormal(mean=2.0, sigma=1.5, size=shape)
    edges = default_latency_edges_ms() if edges is None else np.asarray(edges)
    on_edge = rng.random(shape) < 0.2
    values[on_edge] = rng.choice(edges, size=int(on_edge.sum()))
    return values, rng.random(shape) < 0.7


# ---------------------------------------------------------------------------
# Histograms: host, in-loop, numpy and the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_and_loop_histograms_equal_numpy_and_the_reference(jref, seed, masked):
    values, mask = _values(seed)
    mask = mask if masked else None
    edges = default_latency_edges_ms()
    np.testing.assert_array_equal(edges, jref["obs"].default_latency_edges_ms())
    kept = values[mask] if masked else values.ravel()
    want = np.bincount(np.searchsorted(edges, kept, side="left"), minlength=edges.size + 1)
    host = Histogram("h", edges)
    host.observe_many(values, mask=mask)
    loop = scan_histogram(values, edges, mask=mask, device="cpu")
    with x64_shim():     # the reference imports enable_x64 inside the call
        ref = jref["obs"].scan_histogram(values, edges, mask=mask)
    jhost = jref["obs"].Histogram("h", edges)
    jhost.observe_many(values, mask=mask)
    assert loop.dtype == np.int64
    for counts in (host.counts, loop, ref, jhost.counts):
        np.testing.assert_array_equal(counts, want)
    assert host.to_dict() == jhost.to_dict()


def test_hist_update_puts_ties_in_the_lower_bucket_and_drops_masked_values():
    edges = torch.tensor([1.0, 10.0, 100.0], dtype=torch.float64)
    counts = torch.zeros(4, dtype=torch.int64)
    values = torch.tensor([1.0, 10.0, 100.0, 100.5, 0.0, 5.0], dtype=torch.float64)
    mask = torch.tensor([True, True, True, True, True, False])
    out = hist_update(counts, edges, values, mask)
    assert out.dtype == torch.int64 and out.tolist() == [2, 1, 1, 1]
    assert hist_update(out, edges, values.to(torch.float32)).tolist() == [4, 3, 2, 2]


def test_registry_percentiles_and_queue_edges_equal_the_reference(jref):
    jobs = jref["obs"]
    h, jh = Histogram("lat", np.linspace(1, 100, 100)), jobs.Histogram("lat", np.linspace(1, 100, 100))
    for x in (np.arange(1, 101, dtype=np.float64), [-5.0, 250.0]):
        h.observe_many(x)
        jh.observe_many(x)
    for q in (0.0, 1.0, 50.0, 99.0, 100.0):
        assert h.percentile(q) == jh.percentile(q)
    assert h.to_dict() == jh.to_dict()
    for cap, n in ((4, 3), (16, 256), (16, 4096)):
        np.testing.assert_array_equal(fleet_queue_depth_edges(cap, n),
                                      jobs.fleet_queue_depth_edges(cap, n))
    reg = MetricsRegistry()
    with pytest.raises(TypeError):
        reg.counter("x") and reg.gauge("x")
    with pytest.raises(ValueError, match="different edges"):
        reg.histogram("h", [1.0, 2.0]) and reg.histogram("h", [1.0, 3.0])


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------
def _policies(item, ref_adaptive=None):
    p_idle = item.idle_power_mw
    timeout = break_even_timeout_ms(item, p_idle, CAL)
    if ref_adaptive is not None:
        return {"on_off": ref_adaptive.StaticPolicy("on_off", item),
                "idle_waiting": ref_adaptive.StaticPolicy("idle_waiting", item),
                "break_even": ref_adaptive.FixedTimeoutPolicy(timeout, p_idle)}
    return {"on_off": StaticPolicy("on_off", item),
            "idle_waiting": StaticPolicy("idle_waiting", item),
            "break_even": FixedTimeoutPolicy(timeout, p_idle)}


@pytest.mark.parametrize("policy", ["on_off", "idle_waiting", "break_even"])
@pytest.mark.parametrize("budget_mj", [em.PAPER_ENERGY_BUDGET_MJ, 60.0])
def test_simulate_trace_recorder_gives_the_reference_chrome_events(jref, policy, budget_mj):
    item, jitem = paper_lstm_item(), jref["phases"].paper_lstm_item()
    arrivals = [0.0, 10.0, 700.0, 710.0, 2500.0] + [2500.0 + 37.0 * k for k in range(1, 200)]
    rec, jrec = TraceRecorder(), jref["obs"].TraceRecorder()
    res = simulate_trace(item, arrivals, _policies(item)[policy], budget_mj,
                         powerup_overhead_mj=CAL, recorder=rec)
    jres = jref["sim"].simulate_trace(jitem, arrivals, _policies(jitem, jref["adaptive"])[policy],
                                      budget_mj, powerup_overhead_mj=CAL, recorder=jrec)
    assert res.n_items == jres.n_items
    payload = rec.to_chrome()
    assert payload == jrec.to_chrome()
    assert validate_chrome_trace(payload) == []
    assert trace_summary(payload) == jref["obs"].trace_summary(payload)


def _routed_pair(jref, n=6, ticks=30, qcap=16):
    kw = dict(strategies=STRATEGIES, request_period_ms=40.0, powerup_overhead_mj=CAL)
    counts = np.random.default_rng(4).poisson(0.9 * n, ticks).astype(np.int32)
    run_kw = dict(router="round_robin", queue_capacity=qcap, collect_latency=True, collect_events=True)
    res = run_routed(uniform_fleet(n, device="cpu", **kw), counts, 40.0, **run_kw)
    jres = jref["fleet"].run_routed(jref["fleet"].uniform_fleet(n, **kw), counts, 40.0, **run_kw)
    return res, jres


def test_routed_timeline_and_metrics_equal_the_reference(jref, tmp_path):
    res, jres = _routed_pair(jref)
    rec = routed_timeline(res)
    payload = rec.to_chrome()
    with x64_shim():     # the reference's timeline and metrics import enable_x64 inside the call
        assert payload == jref["obs"].routed_timeline(jres).to_chrome()
        jreg = jref["obs"].routed_metrics(jres).to_dict()
    assert validate_chrome_trace(payload) == []
    rec.write(str(tmp_path / "trace.json"))
    assert validate_chrome_trace(json.loads((tmp_path / "trace.json").read_text())) == []
    reg = routed_metrics(res).to_dict()
    assert reg == jreg
    assert reg["request_latency_ms"]["total"] == int(res.served_mask.sum())
    with pytest.raises(ValueError, match="collect_events"):
        routed_timeline(run_routed(uniform_fleet(2, device="cpu"), np.full(5, 2, np.int32), 40.0))


def test_validator_and_report_agree_with_the_reference(jref):
    jobs = jref["obs"]
    bad = {"traceEvents": [
        {"name": "x", "ph": "B", "ts": 0, "pid": 1, "tid": 1},
        {"name": "y", "ph": "X", "ts": -5, "dur": 1, "pid": 1, "tid": 1},
        {"name": "z", "ph": "E", "ts": 3, "pid": 1, "tid": 2},
        {"name": "w", "ph": "Q", "ts": 4, "pid": 1, "tid": 1},
        "nope",
    ]}
    assert validate_chrome_trace(bad) == jobs.validate_chrome_trace(bad)
    assert validate_chrome_trace([]) == jobs.validate_chrome_trace([])
    with pytest.raises(ValueError):
        TraceRecorder().instant("bad", float("nan"))
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("served").inc(7)
        r.gauge("alive").set(3)
        r.histogram("lat", [1.0, 10.0]).observe_many([0.5, 5.0, 50.0])
    kw = dict(summary={"n": 1}, conservation={"fleet": 1e-16}, throughput={"x": 1.0},
              config={"devices": 4})
    report = run_report(metrics=reg, **kw)
    assert report == jobs.run_report(metrics=jreg, **kw)
    assert render_markdown(report) == jobs.render_markdown(report)


# ---------------------------------------------------------------------------
# The engine's registry
# ---------------------------------------------------------------------------
def test_engine_metrics_names_and_counts_equal_the_reference(jref, tmp_path, monkeypatch):
    """A reduced qwen3 brought up from one JAX-written checkpoint in both
    packages with a registry attached: two generate calls and a release."""
    import jax
    import jax.numpy as jnp
    from repro import checkpoint as jckpt
    from repro.checkpoint import serializer as jser
    from repro.configs import base as jbase
    from repro.models import model_zoo as jzoo
    from repro.serving import engine as jengine

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serving.engine import bring_up_from_checkpoint

    small = dict(name="qwen3-small", family="dense", num_layers=2, d_model=128, num_heads=4,
                 num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=1024, qk_norm=True,
                 rope_theta=1_000_000.0, tie_embeddings=True)
    monkeypatch.setattr(jser, "HAVE_ZSTD", False)   # the zlib codec
    jcfg, cfg = jbase.ArchConfig(**small), ArchConfig(**small)
    jm = jckpt.CheckpointManager(str(tmp_path), mode="zstd+int8")
    jm.save(0, jzoo.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)

    jreg, reg = jref["obs"].MetricsRegistry(), MetricsRegistry()
    jeng = jengine.bring_up_from_checkpoint(
        jcfg, jm, 32, warmup_batch={"tokens": jnp.asarray(toks)}, metrics=jreg)
    eng = bring_up_from_checkpoint(cfg, CheckpointManager(str(tmp_path)), 32,
                                   warmup_batch={"tokens": torch.from_numpy(toks)},
                                   device="cpu", metrics=reg)
    for _ in range(2):
        jeng.generate({"tokens": jnp.asarray(toks)}, n_new=4)
        eng.generate({"tokens": torch.from_numpy(toks)}, n_new=4)
    jeng.release()
    eng.release()

    def counts(d):
        return {k: (m["type"], m.get("value"), m.get("total")) for k, m in d.items()}

    d, jd = reg.to_dict(), jreg.to_dict()
    assert list(d) == list(jd) == sorted([
        "engine_bring_up_ms", "engine_bring_ups", "engine_decode_ms", "engine_generate_calls",
        "engine_prefill_ms", "engine_releases", "engine_resident", "engine_tokens_generated"])
    assert counts(d) == counts(jd)
    assert d["engine_tokens_generated"]["value"] == 2 * 1 + 2 * 2 * 4
    assert d["engine_resident"]["value"] == 0.0 and d["engine_releases"]["value"] == 1
    assert all(d[k]["edges"] == jd[k]["edges"] for k in d if d[k]["type"] == "histogram")


# ---------------------------------------------------------------------------
# The obs CLI
# ---------------------------------------------------------------------------
def test_obs_cli_smoke_payload_equals_the_reference(jref, tmp_path):
    from repro_torch.launch import obs as obs_cli

    argv = ["--smoke", "--horizon", "4"]
    assert obs_cli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "p.json"),
                                "--trace-out", str(tmp_path / "t.json"),
                                "--md-out", str(tmp_path / "p.md")]) == 0
    with x64_shim():     # the reference's CLI imports enable_x64 inside its metrics
        assert jref["launch_obs"].main(argv + ["--out", str(tmp_path / "r.json")]) == 0
    p, r = (json.loads((tmp_path / f).read_text()) for f in ("p.json", "r.json"))
    assert set(p) == set(r)
    for key in ("config", "ledger", "metrics", "summary", "trace"):
        assert p[key] == r[key], key
    assert set(p["conservation"]) == set(r["conservation"])
    for path, err in p["conservation"].items():
        assert err <= 1e-9 and abs(err - r["conservation"][path]) <= 1e-12, path
    assert set(p["throughput"]["periodic"]["fleet"]) == set(r["throughput"]["periodic"]["fleet"])
    assert validate_chrome_trace(json.loads((tmp_path / "t.json").read_text())) == []
    assert p["manifest"]["backend"] == "cpu" and p["manifest"]["versions"]["torch"] == torch.__version__
    assert "· device: `cpu` · torch " in (tmp_path / "p.md").read_text()
