"""The port's batched arrival sampling (``ArrivalProcess.sample_gaps`` /
``sample_batch`` and the six processes' draw and transform stages) against
the JAX package, and its own generator's streams against the statistical
checks ``tests/test_arrivals_stats.py`` holds the reference to.

Fed ``jax.random``'s own draws (as numpy), every process's gaps equal the
reference's exactly — deterministic, jittered, Poisson, MMPP and flash
crowd — except the diurnal process, whose ``sin`` (torch's against XLA's)
and whose compiled scan (which may multiply by ``1/day_ms`` where the port
divides) leave it within 1e-12 relative."""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import arrivals as pa
from test_torch_x64_shim import x64_shim

N_DEV, N_GAPS = 48, 120

PROCESSES = {
    "deterministic": ("DeterministicArrivals", dict(period_ms=40.0)),
    "jittered": ("JitteredArrivals", dict(period_ms=40.0, jitter=0.2)),
    "poisson": ("PoissonArrivals", dict(mean_ms=40.0)),
    "mmpp": ("MMPPArrivals", dict(burst_ms=5.0, quiet_ms=200.0, mean_burst_len=6.0, mean_quiet_len=2.0)),
    "diurnal": ("DiurnalArrivals", dict(mean_ms=40.0, day_ms=3000.0, amplitude=0.6)),
    "diurnal_bursts": ("DiurnalArrivals", dict(mean_ms=40.0, day_ms=3000.0, amplitude=0.6,
                                               burst_ms=4.0, mean_burst_len=5.0)),
    "flash_crowd": ("FlashCrowdArrivals", dict(quiet_ms=100.0, flash_gap_ms=2.0, flash_len=8,
                                               flash_every=3.0)),
}
#: relative tolerance by process: exact, except where sin enters
REL = {"diurnal": 1e-12, "diurnal_bursts": 1e-12}

CHI2_999 = {9: 27.877}


@pytest.fixture(scope="module")
def jref():
    """The JAX package's arrivals module, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        from repro.core import arrivals

    return arrivals


def _jax_draws(name: str, key, n_devices: int, n_gaps: int) -> tuple:
    """The draws the reference's ``_batch_gaps`` consumes for ``key``."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64():
        if name == "deterministic":
            return (np.zeros((n_devices, n_gaps)),)
        if name == "jittered":
            return (np.array(jax.random.normal(key, (n_devices, n_gaps), dtype=jnp.float64)),)
        if name == "poisson":
            return (np.array(jax.random.exponential(key, (n_devices, n_gaps), dtype=jnp.float64)),)
        k1, k2 = jax.random.split(key)
        return (np.array(jax.random.exponential(k1, (n_gaps, n_devices), dtype=jnp.float64)),
                np.array(jax.random.uniform(k2, (n_gaps, n_devices), dtype=jnp.float64)))


def _procs(jref, name):
    cls, kw = PROCESSES[name]
    return getattr(pa, cls)(**kw), getattr(jref, cls)(**kw)


@pytest.mark.parametrize("name", sorted(PROCESSES))
def test_gaps_from_the_same_draws_equal_the_reference(jref, name):
    import jax

    ours, ref = _procs(jref, name)
    key = jax.random.PRNGKey(11)
    with jax.enable_x64():
        want = np.asarray(ref._batch_gaps(key, N_DEV, N_GAPS))
    draws = tuple(torch.from_numpy(d) for d in _jax_draws(name, key, N_DEV, N_GAPS))
    got = ours._gaps_from_draws(*draws)
    assert got.dtype == torch.float64 and tuple(got.shape) == (N_DEV, N_GAPS)
    if name in REL:
        np.testing.assert_allclose(got.numpy(), want, rtol=REL[name], atol=0)
    else:
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("include_origin", [True, False])
@pytest.mark.parametrize("name", ["poisson", "mmpp", "flash_crowd"])
def test_sample_batch_from_the_same_draws_equals_the_reference(jref, monkeypatch, name, include_origin):
    """Padding, origin and horizon as the reference's ``sample_batch``.  The
    times are a cumsum of equal gaps: torch sums a row in order, JAX's
    cumsum (a parallel scan, on the CPU too) in another, so times agree
    within 1e-14 relative, and a binned count may move only for an arrival
    within 1e-9 ms of a tick edge."""
    import jax

    ours, ref = _procs(jref, name)
    key = jax.random.PRNGKey(5)
    horizon, m = 2500.0, 64
    want = np.asarray(ref.sample_batch(key, N_DEV, horizon, max_arrivals=m,
                                       include_origin=include_origin))
    n_gaps = m - 1 if include_origin else m
    draws = tuple(torch.from_numpy(d) for d in _jax_draws(name, key, N_DEV, n_gaps))
    monkeypatch.setattr(type(ours), "_draws", lambda self, g, n, k: draws)
    got = ours.sample_batch(torch.Generator(), N_DEV, horizon, max_arrivals=m,
                            include_origin=include_origin).numpy()
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-14, atol=0)
    counts = pa.bin_arrival_counts(torch.from_numpy(got), horizon, 40.0).numpy()
    moved = counts != np.asarray(jref.bin_arrival_counts(want, horizon, 40.0))
    if moved.any():
        edge_dist = np.abs(want[finite] - 40.0 * np.round(want[finite] / 40.0))
        assert np.sum(moved) <= 2 * np.sum(edge_dist < 1e-9)


@pytest.mark.parametrize("name", sorted(PROCESSES))
def test_one_seed_gives_the_same_batch_twice(name):
    cls, kw = PROCESSES[name]
    proc = getattr(pa, cls)(**kw)
    a = proc.sample_batch(torch.Generator().manual_seed(3), 8, 3000.0)
    b = proc.sample_batch(torch.Generator().manual_seed(3), 8, 3000.0)
    c = proc.sample_batch(torch.Generator().manual_seed(4), 8, 3000.0)
    assert torch.equal(a, b)
    assert (a[:, 0] == 0).all() and (torch.isinf(a) | (a < 3000.0)).all()
    assert name == "deterministic" or not torch.equal(a, c)


def test_sample_validation():
    proc = pa.PoissonArrivals(40.0)
    g = torch.Generator()
    with pytest.raises(ValueError, match="n_streams"):
        proc.sample_gaps(g, 0, 4)
    with pytest.raises(ValueError, match="n_gaps"):
        proc.sample_gaps(g, 2, -1)
    with pytest.raises(ValueError, match="n_devices"):
        proc.sample_batch(g, 0, 100.0)
    with pytest.raises(ValueError, match="horizon"):
        proc.sample_batch(g, 2, 0.0)
    with pytest.raises(ValueError, match="max_arrivals"):
        proc.sample_batch(g, 2, 100.0, max_arrivals=0)
    with pytest.raises(NotImplementedError, match="no vectorized batch sampler"):
        pa.TraceArrivals((1.0, 2.0)).sample_gaps(g, 2, 3)


# ---------------------------------------------------------------------------
# the port's own generator against tests/test_arrivals_stats.py's checks
# ---------------------------------------------------------------------------
def _gaps(proc, n_streams, n_gaps, seed) -> np.ndarray:
    return proc.sample_gaps(torch.Generator().manual_seed(seed), n_streams, n_gaps).numpy()


def _chi2_exponential(g: np.ndarray, mean: float) -> float:
    q = np.linspace(0.0, 1.0, 11)
    edges = np.append(-mean * np.log1p(-q[:-1]), np.inf)
    counts, _ = np.histogram(g, bins=edges)
    expected = 0.1 * g.size
    return float(np.sum((counts - expected) ** 2 / expected))


@pytest.mark.parametrize("seed", [0, 1])
def test_poisson_mean_variance_and_chi_square(seed):
    mean = 40.0
    g = _gaps(pa.PoissonArrivals(mean), 256, 400, seed).ravel()
    assert abs(g.mean() - mean) < 4.0 * mean / math.sqrt(g.size)
    assert abs(g.var(ddof=1) - mean**2) < 5.0 * mean**2 * math.sqrt(8.0 / g.size)
    assert _chi2_exponential(g, mean) < CHI2_999[9]
    assert g.std() / g.mean() == pytest.approx(1.0, abs=0.02)


def test_poisson_binned_counts_are_poisson_dispersed():
    t = pa.PoissonArrivals(25.0).sample_batch(torch.Generator().manual_seed(4), 64, 50_000.0,
                                              include_origin=False)
    c = pa.bin_arrival_counts(t, 50_000.0, 500.0).numpy().ravel()
    assert c.var(ddof=1) / c.mean() == pytest.approx(1.0, abs=5.0 * math.sqrt(2.0 / c.size) + 0.02)


def test_mmpp_rate_and_burstiness():
    burst, quiet, lb, lq = 5.0, 500.0, 8.0, 2.0
    proc = pa.MMPPArrivals(burst, quiet, mean_burst_len=lb, mean_quiet_len=lq)
    g = _gaps(proc, 512, 400, 6).ravel()
    assert g.mean() == pytest.approx(proc.mean_period_ms(), rel=0.05)
    pb = lb / (lb + lq)
    m1 = pb * burst + (1 - pb) * quiet
    m2 = pb * 2.0 * burst**2 + (1 - pb) * 2.0 * quiet**2
    cv2 = g.var(ddof=1) / g.mean() ** 2
    assert cv2 == pytest.approx(m2 / m1**2 - 1.0, rel=0.2) and cv2 > 1.5


def test_deterministic_and_zero_jitter_have_zero_variance():
    for proc in (pa.DeterministicArrivals(40.0), pa.JitteredArrivals(40.0, 0.0)):
        g = _gaps(proc, 32, 200, 0)
        assert float(g.var()) == 0.0 and np.all(g == 40.0)


def test_jittered_matches_the_requested_noise():
    from statistics import NormalDist

    g = _gaps(pa.JitteredArrivals(40.0, 0.05), 256, 400, 9).ravel()
    assert g.mean() == pytest.approx(40.0, rel=0.005)
    assert g.std() == pytest.approx(2.0, rel=0.05)
    g = _gaps(pa.JitteredArrivals(40.0, 0.2), 256, 400, 10).ravel()
    nd = NormalDist(mu=40.0, sigma=8.0)
    edges = np.array([-np.inf] + [nd.inv_cdf(k / 10) for k in range(1, 10)] + [np.inf])
    counts, _ = np.histogram(g, bins=edges)
    assert float(np.sum((counts - 0.1 * g.size) ** 2 / (0.1 * g.size))) < CHI2_999[9]


def test_diurnal_stationary_limit_and_day_cycle():
    g = _gaps(pa.DiurnalArrivals(40.0, day_ms=1e6, amplitude=0.0), 256, 400, 0).ravel()
    assert _chi2_exponential(g, 40.0) < CHI2_999[9]
    day = 2000.0
    t = np.cumsum(_gaps(pa.DiurnalArrivals(10.0, day_ms=day, amplitude=0.75), 64, 400, 1), axis=1)
    frac = (t / day) % 1.0
    assert 2.0 < int(np.sum(frac < 0.5)) / int(np.sum(frac >= 0.5)) < 4.0


def test_flash_crowd_mean_and_flash_fraction():
    proc = pa.FlashCrowdArrivals(quiet_ms=4000.0, flash_gap_ms=5.0, flash_len=16, flash_every=8.0)
    g = _gaps(proc, 256, 400, 5).ravel()
    assert g.mean() == pytest.approx(proc.mean_period_ms(), rel=0.05)
    assert float(np.mean(g < 100.0)) == pytest.approx(16.0 / 24.0, abs=0.03)
