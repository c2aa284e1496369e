"""The ``enable_x64`` shim the parity files load the JAX package under.

Under jax 0.9.0 ``from jax.experimental import enable_x64`` is gone while
``jax.enable_x64`` remains, so the JAX package does not import without the
old name (ROADMAP C-ref-1).  Importing this module sets the old name to
``jax.enable_x64`` for the rest of the process.  The parity files import
it, and pytest collects every test file in every xdist worker before the
worker runs its first test, so every worker holds the name from the start
of its run: a JAX-package test that imports the name lazily
(``repro.testing.perf_regression.measure_scan_rate``) sees the same jax
whichever worker runs it and whatever ran there before.  Parity files
import the reference inside ``with x64_shim():``, which sets the name
where a test file was run without this module having been imported.
"""
import contextlib
import importlib

import jax
import jax.experimental
import pytest

#: the JAX package's modules that import ``enable_x64`` at module level
X64_MODULES = (
    "repro.core.arrivals",
    "repro.core.batch_eval",
    "repro.core.pareto",
    "repro.fleet.dtypes",
    "repro.fleet.state",
    "repro.fleet.step",
    "repro.fleet.shard",
    "repro.mc.ensemble",
    "repro.mc.sensitivity",
    "repro.optimize.relax",
    "repro.optimize.descent",
    "repro.policy.rollout",
    "repro.policy.train",
    "repro.control.hierarchy",
    "repro.control.simulate",
)

#: the JAX package's functions that import ``enable_x64`` when called
X64_LAZY = (
    ("repro.obs.metrics", "scan_histogram"),
    ("repro.testing.perf_regression", "measure_scan_rate"),
)


def install():
    """Set ``jax.experimental.enable_x64`` where the installed jax lacks it."""
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64


install()


@contextlib.contextmanager
def x64_shim():
    """The block runs with ``jax.experimental.enable_x64`` set."""
    install()
    yield


def test_importing_the_shim_sets_the_name_for_good():
    from jax.experimental import enable_x64

    with x64_shim():
        pass
    assert jax.experimental.enable_x64 is enable_x64
    with enable_x64():
        assert jax.numpy.zeros(1, dtype=jax.numpy.float64).dtype == jax.numpy.float64


def test_the_name_stays_after_a_raise_inside_the_block():
    with pytest.raises(KeyError):
        with x64_shim():
            raise KeyError("inside")
    from jax.experimental import enable_x64  # noqa: F401


@pytest.mark.parametrize("name", X64_MODULES)
def test_each_module_that_takes_the_name_at_import_imports(name):
    assert importlib.import_module(name).__name__ == name


@pytest.mark.parametrize("module,func", X64_LAZY, ids=[f for _, f in X64_LAZY])
def test_each_function_that_takes_the_name_when_called_resolves_it(module, func):
    fn = getattr(importlib.import_module(module), func)
    if func == "measure_scan_rate":
        assert fn(n_steps=64, reps=1) > 0
    else:
        import numpy as np

        vals = np.array([[0.5, 5.0], [50.0, 500.0]])
        assert fn(vals, [1.0, 10.0, 100.0]).tolist() == [1, 1, 1, 1]
