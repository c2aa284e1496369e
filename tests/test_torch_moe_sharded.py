"""The MoE's expert-parallel and f-sharded bodies and ``compress_psum`` on a
mesh of ranks, against the JAX package's ``shard_map`` versions on a fake
mesh, on the CPU.

The configurations are ``tests/test_multidevice.py``'s: the reduced
qwen3-moe-235b-a22b widened to 16 experts, top 2 (the expert-parallel
branch) and the reduced mixtral-8x7b, 4 experts (the f-sharded branch), on
(data 2, model 4) and (data 1, model 4).  Each runs at capacity factor 64,
where nothing drops, on the reference test's (4, 16) input, and at
capacity factor 1 on an (8, 64) input with a shared direction, where both
packages drop the same slots (their count, from ``moe_capacity_reference``,
is above 0).  The inputs are numpy draws from a seed.  The port's cases run
in one spawn of 8 gloo ranks (``multi_rank``), the JAX package's in one
subprocess with 8 fake devices (each case under ``jax.jit``), started
before the spawn; both within
2e-5 (the reference test's bound), and ``moe_capacity_reference`` on one
device within 2e-5 of the JAX bodies.  ``compress_psum`` over the pod axis
of a (pod 2, data 4) mesh equals the JAX package's bit for bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models import moe
from repro_torch.optim import grad_compress as gc
from test_torch_x64_shim import x64_shim

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 2e-5                      # tests/test_multidevice.py's
MESHES = ((2, 4), (1, 4))       # (data, model)
CASES = (("ep", 64.0), ("ep", 1.0), ("ftp", 64.0), ("ftp", 1.0))
SKEW = 0.5


def _cfg(branch):
    if branch == "ep":
        return dataclasses.replace(get_config("qwen3-moe-235b-a22b", reduced=True),
                                   num_experts=16, experts_per_token=2)
    return get_config("mixtral-8x7b", reduced=True)


def _inputs(branch, cf):
    """numpy params and input of one case (float32)."""
    cfg = _cfg(branch)
    rng = np.random.default_rng(0 if branch == "ep" else 1)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    params = {
        "router": rng.standard_normal((d, e)) * 0.02,
        "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
        "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
        "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f),
    }
    if cf == 64.0:
        x = rng.standard_normal((4, 16, d))
    else:
        x = rng.standard_normal((8, 64, d)) + SKEW * rng.standard_normal(d)
    return {k: v.astype(np.float32) for k, v in params.items()}, x.astype(np.float32)


def _grads():
    return np.random.default_rng(5).standard_normal((8, 64)).astype(np.float32)


def _ranks_body() -> dict:
    out = {"moe": {}}
    for shape in MESHES:
        mesh = make_rank_mesh(shape)
        for branch, cf in CASES:
            if not mesh.is_member:
                continue
            cfg = _cfg(branch)
            params, x = _inputs(branch, cf)
            params, x = {k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x)
            specs = moe.moe_pspecs(cfg, mesh, x.shape)
            with shd.use_sharding(mesh):
                y, aux = moe.moe_block({k: ranks.shard(v, specs[k]) for k, v in params.items()},
                                       ranks.shard(x, specs["x"]), cfg, capacity_factor=cf)
            out["moe"][shape, branch, cf] = (ranks.unshard(y, specs["x"], mesh), float(aux))
    mesh = make_rank_mesh((2, 4), ("pod", "data"))
    g = torch.from_numpy(_grads())
    g_loc = ranks.shard(g, shd.P("pod"), mesh)
    with shd.use_sharding(mesh):
        red, err = gc.compress_psum({"g": g_loc}, gc.init_error({"g": g_loc}), "pod")
    out["compress"] = (ranks.unshard(red["g"], shd.P("pod"), mesh), ranks.unshard(err.error["g"], shd.P("pod"), mesh))
    return out


_JAX_CODE = """
import dataclasses, pickle, sys
import numpy as np
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.models import moe
from repro.optim import grad_compress as gc

with open(sys.argv[1], "rb") as fh:
    inputs, grads = pickle.load(fh)
out = {{"moe": {{}}}}
for shape in {meshes!r}:
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
    for (branch, cf), (params, x) in inputs.items():
        cfg = get_config("qwen3-moe-235b-a22b" if branch == "ep" else "mixtral-8x7b", reduced=True)
        if branch == "ep":
            cfg = dataclasses.replace(cfg, num_experts=16, experts_per_token=2)
        with shd.use_sharding(mesh):
            xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None)))
            ps = jax.device_put({{k: jnp.asarray(v) for k, v in params.items()}},
                                NamedSharding(mesh, P()))
            y, aux = jax.jit(lambda p_, x_: moe.moe_block(p_, x_, cfg, capacity_factor=cf))(ps, xs)
        out["moe"][shape, branch, cf] = (np.asarray(y), float(aux))
mesh = jax.make_mesh((2, 4), ("pod", "data"))
def body(g_loc, e_loc):
    o, e = gc.compress_psum({{"g": g_loc}}, gc.CompressState({{"g": e_loc}}), "pod")
    return o["g"], e.error["g"]
g = jnp.asarray(grads)
o, e = compat.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
                        check_vma=False)(g, jnp.zeros_like(g))
out["compress"] = (np.asarray(o), np.asarray(e))
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """The port's cases (one spawn of 8 ranks) and the JAX package's (one
    subprocess on 8 fake devices, running meanwhile)."""
    tmp = tmp_path_factory.mktemp("moe_sharded")
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(({case: _inputs(*case) for case in CASES}, _grads()), fh)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC,
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_CODE.format(meshes=MESHES)),
                             str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ours = ranks.spawn(8, _ranks_body, device="cpu", timeout_s=240)
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as fh:
        return ours, pickle.load(fh)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("branch,cf", CASES, ids=[f"{b}-cf{cf:g}" for b, cf in CASES])
def test_sharded_bodies_match_the_jax_shard_map(multi_rank, shape, branch, cf):
    ours, theirs = multi_rank
    cfg = _cfg(branch)
    assert moe._branch(cfg, shd.Mesh(shape, ("data", "model"))) == branch
    y, aux = ours["moe"][shape, branch, cf]
    jy, jaux = theirs["moe"][shape, branch, cf]
    assert y.shape == jy.shape and bool(torch.isfinite(y).all())
    err = float(np.max(np.abs(y.numpy() - jy)))
    assert err < TOL, err
    assert abs(aux - jaux) < 1e-6
    params, x = _inputs(branch, cf)
    params, x = {k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x)
    _, _, dropped = moe.moe_capacity_reference(params, x, cfg, cf, dict(zip(("data", "model"), shape)))
    if cf == 64.0:
        # nothing drops: the bodies compute the dropless oracle's function
        assert dropped == 0
        assert float((y - moe.moe_block(params, x, cfg)[0]).abs().max()) < TOL
    else:
        assert dropped > 0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("branch,cf", CASES, ids=[f"{b}-cf{cf:g}" for b, cf in CASES])
def test_capacity_reference_matches_the_jax_shard_map(multi_rank, shape, branch, cf):
    """The one-device plain version of the bodies, each rank's tokens routed
    and dropped as the bodies do, against the JAX package's sharded run."""
    _, theirs = multi_rank
    params, x = _inputs(branch, cf)
    y, aux, _ = moe.moe_capacity_reference({k: torch.from_numpy(v) for k, v in params.items()},
                                           torch.from_numpy(x), _cfg(branch), cf,
                                           dict(zip(("data", "model"), shape)))
    jy, jaux = theirs["moe"][shape, branch, cf]
    assert float(np.max(np.abs(y.numpy() - jy))) < TOL
    assert abs(float(aux) - jaux) < 1e-6


def test_compress_psum_on_pod_data_mesh_equals_the_jax_one(multi_rank):
    ours, theirs = multi_rank
    out, err = ours["compress"]
    jout, jerr = theirs["compress"]
    assert out.numpy().tobytes() == jout.tobytes()
    assert err.numpy().tobytes() == jerr.tobytes()
    g = _grads()
    exact = (g[:4] + g[4:]) / 2
    rel = float(np.max(np.abs(out.numpy()[:4] - exact)) / np.max(np.abs(exact)))
    assert rel < 0.02 and np.array_equal(out.numpy()[:4], out.numpy()[4:])


def test_capacity_and_dispatch_indices_match_jax():
    with x64_shim():
        import jax.numpy as jnp
        from repro.models import moe as jmoe

    for t, e, k, cf in ((32, 16, 2, 1.0), (128, 128, 8, 1.25), (5, 8, 2, 64.0), (64, 4, 2, 0.5)):
        assert moe._capacity(t, e, k, cf) == jmoe._capacity(t, e, k, cf)
        ids = np.random.default_rng(t).integers(0, e, (t, k))
        cap = moe._capacity(t, e, k, cf)
        flat, rank = moe._dispatch_indices(torch.from_numpy(ids), e, cap)
        jflat, jrank = jmoe._dispatch_indices(jnp.asarray(ids, dtype=jnp.int32), e, cap)
        np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    assert moe.EP_MODEL_AXIS == jmoe.EP_MODEL_AXIS
    for arch in ("mixtral-8x7b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b"):
        assert moe.uses_ep(get_config(arch)) == jmoe.uses_ep(get_config(arch))


def test_one_device_mesh_is_the_dropless_dispatch_and_no_sharding_raises():
    cfg = _cfg("ftp")
    params, x = _inputs("ftp", 64.0)
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    x = torch.from_numpy(x)
    want = moe.moe_block(params, x, cfg)[0]
    with shd.use_sharding(make_rank_mesh((1, 1))):
        got = moe.moe_block(params, x, cfg, capacity_factor=0.01)[0]
    assert torch.equal(got, want)
    # 4 experts on a 3-wide model axis, d_ff not divisible by 3 either
    with pytest.raises(ValueError, match="no MoE sharding"):
        moe.moe_pspecs(dataclasses.replace(cfg, d_ff=128), shd.Mesh((1, 3), ("data", "model")), x.shape)
