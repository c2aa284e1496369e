"""The port's training scaffolding against the JAX package, on the CPU:
``PerfConfig``, the sharding rule table and its specs, the meshes, the LM
data stream and its modality adapters, ``shard_batch``, int8 gradient
compression with error feedback, and AdamW over nested parameter trees."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch, shard_batch
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import chips, make_host_mesh, make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw, grad_compress as gc


@pytest.fixture(scope="session")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` (imported by ``repro.core.arrivals``)
    is gone but ``jax.enable_x64`` remains."""
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import repro.compat
    import repro.configs
    import repro.configs.perf
    import repro.data.pipeline
    import repro.distributed.sharding
    import repro.optim
    from repro.models import model_zoo

    return dict(
        compat=repro.compat, configs=repro.configs, perf=repro.configs.perf,
        data=repro.data.pipeline, shd=repro.distributed.sharding, optim=repro.optim,
        zoo=model_zoo,
    )


# ---------------------------------------------------------------------------
# PerfConfig
# ---------------------------------------------------------------------------
KERNEL_CHOICES = ("attention_impl", "ssd_impl", "attn_scores_dtype", "attn_triangular")


def test_perf_config_has_the_reference_fields_and_defaults(jref):
    """The reference's fields and defaults, but its kernel choices."""
    ref = jref["perf"].BASELINE
    assert [f.name for f in dataclasses.fields(PerfConfig)] == [
        f.name for f in dataclasses.fields(type(ref)) if f.name not in KERNEL_CHOICES
    ]
    want = {k: v for k, v in dataclasses.asdict(ref).items() if k not in KERNEL_CHOICES}
    assert dataclasses.asdict(BASELINE) == want


@pytest.mark.parametrize("field,value", [
    ("attention_impl", "xla"), ("attention_impl", "ref"), ("attention_impl", "pallas"),
    ("attention_impl", "xla_flash"), ("ssd_impl", "ref"), ("ssd_impl", "chunked"),
    ("attn_scores_dtype", "bfloat16"), ("attn_triangular", True),
])
def test_perf_config_kernel_fields_route_nothing_to_a_plain_version(field, value):
    with pytest.raises(TypeError, match=field):
        PerfConfig(**{field: value})


@pytest.mark.parametrize("over", [{"remat": "offload"}, {"optimizer_moment_dtype": "float16"},
                                  {"num_microbatches": 0}, {"loss_chunk": 0}])
def test_perf_config_rejects_unknown_levers(over):
    with pytest.raises(ValueError):
        PerfConfig(**over)


# ---------------------------------------------------------------------------
# The rule table and its specs
# ---------------------------------------------------------------------------
def test_rule_table_is_the_reference_s(jref):
    assert shd.DEFAULT_RULES == jref["shd"].DEFAULT_RULES


def _both_meshes(jref, sizes, names):
    return jref["compat"].abstract_mesh(sizes, names), shd.Mesh(sizes, names)


SPEC_CASES = [
    # tests/test_data_and_sharding.py::TestLogicalSharding
    (("embed", "vocab"), (1280, 504)),      # vocab 504 drops the model axis
    (("embed", "vocab"), (1280, 512)),
    (("cache_batch", "long_cache_seq"), (16, 64)),   # 'data' used once
    (("batch", None, "act_vocab"), (16, 8, 32)),
    (("layers", "embed", "mlp"), (28, 2048, 6144)),
    (("expert", "expert_in", "mlp"), (8, 4096, 14336)),
    (("batch", "act_seq", None), (3, 5, 7)),
    ((None, None), None),
    (("norm",), (2048,)),
]


@pytest.mark.parametrize("sizes,names", [((16, 16), ("data", "model")),
                                         ((2, 16, 16), ("pod", "data", "model")),
                                         ((4, 2), ("data", "model"))])
@pytest.mark.parametrize("axes,shape", SPEC_CASES)
def test_logical_to_pspec_equals_the_reference(jref, sizes, names, axes, shape):
    jmesh, mesh = _both_meshes(jref, sizes, names)
    want = jref["shd"].logical_to_pspec(axes, mesh=jmesh, shape=shape)
    got = shd.logical_to_pspec(axes, mesh=mesh, shape=shape)
    assert isinstance(got, tuple) and got == want and want == got


def test_duplicate_axis_dropped():
    spec = shd.logical_to_pspec(("cache_batch", "long_cache_seq"),
                                mesh=make_production_mesh(), shape=(16, 64))
    names = []
    for x in spec:
        if x is not None:
            names.extend(x) if isinstance(x, tuple) else names.append(x)
    assert len(names) == len(set(names))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_pspecs_equal_the_reference_for_every_arch(jref, multi_pod):
    sizes, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else ((16, 16), ("data", "model"))
    jmesh, mesh = _both_meshes(jref, sizes, names)
    for arch in list_archs():
        want = jref["zoo"].param_pspecs(jref["configs"].get_config(arch), jmesh)
        got = zoo.param_pspecs(get_config(arch), mesh)
        flat_w = {jax.tree_util.keystr(p): tuple(s) for p, s in
                  jax.tree_util.tree_flatten_with_path(
                      want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        flat_g = {}

        def walk(t, pre):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, pre + f"['{k}']")
                else:
                    flat_g[pre + f"['{k}']"] = tuple(v)
        walk(got, "")
        assert flat_g == flat_w, arch


def test_param_pspecs_on_the_host_mesh_equal_the_reference_s_on_1x1(jref):
    """A 1×1 mesh divides every dimension: the specs name its size-1 axes,
    as the reference's do, and shard nothing."""
    jmesh = jref["compat"].abstract_mesh((1, 1), ("data", "model"))
    cfg = get_config("qwen3-1.7b", reduced=True)
    want = jref["zoo"].param_pspecs(jref["configs"].get_config("qwen3-1.7b", reduced=True), jmesh)
    got = zoo.param_pspecs(cfg, make_host_mesh("cpu"))
    assert got["periods"]["pos0"]["attn"]["wq"] == want["periods"]["pos0"]["attn"]["wq"]
    assert got["embed"] == want["embed"] == ("model", "data")


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("call", [
    lambda m: m.axis_size("fleet_device"), lambda m: m.axis_size("embed"),
    lambda m: m.divisible(12, "vocab"),
])
def test_axis_size_and_divisible_raise_the_reference_s_error_without_a_mesh(jref, call):
    assert _raised(lambda: call(shd)) == _raised(lambda: call(jref["shd"]))
    assert "use_sharding" in _raised(lambda: call(shd))


def test_axis_size_error_names_the_axis():
    with pytest.raises(ValueError, match=r"axis_size\('fleet_device'\)"):
        shd.axis_size("fleet_device")
    with pytest.raises(ValueError, match=r"divisible\(dim=12, logical='vocab'\)"):
        shd.divisible(12, "vocab")


def test_axis_size_with_explicit_and_installed_meshes(jref):
    jmesh, mesh = _both_meshes(jref, (4, 2), ("data", "model"))
    for logical in ("embed", "vocab", "batch", "no_such_logical_axis", "layers"):
        assert shd.axis_size(logical, mesh) == jref["shd"].axis_size(logical, jmesh)
        for dim in (7, 12, 13):
            assert shd.divisible(dim, logical, mesh) == jref["shd"].divisible(dim, logical, jmesh)
    with shd.use_sharding(mesh):
        assert shd.current_mesh() is mesh
        assert shd.axis_size("vocab") == 2 and shd.divisible(10, "vocab")
    assert shd.current_mesh() is None


def test_constrain_is_the_identity_on_one_device_and_raises_beyond():
    """On a mesh of more devices ``constrain`` asserts the block's shape:
    the identity on the block ``logical_to_pspec`` implies, ``ValueError``
    on any other and without the global shape."""
    x = torch.ones(4, 4)
    assert shd.constrain(x, ("batch", None)) is x
    with shd.use_sharding(make_host_mesh("cpu")):
        assert shd.constrain(x, ("batch", None)) is x
    with shd.use_sharding(make_production_mesh()):
        assert shd.constrain(x, ("batch", None), shape=(64, 4)) is x          # 64 rows over data 16
        assert shd.constrain(x, ("batch", "act_vocab"), shape=(64, 64)) is x  # and 64 columns over model 16
        with pytest.raises(ValueError, match=r"is \(4, 1\), got \(4, 4\)"):
            shd.constrain(x, ("batch", "act_vocab"), shape=(64, 16))
        with pytest.raises(ValueError, match="needs the global shape"):
            shd.constrain(x, ("batch", None))


def test_meshes():
    host = make_host_mesh("cpu")
    assert host.axis_names == ("data", "model") and host.shape == {"data": 1, "model": 1}
    assert host.device == torch.device("cpu") and chips(host) == 1
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and chips(single) == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and chips(multi) == 512
    assert single.device is None


def test_host_mesh_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
def test_stream_batches_equal_the_reference_s(jref):
    ours = SyntheticLMStream(1000, 4, 16, seed=7)
    theirs = jref["data"].SyntheticLMStream(1000, 4, 16, seed=7)
    for _ in range(5):
        a, b = ours.next_batch(), theirs.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    assert ours.state() == theirs.state()


def test_stream_resume_exact():
    a = SyntheticLMStream(100, 4, 16, seed=7)
    for _ in range(5):
        a.next_batch()
    state = a.state()
    want = a.next_batch()["tokens"]
    b = SyntheticLMStream(100, 4, 16, seed=0)
    b.restore(state)
    np.testing.assert_array_equal(b.next_batch()["tokens"], want)
    c = SyntheticLMStream(100, 4, 16)
    assert not np.array_equal(c.next_batch()["tokens"], c.next_batch()["tokens"])


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", list_archs())
def test_batch_for_arch_equals_the_reference_s(jref, arch, reduced):
    cfg, jcfg = get_config(arch, reduced=reduced), jref["configs"].get_config(arch, reduced=reduced)
    seq = 640 if cfg.frontend == "vision" else 64      # llava's 576 patches fit
    raw = SyntheticLMStream(max(cfg.vocab_size, 2), 2, seq, seed=3).next_batch()
    ours, theirs = batch_for_arch(cfg, raw), jref["data"].batch_for_arch(jcfg, raw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
        assert ours[k].dtype == theirs[k].dtype
    if cfg.frontend == "audio":
        assert ours["labels"].max() < cfg.vocab_size


def test_shard_batch_places_the_batch_on_the_mesh_device():
    raw = batch_for_arch(get_config("llava-next-mistral-7b", reduced=True),
                         SyntheticLMStream(1000, 2, 32).next_batch())
    placed = shard_batch(raw, make_host_mesh("cpu"))
    for k, v in raw.items():
        assert placed[k].device.type == "cpu"
        np.testing.assert_array_equal(placed[k].numpy(), v)
    # a rank of a (pod 2, data 2, model 2) mesh at (1, 0, 1): rows 4-5 of 8
    # (block 2 of 4 over (pod, data)), all 2 rows where 4 do not divide them
    rank_mesh = shd.Mesh((2, 2, 2), ("pod", "data", "model"), device=torch.device("cpu"), coordinate=(1, 0, 1))
    placed = shard_batch(raw, rank_mesh)
    for k, v in raw.items():
        np.testing.assert_array_equal(placed[k].numpy(), v)
    wide = {"tokens": np.arange(8 * 3, dtype=np.int32).reshape(8, 3)}
    np.testing.assert_array_equal(shard_batch(wide, rank_mesh)["tokens"].numpy(), wide["tokens"][4:6])
    np.testing.assert_array_equal(
        shard_batch(wide, rank_mesh, pspecs={"tokens": shd.P("model")})["tokens"].numpy(), wide["tokens"][4:])
    assert shard_batch(raw, make_production_mesh()) is None          # a descriptor: no block here


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-4, 3e-2, 1.0, 7.5, 1e4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_dequantize_bit_for_bit(jref, scale, seed):
    x = (np.random.default_rng(seed).standard_normal(257) * scale).astype(np.float32)
    q, s = gc.quantize(torch.from_numpy(x))
    jq, js = jref["optim"].quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.dtype == torch.float32 and s.numpy().tobytes() == np.asarray(js).tobytes()
    back, jback = gc.dequantize(q, s), jref["optim"].dequantize(jq, js)
    assert back.numpy().tobytes() == np.asarray(jback).tobytes()
    assert float(torch.max(torch.abs(torch.from_numpy(x) - back))) <= float(s) * 0.5 * (1 + 1e-4) + 1e-12


def test_quantize_an_all_zero_tensor():
    q, s = gc.quantize(torch.zeros(8))
    assert float(s) == pytest.approx(1e-12 / 127.0) and not q.any()


def test_error_feedback_unbiased_over_steps(jref):
    """tests/test_optim.py::TestQuantize's loop, through ``error_feedback``,
    equal to the reference's quantize/dequantize loop bit for bit."""
    g = {"w": torch.full((16,), 0.001)}
    err = gc.init_error(g)
    assert err.error["w"].dtype == torch.float32 and not err.error["w"].any()
    total = torch.zeros(16)
    jerr, jtotal = jnp.zeros((16,)), jnp.zeros((16,))
    jq, jdq = jref["optim"].quantize, jref["optim"].dequantize
    for _ in range(100):
        deq, err = gc.error_feedback(g, err)
        total = total + deq["w"]
        carry = jnp.full((16,), 0.001) + jerr
        jd = jdq(*jq(carry))
        jerr, jtotal = carry - jd, jtotal + jd
    np.testing.assert_allclose(total.numpy(), np.full(16, 0.1), rtol=0.02)
    assert total.numpy().tobytes() == np.asarray(jtotal).tobytes()
    assert err.error["w"].numpy().tobytes() == np.asarray(jerr).tobytes()


def test_compress_psum_waits_for_the_multi_rank_slice():
    """``compress_psum`` needs a mesh with the axis (its multi-rank runs are
    in ``tests/test_torch_moe_sharded.py``); over a pod axis of size 1 it
    is the error feedback alone."""
    g = {"w": torch.linspace(-1.0, 2.0, 9)}
    with pytest.raises(ValueError, match="needs a mesh with that axis"):
        gc.compress_psum(g, gc.init_error(g), "pod")
    with shd.use_sharding(make_host_mesh("cpu")):
        with pytest.raises(ValueError, match="needs a mesh with that axis"):
            gc.compress_psum(g, gc.init_error(g), "pod")
    mesh = shd.Mesh((1, 2), ("pod", "data"))
    out, err = gc.compress_psum(g, gc.init_error(g), "pod", mesh)
    want, want_err = gc.error_feedback(g, gc.init_error(g))
    assert torch.equal(out["w"], want["w"]) and torch.equal(err.error["w"], want_err.error["w"])


# ---------------------------------------------------------------------------
# AdamW over nested trees
# ---------------------------------------------------------------------------
def test_bf16_moments_shard_like_params(jref):
    """tests/test_optim.py::test_bf16_moments_shard_like_params, on a
    model's nested tree: moments mirror the tree in bf16."""
    params = zoo.init_params(get_config("mamba2-370m", reduced=True),
                             torch.Generator().manual_seed(0), dtype=torch.float32)
    state = adamw(moment_dtype=torch.bfloat16).init(params)
    ps, ms = dict(_paths(params)), dict(_paths(state.m))
    assert ps.keys() == ms.keys()
    for k, p in ps.items():
        assert ms[k].dtype == torch.bfloat16 and ms[k].shape == p.shape
    specs = zoo.param_pspecs(get_config("mamba2-370m", reduced=True), make_production_mesh())
    assert dict(_paths(specs)).keys() == ps.keys()


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}" if pre else k)
    else:
        yield pre, tree


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_adamw_nested_equals_flat_path_keys(moments):
    gen = torch.Generator().manual_seed(1)
    nested = {"a": {"x": torch.randn(3, 4, generator=gen), "y": torch.randn(5, generator=gen)},
              "b": torch.randn(2, generator=gen)}
    grads = {"a": {"x": torch.randn(3, 4, generator=gen), "y": torch.randn(5, generator=gen)},
             "b": torch.randn(2, generator=gen)}
    flat = {k: v.clone() for k, v in _paths(nested)}
    flat_grads = dict(_paths(grads))
    opt = adamw(moment_dtype=moments)
    s_nested, s_flat = opt.init(nested), opt.init(flat)
    for _ in range(3):
        nested, s_nested, n1 = opt.update(grads, s_nested, nested, 1e-2)
        flat, s_flat, n2 = opt.update(flat_grads, s_flat, flat, 1e-2)
        assert torch.equal(n1, n2)
    # nested grads against a flat path-keyed grads dict: the same update
    for k, v in _paths(nested):
        assert torch.equal(v, flat[k])
    for k, v in _paths(s_nested.m):
        assert torch.equal(v, s_flat.m[k]) and v.dtype == moments
    assert s_nested.step == 3


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_nested_equals_the_reference(jref, moments):
    """Three updates of a nested tree against the reference's eager AdamW,
    the moments kept in fp32 or bf16."""
    rng = np.random.default_rng(5)
    p0 = {"layer": {"w": rng.standard_normal((6, 4)).astype(np.float32),
                    "b": rng.standard_normal(4).astype(np.float32)},
          "head": rng.standard_normal((4, 3)).astype(np.float32)}
    gs = [{"layer": {"w": rng.standard_normal((6, 4)).astype(np.float32),
                     "b": rng.standard_normal(4).astype(np.float32)},
           "head": rng.standard_normal((4, 3)).astype(np.float32)} for _ in range(3)]
    tmap = lambda f, t: {k: tmap(f, v) for k, v in t.items()} if isinstance(t, dict) else f(t)
    params = tmap(torch.from_numpy, tmap(np.copy, p0))
    opt = adamw(moment_dtype=getattr(torch, moments))
    jopt = jref["optim"].adamw(moment_dtype=getattr(jnp, moments))
    state, jp = opt.init(params), tmap(jnp.asarray, p0)
    jstate = jopt.init(jp)
    with jax.disable_jit():
        for g in gs:
            params, state, norm = opt.update(tmap(torch.from_numpy, g), state, params, 1e-2)
            jp, jstate, jnorm = jopt.update(tmap(jnp.asarray, g), jstate, jp, 1e-2)
            assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    want = dict(_paths(tmap(np.asarray, jp)))
    for k, v in _paths(params):
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6 * np.abs(want[k]).max())
    for tree, jtree in ((state.m, jstate.m), (state.v, jstate.v)):
        theirs = dict(_paths(tmap(lambda a: np.asarray(a, np.float32), jtree)))
        for k, v in _paths(tree):
            assert v.dtype == getattr(torch, moments)
            np.testing.assert_allclose(v.float().numpy(), theirs[k], rtol=0,
                                       atol=(2.0 ** -8 if moments == "bfloat16" else 1e-6) * np.abs(theirs[k]).max())
