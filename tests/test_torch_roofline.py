"""The roofline counter (``launch/roofline.py``) against the reference's
HLO parser, on the CPU and the ``meta`` device.

``RooflineTerms`` is the reference's arithmetic on the card's ceilings.
The counter's FLOPs equal ``repro.launch.roofline.parse_hlo_costs`` on the
conformance modules of ``tests/test_roofline_conformance.py`` (the
matmul, the attention pair through the flash op and its plain version, the
LSTM, the SSD and dequant, exactly) and its bytes are no lower than
``costs/counts.py``'s; a reduced dense cell's prefill and decode FLOPs on a
1×1 mesh equal the reference's HLO count of the same single-device
lowering, and a rank's FLOPs on a (2, 2) mesh are a quarter of them; three
full-width cells of qwen3-1.7b on the 16×16 mesh are counted on ``meta``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.costs.counts import attention_counts, dequant_counts, lstm_counts, matmul_counts, ssd_counts
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels.dequant import ops as dq
from repro_torch.kernels.dequant.ref import dequantize_blocked_reference
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.lstm import ops as lstm_ops
from repro_torch.kernels.lstm.ref import lstm_reference
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_recurrent_reference
from repro_torch.launch import dryrun_lib
from repro_torch.launch import roofline as rf
from test_torch_x64_shim import x64_shim


@pytest.fixture(scope="module")
def jref():
    with x64_shim():
        from repro.configs import base
        from repro.configs import get_config as jget
        from repro.kernels.dequant.ref import dequantize_blocked_reference as jdequant
        from repro.kernels.lstm.ref import lstm_reference as jlstm
        from repro.kernels.ssd.ref import ssd_recurrent_reference as jssd
        from repro.launch import roofline as jroof
        from repro.models import decoder as jdecoder
        from repro.models import model_zoo as jzoo

    return dict(base=base, get=jget, dequant=jdequant, lstm=jlstm, ssd=jssd, roof=jroof, decoder=jdecoder, zoo=jzoo)


def _hlo(jref, fn, *args):
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return jref["roof"].parse_hlo_costs(txt)


def _sds(*shapes, dtype=jnp.float32):
    return [jax.ShapeDtypeStruct(s, dtype) for s in shapes]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# RooflineTerms
# ---------------------------------------------------------------------------
def test_roofline_terms_arithmetic_on_the_cards_ceilings(jref):
    """The reference's ``TestRooflineTerms`` case, its 1 s / 2 s / 0.5 s
    terms set on the H100's ceilings."""
    t = rf.RooflineTerms(
        flops_per_device=rf.PEAK_FLOPS_BF16,          # 1 s compute
        bytes_per_device=rf.HBM_BW * 2,               # 2 s memory
        collective_bytes_per_device=rf.GLOO_HOST_STAGED_BW * 0.5,
        chips=256,
        model_flops=rf.PEAK_FLOPS_BF16 * 256,         # perfect-efficiency model
    )
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(2.0)
    assert t.collective_s == pytest.approx(0.5)
    assert t.dominant == "memory"
    assert t.step_time_lower_bound_s == pytest.approx(2.0)
    assert t.useful_flops_fraction == pytest.approx(1.0)
    assert t.mfu_bound == pytest.approx(0.5)   # 1 s useful / 2 s bound
    theirs = jref["roof"].RooflineTerms(197e12, 819e9 * 2, 50e9 * 0.5, 256, 197e12 * 256)
    assert t.to_dict().keys() == theirs.to_dict().keys()
    for key in ("compute_s", "memory_s", "collective_s", "dominant", "step_time_lower_bound_s",
                "useful_flops_fraction", "mfu_bound"):
        assert t.to_dict()[key] == pytest.approx(theirs.to_dict()[key]), key
    fp32 = rf.RooflineTerms(rf.PEAK_FLOPS_FP32, 0.0, 0.0, 1, peak_flops=rf.peak_flops(torch.float32))
    assert fp32.compute_s == pytest.approx(1.0) and fp32.dominant == "compute"
    assert (rf.PEAK_FLOPS_BF16, rf.PEAK_FLOPS_FP32, rf.HBM_BW) == (989e12, 67e12, 3.35e12)


# ---------------------------------------------------------------------------
# The counter against the reference's HLO parser
# ---------------------------------------------------------------------------
def test_matmul_flops_equal_the_parser(jref):
    m, k, n = 16, 32, 24
    theirs = _hlo(jref, lambda a, b: a @ b, *_sds((m, k), (k, n)))
    _, ours = rf.count(torch.matmul, _meta(m, k), _meta(k, n))
    assert ours.flops == theirs.flops == matmul_counts(m, k, n).flops
    assert ours.hbm_bytes >= matmul_counts(m, k, n, dtype_bytes=4).hbm_bytes


@pytest.mark.parametrize("path", ["flash op", "plain version"])
def test_attention_pair_flops_equal_the_parser(jref, path):
    b, s, h, d = 1, 32, 2, 8

    def pair(q, k, v):
        p = jax.nn.softmax(jnp.einsum("bshd,bthd->bhst", q, k), axis=-1)
        return jnp.einsum("bhst,bthd->bshd", p, v)

    theirs = _hlo(jref, pair, *_sds((b, s, h, d), (b, s, h, d), (b, s, h, d)))
    fn = fa.attention if path == "flash op" else attention_reference
    _, ours = rf.count(fn, *(_meta(b, s, h, d) for _ in range(3)), causal=False)
    assert ours.flops == theirs.flops == 4 * b * s * s * h * d == attention_counts(b, s, s, h, d).flops
    assert ours.hbm_bytes >= attention_counts(b, s, s, h, d, dtype_bytes=4).hbm_bytes


@pytest.mark.parametrize("path", ["kernel op", "plain version"])
def test_lstm_flops_equal_the_parser(jref, path):
    b, s, i, h = 1, 16, 6, 20
    theirs = _hlo(jref, lambda x, a, w, c: jref["lstm"](x, a, w, c)[0], *_sds((b, s, i), (i, 4 * h), (h, 4 * h), (4 * h,)))
    fn = lstm_ops.lstm if path == "kernel op" else lstm_reference
    _, ours = rf.count(fn, _meta(b, s, i), _meta(i, 4 * h), _meta(h, 4 * h), _meta(4 * h))
    assert ours.flops == theirs.flops == lstm_counts(b, s, i, h).flops
    assert ours.hbm_bytes >= lstm_counts(b, s, i, h).hbm_bytes


@pytest.mark.parametrize("path", ["kernel op", "plain version"])
def test_ssd_flops_equal_the_parser(jref, path):
    b, s, h, p, g, n = 1, 8, 2, 4, 1, 4
    theirs = _hlo(jref, lambda *a: jref["ssd"](*a)[0],
                  *_sds((b, s, h, p), (b, s, h), (h,), (b, s, g, n), (b, s, g, n), (h,)))
    fn = ssd_ops.ssd if path == "kernel op" else ssd_recurrent_reference
    _, ours = rf.count(fn, _meta(b, s, h, p), _meta(b, s, h), _meta(h), _meta(b, s, g, n), _meta(b, s, g, n), _meta(h))
    assert ours.flops == theirs.flops == ssd_counts(b, s, h, p, n, num_groups=g).flops
    assert ours.hbm_bytes >= ssd_counts(b, s, h, p, n, num_groups=g, dtype_bytes=4).hbm_bytes


def test_dequant_bytes_equal_the_parser_and_no_flops(jref):
    r, c, group = 8, 256, 128
    theirs = _hlo(jref, lambda q, s: jref["dequant"](q, s, group=group),
                  jax.ShapeDtypeStruct((r, c), jnp.int8), jax.ShapeDtypeStruct((r, c // group), jnp.float32))
    _, ours = rf.count(dq.dequantize, _meta(r, c, dtype=torch.int8), _meta(r, c // group), group=group)
    assert ours.flops == theirs.flops == 0
    assert ours.hbm_bytes == theirs.hbm_bytes == dequant_counts(r, c, group).hbm_bytes
    _, plain = rf.count(dequantize_blocked_reference, _meta(r, c, dtype=torch.int8), _meta(r, c // group), group=group)
    assert plain.flops == 0 and plain.hbm_bytes >= ours.hbm_bytes


def test_a_cuda_or_cpu_tensor_never_takes_the_meta_op():
    """The meta stand-in is for meta tensors only: a CPU tensor still
    takes the plain version (its values), under the counter or not."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    out, cost = rf.count(fa.attention, q, k, v)
    assert torch.equal(out, attention_reference(q, k, v)) and cost.flops == 4 * 8 * 8 * 2 * 16


# ---------------------------------------------------------------------------
# Whole cells
# ---------------------------------------------------------------------------
def _reference_flops(jref, arch, kind, s, b):
    jcfg = jref["get"](arch, reduced=True)
    spec = jref["base"].ShapeSpec(kind, s, b, kind)
    psds, bsds = jref["zoo"].param_shapes(jcfg), jref["zoo"].batch_spec(jcfg, spec)
    if kind == "prefill":
        fn, args = (lambda p, x: jref["zoo"].prefill_fn(p, x, jcfg, max_len=s)), (psds, bsds)
    else:
        fn, args = (lambda p, st, t: jref["zoo"].decode_fn(p, st, t, jcfg)), (psds, bsds["state"], bsds["token"])
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return jref["roof"].parse_hlo_costs(txt, default_trip=jref["decoder"].num_periods(jcfg)).flops


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_reduced_dense_cell_flops_equal_the_reference_lowering(jref, kind):
    """The reduced qwen3 at B 2, S 32 (a cache of 48 to decode) on a 1×1
    mesh against the reference's single-device lowering; on a (data 2,
    model 2) mesh each rank counts a quarter (the batch and the heads
    divide)."""
    s = 32 if kind == "prefill" else 48
    cfg, shape = get_config("qwen3-1.7b", reduced=True), ShapeSpec(kind, s, 2, kind)
    theirs = _reference_flops(jref, "qwen3-1.7b", kind, s, 2)
    one = dryrun_lib.lower_cell("qwen3-1.7b", kind, mesh=Mesh((1, 1), ("data", "model")), cfg=cfg, shape=shape)
    four = dryrun_lib.lower_cell("qwen3-1.7b", kind, mesh=Mesh((2, 2), ("data", "model")), cfg=cfg, shape=shape)
    assert one.status == four.status == "ok", (one.reason, four.reason)
    flops = one.roofline["flops_per_device"]
    assert abs(flops - theirs) <= 1e-9 * theirs
    assert four.roofline["flops_per_device"] * 4 == flops
    assert one.roofline["collective_bytes_per_device"] == 0.0
    assert four.collectives["staged_by_tag"]["tensor parallel"]["calls"] > 0


def test_full_width_cells_of_each_kind_are_counted_on_meta():
    """qwen3-1.7b's train_4k, prefill_32k and decode_32k on the 16×16
    mesh: one rank's counts, finite and consistent with the model's own
    FLOPs (the counted work is at least the useful work, plus the remat
    recompute and the attention)."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        res = dryrun_lib.lower_cell("qwen3-1.7b", shape)
        assert res.status == "ok", res.reason
        r = res.roofline
        assert r["chips"] == 256 and r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert 0.0 < r["useful_flops_fraction"] <= 1.0, shape
        assert r["step_time_lower_bound_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])
        assert res.memory["per_device_total_gb"] >= res.memory["argument_gb"] > 0
        assert set(res.collectives["staged_by_tag"]) >= {"weight gather", "tensor parallel"}
        assert np.isfinite(list(r[k] for k in r if k != "dominant")).all()


def test_counter_flops_equal_flop_counter_mode_on_a_train_step():
    """The counter applies ``FlopCounterMode``'s formulas without its
    decomposition pass: on the reduced qwen3's train step (forward, remat
    replay, backward, AdamW) on a (2, 2) mesh the two counts agree."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import sharding as shd
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.models import model_zoo as zoo

    cfg = get_config("qwen3-1.7b", reduced=True)
    mesh = dryrun_lib.dry_mesh(Mesh((2, 2), ("data", "model")), (1, 0))
    with shd.use_sharding(mesh):
        fns = make_train_step(cfg, mesh=mesh)
        batch = {k: _meta(2, 16, dtype=torch.int32) for k in ("tokens", "labels")}
        _, cost = rf.count(fns.train_step, fns.init_state(zoo.param_shapes(cfg)), batch, 1e-3)
        with FlopCounterMode(display=False) as mode:
            fns.train_step(fns.init_state(zoo.param_shapes(cfg)), batch, 1e-3)
    assert cost.flops == mode.get_total_flops() > 0
