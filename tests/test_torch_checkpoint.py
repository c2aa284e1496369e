"""Port's checkpoint format vs the JAX serializer: the msgpack codec writes
the same bytes, and a checkpoint written by either side restores in the
other bit-equal to its own restore, on either compression codec (zstd where
``zstandard`` is installed, zlib where it is not)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import msgpack

from repro_torch.checkpoint import CheckpointManager, MODES, deserialize, serialize
from repro_torch.checkpoint import _msgpack
from repro_torch.kernels.dequant import ops as dq


@pytest.fixture(scope="module")
def jser():
    from repro.checkpoint import serializer

    return serializer


@pytest.fixture(params=["zstd", "zlib"])
def zlib_reference(request, jser, monkeypatch):
    """The JAX serializer and the port's on one codec: both flags true
    (``zstandard`` installed: zstd) or both patched false (absent: zlib)."""
    import repro_torch.checkpoint.serializer as ser

    have = request.param == "zstd"
    if have and not (jser.HAVE_ZSTD and ser.HAVE_ZSTD):
        pytest.skip("the zstd codec needs 'zstandard' installed")
    monkeypatch.setattr(jser, "HAVE_ZSTD", have)
    monkeypatch.setattr(ser, "HAVE_ZSTD", have)
    return jser


def _tree_np(seed=0):
    """A parameter-like tree: stacked matrices large enough to quantize, a
    small one that is not, norms and an int scalar (numpy; bf16 leaves as
    ``ml_dtypes.bfloat16``)."""
    rng = np.random.default_rng(seed)
    bf16 = jnp.bfloat16.dtype
    return {
        "periods": {"pos0": {
            "w_big": (rng.standard_normal((2, 256, 256)) * 0.05).astype(bf16),
            "w_small": (rng.standard_normal((2, 64, 128)) * 0.05).astype(bf16),
            "ln1": np.ones((2, 256), bf16),
        }},
        "embed": (rng.standard_normal((600, 128)) * 0.02).astype(np.float32),
        "scale": rng.standard_normal((8,)).astype(np.float32),
        "step": np.asarray(7, np.int32),
    }


def _torch_of(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits_t(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _bits_np(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _port_tree(tree_np):
    return {k: _port_tree(v) if isinstance(v, dict) else _torch_of(v) for k, v in tree_np.items()}


# ---------------------------------------------------------------------------
# msgpack codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_codec_bytes_equal_msgpack_on_jax_payloads(zlib_reference, mode):
    blob = zlib_reference.serialize(_tree_np(), mode=mode)
    payload = msgpack.unpackb(blob, raw=False)
    assert _msgpack.packb(payload) == blob
    assert _msgpack.unpackb(blob) == payload


@pytest.mark.parametrize("mode", MODES)
def test_codec_bytes_equal_msgpack_on_port_payloads(mode):
    blob = serialize(_port_tree(_tree_np(1)), mode=mode)
    payload = _msgpack.unpackb(blob)
    assert msgpack.packb(payload, use_bin_type=True) == blob
    assert msgpack.unpackb(blob, raw=False) == payload


@pytest.mark.parametrize(
    "obj",
    [None, True, False, 0, 127, 128, 65535, 65536, 2**32, 2**64 - 1, -1, -32, -33,
     -129, -32769, -2**31 - 1, -2**63, "", "x" * 31, "x" * 32, "é" * 200,
     "x" * 70000, b"", b"y" * 255, b"y" * 256, b"y" * 70000, [1] * 15, [1] * 16,
     [1] * 70000, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)}],
)
def test_codec_matches_msgpack_at_every_width(obj):
    assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.unpackb(_msgpack.packb(obj)) == msgpack.unpackb(
        msgpack.packb(obj, use_bin_type=True), raw=False)


# ---------------------------------------------------------------------------
# cross restores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_jax_written_checkpoint_restores_bit_equal(zlib_reference, mode):
    tree = _tree_np(2)
    blob = zlib_reference.serialize(tree, mode=mode)
    theirs = zlib_reference.deserialize(blob)
    before = dq.launches
    ours = deserialize(blob, device="cpu")
    assert dq.launches == before          # CPU restore: the plain dequant
    assert set(ours) == set(theirs)
    for path, arr in theirs.items():
        assert tuple(ours[path].shape) == arr.shape
        assert str(ours[path].dtype)[6:] == arr.dtype.name
        np.testing.assert_array_equal(_bits_t(ours[path]), _bits_np(arr))
    if mode == "zstd+int8":
        payload = msgpack.unpackb(blob, raw=False)
        quantized = {r["path"] for r in payload["leaves"] if "quant" in r}
        assert quantized == {"embed", "periods/pos0/w_big"}


@pytest.mark.parametrize("mode", MODES)
def test_port_written_checkpoint_restores_bit_equal_in_jax(zlib_reference, mode):
    jser = zlib_reference
    tree = _port_tree(_tree_np(3))
    blob = serialize(tree, mode=mode)
    ours = deserialize(blob, device="cpu")
    theirs = jser.deserialize(blob)
    assert set(ours) == set(theirs) == set(_flat(tree))
    for path, arr in theirs.items():
        np.testing.assert_array_equal(_bits_t(ours[path]), _bits_np(arr))


def test_serialized_bytes_equal_jax_on_the_zlib_codec(zlib_reference):
    """Same tree, same format, same compressor (either codec): the same
    blob."""
    tree = _tree_np(4)
    for mode in MODES:
        assert serialize(_port_tree(tree), mode=mode) == zlib_reference.serialize(tree, mode=mode)
        # and the leaves inflate on that many threads into the reference's restore
        blob = zlib_reference.serialize(tree, mode=mode)
        ours, theirs = deserialize(blob, device="cpu"), zlib_reference.deserialize(blob)
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k].float().numpy(), np.asarray(theirs[k], dtype=np.float32))


@pytest.mark.parametrize("threads", [1, 3])
def test_compression_threads_write_the_reference_blob(zlib_reference, monkeypatch, threads):
    """More leaves than compressions in flight: the blob is the same at any
    thread count, and the reference's; reading it on that many threads
    restores what the reference restores."""
    import repro_torch.checkpoint.serializer as ser

    monkeypatch.setattr(ser, "_ZLIB_THREADS", threads)
    rng = np.random.default_rng(7)
    tree = {f"layer{i}": {"w": rng.standard_normal((16, 256)).astype(np.float32),
                          "b": rng.standard_normal((5,)).astype(np.float32)} for i in range(9)}
    for mode in MODES:
        assert serialize(_port_tree(tree), mode=mode) == zlib_reference.serialize(tree, mode=mode)
        # and the leaves inflate on that many threads into the reference's restore
        blob = zlib_reference.serialize(tree, mode=mode)
        ours, theirs = deserialize(blob, device="cpu"), zlib_reference.deserialize(blob)
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k].float().numpy(), np.asarray(theirs[k], dtype=np.float32))


def test_zstd_codec_blob_raises(jser, monkeypatch):
    """A zstd blob (the reference's, where ``zstandard`` is installed) read
    by the port where the package is absent: ``ModuleNotFoundError``; the
    port then writes and reads zlib."""
    import repro_torch.checkpoint.serializer as ser

    if not jser.HAVE_ZSTD:
        pytest.skip("the reference writes zstd only with 'zstandard' installed")
    blob = jser.serialize(_tree_np(5), mode="zstd")
    assert msgpack.unpackb(blob, raw=False)["codec"] == "zstd"
    monkeypatch.setattr(ser, "HAVE_ZSTD", False)
    with pytest.raises(ModuleNotFoundError, match="zstd"):
        deserialize(blob, device="cpu")
    tree = _port_tree(_tree_np(5))
    ours = serialize(tree, mode="zstd")
    assert msgpack.unpackb(ours, raw=False)["codec"] == "zlib"
    back = deserialize(ours, device="cpu")
    for path, t in _flat(tree).items():
        np.testing.assert_array_equal(_bits_t(back[path]), _bits_t(t))


@pytest.mark.parametrize("mode", MODES)
def test_bf16_leaves_round_trip(mode):
    g = torch.Generator().manual_seed(0)
    tree = {
        "w": (torch.randn((256, 256), generator=g) * 0.02).to(torch.bfloat16),
        "n": torch.randn((64,), generator=g).to(torch.bfloat16),
    }
    back = deserialize(serialize(tree, mode=mode), tree, device="cpu")
    assert back["w"].dtype == torch.bfloat16 and back["n"].dtype == torch.bfloat16
    assert torch.equal(back["n"], tree["n"])
    if mode == "zstd+int8":
        err = (back["w"].float() - tree["w"].float()).abs().max()
        assert err <= tree["w"].float().abs().max() / 100.0
    else:
        assert torch.equal(back["w"], tree["w"])


def test_restore_into_meta_target_casts_and_checks_paths():
    tree = {"a": torch.randn(4, 128), "b": {"c": torch.arange(3, dtype=torch.int32)}}
    blob = serialize(tree, mode="zstd")
    target = {"a": torch.empty((4, 128), dtype=torch.bfloat16, device="meta"),
              "b": {"c": torch.empty(3, dtype=torch.int32, device="meta")}}
    back = deserialize(blob, target, device="cpu")
    assert back["a"].dtype == torch.bfloat16 and back["a"].device.type == "cpu"
    assert torch.equal(back["a"], tree["a"].to(torch.bfloat16))
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    with pytest.raises(KeyError):
        deserialize(serialize({"a": tree["a"]}), target, device="cpu")


def test_manager_rotation_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, mode="zstd+int8")
    assert m.restore_latest(device="cpu") == (None, None)
    for step in range(4):
        m.save(step, {"w": torch.full((2, 4), float(step))})
    assert m.steps() == [2, 3]
    step, back = m.restore_latest({"w": torch.empty((2, 4), device="meta")}, device="cpu")
    assert step == 3 and torch.equal(back["w"], torch.full((2, 4), 3.0))
    (tmp_path / "step_9.ckpt.tmp").write_bytes(b"partial")
    assert m.steps() == [2, 3]


def test_restore_defaults_to_the_card_and_raises_without_it(tmp_path, monkeypatch):
    """``deserialize``, ``restore`` and ``restore_latest`` restore onto the
    card unless the caller passes ``device="cpu"``; with no card they raise
    instead of landing on the CPU."""
    tree = {"w": torch.arange(8, dtype=torch.float32).reshape(2, 4)}
    blob = serialize(tree)
    m = CheckpointManager(str(tmp_path))
    m.save(0, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: deserialize(blob), lambda: m.restore(0), lambda: m.restore_latest()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert torch.equal(deserialize(blob, device="cpu")["w"], tree["w"])
    assert torch.equal(m.restore(0, device="cpu")["w"], tree["w"])
    step, back = m.restore_latest(device="cpu")
    assert step == 0 and back["w"].device.type == "cpu" and torch.equal(back["w"], tree["w"])
