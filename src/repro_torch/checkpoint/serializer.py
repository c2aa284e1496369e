"""Checkpoint serialization: msgpack + compression (+ optional int8 weight
quantization) — port of ``repro.checkpoint.serializer``, same on-disk format.

The analogue of the paper's bitstream compression: compression shrinks the
bytes moved during bring-up (the configuration phase) at the cost of decode
compute.  Three modes:

    none       raw little-endian tensors
    zstd       lossless compression of every leaf
    zstd+int8  blocked int8 quantization (kernels/dequant) + compression
               (≈4× smaller; dequantize-on-load)

The codec is the reference's choice: zstd at ``level`` (3) where the
optional ``zstandard`` package is installed, stdlib zlib at level 6
otherwise; every blob records its codec, and both codecs are read (a zstd
blob where ``zstandard`` is absent raises ``ModuleNotFoundError``).
Payloads go through the bundled msgpack codec (``_msgpack``), and bf16
leaves through torch, so the port needs neither ``msgpack`` nor
``ml_dtypes``, and ``zstandard`` only to use zstd.

Restore dequantizes where the tensors are sent: with ``device="cuda"`` the
int8 values and scales move to the card and the dequant kernel writes the
weights there, with no round trip through the host.
"""
from __future__ import annotations

import collections
import os
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

try:  # optional: stdlib zlib is the codec where zstandard is absent
    import zstandard
except ImportError:  # pragma: no cover - exercised on hosts without the package
    zstandard = None

from repro_torch import tree as trees
from repro_torch.checkpoint import _msgpack
from repro_torch.device import resolve_device
from repro_torch.kernels.dequant import ops as dq

MODES = ("none", "zstd", "zstd+int8")
_QUANT_GROUP = 128
_ZLIB_LEVEL = 6
_ZLIB_THREADS = min(8, os.cpu_count() or 1)  # zlib and zstd release the GIL while they (de)compress

#: whether the "zstd" modes write the zstd codec (else zlib), as the reference's flag
HAVE_ZSTD = zstandard is not None

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _compressor(level: int):
    """(codec name, bytes → bytes) for the "zstd" modes: the reference's
    choice.  A zstd context is made per call, so the pool's threads share
    none."""
    if HAVE_ZSTD:
        return "zstd", lambda raw: zstandard.ZstdCompressor(level=level).compress(raw)
    return "zlib", lambda raw: zlib.compress(raw, _ZLIB_LEVEL)


def _decompress(codec: str, data: bytes) -> bytes:
    if codec == "zlib":
        return zlib.decompress(data)
    if codec == "zstd":
        if not HAVE_ZSTD:
            raise ModuleNotFoundError(
                "checkpoint was written with the zstd codec but the 'zstandard' "
                "package is not installed"
            )
        return zstandard.ZstdDecompressor().decompress(data)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a tree (``repro_torch.tree``), in the order
    ``jax.tree_util`` flattens the same tree: keys sorted, paths joined by
    ``/``, NamedTuples by field name in field order."""
    return list(trees.paths(tree, prefix, sort=True).items())


def unflatten_like(tree: Any, leaves: list) -> Any:
    """Rebuild ``tree``'s structure with ``leaves`` in :func:`flatten` order
    (dicts come back with their keys sorted)."""
    return trees.unflatten_like(tree, leaves, sort=True)


def _should_quantize(t: torch.Tensor) -> bool:
    """int8-quantize large float matrices only (embeddings/projections);
    norms, biases and scalars stay exact."""
    return (
        t.dim() >= 2
        and t.dtype in (torch.float32, torch.bfloat16)
        and t.shape[-1] % _QUANT_GROUP == 0
        and t.numel() >= 1 << 16
    )


def _to_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_bytes(raw: bytes, dtype: torch.dtype, shape, device) -> torch.Tensor:
    """A tensor of ``dtype`` over little-endian ``raw``, moved to ``device``."""
    if len(raw) == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    with warnings.catch_warnings():
        # `raw` is read-only; the tensor is copied (to the device, or by
        # clone on the CPU) before anything could write to it
        warnings.simplefilter("ignore", UserWarning)
        t = torch.frombuffer(raw, dtype=torch.uint8).view(dtype).reshape(shape)
    return t.to(device) if device.type != "cpu" else t.clone()


def serialize(tree: Any, mode: str = "zstd", level: int = 3) -> bytes:
    """Nested dict of tensors → bytes.  Quantization runs where the
    tensors lie (the kernel-free quantizer, on the card for CUDA tensors);
    the leaves are compressed (module docstring: the codec) on
    ``_ZLIB_THREADS`` host threads, at most twice that many in flight, into
    the bytes one thread would write."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    codec, pack = _compressor(level)
    leaves = []
    pending = collections.deque()             # (record, key, future), in the leaves' order
    with ThreadPoolExecutor(_ZLIB_THREADS) as pool:

        def compress(record: dict, key: str, raw: bytes) -> None:
            pending.append((record, key, pool.submit(pack, raw)))
            while len(pending) > 2 * _ZLIB_THREADS:
                done, k, future = pending.popleft()
                done[k] = future.result()

        for path, leaf in flatten(tree):
            t = torch.as_tensor(leaf)
            record: dict[str, Any] = {
                "path": path,
                "shape": list(t.shape),
                "dtype": _NAMES[t.dtype],
            }
            if mode == "zstd+int8" and _should_quantize(t):
                mat = t.reshape(-1, t.shape[-1])
                q, scales = dq.quantize_blocked(mat, group=_QUANT_GROUP)
                # the keys in the reference's order; the blobs fill in below
                record["quant"] = quant = {
                    "group": _QUANT_GROUP,
                    "q": None,
                    "scales": None,
                    "rows": int(mat.shape[0]),
                }
                compress(quant, "q", _to_bytes(q))
                compress(quant, "scales", _to_bytes(scales))
            else:
                raw = _to_bytes(t)
                record["data"] = raw
                if mode != "none":
                    compress(record, "data", raw)
            leaves.append(record)
        for done, k, future in pending:
            done[k] = future.result()
    payload = {
        "version": 1,
        "mode": mode,
        "codec": codec,
        "leaves": leaves,
    }
    return _msgpack.packb(payload)


def _inflated(pool: ThreadPoolExecutor, codec: str, blobs: list):
    """The blobs decompressed on ``pool``, at most twice its threads in
    flight, yielded in order (both codecs release the GIL while they
    inflate)."""
    pending = collections.deque()
    for blob in blobs:
        pending.append(pool.submit(_decompress, codec, blob))
        if len(pending) > 2 * _ZLIB_THREADS:
            yield pending.popleft().result()
    while pending:
        yield pending.popleft().result()


def deserialize(data: bytes, target: Any = None, device="cuda") -> Any:
    """bytes → tensors on ``device``, the card unless the caller passes
    ``device="cpu"`` (raises where CUDA is asked for and absent).  If
    ``target`` (a tree of tensors, e.g. meta tensors from
    ``model_zoo.param_shapes``) is given, leaves are restored into its
    structure and cast to its dtypes; else a flat {path: tensor} dict is
    returned.  A Python number in ``target`` (a step counter) comes back
    as a number of its type.  The leaves inflate on ``_ZLIB_THREADS`` host
    threads; they are restored (dequantized, moved) in their order."""
    device = resolve_device(device)
    payload = _msgpack.unpackb(data)
    mode = payload["mode"]
    # blobs predating the codec field were always zstd-compressed
    codec = payload.get("codec", "zstd")
    blobs = []
    for record in payload["leaves"]:
        if "quant" in record:
            blobs += [record["quant"]["q"], record["quant"]["scales"]]
        elif mode != "none":
            blobs.append(record["data"])
    by_path: dict[str, torch.Tensor] = {}
    with ThreadPoolExecutor(_ZLIB_THREADS) as pool:
        inflated = _inflated(pool, codec, blobs)
        for record in payload["leaves"]:
            shape = tuple(record["shape"])
            dtype = _DTYPES[record["dtype"]]
            if "quant" in record:
                qd = record["quant"]
                rows, group = qd["rows"], qd["group"]
                cols = (int(torch.Size(shape).numel()) // rows) if rows else 0
                q = _from_bytes(next(inflated), torch.int8, (rows, cols), device)
                scales = _from_bytes(next(inflated), torch.float32, (rows, cols // group), device)
                t = dq.dequantize(q, scales, group=group, dtype=dtype).reshape(shape)
            else:
                raw = record["data"] if mode == "none" else next(inflated)
                t = _from_bytes(raw, dtype, shape, device)
            by_path[record["path"]] = t
    if target is None:
        return by_path
    out = []
    for key, leaf in flatten(target):
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = by_path.pop(key)
        if isinstance(leaf, (bool, int, float)):
            out.append(type(leaf)(t.item()))
        else:
            out.append(t if t.dtype == leaf.dtype else t.to(leaf.dtype))
    return unflatten_like(target, out)
