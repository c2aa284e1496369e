"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc`` per
source, all started together — and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  In a checkout the library
lands in ``build/repro_torch/<hash>/`` at the repository root (listed in
``.gitignore``); an installed copy of the package builds under
``$XDG_CACHE_HOME/repro_torch`` (default ``~/.cache/repro_torch``).  The
directory is keyed by a hash of the sources and flags, so the first caller
builds it and later callers reuse it.  Each process compiles in a directory
of its own and publishes the finished library with one atomic rename, so
two processes that build at once do not write the same files.  Nothing is
built when this module is imported: :func:`library` builds at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("dequant.cu", "flash_attention.cu", "lstm.cu", "ssd.cu")
_CHECKOUT = Path(__file__).resolve().parents[3]


def _build_root() -> Path:
    if (_CHECKOUT / "src" / "repro_torch").is_dir():
        return _CHECKOUT / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "repro_torch"


BUILD_ROOT = _build_root()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
#: what the last build did: {"seconds": float, "cached": bool, "log": str}
last_build: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (unless this exact build exists) → library path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "librepro_torch.so"
    if lib_path.exists():
        last_build.update(seconds=0.0, cached=True, log="")
        return lib_path
    work = out_dir / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs = []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    tmp = work / "librepro_torch.so"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *(str(obj) for _, obj, _ in procs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    log = "\n".join(logs)
    (work / "build.log").write_text(log)
    os.replace(work / "build.log", out_dir / "build.log")
    os.replace(tmp, lib_path)   # atomic publish: a reader sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    last_build.update(seconds=time.perf_counter() - t0, cached=False, log=log)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_dequant.argtypes = [vp, vp, vp, ll, ll, i32, i32, vp]
        lib.repro_dequant.restype = i32
        flash = [vp, vp, vp, vp] + [i32] * 6 + [ctypes.POINTER(ll)] + [i32] * 3 + [ctypes.c_float]
        lib.repro_flash_attention_fp32.argtypes = flash + [vp]
        lib.repro_flash_attention_fp32.restype = i32
        lib.repro_flash_attention_bf16.argtypes = flash + [vp]
        lib.repro_flash_attention_bf16.restype = i32
        lib.repro_lstm.argtypes = [vp] * 9 + [i32] * 5 + [ll] * 3 + [vp]
        lib.repro_lstm.restype = i32
        lib.repro_ssd.argtypes = [vp] * 13 + [i32] * 11 + [ctypes.POINTER(ll), vp]
        lib.repro_ssd.restype = i32
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
