"""Shared scaffolding for the launch CLIs (sweep / fleet), ported from
``repro.launch._cli``: axis parsing (``start:stop:step`` ranges and comma
lists), device/method name resolution, argparse boilerplate, timing
metadata, and the write-to-``--out``-or-stdout tail.

Every launcher takes ``--device`` (default ``cuda``): the run goes on the
card, and raises on a host without one unless ``--device cpu`` is given.

Nothing here imports torch at module scope — ``--help`` stays instant.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import platform
import subprocess
import sys
import time


def parse_axis(spec: str) -> list[float]:
    """'a:b:step' (stop-inclusive) or 'x,y,z' → list of floats.

    >>> parse_axis("10:40:10")
    [10.0, 20.0, 30.0, 40.0]
    >>> parse_axis("3,6,9")
    [3.0, 6.0, 9.0]
    """
    if ":" in spec:
        parts = [float(x) for x in spec.split(":")]
        if len(parts) != 3:
            raise argparse.ArgumentTypeError(f"range must be start:stop:step, got {spec!r}")
        start, stop, step = parts
        if step <= 0:
            raise argparse.ArgumentTypeError(f"step must be positive in {spec!r}")
        out = []
        x = start
        while x <= stop + 1e-9:
            out.append(round(x, 10))
            x += step
        return out
    return [float(x) for x in spec.split(",") if x]


def resolve_devices(spec: str):
    """Comma list of FPGA device names (or 'both') → tuple of FpgaDevice."""
    from repro_torch.core.config_phase import DEVICES

    if spec == "both":
        return tuple(DEVICES.values())
    out = []
    for name in spec.split(","):
        if name not in DEVICES:
            raise SystemExit(f"unknown device {name!r}; known: {', '.join(DEVICES)} or 'both'")
        out.append(DEVICES[name])
    return tuple(out)


def resolve_methods(spec: str):
    """Comma list of Table-3 method names → tuple of IdlePowerMethod."""
    from repro_torch.core.strategies import IdlePowerMethod

    return tuple(IdlePowerMethod(m) for m in spec.split(","))


def make_parser(
    prog: str,
    description: str,
    calibrated_default: bool = False,
    out_default: str | None = None,
) -> argparse.ArgumentParser:
    """Uniform parser with the flags every launcher shares (--out,
    --calibrated/--no-calibrated, --device); launchers add their own on
    top.  The reference's ``--jit`` (XLA fusion) has no counterpart: the
    port's closed forms run eagerly, one correctly rounded op at a time."""
    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("--out", default=out_default, metavar="PATH",
                    help="write JSON here"
                    + (" (default stdout)" if out_default is None else ""))
    ap.add_argument("--calibrated", action="store_true", default=calibrated_default,
                    help="include the calibrated power-up overhead (DESIGN.md §2)")
    ap.add_argument("--no-calibrated", dest="calibrated", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the same "
                         "program on the host)")
    return ap


def powerup_overhead_mj(args) -> float:
    """--calibrated flag → overhead constant (0.0 when absent/false)."""
    from repro_torch.core import energy_model as em

    return em.CALIBRATED_POWERUP_OVERHEAD_MJ if args.calibrated else 0.0


class Timer:
    """Tiny perf_counter context: ``with Timer() as t: ...; t.elapsed_s``."""

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        self.elapsed_s = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed_s = time.perf_counter() - self._t0


def finish_payload(payload: dict, elapsed_s: float, **meta) -> dict:
    """Attach the uniform ``meta`` block (timing + launcher-specific keys)."""
    size = payload.get("size") or len(payload.get("records", [])) or None
    payload["meta"] = {
        "elapsed_s": round(elapsed_s, 6),
        "points_per_s": round(size / elapsed_s, 1) if size and elapsed_s > 0 else None,
        **meta,
    }
    return payload


def _git_sha() -> str | None:
    """HEAD SHA of the repo this module lives in, or None outside git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def card_name_and_power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``name, power.limit``), or None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run_manifest(seed=None, device=None) -> dict:
    """Provenance block stamped into every emitted payload: git SHA,
    interpreter/library versions (torch and its CUDA), the device the run
    used — on a card its name and power limit — seed, wall-clock.  Every
    field degrades to None rather than raising — a manifest must never be
    the reason a run fails."""
    versions: dict[str, str | None] = {"python": platform.python_version()}
    backend = None
    card = None
    try:
        import torch

        versions["torch"] = torch.__version__
        versions["cuda"] = torch.version.cuda
        backend = str(device) if device is not None else None
        if backend is not None and torch.device(backend).type == "cuda":
            card = card_name_and_power_limit()
    except Exception:
        versions.setdefault("torch", None)
        versions.setdefault("cuda", None)
    try:
        import numpy

        versions["numpy"] = numpy.__version__
    except Exception:
        versions["numpy"] = None
    now = datetime.datetime.now(datetime.timezone.utc)
    return {
        "git_sha": _git_sha(),
        "versions": versions,
        "backend": backend,
        "card": card,
        "platform": platform.platform(),
        "seed": seed,
        "unix_time": round(now.timestamp(), 3),
        "timestamp": now.isoformat(timespec="seconds"),
    }


def emit(payload: dict, out: str | None, label: str = "payload", device=None) -> None:
    """JSON to ``out`` (with a stderr receipt) or stdout — the shared tail
    of every launcher's ``main``.  Stamps a :func:`run_manifest` into the
    payload (under ``"manifest"``) unless the launcher already did."""
    if isinstance(payload, dict) and "manifest" not in payload:
        seed = None
        config = payload.get("config")
        if isinstance(config, dict):
            seed = config.get("seed")
        payload["manifest"] = run_manifest(seed=seed, device=device)
    text = json.dumps(payload, indent=2)
    if out:
        with open(out, "w") as f:
            f.write(text)
        print(f"wrote {label} to {out}", file=sys.stderr)
    else:
        print(text)
