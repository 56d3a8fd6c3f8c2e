"""Build the port's hand-written CUDA sources into shared libraries.

Each library is compiled from ``beam_slam_tpu_torch/csrc`` with ``nvcc`` for
Hopper (``sm_90a``) into a plain-C-ABI ``.so`` that :mod:`ctypes` loads: no
PyTorch headers, so a build takes seconds. The result is cached in
``beam_slam_tpu_torch/_build/`` (git-ignored) under a hash of the sources and
flags, and built on first use in each fresh checkout; callers load it with
:mod:`ctypes`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(name: str, sources: Sequence[str]) -> Tuple[Path, list]:
    """(cached .so path, the source paths) of library ``name``; the hash
    covers the sources, the headers of csrc/ and the flags."""
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so", paths


def build_many(specs: Sequence[Tuple[str, Sequence[str]]]
               ) -> Dict[str, Tuple[Path, str, float]]:
    """Compile several libraries at once, one ``nvcc`` process each, all
    started together. ``specs`` is a list of (name, sources under csrc/).

    Returns name → (path of the .so, the compiler's stderr — ptxas register
    and shared-memory report — and the build seconds; 0.0 on a cache hit)."""
    results: Dict[str, Tuple[Path, str, float]] = {}
    running = []
    for name, sources in specs:
        out, paths = _target(name, sources)
        if out.exists():
            results[name] = (out, "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, cmd, proc, t0 in running:
        _, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stderr}")
            continue
        os.replace(tmp, out)
        results[name] = (out, stderr, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def build(name: str, sources: Sequence[str]) -> Tuple[Path, str, float]:
    """Compile ``sources`` (file names under csrc/) into ``lib<name>``; see
    :func:`build_many` for what it returns."""
    return build_many([(name, sources)])[name]
