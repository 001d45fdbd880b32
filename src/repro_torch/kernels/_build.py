"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` (the hash is
of the source text, so an edited source never loads a stale library) and is
loaded at first use. Only the repository's own sources are built; the
sources of one call are compiled by concurrent ``nvcc`` processes. The
directory ``_build/`` is git-ignored. Nothing here runs at import time, so
the module imports on a machine without ``nvcc``.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class Built(NamedTuple):
    lib: ctypes.CDLL
    seconds: float      # wall time of the nvcc run (0.0 when already built)
    log: str            # nvcc's output (register / shared-memory report)


_loaded: Dict[str, Built] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "repro_torch are built from source and need the CUDA toolkit"
    )


def _build(srcs: List[Path]) -> None:
    """Build and load ``srcs`` into ``_loaded``, one ``nvcc`` process per
    source, all started before any is waited for. Raises ``RuntimeError``
    with nvcc's output for every source that failed."""
    todo = []
    for src in srcs:
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        target = BUILD_DIR / f"lib{src.stem}-{digest}.so"
        if target.is_file():
            _loaded[src.stem] = Built(ctypes.CDLL(str(target)), 0.0, "")
        else:
            todo.append((src, target))
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = [
        (src, target, time.perf_counter(), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(target), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, target in todo
    ]
    errors = []
    for src, target, t0, proc in started:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            target.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {src.name}:\n{log}")
        else:
            _loaded[src.stem] = Built(ctypes.CDLL(str(target)), seconds, log)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all() -> Dict[str, Built]:
    """Build and load every ``csrc/*.cu`` not loaded yet. Returns
    ``{name: Built}`` for all sources. Raises ``RuntimeError`` with nvcc's
    output if a build fails."""
    _build([src for src in sources() if src.stem not in _loaded])
    return dict(_loaded)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    if name not in _loaded:
        _build([CSRC / f"{name}.cu"])
    return _loaded[name].lib
