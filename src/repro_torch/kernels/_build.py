"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel source under ``kernels/*/csrc/`` exposes a plain C function
(pointers, ints and the stream as ``void*``, returning the launch's
``cudaError_t``), so it compiles in seconds without PyTorch's headers.  The
shared library lands in ``build/kernels/`` at the root of the checkout,
named by the hash of its source and the headers beside it, so an edited
kernel is never served stale.
Nothing here runs at import: the first launch on a CUDA tensor builds (or
finds) and loads its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "build_all", "build_dir", "load"]

_PKG = Path(__file__).resolve().parent
# kernel name -> CUDA source, relative to this package
SOURCES: dict[str, Path] = {
    "paged_decode": _PKG / "decode_attention" / "csrc" / "paged_decode.cu",
    "dense_decode": _PKG / "decode_attention" / "csrc" / "dense_decode.cu",
    "flash_fwd": _PKG / "flash_attention" / "csrc" / "flash_fwd.cu",
    "flash_bwd": _PKG / "flash_attention" / "csrc" / "flash_bwd.cu",
    "lstm_cell": _PKG / "lstm_cell" / "csrc" / "lstm_cell.cu",
    "moe_gmm": _PKG / "moe_gmm" / "csrc" / "moe_gmm.cu",
    "moe_route": _PKG / "moe_route" / "csrc" / "moe_route.cu",
    "ssm_scan": _PKG / "ssm_scan" / "csrc" / "ssm_scan.cu",
    "rglru_scan": _PKG / "rglru_scan" / "csrc" / "rglru_scan.cu",
    "adamw": _PKG / "adamw" / "csrc" / "adamw.cu",
}
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout (``.gitignore`` lists it)."""
    return _PKG.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels build on the GPU host")
    return found


def _target(name: str) -> Path:
    """The library's path, named by the hash of its source and of every
    header beside it (``csrc/*.cuh``, ``*.h``), so an edited header is never
    served stale either."""
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    for hdr in sorted(p for p in src.parent.iterdir() if p.suffix in (".cuh", ".h")):
        digest.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path, verbose: bool) -> list[str]:
    cmd = [_nvcc(), *_ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(out), str(SOURCES[name])]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(names: list[str] | None = None, *, verbose: bool = False) -> dict[str, dict]:
    """Compile every named kernel (default: all), one ``nvcc`` per source,
    all started together.  Returns ``{name: {"path", "seconds", "log"}}``;
    ``log`` holds ``-Xptxas -v`` (registers, shared memory, spills) when
    ``verbose``.  Up-to-date libraries are not rebuilt."""
    names = list(SOURCES) if names is None else names
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    done: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists() and not verbose:
            done[name] = {"path": out, "seconds": 0.0, "log": "up to date"}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp, verbose), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({SOURCES[name]}):\n{log}")
        os.replace(tmp, out)
        done[name] = {"path": out, "seconds": time.perf_counter() - t0, "log": log}
    return done


def build(name: str) -> Path:
    """The compiled library of one kernel, building it when missing."""
    return build_all([name])[name]["path"]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel (built on first use, then cached)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
