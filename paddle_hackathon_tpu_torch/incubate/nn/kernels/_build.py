"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  At first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``paddle_hackathon_tpu_torch/_build/`` and loaded with
``ctypes``.  The flash-attention sources are built once per padded head
width (``-DFLASH_DP=64``, 128, 256: libraries ``<name>_w<DP>``) and once
for every wider head (``-DFLASH_DP=0``: ``<name>_wide``, the
column-chunked kernels, whose chunk count is fixed at run time), and the
bhd kernels also once per type family (``-DFLASH_F32=1`` f32, ``0``
bf16/f16: ``flash_attention_w<DP>_f32`` / ``_h``,
``flash_attention_wide_f32`` / ``_h``), so that their template instances
compile in parallel processes; each such library exports the same C
functions for its own widths and types.  The
library's file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one loads the earlier build.
:func:`build_all` starts one ``nvcc`` per missing library, all at once,
and waits for them.

Only sources in this repository are compiled; nothing includes
PyTorch's headers (that route takes minutes per build).
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
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[3]
BUILD_DIR = _PKG / "_build"
FLASH_WIDTHS = (64, 128, 256)   # the padded head widths of K1 and K2
SOURCES: Dict[str, Path] = {
    "paged_attention": _PKG / "csrc" / "paged_attention.cu",
    "quant_matmul": _PKG / "csrc" / "quant_matmul.cu",
}
EXTRA_FLAGS: Dict[str, List[str]] = {}
for _dp, _tag in [(dp, f"w{dp}") for dp in FLASH_WIDTHS] + [(0, "wide")]:
    SOURCES[f"flash_attention_packed_{_tag}"] = \
        _PKG / "csrc" / "flash_attention_packed.cu"
    EXTRA_FLAGS[f"flash_attention_packed_{_tag}"] = [f"-DFLASH_DP={_dp}"]
    for _fam, _f32 in (("f32", 1), ("h", 0)):
        SOURCES[f"flash_attention_{_tag}_{_fam}"] = \
            _PKG / "csrc" / "flash_attention.cu"
        EXTRA_FLAGS[f"flash_attention_{_tag}_{_fam}"] = [
            f"-DFLASH_DP={_dp}", f"-DFLASH_F32={_f32}"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per library built
# in this process, and the seconds from the start of the parallel build
# until its nvcc was collected (collected in order: an upper bound on its
# own build time; the largest is the build's wall time)
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def width_tag(head_dim: int) -> str:
    """The flash library that takes ``head_dim``: ``w64``, ``w128`` or
    ``w256`` (its padded width), or ``wide`` past 256."""
    return next((f"w{dp}" for dp in FLASH_WIDTHS if head_dim <= dp), "wide")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):   # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every missing kernel library in parallel; returns the
    library path of each.  Raises with nvcc's output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []   # (name, process, temp output, final output)
    t0 = time.perf_counter()
    for n in names:
        out = library_path(n)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *_flags(n), "-o", str(tmp), str(SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((n, proc, tmp, out))
    failed = []
    for n, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        build_logs[n] = log
        build_seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
