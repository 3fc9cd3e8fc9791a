"""The native serving ABI (``serving.cc``): build helper.

``serving.cc`` is host C++ that embeds CPython and serves the port's
predictor and engine through the C functions ``pht_serving_init``,
``pht_predictor_*`` and ``pht_engine_*`` (the JAX package's
``native/serving.cc`` ABI).  :func:`build_serving_shim` compiles it with
``g++ -std=c++17 -shared -fPIC`` against this interpreter's headers and
``libpython`` into ``paddle_hackathon_tpu_torch/_build/`` at first use (the
library's name carries a hash of the source, so an edited source
rebuilds); :func:`client_link_flags` gives the flags a C++ client links it
with.  No ``nvcc``: the kernels the engine runs are built by their own
wrappers inside the embedded interpreter.

A client process needs the interpreter's module path: run it with
``PYTHONPATH`` set to the ``sys.path`` of an interpreter that imports
``torch`` (:func:`client_env`).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "serving.cc"
BUILD_DIR = _PKG / "_build"
_lock = threading.Lock()

__all__ = ["build_serving_shim", "client_link_flags", "client_env"]


def _python_link() -> List[str]:
    """The compile and link flags for this interpreter's headers and
    shared ``libpython``; raises when either is missing."""
    inc = sysconfig.get_paths()["include"]
    if not (Path(inc) / "Python.h").exists():
        raise RuntimeError(f"Python.h not found under {inc}: the serving "
                           f"shim needs the interpreter's headers")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    if not ldlib.endswith(".so") or not (Path(libdir) / ldlib).exists():
        raise RuntimeError(f"no shared libpython ({ldlib!r} under "
                           f"{libdir!r}): the serving shim embeds the "
                           f"interpreter from a shared library")
    lib = ldlib[len("lib"):-len(".so")]
    return [f"-I{inc}", f"-L{libdir}", f"-l{lib}",
            f"-Wl,-rpath,{libdir}"]


def build_serving_shim() -> Path:
    """The path of the built shim (``libpht_serving_<hash>.so``), compiled
    now if missing."""
    flags = _python_link()
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libpht_serving_{digest}.so"
    with _lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(SOURCE),
               *flags, "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the serving shim failed:\n"
                               f"{' '.join(cmd)}\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def client_link_flags(shim: Path) -> List[str]:
    """What a C++ client's ``g++`` command adds to link ``shim``: the
    library, run paths to it and to ``libpython``, and ``-pthread``."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    return [str(shim), f"-Wl,-rpath,{Path(shim).parent}",
            f"-Wl,-rpath,{libdir}", "-pthread"]


def client_env(platform=None) -> Dict[str, str]:
    """The environment a client process runs in: this one, with
    ``PYTHONPATH`` giving the embedded interpreter this interpreter's
    module path, and ``PHT_SERVING_PLATFORM`` when ``platform`` is given
    (``"cpu"`` asks for the CPU)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    if platform is not None:
        env["PHT_SERVING_PLATFORM"] = platform
    return env
