"""Build the port's native code from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``; the
``csrc/*.cuh`` headers they share are part of every library's hash.  No
PyTorch headers are involved, so a build takes seconds.  Libraries land in
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so a changed source is rebuilt and an unchanged one
is reused.  A failed build raises: nothing falls back to a plain version.

Each ``csrc/<name>.cpp`` is host code (the ndjson log encoder), compiled
by ``g++`` the same way into ``build/host/`` on whichever machine first
loads it (:func:`load_host`).  Concurrent builds (test workers) each
write a temp file of their own and ``os.replace`` it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# ``-Xptxas -v`` only adds ptxas's register and spill report to the output.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_BUILD_DIR = BUILD_DIR.parent / "host"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's kernels are built from csrc/ on the machine with the card")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> "subprocess.Popen | None":
    """Start nvcc for one source unless its library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.coast_args = (name, tmp, target, cmd)
    return proc


def _finish(proc: "subprocess.Popen") -> str:
    name, tmp, target, cmd = proc.coast_args
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{out}")
    os.replace(tmp, target)
    return out


def build_all() -> Dict[str, str]:
    """Build every kernel source, one nvcc per source, all started
    together.  Returns name -> compiler output ('' when already built)."""
    with _lock:
        procs = {name: _start(name) for name in sources()}
        return {name: (_finish(p) if p is not None else "")
                for name, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it if needed)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            proc = _start(name)
            if proc is not None:
                _finish(proc)
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib


def _host_target(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return HOST_BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The built library of the host source ``csrc/<name>.cpp``, compiled
    with ``g++`` at first use."""
    key = f"host:{name}"
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            target = _host_target(name)
            if not target.exists():
                HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [shutil.which("g++") or "g++", *GXX_FLAGS, "-o",
                       str(tmp), str(CSRC / f"{name}.cpp")]
                try:
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True)
                except OSError as e:
                    raise RuntimeError(
                        f"g++ could not run for csrc/{name}.cpp: {e}") from e
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"g++ failed for csrc/{name}.cpp (rc "
                        f"{proc.returncode}):\n{' '.join(cmd)}\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, target)
            lib = ctypes.CDLL(str(target))
            _loaded[key] = lib
        return lib
