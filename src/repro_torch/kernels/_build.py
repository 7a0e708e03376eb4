"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (it may
include headers beside it in ``csrc/``, and the headers all kernels share in
``kernels/include/``, which nvcc gets with ``-I``), compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``<repo>/build/kernels/`` (listed in
``.gitignore``). The library's name carries a hash of every file under the
kernel's ``csrc/`` and under ``kernels/include/``, so an edited kernel or
header, shared or not, is rebuilt and an unchanged one is loaded as built.
Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_ROOT.parents[1] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: headers every kernel may include (hopper.cuh: the Hopper primitives)
INCLUDE_DIR = PACKAGE_ROOT / "kernels" / "include"

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels of repro_torch are built from source at "
            "first use and have no other implementation on the GPU"
        )
    return found


def _csrc(name: str) -> Path:
    return PACKAGE_ROOT / "kernels" / name / "csrc"


def _source(name: str) -> Path:
    return _csrc(name) / f"{name}.cu"


def library_path(name: str) -> Path:
    """The library's path: its name carries a hash of each file under the
    kernel's ``csrc/`` and under ``INCLUDE_DIR`` (path and content)."""
    digest = hashlib.sha256()
    for root, tag in ((_csrc(name), b"csrc/"), (INCLUDE_DIR, b"include/")):
        for f in sorted(p for p in root.rglob("*") if p.is_file()):
            digest.update(tag + f.relative_to(root).as_posix().encode() + b"\0"
                          + f.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """Where the compiler's output of the built library is kept."""
    return library_path(name).with_suffix(".log")


def _start_build(name: str, nvcc: str) -> Optional[subprocess.Popen]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(INCLUDE_DIR),
        "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_source(name)),
    ]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.kernel_name, proc.tmp_path, proc.out_path = name, tmp, out
    return proc


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compiles the named kernels, one ``nvcc`` each, all at once. Returns
    each kernel's compiler output (``-Xptxas -v``: registers, shared memory,
    spills), kept beside the library (``log_path``) and read from there for
    a library that was already built (empty if it has none)."""
    nvcc = find_nvcc()
    procs: List[subprocess.Popen] = []
    logs: Dict[str, str] = {}
    for name in names:
        proc = _start_build(name, nvcc)
        if proc is None:
            log = log_path(name)
            logs[name] = log.read_text() if log.exists() else ""
        else:
            procs.append(proc)
    failed = []
    for proc in procs:
        text, _ = proc.communicate()
        logs[proc.kernel_name] = text
        if proc.returncode != 0:
            failed.append(f"{proc.kernel_name} (exit {proc.returncode}):\n{text}")
        else:
            proc.out_path.with_suffix(".log").write_text(text)
            os.replace(proc.tmp_path, proc.out_path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
