"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, which :func:`load` opens with
``ctypes``.  No PyTorch header is included, so a build takes seconds.

:func:`build_all` starts one ``nvcc`` per source, all at once.
Libraries land in ``build/repro_torch/`` at the root of the checkout, named
by a hash of the source, so an edited source rebuilds and an unchanged one
is reused.  Nothing here runs at import: the CPU tests import every module
on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)
#: after the source: libcuda, whose ``cuTensorMapEncodeTiled`` builds the
#: flash kernel's TMA descriptors on the host
LINK_FLAGS = ("-lcuda",)
#: macros defined for a source's build, name -> ("NAME" or "NAME=VALUE", ...);
#: they are part of the library's hash, so set them before its first load
DEFINES: dict = {}

_loaded: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _defines(name: str) -> tuple:
    return tuple(f"-D{d}" for d in DEFINES.get(name, ()))


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built (hash of its source)."""
    src = CSRC_DIR / f"{name}.cu"
    flags = " ".join(NVCC_FLAGS + LINK_FLAGS + _defines(name))
    digest = hashlib.sha256(src.read_bytes() + flags.encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built; the ``nvcc`` output.

    A cached library gives an empty log.  Raises ``RuntimeError`` with the
    compiler's output when the build fails.
    """
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    src = str(CSRC_DIR / f"{name}.cu")
    cmd = [_nvcc(), *NVCC_FLAGS, *_defines(name), "-o", str(tmp), src, *LINK_FLAGS]
    proc = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stdout}"
        )
    os.replace(tmp, out)
    return proc.stdout


def build_all(names) -> dict:
    """Compile the named sources at once, one ``nvcc`` each; name -> log.

    Raises ``RuntimeError`` naming every source that failed.
    """
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {n: pool.submit(build, n) for n in names}
    logs, errors = {}, []
    for name, fut in futures.items():
        try:
            logs[name] = fut.result()
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
