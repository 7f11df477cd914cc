"""Build a kernel source under ``csrc/`` with ``nvcc``, or a host C++ source with
``g++`` (``host=True``), into a shared library.

Each library is compiled at first use into ``_build/`` (gitignored) as
``lib<stem>_<hash>.so``, where the hash is of the source and of every local header it
includes (``#include "..."``, followed through headers), so a stale build is never
loaded, and editing a header shared by two sources rebuilds both. ``nvcc``'s
register/shared-memory report goes to ``<lib>.ptxas.txt``.
Builds of different sources may run at the same time (each writes a temporary file
and renames it into place).
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: put a host C++ compiler on PATH")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_files(src: pathlib.Path) -> list:
    """``src`` and the local headers it includes, directly or through other local
    headers (paths relative to the including file), each once, in include order."""
    found, todo = [], [src.resolve()]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / name.decode()).resolve())
    return found


def source_digest(src: pathlib.Path) -> str:
    """The hash in the library's name: of ``src`` and of its local headers."""
    h = hashlib.sha256()
    for path in local_files(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:12]


def build(src: pathlib.Path, host: bool = False) -> pathlib.Path:
    """Compile ``src`` (if it or a local header changed since the last build) and
    return the library: with ``nvcc`` for the card, or with ``g++`` for the host
    (``host=True``, linked with pthread). A failed build raises."""
    digest = source_digest(src)
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    if host:
        cmd = [_gxx(), *GXX_FLAGS, "-o", tmp, str(src), "-lpthread"]
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    if not host:
        lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib
