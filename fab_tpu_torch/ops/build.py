"""Build a kernel source under ``csrc/`` with ``nvcc`` into a shared library.

Each library is compiled at first use into ``_build/`` (gitignored) as
``lib<stem>_<hash>.so``, where the hash is of the source and of every local header it
includes (``#include "..."``, followed through headers), so a stale build is never
loaded, and editing a header shared by two sources rebuilds both. The compiler's register/shared-memory report goes to ``<lib>.ptxas.txt``.
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


def build(src: pathlib.Path) -> pathlib.Path:
    """Compile ``src`` (if it or a local header changed since the last build) and
    return the library."""
    digest = source_digest(src)
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib
