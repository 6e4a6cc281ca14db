"""Build the port's CUDA sources with nvcc into shared libraries.

Every ``csrc/*.cu`` of the port has a plain C interface and is compiled
on its own for ``sm_90a`` into ``<repo>/build/`` (listed in .gitignore),
with ``csrc/`` on the include path, then loaded with ``ctypes`` by its
wrapper module.  A library's name carries a digest of its source, of
every header beside it (``csrc/*.cuh``) and of the compiler flags, so an
edited source or header is rebuilt and an unchanged one is reused.
``build`` starts one nvcc for each source that needs building, all at
once, and waits for all of them.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Tuple

# build outputs go to <repo>/build (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def digest(source: Path) -> str:
    """The digest in the name of ``source``'s library: its bytes, those
    of every ``*.cuh`` in its directory (sorted by name) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(*sources: Path) -> List[Tuple[Path, float, str]]:
    """Compile every source whose library is missing, all in parallel;
    returns ``(library path, build seconds, compiler output)`` per source,
    in the order given (0 seconds and no output for a library that was
    already there)."""
    jobs = []
    for source in sources:
        lib = BUILD_DIR / f"{source.stem}_{digest(source)}.so"
        if lib.exists():
            jobs.append((lib, None, None, None))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(source.parent), "-o", str(tmp),
               str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((lib, tmp, cmd, (proc, time.perf_counter())))
    out = []
    failed = []
    for lib, tmp, cmd, started in jobs:
        if started is None:
            out.append((lib, 0.0, ""))
            continue
        proc, t0 = started
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}")
            continue
        os.replace(tmp, lib)
        out.append((lib, secs, stdout + stderr))
    if failed:
        raise RuntimeError("\n".join(failed))
    return out
