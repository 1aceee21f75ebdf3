"""Build and load the CUDA kernels of this package.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  The ``csrc/*.cuh`` headers hold the arithmetic the
sources share.  Libraries land in ``kernels/build/`` (listed in
``.gitignore``) at first use; a library newer than its source and every
header is reused.
``build_all`` starts one ``nvcc`` per source at once and waits for all.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time

__all__ = ["SOURCES", "CSRC_DIR", "BUILD_DIR", "nvcc_command", "build",
           "build_all", "load"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = ("quantize_payload", "dequant_combine_payload", "subbyte_encode",
           "subbyte_combine", "topk_encode", "topk_combine", "quantize_blocks",
           "dequant_combine_blocks", "gqa_decode")

#: ``-fmad=false`` keeps nvcc from contracting a*b+c into FMA anywhere the
#: kernels do not already spell each rounding with an intrinsic: the
#: contract with the plain versions is bit-exact.  No ``--use_fast_math``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: gqa_decode.cu instantiates its kernel 32 times (dtype x hd x g): nvcc
#: compiles them on every core instead of one after another
SOURCE_FLAGS = {"gqa_decode": ("-split-compile=0",)}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from csrc/ on a machine with the CUDA toolkit")


def _paths(name: str) -> tuple[str, str]:
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; have {SOURCES}")
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def nvcc_command(name: str, out: str) -> list[str]:
    src, _ = _paths(name)
    return [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", out,
            src]


def _fresh(name: str) -> bool:
    src, lib = _paths(name)
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
               if f.endswith(".cuh")]
    return (os.path.exists(lib) and os.path.getmtime(lib)
            >= max(os.path.getmtime(f) for f in [src, *headers]))


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every stale library in parallel (one nvcc per source).

    Returns ``{name: {"seconds": wall, "log": compiler output}}`` — the
    ``-Xptxas -v`` register/spill report is in the log.  Raises on the
    first failed build with its compiler output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if _fresh(name):
            continue
        _, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (tmp, lib, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    report = {name: {"seconds": 0.0, "log": "up to date"} for name in names}
    failed = []
    for name, (tmp, lib, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, lib)      # atomic: concurrent builders never
                                      # load a half-written library
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def build(name: str) -> str:
    """Path of the compiled library for ``name``, building it if stale."""
    build_all((name,))
    return _paths(name)[1]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name`` (built at first use, then cached
    for the life of the process)."""
    return ctypes.CDLL(build(name))
