"""Build a CUDA source of `csrc/` into a shared library with a plain C
interface, for loading with ctypes.

Each library lands in `tungsten_tpu_torch/_build/` under a name that hashes
the source, the headers beside it (`csrc/*.cuh`), `NVCC_FLAGS` and
`nvcc --version`, so a change to any of them rebuilds it and an unchanged
one is built once.  The build holds an exclusive file lock
(`fcntl.flock` on `<library>.lock`), so processes started together (the
ranks of a sharded render) do not compile one library at once: the first
builds it and the others load what it built.  Building happens at a
kernel's first use, never at import: the CPU tests import every module on
machines without nvcc.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# no fast math, and no fused multiply-add contraction: float rounding then
# follows the plain PyTorch twins operation for operation
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def compile_library(source):
    """Compile `source` (a Path) unless its library exists.

    Returns (library path, nvcc's output: the register and spill report,
    or "" when the library was already built)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           + str(source))
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    key = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update("\0".join((*NVCC_FLAGS, version)).encode())
    lib = BUILD_DIR / f"lib{source.stem}_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    with open(lib.with_name(lib.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while this one waited
            return lib, ""
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                              str(source)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


def sass_listing(lib):
    """`cuobjdump -sass` of the library `lib` (a Path), with the toolkit
    that builds it."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: cuobjdump is needed")
    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
