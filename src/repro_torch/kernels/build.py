"""Build and load the port's CUDA kernels.

Each ``kernels/csrc/<name>.cu`` exposes a plain C interface and compiles on
its own, with ``nvcc -gencode arch=compute_90a,code=sm_90a -I csrc``, into a
shared library under ``build/repro_torch_kernels/`` of the checkout (listed
in ``.gitignore``), loaded with :mod:`ctypes`.  Device code shared by
several kernels lives in ``csrc/*.cuh`` headers.  A library's file name
carries a digest of its source, the headers and the flags, so an edited
source or header never loads a stale build.  Nothing here runs when the
module is imported: the first launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): the port's kernels cannot build")
    return os.path.join(CUDA_HOME, "bin", name)


def headers() -> Dict[str, Path]:
    """Header name -> its ``.cuh`` file (device code the sources share)."""
    return {p.name: p for p in sorted(CSRC.glob("*.cuh"))}


def library_path(name: str) -> Path:
    text = sources()[name].read_bytes()
    for header in headers().values():
        text += header.read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns seconds per kernel
    built; raises with the compiler's output if any build fails.  The
    compiler's report (registers, shared memory, spills) is kept beside
    each library as ``<library>.log``."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _tool("nvcc")
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(sources()[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for a built kernel ('' if none kept)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (once per
    process)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


# "/*0450*/  @P0  HMMA.16816.F32.BF16 R4, ..." -> "HMMA"
_SASS_OPCODE = re.compile(
    r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")


def count_opcodes(sass: str, opcodes: Iterable[str]) -> Dict[str, int]:
    """Instructions in a ``cuobjdump --dump-sass`` listing whose opcode
    (before its first ``.``) is each of ``opcodes``."""
    counts = {op: 0 for op in opcodes}
    for match in _SASS_OPCODE.finditer(sass):
        if match.group(1) in counts:
            counts[match.group(1)] += 1
    return counts


def sass_counts(name: str, opcodes: Iterable[str] = ("HGMMA", "HMMA")
                ) -> Dict[str, int]:
    """Tensor-core instructions in the built kernel's machine code:
    ``HGMMA`` is a warpgroup ``wgmma``, ``HMMA`` a warp ``mma.sync``."""
    sass = subprocess.run([_tool("cuobjdump"), "--dump-sass",
                           str(library_path(name))], capture_output=True,
                          text=True, check=True).stdout
    return count_opcodes(sass, opcodes)
