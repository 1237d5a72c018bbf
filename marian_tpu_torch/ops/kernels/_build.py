"""Build and load the port's CUDA kernels (``marian_tpu_torch/csrc/*.cu``).

Each library is compiled on first use by ``nvcc`` from one source, with
defines of its own, into a shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
A source whose entry points each take one operand type
(``packed_attention``, ``flash_attention``, ``fused_ce``) makes two
libraries, ``KERNEL_DTYPE`` 0 (float32) and 1 (bfloat16, the name
``<source>_bf16``), which compile in parallel. Libraries land in
``build/marian_tpu_torch/`` beside the package, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.
``build_all`` starts one ``nvcc`` per library, all at once. A library
built with ``-Xptxas -v`` (the bf16 fused CE, flash and packed
attention, whose tensor-core kernels' registers and spills are worth a
look) leaves its kernels' resource lines in ``USAGE``.

Every C entry point takes pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

from ...common import lockdep

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "marian_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# library -> (source in csrc/, its own nvcc flags)
LIBRARIES = {"decode_attention": ("decode_attention", ()),
             "paged_decode_attention": ("paged_decode_attention", ())}
for _src in ("packed_attention", "flash_attention", "fused_ce"):
    LIBRARIES[_src] = (_src, ("-DKERNEL_DTYPE=0",))
    LIBRARIES[f"{_src}_bf16"] = (_src, ("-DKERNEL_DTYPE=1",))
for _src in ("fused_ce", "flash_attention", "packed_attention"):
    LIBRARIES[f"{_src}_bf16"] = (_src, ("-DKERNEL_DTYPE=1", "-Xptxas", "-v"))
# the sources the libraries are built from
SOURCES = tuple(dict.fromkeys(src for src, _ in LIBRARIES.values()))

_lock = lockdep.make_lock("marian_tpu_torch.ops.kernels._build._lock")
_libs: Dict[str, ctypes.CDLL] = {}
# library -> "<kernel>: <registers, shared memory, spills>" lines of its
# last build here with -Xptxas -v
USAGE: Dict[str, List[str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda)")


def kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier in a mangled name: the shortest one
    whose length prefix (the digits just before it, e.g.
    ``17fce_tc_fwd_kernel``) counts exactly its characters, with its
    integer template arguments (``flash_tc_fwd_kernel<64>``); the mangled
    name when none does. Digits of the hash in an anonymous namespace's
    name can count a longer run that also ends at ``_kernel`` (``...cu_
    16167a2f18flash_tc_dq_kernel``); the identifier itself is the
    shortest."""
    found = []
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            end = m.end() + int(digits[i:])
            ident = mangled[m.end():end]
            if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*",
                                                          ident):
                found.append((len(ident), end, ident))
    if not found:
        return mangled
    _, end, ident = min(found)
    args = re.match(r"I(.*?)EE", mangled[end:])
    ints = re.findall(r"Li(-?\d+)E", args.group(1) + "E") if args else []
    return f"{ident}<{', '.join(ints)}>" if ints else ident


def ptxas_usage(log: str) -> List[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name
    (``kernel_name``) with its stack, spill and register lines."""
    out, kernel, props = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, props = kernel_name(m.group(1)), ""
        elif kernel and "spill" in line:
            props = line.strip()
        elif kernel and "registers" in line:
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}; "
                       f"{props}")
            kernel = None
    return out


def _flags(name: str):
    return [*NVCC_FLAGS, *LIBRARIES[name][1]]


def _lib_path(name: str) -> Path:
    # the source, every shared header it may include, and the flags
    src = b"".join(p.read_bytes() for p in [
        CSRC / f"{LIBRARIES[name][0]}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build_all(names: Sequence[str] = tuple(LIBRARIES)) -> Dict[str, float]:
    """Compile every library that is missing, one nvcc each, all started
    together; returns {name: seconds its nvcc took} for those compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    jobs, took = [], {}
    t0 = time.perf_counter()
    try:
        for n in todo:
            out = _lib_path(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = out.with_suffix(f".{os.getpid()}.log")
            cmd = [_nvcc(), *_flags(n), "-o", str(tmp),
                   str(CSRC / f"{LIBRARIES[n][0]}.cu")]
            with open(log, "w") as f:
                jobs.append((n, out, tmp, log, subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT)))
        # poll, so that each library's time is its own nvcc's
        while len(took) < len(jobs):
            time.sleep(0.05)
            for n, out, tmp, log, proc in jobs:
                if n in took or proc.poll() is None:
                    continue
                took[n] = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {n} (csrc/{LIBRARIES[n][0]}.cu, "
                        f"exit {proc.returncode}):\n{log.read_text()}")
                if "-v" in LIBRARIES[n][1]:
                    USAGE[n] = ptxas_usage(log.read_text())
                os.replace(tmp, out)
    finally:
        for _, _, _, log, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.unlink(missing_ok=True)
    return took


def typed(source: str, bf16: bool) -> str:
    """The library of ``source`` for float32 or bfloat16 operands."""
    return f"{source}_bf16" if bf16 else source


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of LIBRARIES), built on first
    use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with "
                           f"cudaError {err}")
