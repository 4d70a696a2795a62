"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface,
``<repo>/build/repro_torch/<name>-<hash>.so``, and loaded with ``ctypes``.
The hash covers the source, the shared headers and the flags, so an edit
rebuilds and an unchanged tree reuses the library.  ``build()`` starts one
``nvcc`` per missing library, all at once, and keeps what ptxas reports of
each kernel's registers, static shared memory and spills in ``PTXAS``.

Every C entry returns ``cudaGetLastError()`` after its launch;
``check`` raises on a nonzero code.  This module is imported only by the
kernel wrappers' CUDA branches, so nothing on a CPU-only machine touches it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

# What ptxas reported for each source built in this process: per kernel
# instantiation (demangled where c++filt is present) its registers, static
# shared-memory bytes and spill-store bytes.
PTXAS: dict[str, list[dict]] = {}

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def _demangle(names: list[str]) -> list[str]:
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt or not names:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names), text=True,
                         capture_output=True, timeout=60)
    got = out.stdout.splitlines()
    return got if out.returncode == 0 and len(got) == len(names) else names


def parse_ptxas(out: str) -> list[dict]:
    """Each kernel entry of ptxas's ``-v`` report: its name, registers,
    static shared memory (bytes) and spill stores (bytes)."""
    entries: list[dict] = []
    for line in out.splitlines():
        m = _ENTRY.search(line)
        if m:
            entries.append({"kernel": m.group(1), "registers": None,
                            "smem": 0, "spill_bytes": 0})
            continue
        if not entries:
            continue
        m = _SPILL.search(line)
        if m:
            entries[-1]["spill_bytes"] = int(m.group(1))
        m = _USED.search(line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
            entries[-1]["smem"] = int(m.group(2) or 0)
    for e, name in zip(entries, _demangle([e["kernel"] for e in entries])):
        e["kernel"] = name
    return entries


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named source (default: all) whose library is missing,
    one ``nvcc`` each, started together.  Returns seconds per source
    built; raises with the compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    seconds, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
            PTXAS[name] = parse_ptxas(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
