"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``kernels/<name>/csrc/<name>.cu`` compiles on its own, with ``nvcc`` for
``sm_90a``, into a shared library with a plain C interface under
``build/kernels/`` at the root of the checkout.  The library's file name
carries a hash of the source and the flags, so an edited source rebuilds and
an unchanged one loads at once.  ``ptxas -v`` reports each kernel's
registers, stack frame and spills in the build's output, which
:data:`logs` keeps and :func:`resource_usage` reads.  Nothing here runs at
import: the CPU tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}  # kernel name -> ctypes.CDLL, one load per process
logs: dict = {}  # kernel name -> nvcc's output of its build in this process
# Guards _loaded and the builds: the runtime's stepper thread may reach a
# kernel's first use while another thread does, and two nvcc runs of one
# process would write the same temporary file.
_lock = threading.RLock()


def sources() -> dict:
    """``{name: path}`` of every kernel source in the package."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``; raises with the compiler's output if any
    build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = set(names) - set(srcs)
    if missing:
        raise KeyError(f"no kernel source for {sorted(missing)}")
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out, running = {}, []
        for name in names:
            lib = _target(srcs[name])
            out[name] = lib
            if not lib.exists():
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(srcs[name])]
                running.append((name, lib, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        failures = []
        for name, lib, tmp, proc in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- {name} (nvcc exit "
                                f"{proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)  # atomic: no reader sees half a file
                logs[name] = log
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failures))
        return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(str(build_all([name])[name]))
            lib = _loaded[name]
    return lib


def compile_log(name: str) -> str:
    """nvcc's output for kernel ``name``: its build's in this process, or
    that of a compile into nothing when the library was built before."""
    with _lock:
        if name not in logs:
            out = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", os.devnull,
                 str(sources()[name])], capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{out.stdout}{out.stderr}")
            logs[name] = out.stdout + out.stderr
        return logs[name]


def resource_usage(log: str) -> list:
    """Each kernel that ``ptxas -v`` reports in ``log``, in its order:
    ``{"function", "stack", "spill_stores", "spill_loads", "registers"}``
    (bytes a thread; registers a thread)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None and "registers" not in cur:
            cur["registers"] = int(m.group(1))
    return out
