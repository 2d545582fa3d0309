"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, into the package's
git-ignored ``_build/`` directory, keyed by a hash of the source and the
flags; it is then loaded with ``ctypes``. Nothing here runs at import, so
the CPU-only test environment imports every module without a toolchain.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# --fmad=false: no multiply-add contraction anywhere in a kernel, so a kernel
# that rounds like its plain PyTorch version can equal it bit for bit.
# -Xptxas -v: registers, shared memory and spills per kernel, kept in the
# build record (and beside the library, for a later process that finds it
# built) for the smoke run to print.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()                  # guards _name_locks
_name_locks = {}                          # one build at a time per source
_libs = {}
# name -> {"path", "seconds", "log"}: what this process built or found
builds = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin, default /usr/local/cuda/bin)")


def _build(name: str) -> dict:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")
    if os.path.exists(so):
        log = "(cached build)"
        if os.path.exists(so + ".log"):
            with open(so + ".log") as f:
                log = f.read()
        return {"path": so, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    log = (r.stdout + r.stderr).strip()
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", so + ".log")
    os.replace(tmp, so)
    return {"path": so, "seconds": time.perf_counter() - t0, "log": log}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built on first use.

    ``signatures`` maps each C entry point to ``(restype, argtypes)``; every
    pointer and the stream must be ``ctypes.c_void_p`` so that 64-bit
    addresses are not cut. Raises if the build or the load fails. Distinct
    sources build in parallel when loaded from several threads."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            info = _build(name)
            lib = ctypes.CDLL(info["path"])
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            builds[name] = info
            _libs[name] = lib
        return lib


def ptxas_resources(name: str, kernel: str) -> dict:
    """What ``-Xptxas -v`` said of ``kernel`` in the loaded ``csrc/<name>.cu``:
    its ``registers`` a thread and static shared memory (``smem``, bytes;
    dynamic shared memory is the launch's), and the bytes of spill stores
    and loads (``spill_stores``, ``spill_loads``) of the entry functions
    whose name holds ``kernel`` and of every function that is not an entry
    (one a kernel may call). Raises if the log does not name the kernel."""
    log = builds[name]["log"].splitlines()
    entries = {m[1] for line in log
               for m in [re.search(r"Compiling entry function '([^']+)'",
                                   line)] if m}
    regs = smem = None
    spills = [0, 0]
    inside = False
    props = ""
    for line in log:
        if "Compiling entry function" in line:
            inside = kernel in line
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (kernel in props or props not in entries):
            spills = [spills[0] + int(m[1]), spills[1] + int(m[2])]
        m = re.search(r"Used (\d+) registers", line)
        if inside and m:
            regs = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            smem = int(m[1]) if m else 0
    if regs is None:
        raise RuntimeError(f"the build log of csrc/{name}.cu names no "
                           f"{kernel}")
    return dict(registers=regs, smem=smem, spill_stores=spills[0],
                spill_loads=spills[1])
