"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface: it is compiled on its own
into a shared library and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries land in ``tpu_ray_torch/_build/`` (or
``$TPU_RAY_TORCH_BUILD_DIR``), named by a hash of the source and flags, so
an edited source is rebuilt and an unchanged one is reused (the shared
``csrc/*.cuh`` headers count into every source's hash).

Flags: ``-O3 -gencode arch=compute_90a,code=sm_90a --fmad=false`` and no
fast math.  The sweep's ray-range padding is gone, but the kernels still
rely on IEEE comparisons with NaN and on per-op rounding: ``--fmad=false``
keeps the kernels' arithmetic that of the plain PyTorch versions, so the
discrete decisions (hit, front face, material, path death) agree.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
SOURCES = ("sweep", "sweep_compact", "sweep_mxu", "pool_step", "megakernel",
           "aov", "bvh", "media", "queue")

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}
build_log: dict = {}     # source name -> nvcc's stderr (ptxas register use)
build_seconds: dict = {}


def build_dir() -> str:
    d = os.environ.get("TPU_RAY_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set NVCC or CUDA_HOME)")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    src, so = _target(name)
    if os.path.exists(so):
        return None
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, so


def build_all(names=SOURCES) -> dict:
    """Compile every source that has no current library, one ``nvcc`` per
    source, all started together; returns {name: seconds}."""
    with _lock:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is None:
                build_seconds.setdefault(n, 0.0)
                continue
            proc, tmp, so = job
            out, err = proc.communicate()
            build_log[n] = err
            if proc.returncode != 0:
                for other in jobs.values():      # leave no compiler running
                    if other is not None and other[0].poll() is None:
                        other[0].kill()
                        other[0].wait()
                raise RuntimeError(f"nvcc failed on {n}.cu:\n{out}\n{err}")
            os.replace(tmp, so)
            build_seconds[n] = time.perf_counter() - t0
        return dict(build_seconds)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    lib = ctypes.CDLL(_target(name)[1])
    with _lock:
        _libs[name] = lib
    return lib


def loaded() -> list:
    """The names of the sources whose libraries this process has loaded."""
    with _lock:
        return sorted(_libs)


def load_fn(name: str, symbol: str, argtypes):
    """C function ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared (returns a cudaError_t as int)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn
