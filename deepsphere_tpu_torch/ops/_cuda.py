"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``deepsphere_tpu_torch/csrc/`` (``strips.cu``,
``stencil_conv.cu``) have a plain C interface.  At first use they are
compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared library in the
package's ``_build/`` directory, named by a hash of the sources and flags,
and loaded with ``ctypes``.  Nothing here runs at import: the CPU tests
import every module of the port on a machine without ``nvcc``.

Every kernel wrapper adds one to its entry of :data:`launch_counts` where
it launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time

__all__ = ["build", "lib", "check", "launch_counts", "reset_launch_counts"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> launches since the last :func:`reset_launch_counts`
launch_counts = {"strips": 0, "stencil_conv": 0}

_lib = None


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def build():
    """Compile the kernels if this exact source set has not been built.

    :return: ``(path, seconds, log)`` — the library, the compile time (0
        when it was already built) and nvcc's output (``-Xptxas -v``:
        registers, shared memory and spills per kernel).
    """
    from torch.utils.cpp_extension import CUDA_HOME

    srcs = _sources()
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode() + fh.read())
    path = os.path.join(_BUILD, f"libds_kernels-{h.hexdigest()[:16]}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return path, 0.0, log
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    os.makedirs(_BUILD, exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp"
    cu = [s for s in srcs if s.endswith(".cu")]
    t0 = time.perf_counter()
    res = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), *_FLAGS, "-I", _CSRC,
         "-o", tmp, *cu],
        capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    with open(log_path, "w") as fh:
        fh.write(log)
    os.replace(tmp, path)
    return path, seconds, log


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        L = ctypes.CDLL(path)
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        L.ds_strips.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll, ll, vp]
        L.ds_strips.restype = ci
        L.ds_stencil_conv.argtypes = [vp] * 8 + [ci] * 12 + [vp]
        L.ds_stencil_conv.restype = ci
        L.ds_error_string.argtypes = [ci]
        L.ds_error_string.restype = ctypes.c_char_p
        _lib = L
    return _lib


def check(rc, what):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib().ds_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
