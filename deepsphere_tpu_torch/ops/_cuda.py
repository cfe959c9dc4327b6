"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``deepsphere_tpu_torch/csrc/`` (``strips.cu``,
``stencil_conv.cu`` with the instantiations of ``stencil_conv.cuh`` spread
over ``stencil_conv*.cu``, ``stencil_dxdw.cu`` and ``stencil_grad.cu`` as
the two modes of the backward template ``stencil_bwd.cuh``, which runs its
laps and stages its windows through K1's device functions, with their
instantiations spread over
``stencil_dxdw_r*.cu`` and ``stencil_grad_r*.cu``, the bfloat16
instantiations of all three in ``*_bf16*.cu``, and ``bands.cu``) have
a plain C interface.
At first use each ``.cu`` is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into one
shared library in the package's ``_build/`` directory, named by a hash of
the sources and flags, and loaded with ``ctypes``.  Nothing here runs at import: the CPU tests
import every module of the port on a machine without ``nvcc``.

The kernels are reached through their custom ops (:mod:`.library`): each
op's CUDA implementation adds one to its entry of :data:`launch_counts`
where it launches its kernel, and nowhere else, so a run (a replayed
``torch.export`` artifact too) can show that its main path went through
the kernels; a bfloat16 instantiation counts in :data:`bf16_launch_counts`
instead, by kernel and mode (``_bf16``: the band mode on float32 arrays,
``_bf16_io``: bfloat16 arrays; ``strips_bf16``: K4 on 2-byte elements),
K1's, K2's and K3's launches in 2-byte shared elements apart (``_s2``:
the shapes where only those fit, ``fused_stencil._k1_bf16_staging`` and
``_bwd_bf16_staging``).
Beside them, :data:`route_counts` counts
the routes chosen from a shape that launch none of these kernels (the
cface conv's per-step route, ``ops/stencil.py::_cface_per_step``) or that
choose which launches run (the lap chain: ``lap_chain`` for each conv that
takes it, ``chain_cface`` for a cface conv on it; the smoothing chain:
``smooth_fused`` on the fused conv, ``smooth_per_step`` where its stencil
does not fit the fused conv).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time

__all__ = ["build", "lib", "check", "launch_counts", "bf16_launch_counts",
           "route_counts", "reset_launch_counts"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> launches since the last :func:`reset_launch_counts`
launch_counts = {"strips": 0, "stencil_conv": 0, "dxdw": 0, "grad": 0,
                 "bands": 0}
#: bfloat16 instantiation -> launches since the last :func:`reset_launch_counts`
bf16_launch_counts = {"strips_bf16": 0, "stencil_conv_bf16": 0,
                      "stencil_conv_bf16_io": 0, "stencil_conv_bf16_s2": 0,
                      "stencil_conv_bf16_io_s2": 0, "dxdw_bf16": 0,
                      "dxdw_bf16_io": 0, "dxdw_bf16_s2": 0,
                      "dxdw_bf16_io_s2": 0, "grad_bf16": 0, "grad_bf16_io": 0,
                      "grad_bf16_s2": 0, "grad_bf16_io_s2": 0}
#: route name -> times taken since the last :func:`reset_launch_counts`
route_counts = {"per_step_cface": 0, "chain_cface": 0, "lap_chain": 0,
                "smooth_fused": 0, "smooth_per_step": 0}

_lib = None


def reset_launch_counts():
    """Set every launch count and every route count to 0."""
    for counts in (launch_counts, bf16_launch_counts, route_counts):
        for k in counts:
            counts[k] = 0


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh"))
                  + glob.glob(os.path.join(_CSRC, "*.h")))


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
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    cu = [s for s in srcs if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    procs = [subprocess.Popen([nvcc, *_FLAGS, "-I", _CSRC, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(cu, objs)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    log = "".join(outs)
    bad = [s for s, p in zip(cu, procs) if p.returncode != 0]
    if not bad:
        res = subprocess.run([nvcc, *_FLAGS, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True, timeout=600)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            bad = ["(link)"]
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    seconds = time.perf_counter() - t0
    if bad:
        raise RuntimeError(f"nvcc failed for {bad}:\n{log}")
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
        L.ds_strips.argtypes = [vp, vp, vp, ci, ll] + [ci] * 7 + [vp]
        L.ds_strips.restype = ci
        L.ds_stencil_conv.argtypes = [vp] * 7 + [ci] * 17 + [vp]
        L.ds_stencil_conv.restype = ci
        L.ds_stencil_dxdw.argtypes = [vp] * 11 + [ci] * 17 + [vp]
        L.ds_stencil_dxdw.restype = ci
        L.ds_stencil_grad.argtypes = [vp] * 8 + [ci] * 17 + [vp]
        L.ds_stencil_grad.restype = ci
        L.ds_bands.argtypes = [vp, vp] + [ci] * 6 + [vp]
        L.ds_bands.restype = ci
        L.ds_error_string.argtypes = [ci]
        L.ds_error_string.restype = ctypes.c_char_p
        _lib = L
    return _lib


def check(rc, what):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib().ds_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
