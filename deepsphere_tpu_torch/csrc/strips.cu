// Halo-strip builder of the fused stencil conv, as one gather.
//
// Replaces the TPU kernel deepsphere_tpu/ops/pallas_strips.py::_builder_kernel
// (launched by build_strips_pallas).  It builds, for every channel c of the
// cface activation xc (C, 12, n, P_l), the three strip arrays the conv reads:
// top/bot (C, 12, R, P_l) and ls (C, 12, n, 128).  Every strip element is a
// copy of one activation element (a neighbour face's edge, flipped or
// transposed per sphere/faces.py::edge_descriptor) or 0 (the polar 3-way
// corners and the padding).
//
// What bounds it on an H100: memory bandwidth only; it does no arithmetic.
// The TPU kernel was a program of DMA loads and in-register flips because a
// TPU gathers slowly; a GPU gathers at bandwidth, so here the whole flip and
// transpose plan is folded on the host into one int32 source map
// (ops/strips.py::strip_index_map, built once per stencil) and the kernel is
// out[c, e] = idx[e] >= 0 ? xc[c, idx[e]] : 0.  Writes are coalesced; the
// reads of the transposed edges are strided, but they are a few percent of
// the bytes (the ls array is mostly padding).  The output is bit-identical
// to the plain version, since each element is a copy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
strips_kernel(const float* __restrict__ xc, const int* __restrict__ idx,
              float* __restrict__ top, float* __restrict__ bot,
              float* __restrict__ ls, long long slab, long long e_tb,
              long long e_ls) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long c = blockIdx.y;
  if (e >= 2 * e_tb + e_ls) return;
  const int s = idx[e];
  const float v = s >= 0 ? xc[c * slab + s] : 0.f;
  if (e < e_tb) {
    top[c * e_tb + e] = v;
  } else if (e < 2 * e_tb) {
    bot[c * e_tb + (e - e_tb)] = v;
  } else {
    ls[c * e_ls + (e - 2 * e_tb)] = v;
  }
}

}  // namespace

extern "C" {

// xc: (C, slab) activations; idx: (2*e_tb + e_ls) int32 source map;
// top/bot: (C, e_tb); ls: (C, e_ls).  Returns cudaGetLastError().
int ds_strips(const float* xc, const int* idx, float* top, float* bot,
              float* ls, long long C, long long slab, long long e_tb,
              long long e_ls, void* stream) {
  const long long total = 2 * e_tb + e_ls;
  if (C < 1 || C > 65535 || total < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((total + kThreads - 1) / kThreads), (unsigned)C);
  strips_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xc, idx, top, bot, ls, slab, e_tb, e_ls);
  return (int)cudaGetLastError();
}

const char* ds_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
