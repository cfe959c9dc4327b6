// Halo-strip builder of the fused stencil conv (K4), as one gather.
//
// Replaces the TPU kernel deepsphere_tpu/ops/pallas_strips.py::_builder_kernel
// (launched by build_strips_pallas).  It builds, for every channel c of the
// cface activation xc (C, 12, n, P_l), the three strip arrays the conv reads:
// top/bot (C, F, R, P_l) and ls (C, F, n, 128), in one allocation in that
// order.  Every strip element is a copy of one activation element (a
// neighbour face's edge, flipped or transposed per
// sphere/faces.py::edge_descriptor) or 0 (the polar 3-way corners and the
// padding).
//
// What bounds it on an H100: memory bandwidth only; it does no arithmetic,
// and most of what it writes is zero padding (in ls only 2h of 128 lanes
// hold data).  The TPU kernel was a program of DMA loads and in-register
// flips because a TPU gathers slowly; here the flip and transpose plan is
// folded on the host into one int32 source map over one channel's strips
// (ops/strips.py::strip_index_map, built once per stencil; -1 for a zero)
// and the kernel is out[c, e] = idx[e] >= 0 ? src[c * slab + idx[e]] : 0.
// Design: each thread owns one 16-byte group of four outputs of one channel's
// strips and writes it for a chunk of kCC channels, so
// * a group in a zero region (top rows [0, R-h), bot rows [h, R), lanes past
//   roundup(n+2h, 4), ls lanes past roundup(2h, 4)) is written as 16-byte
//   zeros without reading the map;
// * a data group reads its four map entries once (one 16-byte load) for all
//   the chunk's channels, keeps them in registers, and gathers four floats
//   (one 16-byte load when they are four aligned consecutive sources) into
//   one 16-byte store per channel.
// Writes are coalesced 16-byte stores.  The output is bit-identical to the
// plain version, since each element is a copy.
//
// The same kernel copies 2-byte elements (the bfloat16 strips of the
// bf16 I/O conv, R = roundup(h, 16), through their own source map): a
// group is then four bfloat16 copied as their bits, 8 bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// channels per block: on an H100, 2 was the fastest or within 1% of it at
// every main-path shape among 1, 2, 4, 8 and 16 (PERF.md)
constexpr int kCC = 2;

// E: the element (float, or unsigned short: a bfloat16's bits); V: four
// of them
template <class E, class V>
__global__ void __launch_bounds__(kThreads)
strips_kernel(const E* __restrict__ src, const int* __restrict__ idx,
              E* __restrict__ out, int C, long long slab, int F,
              int n, int h, int R, int P, int vec) {
  const int tb4 = F * R * (P / 4);  // 16-byte groups of one channel's top
  const int ls4 = F * n * 32;       // ... and of its ls
  const int p4 = blockIdx.x * kThreads + threadIdx.x;
  if (p4 >= 2 * tb4 + ls4) return;
  const int D4 = (n + 2 * h + 3) / 4;  // data groups of a halo row
  const int Dl4 = (2 * h + 3) / 4;     // data groups of an ls row
  long long base, stride;  // in 16-byte groups: this group of channel 0, and
                           // the step from one channel to the next
  bool data;
  if (p4 < 2 * tb4) {
    const bool is_bot = p4 >= tb4;
    const int rem = is_bot ? p4 - tb4 : p4;
    const int c4 = rem % (P / 4);
    const int row = (rem / (P / 4)) % R;
    data = c4 < D4 && (is_bot ? row < h : row >= R - h);
    base = is_bot ? (long long)C * tb4 + rem : rem;
    stride = tb4;
  } else {
    const int rem = p4 - 2 * tb4;
    data = (rem & 31) < Dl4;
    base = 2LL * C * tb4 + rem;
    stride = ls4;
  }
  V* o = reinterpret_cast<V*>(out) + base;
  const int c0 = blockIdx.y * kCC;
  const int c1 = min(C, c0 + kCC);
  if (!data) {
    const V z = {0, 0, 0, 0};
    for (int c = c0; c < c1; ++c) o[c * stride] = z;
    return;
  }
  // the map covers one channel's [top | bot | ls] in the same order
  const int4 m = reinterpret_cast<const int4*>(idx)[p4];
  const bool run = vec && m.x >= 0 && (m.x & 3) == 0 && m.y == m.x + 1
                   && m.z == m.x + 2 && m.w == m.x + 3;
  for (int c = c0; c < c1; ++c) {
    const E* s = src + c * slab;
    V v;
    if (run) {
      v = *reinterpret_cast<const V*>(s + m.x);
    } else {
      v.x = m.x >= 0 ? s[m.x] : E(0);
      v.y = m.y >= 0 ? s[m.y] : E(0);
      v.z = m.z >= 0 ? s[m.z] : E(0);
      v.w = m.w >= 0 ? s[m.w] : E(0);
    }
    o[c * stride] = v;
  }
}

}  // namespace

extern "C" {

// src: (C, slab) sources; idx: one channel's int32 source map over
// [top (F, R, P) | bot (F, R, P) | ls (F, n, 128)], -1 for a zero; out: the
// three strips of C channels in one allocation, [top | bot | ls]; vec: src
// and slab allow loads of four aligned elements; es: bytes of an element,
// 4 (float32) or 2 (bfloat16).  idx must be 16-byte aligned.  Returns
// cudaGetLastError().
int ds_strips(const void* src, const int* idx, void* out, int C,
              long long slab, int F, int n, int h, int R, int P, int vec,
              int es, void* stream) {
  if (reinterpret_cast<size_t>(idx) & 15) return (int)cudaErrorMisalignedAddress;
  if ((es != 4 && es != 2) || C < 1 || F < 1 || F > 12 || n < 1 || h < 1
      || h > R
      || 2 * h > 128 || P % 128 || n + 2 * h > P)
    return (int)cudaErrorInvalidValue;
  const long long groups = 2LL * F * R * (P / 4) + (long long)F * n * 32;
  const long long gy = (C + kCC - 1) / kCC;
  if (gy > 65535 || groups > (1LL << 30)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((groups + kThreads - 1) / kThreads), (unsigned)gy);
  if (es == 4)
    strips_kernel<float, float4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(src), idx, static_cast<float*>(out), C,
        slab, F, n, h, R, P, vec);
  else
    strips_kernel<unsigned short, ushort4>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            static_cast<const unsigned short*>(src), idx,
            static_cast<unsigned short*>(out), C, slab, F, n, h, R, P, vec);
  return (int)cudaGetLastError();
}

const char* ds_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
