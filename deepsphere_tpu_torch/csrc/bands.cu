// The four edge bands of every face of a face shard, packed for one
// all-gather.
//
// Replaces the TPU kernel deepsphere_tpu/ops/stencil.py::_extract_bands.kern
// (its pallas_call cuts 8-row / 128-lane aligned bands by DMA, then XLA
// slices them to depth h).  For the cface activation xc (C, F, n, P) of a
// face shard (F faces, face col y at lane y + off), it writes the h-deep
// bands at the interior lanes [off, off + n):
//
//   first rows   xc[c, f, 0:h,   off:off+n]        (h, n)
//   last rows    xc[c, f, n-h:n, off:off+n]        (h, n)
//   first cols   xc[c, f, :,     off:off+h]        (n, h)
//   last cols    xc[c, f, :,     off+n-h:off+n]    (n, h)
//
// packed face-major into out (F, C, 4*h*n), the four bands of one (face,
// channel) one after the other in that order.  Face-major is what makes one
// collective enough: the all-gather over the face shards concatenates the
// ranks' buffers, which is then the face order (12, C, 4*h*n), and the halo
// strips of any face are read from it through a host-built source map
// (ops/strips.py::band_strip_index_map, the K4 gather kernel).  The TPU
// issued one all-gather per band.
//
// What bounds it on an H100: memory bandwidth only; it does no arithmetic.
// The TPU kernel's 8-row / 128-lane alignment and its gates (compile mode,
// n >= 128, off + h <= 128) were workarounds for its layouts and are not
// carried over: this kernel runs at every shape.  One thread per output
// element, one grid row per (channel, face), so every index is 32-bit and a
// block writes 256 consecutive floats; the row bands' reads are contiguous
// runs of n floats, the column bands' reads runs of h floats with a stride
// of P.  At the shapes of the model the bands are a few MB, so the launch
// itself is most of the time.  Each element is a copy: the output is
// bit-identical to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// grid: (ceil(4hn / kThreads), C, F)
__global__ void __launch_bounds__(kThreads)
bands_kernel(const float* __restrict__ xc, float* __restrict__ out, int C,
             int F, int n, int h, int P, int off) {
  const int band = h * n;
  const int j = blockIdx.x * kThreads + threadIdx.x;  // in (face, channel)
  if (j >= 4 * band) return;
  const int c = blockIdx.y;
  const int f = blockIdx.z;
  const int seg = j / band;
  const int r = j - seg * band;
  int row, col;
  if (seg < 2) {  // row bands, (h, n)
    row = r / n + (seg == 1 ? n - h : 0);
    col = r - (r / n) * n;
  } else {  // column bands, (n, h)
    row = r / h;
    col = r - row * h + (seg == 3 ? n - h : 0);
  }
  const long long src = (((long long)c * F + f) * n + row) * P + off + col;
  out[((long long)f * C + c) * 4 * band + j] = xc[src];
}

}  // namespace

extern "C" {

// xc: (C, F, n, P) activations, face col y at lane y + off; out: (F, C,
// 4*h*n).  Returns cudaGetLastError().
int ds_bands(const float* xc, float* out, int C, int F, int n, int h, int P,
             int off, void* stream) {
  if (C < 1 || C > 65535 || F < 1 || F > 65535 || n < 1 || h < 1 || h > n
      || off < 0 || off + n > P)
    return (int)cudaErrorInvalidValue;
  dim3 grid((4 * h * n + kThreads - 1) / kThreads, C, F);
  bands_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(xc, out, C, F, n,
                                                            h, P, off);
  return (int)cudaGetLastError();
}

}  // extern "C"
