// K5: the four edge bands of every face of a face shard, packed for one
// all-gather.
//
// Replaces the TPU kernel deepsphere_tpu/ops/stencil.py::_extract_bands.kern
// (:82; its pallas_call cuts 8-row / 128-lane aligned bands by DMA, then XLA
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
// issued one all-gather per band.  Each element is a copy: the output is
// bit-identical to the plain version (ops/stencil.py::pack_edge_bands_plain).
// The TPU kernel's 8-row / 128-lane alignment and its gates (compile mode,
// n >= 128, off + h <= 128) were workarounds for its layouts and are not
// carried over: this kernel runs at every shape.
//
// What bounds it on an H100: memory traffic only; it does no arithmetic.
// The least it must move is each distinct interior source element once,
// n^2 - max(n - 2h, 0)^2 floats per (channel, face), and the output once,
// 4hn floats.  At the model's shapes that is 3-25 MB, a few microseconds at
// 3.35 TB/s, so the grid's shape, its tails and the instructions spent per
// byte weigh as much as the bandwidth.
//
// What the design does about it:
// - The work is the output in float4 units: one (face, channel) plane is
//   4hn floats, hn units, and 4hn is a multiple of 4, so every unit is one
//   aligned 16-byte store.  The C planes of a face are one contiguous run
//   of C*hn units, one unit a thread, and the grid is (blocks over that
//   run, faces): one tail per face, not one per (channel, face) (the first
//   version's grid idled 25% of its threads at n = 16, h = 9), and a
//   quarter of the first version's threads and blocks.  Four units a
//   thread, loads first, made no shape faster on an H100.
// - Index arithmetic per 16 bytes, not per float: one division finds a
//   unit's plane; its row in its band is a shift when n is a power of two,
//   or a division by a compile-time constant in the column bands at h = 4
//   and 9, the model's depths (other h take a generic instance).
// - Loads: a unit whose four floats are consecutive lanes of one source row
//   reads the aligned 16-byte runs that hold them: one float4 where they
//   start aligned (every unit at the headline, off = h = 4, n = 1024), else
//   two, shifted together in registers (the quick_start rows start at lane
//   h = 9, 4 bytes past a 16-byte boundary).  A unit that crosses the end
//   of a band line (a column band's run of 9 floats ends inside a unit)
//   loads its four floats one by one, as does every unit of an xc that is
//   not 16-byte aligned with rows of a multiple of 4 floats.
// - What the layout costs against the bytes bound: a column band reads a
//   run of h floats from each row, h*4 bytes of a 32-byte sector or two,
//   and at the headline each run is a separate access to device memory
//   (rows are P*4 = 4608 bytes apart, the two runs of a row 4 KB apart):
//   2 x 1016 scattered 16-byte reads per plane, 390,000 in all.  Those
//   reads, not the bytes, set the headline's time, which stays far from
//   its bytes bound; neither the order of the runs (a row's second run
//   beside the next row's first) nor the L2 fetch granularity moved it.
// - Small faces read straight from global memory too.  Where n <= 4h the
//   four bands hold at least as many elements as the interior, so a block
//   could stage whole interiors in shared memory (2-8 planes a block, each
//   source element read once in aligned 16-byte runs) and write the bands
//   from there.  Tried on an H100 (chip_smoke.py --compare, in turns with
//   this kernel), it ran no faster at n = 16, h = 9 and 17% slower at
//   n = 32, h = 9: the overlapping bands' re-reads already hit L2, and
//   staging puts a barrier between each block's loads and its stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geo {
  int n, h, P, off;
  int lg_n;  // log2(n) where n is a power of two, else -1
  bool vec;  // xc 16-byte aligned and P % 4 == 0: every row starts aligned
};

// Four consecutive floats e..e+3 of one plane's packed bands, read from src
// (the plane's first row at lane off).  H > 0 is h at compile time.
template <int H>
__device__ __forceinline__ float4 gather4(const float* __restrict__ src,
                                          unsigned e, const Geo& g) {
  const int n = g.n;
  const int h = H > 0 ? H : g.h;
  const unsigned hn = (unsigned)h * n;
  int seg = (e >= hn) + (e >= 2 * hn) + (e >= 3 * hn);
  const unsigned r = e - seg * hn;
  int row, col, width;
  if (seg < 2) {  // row bands, (h, n)
    row = g.lg_n >= 0 ? (int)(r >> g.lg_n) : (int)(r / (unsigned)n);
    col = (int)r - row * n;
    width = n;
  } else {  // column bands, (n, h)
    row = (int)(r / (unsigned)h);
    col = (int)r - row * h;
    width = h;
  }
  auto at = [&](int s, int rw, int cl) {
    return src + (long long)(rw + (s == 1 ? n - h : 0)) * g.P + cl
           + (s == 3 ? n - h : 0);
  };
  const float* p = at(seg, row, col);
  if (g.vec && col + 3 < width) {
    // four lanes of one row: the aligned 16-byte runs that hold them
    const int s = (int)(((uintptr_t)p >> 2) & 3);
    const float4* a = reinterpret_cast<const float4*>(p - s);
    const float4 lo = __ldg(a);
    if (s == 0) return lo;
    const float4 hi = __ldg(a + 1);
    return s == 1   ? make_float4(lo.y, lo.z, lo.w, hi.x)
           : s == 2 ? make_float4(lo.z, lo.w, hi.x, hi.y)
                    : make_float4(lo.w, hi.x, hi.y, hi.z);
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __ldg(at(seg, row, col));
    if (++col == width) {  // the next float starts the next band line
      col = 0;
      if (++row == (seg < 2 ? h : n)) {
        row = 0;
        ++seg;
        width = seg < 2 ? n : h;
      }
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// grid: (ceil(C*h*n / kThreads), F); thread t of block b takes unit
// b*kThreads + t of face blockIdx.y
template <int H>
__global__ void __launch_bounds__(kThreads)
bands_kernel(const float* __restrict__ xc, float* __restrict__ out, int C,
             int F, Geo g) {
  const unsigned hn = (unsigned)(H > 0 ? H : g.h) * g.n;
  const unsigned u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= (unsigned)C * hn) return;
  const int f = blockIdx.y;
  const unsigned c = u / hn, q = u - c * hn;  // plane (f, c), its unit q
  const float* src = xc + ((long long)c * F + f) * g.n * g.P + g.off;
  const float4 v = gather4<H>(src, 4 * q, g);
  *reinterpret_cast<float4*>(out + (((long long)f * C + c) * hn + q) * 4) = v;
}

template <int H>
int launch(const float* xc, float* out, int C, int F, const Geo& g,
           cudaStream_t stream) {
  const long long units = (long long)C * g.h * g.n;  // of one face
  const dim3 grid((unsigned)((units + kThreads - 1) / kThreads), F);
  bands_kernel<H><<<grid, kThreads, 0, stream>>>(xc, out, C, F, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xc: (C, F, n, P) activations, face col y at lane y + off; out: (F, C,
// 4*h*n), 16-byte aligned.  Returns a CUDA error code (0 on success).
int ds_bands(const float* xc, float* out, int C, int F, int n, int h, int P,
             int off, void* stream) {
  if (C < 1 || C > 65535 || F < 1 || F > 65535 || n < 1 || h < 1 || h > n
      || off < 0 || off + n > P || (long long)C * h * n > (1LL << 31)
      || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Geo g{n, h, P, off, (n & (n - 1)) == 0 ? __builtin_ctz(n) : -1,
              ((uintptr_t)xc & 15) == 0 && P % 4 == 0};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (h) {
    case 4: return launch<4>(xc, out, C, F, g, s);
    case 9: return launch<9>(xc, out, C, F, g, s);
    default: return launch<0>(xc, out, C, F, g, s);
  }
}

}  // extern "C"
