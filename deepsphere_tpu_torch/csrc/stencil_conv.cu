// Fused K-term polynomial stencil conv on the HEALPix face layout.
//
// Replaces the TPU kernel deepsphere_tpu/ops/pallas_stencil.py::_stencil_kernel
// (launched by _run_stencil_kernel).  For every output pixel of the cface
// layout it computes y[b, fo] = sum_k sum_fi W[k, fi, fo] * T_k(L~) x[b, fi],
// the Chebyshev (T_k = 2 L~ T_{k-1} - T_{k-2}) or monomial (T_k = L~ T_{k-1})
// recursion of the rescaled Laplacian in its (2r+1)^2-tap stencil form with
// per-pixel weights.  The result is the raw conv: the rows near the 8 polar
// corners that a rectangular face extension cannot represent are corrected
// afterwards in ops/fused_stencil.py, as on the TPU.
//
// Layout: xc (B*Fin, F, n, P) with face col y at lane y + h, F the faces the
// arrays hold (12, or a face shard's F_loc); row-halo strips top/bot
// (B*Fin, F, R, P) with the h halo rows at [R-h, R) / [0, h); lane strips ls
// (B*Fin, F, n, 128), west at [0, h), east at [h, 2h); weight planes wext
// (nplanes, F, n + 2R, P) in the wrapped-extended layout (rows [n, n+R) hold
// face rows [-R, 0), rows [n+R, n+2R) hold face rows [n, n+R)); wk3
// (K, Fin, Fout); out (B*Fout, F, n, P), zero outside the interior lanes.
//
// What bounds it on an H100, by count: at the quick_start widths, arithmetic
// (the contraction is Fin*Fout FMAs per pixel and term, the recursion 9 per
// pixel, channel and lap); at the headline conv (Fin = Fout = 4), the reads
// of the weight planes, the largest array.  This first version runs well
// below both bounds (PERF.md has its times): the lap loop's shared-memory
// reads and index arithmetic are the suspects.  The design keeps every
// intermediate on chip: one block per (face, T x T tile,
// batch index, chunk of 8 output channels) stages the tile's weight window in
// shared memory once, then for each input channel loads the (T+2h)^2 halo
// window, runs the K-1 laps in shared memory on a region that shrinks by r
// per lap (only what the centre still needs), and folds each term into
// 8 x 4 f32 accumulators in registers.  The activation is read once per
// output-channel chunk and the output written once; the per-step path
// instead writes and re-reads the map on every lap.  Plain f32 FMAs, no
// tensor cores, no TF32.  Faster forms (batch inside the block so the weight
// window is read once per tile, cp.async/TMA staging, wgmma for the
// contraction at large Fin*Fout) are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPix = 4;      // output pixels per thread: T <= 32
constexpr int kFoChunk = 8;     // output channels per block
constexpr int kMaxPlanes = 81;  // stencil radius <= 4

struct ConvArgs {
  const float* xc;
  const float* top;
  const float* bot;
  const float* ls;
  const float* wext;
  const float* wk3;
  const int* offs;
  float* out;
  int cheby, K, radius, nplanes, F, Fin, Fout, n, h, R, P, T, tiles, chunks;
};

__global__ void __launch_bounds__(kThreads)
stencil_conv_kernel(const ConvArgs a) {
  extern __shared__ float smem[];
  __shared__ int s_dx[kMaxPlanes];
  __shared__ int s_dy[kMaxPlanes];

  const int tid = threadIdx.x;
  const int r = a.radius;
  const int W0 = a.T + 2 * a.h;  // halo window side
  const int Ww = W0 - 2 * r;     // weight window side (lap 1's region)
  const int wsz = Ww * Ww;
  float* s_w = smem;                         // nplanes * Ww * Ww
  float* b0 = s_w + a.nplanes * wsz;         // three W0 * W0 term buffers
  float* b1 = b0 + W0 * W0;
  float* b2 = b1 + W0 * W0;

  const int f = blockIdx.y;
  const int b = blockIdx.z / a.chunks;
  const int fo0 = (blockIdx.z % a.chunks) * kFoChunk;
  const int x0 = (blockIdx.x / a.tiles) * a.T;
  const int y0 = (blockIdx.x % a.tiles) * a.T;
  const long long nr = a.n + 2 * a.R;  // rows of one weight plane

  for (int d = tid; d < a.nplanes; d += kThreads) {
    s_dx[d] = a.offs[2 * d];
    s_dy[d] = a.offs[2 * d + 1];
  }
  // weight window: s_w[d][i][j] is plane d at window position (i+r, j+r),
  // i.e. face row x0 - h + r + i, lane y0 + r + j
  for (int e = tid; e < a.nplanes * wsz; e += kThreads) {
    const int d = e / wsz;
    const int rem = e - d * wsz;
    const int i = rem / Ww;
    const int j = rem - i * Ww;
    const int x = x0 - a.h + r + i;
    const int row = x < 0 ? a.n + a.R + x : (x >= a.n ? a.R + x : x);
    s_w[e] = a.wext[((long long)(d * a.F + f) * nr + row) * a.P + y0 + r + j];
  }

  float acc[kMaxPix][kFoChunk];
#pragma unroll
  for (int p = 0; p < kMaxPix; ++p)
#pragma unroll
    for (int j = 0; j < kFoChunk; ++j) acc[p][j] = 0.f;

  const int npix = a.T * a.T;
  for (int fi = 0; fi < a.Fin; ++fi) {
    const long long cf = ((long long)b * a.Fin + fi) * a.F + f;
    __syncthreads();  // the previous channel is done with the buffers
    float* p2 = b2;
    float* p1 = b0;
    float* cur = b1;
    // halo window: position (i, j) is face row x0 - h + i, lane y0 + j
    for (int e = tid; e < W0 * W0; e += kThreads) {
      const int i = e / W0;
      const int j = e - i * W0;
      const int x = x0 - a.h + i;
      const int lane = y0 + j;
      float v;
      if (x < 0) {
        v = a.top[(cf * a.R + a.R + x) * a.P + lane];
      } else if (x >= a.n) {
        v = a.bot[(cf * a.R + x - a.n) * a.P + lane];
      } else if (lane < a.h) {  // west lane strip
        v = a.ls[(cf * a.n + x) * 128 + lane];
      } else if (lane >= a.h + a.n) {  // east lane strip
        v = a.ls[(cf * a.n + x) * 128 + lane - a.n];
      } else {
        v = a.xc[(cf * a.n + x) * a.P + lane];
      }
      p1[e] = v;
    }
    __syncthreads();

    for (int k = 0; k < a.K; ++k) {
      if (k > 0) {
        // lap k: valid on [r*k, W0 - r*k)^2
        const int lo = r * k;
        const int L = W0 - 2 * lo;
        const bool twice = a.cheby && k >= 2;
        for (int e = tid; e < L * L; e += kThreads) {
          const int i = lo + e / L;
          const int j = lo + e % L;
          const float* wij = s_w + (i - r) * Ww + (j - r);
          float s = 0.f;
          for (int d = 0; d < a.nplanes; ++d)
            s += wij[d * wsz] * p1[(i + s_dx[d]) * W0 + j + s_dy[d]];
          cur[i * W0 + j] = twice ? 2.f * s - p2[i * W0 + j] : s;
        }
        __syncthreads();
        float* t = p2;
        p2 = p1;
        p1 = cur;
        cur = t;
      }
      // fold term k (in p1) into the accumulators
      float wk[kFoChunk];
#pragma unroll
      for (int j = 0; j < kFoChunk; ++j) {
        const int fo = fo0 + j;
        wk[j] = fo < a.Fout ? a.wk3[((long long)k * a.Fin + fi) * a.Fout + fo]
                            : 0.f;
      }
#pragma unroll
      for (int p = 0; p < kMaxPix; ++p) {
        const int pix = tid + p * kThreads;
        if (pix < npix) {
          const int ti = pix / a.T;
          const int tj = pix - ti * a.T;
          const float v = p1[(a.h + ti) * W0 + a.h + tj];
#pragma unroll
          for (int j = 0; j < kFoChunk; ++j) acc[p][j] += wk[j] * v;
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kMaxPix; ++p) {
    const int pix = tid + p * kThreads;
    if (pix < npix) {
      const int ti = pix / a.T;
      const int tj = pix - ti * a.T;
#pragma unroll
      for (int j = 0; j < kFoChunk; ++j) {
        const int fo = fo0 + j;
        if (fo < a.Fout) {
          const long long o = ((long long)(b * a.Fout + fo) * a.F + f) * a.n;
          a.out[(o + x0 + ti) * a.P + a.h + y0 + tj] = acc[p][j];
        }
      }
    }
  }
  // lanes outside the interior are zero: [0, h) by the first tile column,
  // [h + n, P) by the last
  const int wlo = y0 == 0 ? a.h : 0;
  const int whi = y0 + a.T == a.n ? a.P - a.h - a.n : 0;
  const int wpad = wlo + whi;
  if (wpad > 0) {
    for (int e = tid; e < kFoChunk * a.T * wpad; e += kThreads) {
      const int j = e / (a.T * wpad);
      const int rem = e - j * a.T * wpad;
      const int ti = rem / wpad;
      const int l = rem - ti * wpad;
      const int fo = fo0 + j;
      if (fo < a.Fout) {
        const long long o = ((long long)(b * a.Fout + fo) * a.F + f) * a.n;
        const int lane = l < wlo ? l : a.h + a.n + (l - wlo);
        a.out[(o + x0 + ti) * a.P + lane] = 0.f;
      }
    }
  }
}

}  // namespace

extern "C" {

// kind: 0 Chebyshev, 1 monomial.  F: faces in the arrays.  T: tile side
// (<= 32, divides n).  Returns cudaGetLastError() after the launch (or the
// attribute error).
int ds_stencil_conv(const float* xc, const float* top, const float* bot,
                    const float* ls, const float* wext, const float* wk3,
                    const int* offs, float* out, int kind, int K, int radius,
                    int nplanes, int B, int F, int Fin, int Fout, int n, int h,
                    int R, int P, int T, void* stream) {
  if (T < 1 || T > 32 || n % T || nplanes > kMaxPlanes || radius * (K - 1) > h
      || K < 1 || B < 1 || F < 1 || F > 12 || Fin < 1 || Fout < 1)
    return (int)cudaErrorInvalidValue;
  ConvArgs a{xc, top, bot, ls, wext, wk3, offs, out,
             kind == 0, K, radius, nplanes, F, Fin, Fout, n, h, R, P, T,
             n / T, (Fout + kFoChunk - 1) / kFoChunk};
  const int W0 = T + 2 * h;
  const int Ww = W0 - 2 * radius;
  const size_t smem = sizeof(float) * ((size_t)nplanes * Ww * Ww
                                       + 3 * (size_t)W0 * W0);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.tiles * a.tiles, F, B * a.chunks);
  stencil_conv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
