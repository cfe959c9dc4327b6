// The tile kernel shared by the two backward kernels of the fused stencil
// conv (K2, stencil_dxdw.cu; K3, stencil_grad.cu).  Its window, laps and
// output tile are those of the forward kernel (K1, stencil_conv.cu), which
// keeps its own copy: K1 compiled from this template ran 3-17% slower on an
// H100.
//
// One block takes one (face f, T x T tile, batch index b, chunk of 8
// "chunk" channels).  It stages the tile's weight window (the (2r+1)^2
// per-pixel planes of the rescaled Laplacian) in shared memory once, then for
// each "recursion" channel loads the exact (T+2h)^2 halo window of that
// channel (interior from x, the cross-face halo from the three strip arrays),
// runs the K-1 laps of the Chebyshev (T_k = 2 L~ T_{k-1} - T_{k-2}) or
// monomial (T_k = L~ T_{k-1}) recursion in shared memory on a region that
// shrinks by r per lap, and folds every term k into the block's results as
// soon as it exists:
//
//   kDxDw (K2):  acc[p][j] += W[k, rc, c0+j] * T_k(x)[p]  (registers, as K1)
//                dW[k, c0+j, rc] += sum_p o[p][j] * T_k(x)[p]
//   kGrad (K3):  dW[k, rc, c0+j] += sum_p o[p][j] * T_k(x)[p]
//
// with o the chunk's other operand at the tile's pixels, loaded once per
// block into registers: the forward input times the corrupt-row mask (K2),
// or the cotangent dy (K3).  Only interior lanes are ever read, so garbage
// in the halo lanes of any input cannot leak in.
//
// dW across blocks: blocks run in any order, so nothing is accumulated
// across them.  Inside a block each term's sums over the tile are reduced by
// warp shuffles (8 values in 9 shuffles, by halving the set per step), then
// across the 8 warps in shared memory, and written to the block's own column
// of a scratch matrix partial (K*Crec*Cch, G); a second launch
// (reduce_partials) sums each row in a fixed order.  No float atomics: two
// calls on the same inputs give bitwise-equal dW.
//
// Layout: x (B*Crec, F, n, P) with face col y at lane y + h, F the faces the
// arrays hold (12, or a face shard's F_loc); row-halo strips top/bot
// (B*Crec, F, R, P) with the h halo rows at [R-h, R) / [0, h); lane strips ls
// (B*Crec, F, n, 128), west at [0, h), east at [h, 2h); weight planes wext
// (nplanes, F, n + 2R, P) in the wrapped-extended layout (rows [n, n+R) hold
// face rows [-R, 0), rows [n+R, n+2R) hold face rows [n, n+R)); wk3
// (K, Crec, Cch); other and out (B*Cch, F, n, P); out is zero outside the
// interior lanes.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPix = 4;      // tile pixels per thread: T <= 32
constexpr int kChunk = 8;       // chunk channels per block
constexpr int kMaxPlanes = 81;  // stencil radius <= 4

enum Mode { kDxDw = 1, kGrad = 2 };

struct TileArgs {
  const float* x;      // recursion input (B*Crec, F, n, P)
  const float* top;    // its strips
  const float* bot;
  const float* ls;
  const float* wext;   // (nplanes, F, n + 2R, P)
  const float* wk3;    // (K, Crec, Cch)            [kDxDw]
  const int* offs;     // (nplanes, 2) tap offsets
  const float* other;  // (B*Cch, F, n, P)
  const float* mask;   // (F, n, P) or null         [kDxDw]
  float* out;          // (B*Cch, F, n, P)          [kDxDw]
  float* partial;      // (K*Crec*Cch, G)
  int cheby, K, radius, nplanes, F, Crec, Cch, n, h, R, P, T, tiles, chunks, G;
};

// Sum of v[j] over the 32 lanes of the warp, for j = (lane >> 2) & 7: each
// step sends half of the remaining values to the partner lane and keeps the
// other half, so 8 sums take 4 + 2 + 1 + 1 + 1 shuffles instead of 40.
__device__ __forceinline__ float warp_sum8(const float (&v)[kChunk], int lane) {
  const unsigned full = 0xffffffffu;
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = u16 ? v[i] : v[i + 4];
    a[i] = (u16 ? v[i + 4] : v[i]) + __shfl_xor_sync(full, send, 16);
  }
  float b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = u8 ? a[i] : a[i + 2];
    b[i] = (u8 ? a[i + 2] : a[i]) + __shfl_xor_sync(full, send, 8);
  }
  float c = (u4 ? b[1] : b[0]) + __shfl_xor_sync(full, u4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(full, c, 2);
  c += __shfl_xor_sync(full, c, 1);
  return c;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
stencil_tile_kernel(const TileArgs a) {
  constexpr bool kAcc = kMode == kDxDw;  // accumulates an output tile
  extern __shared__ float smem[];
  __shared__ int s_dx[kMaxPlanes];
  __shared__ int s_dy[kMaxPlanes];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = a.radius;
  const int W0 = a.T + 2 * a.h;  // halo window side
  const int Ww = W0 - 2 * r;     // weight window side (lap 1's region)
  const int wsz = Ww * Ww;
  float* s_w = smem;                    // nplanes * Ww * Ww
  float* b0 = s_w + a.nplanes * wsz;    // three W0 * W0 term buffers
  float* b1 = b0 + W0 * W0;
  float* b2 = b1 + W0 * W0;
  float* s_red = b2 + W0 * W0;          // [K][kWarps][kChunk]

  const int f = blockIdx.y;
  const int b = blockIdx.z / a.chunks;
  const int c0 = (blockIdx.z % a.chunks) * kChunk;
  const int x0 = (blockIdx.x / a.tiles) * a.T;
  const int y0 = (blockIdx.x % a.tiles) * a.T;
  const long long nr = a.n + 2 * a.R;  // rows of one weight plane
  const int npix = a.T * a.T;
  // this block's column of the partial sums
  const long long g = ((long long)b * a.F + f) * a.tiles * a.tiles + blockIdx.x;

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

  float acc[kMaxPix][kChunk];
  float oth[kMaxPix][kChunk];
#pragma unroll
  for (int p = 0; p < kMaxPix; ++p) {
    const int pix = tid + p * kThreads;
    const int ti = pix / a.T;
    const int tj = pix - ti * a.T;
    const long long rowl = (long long)(x0 + ti) * a.P + a.h + y0 + tj;
    float m = 1.f;
    if constexpr (kMode == kDxDw) {
      if (a.mask != nullptr && pix < npix) m = a.mask[(long long)f * a.n * a.P + rowl];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      acc[p][j] = 0.f;
      oth[p][j] = 0.f;
      const int ch = c0 + j;
      if (pix < npix && ch < a.Cch)
        oth[p][j] = m * a.other[((long long)(b * a.Cch + ch) * a.F + f) * a.n * a.P + rowl];
    }
  }

  // sums of the last channel's K terms -> this block's partial column
  auto flush = [&](int rc) {
    for (int e = tid; e < a.K * kChunk; e += kThreads) {
      const int k = e / kChunk;
      const int j = e - k * kChunk;
      const int ch = c0 + j;
      if (ch < a.Cch) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += s_red[(k * kWarps + w) * kChunk + j];
        const long long row = kMode == kGrad
            ? ((long long)k * a.Crec + rc) * a.Cch + ch
            : ((long long)k * a.Cch + ch) * a.Crec + rc;
        a.partial[row * a.G + g] = s;
      }
    }
  };

  for (int rc = 0; rc < a.Crec; ++rc) {
    const long long cf = ((long long)b * a.Crec + rc) * a.F + f;
    __syncthreads();  // the previous channel is done with the buffers
    if (rc > 0) flush(rc - 1);
    float* p2 = b2;
    float* p1 = b0;
    float* cur = b1;
    // halo window: position (i, j) is face row x0 - h + i, lane y0 + j
    for (int e = tid; e < W0 * W0; e += kThreads) {
      const int i = e / W0;
      const int j = e - i * W0;
      const int x = x0 - a.h + i;
      const int lane_ = y0 + j;
      float v;
      if (x < 0) {
        v = a.top[(cf * a.R + a.R + x) * a.P + lane_];
      } else if (x >= a.n) {
        v = a.bot[(cf * a.R + x - a.n) * a.P + lane_];
      } else if (lane_ < a.h) {  // west lane strip
        v = a.ls[(cf * a.n + x) * 128 + lane_];
      } else if (lane_ >= a.h + a.n) {  // east lane strip
        v = a.ls[(cf * a.n + x) * 128 + lane_ - a.n];
      } else {
        v = a.x[(cf * a.n + x) * a.P + lane_];
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
      // fold term k (in p1)
      float v[kMaxPix];
#pragma unroll
      for (int p = 0; p < kMaxPix; ++p) {
        const int pix = tid + p * kThreads;
        const int ti = pix / a.T;
        const int tj = pix - ti * a.T;
        v[p] = pix < npix ? p1[(a.h + ti) * W0 + a.h + tj] : 0.f;
      }
      if constexpr (kAcc) {
        float wk[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int ch = c0 + j;
          wk[j] = ch < a.Cch ? a.wk3[((long long)k * a.Crec + rc) * a.Cch + ch]
                             : 0.f;
        }
#pragma unroll
        for (int p = 0; p < kMaxPix; ++p)
#pragma unroll
          for (int j = 0; j < kChunk; ++j) acc[p][j] += wk[j] * v[p];
      }
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = 0.f;
#pragma unroll
        for (int p = 0; p < kMaxPix; ++p) s[j] += v[p] * oth[p][j];
      }
      const float t = warp_sum8(s, lane);
      if ((lane & 3) == 0)
        s_red[(k * kWarps + warp) * kChunk + ((lane >> 2) & 7)] = t;
    }
  }
  __syncthreads();
  flush(a.Crec - 1);

  if constexpr (kAcc) {
#pragma unroll
    for (int p = 0; p < kMaxPix; ++p) {
      const int pix = tid + p * kThreads;
      if (pix < npix) {
        const int ti = pix / a.T;
        const int tj = pix - ti * a.T;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int ch = c0 + j;
          if (ch < a.Cch) {
            const long long o = ((long long)(b * a.Cch + ch) * a.F + f) * a.n;
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
      for (int e = tid; e < kChunk * a.T * wpad; e += kThreads) {
        const int j = e / (a.T * wpad);
        const int rem = e - j * a.T * wpad;
        const int ti = rem / wpad;
        const int l = rem - ti * wpad;
        const int ch = c0 + j;
        if (ch < a.Cch) {
          const long long o = ((long long)(b * a.Cch + ch) * a.F + f) * a.n;
          const int lane_ = l < wlo ? l : a.h + a.n + (l - wlo);
          a.out[(o + x0 + ti) * a.P + lane_] = 0.f;
        }
      }
    }
  }
}

// out[e] = sum_g partial[e, g], one block per row, in a fixed order: thread
// t sums g = t, t + 256, ..., then a fixed tree over the 256 threads.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ partial, float* __restrict__ out,
                int G) {
  __shared__ float s[kThreads];
  const float* row = partial + (long long)blockIdx.x * G;
  float acc = 0.f;
  for (int i = threadIdx.x; i < G; i += kThreads) acc += row[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

// Checks, launches the tile kernel and the reduction of its partial sums
// into dw (K*Crec*Cch floats).  B: batch.
// Returns cudaGetLastError() after the launches (or the first error).
template <int kMode>
int launch_tile(TileArgs a, int B, float* dw, void* stream) {
  if (a.T < 1 || a.T > 32 || a.n % a.T || a.nplanes > kMaxPlanes
      || a.radius * (a.K - 1) > a.h || a.K < 1 || B < 1 || a.F < 1
      || a.F > 12 || a.Crec < 1 || a.Cch < 1)
    return (int)cudaErrorInvalidValue;
  a.tiles = a.n / a.T;
  a.chunks = (a.Cch + kChunk - 1) / kChunk;
  a.G = B * a.F * a.tiles * a.tiles;
  if ((long long)B * a.chunks > 65535) return (int)cudaErrorInvalidValue;
  const int W0 = a.T + 2 * a.h;
  const int Ww = W0 - 2 * a.radius;
  const size_t smem = sizeof(float) * ((size_t)a.nplanes * Ww * Ww
                                       + 3 * (size_t)W0 * W0
                                       + (size_t)a.K * kWarps * kChunk);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_tile_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.tiles * a.tiles, a.F, B * a.chunks);
  stencil_tile_kernel<kMode><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<a.K * a.Crec * a.Cch, kThreads, 0, (cudaStream_t)stream>>>(
      a.partial, dw, a.G);
  return (int)cudaGetLastError();
}

}  // namespace
