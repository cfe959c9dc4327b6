// Templates of the fused stencil conv kernel (K1); the design note, the
// C entry point and the dispatch are in stencil_conv.cu.  Each
// stencil_conv*.cu compiles the instantiations of some (radius, lap group)
// pairs, so that one nvcc per source builds them in parallel; the bfloat16
// instantiations are in stencil_conv_bf16*.cu.
//
// The bfloat16 kernels (config.conv_dtype "bfloat16" and "bfloat16_io")
// round at the points of ops/fused_stencil.py::_plain_terms: the weight
// window, the halo windows and the channel kernel are rounded to bfloat16
// once as they are staged (from float32 arrays, round to nearest even, the
// band mode; copied from bfloat16 arrays, the I/O mode), each lap sums its
// taps in float32 and stores its term rounded to bfloat16 (a Chebyshev
// term's 2 L~T - T formed in float32 first), and the fold accumulates in
// float32; the output is float32, or bfloat16 in the I/O mode.  They come
// in two stagings (Staging below), the same function bit for bit:
// * kBf32 (band) and kBf32Io (I/O), wherever the float32 kernel's shared
//   bytes fit at the plan's tile, lap group and output channels
//   (ops/fused_stencil.py::_k1_bf16_staging): the bfloat16 values held in
//   float32 shared memory, so the laps and folds are the float32 kernel's
//   and convert nothing but the term they store (two by two, one paired
//   conversion).  The halo windows and the channel-kernel slice go by
//   cp.async, the next step's during the last fold and the output as in
//   float32.  Band mode: the float32 kernel's window copies, each thread
//   rounding in place what it copied once its copies land (before the
//   barrier that publishes them, so no extra one).  I/O mode: each window
//   row lands as bfloat16 at the end of its own float32 row (16-byte
//   copies where eight lanes share a source, 4-byte words else; a word
//   that straddles the lane strip and the array at odd h is loaded in
//   registers and stored whole), then the lanes that copied it widen it in
//   place (__syncwarp, no block barrier).  The weight window, in both
//   modes: aligned 16-byte loads of each plane row, several in flight a
//   thread, issued while the first window's copies fly and stored
//   interleaved (rounded in pairs in band mode).  One instantiation a mode:
//   in one kernel the two stagings cost each other registers (measured).
// * the 2-byte body (stencil_conv_s2_kernel, below), where only the 2-byte
//   plan fits: bfloat16 shared elements, either mode by a runtime flag.
//   At radius 3 and 4 one lap runs the windows of 2 or 4 batch indices of
//   a channel group (window sets, as many as the registers, the block's
//   batch indices and the free shared bytes allow: stencil_conv_s2.h; one
//   instantiation a count), so each weight read from shared memory feeds
//   every set; each output keeps its own tap order and its own sums, so
//   the bits are those of the first bfloat16 version.  Its staging: the
//   weight window by 16-byte loads (several in flight a thread, no divide
//   an element) while the first windows fly; the next pass's windows by
//   cp.async into a float32 landing zone during the laps, rounded four
//   lanes at a time after the last fold, in the band mode where the zone
//   fits, else by 16-byte register loads after the last lap; by 8-byte
//   cp.async after the last lap in the I/O mode.
// K2's and K3's 2-byte kernel (stencil_bwd_s2_kernel, stencil_bwd.cuh) is
// built on the 2-byte body's device functions: its weight staging, window
// stagings and lap_sets.  The float32 kernels' code is unchanged (if
// constexpr).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

#include "stencil_conv_s2.h"

namespace ds_k1 {


constexpr int NT = 256;  // threads per block
constexpr int kRun = 4;  // lap points per thread: a vertical run

using bf16 = __nv_bfloat16;

// a staged element as float32, and a float32 as a staged element (rounded
// to nearest even for bfloat16)
__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(bf16 v) { return __bfloat162float(v); }
template <class E>
__device__ __forceinline__ E to(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 to<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// a float32 rounded to bfloat16 precision, kept in float32
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// two float32 rounded to bfloat16 precision by one paired conversion (the
// same rounding as rnd's, to nearest even), kept in float32
__device__ __forceinline__ float2 rnd2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}
// loads a thread keeps in flight when it stages through registers
constexpr int kLoads = 8;

// plane index of tap (dx, dy) in stencil_offsets(R): radius 1 in the
// healpix_base neighbour order, larger radii in raster order, centre last
template <int R>
__device__ __forceinline__ constexpr int plane_of(int dx, int dy) {
  if (dx == 0 && dy == 0) return (2 * R + 1) * (2 * R + 1) - 1;
  if (R == 1) {
    // (-1,0) (-1,1) (0,1) (1,1) (1,0) (1,-1) (0,-1) (-1,-1)
    return dx == -1 ? (dy == 0 ? 0 : (dy == 1 ? 1 : 7))
                    : (dx == 0 ? (dy == 1 ? 2 : 6)
                               : (dy == 1 ? 3 : (dy == 0 ? 4 : 5)));
  }
  const int idx = (dx + R) * (2 * R + 1) + (dy + R);
  const int centre = R * (2 * R + 1) + R;
  return idx < centre ? idx : idx - 1;
}

// xc, the strips, wext and out are bfloat16 arrays where io (the bfloat16
// kernels' I/O mode), else float32; wk3 is float32
struct ConvArgs {
  const float* xc;
  const float* top;
  const float* bot;
  const float* ls;
  const float* wext;
  const float* wk3;
  float* out;
  int cheby, K, B, F, Fin, Fout, n, h, Rs, P, T, GB, chunks, vec, io;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// 4 bytes from src, or zeros where !valid (src is not read then)
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One lap over [lo, W0 - lo)^2: dst = L~ src (or 2 L~ src - dst, Chebyshev
// in place over T_{k-2}: TWICE) for G channels, buffers BW floats apart,
// rows WS floats apart (RND: the floats hold bfloat16 values, each term
// stored rounded to bfloat16; the 2-byte bodies' lap is lap_sets).
// Nothing in the unrolled body depends on a runtime value, so its loads can
// be issued ahead of the FMAs.
template <int R, int G, bool TWICE, bool RND = false>
__device__ __forceinline__ void lap(const float* __restrict__ src,
                                    float* __restrict__ dst,
                                    const float* __restrict__ s_w, int W0,
                                    int WS, int Ww, int BW, int k) {
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  const int lo = R * k;
  const int L = W0 - 2 * lo;
  const int hi = lo + L;
  const int nq = (L + kRun - 1) / kRun;
  // unit u = q * L + jj (run q, column jj), walked with stride NT
  // without a divide per unit
  const int dq = NT / L;
  const int dj = NT - dq * L;
  int q = threadIdx.x / L;
  int jj = threadIdx.x - q * L;
  const int wrow = Ww * NP;
  while (q < nq) {
    const int i0 = lo + kRun * q;
    const int j = lo + jj;
    float s[G][kRun];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int o = 0; o < kRun; ++o) s[g][o] = 0.f;
    // weights of point (i0, j): window position (i0, j) is weight-window
    // position (i0 - R, j - R)
    const float* wb = s_w + ((i0 - R) * Ww + (j - R)) * NP;
    const float* xb = src + (i0 - R) * WS + (j - R);
#pragma unroll
    for (int a = 0; a < kRun + 2 * R; ++a) {  // input row i0 - R + a
#pragma unroll
      for (int c = 0; c <= 2 * R; ++c) {  // input lane j - R + c
        float v[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          v[g] = xb[g * BW + a * WS + c];
#pragma unroll
        for (int o = 0; o < kRun; ++o) {
          const int dx = a - R - o;
          if (dx >= -R && dx <= R) {
            const float w = wb[o * wrow + plane_of<R>(dx, c - R)];
#pragma unroll
            for (int g = 0; g < G; ++g) s[g][o] = fmaf(w, v[g], s[g][o]);
          }
        }
      }
    }
    if constexpr (RND) {
      // the terms rounded two by two (one conversion a pair of rows), the
      // old values read first (rows past hi lie in the buffer's kRun - 1
      // slack rows; what is read there is not stored)
      float t[G][kRun];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int o = 0; o < kRun; ++o)
          t[g][o] = TWICE ? fmaf(2.f, s[g][o],
                                 -dst[g * BW + (i0 + o) * WS + j])
                          : s[g][o];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int o = 0; o < kRun; o += 2) {
          const float2 r = rnd2(t[g][o], t[g][o + 1]);
          t[g][o] = r.x;
          t[g][o + 1] = r.y;
        }
#pragma unroll
      for (int o = 0; o < kRun; ++o)
        if (i0 + o < hi)
#pragma unroll
          for (int g = 0; g < G; ++g)
            dst[g * BW + (i0 + o) * WS + j] = t[g][o];
    } else {
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        const int i = i0 + o;
        if (i < hi) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float* d = dst + g * BW + i * WS + j;
            *d = TWICE ? fmaf(2.f, s[g][o], -*d) : s[g][o];
          }
        }
      }
    }
    jj += dj;
    q += dq;
    if (jj >= L) {
      jj -= L;
      ++q;
    }
  }
}

// Fold one term (G channels in buf, BW floats apart) into the
// accumulators of this thread's PP pixels (tile pixels threadIdx.x + p * NT
// of T x T, T = 1 << lgT, at window offset (h + ti) * WS + h + tj, computed
// here rather than held in registers); wkk: the term's [g][FC] slice.
template <int G, int PP, int FC, class E = float>
__device__ __forceinline__ void fold(float (&acc)[PP][FC],
                                     const E* __restrict__ buf,
                                     const float* __restrict__ wkk, int BW,
                                     int WS, int h, int lgT) {
  int off[PP];
  bool val[PP];
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int pix = threadIdx.x + p * NT;
    val[p] = pix < (1 << (2 * lgT));
    off[p] = val[p] ? (h + (pix >> lgT)) * WS + h + (pix & ((1 << lgT) - 1)) : 0;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float t[PP];
#pragma unroll
    for (int p = 0; p < PP; ++p) t[p] = val[p] ? ld(buf[g * BW + off[p]]) : 0.f;
    const float4* w4 = reinterpret_cast<const float4*>(wkk + g * FC);
#pragma unroll
    for (int c = 0; c < FC / 4; ++c) {
      const float4 w = w4[c];
#pragma unroll
      for (int p = 0; p < PP; ++p) {
        acc[p][4 * c + 0] = fmaf(w.x, t[p], acc[p][4 * c + 0]);
        acc[p][4 * c + 1] = fmaf(w.y, t[p], acc[p][4 * c + 1]);
        acc[p][4 * c + 2] = fmaf(w.z, t[p], acc[p][4 * c + 2]);
        acc[p][4 * c + 3] = fmaf(w.w, t[p], acc[p][4 * c + 3]);
      }
    }
  }
}

// The staging of a block and the zeros of its pad lanes, shared with K2
// and K3 (stencil_bwd.cuh).

// The tile's weight window, once per block: s_w[(i * Ww + j) * NP + d] is
// plane d of face f at window position (i + R, j + R), i.e. face row
// x0 - h + R + i, lane y0 + R + j (wext: F faces of n + 2 Rs wrapped rows)
template <int R>
__device__ __forceinline__ void stage_weights(float* s_w,
                                              const float* __restrict__ wext,
                                              int F, int f, int n, int Rs,
                                              int P, int h, int x0, int y0,
                                              int Ww) {
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  const int lane = threadIdx.x & 31;
  const long long nr = n + 2 * Rs;
  for (int row = threadIdx.x >> 5; row < NP * Ww; row += NT / 32) {
    const int d = row / Ww;
    const int i = row - d * Ww;
    const int x = x0 - h + R + i;
    const int wr = x < 0 ? n + Rs + x : (x >= n ? Rs + x : x);
    const float* src = wext + ((long long)(d * F + f) * nr + wr) * P + y0 + R;
    for (int j = lane; j < Ww; j += 32) cp_async4(s_w + (i * Ww + j) * NP + d, src + j);
  }
}

// A channel array and its halo strips: what a tile's halo window reads
template <class S>
struct HaloT {
  const S* x;    // (C, F, n, P), face col y at lane y + h
  const S* top;  // (C, F, Rs, P): the rows above the face
  const S* bot;  // (C, F, Rs, P): the rows below
  const S* ls;   // (C, F, n, 128): the lanes west and east
  int n, h, Rs, P;
};
using Halo = HaloT<float>;

// the same arrays read as bfloat16 (the I/O mode)
__device__ __forceinline__ HaloT<bf16> as_bf16(const Halo& s) {
  return {reinterpret_cast<const bf16*>(s.x),
          reinterpret_cast<const bf16*>(s.top),
          reinterpret_cast<const bf16*>(s.bot),
          reinterpret_cast<const bf16*>(s.ls), s.n, s.h, s.Rs, s.P};
}

// face row x, lane y of channel cf (channel c of face f: c * F + f): the
// top/bot strips above and below the face, the lane strips west and east
// of it, else the array
template <class S>
__device__ __forceinline__ const S* window_src(const HaloT<S>& s,
                                               long long cf, int x, int y) {
  if (x < 0) return s.top + (cf * s.Rs + s.Rs + x) * s.P + y;
  if (x >= s.n) return s.bot + (cf * s.Rs + x - s.n) * s.P + y;
  if (y < s.h) return s.ls + (cf * s.n + x) * 128 + y;
  if (y >= s.h + s.n) return s.ls + (cf * s.n + x) * 128 + y - s.n;
  return s.x + (cf * s.n + x) * s.P + y;
}

// The halo windows of the G channels cf0 + g * F into dst + g * BW:
// position (i, j) is face row x0 - h + i, lane y0 + j.  Groups of four
// lanes from one source go as one 16-byte copy where the sources' rows are
// 16-byte aligned (vec); the rows' last group may copy up to 3 lanes past
// W0 into the row's padding: P > n + 2h + 2 whenever W0 is not a multiple
// of 4.
template <int G>
__device__ __forceinline__ void stage_window(float* dst, const Halo& s,
                                             long long cf0, int F, int x0,
                                             int y0, int W0, int WS, int BW,
                                             bool vec) {
  const int c4 = WS / 4;
  for (int g = 0; g < G; ++g) {
    const long long cf = cf0 + (long long)g * F;
    float* d = dst + g * BW;
    for (int e = threadIdx.x; e < W0 * c4; e += NT) {
      const int i = e / c4;
      const int j = 4 * (e - i * c4);
      const int x = x0 - s.h + i;
      const int y = y0 + j;
      if (vec && (x < 0 || x >= s.n
                  || ((y < s.h) == (y + 3 < s.h)
                      && (y >= s.h + s.n) == (y + 3 >= s.h + s.n)))) {
        cp_async16(d + i * WS + j, window_src(s, cf, x, y));
      } else {
        for (int t = 0; t < 4; ++t)
          if (j + t < W0) cp_async4(d + i * WS + j + t, window_src(s, cf, x, y + t));
      }
    }
  }
}

// dst[k][g][c] = wk[k][ci0 + g][co0 + c] of a (K, Cin, Cout) channel
// kernel, K x G x FC floats, zero past Cout
template <int G, int FC>
__device__ __forceinline__ void stage_slice(float* dst,
                                            const float* __restrict__ wk,
                                            int K, int Cin, int Cout, int ci0,
                                            int co0) {
  for (int e = threadIdx.x; e < K * G * FC; e += NT) {
    const int k = e / (G * FC);
    const int rem = e - k * G * FC;
    const int g = rem / FC;
    const int co = co0 + rem - g * FC;
    const bool ok = co < Cout;
    cp_async4_zfill(dst + e,
                    wk + (ok ? ((long long)k * Cin + ci0 + g) * Cout + co : 0),
                    ok);
  }
}

// bfloat16 lanes 2w, 2w + 1 of a 32-bit word as float32
__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The kBf32 and kBf32Io stagings of the bfloat16 K1: bfloat16 values in
// float32 shared memory, copied with cp.async and rounded (band mode) or
// widened (I/O mode) by the thread that copied them once its copies land.

// rounds to bfloat16 the 4-lane groups of the halo windows this thread
// copied (stage_window; the lanes past W0 are row padding, never read)
template <int G>
__device__ __forceinline__ void round_window(float* dst, int W0, int WS,
                                             int BW) {
  const int c4 = WS / 4;
  for (int g = 0; g < G; ++g) {
    float* d = dst + g * BW;
    for (int e = threadIdx.x; e < W0 * c4; e += NT) {
      const int i = e / c4;
      float4* p = reinterpret_cast<float4*>(d + i * WS + 4 * (e - i * c4));
      const float4 v = *p;
      const float2 a = rnd2(v.x, v.y);
      const float2 b = rnd2(v.z, v.w);
      *p = make_float4(a.x, a.y, b.x, b.y);
    }
  }
}

// rounds to bfloat16 the channel-kernel slice this thread copied
// (stage_slice)
template <int G, int FC>
__device__ __forceinline__ void round_slice(float* dst, int K) {
  for (int e = threadIdx.x; e < K * G * FC; e += NT) dst[e] = rnd(dst[e]);
}

// The I/O mode's halo windows: window row q = g * W0 + i of the G
// channels is copied and widened by the lanes of one warp, 8 lanes of the
// row (16 bytes of bfloat16) a lane; a warp takes 32 / upr rows at once.
struct IoRows {
  int upr;  // 8-lane units a row
  int rpw;  // rows a warp takes at once
  int ql;   // this lane's row among them (ql >= rpw: none)
  int j;    // its first window lane
  __device__ __forceinline__ explicit IoRows(int W0) {
    const int lane = threadIdx.x & 31;
    upr = (W0 + 7) >> 3;
    rpw = 32 / upr;
    ql = lane / upr;
    j = 8 * (lane - ql * upr);
  }
  // the row's landing, bfloat16 at the end of its float32 row (16-byte
  // aligned: WS is a multiple of 4 floats, 8 * upr of 8 bfloat16)
  __device__ __forceinline__ bf16* landing(float* row, int WS) const {
    return reinterpret_cast<bf16*>(row) + 2 * WS - 8 * upr;
  }
};

// lanes y and z of a face row come from the same array (both in the west
// lane strip, the interior, or the east lane strip)
__device__ __forceinline__ bool one_source(const HaloT<bf16>& s, int y,
                                           int z) {
  return (y < s.h) == (z < s.h) && (y >= s.h + s.n) == (z >= s.h + s.n);
}

// The halo windows of the G channels cf0 + g * F into the float32 buffers
// dst + g * BW (bfloat16 arrays), landed as bfloat16 (widen_window_io
// widens them): 16-byte copies where the 8 lanes share a source and the
// arrays are 16-byte aligned (vec), else 4-byte words; a word whose two
// lanes come from two arrays (at odd h, lanes h - 1 | h and h + n - 1 |
// h + n) is loaded in registers and stored as one word, which no cp.async
// writes.  Lanes past W0 are not read.
template <int G>
__device__ __forceinline__ void stage_window_io(float* dst,
                                                const HaloT<bf16>& s,
                                                long long cf0, int F, int x0,
                                                int y0, int W0, int WS,
                                                int BW, bool vec) {
  const IoRows r(W0);
  if (r.ql >= r.rpw) return;
  const int j = r.j;
  for (int q = (threadIdx.x >> 5) * r.rpw + r.ql; q < G * W0;
       q += (NT / 32) * r.rpw) {
    const int g = q / W0;
    const int i = q - g * W0;
    const long long cf = cf0 + (long long)g * F;
    bf16* row = r.landing(dst + g * BW + i * WS, WS);
    const int x = x0 - s.h + i;
    const bool whole = x < 0 || x >= s.n;  // a top or bottom strip row
    if (vec && j + 8 <= W0 && (whole || one_source(s, y0 + j, y0 + j + 7))) {
      cp_async16(reinterpret_cast<float*>(row + j),
                 reinterpret_cast<const float*>(window_src(s, cf, x, y0 + j)));
    } else {
      for (int t = j; t < j + 8 && t < W0; t += 2) {
        if (whole || one_source(s, y0 + t, y0 + t + 1)) {
          cp_async4(reinterpret_cast<float*>(row + t),
                    reinterpret_cast<const float*>(
                        window_src(s, cf, x, y0 + t)));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(row + t) =
              __halves2bfloat162(*window_src(s, cf, x, y0 + t),
                                 *window_src(s, cf, x, y0 + t + 1));
        }
      }
    }
  }
}

// Widens in place the window rows this lane copied (stage_window_io), once
// its copies have landed: each lane reads its own 8 landed lanes, the warp
// syncs (the float32 row overwrites the landings of its other lanes), and
// each lane writes its 8 floats (the 4 past WS, if any, would be the next
// row's: not written; those past W0 are row padding).
template <int G>
__device__ __forceinline__ void widen_window_io(float* dst, int W0, int WS,
                                                int BW) {
  const IoRows r(W0);
  const int j = r.j;
  for (int q0 = (threadIdx.x >> 5) * r.rpw; q0 < G * W0;
       q0 += (NT / 32) * r.rpw) {
    const int q = q0 + r.ql;
    const bool mine = r.ql < r.rpw && q < G * W0;
    float* row = dst;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (mine) {
      const int g = q / W0;
      row = dst + g * BW + (q - g * W0) * WS;
      w = *reinterpret_cast<const uint4*>(r.landing(row, WS) + j);
    }
    __syncwarp();
    if (mine) {
      *reinterpret_cast<float4*>(row + j) =
          make_float4(bf_lo(w.x), bf_hi(w.x), bf_lo(w.y), bf_hi(w.y));
      if (j + 4 < WS)
        *reinterpret_cast<float4*>(row + j + 4) =
            make_float4(bf_lo(w.z), bf_hi(w.z), bf_lo(w.w), bf_hi(w.w));
    }
  }
}

// The bfloat16 kernels' weight window in float32 (kBf32, kBf32Io), laid out as
// stage_weights lays it, from float32 planes (band mode, rounded to
// bfloat16) or bfloat16 ones (I/O mode): each plane row's W0 lanes from
// y0 (aligned) in 16-byte loads where wext is 16-byte aligned (vec), kLoads
// of them in flight a thread, then stored interleaved; issued after the
// first step's window copies, so that both reach shared memory in one
// round trip.
template <int R, class S>
__device__ __forceinline__ void stage_weights_reg(float* s_w,
                                                  const S* __restrict__ wext,
                                                  int F, int f, int n, int Rs,
                                                  int P, int h, int x0, int y0,
                                                  int Ww, bool vec) {
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  constexpr int CL = 16 / sizeof(S);  // lanes a 16-byte load
  constexpr int WL = 4 / sizeof(S);   // lanes a 4-byte word
  const int W0 = Ww + 2 * R;
  const int upr = (W0 + CL - 1) / CL;
  const int tot = NP * Ww * upr;
  const long long nr = n + 2 * Rs;
  for (int e0 = threadIdx.x; e0 < tot; e0 += kLoads * NT) {
    uint4 v[kLoads];
    int base[kLoads];  // s_w index of lane j0 (window position j0 - R)
    int j0[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * NT;
      j0[u] = -1;
      if (e < tot) {
        const int q = e / upr;  // plane d, window row i
        const int d = q / Ww;
        const int i = q - d * Ww;
        const int j = CL * (e - q * upr);
        const int x = x0 - h + R + i;
        const int wr = x < 0 ? n + Rs + x : (x >= n ? Rs + x : x);
        const S* src = wext + ((long long)(d * F + f) * nr + wr) * P + y0 + j;
        if (vec && j + CL <= W0) {
          v[u] = *reinterpret_cast<const uint4*>(src);
        } else {
          unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (j + WL * t < W0)
              w[t] = *reinterpret_cast<const unsigned*>(src + WL * t);
          v[u] = make_uint4(w[0], w[1], w[2], w[3]);
        }
        j0[u] = j;
        base[u] = (i * Ww + j - R) * NP + d;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (j0[u] >= 0) {
        float val[8];
        if constexpr (sizeof(S) == 4) {  // float32, rounded in pairs
          const float2 a =
              rnd2(__uint_as_float(v[u].x), __uint_as_float(v[u].y));
          const float2 b =
              rnd2(__uint_as_float(v[u].z), __uint_as_float(v[u].w));
          val[0] = a.x;
          val[1] = a.y;
          val[2] = b.x;
          val[3] = b.y;
        } else {  // bfloat16 pairs, exact
          const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            val[2 * t] = bf_lo(w[t]);
            val[2 * t + 1] = bf_hi(w[t]);
          }
        }
#pragma unroll
        for (int t = 0; t < CL; ++t) {
          const int jj = j0[u] + t - R;  // window position
          if (jj >= 0 && jj < Ww) s_w[base[u] + t * NP] = val[t];
        }
      }
    }
  }
}

// The bfloat16 kernels' output of a tile: the PP x FC sums of this thread
// (then zeroed) to channels ch0 + o (o < nc) of out (C, F, n, P), float32
// or bfloat16 (O), at its pixels' offsets gof in a face plane (-1: none).
// The float32 kernels keep their own writes (K2's dx through a shared
// function spilled, 5% slower at the headline).
template <int PP, int FC, class O>
__device__ __forceinline__ void store_sums(O* __restrict__ out,
                                           float (&acc)[PP][FC],
                                           const long long (&gof)[PP],
                                           long long ch0, int nc, int F,
                                           int f, int n, int P) {
#pragma unroll
  for (int o = 0; o < FC; ++o) {
    if (o < nc) {
      O* oc = out + ((ch0 + o) * F + f) * n * P;
#pragma unroll
      for (int p = 0; p < PP; ++p) {
        if (gof[p] >= 0) oc[gof[p]] = to<O>(acc[p][o]);
        acc[p][o] = 0.f;
      }
    }
  }
}

// Zeros at the lanes outside the interior of channels ch0 + o (o < nc) of
// out (C, F, n, P) along the tile's T rows: [0, h) by the first tile
// column, [h + n, P) by the last.  (Each kernel writes the interior from
// its own registers: K2 through its pixel offsets, which keeps its dx
// write free of spills.)
template <class O>
__device__ __forceinline__ void zero_pad_lanes(O* __restrict__ out,
                                               long long ch0, int nc, int F,
                                               int f, int n, int P, int h,
                                               int T, int x0, int y0) {
  const int wlo = y0 == 0 ? h : 0;
  const int whi = y0 + T == n ? P - h - n : 0;
  const int wpad = wlo + whi;
  if (wpad > 0) {
    for (int e = threadIdx.x; e < nc * T * wpad; e += NT) {
      const int o = e / (T * wpad);
      const int rem = e - o * T * wpad;
      const int ti = rem / wpad;
      const int l = rem - ti * wpad;
      const int y = l < wlo ? l : h + n + (l - wlo);
      out[(((ch0 + o) * F + f) * n + x0 + ti) * P + y] = to<O>(0.f);
    }
  }
}

// Two blocks per SM where the sums a thread holds allow it (at most 128
// registers): left free, the compiler takes up to 200 and halves the
// blocks per SM, which costs more than it gains.
template <int PP, int FC>
constexpr int min_blocks() {
  return PP * FC <= 32 ? 2 : 1;
}

// how a K1 instantiation holds the elements it stages in shared memory
enum Staging {
  kF32 = 0,     // float32 (the float32 kernel)
  kBf32 = 1,    // bfloat16 values in float32, from float32 arrays (band)
  kBf32Io = 3,  // bfloat16 values in float32, from bfloat16 arrays (I/O)
};

template <int R, int G, int PP, int FC, int S = kF32>
__global__ void __launch_bounds__(NT, (min_blocks<PP, FC>()))
stencil_conv_kernel(const ConvArgs a) {
  // bfloat16 values in float32: each mode its own instantiation (the two
  // stagings in one kernel cost each other registers)
  constexpr bool F32S = S == kBf32 || S == kBf32Io;
  constexpr bool IO = S == kBf32Io;
  using E = float;
  extern __shared__ __align__(16) float smem[];
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  const int T = a.T, h = a.h, n = a.n, P = a.P, K = a.K;
  const int W0 = T + 2 * h;          // halo window side
  const int WS = (W0 + 3) & ~3;      // its row stride: rows 16-byte aligned
  const int Ww = W0 - 2 * R;         // weight window side (lap 1's region)
  const int BW = (W0 + kRun - 1) * WS;  // one channel's buffer (+ run slack)
  const int wkn = K * G * FC;     // one group's channel-kernel slice
  float* s_wk = smem;                               // 2 x K x G x FC
  E* s_w = reinterpret_cast<E*>(s_wk + 2 * wkn);    // (Ww+kRun-1) x Ww x NP
  // 2 x G x BW, 16-byte aligned (float)
  E* bufs = s_w + (((Ww + kRun - 1) * Ww * NP + 3) & ~3);

  const int tiles = n / T;
  const int f = blockIdx.y;
  const int x0 = (blockIdx.x / tiles) * T;
  const int y0 = (blockIdx.x % tiles) * T;
  const int fo0 = (blockIdx.z % a.chunks) * FC;
  const int b0 = (blockIdx.z / a.chunks) * a.GB;
  const int nb = min(a.GB, a.B - b0);
  const int ngroups = a.Fin / G;  // G divides Fin
  const int nsteps = nb * ngroups;

  const Halo halo{a.xc, a.top, a.bot, a.ls, n, h, a.Rs, P};
  if constexpr (F32S) {
    // after the first window's copies (below)
  } else {
    stage_weights<R>(s_w, a.wext, a.F, f, n, a.Rs, P, h, x0, y0, Ww);
  }
  // halo windows of step s's channel group into buffer set `set`
  auto stage_step = [&](int s, int set) {
    const int b = b0 + s / ngroups;
    const int fi0 = (s % ngroups) * G;
    const long long cf0 = ((long long)b * a.Fin + fi0) * a.F + f;
    if constexpr (IO) {
      stage_window_io<G>(bufs + set * G * BW, as_bf16(halo), cf0, a.F, x0,
                         y0, W0, WS, BW, a.vec);
    } else {
      stage_window<G>(bufs + set * G * BW, halo, cf0, a.F, x0, y0, W0, WS,
                      BW, a.vec);
    }
  };
  // step s's slice of wk3, zero past Fout: s_wk[slot][k][g][fo], copied
  // asynchronously like the windows (rounded to bfloat16 by F32S once it
  // lands)
  auto stage_wk = [&](int s, int slot) {
    stage_slice<G, FC>(s_wk + slot * wkn, a.wk3, K, a.Fin, a.Fout,
                       (s % ngroups) * G, fo0);
  };
  // F32S: what this thread copied into buffer set `set` and channel-kernel
  // slot `slot`, rounded to bfloat16 (band mode) or widened (I/O mode) in
  // place once its copies have landed, before the barrier that publishes
  // them
  auto land_step = [&](int set, int slot) {
    if constexpr (F32S) {
      if constexpr (IO)
        widen_window_io<G>(bufs + set * G * BW, W0, WS, BW);
      else
        round_window<G>(bufs + set * G * BW, W0, WS, BW);
      round_slice<G, FC>(s_wk + slot * wkn, K);
    }
  };

  const int lgT = 31 - __clz(T);  // T is 8, 16 or 32
  float acc[PP][FC];
#pragma unroll
  for (int p = 0; p < PP; ++p)
#pragma unroll
    for (int o = 0; o < FC; ++o) acc[p][o] = 0.f;

  stage_step(0, 0);
  stage_wk(0, 0);
  if constexpr (F32S) {  // the weight window while those copies fly
    const bool wvec = (reinterpret_cast<size_t>(a.wext) & 15) == 0;
    if constexpr (IO)
      stage_weights_reg<R>(s_w, reinterpret_cast<const bf16*>(a.wext), a.F,
                           f, n, a.Rs, P, h, x0, y0, Ww, wvec);
    else
      stage_weights_reg<R>(s_w, a.wext, a.F, f, n, a.Rs, P, h, x0, y0, Ww,
                           wvec);
  }
  cp_async_commit();
  cp_async_wait_all();
  if constexpr (F32S) land_step(0, 0);
  __syncthreads();

  // the buffer set holding this step's T_0.  The next step's windows go to
  // the set of T_{K-2} once the last lap is done with it, overlapping the
  // last fold and the output (a third set, prefetched during all the laps,
  // measured slower on an H100: it costs a block per SM at the headline)
  int cur = 0;
  const int flip = (K - 1) % 2 == 0;  // T_{K-1} in the even set
  for (int s = 0; s < nsteps; ++s) {
    const bool more = s + 1 < nsteps;
    if (more) stage_wk(s + 1, (s + 1) & 1);
    cp_async_commit();
    const float* wk = s_wk + (s & 1) * wkn;
    E* P0 = bufs + cur * G * BW;        // even terms
    E* P1 = bufs + (cur ^ 1) * G * BW;  // odd terms
    const int next = cur ^ flip;
    if (K == 1 && more) stage_step(s + 1, next);

    fold<G, PP, FC>(acc, P0, wk, BW, WS, h, lgT);
    for (int k = 1; k < K; ++k) {
      E* src = (k & 1) ? P0 : P1;
      E* dst = (k & 1) ? P1 : P0;
      if (a.cheby && k >= 2)
        lap<R, G, true, F32S>(src, dst, s_w, W0, WS, Ww, BW, k);
      else
        lap<R, G, false, F32S>(src, dst, s_w, W0, WS, Ww, BW, k);
      __syncthreads();
      if (k == K - 1 && more) stage_step(s + 1, next);
      fold<G, PP, FC>(acc, dst, wk + k * G * FC, BW, WS, h, lgT);
    }

    if constexpr (S != kF32) {
      if ((s + 1) % ngroups == 0) {  // the batch index is complete
        const int b = b0 + s / ngroups;
        const int nfo = min(FC, a.Fout - fo0);
        long long gof[PP];
#pragma unroll
        for (int p = 0; p < PP; ++p) {
          const int pix = threadIdx.x + p * NT;
          gof[p] = pix < T * T ? (long long)(x0 + (pix >> lgT)) * P + h + y0
                                     + (pix & (T - 1))
                               : -1;
        }
        const long long ch0 = (long long)b * a.Fout + fo0;
        if (IO) {
          bf16* out = reinterpret_cast<bf16*>(a.out);
          store_sums(out, acc, gof, ch0, nfo, a.F, f, n, P);
          zero_pad_lanes(out, ch0, nfo, a.F, f, n, P, h, T, x0, y0);
        } else {
          store_sums(a.out, acc, gof, ch0, nfo, a.F, f, n, P);
          zero_pad_lanes(a.out, ch0, nfo, a.F, f, n, P, h, T, x0, y0);
        }
      }
    } else if ((s + 1) % ngroups == 0) {  // the batch index is complete
      const int b = b0 + s / ngroups;
      const int nfo = min(FC, a.Fout - fo0);
#pragma unroll
      for (int o = 0; o < FC; ++o) {
        if (o < nfo) {
          float* oc = a.out + ((long long)(b * a.Fout + fo0 + o) * a.F + f) * n * P;
#pragma unroll
          for (int p = 0; p < PP; ++p) {
            const int pix = threadIdx.x + p * NT;
            if (pix < T * T)
              oc[(x0 + (pix >> lgT)) * P + h + y0 + (pix & (T - 1))] = acc[p][o];
            acc[p][o] = 0.f;
          }
        }
      }
      zero_pad_lanes(a.out, (long long)b * a.Fout + fo0, nfo, a.F, f, n, P,
                     h, T, x0, y0);
    }

    cp_async_commit();
    cp_async_wait_all();
    if constexpr (F32S) {
      if (more) land_step(next, (s + 1) & 1);
    }
    __syncthreads();
    cur ^= flip;
  }
}

// The 2-byte body of the bfloat16 K1 (stencil_conv_s2_kernel): bfloat16
// shared elements where only those fit, either mode by a runtime flag.

// 8 bytes; both addresses 8-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// two float32 as one word of two bfloat16, each rounded to nearest even
// (the rounding of to<bf16>), the first in the low half
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// The tile's weight window in bfloat16, laid out as stage_weights lays it,
// from float32 planes (band mode, rounded) or bfloat16 ones (I/O mode):
// each plane row's W0 lanes from y0 in 16-byte loads where wext is 16-byte
// aligned (vec), else element by element, kLoads of them in flight a
// thread and no divide an element (16 or 32 in flight measured 2-10%
// slower on an H100); stored lane by lane.
template <int R, class S>
__device__ __forceinline__ void stage_weights_s2(bf16* s_w,
                                                 const S* __restrict__ wext,
                                                 int F, int f, int n, int Rs,
                                                 int P, int h, int x0, int y0,
                                                 int Ww, bool vec) {
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  constexpr int CL = 16 / sizeof(S);  // lanes a 16-byte load
  const int W0 = Ww + 2 * R;
  const int upr = (W0 + CL - 1) / CL;
  const int tot = NP * Ww * upr;
  const long long nr = n + 2 * Rs;
  for (int e0 = threadIdx.x; e0 < tot; e0 += kLoads * NT) {
    uint4 v[kLoads];
    int base[kLoads];  // s_w index of lane j0 (window position j0 - R)
    int j0[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * NT;
      j0[u] = -1;
      if (e < tot) {
        const int q = e / upr;  // plane d, window row i
        const int d = q / Ww;
        const int i = q - d * Ww;
        const int j = CL * (e - q * upr);
        const int x = x0 - h + R + i;
        const int wr = x < 0 ? n + Rs + x : (x >= n ? Rs + x : x);
        const S* src = wext + ((long long)(d * F + f) * nr + wr) * P + y0 + j;
        if (vec && j + CL <= W0) {
          v[u] = *reinterpret_cast<const uint4*>(src);
        } else {
          unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int t = 0; t < CL; ++t) {
            if (j + t < W0) {
              if constexpr (sizeof(S) == 4)
                w[t] = __float_as_uint(src[t]);
              else
                w[t >> 1] |= (unsigned)__bfloat16_as_ushort(src[t])
                             << (16 * (t & 1));
            }
          }
          v[u] = make_uint4(w[0], w[1], w[2], w[3]);
        }
        j0[u] = j;
        base[u] = (i * Ww + j - R) * NP + d;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (j0[u] >= 0) {
        unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        if constexpr (sizeof(S) == 4) {  // float32, rounded in pairs
          w[0] = bf16x2_bits(__uint_as_float(v[u].x), __uint_as_float(v[u].y));
          w[1] = bf16x2_bits(__uint_as_float(v[u].z), __uint_as_float(v[u].w));
        }
#pragma unroll
        for (int t = 0; t < CL; ++t) {
          const int jj = j0[u] + t - R;  // window position
          if (jj >= 0 && jj < Ww)
            s_w[base[u] + t * NP] = __ushort_as_bfloat16(
                (unsigned short)(w[t >> 1] >> (16 * (t & 1))));
        }
      }
    }
  }
}

// One round of the band mode's window staging: NL 4-lane groups a thread
// (16 bytes of float32 each) in registers, and where each goes in the
// buffers (-1: none).  Loaded by stage_band_load, rounded and stored by
// stage_band_store.
template <int NL = kLoads>
struct BandRound {
  uint4 v[NL];
  int o[NL];
};

// lanes y to y + 3 of a face row come from one array (the west lane strip,
// the interior or the east lane strip)
template <class S>
__device__ __forceinline__ bool one_source4(const HaloT<S>& s, int y) {
  return (y < s.h) == (y + 3 < s.h)
      && (y >= s.h + s.n) == (y + 3 >= s.h + s.n);
}

// The 4-lane groups [e0, e0 + NL * NT) of a pass's halo windows, group
// e = ((set * G + g) * W0 + i) * (WS / 4) + jg: lanes 4 jg to 4 jg + 3 of
// window row i of channel g of window set `set` (channel cfb + (set * Fin
// + g) * F of the arrays), into the set's buffer at set * SS + g * BW + i *
// WS + 4 jg.  Lanes past W0 are not read (zeros).
template <int G, int NL>
__device__ __forceinline__ void stage_band_load(BandRound<NL>& r,
                                                const Halo& s, int e0,
                                                int tot, int c4, int W0,
                                                int WS, int BW, int SS,
                                                long long cfb, int Fin, int F,
                                                int x0, int y0, bool vec) {
#pragma unroll
  for (int u = 0; u < NL; ++u) {
    const int e = e0 + u * NT;
    r.o[u] = -1;
    if (e < tot) {
      const int q = e / c4;
      const int j = 4 * (e - q * c4);
      const int ch = q / W0;  // set * G + g
      const int i = q - ch * W0;
      const int set = ch / G;
      const int g = ch - set * G;
      const long long cf = cfb + ((long long)set * Fin + g) * F;
      const int x = x0 - s.h + i;
      const int y = y0 + j;
      if (vec && j + 4 <= W0 && (x < 0 || x >= s.n || one_source4(s, y))) {
        r.v[u] = *reinterpret_cast<const uint4*>(window_src(s, cf, x, y));
      } else {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (j + t < W0) w[t] = __float_as_uint(*window_src(s, cf, x, y + t));
        r.v[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
      r.o[u] = set * SS + g * BW + i * WS + j;
    }
  }
}

// the groups of a round rounded to bfloat16 (as to<bf16> rounds) and
// stored, 8 bytes a group, into the buffers at dst
template <int NL>
__device__ __forceinline__ void stage_band_store(const BandRound<NL>& r,
                                                 bf16* dst) {
#pragma unroll
  for (int u = 0; u < NL; ++u)
    if (r.o[u] >= 0)
      *reinterpret_cast<uint2*>(dst + r.o[u]) = make_uint2(
          bf16x2_bits(__uint_as_float(r.v[u].x), __uint_as_float(r.v[u].y)),
          bf16x2_bits(__uint_as_float(r.v[u].z), __uint_as_float(r.v[u].w)));
}

// The I/O mode's windows of a pass (the groups of stage_band_load, all of
// them): 8-byte cp.async copies where the four lanes share a source and the
// arrays are 16-byte aligned (vec), else loaded lane by lane and stored;
// with WORDS the other groups' lane pairs as 4-byte cp.async copies where
// both lanes share a source (vec), else (a pair that straddles two arrays
// at odd h) both lanes loaded before the pair is stored, so that no load
// waits on another (K2's and K3's 2-byte kernel; W0 is even, so no pair
// lies across W0).
template <int G, bool WORDS = false>
__device__ __forceinline__ void stage_io_copy(bf16* dst,
                                              const HaloT<bf16>& s, int tot,
                                              int c4, int W0, int WS, int BW,
                                              int SS, long long cfb, int Fin,
                                              int F, int x0, int y0,
                                              bool vec) {
  for (int e = threadIdx.x; e < tot; e += NT) {
    const int q = e / c4;
    const int j = 4 * (e - q * c4);
    const int ch = q / W0;
    const int i = q - ch * W0;
    const int set = ch / G;
    const int g = ch - set * G;
    const long long cf = cfb + ((long long)set * Fin + g) * F;
    const int x = x0 - s.h + i;
    const int y = y0 + j;
    bf16* d = dst + set * SS + g * BW + i * WS + j;
    if (vec && j + 4 <= W0 && (x < 0 || x >= s.n || one_source4(s, y))) {
      cp_async8(d, window_src(s, cf, x, y));
    } else if constexpr (WORDS) {
      for (int t = 0; t < 4 && j + t < W0; t += 2) {
        if (vec && (x < 0 || x >= s.n || one_source(s, y + t, y + t + 1))) {
          cp_async4(reinterpret_cast<float*>(d + t),
                    reinterpret_cast<const float*>(
                        window_src(s, cf, x, y + t)));
        } else {
          const bf16 lo = *window_src(s, cf, x, y + t);
          const bf16 hi = *window_src(s, cf, x, y + t + 1);
          *reinterpret_cast<__nv_bfloat162*>(d + t) =
              __halves2bfloat162(lo, hi);
        }
      }
    } else {
      for (int t = 0; t < 4 && j + t < W0; ++t) d[t] = *window_src(s, cf, x, y + t);
    }
  }
}

// The band mode's windows of a pass (the groups of stage_band_load) into
// the landing zone by cp.async, float32 as they are, group e at zone + (e /
// c4) * WS + 4 (e % c4): 16-byte copies where the four lanes share a source
// and the arrays are 16-byte aligned (vec), else 4-byte ones (lanes past
// W0 are not copied).
template <int G>
__device__ __forceinline__ void stage_band_copy(float* zone, const Halo& s,
                                                int tot, int c4, int W0,
                                                long long cfb, int Fin, int F,
                                                int x0, int y0, bool vec) {
  const int WS = 4 * c4;
  for (int e = threadIdx.x; e < tot; e += NT) {
    const int q = e / c4;
    const int j = 4 * (e - q * c4);
    const int ch = q / W0;  // set * G + g
    const int i = q - ch * W0;
    const int set = ch / G;
    const long long cf = cfb + ((long long)set * Fin + ch - set * G) * F;
    const int x = x0 - s.h + i;
    const int y = y0 + j;
    float* d = zone + q * WS + j;
    if (vec && j + 4 <= W0 && (x < 0 || x >= s.n || one_source4(s, y))) {
      cp_async16(d, window_src(s, cf, x, y));
    } else {
      for (int t = 0; t < 4 && j + t < W0; ++t)
        cp_async4(d + t, window_src(s, cf, x, y + t));
    }
  }
}

// The groups this thread copied into the landing zone (stage_band_copy),
// once its copies have landed, into the term buffers at dst as
// stage_band_store puts them, rounded to bfloat16.
template <int G>
__device__ __forceinline__ void land_zone(const float* zone, bf16* dst,
                                          int tot, int c4, int W0, int BW,
                                          int SS) {
  const int WS = 4 * c4;
  for (int e = threadIdx.x; e < tot; e += NT) {
    const int q = e / c4;
    const int j = 4 * (e - q * c4);
    const int ch = q / W0;
    const int i = q - ch * W0;
    const int set = ch / G;
    const float4 v = *reinterpret_cast<const float4*>(zone + q * WS + j);
    *reinterpret_cast<uint2*>(dst + set * SS + (ch - set * G) * BW + i * WS
                              + j) =
        make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w));
  }
}

// One lap of lap's on bfloat16 elements (the sums in float32, each term
// stored rounded; TWICE a runtime flag, twice: one body to compile) over
// the first nl of NS window sets (set u's buffers u * SS elements past src
// and dst): each weight read from shared memory feeds the G channels of
// every set.  With fewer than NS sets
// the first set's window runs in place of the others and only the nl sets
// are stored, so the unrolled body holds no per-set branch (guarding each
// set's loads and sums instead cost 1.7x at 15(d)'s radius-3 conv on an
// H100).  Splitting the sets over idle threads in the small regions
// measured 5% slower: the unrolled body costs NS sets whatever a thread
// keeps.  Each output sums its taps in the order of lap's, so a set's
// terms are the first bfloat16 version's bit for bit.
template <int R, int G, int NS>
__device__ __forceinline__ void lap_sets(const bf16* __restrict__ src,
                                         bf16* __restrict__ dst,
                                         const bf16* __restrict__ s_w,
                                         int W0, int WS, int Ww, int BW,
                                         int SS, int k, int nl, bool twice) {
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  const int lo = R * k;
  const int L = W0 - 2 * lo;
  const int hi = lo + L;
  const int nq = (L + kRun - 1) / kRun;
  int off[NS];  // set u's buffers, or the first set's past nl
#pragma unroll
  for (int u = 0; u < NS; ++u) off[u] = (u < nl ? u : 0) * SS;
  const int dq = NT / L;
  const int dj = NT - dq * L;
  int q = threadIdx.x / L;
  int jj = threadIdx.x - q * L;
  const int wrow = Ww * NP;
  while (q < nq) {
    const int i0 = lo + kRun * q;
    const int j = lo + jj;
    float s[NS][G][kRun];
#pragma unroll
    for (int u = 0; u < NS; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int o = 0; o < kRun; ++o) s[u][g][o] = 0.f;
    const bf16* wb = s_w + ((i0 - R) * Ww + (j - R)) * NP;
    const bf16* xb = src + (i0 - R) * WS + (j - R);
#pragma unroll
    for (int a = 0; a < kRun + 2 * R; ++a) {  // input row i0 - R + a
#pragma unroll
      for (int c = 0; c <= 2 * R; ++c) {  // input lane j - R + c
        float v[NS][G];
#pragma unroll
        for (int u = 0; u < NS; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g)
            v[u][g] = ld(xb[off[u] + g * BW + a * WS + c]);
#pragma unroll
        for (int o = 0; o < kRun; ++o) {
          const int dx = a - R - o;
          if (dx >= -R && dx <= R) {
            const float w = ld(wb[o * wrow + plane_of<R>(dx, c - R)]);
#pragma unroll
            for (int u = 0; u < NS; ++u)
#pragma unroll
              for (int g = 0; g < G; ++g)
                s[u][g][o] = fmaf(w, v[u][g], s[u][g][o]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      const int i = i0 + o;
      if (i < hi) {
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          if (u < nl) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              bf16* d = dst + off[u] + g * BW + i * WS + j;
              *d = to<bf16>(twice ? fmaf(2.f, s[u][g][o], -ld(*d))
                                  : s[u][g][o]);
            }
          }
        }
      }
    }
    jj += dj;
    q += dq;
    if (jj >= L) {
      jj -= L;
      ++q;
    }
  }
}

// K1's 2-byte launch: its arguments and whether the next pass's windows
// land in a zone of their own (s2_land, stencil_conv_s2.h)
struct S2Args {
  ConvArgs c;
  int land;
};

// One block per (face, T x T tile, group of GB batch indices, chunk of FC
// output channels), as stencil_conv_kernel; its batch indices run NS at a
// time (NS window sets a lap: s2_sets, stencil_conv_s2.h; the last chunk
// of a block may hold fewer), and each chunk's passes take the channel
// groups in order, each pass one lap a term over the chunk's windows,
// folded into each batch index's own sums.  With a landing zone (land)
// the next pass's windows are copied there by cp.async at the start of
// each pass, under all its laps, and moved into the term buffers after
// its last fold; without one they are staged after the last lap.
template <int R, int G, int PP, int FC, int NS>
__global__ void __launch_bounds__(NT, 1)
stencil_conv_s2_kernel(const S2Args sa) {
  const ConvArgs& a = sa.c;
  const bool land = sa.land && !a.io;  // the band mode's only (s2_land)
  extern __shared__ __align__(16) float smem[];
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  const int T = a.T, h = a.h, n = a.n, P = a.P, K = a.K;
  const int W0 = T + 2 * h;          // halo window side
  const int WS = (W0 + 3) & ~3;      // its row stride: rows 8-byte aligned
  const int c4 = WS / 4;             // 4-lane groups a row
  const int Ww = W0 - 2 * R;         // weight window side (lap 1's region)
  const int BW = (W0 + kRun - 1) * WS;  // one channel's buffer (+ run slack)
  const int SS = 2 * G * BW;         // one window set's two term buffers
  const int wkn = K * G * FC;        // one group's channel-kernel slice
  float* s_wk = smem;                               // 2 x K x G x FC
  float* zone = s_wk + 2 * wkn;  // land: NS x G x W0 x WS, 16-byte aligned
  // (Ww+kRun-1) x Ww x NP
  bf16* s_w = reinterpret_cast<bf16*>(zone + (land ? NS * G * W0 * WS : 0));
  // ns x 2 x G x BW, 8-byte aligned: set u's even and odd terms at
  // u * SS and u * SS + G * BW
  bf16* bufs = s_w + (((Ww + kRun - 1) * Ww * NP + 3) & ~3);

  const int tiles = n / T;
  const int f = blockIdx.y;
  const int x0 = (blockIdx.x / tiles) * T;
  const int y0 = (blockIdx.x % tiles) * T;
  const int fo0 = (blockIdx.z % a.chunks) * FC;
  const int b0 = (blockIdx.z / a.chunks) * a.GB;
  const int nb = min(a.GB, a.B - b0);
  const int ns = s2_block_sets(NS, nb);  // window sets a lap
  const int ngroups = a.Fin / G;           // G divides Fin
  const int npass = s2_chunks(nb, ns) * ngroups;
  const Halo halo{a.xc, a.top, a.bot, a.ls, n, h, a.Rs, P};

  // pass p: the channel group p % ngroups of chunk p / ngroups, batch
  // indices b0 + bc(p) .., sets(p) of them
  auto bc = [&](int p) { return (p / ngroups) * ns; };
  auto sets = [&](int p) { return s2_chunk_sets(nb, ns, p / ngroups); };
  auto groups_of = [&](int p) { return sets(p) * G * W0 * c4; };
  auto cfb = [&](int p) {
    return ((long long)(b0 + bc(p)) * a.Fin + (p % ngroups) * G) * a.F + f;
  };
  // pass p's windows into the buffers of parity `par` (0: even terms): the
  // I/O mode's copies all issued here; the band mode's first round loaded
  // into registers (stored by stage_end), the rest after it
  BandRound<> br;
  auto stage_begin = [&](int p, int par) {
    if (a.io)
      stage_io_copy<G>(bufs + par * G * BW, as_bf16(halo), groups_of(p), c4,
                       W0, WS, BW, SS, cfb(p), a.Fin, a.F, x0, y0, a.vec);
    else
      stage_band_load<G>(br, halo, threadIdx.x, groups_of(p), c4, W0, WS, BW,
                         SS, cfb(p), a.Fin, a.F, x0, y0, a.vec);
  };
  auto stage_end = [&](int p, int par) {
    if (!a.io) {
      bf16* d = bufs + par * G * BW;
      stage_band_store(br, d);
      const int tot = groups_of(p);
      for (int e0 = threadIdx.x + kLoads * NT; e0 < tot; e0 += kLoads * NT) {
        stage_band_load<G>(br, halo, e0, tot, c4, W0, WS, BW, SS, cfb(p),
                           a.Fin, a.F, x0, y0, a.vec);
        stage_band_store(br, d);
      }
    }
  };
  // the band mode's pass p's windows into the landing zone, and from
  // there (what this thread copied, once landed) into the buffers of
  // parity `par`
  auto zone_begin = [&](int p) {
    stage_band_copy<G>(zone, halo, groups_of(p), c4, W0, cfb(p), a.Fin, a.F,
                       x0, y0, a.vec);
  };
  auto zone_end = [&](int p, int par) {
    land_zone<G>(zone, bufs + par * G * BW, groups_of(p), c4, W0, BW, SS);
  };
  // pass p's slice of wk3, zero past Fout: s_wk[slot][k][g][fo], by
  // cp.async, rounded to bfloat16 by round_slice once it lands
  auto stage_wk = [&](int p, int slot) {
    stage_slice<G, FC>(s_wk + slot * wkn, a.wk3, K, a.Fin, a.Fout,
                       (p % ngroups) * G, fo0);
  };

  const int lgT = 31 - __clz(T);  // T is 8, 16 or 32
  float acc[NS][PP][FC];
#pragma unroll
  for (int u = 0; u < NS; ++u)
#pragma unroll
    for (int p = 0; p < PP; ++p)
#pragma unroll
      for (int o = 0; o < FC; ++o) acc[u][p][o] = 0.f;

  // the first pass's windows and slice fly while the weight window is
  // staged
  stage_wk(0, 0);
  stage_begin(0, 0);
  cp_async_commit();
  const bool wvec = (reinterpret_cast<size_t>(a.wext) & 15) == 0;
  if (a.io)
    stage_weights_s2<R>(s_w, reinterpret_cast<const bf16*>(a.wext), a.F, f,
                        n, a.Rs, P, h, x0, y0, Ww, wvec);
  else
    stage_weights_s2<R>(s_w, a.wext, a.F, f, n, a.Rs, P, h, x0, y0, Ww, wvec);
  stage_end(0, 0);
  cp_async_wait_all();
  round_slice<G, FC>(s_wk, K);
  __syncthreads();

  // the parity of this pass's T_0; the next pass's windows go to the
  // buffers of T_{K-2} once the last lap is done with them, overlapping
  // the last fold and the output
  int cur = 0;
  const int flip = (K - 1) % 2 == 0;  // T_{K-1} in the even buffers
  for (int p = 0; p < npass; ++p) {
    const bool more = p + 1 < npass;
    if (more) stage_wk(p + 1, (p + 1) & 1);
    if (land && more) zone_begin(p + 1);
    cp_async_commit();
    const int nl = sets(p);
    const float* wk = s_wk + (p & 1) * wkn;
    bf16* P0 = bufs + cur * G * BW;        // even terms
    bf16* P1 = bufs + (cur ^ 1) * G * BW;  // odd terms
    const int next = cur ^ flip;
    if (K == 1 && more && !land) stage_begin(p + 1, next);

#pragma unroll
    for (int u = 0; u < NS; ++u)
      if (u < nl) fold<G, PP, FC>(acc[u], P0 + u * SS, wk, BW, WS, h, lgT);
    for (int k = 1; k < K; ++k) {
      bf16* src = (k & 1) ? P0 : P1;
      bf16* dst = (k & 1) ? P1 : P0;
      lap_sets<R, G, NS>(src, dst, s_w, W0, WS, Ww, BW, SS, k, nl,
                         a.cheby && k >= 2);
      __syncthreads();
      if (k == K - 1 && more && !land) stage_begin(p + 1, next);
#pragma unroll
      for (int u = 0; u < NS; ++u)
        if (u < nl)
          fold<G, PP, FC>(acc[u], dst + u * SS, wk + k * G * FC, BW, WS, h,
                          lgT);
    }

    if ((p + 1) % ngroups == 0) {  // the chunk's batch indices are complete
      const int nfo = min(FC, a.Fout - fo0);
      long long gof[PP];
#pragma unroll
      for (int q = 0; q < PP; ++q) {
        const int pix = threadIdx.x + q * NT;
        gof[q] = pix < T * T ? (long long)(x0 + (pix >> lgT)) * P + h + y0
                                   + (pix & (T - 1))
                             : -1;
      }
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        if (u < nl) {
          const long long ch0 = (long long)(b0 + bc(p) + u) * a.Fout + fo0;
          if (a.io) {
            bf16* out = reinterpret_cast<bf16*>(a.out);
            store_sums(out, acc[u], gof, ch0, nfo, a.F, f, n, P);
            zero_pad_lanes(out, ch0, nfo, a.F, f, n, P, h, T, x0, y0);
          } else {
            store_sums(a.out, acc[u], gof, ch0, nfo, a.F, f, n, P);
            zero_pad_lanes(a.out, ch0, nfo, a.F, f, n, P, h, T, x0, y0);
          }
        }
      }
    }

    cp_async_commit();
    cp_async_wait_all();
    if (more) {
      if (land)
        zone_end(p + 1, next);
      else
        stage_end(p + 1, next);
      round_slice<G, FC>(s_wk + ((p + 1) & 1) * wkn, K);
    }
    __syncthreads();
    cur ^= flip;
  }
}

// kern<<<grid, NT, smem, stream>>>(a).  The dynamic shared-memory limit is
// an attribute of the function on the current device: raised per (function,
// device) only when a launch needs more, under a lock so that it only ever
// grows.  It is not a stream operation, so a launch captured in a CUDA graph
// after a first eager call never sets it.  K2 and K3 launch through it too.
template <class Args>
int launch_kernel(void (*kern)(Args), const Args& a, dim3 grid, size_t smem,
                  cudaStream_t stream) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> set_bytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> lock(mu);
    size_t& have = set_bytes[{reinterpret_cast<const void*>(kern), dev}];
    if (smem > have) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      have = smem;
    }
  }
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R, int G, int PP, int FC, int S>
int launch(const ConvArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  return launch_kernel(stencil_conv_kernel<R, G, PP, FC, S>, a, grid, smem,
                       stream);
}

template <int R, int G, int PP, int S>
int launch_fc(int FC, const ConvArgs& a, dim3 grid, size_t smem,
              cudaStream_t stream) {
  switch (FC) {
    case 4: return launch<R, G, PP, 4, S>(a, grid, smem, stream);
    case 8: return launch<R, G, PP, 8, S>(a, grid, smem, stream);
    case 16: return launch<R, G, PP, 16, S>(a, grid, smem, stream);
    default:
      return launch<R, G, PP, (PP == 1 ? 32 : 16), S>(a, grid, smem, stream);
  }
}

// T x T tiles: 4 pixels a thread on a 32-tile (radius <= 2 only: larger
// radii fit no 32-tile), 1 on smaller tiles
template <int R, int G, int S = kF32>
int launch_t(int T, int FC, const ConvArgs& a, dim3 grid, size_t smem,
             cudaStream_t stream) {
  if constexpr (R <= 2) {
    if (T == 32) return launch_fc<R, G, 4, S>(FC, a, grid, smem, stream);
  }
  return launch_fc<R, G, 1, S>(FC, a, grid, smem, stream);
}

// the 2-byte body compiled for ns window sets a lap: 1, 2 or 4, up to
// what the registers allow
template <int R, int G, int PP, int FC>
int launch_s2(const ConvArgs& a, int ns, int land, dim3 grid, size_t smem,
              cudaStream_t stream) {
  constexpr int M = s2_sets_max(R, PP, FC, G);
  const S2Args sa{a, land};
  if constexpr (M >= 4) {
    if (ns == 4)
      return launch_kernel(stencil_conv_s2_kernel<R, G, PP, FC, 4>, sa, grid,
                           smem, stream);
  }
  if constexpr (M >= 2) {
    if (ns == 2)
      return launch_kernel(stencil_conv_s2_kernel<R, G, PP, FC, 2>, sa, grid,
                           smem, stream);
  }
  if (ns == 1)
    return launch_kernel(stencil_conv_s2_kernel<R, G, PP, FC, 1>, sa, grid,
                         smem, stream);
  return (int)cudaErrorInvalidValue;
}

template <int R, int G, int PP>
int launch_s2_fc(int FC, const ConvArgs& a, int ns, int land, dim3 grid,
                 size_t smem, cudaStream_t stream) {
  switch (FC) {
    case 4: return launch_s2<R, G, PP, 4>(a, ns, land, grid, smem, stream);
    case 8: return launch_s2<R, G, PP, 8>(a, ns, land, grid, smem, stream);
    case 16: return launch_s2<R, G, PP, 16>(a, ns, land, grid, smem, stream);
    default:
      return launch_s2<R, G, PP, (PP == 1 ? 32 : 16)>(a, ns, land, grid,
                                                       smem, stream);
  }
}

// the 2-byte body on T x T tiles (launch_t's pixels a thread), ns window
// sets a lap, with a landing zone or not
template <int R, int G>
int launch_s2_t(int T, int FC, const ConvArgs& a, int ns, int land,
                dim3 grid, size_t smem, cudaStream_t stream) {
  if constexpr (R <= 2) {
    if (T == 32)
      return launch_s2_fc<R, G, 4>(FC, a, ns, land, grid, smem, stream);
  }
  return launch_s2_fc<R, G, 1>(FC, a, ns, land, grid, smem, stream);
}

// one per (radius, lap group G): the instantiations of stencil_conv*.cu,
// the bfloat16 ones of stencil_conv_bf16_r*.cu (kBf32, band mode) and
// stencil_conv_bf16_io*.cu (kBf32Io, I/O mode), and the 2-byte body's
// (either mode, ns window sets a lap, land: a landing zone) of
// stencil_conv_bf16_s2*.cu
#define DS_K1_LAUNCH(NAME)                                                 \
  int NAME(int T, int FC, const ConvArgs& a, dim3 grid, size_t smem,       \
           cudaStream_t stream)
#define DS_K1_S2_LAUNCH(NAME)                                              \
  int NAME(int T, int FC, const ConvArgs& a, int ns, int land, dim3 grid,  \
           size_t smem, cudaStream_t stream)
DS_K1_LAUNCH(launch_r1_g1);
DS_K1_LAUNCH(launch_r1_g2);
DS_K1_LAUNCH(launch_r1_g4);
DS_K1_LAUNCH(launch_r2_g1);
DS_K1_LAUNCH(launch_r2_g2);
DS_K1_LAUNCH(launch_r3_g1);
DS_K1_LAUNCH(launch_r4_g1);
DS_K1_LAUNCH(launch_bf16_r1_g1);
DS_K1_LAUNCH(launch_bf16_r1_g2);
DS_K1_LAUNCH(launch_bf16_r1_g4);
DS_K1_LAUNCH(launch_bf16_r2_g1);
DS_K1_LAUNCH(launch_bf16_r2_g2);
DS_K1_LAUNCH(launch_bf16_r3_g1);
DS_K1_LAUNCH(launch_bf16_r4_g1);
DS_K1_LAUNCH(launch_bf16_io_r1_g1);
DS_K1_LAUNCH(launch_bf16_io_r1_g2);
DS_K1_LAUNCH(launch_bf16_io_r1_g4);
DS_K1_LAUNCH(launch_bf16_io_r2_g1);
DS_K1_LAUNCH(launch_bf16_io_r2_g2);
DS_K1_LAUNCH(launch_bf16_io_r3_g1);
DS_K1_LAUNCH(launch_bf16_io_r4_g1);
DS_K1_S2_LAUNCH(launch_bf16_s2_r1_g1);
DS_K1_S2_LAUNCH(launch_bf16_s2_r1_g2);
DS_K1_S2_LAUNCH(launch_bf16_s2_r1_g4);
DS_K1_S2_LAUNCH(launch_bf16_s2_r2_g1);
DS_K1_S2_LAUNCH(launch_bf16_s2_r2_g2);
DS_K1_S2_LAUNCH(launch_bf16_s2_r3_g1);
DS_K1_S2_LAUNCH(launch_bf16_s2_r4_g1);

}  // namespace ds_k1
