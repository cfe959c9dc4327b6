// The backward template of the fused stencil conv: K2 (stencil_dxdw.cu,
// fused dx + dW) and K3 (stencil_grad.cu, dW of the two-kernel backward)
// are its two modes.  Its laps are K1's (lap<R, G, TWICE> in
// stencil_conv.cuh: taps compile-time in stencil_offsets order, runs of
// kRun points a thread, G channels sharing each weight; lap_sets in the
// 2-byte kernel), and so are its staging of the weight window, the halo
// windows and the channel-kernel slice and the zeros of K2's dx pad lanes;
// K1 keeps its own kernels, only these device functions are shared.  Each
// stencil_dxdw*.cu and stencil_grad*.cu compiles the instantiations of some
// (mode, radius, lap group), so that one nvcc per source builds them in
// parallel.
//
// One block takes one (face f, T x T tile, group of GB batch indices, chunk
// of FC "fold" channels).  It stages the tile's weight window once,
// interleaved per pixel as K1's, and uses it for all its batch indices,
// recursion channels and laps.  Its steps are (batch index, group of G
// "recursion" channels), batch-major: each step's halo windows (cp.async,
// 16-byte copies where four lanes share a source) run through the K-1 laps
// of the Chebyshev or monomial recursion, and every term k is folded as
// soon as it exists:
//
//   kDxDw (K2):  acc[p][c] += W[k, rc, c0+c] * T_k[rc][p]  (registers, as K1)
//                dW[k, c0+c, rc] += sum_p o[p][c] * T_k[rc][p]
//   kGrad (K3):  dW[k, rc, c0+c] += sum_p o[p][c] * T_k[rc][p]
//
// with o the fold operand at the thread's tile pixels, loaded into
// registers once per batch index: the forward input times the corr_mask
// plane (K2), or the cotangent dy (K3).  Only interior lanes of o are read.
//
// dW without float atomics: each term's products are summed over the warp
// by shuffles (V values in about V shuffles, halving the set per step),
// over the 8 warps in shared memory, and into the block's dW cells (K x
// Crec x FC floats of shared memory) by the one thread that owns each
// cell, batch index after batch index in order; at the end the block
// writes its cells to its own column of the partial matrix, and
// reduce_partials sums each row in a fixed order.  Two calls on the same
// inputs give bitwise-equal dW.
//
// Layout: src (B*Crec, F, n, P) with face col y at lane y + h, F the faces
// the arrays hold; its row-halo strips top/bot (B*Crec, F, Rs, P), lane
// strips ls (B*Crec, F, n, 128); weight planes wext (nplanes, F, n + 2Rs, P)
// wrapped-extended, as K1's; wk (K, Crec, Cch) [K2]; oth (B*Cch, F, n, P);
// mask (F, n, P) or null [K2]; out (B*Cch, F, n, P), zero outside the
// interior lanes [K2]; partial (K*Crec*Cch, ncol), ncol = F * tiles^2 *
// ceil(B / GB).
//
// The bfloat16 instantiations round at K1's points (stencil_conv.cuh): the
// windows, the weights, the channel kernel and each stored term rounded to
// bfloat16, the fold operand rounded to bfloat16 as it is loaded into
// registers, every sum in float32; src, its strips, wext, oth and out are
// bfloat16 arrays in the bf16 I/O mode, else float32; wk, mask, partial and
// dW stay float32.  They come in two stagings, the same function bit for
// bit (ops/fused_stencil.py::_bwd_bf16_staging picks, launch_bwd's prec
// names it):
// * kBf32 (band; stencil_*_bf16.cu, _bf16_r*.cu) and kBf32Io (I/O;
//   stencil_*_bf16_io*.cu) of stencil_bwd_kernel, K1's stagings
//   (ds_k1::Staging), wherever the float32 kernel's shared bytes fit at
//   the plan's tile, lap group and fold channels and keep the blocks an SM
//   holds:
//   the bfloat16 values held in float32 shared memory and staged as K1's
//   kBf32 / kBf32Io stage them (cp.async halo windows and channel-kernel
//   slice, rounded or widened in place by the copying thread before the
//   barrier that publishes them; the weight window by 16-byte register
//   loads while the first window's copies fly), so the laps are K1's
//   float32 laps that round each stored term in pairs, and the next step's
//   windows overlap the last fold as in float32.  One instantiation a mode.
// * the 2-byte kernel (stencil_bwd_s2_kernel, stencil_*_bf16_s2*.cu)
//   elsewhere, on K1's 2-byte body's device functions, either mode by the
//   runtime io flag: the windows, weights and terms in bfloat16 shared
//   elements; at radius 3 and 4 one lap runs the windows of 2 or 4 batch
//   indices of a channel group (window sets, as many as the registers, the
//   block's batch indices and the free shared bytes allow without costing
//   a block an SM), so each weight read feeds every set.  The weight
//   window by 16-byte loads while the first windows fly; the next pass's
//   windows, in the band mode, by cp.async into a float32 landing zone
//   during the laps where it fits (rounded after the last fold), else
//   after the last lap (band: 16-byte register loads, rounded; I/O: 8-
//   and 4-byte cp.async); the channel-kernel slice by cp.async, rounded in
//   place.  One instantiation
//   a count of sets, compiled for two blocks an SM (128 registers) where a
//   set's dx sums and fold values allow it, as the float32 kernel is, and a
//   32-tile one-set kernel also for one block an SM, launched where its
//   bytes hold only one (under the cap its staging spilled).  The rule is
//   stencil_bwd_s2.h's.
// The fold, the dW reduction and the dx store are the same in every
// bfloat16 staging, and the sets of a lap are folded and flushed into the
// dW cells in batch order, term by term, so the dW sums come out in the
// same order as the first bfloat16 version's.

#pragma once

#include "stencil_bwd_s2.h"
#include "stencil_conv.cuh"

namespace ds_bwd {

using ds_k1::NT;
using ds_k1::kRun;
using ds_k1::bf16;
using ds_k1::cp_async_commit;
using ds_k1::cp_async_wait_all;
using ds_k1::ld;
using ds_k1::kF32;
using ds_k1::kBf32;
using ds_k1::kBf32Io;

constexpr int kWarps = NT / 32;
static_assert(kWarps == kS2Warps, "stencil_bwd_s2.h counts 8 warps a block");

enum Mode { kDxDw = 1, kGrad = 2 };

struct BwdArgs {
  const float* src;   // recursion input (B*Crec, F, n, P)
  const float* top;   // its strips
  const float* bot;
  const float* ls;
  const float* wext;  // (nplanes, F, n + 2Rs, P)
  const float* wk;    // (K, Crec, Cch)              [kDxDw]
  const float* oth;   // fold operand (B*Cch, F, n, P)
  const float* mask;  // (F, n, P) or null           [kDxDw]
  float* out;         // (B*Cch, F, n, P)            [kDxDw]
  float* partial;     // (K*Crec*Cch, ncol)
  int cheby, K, B, F, Crec, Cch, n, h, Rs, P, T, GB, chunks, vec, ncol;
  int io;             // bfloat16 arrays: src, its strips, wext, oth, out
};

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// One step of warp_sums: each lane keeps HALF of its 2 HALF values and
// sends the other half to the partner lane across `bit`.  Every index is a
// constant, so v stays in registers.
template <int V, int HALF>
__device__ __forceinline__ void halve(float (&v)[V], int lane) {
  constexpr int bit = 32 * HALF / V;
  const bool up = lane & bit;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
  if constexpr (HALF > 1) halve<V, HALF / 2>(v, lane);
}

// Sums of v[0..V) over the 32 lanes of the warp, V a power of two <= 32:
// each step sends half of the remaining values to the partner lane and
// keeps the other half.  Lane l returns the sum of value l >> (5 - log2 V).
template <int V>
__device__ __forceinline__ float warp_sums(float (&v)[V], int lane) {
  if constexpr (V > 1) halve<V, V / 2>(v, lane);
  float c = v[0];
#pragma unroll
  for (int bit = 16 >> ilog2(V); bit >= 1; bit >>= 1)
    c += __shfl_xor_sync(0xffffffffu, c, bit);
  return c;
}

// Fold one term (G channels in buf, BW elements apart) at this thread's PP
// tile pixels (threadIdx.x + p * NT of T x T, T = 1 << lgT, at window
// offset (h + ti) * WS + h + tj): into the dx accumulators through wkk, the
// term's [g][FC] slice [DX], and its dW sums over the warp into red[g][FC].
template <bool DX, int G, int PP, int FC, class E = float>
__device__ __forceinline__ void fold(float (&acc)[PP][FC],
                                     const float (&oth)[PP][FC],
                                     const E* __restrict__ buf,
                                     const float* __restrict__ wkk,
                                     float* __restrict__ red, int BW, int WS,
                                     int h, int lgT, int lane) {
  float t[G][PP];
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int pix = threadIdx.x + p * NT;
    const bool val = pix < (1 << (2 * lgT));
    const int off =
        val ? (h + (pix >> lgT)) * WS + h + (pix & ((1 << lgT) - 1)) : 0;
#pragma unroll
    for (int g = 0; g < G; ++g) t[g][p] = val ? ld(buf[g * BW + off]) : 0.f;
  }
  if constexpr (DX) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4* w4 = reinterpret_cast<const float4*>(wkk + g * FC);
#pragma unroll
      for (int c = 0; c < FC / 4; ++c) {
        const float4 w = w4[c];
#pragma unroll
        for (int p = 0; p < PP; ++p) {
          acc[p][4 * c + 0] = fmaf(w.x, t[g][p], acc[p][4 * c + 0]);
          acc[p][4 * c + 1] = fmaf(w.y, t[g][p], acc[p][4 * c + 1]);
          acc[p][4 * c + 2] = fmaf(w.z, t[g][p], acc[p][4 * c + 2]);
          acc[p][4 * c + 3] = fmaf(w.w, t[g][p], acc[p][4 * c + 3]);
        }
      }
    }
  }
  // dW: chunks of CW fold channels, V = G * CW sums a warp reduction
  constexpr int CW = FC < 8 ? FC : 8;
  constexpr int V = G * CW;
  constexpr int SH = 5 - ilog2(V);
#pragma unroll
  for (int cc = 0; cc < FC / CW; ++cc) {
    float s[V];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        float v = 0.f;
#pragma unroll
        for (int p = 0; p < PP; ++p) v = fmaf(t[g][p], oth[p][cc * CW + c], v);
        s[g * CW + c] = v;
      }
    const float r = warp_sums<V>(s, lane);
    if ((lane & ((1 << SH) - 1)) == 0) {
      const int j = lane >> SH;
      red[(j / CW) * FC + cc * CW + j % CW] = r;
    }
  }
}

// Two blocks per SM where the registers a thread holds across the laps
// allow it (the dx sums and the fold operand, PP x FC each)
template <int MODE, int PP, int FC>
constexpr int min_blocks() {
  return (MODE == kDxDw ? 2 : 1) * PP * FC <= 32 ? 2 : 1;
}

template <int MODE, int R, int G, int PP, int FC, int S = kF32>
__global__ void __launch_bounds__(NT, (min_blocks<MODE, PP, FC>()))
stencil_bwd_kernel(const BwdArgs a) {
  // bfloat16 values in float32: each mode its own instantiation, as K1's
  constexpr bool F32S = S == kBf32 || S == kBf32Io;
  constexpr bool IO = S == kBf32Io;
  extern __shared__ __align__(16) float smem[];
  constexpr bool kDx = MODE == kDxDw;
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  constexpr int NV = G * FC;  // dW cells of one term of one step
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = a.T, h = a.h, n = a.n, P = a.P, K = a.K;
  const int W0 = T + 2 * h;             // halo window side
  const int WS = (W0 + 3) & ~3;         // its row stride: rows 16-byte aligned
  const int Ww = W0 - 2 * R;            // weight window side (lap 1's region)
  const int BW = (W0 + kRun - 1) * WS;  // one channel's buffer (+ run slack)
  const int wkn = kDx ? K * G * FC : 0;  // one step's channel-kernel slice
  const int ndw = K * a.Crec * FC;       // the block's dW cells
  float* s_wk = smem;                             // 2 x K x G x FC [kDx]
  float* s_w = s_wk + 2 * wkn;                    // (Ww+kRun-1) x Ww x NP
  float* bufs = s_w + (((Ww + kRun - 1) * Ww * NP + 3) & ~3);  // 2 x G x BW
  float* s_red = bufs + 2 * G * BW;               // 2 x kWarps x NV
  float* s_dw = s_red + 2 * kWarps * NV;          // K x Crec x FC

  const int tiles = n / T;
  const int f = blockIdx.y;
  const int x0 = (blockIdx.x / tiles) * T;
  const int y0 = (blockIdx.x % tiles) * T;
  const int c0 = (blockIdx.z % a.chunks) * FC;
  const int bg = blockIdx.z / a.chunks;
  const int b0 = bg * a.GB;
  const int nb = min(a.GB, a.B - b0);
  const int ngroups = a.Crec / G;  // G divides Crec
  const int nsteps = nb * ngroups;

  // the weight window once per block, the halo windows and the
  // channel-kernel slice as K1 stages them (the float32 statements as they
  // were before the bfloat16 instantiations, so that their code is too)
  if constexpr (F32S) {
    // after the first window's copies (below)
  } else {
    ds_k1::stage_weights<R>(s_w, a.wext, a.F, f, n, a.Rs, P, h, x0, y0, Ww);
  }
  for (int e = tid; e < ndw; e += NT) s_dw[e] = 0.f;
  const ds_k1::Halo halo{a.src, a.top, a.bot, a.ls, n, h, a.Rs, P};
  // halo windows of step s's channel group into buffer set `set`
  auto stage_step = [&](int s, int set) {
    const int b = b0 + s / ngroups;
    const int rc0 = (s % ngroups) * G;
    if constexpr (IO) {
      ds_k1::stage_window_io<G>(bufs + set * G * BW, ds_k1::as_bf16(halo),
                                ((long long)b * a.Crec + rc0) * a.F + f, a.F,
                                x0, y0, W0, WS, BW, a.vec);
    } else {
      ds_k1::stage_window<G>(bufs + set * G * BW, halo,
                             ((long long)b * a.Crec + rc0) * a.F + f, a.F, x0,
                             y0, W0, WS, BW, a.vec);
    }
  };
  // step s's slice of wk, zero past Cch: s_wk[slot][k][g][c] (rounded to
  // bfloat16 by F32S once it lands)
  auto stage_wk = [&](int s, int slot) {
    ds_k1::stage_slice<G, FC>(s_wk + slot * wkn, a.wk, K, a.Crec, a.Cch,
                              (s % ngroups) * G, c0);
  };
  // F32S: what this thread copied into buffer set `set` (and channel-kernel
  // slot `slot`), rounded to bfloat16 (band mode) or widened (I/O mode) in
  // place once its copies have landed, before the barrier that publishes
  // them
  auto land_step = [&](int set, int slot) {
    if constexpr (F32S) {
      if constexpr (IO)
        ds_k1::widen_window_io<G>(bufs + set * G * BW, W0, WS, BW);
      else
        ds_k1::round_window<G>(bufs + set * G * BW, W0, WS, BW);
      if constexpr (kDx) ds_k1::round_slice<G, FC>(s_wk + slot * wkn, K);
    }
  };

  const int lgT = 31 - __clz(T);  // T is 8, 16 or 32
  // this thread's tile pixels: offset in a face plane, and the mask there
  long long gof[PP];
  float msk[PP];
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int pix = tid + p * NT;
    const bool val = pix < T * T;
    gof[p] = val ? (long long)(x0 + (pix >> lgT)) * P + h + y0 + (pix & (T - 1)) : -1;
    msk[p] = 1.f;
    if (kDx && val && a.mask != nullptr) msk[p] = a.mask[(long long)f * n * P + gof[p]];
  }
  float acc[PP][FC];
  float oth[PP][FC];
#pragma unroll
  for (int p = 0; p < PP; ++p)
#pragma unroll
    for (int c = 0; c < FC; ++c) acc[p][c] = 0.f;
  // the fold operand of batch index b at this thread's pixels, 0 past Cch
  // (rounded to bfloat16 in the bfloat16 modes, as the TPU kernel's bf16
  // dot operand)
  auto load_oth = [&](int b) {
#pragma unroll
    for (int c = 0; c < FC; ++c) {
      const bool ok = c0 + c < a.Cch;
      if constexpr (S != kF32) {
        const long long base =
            ((long long)(b * a.Cch + c0 + c) * a.F + f) * n * P;
        const bf16* ob = reinterpret_cast<const bf16*>(a.oth) + base;
        const float* of = a.oth + base;
#pragma unroll
        for (int p = 0; p < PP; ++p)
          oth[p][c] = ok && gof[p] >= 0
              ? msk[p] * (IO ? ld(ob[gof[p]]) : ds_k1::rnd(of[gof[p]]))
              : 0.f;
      } else {
        const float* oc = a.oth + ((long long)(b * a.Cch + c0 + c) * a.F + f) * n * P;
#pragma unroll
        for (int p = 0; p < PP; ++p)
          oth[p][c] = ok && gof[p] >= 0 ? msk[p] * oc[gof[p]] : 0.f;
      }
    }
  };
  // term k of channels rc0.. from the warps' sums in slot `slot` into the
  // block's dW cells: one thread per cell, in a fixed order
  auto flush = [&](int k, int rc0, int slot) {
    const float* red = s_red + slot * kWarps * NV;
    for (int e = tid; e < NV; e += NT) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * NV + e];
      s_dw[(k * a.Crec + rc0) * FC + e] += s;
    }
  };

  stage_step(0, 0);
  if (kDx) stage_wk(0, 0);
  if constexpr (F32S) {  // the weight window while those copies fly
    const bool wvec = (reinterpret_cast<size_t>(a.wext) & 15) == 0;
    if constexpr (IO)
      ds_k1::stage_weights_reg<R>(s_w, reinterpret_cast<const bf16*>(a.wext),
                                  a.F, f, n, a.Rs, P, h, x0, y0, Ww, wvec);
    else
      ds_k1::stage_weights_reg<R>(s_w, a.wext, a.F, f, n, a.Rs, P, h, x0, y0,
                                  Ww, wvec);
  }
  cp_async_commit();
  cp_async_wait_all();
  if constexpr (F32S) land_step(0, 0);
  __syncthreads();

  // buffer sets as K1's: the next step's windows go to the set of T_{K-2}
  // once the last lap is done with it.  Warp sums of term k of step s go to
  // slot (s * K + k) & 1, flushed after the barrier that follows the next
  // lap (or the step)
  int cur = 0;
  const int flip = (K - 1) % 2 == 0;  // T_{K-1} in the even set
  int prev_rc0 = 0;
  for (int s = 0; s < nsteps; ++s) {
    const bool more = s + 1 < nsteps;
    const int gi = s % ngroups;
    const int rc0 = gi * G;
    if (kDx && more) stage_wk(s + 1, (s + 1) & 1);
    cp_async_commit();
    if (s > 0) flush(K - 1, prev_rc0, (s * K - 1) & 1);
    if (gi == 0) load_oth(b0 + s / ngroups);
    const float* wk = s_wk + (s & 1) * wkn;
    float* red = s_red + warp * NV;
    float* P0 = bufs + cur * G * BW;        // even terms
    float* P1 = bufs + (cur ^ 1) * G * BW;  // odd terms
    const int next = cur ^ flip;
    if (K == 1 && more) stage_step(s + 1, next);

    fold<kDx, G, PP, FC>(acc, oth, P0, wk, red + ((s * K) & 1) * kWarps * NV,
                         BW, WS, h, lgT, lane);
    for (int k = 1; k < K; ++k) {
      float* src = (k & 1) ? P0 : P1;
      float* dst = (k & 1) ? P1 : P0;
      if (a.cheby && k >= 2)
        ds_k1::lap<R, G, true, F32S>(src, dst, s_w, W0, WS, Ww, BW, k);
      else
        ds_k1::lap<R, G, false, F32S>(src, dst, s_w, W0, WS, Ww, BW, k);
      __syncthreads();
      flush(k - 1, rc0, (s * K + k - 1) & 1);
      if (k == K - 1 && more) stage_step(s + 1, next);
      fold<kDx, G, PP, FC>(acc, oth, dst, wk + k * G * FC,
                           red + ((s * K + k) & 1) * kWarps * NV, BW, WS, h,
                           lgT, lane);
    }

    if constexpr (S != kF32) {
      if (kDx && gi == ngroups - 1) {  // the batch index's dx is complete
        const long long ch0 = (long long)(b0 + s / ngroups) * a.Cch + c0;
        const int nc = min(FC, a.Cch - c0);
        if (IO) {
          bf16* out = reinterpret_cast<bf16*>(a.out);
          ds_k1::store_sums(out, acc, gof, ch0, nc, a.F, f, n, P);
          ds_k1::zero_pad_lanes(out, ch0, nc, a.F, f, n, P, h, T, x0, y0);
        } else {
          ds_k1::store_sums(a.out, acc, gof, ch0, nc, a.F, f, n, P);
          ds_k1::zero_pad_lanes(a.out, ch0, nc, a.F, f, n, P, h, T, x0, y0);
        }
      }
    } else if (kDx && gi == ngroups - 1) {  // the batch index's dx is complete
      const int b = b0 + s / ngroups;
      const int nc = min(FC, a.Cch - c0);
#pragma unroll
      for (int c = 0; c < FC; ++c) {
        if (c < nc) {
          float* oc = a.out + ((long long)(b * a.Cch + c0 + c) * a.F + f) * n * P;
#pragma unroll
          for (int p = 0; p < PP; ++p) {
            if (gof[p] >= 0) oc[gof[p]] = acc[p][c];
            acc[p][c] = 0.f;
          }
        }
      }
      ds_k1::zero_pad_lanes(a.out, (long long)b * a.Cch + c0, nc, a.F, f, n,
                            P, h, T, x0, y0);
    }

    cp_async_commit();
    cp_async_wait_all();
    if constexpr (F32S) {
      if (more) land_step(next, (s + 1) & 1);
    }
    __syncthreads();
    cur ^= flip;
    prev_rc0 = rc0;
  }
  flush(K - 1, prev_rc0, (nsteps * K - 1) & 1);
  __syncthreads();

  // the block's dW cells -> its column of the partial matrix
  const long long col = ((long long)bg * a.F + f) * tiles * tiles + blockIdx.x;
  for (int e = tid; e < ndw; e += NT) {
    const int k = e / (a.Crec * FC);
    const int rem = e - k * a.Crec * FC;
    const int rc = rem / FC;
    const int c = c0 + rem - rc * FC;
    if (c < a.Cch) {
      const long long row = kDx ? ((long long)k * a.Cch + c) * a.Crec + rc
                                : ((long long)k * a.Crec + rc) * a.Cch + c;
      a.partial[row * a.ncol + col] = s_dw[e];
    }
  }
}

// The 2-byte bfloat16 kernel: its arguments and whether the next pass's
// windows land in a zone of their own (s2_land, stencil_bwd_s2.h)
struct S2BwdArgs {
  BwdArgs b;
  int land;
};

// One block per (face, T x T tile, group of GB batch indices, chunk of FC
// fold channels), as stencil_bwd_kernel, on K1's 2-byte body's device
// functions (stencil_conv_s2_kernel): bfloat16 shared elements, either mode
// by a.io.  Its batch indices run NS at a time (NS window sets a lap:
// s2_sets, stencil_bwd_s2.h; the last chunk of a block may hold fewer, whose
// missing sets alias set 0 in the lap and are skipped everywhere else), and
// each chunk's passes take the channel groups in order, each pass one lap a
// term over the chunk's windows.  Each term is folded set by set into each
// batch index's own dx sums and warp sums, and the warp sums are flushed
// into the dW cells set by set: each dW cell receives its batch indices'
// sums in batch order, as stencil_bwd_kernel adds them, and each dx sum its
// terms in its order, so the bits are the first bfloat16 version's.  With a
// landing zone (land, the band mode only) the next pass's windows are
// copied there by cp.async at the start of each pass, under all its laps,
// as the arrays hold them, and moved into the term buffers, rounded, after
// its last fold; without one they are staged after the last lap.  MB: the
// blocks an SM of its launch bounds (s2_launch_blocks).
template <int MODE, int R, int G, int PP, int FC, int NS, int MB>
__global__ void __launch_bounds__(NT, MB)
stencil_bwd_s2_kernel(const S2BwdArgs sa) {
  static_assert(MB == 1 || s2_min_blocks(MODE == kDxDw, PP, FC, NS) == 2,
                "two blocks an SM only where the registers allow them");
  const BwdArgs& a = sa.b;
  const bool land = sa.land && !a.io;  // the band mode's only
  extern __shared__ __align__(16) float smem[];
  constexpr bool kDx = MODE == kDxDw;
  constexpr int NP = (2 * R + 1) * (2 * R + 1);
  constexpr int NV = G * FC;  // dW cells of one term of one set
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = a.T, h = a.h, n = a.n, P = a.P, K = a.K;
  const int W0 = T + 2 * h;             // halo window side
  const int WS = (W0 + 3) & ~3;         // its row stride: rows 8-byte aligned
  const int c4 = WS / 4;                // 4-lane groups a row
  const int Ww = W0 - 2 * R;            // weight window side (lap 1's region)
  const int BW = (W0 + kRun - 1) * WS;  // one channel's buffer (+ run slack)
  const int SS = 2 * G * BW;            // one window set's two term buffers
  const int wkn = kDx ? K * G * FC : 0;  // one group's channel-kernel slice
  const int ndw = K * a.Crec * FC;       // the block's dW cells
  float* s_wk = smem;                     // 2 x K x G x FC [kDx]
  float* s_red = s_wk + 2 * wkn;          // 2 x NS x kWarps x NV
  float* s_dw = s_red + 2 * NS * kWarps * NV;  // K x Crec x FC
  // land (band mode): NS x G x W0 x WS floats, 16-byte aligned
  float* zone = s_dw + ndw;
  const int zf = land ? NS * G * W0 * WS : 0;
  // (Ww+kRun-1) x Ww x NP
  bf16* s_w = reinterpret_cast<bf16*>(zone + zf);
  // NS x 2 x G x BW, 8-byte aligned: set u's even and odd terms at u * SS
  // and u * SS + G * BW
  bf16* bufs = s_w + (((Ww + kRun - 1) * Ww * NP + 3) & ~3);

  const int tiles = n / T;
  const int f = blockIdx.y;
  const int x0 = (blockIdx.x / tiles) * T;
  const int y0 = (blockIdx.x % tiles) * T;
  const int c0 = (blockIdx.z % a.chunks) * FC;
  const int bg = blockIdx.z / a.chunks;
  const int b0 = bg * a.GB;
  const int nb = min(a.GB, a.B - b0);
  const int ns = ds_k1::s2_block_sets(NS, nb);  // window sets a lap
  const int ngroups = a.Crec / G;                 // G divides Crec
  const int npass = ds_k1::s2_chunks(nb, ns) * ngroups;
  const ds_k1::Halo halo{a.src, a.top, a.bot, a.ls, n, h, a.Rs, P};

  // pass p: the channel group p % ngroups of chunk p / ngroups, batch
  // indices b0 + bc(p) .., sets(p) of them
  auto bc = [&](int p) { return (p / ngroups) * ns; };
  auto sets = [&](int p) { return ds_k1::s2_chunk_sets(nb, ns, p / ngroups); };
  auto groups_of = [&](int p) { return sets(p) * G * W0 * c4; };
  auto cfb = [&](int p) {
    return ((long long)(b0 + bc(p)) * a.Crec + (p % ngroups) * G) * a.F + f;
  };
  // pass p's windows into the buffers of parity `par` (0: even terms), as
  // K1's 2-byte body stages them: the I/O mode's copies all issued by
  // stage_begin; the band mode's by stage_end, in rounds of kRound 4-lane
  // groups a thread through registers (carrying a round across the last
  // fold, as K1's body does, measured 1-6% slower at radius 3-4 on an
  // H100), 4 a round under two blocks' 128 registers, where 8 spilled
  constexpr int kRound = MB == 2 ? 4 : ds_k1::kLoads;
  auto stage_begin = [&](int p, int par) {
    if (a.io)
      ds_k1::stage_io_copy<G, true>(bufs + par * G * BW, ds_k1::as_bf16(halo),
                              groups_of(p), c4, W0, WS, BW, SS, cfb(p),
                              a.Crec, a.F, x0, y0, a.vec);
  };
  auto stage_end = [&](int p, int par) {
    if (!a.io) {
      bf16* d = bufs + par * G * BW;
      ds_k1::BandRound<kRound> br;
      const int tot = groups_of(p);
      for (int e0 = tid; e0 < tot; e0 += kRound * NT) {
        ds_k1::stage_band_load<G>(br, halo, e0, tot, c4, W0, WS, BW, SS,
                                  cfb(p), a.Crec, a.F, x0, y0, a.vec);
        ds_k1::stage_band_store(br, d);
      }
    }
  };
  // the band mode's landing zone: pass p's windows into it by cp.async in
  // float32, as the arrays hold them, and from there (what this thread
  // copied, once landed) into the buffers of parity `par`, rounded
  auto zone_begin = [&](int p) {
    ds_k1::stage_band_copy<G>(zone, halo, groups_of(p), c4, W0, cfb(p),
                              a.Crec, a.F, x0, y0, a.vec);
  };
  auto zone_end = [&](int p, int par) {
    ds_k1::land_zone<G>(zone, bufs + par * G * BW, groups_of(p), c4, W0, BW,
                        SS);
  };
  // pass p's slice of wk, zero past Cch: s_wk[slot][k][g][c], by cp.async,
  // rounded to bfloat16 by round_slice once it lands
  auto stage_wk = [&](int p, int slot) {
    ds_k1::stage_slice<G, FC>(s_wk + slot * wkn, a.wk, K, a.Crec, a.Cch,
                              (p % ngroups) * G, c0);
  };

  const int lgT = 31 - __clz(T);  // T is 8, 16 or 32
  // this thread's tile pixels: offset in a face plane (-1: none), in 32
  // bits, which the face planes' n x P elements fit (fewer registers held
  // through the kernel than stencil_bwd_kernel's 64-bit offsets and masks)
  int gof[PP];
#pragma unroll
  for (int p = 0; p < PP; ++p) {
    const int pix = tid + p * NT;
    gof[p] = pix < T * T ? (x0 + (pix >> lgT)) * P + h + y0 + (pix & (T - 1))
                         : -1;
  }
  float acc[NS][PP][FC];
  float oth[NS][PP][FC];
#pragma unroll
  for (int u = 0; u < NS; ++u)
#pragma unroll
    for (int p = 0; p < PP; ++p)
#pragma unroll
      for (int c = 0; c < FC; ++c) acc[u][p][c] = 0.f;
  // the fold operand of batch indices b .. b + nl - 1 at this thread's
  // pixels into sets 0 .. nl - 1, 0 past Cch, rounded to bfloat16 (read as
  // bfloat16 in the I/O mode), times the mask there (K2)
  auto load_oth = [&](int b, int nl) {
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      if (u < nl) {
#pragma unroll
        for (int c = 0; c < FC; ++c) {
          const bool ok = c0 + c < a.Cch;
          const long long base =
              ((long long)((b + u) * a.Cch + c0 + c) * a.F + f) * n * P;
          const bf16* ob = reinterpret_cast<const bf16*>(a.oth) + base;
          const float* of = a.oth + base;
#pragma unroll
          for (int p = 0; p < PP; ++p) {
            float m = 1.f;
            if (kDx && a.mask != nullptr && gof[p] >= 0)
              m = a.mask[(long long)f * n * P + gof[p]];
            oth[u][p][c] = ok && gof[p] >= 0
                ? m * (a.io ? ld(ob[gof[p]]) : ds_k1::rnd(of[gof[p]]))
                : 0.f;
          }
        }
      }
    }
  };
  // term k of channels rc0.. of the first nl sets, from their warps' sums
  // in slot `slot`, into the block's dW cells: one thread per cell, set
  // after set (batch order)
  auto flush = [&](int k, int rc0, int slot, int nl) {
    for (int u = 0; u < nl; ++u) {
      const float* red = s_red + (slot * NS + u) * kWarps * NV;
      for (int e = tid; e < NV; e += NT) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w * NV + e];
        s_dw[(k * a.Crec + rc0) * FC + e] += s;
      }
    }
  };

  // the first pass's windows and slice fly while the weight window is
  // staged
  for (int e = tid; e < ndw; e += NT) s_dw[e] = 0.f;
  if (kDx) stage_wk(0, 0);
  stage_begin(0, 0);
  cp_async_commit();
  const bool wvec = (reinterpret_cast<size_t>(a.wext) & 15) == 0;
  if (a.io)
    ds_k1::stage_weights_s2<R>(s_w, reinterpret_cast<const bf16*>(a.wext),
                               a.F, f, n, a.Rs, P, h, x0, y0, Ww, wvec);
  else
    ds_k1::stage_weights_s2<R>(s_w, a.wext, a.F, f, n, a.Rs, P, h, x0, y0,
                               Ww, wvec);
  stage_end(0, 0);
  cp_async_wait_all();
  if (kDx) ds_k1::round_slice<G, FC>(s_wk, K);
  __syncthreads();

  // the parity of this pass's T_0; the next pass's windows go to the
  // buffers of T_{K-2} once the last lap is done with them.  Warp sums of
  // term k of pass p go to slot (p * K + k) & 1, flushed after the barrier
  // that follows the next lap (or the pass)
  int cur = 0;
  const int flip = (K - 1) % 2 == 0;  // T_{K-1} in the even buffers
  int prev_rc0 = 0, prev_nl = 0;
  for (int p = 0; p < npass; ++p) {
    const bool more = p + 1 < npass;
    const int gi = p % ngroups;
    const int rc0 = gi * G;
    const int nl = sets(p);
    if (kDx && more) stage_wk(p + 1, (p + 1) & 1);
    if (land && more) zone_begin(p + 1);
    cp_async_commit();
    if (p > 0) flush(K - 1, prev_rc0, (p * K - 1) & 1, prev_nl);
    if (gi == 0) load_oth(b0 + bc(p), nl);
    const float* wk = s_wk + (p & 1) * wkn;
    float* red = s_red + warp * NV;
    bf16* P0 = bufs + cur * G * BW;        // even terms
    bf16* P1 = bufs + (cur ^ 1) * G * BW;  // odd terms
    const int next = cur ^ flip;
    if (K == 1 && more && !land) stage_begin(p + 1, next);

#pragma unroll
    for (int u = 0; u < NS; ++u)
      if (u < nl)
        fold<kDx, G, PP, FC>(acc[u], oth[u], P0 + u * SS, wk,
                             red + (((p * K) & 1) * NS + u) * kWarps * NV, BW,
                             WS, h, lgT, lane);
    for (int k = 1; k < K; ++k) {
      bf16* src = (k & 1) ? P0 : P1;
      bf16* dst = (k & 1) ? P1 : P0;
      ds_k1::lap_sets<R, G, NS>(src, dst, s_w, W0, WS, Ww, BW, SS, k, nl,
                                a.cheby && k >= 2);
      __syncthreads();
      flush(k - 1, rc0, (p * K + k - 1) & 1, nl);
      if (k == K - 1 && more && !land) stage_begin(p + 1, next);
#pragma unroll
      for (int u = 0; u < NS; ++u)
        if (u < nl)
          fold<kDx, G, PP, FC>(acc[u], oth[u], dst + u * SS, wk + k * G * FC,
                               red + (((p * K + k) & 1) * NS + u) * kWarps * NV,
                               BW, WS, h, lgT, lane);
    }

    if (kDx && gi == ngroups - 1) {  // the chunk's dx sums are complete
      const int nc = min(FC, a.Cch - c0);
      long long g64[PP];
#pragma unroll
      for (int q = 0; q < PP; ++q) g64[q] = gof[q];
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        if (u < nl) {
          const long long ch0 = (long long)(b0 + bc(p) + u) * a.Cch + c0;
          if (a.io) {
            bf16* out = reinterpret_cast<bf16*>(a.out);
            ds_k1::store_sums(out, acc[u], g64, ch0, nc, a.F, f, n, P);
            ds_k1::zero_pad_lanes(out, ch0, nc, a.F, f, n, P, h, T, x0, y0);
          } else {
            ds_k1::store_sums(a.out, acc[u], g64, ch0, nc, a.F, f, n, P);
            ds_k1::zero_pad_lanes(a.out, ch0, nc, a.F, f, n, P, h, T, x0,
                                  y0);
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
      if (kDx) ds_k1::round_slice<G, FC>(s_wk + ((p + 1) & 1) * wkn, K);
    }
    __syncthreads();
    cur ^= flip;
    prev_rc0 = rc0;
    prev_nl = nl;
  }
  flush(K - 1, prev_rc0, (npass * K - 1) & 1, prev_nl);
  __syncthreads();

  // the block's dW cells -> its column of the partial matrix
  const long long col = ((long long)bg * a.F + f) * tiles * tiles + blockIdx.x;
  for (int e = tid; e < ndw; e += NT) {
    const int k = e / (a.Crec * FC);
    const int rem = e - k * a.Crec * FC;
    const int rc = rem / FC;
    const int c = c0 + rem - rc * FC;
    if (c < a.Cch) {
      const long long row = kDx ? ((long long)k * a.Cch + c) * a.Crec + rc
                                : ((long long)k * a.Crec + rc) * a.Cch + c;
      a.partial[row * a.ncol + col] = s_dw[e];
    }
  }
}

// out[e] = sum_g partial[e, g], one block per row, in a fixed order: thread
// t sums g = t, t + 256, ..., then a fixed tree over the 256 threads.
// Static: each source that includes this header has its own copy.
static __global__ void __launch_bounds__(NT)
reduce_partials(const float* __restrict__ partial, float* __restrict__ out,
                int ncol) {
  __shared__ float s[NT];
  const float* row = partial + (long long)blockIdx.x * ncol;
  float acc = 0.f;
  for (int i = threadIdx.x; i < ncol; i += NT) acc += row[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

template <int MODE, int R, int G, int PP, int FC, int S>
int launch(const BwdArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  return ds_k1::launch_kernel(stencil_bwd_kernel<MODE, R, G, PP, FC, S>, a,
                              grid, smem, stream);
}

// FC fold channels a block: 4 or 8 with 4 pixels a thread (32-tile), up
// to 32 with 1
template <int MODE, int R, int G, int PP, int S>
int launch_fc(int FC, const BwdArgs& a, dim3 grid, size_t smem,
              cudaStream_t stream) {
  switch (FC) {
    case 4: return launch<MODE, R, G, PP, 4, S>(a, grid, smem, stream);
    case 8: return launch<MODE, R, G, PP, 8, S>(a, grid, smem, stream);
    case 16:
      return launch<MODE, R, G, PP, (PP == 1 ? 16 : 8), S>(a, grid, smem,
                                                           stream);
    default:
      return launch<MODE, R, G, PP, (PP == 1 ? 32 : 8), S>(a, grid, smem,
                                                           stream);
  }
}

// T x T tiles: 4 pixels a thread on a 32-tile (radius <= 2 only), 1 on
// smaller tiles
template <int MODE, int R, int G, int S = kF32>
int launch_t(int T, int FC, const BwdArgs& a, dim3 grid, size_t smem,
             cudaStream_t stream) {
  if constexpr (R <= 2) {
    if (T == 32) return launch_fc<MODE, R, G, 4, S>(FC, a, grid, smem, stream);
  }
  return launch_fc<MODE, R, G, 1, S>(FC, a, grid, smem, stream);
}

// the 2-byte kernel compiled for ns window sets a lap: 1, 2 or 4, up to
// what the registers allow (s2_sets_max), for the mb blocks an SM
// s2_launch_blocks gives (a 32-tile one-set kernel for one and for two)
template <int MODE, int R, int G, int PP, int FC>
int launch_s2(const BwdArgs& a, int ns, int land, int mb, dim3 grid,
              size_t smem, cudaStream_t stream) {
  constexpr bool dx = MODE == kDxDw;
  constexpr int M = s2_sets_max(R, PP, FC, G, dx);
  constexpr int MB = s2_min_blocks(dx, PP, FC, 1);
  const S2BwdArgs sa{a, land};
  if constexpr (M >= 4) {
    if (ns == 4)
      return ds_k1::launch_kernel(
          stencil_bwd_s2_kernel<MODE, R, G, PP, FC, 4, 1>, sa, grid, smem,
          stream);
  }
  if constexpr (M >= 2) {
    if (ns == 2)
      return ds_k1::launch_kernel(
          stencil_bwd_s2_kernel<MODE, R, G, PP, FC, 2, 1>, sa, grid, smem,
          stream);
  }
  if constexpr (PP == 4 && MB == 2) {
    if (ns == 1 && mb == 1)
      return ds_k1::launch_kernel(
          stencil_bwd_s2_kernel<MODE, R, G, PP, FC, 1, 1>, sa, grid, smem,
          stream);
  }
  if (ns == 1 && mb == MB)
    return ds_k1::launch_kernel(
        stencil_bwd_s2_kernel<MODE, R, G, PP, FC, 1, MB>, sa, grid, smem,
        stream);
  return (int)cudaErrorInvalidValue;
}

// the 2-byte kernel's fold channels, as launch_fc's
template <int MODE, int R, int G, int PP>
int launch_s2_fc(int FC, const BwdArgs& a, int ns, int land, int mb,
                 dim3 grid, size_t smem, cudaStream_t stream) {
  switch (FC) {
    case 4:
      return launch_s2<MODE, R, G, PP, 4>(a, ns, land, mb, grid, smem, stream);
    case 8:
      return launch_s2<MODE, R, G, PP, 8>(a, ns, land, mb, grid, smem, stream);
    case 16:
      return launch_s2<MODE, R, G, PP, (PP == 1 ? 16 : 8)>(a, ns, land, mb,
                                                           grid, smem, stream);
    default:
      return launch_s2<MODE, R, G, PP, (PP == 1 ? 32 : 8)>(a, ns, land, mb,
                                                           grid, smem, stream);
  }
}

// the 2-byte kernel on launch_t's tiles, ns window sets a lap, with a
// landing zone or not
template <int MODE, int R, int G>
int launch_s2_t(int T, int FC, const BwdArgs& a, int ns, int land, int mb,
                dim3 grid, size_t smem, cudaStream_t stream) {
  if constexpr (R <= 2) {
    if (T == 32)
      return launch_s2_fc<MODE, R, G, 4>(FC, a, ns, land, mb, grid, smem,
                                         stream);
  }
  return launch_s2_fc<MODE, R, G, 1>(FC, a, ns, land, mb, grid, smem, stream);
}

// one per (mode, radius, lap group G): the instantiations of
// stencil_dxdw*.cu and stencil_grad*.cu; the bfloat16 ones of
// *_bf16.cu and *_bf16_r*.cu (kBf32, band mode) and *_bf16_io*.cu
// (kBf32Io, I/O mode); the 2-byte kernel's (either mode, ns window sets a
// lap, land: a landing zone, mb blocks an SM) of *_bf16_s2*.cu
#define DS_BWD_LAUNCH(NAME)                                                \
  int NAME(int T, int FC, const BwdArgs& a, dim3 grid, size_t smem,        \
           cudaStream_t stream)
#define DS_BWD_S2_LAUNCH(NAME)                                             \
  int NAME(int T, int FC, const BwdArgs& a, int ns, int land, int mb,      \
           dim3 grid, size_t smem, cudaStream_t stream)
#define DS_BWD_FAMILY(L, P)                                                \
  L(P##_r1_g1);                                                            \
  L(P##_r1_g2);                                                            \
  L(P##_r1_g4);                                                            \
  L(P##_r2_g1);                                                            \
  L(P##_r2_g2);                                                            \
  L(P##_r3_g1);                                                            \
  L(P##_r4_g1)
DS_BWD_FAMILY(DS_BWD_LAUNCH, dxdw);
DS_BWD_FAMILY(DS_BWD_LAUNCH, grad);
DS_BWD_FAMILY(DS_BWD_LAUNCH, dxdw_bf16);
DS_BWD_FAMILY(DS_BWD_LAUNCH, grad_bf16);
DS_BWD_FAMILY(DS_BWD_LAUNCH, dxdw_bf16_io);
DS_BWD_FAMILY(DS_BWD_LAUNCH, grad_bf16_io);
DS_BWD_FAMILY(DS_BWD_S2_LAUNCH, dxdw_bf16_s2);
DS_BWD_FAMILY(DS_BWD_S2_LAUNCH, grad_bf16_s2);

// rc = the launch of family P's (radius, G) instantiation on the
// arguments ARGS
#define DS_BWD_PICK(P, ARGS)                                               \
  switch (radius * 8 + G) {                                                \
    case 9: rc = P##_r1_g1 ARGS; break;                                    \
    case 10: rc = P##_r1_g2 ARGS; break;                                   \
    case 12: rc = P##_r1_g4 ARGS; break;                                   \
    case 17: rc = P##_r2_g1 ARGS; break;                                   \
    case 18: rc = P##_r2_g2 ARGS; break;                                   \
    case 25: rc = P##_r3_g1 ARGS; break;                                   \
    default: rc = P##_r4_g1 ARGS; break;                                   \
  }

// the dynamic shared bytes a launch may ask for (ops/fused_stencil.py's
// _SMEM_MAX: an H100 block's 227 KB less 1 KB)
constexpr size_t kSmemMax = 232448 - 1024;

// Checks the shape (T, G, GB and FC as ops/fused_stencil.py::_bwd_plan
// picks them), launches the kernel on its plan, then the reduction of its
// partial sums into dw (K*Crec*Cch floats).  prec: 0 float32; the
// bfloat16 band on float32 arrays, 1 staged in float32 shared memory or 3
// in bfloat16; on bfloat16 arrays, 2 staged in float32 (every array
// 4-byte aligned) or 4 in bfloat16.  The caller picks the staging
// (ops/fused_stencil.py::_bwd_bf16_staging); a staging whose bytes do not
// fit is refused.  The 2-byte kernel's window sets, landing zone and bytes
// are stencil_bwd_s2.h's.  Returns cudaGetLastError() after the
// launches (or the first error).
inline int launch_bwd(int mode, BwdArgs a, int radius, int nplanes, int G,
                      int FC, int prec, float* dw, cudaStream_t stream) {
  const int T = a.T;
  const int gm = radius == 1 ? 4 : (radius == 2 ? 2 : 1);
  const bool fc_ok =
      FC == 4 || FC == 8 || ((FC == 16 || FC == 32) && T != 32);
  if (T == 32 && radius > 2) return (int)cudaErrorInvalidValue;
  if ((mode != kDxDw && mode != kGrad) || prec < 0 || prec > 4
      || (T != 8 && T != 16 && T != 32)
      || a.n % T || radius < 1 || radius > 4
      || nplanes != (2 * radius + 1) * (2 * radius + 1) || a.K < 1
      || radius * (a.K - 1) > a.h || a.B < 1 || a.F < 1 || a.F > 12
      || a.Crec < 1 || a.Cch < 1 || G < 1 || G > gm || (G & (G - 1))
      || a.Crec % G || a.GB < 1 || !fc_ok)
    return (int)cudaErrorInvalidValue;
  const int tiles = a.n / T;
  const int nbg = (a.B + a.GB - 1) / a.GB;
  a.chunks = (a.Cch + FC - 1) / FC;
  const long long gz = (long long)nbg * a.chunks;
  if (gz > 65535) return (int)cudaErrorInvalidValue;
  a.ncol = nbg * a.F * tiles * tiles;
  const int W0 = T + 2 * a.h;
  const int WS = (W0 + 3) & ~3;
  const int Ww = W0 - 2 * radius;
  // 16-byte window copies: rows 16-byte aligned in the sources
  a.vec = ((reinterpret_cast<size_t>(a.src) | reinterpret_cast<size_t>(a.top)
            | reinterpret_cast<size_t>(a.bot) | reinterpret_cast<size_t>(a.ls))
           & 15) == 0;
  a.io = prec == 2 || prec == 4;
  dim3 grid(tiles * tiles, a.F, (unsigned)gz);
  int rc;
  if (prec > 2) {
    // as many window sets a lap as fit (one set: the 2-byte plan's bytes),
    // the landing zone where it fits beside them, and the instantiation
    // for the blocks an SM those bytes hold
    const bool dx = mode == kDxDw;
    const int ns = s2_sets(T, a.h, radius, nplanes, a.K, G, FC, a.Crec, dx,
                           a.GB, kSmemMax);
    if (ns < 1) return (int)cudaErrorInvalidValue;
    const int land = s2_land(T, a.h, radius, nplanes, a.K, G, FC, a.Crec, dx,
                             ns, a.io, kSmemMax);
    const size_t smem =
        s2_smem(T, a.h, radius, nplanes, a.K, G, FC, a.Crec, dx, ns)
        + (land ? ds_k1::s2_zone(T, a.h, G, ns) : 0);
    const int mb = s2_launch_blocks(dx, T == 32 && radius <= 2 ? 4 : 1, FC,
                                    ns, smem);
    if (dx)
      DS_BWD_PICK(dxdw_bf16_s2, (T, FC, a, ns, land, mb, grid, smem, stream))
    else
      DS_BWD_PICK(grad_bf16_s2, (T, FC, a, ns, land, mb, grid, smem, stream))
  } else {
    // the windows in float32, as the other arrays
    const size_t smem =
        sizeof(float)
        * ((mode == kDxDw ? (size_t)2 * a.K * G * FC : 0)
           + (size_t)2 * kWarps * G * FC + (size_t)a.K * a.Crec * FC
           + (((size_t)(Ww + kRun - 1) * Ww * nplanes + 3) & ~(size_t)3)
           + (size_t)2 * G * (W0 + kRun - 1) * WS);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    // the I/O mode's cp.async copies move whole 4-byte words, a window row
    // at most 32 of 8 lanes
    if (prec == 2 && W0 > 256) return (int)cudaErrorInvalidValue;
    if (prec == 2
        && ((reinterpret_cast<size_t>(a.src) | reinterpret_cast<size_t>(a.top)
             | reinterpret_cast<size_t>(a.bot) | reinterpret_cast<size_t>(a.ls)
             | reinterpret_cast<size_t>(a.wext)) & 3))
      return (int)cudaErrorMisalignedAddress;
    if (mode == kDxDw) {
      if (prec == 2) DS_BWD_PICK(dxdw_bf16_io, (T, FC, a, grid, smem, stream))
      else if (prec) DS_BWD_PICK(dxdw_bf16, (T, FC, a, grid, smem, stream))
      else DS_BWD_PICK(dxdw, (T, FC, a, grid, smem, stream))
    } else {
      if (prec == 2) DS_BWD_PICK(grad_bf16_io, (T, FC, a, grid, smem, stream))
      else if (prec) DS_BWD_PICK(grad_bf16, (T, FC, a, grid, smem, stream))
      else DS_BWD_PICK(grad, (T, FC, a, grid, smem, stream))
    }
  }
  if (rc != 0) return rc;
  reduce_partials<<<a.K * a.Crec * a.Cch, NT, 0, stream>>>(a.partial, dw,
                                                           a.ncol);
  return (int)cudaGetLastError();
}

}  // namespace ds_bwd
