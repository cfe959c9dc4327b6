// Fused K-term polynomial stencil conv on the HEALPix face layout (K1).
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
// (B*Fin, F, Rs, P) with the h halo rows at [Rs-h, Rs) / [0, h); lane strips
// ls (B*Fin, F, n, 128), west at [0, h), east at [h, 2h); weight planes wext
// (nplanes, F, n + 2Rs, P) in the wrapped-extended layout (rows [n, n+Rs)
// hold face rows [-Rs, 0), rows [n+Rs, n+2Rs) hold face rows [n, n+Rs)); wk3
// (K, Fin, Fout); out (B*Fout, F, n, P), zero outside the interior lanes.
//
// What bounds it on an H100: at the headline conv (nside 1024, Fin = Fout =
// 4) the bytes, mostly the weight planes and the activation in and out; at
// the quick_start widths the float32 operations of the contraction and the
// laps.  Design, one block per (face, T x T tile, group of GB batch indices,
// chunk of FC output channels):
// * the tile's weight window is staged in shared memory once and serves
//   every batch index, input channel and lap of the block (the first version
//   re-read it for every batch index and 8-channel chunk);
// * the G input channels of a group run their laps together, so each weight
//   loaded from shared memory feeds G channels; each thread computes a
//   vertical run of kRun points, so each loaded activation feeds up to 2r+1
//   taps (about 0.75 shared loads per FMA at r = 1, G = 4, against 4);
// * the taps are compile-time (the kernel is templated on the radius, in
//   the fixed order of graph/stencil.py::stencil_offsets), the lap loop is
//   fully unrolled, and the weights are interleaved per pixel so every tap's
//   weight sits at a constant offset: no per-point divide or index load;
// * all FC output channels accumulate in registers, so the recursion runs
//   once per input channel (not once per 8-channel chunk);
// * Chebyshev terms are formed in place (T_k over T_{k-2}), two buffer sets
//   per group; the next group's halo windows (16-byte copies where four
//   lanes come from one source) and channel-kernel slice are copied with
//   cp.async, into the set of T_{K-2} once the last lap is done with it,
//   overlapping the last fold and the output;
// * the block keeps its registers (__launch_bounds__) and shared memory
//   within two blocks per SM where it can: what limits it is latency and
//   the barrier after each lap, which the second block's warps cover.
// The launch plan (ops/fused_stencil.py::_k1_plan) picks T, G, GB and FC
// from the shape, by rules measured on an H100 (PERF.md).  Plain float32 FMAs on the CUDA cores, no tensor cores, no
// TF32.
//
// Its bfloat16 instantiations run the TPU kernel's bf16 band mode (bdt =
// bfloat16): the windows and weights rounded to bfloat16, each term rounded
// to bfloat16, float32 sums; on float32 arrays (mode 1) or bfloat16 ones
// (mode 2, the bf16 I/O mode: x, the strips with Rs = roundup(h, 16), the
// R16 weight planes and the output in bfloat16).  Those of
// stencil_conv_bf16.cu and _bf16_r*.cu (band) and of stencil_conv_bf16_io*.cu
// (I/O) hold the bfloat16 values in float32 shared memory and copy the
// windows with cp.async, as the float32 kernel; where the float32 kernel's
// shared bytes do not fit at the plan's tile and lap group, the 2-byte
// body of stencil_conv_bf16_s2*.cu holds 2-byte elements in either mode,
// several batch indices' windows a lap (stencil_conv_s2.h).  See
// stencil_conv.cuh.

#include "stencil_conv.cuh"

namespace ds_k1 {

DS_K1_LAUNCH(launch_r1_g4) { return launch_t<1, 4>(T, FC, a, grid, smem, stream); }

}  // namespace ds_k1

using namespace ds_k1;

// the dynamic shared bytes a launch may ask for (ops/fused_stencil.py's
// _SMEM_MAX: an H100 block's 227 KB less 1 KB)
constexpr size_t kSmemMax = 232448 - 1024;

extern "C" {

// kind: 0 Chebyshev, 1 monomial.  F: faces in the arrays.  T: tile side (8,
// 16 or 32, dividing n); G: input channels whose laps run together (1, 2
// or 4 at radius 1, 1 or 2 at radius 2, 1 beyond; it divides Fin); GB:
// batch indices per block; FC: output channels per block (4, 8, 16, or 32
// for T <= 16).  mode: 0 float32; 1 the bfloat16 band on float32 arrays;
// 2 the bfloat16 band on bfloat16 arrays (xc, the strips, wext, out; wk3
// stays float32; every array 4-byte aligned where the values are staged in
// float32).  The bfloat16 modes hold their staged values in float32 shared
// memory where those bytes fit, else in bfloat16 (the rule of
// ops/fused_stencil.py::_k1_bf16_staging; the 2-byte body's window sets
// and bytes: stencil_conv_s2.h).
// Returns cudaGetLastError() after the launch (or the attribute error).
int ds_stencil_conv(const float* xc, const float* top, const float* bot,
                    const float* ls, const float* wext, const float* wk3,
                    float* out, int kind, int K, int radius, int nplanes,
                    int B, int F, int Fin, int Fout, int n, int h, int Rs,
                    int P, int T, int G, int GB, int FC, int mode,
                    void* stream) {
  const int gm = radius == 1 ? 4 : (radius == 2 ? 2 : 1);
  const bool fc_ok = FC == 4 || FC == 8 || FC == 16 || (FC == 32 && T != 32);
  if (T == 32 && radius > 2) return (int)cudaErrorInvalidValue;
  if (mode < 0 || mode > 2 || (T != 8 && T != 16 && T != 32) || n % T
      || radius < 1 || radius > 4
      || nplanes != (2 * radius + 1) * (2 * radius + 1) || K < 1
      || radius * (K - 1) > h || B < 1 || F < 1 || F > 12 || Fin < 1
      || Fout < 1 || G < 1 || G > gm || (G & (G - 1)) || Fin % G
      || GB < 1 || !fc_ok)
    return (int)cudaErrorInvalidValue;
  const int chunks = (Fout + FC - 1) / FC;
  const long long gz = (long long)((B + GB - 1) / GB) * chunks;
  if (gz > 65535) return (int)cudaErrorInvalidValue;
  const int W0 = T + 2 * h;
  const int WS = (W0 + 3) & ~3;
  const int Ww = W0 - 2 * radius;
  // 16-byte window copies: rows 16-byte aligned in the sources
  const int vec =
      ((reinterpret_cast<size_t>(xc) | reinterpret_cast<size_t>(top)
           | reinterpret_cast<size_t>(bot) | reinterpret_cast<size_t>(ls))
          & 15) == 0;
  ConvArgs a{xc, top, bot, ls, wext, wk3, out, kind == 0, K, B, F, Fin, Fout,
             n, h, Rs, P, T, GB, chunks, vec, mode == 2};
  // the channel-kernel slots in float32, the windows in the staged type:
  // float32 in every mode where that fits (the bfloat16 modes' plan is
  // the 2-byte one, so it may not)
  auto smem_of = [&](size_t es) {
    return sizeof(float) * (size_t)2 * K * G * FC
        + es * ((((size_t)(Ww + kRun - 1) * Ww * nplanes + 3) & ~(size_t)3)
                + (size_t)2 * G * (W0 + kRun - 1) * WS);
  };
  const bool two = mode && smem_of(sizeof(float)) > kSmemMax;
  const size_t smem = smem_of(two ? sizeof(bf16) : sizeof(float));
  // the I/O mode's cp.async copies move whole 4-byte words, a window row
  // at most 32 of 8 lanes
  if (mode == 2 && !two && W0 > 256) return (int)cudaErrorInvalidValue;
  if (mode == 2 && !two
      && ((reinterpret_cast<size_t>(xc) | reinterpret_cast<size_t>(top)
           | reinterpret_cast<size_t>(bot) | reinterpret_cast<size_t>(ls)
           | reinterpret_cast<size_t>(wext)) & 3))
    return (int)cudaErrorMisalignedAddress;
  dim3 grid((n / T) * (n / T), F, (unsigned)gz);
  cudaStream_t st = (cudaStream_t)stream;
  if (two) {
    // the 2-byte body: as many window sets a lap as fit (one set: smem),
    // and in the band mode the landing zone where it fits beside them
    const int ns = s2_sets(T, h, radius, nplanes, K, G, FC, GB, kSmemMax);
    if (ns < 1) return (int)cudaErrorInvalidValue;
    const int land =
        s2_land(T, h, radius, nplanes, K, G, FC, ns, mode == 2, kSmemMax);
    const size_t sm2 = s2_smem(T, h, radius, nplanes, K, G, FC, ns)
                       + (land ? s2_zone(T, h, G, ns) : 0);
    switch (radius * 8 + G) {
      case 9: return launch_bf16_s2_r1_g1(T, FC, a, ns, land, grid, sm2, st);
      case 10: return launch_bf16_s2_r1_g2(T, FC, a, ns, land, grid, sm2, st);
      case 12: return launch_bf16_s2_r1_g4(T, FC, a, ns, land, grid, sm2, st);
      case 17: return launch_bf16_s2_r2_g1(T, FC, a, ns, land, grid, sm2, st);
      case 18: return launch_bf16_s2_r2_g2(T, FC, a, ns, land, grid, sm2, st);
      case 25: return launch_bf16_s2_r3_g1(T, FC, a, ns, land, grid, sm2, st);
      default: return launch_bf16_s2_r4_g1(T, FC, a, ns, land, grid, sm2, st);
    }
  }
  if (mode == 2) {
    switch (radius * 8 + G) {
      case 9: return launch_bf16_io_r1_g1(T, FC, a, grid, smem, st);
      case 10: return launch_bf16_io_r1_g2(T, FC, a, grid, smem, st);
      case 12: return launch_bf16_io_r1_g4(T, FC, a, grid, smem, st);
      case 17: return launch_bf16_io_r2_g1(T, FC, a, grid, smem, st);
      case 18: return launch_bf16_io_r2_g2(T, FC, a, grid, smem, st);
      case 25: return launch_bf16_io_r3_g1(T, FC, a, grid, smem, st);
      default: return launch_bf16_io_r4_g1(T, FC, a, grid, smem, st);
    }
  }
  if (mode) {
    switch (radius * 8 + G) {
      case 9: return launch_bf16_r1_g1(T, FC, a, grid, smem, st);
      case 10: return launch_bf16_r1_g2(T, FC, a, grid, smem, st);
      case 12: return launch_bf16_r1_g4(T, FC, a, grid, smem, st);
      case 17: return launch_bf16_r2_g1(T, FC, a, grid, smem, st);
      case 18: return launch_bf16_r2_g2(T, FC, a, grid, smem, st);
      case 25: return launch_bf16_r3_g1(T, FC, a, grid, smem, st);
      default: return launch_bf16_r4_g1(T, FC, a, grid, smem, st);
    }
  }
  switch (radius * 8 + G) {
    case 9: return launch_r1_g1(T, FC, a, grid, smem, st);
    case 10: return launch_r1_g2(T, FC, a, grid, smem, st);
    case 12: return launch_r1_g4(T, FC, a, grid, smem, st);
    case 17: return launch_r2_g1(T, FC, a, grid, smem, st);
    case 18: return launch_r2_g2(T, FC, a, grid, smem, st);
    case 25: return launch_r3_g1(T, FC, a, grid, smem, st);
    default: return launch_r4_g1(T, FC, a, grid, smem, st);
  }
}

}  // extern "C"
