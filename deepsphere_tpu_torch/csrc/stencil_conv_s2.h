// The launch rule of K1's 2-byte bfloat16 body (stencil_conv_s2_kernel in
// stencil_conv.cuh): how many window sets a lap takes, whether the next
// pass's windows have a landing zone, and the dynamic shared bytes those
// cost.  The one statement of this rule: the C entry (stencil_conv.cu)
// applies it and the kernel sizes its shared arrays by it.  Plain C++ (no
// CUDA header), so that the CPU tests compile it with the host compiler
// and check it (tests/test_torch_s2_plan.py): its bytes at one set are
// those of the 2-byte plan, ops/fused_stencil.py::_k1_smem with es = 2.

#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define DS_HD __host__ __device__
#else
#define DS_HD
#endif

namespace ds_k1 {

// the most window sets (batch indices of one channel group) a lap of the
// 2-byte body takes at radius R: one at radius <= 2 (the kernels for more
// sets cost the build more than a 9- or 25-tap lap gains from them); else
// from the registers they cost: a thread holds PP x FC
// output sums a set through the whole kernel (at most 32 in all) and G x
// 4 lap sums a set (at most 32 in all); at most 4 (1, 2 or 4)
DS_HD constexpr int s2_sets_max(int R, int PP, int FC, int G) {
  const int by_acc = 32 / (PP * FC) > 0 ? 32 / (PP * FC) : 1;
  const int by_lap = 8 / G > 0 ? 8 / G : 1;
  const int m = by_acc < by_lap ? by_acc : by_lap;
  return R <= 2 ? 1 : (m < 4 ? m : 4);
}

// A block of nb batch indices runs them ns = s2_block_sets(the launch's
// sets, nb) at a time: s2_chunks chunks, chunk c holding s2_chunk_sets of
// them from c * ns (the last may hold fewer)
DS_HD constexpr int s2_block_sets(int ns, int nb) { return ns < nb ? ns : nb; }
DS_HD constexpr int s2_chunks(int nb, int ns) { return (nb + ns - 1) / ns; }
DS_HD constexpr int s2_chunk_sets(int nb, int ns, int c) {
  return nb - c * ns < ns ? nb - c * ns : ns;
}

// dynamic shared bytes of the 2-byte body with ns window sets: two slots of
// the group's channel kernel (float32), the interleaved weight window with
// its run slack (2 bytes an element, padded to 4 elements) and, a set, the
// two term buffers of G halo windows with their slack rows (2 bytes an
// element, rows padded to 4 elements).  At ns = 1 these are the bytes of
// the 2-byte plan (ops/fused_stencil.py::_k1_smem with es = 2).
inline size_t s2_smem(int T, int h, int r, int nplanes, int K, int G, int FC,
                      int ns) {
  const size_t W0 = T + 2 * h;
  const size_t WS = (W0 + 3) & ~(size_t)3;
  const size_t Ww = W0 - 2 * r;
  const size_t run = 4;  // kRun
  return sizeof(float) * 2 * (size_t)K * G * FC
      + 2 * ((((Ww + run - 1) * Ww * nplanes) + 3) & ~(size_t)3)
      + 2 * (size_t)ns * 2 * G * (W0 + run - 1) * WS;
}

// bytes of the landing zone of ns window sets: each set's G halo windows
// in float32 (W0 rows of WS), where the next pass's windows land under the
// current pass's laps
inline size_t s2_zone(int T, int h, int G, int ns) {
  const size_t W0 = T + 2 * h;
  return sizeof(float) * (size_t)ns * G * W0 * ((W0 + 3) & ~(size_t)3);
}

// whether the band mode's launch (io = 0) has the landing zone (1): where
// it fits beside ns window sets; else (0, and always in the I/O mode,
// whose windows are copied by cp.async after the last lap and measured 4%
// slower through the zone) the next pass's windows are staged after the
// last lap
inline int s2_land(int T, int h, int r, int nplanes, int K, int G, int FC,
                   int ns, int io, size_t smem_max) {
  return !io && s2_smem(T, h, r, nplanes, K, G, FC, ns) + s2_zone(T, h, G, ns)
                    <= smem_max;
}

// the window sets a lap takes on a launch of tile T, lap group G, FC
// output channels and GB batch indices a block, a power of two (the
// kernel is compiled for 1, 2 and 4): the most that the radius and the
// registers allow (s2_sets_max, PP = 4 pixels a thread on a 32-tile at
// radius <= 2, else 1), the block's batch indices and smem_max dynamic
// shared bytes; 0 where one set does not fit
inline int s2_sets(int T, int h, int r, int nplanes, int K, int G, int FC,
                   int GB, size_t smem_max) {
  const int PP = (T == 32 && r <= 2) ? 4 : 1;
  int ns = s2_sets_max(r, PP, FC, G);
  while (ns > GB) ns /= 2;
  while (ns > 0 && s2_smem(T, h, r, nplanes, K, G, FC, ns) > smem_max)
    ns /= 2;
  return ns;
}

}  // namespace ds_k1
