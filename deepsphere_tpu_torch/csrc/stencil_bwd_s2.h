// The launch rule of the 2-byte bfloat16 kernel of K2 and K3
// (stencil_bwd_s2_kernel in stencil_bwd.cuh): how many window sets a lap
// takes, whether the next windows have a landing zone, the blocks an SM
// holds and the dynamic shared bytes those cost.  The one
// statement of this rule: the C entry (launch_bwd) applies it and the
// kernel sizes its shared arrays and its launch bounds by it.  Plain C++
// (no CUDA header), so that the CPU tests compile it with the host compiler
// and check it (tests/test_torch_s2_plan.py): its bytes at one set are
// those of the 2-byte plan, ops/fused_stencil.py::_bwd_smem with es = 2,
// and its blocks at one set those of ops/fused_stencil.py::_bwd_blocks.

#pragma once

#include <cstddef>

#include "stencil_conv_s2.h"

namespace ds_bwd {

// warps a block: each set's warp sums of a term in shared memory
constexpr int kS2Warps = 8;
// an SM's shared bytes (an H100 SM's 228 KB, ops/fused_stencil.py's
// _SMEM_SM), of which each block reserves 1 KB
constexpr size_t kS2SmemSM = 233472;

// the most window sets (batch indices of one channel group) a lap takes at
// radius R: one at radius <= 2, as K1's rule (the kernels for more sets
// cost the build more than a 9- or 25-tap lap gains from them); else from
// the registers they cost: a thread holds, a set, PP x FC fold values and
// (K2, dx) as many dx sums through the whole kernel (at most 32 in all) and
// G x 4 lap sums (at most 32 in all); at most 4 (1, 2 or 4)
DS_HD constexpr int s2_sets_max(int R, int PP, int FC, int G, bool dx) {
  const int held = (dx ? 2 : 1) * PP * FC;
  const int by_regs = 32 / held > 0 ? 32 / held : 1;
  const int by_lap = 8 / G > 0 ? 8 / G : 1;
  const int m = by_regs < by_lap ? by_regs : by_lap;
  return R <= 2 ? 1 : (m < 4 ? m : 4);
}

// the blocks an SM the kernel with ns sets is compiled for (its launch
// bounds): two where one set's dx sums and fold values fit 128 registers a
// thread (as the float32 kernel's min_blocks), else one
DS_HD constexpr int s2_min_blocks(bool dx, int PP, int FC, int ns) {
  return ns == 1 && (dx ? 2 : 1) * PP * FC <= 32 ? 2 : 1;
}

// dynamic shared bytes with ns window sets: in float32 two slots of the
// group's channel kernel (K2 only), two slots of each set's warp sums of a
// term and the block's K x Crec x FC dW cells; in 2 bytes an element the
// interleaved weight window with its run slack (padded to 4 elements) and,
// a set, the two term buffers of G halo windows with their slack rows (rows
// padded to 4 elements).  At ns = 1 these are the bytes of the 2-byte plan
// (ops/fused_stencil.py::_bwd_smem with es = 2).
inline size_t s2_smem(int T, int h, int r, int nplanes, int K, int G, int FC,
                      int Crec, bool dx, int ns) {
  const size_t W0 = T + 2 * h;
  const size_t WS = (W0 + 3) & ~(size_t)3;
  const size_t Ww = W0 - 2 * r;
  const size_t run = 4;  // kRun
  return sizeof(float)
             * ((dx ? (size_t)2 * K * G * FC : 0)
                + (size_t)2 * ns * kS2Warps * G * FC + (size_t)K * Crec * FC)
         + 2 * ((((Ww + run - 1) * Ww * nplanes) + 3) & ~(size_t)3)
         + 2 * (size_t)ns * 2 * G * (W0 + run - 1) * WS;
}

// the blocks an SM holds of a launch with ns sets at `bytes` dynamic
// shared bytes: the fewer of its launch bounds' and its bytes'
inline int s2_blocks(bool dx, int PP, int FC, int ns, size_t bytes) {
  const int by_bytes = (int)(kS2SmemSM / (bytes + 1024));
  const int by_regs = s2_min_blocks(dx, PP, FC, ns);
  return by_bytes < by_regs ? by_bytes : by_regs;
}

// the blocks an SM the launched instantiation is compiled for: a 32-tile
// one-set kernel (PP = 4) is compiled for one and for two blocks an SM and
// launched for the blocks its bytes hold (s2_blocks), since under the
// two-block cap of 128 registers its staging spilled (up to 1.3x slower
// on an H100 where the bytes hold one block anyway); the others as their
// registers allow (s2_min_blocks)
inline int s2_launch_blocks(bool dx, int PP, int FC, int ns, size_t bytes) {
  return PP == 4 ? s2_blocks(dx, PP, FC, ns, bytes)
                 : s2_min_blocks(dx, PP, FC, ns);
}

// the window sets a lap takes on a launch of tile T, lap group G, FC fold
// channels and GB batch indices a block, a power of two (the kernel is
// compiled for 1, 2 and 4): the most that the radius and the registers
// allow (s2_sets_max, PP = 4 pixels a thread on a 32-tile at radius <= 2,
// else 1), the block's batch indices and smem_max dynamic shared bytes,
// that keep the blocks an SM holds at one set; 0 where one set does not fit
inline int s2_sets(int T, int h, int r, int nplanes, int K, int G, int FC,
                   int Crec, bool dx, int GB, size_t smem_max) {
  const int PP = (T == 32 && r <= 2) ? 4 : 1;
  const size_t one = s2_smem(T, h, r, nplanes, K, G, FC, Crec, dx, 1);
  if (one > smem_max) return 0;
  const int blocks = s2_blocks(dx, PP, FC, 1, one);
  int ns = s2_sets_max(r, PP, FC, G, dx);
  while (ns > GB) ns /= 2;
  while (ns > 1) {
    const size_t b = s2_smem(T, h, r, nplanes, K, G, FC, Crec, dx, ns);
    if (b <= smem_max && s2_blocks(dx, PP, FC, ns, b) == blocks) break;
    ns /= 2;
  }
  return ns;
}

// whether the band mode's launch (io = 0) with ns sets has the landing
// zone (1), float32 (ds_k1::s2_zone), where the next pass's windows land by
// cp.async under the laps: where it fits beside the sets and keeps the
// blocks an SM holds; else (0, and always in the I/O mode, as in K1's
// body: there the zone gained at most 1% on an H100 and cost 2% at
// quick_start's first conv) the next pass's windows are staged after the
// last lap
inline int s2_land(int T, int h, int r, int nplanes, int K, int G, int FC,
                   int Crec, bool dx, int ns, int io, size_t smem_max) {
  if (io) return 0;
  const int PP = (T == 32 && r <= 2) ? 4 : 1;
  const size_t b = s2_smem(T, h, r, nplanes, K, G, FC, Crec, dx, ns);
  const size_t z = b + ds_k1::s2_zone(T, h, G, ns);
  return z <= smem_max
         && s2_blocks(dx, PP, FC, ns, z) == s2_blocks(dx, PP, FC, ns, b);
}

}  // namespace ds_bwd
