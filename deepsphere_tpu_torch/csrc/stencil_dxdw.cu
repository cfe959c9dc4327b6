// Fused backward of the stencil conv: dx and dW in one pass over dy (K2).
//
// Replaces the TPU kernel deepsphere_tpu/ops/pallas_stencil.py::_dxdw_kernel
// (launched by _run_dxdw_kernel).  L~ is symmetric, so the conv's adjoint is
// the same conv with the transposed channel kernel, and dW[k] =
// <T_k(L~) x, dy> = <x, T_k(L~) dy>: the recursion runs on dy (the Fout
// channels of the forward) and each term T_k(dy) feeds both
//   dx[b, fi] += sum_fo W[k, fi, fo] * T_k(dy)[b, fo]   (as K1 does), and
//   dW[k, fi, fo] += sum over the tile of (x * mask)[b, fi] * T_k(dy)[b, fo],
// with mask the corr_mask plane (0 at the corrupt corner rows, whose exact
// dW terms ops/fused_stencil.py adds from the correction ball).  dx is the
// raw conv of dy: its corrupt rows are patched afterwards, as the forward's.
//
// Layout: dy (B*Fout, F, n, P) with its strips and the weight planes as in
// stencil_bwd.cuh (recursion channels Fout, fold channels Fin; F faces);
// wk3t (K, Fout, Fin); xr (B*Fin, F, n, P) the forward input; mask (F, n, P)
// or null; dx (B*Fin, F, n, P), zero outside the interior lanes; dw (K*Fin,
// Fout) in the forward kernel's orientation; partial (K*Fin*Fout, ncol)
// scratch, ncol = F * (n/T)^2 * ceil(B/GB).
//
// What bounds it on an H100: at the headline (nside 1024, 4 -> 4 channels)
// the bytes, as K1's; at the quick_start widths the float32 operations of
// the laps and the two contractions (dx and dW: about twice K1's).  The
// first version re-staged the weight window and re-ran every lap for
// each batch index and 8-channel chunk, with runtime taps.  This one is the
// kDxDw mode of stencil_bwd.cuh: the weight window once per block for a
// group of batch indices, K1's compile-time-tap laps on G channels at a
// time, all fold channels a block holds at once (so each lap runs once per
// block), the x tile in registers once per batch index, the channel-kernel
// slice and the next halo windows by cp.async.  The TPU kernel summed dW
// across its sequential grid into one VMEM block; here each block sums its
// tile and batch group into its own column of the partial matrix and a
// second launch reduces the columns in a fixed order: no atomics,
// bitwise-reproducible dW.  Plain f32 FMAs, no tensor cores, no TF32.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_LAUNCH(dxdw_r1_g4) {
  return launch_t<kDxDw, 1, 4>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_bwd

extern "C" {

// kind: 0 Chebyshev, 1 monomial.  F: faces in the arrays.  Fc: recursion
// channels (the forward's Fout); Fx: x channels (the forward's Fin).  T
// (8, 16 or 32, dividing n), G (recursion channels per lap, dividing Fc), GB
// (batch indices per block) and FC (x channels per block: 4 or 8 on a
// 32-tile, up to 32 on smaller ones): the plan of
// ops/fused_stencil.py::_bwd_plan.  prec: 0 float32; the bfloat16 band
// on float32 arrays staged in float32 shared memory (1) or in bfloat16
// (3); on bfloat16 arrays (dy, its strips, wext, xr, dx) staged in float32
// (2: dy, its strips and wext 4-byte aligned) or in bfloat16 (4): the
// bfloat16 instantiations of stencil_dxdw_bf16*.cu, in the staging
// ops/fused_stencil.py::_bwd_bf16_staging picks from the shape.  Returns
// cudaGetLastError() after the two launches (or the first error).
int ds_stencil_dxdw(const float* dy, const float* top, const float* bot,
                    const float* ls, const float* wext, const float* wk3t,
                    const float* xr, const float* mask, float* dx,
                    float* partial, float* dw, int kind, int K, int radius,
                    int nplanes, int B, int F, int Fc, int Fx, int n, int h,
                    int Rs, int P, int T, int G, int GB, int FC,
                    int prec, void* stream) {
  ds_bwd::BwdArgs a{dy, top, bot, ls, wext, wk3t, xr, mask, dx, partial,
                    kind == 0, K, B, F, Fc, Fx, n, h, Rs, P, T, GB, 0, 0, 0,
                    0};
  return ds_bwd::launch_bwd(ds_bwd::kDxDw, a, radius, nplanes, G, FC, prec,
                            dw, (cudaStream_t)stream);
}

}  // extern "C"
