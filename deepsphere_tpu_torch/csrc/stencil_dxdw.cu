// Fused backward of the stencil conv: dx and dW in one pass over dy.
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
// stencil_tile.cuh (recursion channels Fout, chunk channels Fin; F faces);
// wk3t (K, Fout, Fin); xr (B*Fin, F, n, P) the forward input; mask (F, n, P)
// or null; dx (B*Fin, F, n, P), zero outside the interior lanes; dw (K*Fin,
// Fout) in the forward kernel's orientation; partial (K*Fin*Fout, G)
// scratch, G = B * F * (n/T)^2.
//
// What bounds it on an H100, by count: the same as K1 (the recursion's
// shared-memory taps and, at Fin*Fout >= 100, the contraction), plus one
// more contraction of the same size for dW: about twice K1's arithmetic for
// one more read of the activation.  The TPU kernel summed dW across its
// sequential grid into one VMEM block; here blocks run in any order, so each
// block reduces its tile's sums (warp shuffles, then shared memory) into its
// own column of the partial matrix and a second launch sums the columns in
// a fixed order: no atomics, bitwise-reproducible dW.  The x tile of the
// block's 8 channels is staged once in registers, beside the dx
// accumulators.  Plain f32 FMAs, no tensor cores, no TF32.

#include "stencil_tile.cuh"

extern "C" {

// kind: 0 Chebyshev, 1 monomial.  F: faces in the arrays.  Fc: recursion
// channels (the forward's Fout); Fx: x channels (the forward's Fin).  T: tile
// side (<= 32, divides n).  Returns cudaGetLastError() after the two launches (or the first
// error).
int ds_stencil_dxdw(const float* dy, const float* top, const float* bot,
                    const float* ls, const float* wext, const float* wk3t,
                    const int* offs, const float* xr, const float* mask,
                    float* dx, float* partial, float* dw, int kind, int K,
                    int radius, int nplanes, int B, int F, int Fc, int Fx,
                    int n, int h, int R, int P, int T, void* stream) {
  TileArgs a{dy, top, bot, ls, wext, wk3t, offs, xr, mask, dx, partial,
             kind == 0, K, radius, nplanes, F, Fc, Fx, n, h, R, P, T, 0, 0,
             0};
  return launch_tile<kDxDw>(a, B, dw, stream);
}

}  // extern "C"
