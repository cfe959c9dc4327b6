// dW of the two-kernel backward of the stencil conv (K3).
//
// Replaces the TPU kernel deepsphere_tpu/ops/pallas_stencil.py::_grad_kernel
// (launched by _run_grad_kernel).  It computes
//   dW[k, fi, fo] = sum_b sum over the interior of T_k(L~) x[b, fi] * dy[b, fo]
// with the recursion run on the forward input x through x's strips (those
// the forward built), and dy read at the interior lanes only (its halo lanes
// may hold anything).  The caller has zeroed dy's corrupt corner rows and
// adds their exact terms from the correction ball.  dx of this route is the
// forward conv (K4 + K1) on dy.
//
// Layout: xc (B*Fin, F, n, P) with its strips and the weight planes as in
// stencil_bwd.cuh (recursion channels Fin, fold channels Fout; F faces);
// dy (B*Fout, F, n, P); dw (K*Fin, Fout); partial (K*Fin*Fout, ncol)
// scratch, ncol = F * (n/T)^2 * ceil(B/GB).
//
// What bounds it on an H100: at the headline the bytes (one read of x, of
// its strips, of the weight planes and of dy); at the quick_start widths
// the float32 operations of the laps and of the dW contraction.  The first
// version re-staged the weight window and re-ran every lap for each
// batch index and 8-channel chunk, with runtime taps.  This one is the kGrad
// mode of stencil_bwd.cuh: the weight window once per block for a group of
// batch indices, K1's compile-time-tap laps on G channels at a time, all
// fold channels a block holds at once (each lap runs once per block), dy's
// tile in registers once per batch index, the next halo windows by
// cp.async.  dW through per-block columns of the partial matrix and a
// fixed-order second launch: no atomics, bitwise-reproducible.  Plain f32
// FMAs, no tensor cores, no TF32.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_LAUNCH(grad_r1_g4) {
  return launch_t<kGrad, 1, 4>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_bwd

extern "C" {

// kind: 0 Chebyshev, 1 monomial.  F: faces in the arrays.  T, G (dividing
// Fin), GB and FC (dy channels per block): the plan of
// ops/fused_stencil.py::_bwd_plan, as for ds_stencil_dxdw; prec as its
// (xc, its strips, wext and dy bfloat16 at 2 and 4; xc, its strips and
// wext 4-byte aligned at 2).  Returns
// cudaGetLastError() after the two launches (or the first error).
int ds_stencil_grad(const float* xc, const float* top, const float* bot,
                    const float* ls, const float* wext, const float* dy,
                    float* partial, float* dw, int kind, int K, int radius,
                    int nplanes, int B, int F, int Fin, int Fout, int n,
                    int h, int Rs, int P, int T, int G, int GB, int FC,
                    int prec, void* stream) {
  ds_bwd::BwdArgs a{xc, top, bot, ls, wext, nullptr, dy, nullptr, nullptr,
                    partial, kind == 0, K, B, F, Fin, Fout, n, h, Rs, P, T,
                    GB, 0, 0, 0, 0};
  return ds_bwd::launch_bwd(ds_bwd::kGrad, a, radius, nplanes, G, FC, prec,
                            dw, (cudaStream_t)stream);
}

}  // extern "C"
