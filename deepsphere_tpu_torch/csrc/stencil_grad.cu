// dW of the two-kernel backward of the stencil conv.
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
// stencil_tile.cuh (recursion channels Fin, chunk channels Fout; F faces);
// dy (B*Fout, F, n, P); dw (K*Fin, Fout); partial (K*Fin*Fout, G) scratch,
// G = B * F * (n/T)^2.
//
// What bounds it on an H100, by count: the recursion's shared-memory taps
// (9 per pixel, channel and lap, as in K1) and the dW contraction (Fin*Fout
// FMAs per pixel and term); the bytes are one read of x and of dy.  The TPU
// kernel summed dW across its sequential grid into one VMEM block; here each
// block reduces its tile's sums (warp shuffles, then shared memory) into its
// own column of the partial matrix, and a second launch sums the columns in
// a fixed order: no atomics, bitwise-reproducible dW.  dy for the block's 8
// output channels is staged once in registers (Fout * T^2 floats would not
// fit in shared memory beside the window at Fout = 32).  Plain f32 FMAs, no
// tensor cores, no TF32.

#include "stencil_tile.cuh"

extern "C" {

// kind: 0 Chebyshev, 1 monomial.  F: faces in the arrays.  T: tile side
// (<= 32, divides n).
// Returns cudaGetLastError() after the two launches (or the first error).
int ds_stencil_grad(const float* xc, const float* top, const float* bot,
                    const float* ls, const float* wext, const int* offs,
                    const float* dy, float* partial, float* dw, int kind,
                    int K, int radius, int nplanes, int B, int F, int Fin,
                    int Fout, int n, int h, int R, int P, int T,
                    void* stream) {
  TileArgs a{xc, top, bot, ls, wext, nullptr, offs, dy, nullptr, nullptr,
             partial, kind == 0, K, radius, nplanes, F, Fin, Fout, n, h, R,
             P, T, 0, 0, 0};
  return launch_tile<kGrad>(a, B, dw, stream);
}

}  // extern "C"
