// The 2-byte bfloat16 kernel of the dW kernel of the two-kernel backward (K3,
// stencil_grad.cu; stencil_bwd_s2_kernel of stencil_bwd.cuh,
// either mode), where only 2-byte shared elements fit, for
// radius 2 lap group 2.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_S2_LAUNCH(grad_bf16_s2_r2_g2) {
  return launch_s2_t<kGrad, 2, 2>(T, FC, a, ns, land, mb, grid, smem,
                                  stream);
}

}  // namespace ds_bwd
