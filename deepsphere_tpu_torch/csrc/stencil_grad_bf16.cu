// bfloat16 instantiations of the dW kernel of the two-kernel backward (K3,
// stencil_grad.cu; bfloat16 values in float32 shared memory, band mode) for
// radius 1 lap group 4.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_LAUNCH(grad_bf16_r1_g4) {
  return launch_t<kGrad, 1, 4, kBf32>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_bwd
