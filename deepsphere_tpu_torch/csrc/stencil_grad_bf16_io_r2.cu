// bfloat16 instantiations of the dW kernel of the two-kernel backward (K3,
// stencil_grad.cu; bfloat16 values in float32 shared memory, I/O mode) for
// radius 2 lap group 1 and radius 2 lap group 2.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_LAUNCH(grad_bf16_io_r2_g1) {
  return launch_t<kGrad, 2, 1, kBf32Io>(T, FC, a, grid, smem, stream);
}
DS_BWD_LAUNCH(grad_bf16_io_r2_g2) {
  return launch_t<kGrad, 2, 2, kBf32Io>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_bwd
