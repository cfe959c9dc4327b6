// bfloat16 instantiations of the dW kernel of the two-kernel backward (K3,
// stencil_grad.cu; 2-byte shared elements, where only those fit) for
// radius 3 lap group 1 and radius 4 lap group 1.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_LAUNCH(grad_bf16_s2_r3_g1) {
  return launch_t<kGrad, 3, 1, kBf16>(T, FC, a, grid, smem, stream);
}
DS_BWD_LAUNCH(grad_bf16_s2_r4_g1) {
  return launch_t<kGrad, 4, 1, kBf16>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_bwd
