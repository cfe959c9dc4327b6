// bfloat16 instantiations of the fused stencil conv kernel (K1,
// stencil_conv.cu) in 2-byte shared elements, where only those fit, for
// radius 2 lap group 1 and radius 2 lap group 2.

#include "stencil_conv.cuh"

namespace ds_k1 {

DS_K1_LAUNCH(launch_bf16_s2_r2_g1) {
  return launch_t<2, 1, kBf16>(T, FC, a, grid, smem, stream);
}
DS_K1_LAUNCH(launch_bf16_s2_r2_g2) {
  return launch_t<2, 2, kBf16>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_k1
