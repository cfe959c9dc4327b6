// bfloat16 instantiations of the fused stencil conv kernel (K1,
// stencil_conv.cu) in 2-byte shared elements, where only those fit, for
// radius 1 lap group 4.

#include "stencil_conv.cuh"

namespace ds_k1 {

DS_K1_LAUNCH(launch_bf16_s2_r1_g4) {
  return launch_t<1, 4, kBf16>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_k1
