// K1's 2-byte bfloat16 body (stencil_conv_s2_kernel of stencil_conv.cuh,
// either mode), where only 2-byte shared elements fit, for
// radius 1 lap group 2.

#include "stencil_conv.cuh"

namespace ds_k1 {

DS_K1_S2_LAUNCH(launch_bf16_s2_r1_g2) {
  return launch_s2_t<1, 2>(T, FC, a, ns, land, grid, smem, stream);
}

}  // namespace ds_k1
