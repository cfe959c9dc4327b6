// bfloat16 instantiations of the fused stencil conv kernel (K1,
// stencil_conv.cu; bfloat16 values in float32 shared memory, I/O mode) for
// radius 3 lap group 1 and radius 4 lap group 1.

#include "stencil_conv.cuh"

namespace ds_k1 {

DS_K1_LAUNCH(launch_bf16_io_r3_g1) {
  return launch_t<3, 1, kBf32Io>(T, FC, a, grid, smem, stream);
}
DS_K1_LAUNCH(launch_bf16_io_r4_g1) {
  return launch_t<4, 1, kBf32Io>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_k1
