// bfloat16 instantiations of the fused stencil conv kernel (K1,
// stencil_conv.cu; bfloat16 values in float32 shared memory, I/O mode) for
// radius 1 lap group 4.

#include "stencil_conv.cuh"

namespace ds_k1 {

DS_K1_LAUNCH(launch_bf16_io_r1_g4) {
  return launch_t<1, 4, kBf32Io>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_k1
