// bfloat16 instantiations of the fused backward dx + dW kernel (K2,
// stencil_dxdw.cu; bfloat16 values in float32 shared memory, band mode) for
// radius 2 lap group 1 and radius 2 lap group 2.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_LAUNCH(dxdw_bf16_r2_g1) {
  return launch_t<kDxDw, 2, 1, kBf32>(T, FC, a, grid, smem, stream);
}
DS_BWD_LAUNCH(dxdw_bf16_r2_g2) {
  return launch_t<kDxDw, 2, 2, kBf32>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_bwd
