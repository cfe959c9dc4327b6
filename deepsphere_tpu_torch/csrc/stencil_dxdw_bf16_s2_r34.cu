// bfloat16 instantiations of the fused backward dx + dW kernel (K2,
// stencil_dxdw.cu; 2-byte shared elements, where only those fit) for
// radius 3 lap group 1 and radius 4 lap group 1.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_LAUNCH(dxdw_bf16_s2_r3_g1) {
  return launch_t<kDxDw, 3, 1, kBf16>(T, FC, a, grid, smem, stream);
}
DS_BWD_LAUNCH(dxdw_bf16_s2_r4_g1) {
  return launch_t<kDxDw, 4, 1, kBf16>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_bwd
