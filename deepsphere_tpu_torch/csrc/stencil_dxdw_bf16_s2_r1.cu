// bfloat16 instantiations of the fused backward dx + dW kernel (K2,
// stencil_dxdw.cu; 2-byte shared elements, where only those fit) for
// radius 1 lap group 1 and radius 1 lap group 2.

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_LAUNCH(dxdw_bf16_s2_r1_g1) {
  return launch_t<kDxDw, 1, 1, kBf16>(T, FC, a, grid, smem, stream);
}
DS_BWD_LAUNCH(dxdw_bf16_s2_r1_g2) {
  return launch_t<kDxDw, 1, 2, kBf16>(T, FC, a, grid, smem, stream);
}

}  // namespace ds_bwd
