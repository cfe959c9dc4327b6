// The 2-byte bfloat16 kernel of the fused backward dx + dW kernel (K2,
// stencil_dxdw.cu; stencil_bwd_s2_kernel of stencil_bwd.cuh,
// either mode), where only 2-byte shared elements fit, for
// radius 4 lap group 1 (1, 2 or 4 window sets a lap).

#include "stencil_bwd.cuh"

namespace ds_bwd {

DS_BWD_S2_LAUNCH(dxdw_bf16_s2_r4_g1) {
  return launch_s2_t<kDxDw, 4, 1>(T, FC, a, ns, land, mb, grid, smem,
                                  stream);
}

}  // namespace ds_bwd
