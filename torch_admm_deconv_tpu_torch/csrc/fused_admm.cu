// K1: one fused pass of the ADMM elementwise chain.
//
// Replaces the TPU kernel torch_admm_deconv_tpu/kernels/fused_admm.py
// (_make_kernel, reached through fused_elementwise_step).
//
// Bound on the H100: memory bytes. Per call it reads x, u_x, u_y, hty and
// writes s, u'_x, u'_y: 7 planes of 4-byte floats against ~30 flops a pixel,
// far below the card's ~20 flop/byte ridge in f32. The design keeps the DRAM
// traffic at those 7 planes: one thread per pixel, neighbouring threads on
// neighbouring addresses, and the two neighbours that the adjoint
// differences need are recomputed from loads that hit L1/L2 rather than
// written out and read back (see admm_chain.cuh). Any f32 NCHW shape is
// accepted; the TPU tile gates (h % 8, w % 128, the VMEM budget) do not apply.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "admm_chain.cuh"

extern "C" int fused_admm_step(const float* x, const float* ux, const float* uy,
                               const float* hty, const float* rho_tau, float* s,
                               float* uxo, float* uyo, int n_planes, int g, int h,
                               int w, int mode, void* stream) {
  return (int)admm::launch_chain(mode, x, ux, uy, hty, rho_tau, s, uxo, uyo, n_planes,
                                 g, h, w, (cudaStream_t)stream);
}
