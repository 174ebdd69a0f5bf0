// The ADMM elementwise chain, shared by the fused step (fused_admm.cu) and the
// whole solves (vmem_solver.cu, vmem_adaptive.cu, vmem_interleaved.cu).
//
// Per pixel of a plane, given the fresh primal x and the duals u:
//   a  = D x + u                       (backward differences, circular)
//   z  = shrink(a, tau)                (aniso clip form | 'sample' | 'joint')
//   u' = a - z
//   s' = hty + rho * (Dx^T(z_x - u'_x) + Dy^T(z_y - u'_y))
// The same chain as torch_admm_deconv_tpu/kernels/fused_admm.py::_make_kernel.
//
// The adjoint differences make s' at (i, j) need t = z - u' at (i, j+1) and
// (i+1, j), and each of those needs x at its own left and upper neighbours
// (and, for 'sample', the channel norm at that neighbour). In chain_eval (K2,
// K3) one thread per pixel recomputes the two neighbours' shrinkage from
// L1/L2 loads; K1 stages a tile with its halo in shared memory instead and
// computes each pixel's shrinkage once.
//
// The per-pixel helpers take plain pointers, not __restrict__ ones: the
// persistent whole-solve kernels inline them and write the same buffers in
// other stages of one launch, so their loads must not take the
// non-coherent read-only path.
#pragma once

#include <cuda_runtime.h>

namespace admm {

constexpr float kEps = 1e-15f;

enum Mode : int { kAniso = 0, kSample = 1, kJoint = 2 };

// d = D x and a = d + u at (i, j) of one plane
__device__ __forceinline__ void grad_plus_dual(const float* x, const float* ux,
                                               const float* uy,
                                               int i, int j, int h, int w,
                                               float& dx, float& dy,
                                               float& ax, float& ay) {
  const int jl = j == 0 ? w - 1 : j - 1;
  const int iu = i == 0 ? h - 1 : i - 1;
  const long at = (long)i * w + j;
  const float xc = x[at];
  dx = xc - x[(long)i * w + jl];
  dy = xc - x[(long)iu * w + j];
  ax = dx + ux[at];
  ay = dy + uy[at];
}

// z = shrink(D x + u, tau) at (i, j) of plane `plane`, with d = D x and
// a = D x + u; `group` is the first plane of the g planes whose norm
// couples in 'sample' mode.
template <int MODE>
__device__ __forceinline__ void shrink_at(const float* x, const float* ux, const float* uy,
                                          long plane, long group, int g, int i,
                                          int j, int h, int w, float tau,
                                          float& dx, float& dy, float& ax,
                                          float& ay, float& zx, float& zy) {
  grad_plus_dual(x + plane, ux + plane, uy + plane, i, j, h, w, dx, dy, ax, ay);
  if (MODE == kAniso) {
    // clip form of soft shrinkage: a - clip(a, -tau, tau), tau >= 0
    zx = ax - fminf(fmaxf(ax, -tau), tau);
    zy = ay - fminf(fmaxf(ay, -tau), tau);
  } else if (MODE == kJoint) {
    const float mag = sqrtf(ax * ax + ay * ay + kEps);
    const float scale = fmaxf(1.0f - tau / mag, 0.0f);
    zx = scale * ax;
    zy = scale * ay;
  } else {
    const long hw = (long)h * w;
    float sx = 0.0f, sy = 0.0f;
    for (int k = 0; k < g; ++k) {
      const long pk = group + k * hw;
      float ex, ey, bx, by;
      grad_plus_dual(x + pk, ux + pk, uy + pk, i, j, h, w, ex, ey, bx, by);
      sx += bx * bx;
      sy += by * by;
    }
    const float nx = sqrtf(sx + kEps);
    const float ny = sqrtf(sy + kEps);
    zx = fmaxf(1.0f - tau / (nx + kEps), 0.0f) * ax;
    zy = fmaxf(1.0f - tau / (ny + kEps), 0.0f) * ay;
  }
}

// t = z - u' and u' = a - z at (i, j) of plane `plane`.
template <int MODE>
__device__ __forceinline__ void chain_at(const float* x, const float* ux, const float* uy,
                                         long plane, long group, int g, int i,
                                         int j, int h, int w, float tau,
                                         float& tx, float& ty, float& uxn,
                                         float& uyn) {
  float dx, dy, ax, ay, zx, zy;
  shrink_at<MODE>(x, ux, uy, plane, group, g, i, j, h, w, tau, dx, dy, ax, ay, zx, zy);
  uxn = ax - zx;
  uyn = ay - zy;
  tx = zx - uxn;
  ty = zy - uyn;
}

// The chain at pixel `idx` of plane p: s, u'_x, u'_y from x and u, not
// stored, so that a caller can issue the loads of several pixels before
// their stores.
template <int MODE>
__device__ __forceinline__ void chain_eval(const float* x, const float* ux, const float* uy,
                                           const float* hty, float rho, float tau, int p, int g,
                                           int h, int w, long idx, float& s, float& uxn,
                                           float& uyn) {
  const long hw = (long)h * w;
  const int i = (int)(idx / w);
  const int j = (int)(idx % w);
  const int jr = j == w - 1 ? 0 : j + 1;
  const int id = i == h - 1 ? 0 : i + 1;
  const long plane = (long)p * hw;
  const long group = (long)(p / g) * g * hw;
  float tx, ty, txr, tyd, unused0, unused1, unused2;
  chain_at<MODE>(x, ux, uy, plane, group, g, i, j, h, w, tau, tx, ty, uxn, uyn);
  chain_at<MODE>(x, ux, uy, plane, group, g, i, jr, h, w, tau, txr, unused0, unused1, unused2);
  chain_at<MODE>(x, ux, uy, plane, group, g, id, j, h, w, tau, unused0, tyd, unused1, unused2);
  s = hty[plane + idx] + rho * (tx - txr + ty - tyd);
}

// z = shrink(a, tau) of one pixel in the per-plane modes (aniso clip form,
// 'joint'); the same arithmetic as shrink_at. The tiled chains (K1 in
// fused_admm.cu, K4 in vmem_interleaved.cu) take their operands from shared
// memory and call this.
template <int MODE>
__device__ __forceinline__ void shrink_pixel(float ax, float ay, float tau, float& zx,
                                             float& zy) {
  if (MODE == kAniso) {
    zx = ax - fminf(fmaxf(ax, -tau), tau);
    zy = ay - fminf(fmaxf(ay, -tau), tau);
  } else {
    const float mag = sqrtf(ax * ax + ay * ay + kEps);
    const float scale = fmaxf(1.0f - tau / mag, 0.0f);
    zx = scale * ax;
    zy = scale * ay;
  }
}

// 'sample': the factor max(1 - tau / (|a|_C + eps), 0) of a channel norm
// from its sum of squares over the C channels.
__device__ __forceinline__ float sample_scale(float sum_sq, float tau) {
  return fmaxf(1.0f - tau / (sqrtf(sum_sq + kEps) + kEps), 0.0f);
}

}  // namespace admm
