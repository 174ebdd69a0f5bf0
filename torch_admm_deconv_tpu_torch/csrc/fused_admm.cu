// K1: one fused pass of the ADMM elementwise chain.
//
// Replaces the TPU kernel torch_admm_deconv_tpu/kernels/fused_admm.py
// (_make_kernel, reached through fused_elementwise_step).
//
// Bound on the H100: memory bytes. Per call it reads x, u_x, u_y, hty and
// writes s, u'_x, u'_y: 7 planes of 4-byte floats against ~30 flops a pixel,
// far below the card's ~20 flop/byte ridge in f32.
//
// Design: a CTA takes a tile of TH x TW pixels over the g planes of a block
// (g = C in 'sample' mode, else 1). All its global loads are issued at once
// as cp.async copies into shared memory (16 bytes where W % 4 == 0, 4 for
// the halo columns, the ragged edge and the circular wrap): x for the tile
// and a one-pixel halo on each side, u at the tile's pixels plus its right
// column and lower row, and hty of the tile, so the CTA waits on memory
// once. It then computes a = D x + u, z, u' and t = z - u' once per pixel
// of the tile plus that column and row (one thread computes the channel
// norm of a pixel once for all g channels), keeps t in shared memory, and
// forms s' = hty + rho (Dx^T t_x + Dy^T t_y) from it with 16-byte stores.
// Each x and u value is loaded once per tile (the halo re-reads hit L2);
// a kernel of one thread per pixel would load x and u about 46 times per
// output in 'sample' mode to recompute its neighbours' shrinkage. Any f32
// NCHW shape is accepted; TH shrinks where the g planes of a tile would
// not fit the shared memory.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cstdint>

#include "admm_chain.cuh"
#include "tiled_gemm.cuh"

namespace {

constexpr int TW = 32;          // tile columns
constexpr int TH_DEFAULT = 4;   // tile rows: of 1, 2, 4 and 8 the fastest on the H100 at (1, 3, 256, 256)
constexpr int THREADS = 128;
constexpr int XW = TW + 8;      // staged x row: column j0 - 1 at 3, j0 at 4 (16-byte aligned)
constexpr int TS = TW + 4;      // staged t row: TW + 1 columns used
constexpr size_t SMEM_LIMIT = 232448;

struct Args {
  const float *x, *ux, *uy, *hty;
  const float *rho_p, *tau_p;  // device scalars, or null: rho_v, tau_v
  float rho_v, tau_v;
  float *s, *uxo, *uyo;
  int n_blocks, g, h, w, th, vec;
};

// per plane: x [th + 2][XW], t and u [2][th + 1][TS] each, hty [th][TW]
size_t smem_floats(int g, int th) {
  return (size_t)g * ((th + 2) * XW + 4 * (th + 1) * TS + th * TW);
}

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

template <int MODE>
__global__ void __launch_bounds__(THREADS) k1_tile(const __grid_constant__ Args p) {
  extern __shared__ float4 smem_raw[];
  const int g = p.g, h = p.h, w = p.w, th = p.th;
  const int xplane = (th + 2) * XW, tplane = (th + 1) * TS;
  float* xs = reinterpret_cast<float*>(smem_raw);  // [g][th + 2][XW]
  float* ts = xs + g * xplane;                      // [g][2][th + 1][TS]
  float* us = ts + g * 2 * tplane;                  // [g][2][th + 1][TS]
  float* hs = us + g * 2 * tplane;                  // [g][th][TW]
  const long hw = (long)h * w;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * th;
  const int cols = min(TW, w - j0), rows = min(th, h - i0);
  const float rho = p.rho_p != nullptr ? *p.rho_p : p.rho_v;
  // tau >= 0: the clip form of soft shrinkage needs it
  const float tau = fmaxf(p.tau_p != nullptr ? *p.tau_p : p.tau_v, 0.0f);
  const int pc = cols + 1;              // t and u columns: the tile's and the one to its right
  const int q4 = p.vec ? cols >> 2 : 0;  // 16-byte chunks of a row (cols % 4 == 0 if vec)

  for (long blk = blockIdx.z; blk < p.n_blocks; blk += gridDim.z) {
    const long base = blk * g * hw;
    for (int k = 0; k < g; ++k) {
      const long pk = base + k * hw;
      float* xk = xs + k * xplane;
      float* uk = us + k * 2 * tplane;
      float* hk = hs + k * th * TW;
      // x at rows i0 - 1 .. i0 + rows, columns j0 - 1 .. j0 + cols, circular:
      // the interior in chunks, columns 0 and cols + 1 (all where !vec) alone
      for (int l = threadIdx.x; l < (rows + 2) * q4; l += THREADS) {
        const int r = l / q4, c = (l % q4) * 4;
        tiled::cp_async16(xk + r * XW + 4 + c, p.x + pk + (long)wrap(i0 - 1 + r, h) * w + j0 + c, true);
      }
      const int xn = q4 > 0 ? 2 : cols + 2;
      for (int l = threadIdx.x; l < (rows + 2) * xn; l += THREADS) {
        const int r = l / xn, c = q4 > 0 ? ((l % xn) ? cols + 1 : 0) : l % xn;
        tiled::cp_async4(xk + r * XW + 3 + c,
                         p.x + pk + (long)wrap(i0 - 1 + r, h) * w + wrap(j0 - 1 + c, w), true);
      }
      // u at rows i0 .. i0 + rows, columns j0 .. j0 + cols, circular
      for (int l = threadIdx.x; l < (rows + 1) * q4; l += THREADS) {
        const int r = l / q4, c = (l % q4) * 4;
        const long at = pk + (long)wrap(i0 + r, h) * w + j0 + c;
        tiled::cp_async16(uk + r * TS + c, p.ux + at, true);
        tiled::cp_async16(uk + tplane + r * TS + c, p.uy + at, true);
      }
      const int un = q4 > 0 ? 1 : pc;
      for (int l = threadIdx.x; l < (rows + 1) * un; l += THREADS) {
        const int r = l / un, c = q4 > 0 ? cols : l % un;
        const long at = pk + (long)wrap(i0 + r, h) * w + wrap(j0 + c, w);
        tiled::cp_async4(uk + r * TS + c, p.ux + at, true);
        tiled::cp_async4(uk + tplane + r * TS + c, p.uy + at, true);
      }
      // hty of the tile
      const int hn = q4 > 0 ? q4 : cols;
      for (int l = threadIdx.x; l < rows * hn; l += THREADS) {
        const int r = l / hn, c = (l % hn) * (q4 > 0 ? 4 : 1);
        const float* src = p.hty + pk + (long)(i0 + r) * w + j0 + c;
        if (q4 > 0)
          tiled::cp_async16(hk + r * TW + c, src, true);
        else
          tiled::cp_async4(hk + r * TW + c, src, true);
      }
    }
    tiled::cp_async_commit();
    tiled::cp_async_wait<0>();
    __syncthreads();

    // t = z - u' at the (rows + 1) x (cols + 1) pixels; u' of the tile out
    for (int q = threadIdx.x; q < (rows + 1) * pc; q += THREADS) {
      const int r = q / pc, c = q % pc;
      const bool inside = r < rows && c < cols;
      const int xc = (r + 1) * XW + 4 + c;  // x at this pixel
      const int uc = r * TS + c;            // u and t at this pixel
      float fx = 1.0f, fy = 1.0f;
      if (MODE == admm::kSample) {
        float sx = 0.0f, sy = 0.0f;
        for (int k = 0; k < g; ++k) {
          const float* xk = xs + k * xplane;
          const float* uk = us + k * 2 * tplane;
          const float bx = (xk[xc] - xk[xc - 1]) + uk[uc];
          const float by = (xk[xc] - xk[xc - XW]) + uk[tplane + uc];
          sx += bx * bx;
          sy += by * by;
        }
        fx = admm::sample_scale(sx, tau);
        fy = admm::sample_scale(sy, tau);
      }
      for (int k = 0; k < g; ++k) {
        const float* xk = xs + k * xplane;
        const float* uk = us + k * 2 * tplane;
        const float ax = (xk[xc] - xk[xc - 1]) + uk[uc];
        const float ay = (xk[xc] - xk[xc - XW]) + uk[tplane + uc];
        float zx, zy;
        if (MODE == admm::kSample) {
          zx = fx * ax;
          zy = fy * ay;
        } else {
          admm::shrink_pixel<MODE>(ax, ay, tau, zx, zy);
        }
        const float uxn = ax - zx, uyn = ay - zy;
        float* tk = ts + k * 2 * tplane;
        tk[uc] = zx - uxn;
        tk[tplane + uc] = zy - uyn;
        if (inside) {
          const long at = base + k * hw + (long)(i0 + r) * w + j0 + c;
          p.uxo[at] = uxn;
          p.uyo[at] = uyn;
        }
      }
    }
    __syncthreads();

    // s' = hty + rho (t_x - t_x[j + 1] + t_y - t_y[i + 1])
    const int sn = q4 > 0 ? q4 : cols;
    for (int l = threadIdx.x; l < g * rows * sn; l += THREADS) {
      const int k = l / (rows * sn), rem = l % (rows * sn);
      const int r = rem / sn, c = (rem % sn) * (q4 > 0 ? 4 : 1);
      const float* tx = ts + k * 2 * tplane + r * TS + c;
      const float* ty = tx + tplane;
      const float* hv = hs + k * th * TW + r * TW + c;
      const long at = base + k * hw + (long)(i0 + r) * w + j0 + c;
      if (q4 > 0) {
        float4 sv;
        sv.x = hv[0] + rho * (tx[0] - tx[1] + ty[0] - ty[TS]);
        sv.y = hv[1] + rho * (tx[1] - tx[2] + ty[1] - ty[TS + 1]);
        sv.z = hv[2] + rho * (tx[2] - tx[3] + ty[2] - ty[TS + 2]);
        sv.w = hv[3] + rho * (tx[3] - tx[4] + ty[3] - ty[TS + 3]);
        *reinterpret_cast<float4*>(p.s + at) = sv;
      } else {
        p.s[at] = hv[0] + rho * (tx[0] - tx[1] + ty[0] - ty[TS]);
      }
    }
    __syncthreads();  // the staged planes are free for the next block
  }
}

template <int MODE>
cudaError_t launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k1_tile<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  k1_tile<MODE><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// One pass of the chain over n_planes (h, w) planes in blocks of g (g > 1
// only in 'sample' mode). rho and tau are read from the device scalars
// rho_p and tau_p when given (no host sync), else rho_v and tau_v are used;
// tau is clamped to >= 0. A tile has TH_DEFAULT rows, fewer where the g
// planes of a tile would not fit 48 KB. Inputs and outputs must not alias.
extern "C" int fused_admm_step(const float* x, const float* ux, const float* uy,
                               const float* hty, const float* rho_p, const float* tau_p,
                               float rho_v, float tau_v, float* s, float* uxo, float* uyo,
                               int n_planes, int g, int h, int w, int mode, void* stream) {
  if (g <= 0 || n_planes % g != 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (mode != admm::kSample && g != 1) return (int)cudaErrorInvalidValue;
  int th = TH_DEFAULT;
  while (th > 1 && smem_floats(g, th) * sizeof(float) > 48 * 1024) th >>= 1;
  const size_t smem = smem_floats(g, th) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;  // > ~120 channels in 'sample'
  const int vec = (w & 3) == 0 && aligned16(x) && aligned16(ux) && aligned16(uy) &&
                  aligned16(hty) && aligned16(s);
  const Args a{x, ux, uy, hty, rho_p, tau_p, rho_v, tau_v, s, uxo, uyo,
               n_planes / g, g, h, w, th, vec};
  const int n_blocks = n_planes / g;
  const dim3 grid((unsigned)((w + TW - 1) / TW), (unsigned)((h + th - 1) / th),
                  (unsigned)(n_blocks < 65535 ? n_blocks : 65535));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case admm::kAniso:
      return (int)launch<admm::kAniso>(a, grid, smem, st);
    case admm::kSample:
      return (int)launch<admm::kSample>(a, grid, smem, st);
    case admm::kJoint:
      return (int)launch<admm::kJoint>(a, grid, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
