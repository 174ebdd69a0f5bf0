// K2: the whole fixed-iteration TV-ADMM solve.
//
// Replaces the TPU kernel torch_admm_deconv_tpu/kernels/vmem_solver.py
// (_make_kernel, reached through admm_tv_vmem -> _admm_tv_vmem_impl with
// schedule='batched').
//
//   s <- hty, u <- 0
//   repeat maxit:  x = T((T s) * freq)      freq carries 1/(H*W)
//                  s, u <- chain(x, u)      (admm_chain.cuh, the K1 chain)
//   return x                                (zeros when maxit == 0)
//
// T is the separable cas transform T_h v T_w (2 products) when the PSF is
// absent or axis-symmetric, else the 2-D Hartley pair
// (T_h v) C_w + (T_h' v) S_w (4 products). Stage order follows the TPU
// kernel's `apply`: right (W-side) stage over all planes, then the per-plane
// left (H-side) stage on the cas path; both left stages, then the summed
// right stage on the Hartley path. The spectrum multiply is fused into the
// epilogue of the first transform's last stage.
//
// Bound on the H100: operations. At (1, 3, 256, 256) and 100 iterations the
// cas path does 4 products of 2*256^3 flops per plane per iteration, about
// 40 GFLOP a solve, on ~5 MB of state. A TPU block keeps its state in VMEM;
// a 256^2 f32 plane (256 KB) exceeds a block's 227 KB of shared memory, so
// here the state (s, u, y, t, hty, ~5 MB at the flagship shape) and the
// matrices (0.5 MB) stay in the 50 MB L2 between launches instead. The loop
// runs on the host and launches, per iteration, 4 (or 6) tiled f32 SIMT
// matrix-product kernels and one chain kernel on the caller's stream; the
// product tiles shrink when the grid would leave SMs idle.
// 'high' is plain f32, at least as accurate as the TPU's bf16x3 split.
// 'mixed' runs its first fast_iters iterations with every stage operand and
// matrix rounded to bf16 (round to nearest even) and f32 accumulation, as
// the TPU kernel's single-pass bf16 phase does.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>

#include "admm_chain.cuh"

namespace {

// Block tiles: 64x64 with a 4x4 micro-tile per thread where the grid has
// blocks enough to fill the card, 32x32 with 2x2 where it would not (a
// (1, 3, 256, 256) solve gives only 48 blocks of 64x64 for 132 SMs).
constexpr int BK = 16;  // depth per shared-memory stage
constexpr int THREADS = 256;

template <bool FAST>
__device__ __forceinline__ float operand(float v) {
  if (FAST) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// C[b] = A1[b] @ B1[b] (+ A2[b] @ B2[b]), each row-major, M x K times K x N,
// with per-batch element strides; the optional epilogue multiplies by
// freq[(row % freq_rows) * N + col].
template <bool FAST, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const float* __restrict__ A1, const float* __restrict__ B1,
            const float* __restrict__ A2, const float* __restrict__ B2,
            float* __restrict__ C, int M, int N, int K, long sA, long sB, long sC,
            const float* __restrict__ freq, int freq_rows) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one micro-tile per thread");
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);
  const int tc = tid % (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;

  const int passes = A2 != nullptr ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const float* A = (pass == 0 ? A1 : A2) + b * sA;
    const float* B = (pass == 0 ? B1 : B2) + b * sB;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int l = tid; l < BM * BK; l += THREADS) {
        const int r = l / BK, k = l % BK;
        const int gr = row0 + r, gk = k0 + k;
        As[k][r] = (gr < M && gk < K) ? operand<FAST>(A[(long)gr * K + gk]) : 0.0f;
      }
      for (int l = tid; l < BK * BN; l += THREADS) {
        const int k = l / BN, c = l % BN;
        const int gk = k0 + k, gc = col0 + c;
        Bs[k][c] = (gk < K && gc < N) ? operand<FAST>(B[(long)gk * N + gc]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], bv[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) a[m] = As[k][tr * TM + m];
#pragma unroll
        for (int n = 0; n < TN; ++n) bv[n] = Bs[k][tc * TN + n];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
      }
      __syncthreads();
    }
  }

  float* Cb = C + b * sC;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int gr = row0 + tr * TM + m;
    if (gr >= M) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int gc = col0 + tc * TN + n;
      if (gc >= N) continue;
      float v = acc[m][n];
      if (freq != nullptr) v *= freq[(long)(gr % freq_rows) * N + gc];
      Cb[(long)gr * N + gc] = v;
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

template <bool FAST, int BM, int BN, int TM, int TN>
cudaError_t gemm_tiled(const float* A1, const float* B1, const float* A2, const float* B2,
                       float* C, int M, int N, int K, long sA, long sB, long sC, int batch,
                       const float* freq, int freq_rows, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                  (unsigned)batch);
  gemm_kernel<FAST, BM, BN, TM, TN><<<grid, THREADS, 0, stream>>>(
      A1, B1, A2, B2, C, M, N, K, sA, sB, sC, freq, freq_rows);
  return cudaGetLastError();
}

template <bool FAST>
cudaError_t gemm(const float* A1, const float* B1, const float* A2, const float* B2,
                 float* C, int M, int N, int K, long sA, long sB, long sC, int batch,
                 const float* freq, int freq_rows, cudaStream_t stream) {
  const long big_blocks = (long)((N + 63) / 64) * ((M + 63) / 64) * batch;
  if (big_blocks >= 2L * sm_count())
    return gemm_tiled<FAST, 64, 64, 4, 4>(A1, B1, A2, B2, C, M, N, K, sA, sB, sC, batch,
                                          freq, freq_rows, stream);
  return gemm_tiled<FAST, 32, 32, 2, 2>(A1, B1, A2, B2, C, M, N, K, sA, sB, sC, batch,
                                        freq, freq_rows, stream);
}

struct Problem {
  const float* mats[4];  // cas: th, tw; Hartley pair: th, thp, cw, sw
  int n_mats;
  int planes, h, w;
  float* d;  // Hartley pair: left-stage product of th
  float* a;  // right-stage product (cas) or left-stage product of thp
  cudaStream_t stream;
};

// dst = T(src) (* mult): one full transform over all planes.
template <bool FAST>
cudaError_t apply(const Problem& p, const float* src, float* dst, const float* mult) {
  const long hw = (long)p.h * p.w;
  cudaError_t err;
  if (p.n_mats == 2) {
    // right stage over the (planes*h, w) block, then the per-plane left stage
    err = gemm<FAST>(src, p.mats[1], nullptr, nullptr, p.a, p.planes * p.h, p.w, p.w, 0,
                     0, 0, 1, nullptr, p.h, p.stream);
    if (err != cudaSuccess) return err;
    return gemm<FAST>(p.mats[0], p.a, nullptr, nullptr, dst, p.h, p.w, p.h, 0, hw, hw,
                      p.planes, mult, p.h, p.stream);
  }
  // both per-plane left stages, then one summed right stage
  err = gemm<FAST>(p.mats[0], src, nullptr, nullptr, p.d, p.h, p.w, p.h, 0, hw, hw,
                   p.planes, nullptr, p.h, p.stream);
  if (err != cudaSuccess) return err;
  err = gemm<FAST>(p.mats[1], src, nullptr, nullptr, p.a, p.h, p.w, p.h, 0, hw, hw,
                   p.planes, nullptr, p.h, p.stream);
  if (err != cudaSuccess) return err;
  return gemm<FAST>(p.d, p.mats[2], p.a, p.mats[3], dst, p.planes * p.h, p.w, p.w, 0, 0,
                    0, 1, mult, p.h, p.stream);
}

template <bool FAST>
cudaError_t x_update(const Problem& p, const float* s, const float* freq, float* y,
                     float* x) {
  cudaError_t err = apply<FAST>(p, s, y, freq);
  if (err != cudaSuccess) return err;
  return apply<FAST>(p, y, x, nullptr);
}

}  // namespace

// hty, out and the scratch planes s, ux0, ux1, uy0, uy1, y, a are
// (n_planes, h, w) f32; d only on the Hartley-pair path (n_mats == 4),
// else null. freq is (h, w) and carries 1/(h*w). rho_tau = {rho, tau}.
extern "C" int admm_tv_vmem_solve(const float* hty, const float* freq, const float* m0,
                                  const float* m1, const float* m2, const float* m3,
                                  int n_mats, const float* rho_tau, float* out, float* s,
                                  float* ux0, float* ux1, float* uy0, float* uy1,
                                  float* y, float* a, float* d, int n_planes, int g,
                                  int h, int w, int mode, int maxit, int fast_iters,
                                  void* stream_handle) {
  cudaStream_t stream = (cudaStream_t)stream_handle;
  const size_t bytes = (size_t)n_planes * h * w * sizeof(float);
  if (n_mats != 2 && n_mats != 4) return (int)cudaErrorInvalidValue;
  if (maxit <= 0) {
    cudaMemsetAsync(out, 0, bytes, stream);
    return (int)cudaGetLastError();
  }
  Problem p{{m0, m1, m2, m3}, n_mats, n_planes, h, w, d, a, stream};
  cudaMemsetAsync(ux0, 0, bytes, stream);
  cudaMemsetAsync(uy0, 0, bytes, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float* s_in = hty;  // x, z, u start at zero: the first RHS is hty
  float* ux[2] = {ux0, ux1};
  float* uy[2] = {uy0, uy1};
  for (int it = 0; it < maxit; ++it) {
    err = it < fast_iters ? x_update<true>(p, s_in, freq, y, out)
                          : x_update<false>(p, s_in, freq, y, out);
    if (err != cudaSuccess) return (int)err;
    const int cur = it & 1;
    err = admm::launch_chain(mode, out, ux[cur], uy[cur], hty, rho_tau, s, ux[cur ^ 1],
                             uy[cur ^ 1], n_planes, g, h, w, stream);
    if (err != cudaSuccess) return (int)err;
    s_in = s;
  }
  return (int)cudaGetLastError();
}
