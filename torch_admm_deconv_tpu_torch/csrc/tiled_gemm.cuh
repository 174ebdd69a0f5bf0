// Tiled f32 SIMT matrix products and the cas / Hartley-pair transforms built
// from them, shared by the whole-solve kernels (vmem_solver.cu: K2 and K4;
// vmem_adaptive.cu: K3).
//
// C[b] = A1[b] @ B1[b] (+ A2[b] @ B2[b]), each row-major, M x K times K x N,
// with per-batch element strides (a stride of 0 shares one matrix across the
// batch). The epilogue may multiply by a diagonal spectrum at
// (row % spec_rows, col).
//
// ROUND = kExact keeps f32 operands and kFast rounds every operand to bf16
// (round to nearest even) before the f32 product, as the TPU kernels'
// single-pass bf16 phase does; the spectrum is `spec` itself (K2, K4).
// ROUND = kPerBlock is K3's: a batch entry is one plane of block b / g, and
// the block's BlockState decides. The tiles of a plane whose block is not
// running exit before touching memory, the operands are rounded when the
// block is in its fast phase (a tile never straddles two planes, so it
// never mixes roundings), and the spectrum is the block's own
// 1 / (spec + rho_b * d2), spec being |H|^2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tiled {

constexpr int BK = 16;  // depth per shared-memory stage
constexpr int THREADS = 256;

enum Round : int { kExact = 0, kFast = 1, kPerBlock = 2 };

// Per-block state of the residual-stopped solve (K3), kept on the device.
struct BlockState {
  int run;       // 1 while the block iterates
  int fast;      // 1 in the single-pass bf16 phase
  int k;         // iterations run
  int pad;
  float r, s;    // scaled primal and dual residuals of the last iteration
  float rho;     // penalty for the next iteration
  float factor;  // rho_new / rho of the last iteration (dual rescale 1/factor)
};

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int ROUND, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const float* __restrict__ A1, const float* __restrict__ B1,
            const float* __restrict__ A2, const float* __restrict__ B2,
            float* __restrict__ C, int M, int N, int K, long sA, long sB, long sC,
            const float* __restrict__ spec, int spec_rows, const float* __restrict__ d2,
            const BlockState* __restrict__ st, int g) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one micro-tile per thread");
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const long b = blockIdx.z;
  bool fast = ROUND == kFast;
  float rho = 0.0f;
  if (ROUND == kPerBlock) {
    const BlockState& blk = st[b / g];
    if (!blk.run) return;  // uniform over the tile: before any barrier
    fast = blk.fast != 0;
    rho = blk.rho;
  }
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
        const float v = (gr < M && gk < K) ? A[(long)gr * K + gk] : 0.0f;
        As[k][r] = fast ? to_bf16(v) : v;
      }
      for (int l = tid; l < BK * BN; l += THREADS) {
        const int k = l / BN, c = l % BN;
        const int gk = k0 + k, gc = col0 + c;
        const float v = (gk < K && gc < N) ? B[(long)gk * N + gc] : 0.0f;
        Bs[k][c] = fast ? to_bf16(v) : v;
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
      if (spec != nullptr) {
        const long at = (long)(gr % spec_rows) * N + gc;
        if (ROUND == kPerBlock)
          v *= 1.0f / (spec[at] + rho * d2[at]);
        else
          v *= spec[at];
      }
      Cb[(long)gr * N + gc] = v;
    }
  }
}

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// The spectrum and, for kPerBlock, the blocks: spec == nullptr multiplies
// by nothing; st and g are read only by kPerBlock.
struct Spectrum {
  const float* spec;
  int rows;
  const float* d2;
  const BlockState* st;
  int g;
};

constexpr Spectrum kNoSpectrum{nullptr, 1, nullptr, nullptr, 1};

template <int ROUND, int BM, int BN, int TM, int TN>
cudaError_t gemm_tiled(const float* A1, const float* B1, const float* A2, const float* B2,
                       float* C, int M, int N, int K, long sA, long sB, long sC, int batch,
                       const Spectrum& sp, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                  (unsigned)batch);
  gemm_kernel<ROUND, BM, BN, TM, TN><<<grid, THREADS, 0, stream>>>(
      A1, B1, A2, B2, C, M, N, K, sA, sB, sC, sp.spec, sp.rows, sp.d2, sp.st, sp.g);
  return cudaGetLastError();
}

// Block tiles: 64x64 with a 4x4 micro-tile per thread where the grid has
// blocks enough to fill the card, 32x32 with 2x2 where it would not (a
// (1, 3, 256, 256) solve gives only 48 blocks of 64x64 for 132 SMs).
template <int ROUND>
cudaError_t gemm(const float* A1, const float* B1, const float* A2, const float* B2,
                 float* C, int M, int N, int K, long sA, long sB, long sC, int batch,
                 const Spectrum& sp, cudaStream_t stream) {
  const long big_blocks = (long)((N + 63) / 64) * ((M + 63) / 64) * batch;
  if (big_blocks >= 2L * sm_count())
    return gemm_tiled<ROUND, 64, 64, 4, 4>(A1, B1, A2, B2, C, M, N, K, sA, sB, sC, batch,
                                           sp, stream);
  return gemm_tiled<ROUND, 32, 32, 2, 2>(A1, B1, A2, B2, C, M, N, K, sA, sB, sC, batch,
                                         sp, stream);
}

struct Problem {
  const float* mats[4];  // cas: th, tw; Hartley pair: th, thp, cw, sw
  int n_mats;
  int planes, h, w;
  float* d;  // Hartley pair: left-stage product of th
  float* a;  // the other intermediate product
  cudaStream_t stream;
};

// dst = T(src) (* spectrum) over all planes, left (H-side) stage first, per
// plane: the order of the TPU kernels' _make_xform (K3 and K4). `blocks`
// carries K3's BlockStates into every stage (kPerBlock); `sp` adds the
// spectrum to the last.
//   cas:          a = T_h src;  dst = a T_w
//   Hartley pair: d = T_h src, a = T_h' src;  dst = d C_w + a S_w
template <int ROUND>
cudaError_t apply_left(const Problem& p, const float* src, float* dst, const Spectrum& sp) {
  const long hw = (long)p.h * p.w;
  Spectrum blocks = kNoSpectrum;
  blocks.st = sp.st;
  blocks.g = sp.g;
  cudaError_t err;
  if (p.n_mats == 2) {
    err = gemm<ROUND>(p.mats[0], src, nullptr, nullptr, p.a, p.h, p.w, p.h, 0, hw, hw,
                      p.planes, blocks, p.stream);
    if (err != cudaSuccess) return err;
    return gemm<ROUND>(p.a, p.mats[1], nullptr, nullptr, dst, p.h, p.w, p.w, hw, 0, hw,
                       p.planes, sp, p.stream);
  }
  err = gemm<ROUND>(p.mats[0], src, nullptr, nullptr, p.d, p.h, p.w, p.h, 0, hw, hw,
                    p.planes, blocks, p.stream);
  if (err != cudaSuccess) return err;
  err = gemm<ROUND>(p.mats[1], src, nullptr, nullptr, p.a, p.h, p.w, p.h, 0, hw, hw,
                    p.planes, blocks, p.stream);
  if (err != cudaSuccess) return err;
  return gemm<ROUND>(p.d, p.mats[2], p.a, p.mats[3], dst, p.h, p.w, p.w, hw, 0, hw,
                     p.planes, sp, p.stream);
}

}  // namespace tiled
