// The tensor-core product engine of the whole-solve kernels (vmem_solver.cu:
// K2; vmem_adaptive.cu: K3; vmem_interleaved.cu, K4, uses its fragments and
// compute_exact / compute_fast on its own tiles), and the cooperative launch
// of the persistent solves.
//
// One product job: C[b] = A1[b] @ B1[b] (+ A2[b] @ B2[b]), each row-major,
// M x K times K x N, with per-batch element strides (a stride of 0 shares
// one matrix across the batch). The epilogue may multiply by a diagonal
// spectrum at (row % spec_rows, col): by `spec` itself (K2, K4) or, given
// d2, by 1 / (spec + rho_b * d2) with the tile's block's own rho (K3).
//
// A BM x BN output tile is computed by 8 warps (2 x 4) with mma.sync.
// Operands are staged through a ring of STAGES shared-memory tiles of depth
// BK, filled by cp.async (16 bytes a copy where rows are aligned, else 4),
// so the loads of the next steps run under the products of this one.
//   exact (the 'high' products, and 'mixed' outside its fast phase):
//     3xTF32. Each operand is split into hi = cvt.rna.tf32(a) and
//     lo = cvt.rna.tf32(a - hi); C = (sum a_lo b_hi + a_hi b_lo) +
//     sum a_hi b_hi, m16n8k8 TF32 products with f32 accumulation, the small
//     terms summed apart and first (compute_exact).
//     The transform matrices are split once per solve (split_matrices); the
//     state operand is split as its fragments are read.
//   fast (the single-pass phase of 'mixed'): one m16n8k16 bf16 pass on
//     operands rounded to bf16 (nearest even), f32 accumulation: the plain
//     version's bf16-rounded float32 products up to summation order.
// A tile's phase is uniform, so a tile never mixes roundings.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tiled {

constexpr int THREADS = 256;
// CTAs a persistent kernel keeps on an SM: its registers are capped at
// 65536 / (THREADS * MIN_CTAS) = 128 a thread, so the elementwise stages
// have 16 warps an SM
constexpr int MIN_CTAS = 2;

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

struct Operand {
  const float* p;   // f32 values, row-major
  const float* hi;  // tf32 halves of p split once per solve, or null
  const float* lo;
  long stride;      // elements between batch entries; 0 shares one matrix
};

struct Gemm {
  Operand a1, b1, a2, b2;  // a2.p == nullptr: one product
  float* c;
  long sc;
  int m, n, k, batch;
  const float* spec;  // null: no epilogue multiply
  int spec_rows;
  const float* d2;    // null: C *= spec; else C *= 1 / (spec + rho d2)
};

// The transform matrices and their tf32 halves (hi[i], lo[i]: size[i]
// floats each, in workspace).
struct Mats {
  const float* m[4];
  float* hi[4];
  float* lo[4];
  long size[4];
  int n;
};

// A BM x BN output tile, depth BK per shared-memory stage, a ring of STAGES.
template <int BM_, int BN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int LDA = BK + 4;  // A stage [BM][LDA]: conflict-free fragments
  static constexpr int LDB = BN + 8;  // B stage [BK][LDB]
  static constexpr int A_FLOATS = BM * LDA;
  static constexpr int B_FLOATS = BK * LDB;
  static constexpr int LO_FLOATS = A_FLOATS > B_FLOATS ? A_FLOATS : B_FLOATS;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS + LO_FLOATS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_FLOATS * sizeof(float);
  static constexpr int WM = BM / 2, WN = BN / 4;  // one warp's part
  static constexpr int MI = WM / 16, NI = WN / 8;  // mma tiles per warp
  static_assert(MI >= 1 && NI >= 1, "a warp needs at least one m16n8 tile");

  __host__ __device__ static int tiles_m(const Gemm& g) { return (g.m + BM - 1) / BM; }
  __host__ __device__ static int tiles_n(const Gemm& g) { return (g.n + BN - 1) / BN; }
  __host__ __device__ static long count(const Gemm& g) {
    return (long)tiles_m(g) * tiles_n(g) * g.batch;
  }
};

// --- device primitives -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  __nv_bfloat162 v = __floats2bfloat162_rn(first, second);  // first in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ROWS x COLS of a row-major matrix (leading dimension ld) at (r0, c0) into
// shared [ROWS][LD], zero outside (rmax, cmax). `vec`: ld % 4 == 0 and src
// 16-byte aligned, so a 4-float chunk is wholly inside or outside.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_block(float* dst, const float* src, int ld, int r0, int c0,
                                           int rmax, int cmax, bool vec) {
  if (vec) {
    constexpr int PER_ROW = COLS / 4;
    for (int l = threadIdx.x; l < ROWS * PER_ROW; l += THREADS) {
      const int r = l / PER_ROW, c = (l % PER_ROW) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rmax && gc < cmax;
      cp_async16(dst + r * LD + c, ok ? src + (long)gr * ld + gc : src, ok);
    }
  } else {
    for (int l = threadIdx.x; l < ROWS * COLS; l += THREADS) {
      const int r = l / COLS, c = l % COLS;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rmax && gc < cmax;
      cp_async4(dst + r * LD + c, ok ? src + (long)gr * ld + gc : src, ok);
    }
  }
}

__device__ __forceinline__ bool aligned16(const float* p, int ld) {
  return (ld & 3) == 0 && ((uintptr_t)p & 15) == 0;
}

// One BK stage of 3xTF32 products: the small terms a_lo b_hi + a_hi b_lo
// accumulate in `small` on the tensor core; a_hi b_hi of each k8 step is
// taken from zero and added to `acc` by a float32 add. The tensor core's own
// accumulation truncates, and on the hi products that bias grew to 2e-4 over
// a 100-iteration Hartley-pair solve on an H100 (6e-6 with the add; the
// small terms are 2^-11 smaller). The epilogue adds small + acc. LO: 1 when A is
// split in advance (its tf32 lo half in `lo`), 2 when B is, 0 when neither.
template <class T, int LO>
__device__ __forceinline__ void compute_exact(const float* As, const float* Bs, const float* lo,
                                              float (&acc)[T::MI][T::NI][4],
                                              float (&small)[T::MI][T::NI][4],
                                              int wm0, int wn0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 8) {
    uint32_t ah[T::MI][4], al[T::MI][4], bh[T::NI][2], bl[T::NI][2];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
      const int r = wm0 + mi * 16 + g;
      const int at[4] = {r * T::LDA + kk + t, (r + 8) * T::LDA + kk + t,
                         r * T::LDA + kk + t + 4, (r + 8) * T::LDA + kk + t + 4};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (LO == 1) {
          ah[mi][q] = __float_as_uint(As[at[q]]);
          al[mi][q] = __float_as_uint(lo[at[q]]);
        } else {
          split_tf32(As[at[q]], ah[mi][q], al[mi][q]);
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int c = wn0 + ni * 8 + g;
      const int at[2] = {(kk + t) * T::LDB + c, (kk + t + 4) * T::LDB + c};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (LO == 2) {
          bh[ni][q] = __float_as_uint(Bs[at[q]]);
          bl[ni][q] = __float_as_uint(lo[at[q]]);
        } else {
          split_tf32(Bs[at[q]], bh[ni][q], bl[ni][q]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        mma_tf32(small[mi][ni], al[mi], bh[ni]);
        mma_tf32(small[mi][ni], ah[mi], bl[ni]);
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(part, ah[mi], bh[ni]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[q];
      }
  }
}

// One BK stage of single-pass bf16 products.
template <class T>
__device__ __forceinline__ void compute_fast(const float* As, const float* Bs,
                                             float (&acc)[T::MI][T::NI][4],
                                             int wm0, int wn0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 16) {
    uint32_t a[T::MI][4], b[T::NI][2];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
      const int r = wm0 + mi * 16 + g;
      const float2 v0 = *reinterpret_cast<const float2*>(As + r * T::LDA + kk + 2 * t);
      const float2 v1 = *reinterpret_cast<const float2*>(As + (r + 8) * T::LDA + kk + 2 * t);
      const float2 v2 = *reinterpret_cast<const float2*>(As + r * T::LDA + kk + 2 * t + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(As + (r + 8) * T::LDA + kk + 2 * t + 8);
      a[mi][0] = pack_bf16(v0.x, v0.y);
      a[mi][1] = pack_bf16(v1.x, v1.y);
      a[mi][2] = pack_bf16(v2.x, v2.y);
      a[mi][3] = pack_bf16(v3.x, v3.y);
    }
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int c = wn0 + ni * 8 + g;
      const int k0 = kk + 2 * t;
      b[ni][0] = pack_bf16(Bs[k0 * T::LDB + c], Bs[(k0 + 1) * T::LDB + c]);
      b[ni][1] = pack_bf16(Bs[(k0 + 8) * T::LDB + c], Bs[(k0 + 9) * T::LDB + c]);
    }
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

__device__ __forceinline__ float spectrum_at(const Gemm& gm, long at, float rho) {
  return gm.d2 != nullptr ? 1.0f / (gm.spec[at] + rho * gm.d2[at]) : gm.spec[at];
}

// Output tile (tm, tn) of batch entry b. `smem` holds T::SMEM bytes; every
// thread of the CTA calls this with the same arguments.
template <class T>
__device__ void gemm_tile(const Gemm& gm, int b, int tm, int tn, bool fast, float rho,
                          float* smem) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, STAGES = T::STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp >> 2) * T::WM, wn0 = (warp & 3) * T::WN;
  const int row0 = tm * BM, col0 = tn * BN;
  float acc[T::MI][T::NI][4], small[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = small[mi][ni][q] = 0.0f;

  const int kt = (gm.k + BK - 1) / BK;
  const int steps = (gm.a2.p != nullptr ? 2 : 1) * kt;
  auto issue = [&](int step) {
    const bool second = step >= kt;
    const Operand& A = second ? gm.a2 : gm.a1;
    const Operand& B = second ? gm.b2 : gm.b1;
    const int k0 = (step - (second ? kt : 0)) * BK;
    float* base = smem + (step % STAGES) * T::STAGE_FLOATS;
    const bool a_split = !fast && A.hi != nullptr;
    const bool b_split = !fast && !a_split && B.hi != nullptr;
    const float* pa = (a_split ? A.hi : A.p) + b * A.stride;
    const float* pb = (b_split ? B.hi : B.p) + b * B.stride;
    load_block<BM, BK, T::LDA>(base, pa, gm.k, row0, k0, gm.m, gm.k, aligned16(pa, gm.k));
    load_block<BK, BN, T::LDB>(base + T::A_FLOATS, pb, gm.n, k0, col0, gm.k, gm.n,
                               aligned16(pb, gm.n));
    float* lo = base + T::A_FLOATS + T::B_FLOATS;
    if (a_split) {
      const float* pl = A.lo + b * A.stride;
      load_block<BM, BK, T::LDA>(lo, pl, gm.k, row0, k0, gm.m, gm.k, aligned16(pl, gm.k));
    } else if (b_split) {
      const float* pl = B.lo + b * B.stride;
      load_block<BK, BN, T::LDB>(lo, pl, gm.n, k0, col0, gm.k, gm.n, aligned16(pl, gm.n));
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the stage has landed, and every warp is done with step - 1
    if (step + STAGES - 1 < steps) issue(step + STAGES - 1);
    cp_async_commit();
    const float* base = smem + (step % STAGES) * T::STAGE_FLOATS;
    const float* As = base;
    const float* Bs = base + T::A_FLOATS;
    const float* lo = base + T::A_FLOATS + T::B_FLOATS;
    if (fast) {
      compute_fast<T>(As, Bs, acc, wm0, wn0, g, t);
    } else {
      const bool second = step >= kt;
      const Operand& A = second ? gm.a2 : gm.a1;
      const Operand& B = second ? gm.b2 : gm.b1;
      if (A.hi != nullptr)
        compute_exact<T, 1>(As, Bs, lo, acc, small, wm0, wn0, g, t);
      else if (B.hi != nullptr)
        compute_exact<T, 2>(As, Bs, lo, acc, small, wm0, wn0, g, t);
      else
        compute_exact<T, 0>(As, Bs, lo, acc, small, wm0, wn0, g, t);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the CTA's next tile

  float* C = gm.c + b * gm.sc;
  const bool pairs = (gm.n & 1) == 0 && ((uintptr_t)C & 7) == 0;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + wm0 + mi * 16 + g + half * 8;
        const int col = col0 + wn0 + ni * 8 + 2 * t;
        if (row >= gm.m || col >= gm.n) continue;
        // the small terms' sum first, then the hi products (0 + v in bf16)
        float v0 = small[mi][ni][2 * half] + acc[mi][ni][2 * half];
        float v1 = small[mi][ni][2 * half + 1] + acc[mi][ni][2 * half + 1];
        const bool both = col + 1 < gm.n;
        if (gm.spec != nullptr) {
          const long at = (long)(row % gm.spec_rows) * gm.n + col;
          v0 *= spectrum_at(gm, at, rho);
          if (both) v1 *= spectrum_at(gm, at + 1, rho);
        }
        float* out = C + (long)row * gm.n + col;
        if (both && pairs) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (both) out[1] = v1;
        }
      }
}

// Per-block phase and stopping of K3's product tiles: batch entry b is a
// plane of block b / g. st == nullptr: every tile runs in the stage's phase.
struct Blocks {
  const BlockState* st;
  int g;
};

// The tiles of n_jobs jobs, walked by the CTAs of the grid in turn. The
// tiles of a stopped block are skipped (uniform over the CTA).
template <class T>
__device__ void run_stage(const Gemm* jobs, int n_jobs, bool fast, const Blocks& blk,
                          float* smem) {
  long total = 0;
  for (int j = 0; j < n_jobs; ++j) total += T::count(jobs[j]);
  for (long t = blockIdx.x; t < total; t += gridDim.x) {
    int j = 0;
    long r = t;
    while (r >= T::count(jobs[j])) r -= T::count(jobs[j++]);
    const Gemm& gm = jobs[j];
    const long per_b = (long)T::tiles_m(gm) * T::tiles_n(gm);
    const int b = (int)(r / per_b);
    r -= b * per_b;
    bool f = fast;
    float rho = 0.0f;
    if (blk.st != nullptr) {
      const BlockState& s = blk.st[b / blk.g];
      if (!s.run) continue;
      f = s.fast != 0;
      rho = s.rho;
    }
    gemm_tile<T>(gm, b, (int)(r / T::tiles_n(gm)), (int)(r % T::tiles_n(gm)), f, rho, smem);
  }
}

// hi = tf32(m), lo = tf32(m - hi) for every matrix, over the whole grid.
__device__ __forceinline__ void split_matrices(const Mats& mats) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (int i = 0; i < mats.n; ++i)
    for (long at = (long)blockIdx.x * blockDim.x + threadIdx.x; at < mats.size[i]; at += stride) {
      uint32_t hi, lo;
      split_tf32(mats.m[i][at], hi, lo);
      mats.hi[i][at] = __uint_as_float(hi);
      mats.lo[i][at] = __uint_as_float(lo);
    }
}

// Device time by stage of a persistent solve, as CTA 0 sees it between its
// grid barriers (each stage's time includes its barrier): mark(i) adds the
// nanoseconds since the previous mark to ns[i]. ns == nullptr: off.
struct StageClock {
  unsigned long long* ns;
  unsigned long long last;

  __device__ __forceinline__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ __forceinline__ explicit StageClock(unsigned long long* out)
      : ns(blockIdx.x == 0 && threadIdx.x == 0 ? out : nullptr), last(ns ? now() : 0) {}
  __device__ __forceinline__ void mark(int stage) {
    if (ns != nullptr) {
      const unsigned long long t = now();
      ns[stage] += t - last;
      last = t;
    }
  }
};

// --- host side ----------------------------------------------------------------

inline int sm_count() {
  int dev = 0, count = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  return count;
}

// The matrices of a cas (n == 2: th, tw) or Hartley-pair (n == 4: th, thp,
// cw, sw) transform, with their halves in split (4 (h^2 + w^2) floats).
inline Mats make_mats(const float* const* m, int n, int h, int w, float* split) {
  Mats mats{};
  mats.n = n;
  for (int i = 0; i < n; ++i) {
    // th (and thp) are h x h; tw (cas) and cw, sw (pair) are w x w
    const long size = (n == 2 ? i == 0 : i < 2) ? (long)h * h : (long)w * w;
    mats.m[i] = m[i];
    mats.hi[i] = split;
    mats.lo[i] = split + size;
    mats.size[i] = size;
    split += 2 * size;
  }
  return mats;
}

inline Operand matrix(const Mats& mats, int i) {
  return Operand{mats.m[i], mats.hi[i], mats.lo[i], 0};
}

inline Operand planes_of(const float* p, long hw) { return Operand{p, nullptr, nullptr, hw}; }

constexpr Operand kNone{nullptr, nullptr, nullptr, 0};

// The stages of dst = T(src) (* spectrum) with the left (H-side) stage first,
// per plane: the order of the TPU kernels' _make_xform (K3, K4).
//   cas:          a = T_h src;  dst = a T_w                 (1 job, 1 job)
//   Hartley pair: d = T_h src, a = T_h' src;  dst = d C_w + a S_w  (2, 1)
// first[0..n_first) is the first stage, *last the second; the spectrum
// (spec, d2 as in Gemm) goes into the second's epilogue.
inline int left_first_stages(const Mats& mats, int planes, int h, int w, const float* src,
                             float* dst, float* a, float* d, const float* spec,
                             const float* d2, Gemm* first, Gemm* last) {
  const long hw = (long)h * w;
  if (mats.n == 2) {
    first[0] = Gemm{matrix(mats, 0), planes_of(src, hw), kNone, kNone, a, hw, h, w, h, planes,
                    nullptr, 1, nullptr};
    *last = Gemm{planes_of(a, hw), matrix(mats, 1), kNone, kNone, dst, hw, h, w, w, planes,
                 spec, h, d2};
    return 1;
  }
  first[0] = Gemm{matrix(mats, 0), planes_of(src, hw), kNone, kNone, d, hw, h, w, h, planes,
                  nullptr, 1, nullptr};
  first[1] = Gemm{matrix(mats, 1), planes_of(src, hw), kNone, kNone, a, hw, h, w, h, planes,
                  nullptr, 1, nullptr};
  *last = Gemm{planes_of(d, hw), matrix(mats, 2), planes_of(a, hw), matrix(mats, 3), dst, hw, h,
               w, w, planes, spec, h, d2};
  return 2;
}

// Launch `kernel(params)` cooperatively: one CTA of THREADS per resident
// slot (occupancy x SMs), so that the elementwise stages have every warp the
// card can hold. A grid the card cannot hold at once is refused by the
// launch with an error, never run.
template <typename Params>
cudaError_t launch_cooperative(void (*kernel)(Params), const Params& params, size_t smem,
                               cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = per_sm * sm_count();
  void* args[] = {const_cast<Params*>(&params)};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, smem,
                                    stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The two tile shapes: 64 x 128 where the per-plane stage gives at least
// two 64 x 64 tiles per resident CTA slot, 32 x 32 where it would leave SMs
// idle (a (1, 3, 256, 256) solve has 48 tiles of 64 x 64 per stage and 192
// of 32 x 32). The small tile's stages are 64 deep: at (3, 256, 256) a tile
// waits on its loads, and fewer, deeper stages wait less. The large tile is
// double-buffered so that two CTAs fit an SM.
using SmallTile = Tile<32, 32, 64, 3>;
using BigTile = Tile<64, 128, 32, 2>;

inline bool big_tiles(int planes, int h, int w) {
  const long tiles64 = (long)((h + 63) / 64) * ((w + 63) / 64) * planes;
  return tiles64 >= 2L * sm_count();
}

}  // namespace tiled
