// K3: the residual-stopped whole TV-ADMM solve, with per-block stopping and
// adaptive rho.
//
// Replaces the TPU kernel torch_admm_deconv_tpu/kernels/vmem_solver.py
// (_make_adaptive_kernel, reached through admm_tv_adaptive_vmem). A block is
// one plane, or one sample's C planes in 'sample' mode. Per block, until its
// scaled residuals r, s <= tol or k == maxit:
//
//   x   = T(T(s) / (habs2 + rho d2))          habs2, d2 carry H*W
//   z   = shrink(D x + u, lmbd / rho);  u' = D x + u - z
//   r   = |D x - z| / sqrt(2 g H W);   s = |rho D^T(z - z_old)| / sqrt(2 g H W)
//   f   = residual balancing (Boyd 3.4.1; 1 when rho_mu >= 1e29)
//   rho <- rho f;  u <- u' / f;  s <- hty + rho D^T(z - u)
//
// T is the cas or Hartley-pair transform on tiled_gemm.cuh's tensor-core
// tiles, left stage first as the TPU kernel's _make_xform. 'mixed' runs
// single-pass bf16 products while r or s is above the switch (and
// k < fast_cap), then resets r, s to 1 so at least one 3xTF32 iteration
// measures the exit residuals.
//
// Bound on the H100: operations at 256^2 (4 (cas) or 8 (Hartley pair)
// products of 2 H^2 W flops per plane per iteration actually run, each
// three TF32 passes in 'high'); at (8, 3, 512, 512) the state is 24 MB per
// plane set, so the chain's stages also move HBM bytes. A TPU block keeps
// its state in VMEM and its stopping test in a scalar register; here the
// whole solve is one cooperative launch and every decision stays on the
// card:
//   * a BlockState per block (run, phase, k, r, s, rho, factor), double
//     buffered by iteration parity: iteration `it` reads st[it & 1] and its
//     finalize writes st[(it & 1) ^ 1];
//   * every stage skips the tiles of planes whose block is not running, so
//     a stopped block's x, z and u stay as its last executed iteration left
//     them and iteration counts are exact;
//   * the product tiles take each block's phase (bf16 or 3xTF32) and its own
//     spectrum 1 / (habs2 + rho_b d2) in the epilogue;
//   * an iteration is 4 product stages, then (a) z, the unscaled u' and
//     per-chunk partial sums of |Dx - z|^2 and |rho D^T(z - z_old)|^2, the
//     neighbours' z recomputed as K1 does; (b) the CTAs reduce each
//     block's partials in a fixed order (no float atomics: a run is
//     reproducible) and update its BlockState; (c) the next right-hand side
//     and u'/f; a grid barrier separates the 7 stages;
//   * at the top of an iteration every CTA reads the blocks' run flags and
//     the grid leaves the loop when none runs: no host polling, no masked
//     iterations after the last stop.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().


#include "admm_chain.cuh"
#include "tiled_gemm.cuh"

namespace {

using tiled::BlockState;
using tiled::Gemm;

constexpr int kUnroll = 2;  // pixels a thread computes before it stores them
constexpr int kChunk = kUnroll * tiled::THREADS;  // pixels per partial sum

struct Schedule {
  int maxit;
  int fast_cap;
  float tol;
  float fast_switch;
};

struct Adapt {
  int on;           // 0: rho_mu >= 1e29, factor exactly 1
  float mu;         // rho_mu
  float grow;       // rho_scale
  float shrink;     // 1 / rho_scale
};

// After an iteration (or at the start, with k = 0 and r = s = 1): leave the
// fast phase once its condition fails, resetting r and s to 1 as the TPU
// kernel does, and decide whether the block runs the next iteration.
__host__ __device__ inline void schedule(BlockState& b, const Schedule& sc) {
  if (b.fast) {
    const bool stay = b.k < sc.fast_cap && (b.r > sc.fast_switch || b.s > sc.fast_switch);
    if (!stay) {
      b.fast = 0;
      b.r = 1.0f;
      b.s = 1.0f;
    }
  }
  b.run = b.fast ? 1 : (b.k < sc.maxit && (b.r > sc.tol || b.s > sc.tol));
}

struct Adaptive {
  tiled::Mats mats;
  Gemm t1a[2], t1b, t2a[2], t2b;  // T1: s -> y (block spectra), T2: y -> x
  int n_a;
  const float *hty, *lmbd_rho0;
  float *x, *zx, *zy, *ux, *uy;     // the state (and exit state)
  float *zx1, *zy1, *ux1, *uy1, *s;  // z and u' of the iteration; the RHS
  float* partial;
  BlockState* st;  // 2 x n_blocks
  int* iters;
  float* stats;
  unsigned long long* stage_ns;  // 8 slots, or null
  int n_planes, g, h, w, mode, n_blocks, chunks, use_fast;
  Schedule sc;
  Adapt ad;
  float scale;
};

// Sum over the CTA in a fixed order: warp shuffles, then warp 0 over the
// warps' sums. Ends with a barrier, so `shared` may be reused at once.
__device__ __forceinline__ float cta_sum(float v, float* shared) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? shared[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  return v;
}

// (a) at one pixel: z, u' = a - z and the squared residuals, not stored.
struct Residual {
  float zx, zy, unx, uny, rr, ss;
};

template <int MODE>
__device__ __forceinline__ Residual residual_at(const Adaptive& p, int plane, long idx, float rho,
                                                float tau) {
  const int h = p.h, w = p.w, g = p.g;
  const int i = (int)(idx / w);
  const int j = (int)(idx % w);
  const int jr = j == w - 1 ? 0 : j + 1;
  const int id = i == h - 1 ? 0 : i + 1;
  const long hw = (long)h * w;
  const long base = (long)plane * hw;
  const long group = (long)(plane / g) * g * hw;
  float dx, dy, ax, ay, zx, zy;
  admm::shrink_at<MODE>(p.x, p.ux, p.uy, base, group, g, i, j, h, w, tau, dx, dy, ax, ay, zx, zy);
  float e0, e1, e2, e3, zx_r, zy_r, zx_d, zy_d;
  admm::shrink_at<MODE>(p.x, p.ux, p.uy, base, group, g, i, jr, h, w, tau, e0, e1, e2, e3, zx_r,
                        zy_r);
  admm::shrink_at<MODE>(p.x, p.ux, p.uy, base, group, g, id, j, h, w, tau, e0, e1, e2, e3, zx_d,
                        zy_d);
  const float dzx = zx - p.zx[base + idx];
  const float dzx_r = zx_r - p.zx[base + (long)i * w + jr];
  const float dzy = zy - p.zy[base + idx];
  const float dzy_d = zy_d - p.zy[base + (long)id * w + j];
  const float sdual = rho * (dzx - dzx_r + dzy - dzy_d);
  const float rx = dx - zx;
  const float ry = dy - zy;
  return Residual{zx, zy, ax - zx, ay - zy, rx * rx + ry * ry, sdual * sdual};
}

// (a) over the chunks of one running plane's CTA item; returns the
// thread's sums, taken in a fixed order.
template <int MODE>
__device__ __forceinline__ void residual_chunk(const Adaptive& p, int plane, int chunk,
                                               float rho, float tau, float& rr, float& ss) {
  const long hw = (long)p.h * p.w;
  const long base = (long)plane * hw;
  Residual v[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    const long idx = (long)chunk * kChunk + q * tiled::THREADS + threadIdx.x;
    if (idx < hw) v[q] = residual_at<MODE>(p, plane, idx, rho, tau);
  }
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    const long idx = (long)chunk * kChunk + q * tiled::THREADS + threadIdx.x;
    if (idx < hw) {
      rr += v[q].rr;
      ss += v[q].ss;
      p.zx1[base + idx] = v[q].zx;
      p.zy1[base + idx] = v[q].zy;
      p.ux1[base + idx] = v[q].unx;
      p.uy1[base + idx] = v[q].uny;
    }
  }
}

// (a) over the chunks of running planes; partial[plane * chunks + c] and
// the dual sums at partial[n_planes * chunks + ...].
__device__ void residual_stage(const Adaptive& p, const BlockState* cur, float* red) {
  const long items = (long)p.n_planes * p.chunks;
  for (long item = blockIdx.x; item < items; item += gridDim.x) {
    const int plane = (int)(item / p.chunks);
    const int chunk = (int)(item % p.chunks);
    const BlockState& b = cur[plane / p.g];
    if (!b.run) continue;  // uniform over the CTA
    const float rho = b.rho;
    const float tau = fmaxf(p.lmbd_rho0[0] / rho, 0.0f);  // the clip form needs tau >= 0
    float rr = 0.0f, ss = 0.0f;
    switch (p.mode) {
      case admm::kAniso:
        residual_chunk<admm::kAniso>(p, plane, chunk, rho, tau, rr, ss);
        break;
      case admm::kSample:
        residual_chunk<admm::kSample>(p, plane, chunk, rho, tau, rr, ss);
        break;
      default:
        residual_chunk<admm::kJoint>(p, plane, chunk, rho, tau, rr, ss);
    }
    rr = cta_sum(rr, red);
    ss = cta_sum(ss, red);
    if (threadIdx.x == 0) {
      p.partial[item] = rr;
      p.partial[items + item] = ss;
    }
  }
}

// (b) per block, one CTA: reduce its planes' partials in a fixed order and
// update r, s, rho, k and the schedule. Blocks that did not run carry over
// with factor 1.
__device__ void finalize_stage(const Adaptive& p, const BlockState* cur, BlockState* nxt,
                               float* red) {
  const long per_block = (long)p.g * p.chunks;
  const float* dual = p.partial + (long)p.n_planes * p.chunks;
  for (int blk = blockIdx.x; blk < p.n_blocks; blk += gridDim.x) {
    BlockState b = cur[blk];
    if (!b.run) {
      if (threadIdx.x == 0) {
        b.factor = 1.0f;
        nxt[blk] = b;
      }
      continue;
    }
    float sum_r = 0.0f, sum_s = 0.0f;
    for (long t = threadIdx.x; t < per_block; t += blockDim.x) {
      sum_r += p.partial[blk * per_block + t];
      sum_s += dual[blk * per_block + t];
    }
    sum_r = cta_sum(sum_r, red);
    sum_s = cta_sum(sum_s, red);
    if (threadIdx.x == 0) {
      const float r = sqrtf(sum_r) / p.scale;
      const float s = sqrtf(sum_s) / p.scale;
      float factor = 1.0f;
      if (p.ad.on) {
        if (r > p.ad.mu * s)
          factor = p.ad.grow;
        else if (s > p.ad.mu * r)
          factor = p.ad.shrink;
      }
      b.k += 1;
      b.r = r;
      b.s = s;
      b.rho = b.rho * factor;
      b.factor = factor;
      schedule(b, p.sc);
      nxt[blk] = b;
    }
  }
}

// (c) for the planes that ran: s = hty + rho_new D^T(z - u'/f), u = u'/f,
// and z moves into the state buffers.
struct Rhs {
  float s, ux, uy, zx, zy;
};

__device__ __forceinline__ Rhs rhs_at(const Adaptive& p, const BlockState* nxt, long at) {
  const int h = p.h, w = p.w;
  const long hw = (long)h * w;
  const int plane = (int)(at / hw);
  const int blk = plane / p.g;
  const long idx = at - (long)plane * hw;
  const float rho = nxt[blk].rho;
  const float inv_f = 1.0f / nxt[blk].factor;
  const int i = (int)(idx / w);
  const int j = (int)(idx % w);
  const int jr = j == w - 1 ? 0 : j + 1;
  const int id = i == h - 1 ? 0 : i + 1;
  const long base = (long)plane * hw;
  const long right = base + (long)i * w + jr;
  const long down = base + (long)id * w + j;
  const float uxs = p.ux1[at] * inv_f;
  const float uys = p.uy1[at] * inv_f;
  const float zx = p.zx1[at], zy = p.zy1[at];
  const float tx = zx - uxs;
  const float ty = zy - uys;
  const float tx_r = p.zx1[right] - p.ux1[right] * inv_f;
  const float ty_d = p.zy1[down] - p.uy1[down] * inv_f;
  return Rhs{p.hty[at] + rho * (tx - tx_r + ty - ty_d), uxs, uys, zx, zy};
}

__device__ void rhs_stage(const Adaptive& p, const BlockState* cur, const BlockState* nxt) {
  const long hw = (long)p.h * p.w;
  const long total = hw * p.n_planes;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long at0 = (long)blockIdx.x * blockDim.x + threadIdx.x; at0 < total;
       at0 += kUnroll * stride) {
    Rhs v[kUnroll];
    bool ran[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long at = at0 + q * stride;
      ran[q] = at < total && cur[(int)(at / hw) / p.g].run;
      if (ran[q]) v[q] = rhs_at(p, nxt, at);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long at = at0 + q * stride;
      if (ran[q]) {
        p.s[at] = v[q].s;
        p.ux[at] = v[q].ux;
        p.uy[at] = v[q].uy;
        p.zx[at] = v[q].zx;
        p.zy[at] = v[q].zy;
      }
    }
  }
}

// Every CTA reads the same flags after a grid barrier, so all leave the
// loop together.
__device__ __forceinline__ bool any_running(const BlockState* st, int n_blocks) {
  int run = 0;
  for (int b = threadIdx.x; b < n_blocks; b += blockDim.x) run |= st[b].run;
  return __syncthreads_or(run) != 0;
}

template <class T>
__global__ void __launch_bounds__(tiled::THREADS, tiled::MIN_CTAS)
k3_persistent(const __grid_constant__ Adaptive p) {
  extern __shared__ float4 smem_raw[];
  __shared__ float red[tiled::THREADS / 32];
  float* smem = reinterpret_cast<float*>(smem_raw);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  tiled::StageClock clock(p.stage_ns);

  // prologue: the matrices' halves, x = z = u = 0, s = hty, the blocks
  tiled::split_matrices(p.mats);
  const long total = (long)p.h * p.w * p.n_planes;
  const long stride = (long)gridDim.x * blockDim.x;
  const long first = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long at = first; at < total; at += stride) {
    p.x[at] = p.zx[at] = p.zy[at] = p.ux[at] = p.uy[at] = 0.0f;
    p.s[at] = p.hty[at];
  }
  for (long b = first; b < p.n_blocks; b += stride) {
    BlockState s;
    s.k = 0;
    s.pad = 0;
    s.r = 1.0f;
    s.s = 1.0f;
    s.rho = p.lmbd_rho0[1];
    s.factor = 1.0f;
    s.fast = p.use_fast;
    schedule(s, p.sc);
    p.st[b] = s;
  }
  grid.sync();
  clock.mark(0);

  int it = 0;
  for (;; ++it) {
    const BlockState* cur = p.st + (it & 1) * p.n_blocks;
    BlockState* nxt = p.st + ((it & 1) ^ 1) * p.n_blocks;
    if (!any_running(cur, p.n_blocks)) break;
    const tiled::Blocks blocks{cur, p.g};
    tiled::run_stage<T>(p.t1a, p.n_a, false, blocks, smem);
    grid.sync();
    clock.mark(1);
    tiled::run_stage<T>(&p.t1b, 1, false, blocks, smem);
    grid.sync();
    clock.mark(2);
    tiled::run_stage<T>(p.t2a, p.n_a, false, blocks, smem);
    grid.sync();
    clock.mark(3);
    tiled::run_stage<T>(&p.t2b, 1, false, blocks, smem);
    grid.sync();
    clock.mark(4);
    residual_stage(p, cur, red);
    grid.sync();
    clock.mark(5);
    finalize_stage(p, cur, nxt, red);
    grid.sync();
    clock.mark(6);
    rhs_stage(p, cur, nxt);
    grid.sync();
    clock.mark(7);
  }
  // the state after the last iteration
  if (blockIdx.x == 0) {
    const BlockState* st = p.st + (it & 1) * p.n_blocks;
    for (int b = threadIdx.x; b < p.n_blocks; b += blockDim.x) {
      p.iters[b] = st[b].k;
      p.stats[b] = st[b].r;
      p.stats[p.n_blocks + b] = st[b].s;
      p.stats[2 * p.n_blocks + b] = st[b].rho;
    }
  }
}

template <class T>
cudaError_t launch_k3(const Adaptive& p, cudaStream_t stream) {
  return tiled::launch_cooperative(k3_persistent<T>, p, T::SMEM, stream);
}

int chunks_per_plane(int h, int w) { return (int)(((long)h * w + kChunk - 1) / kChunk); }

}  // namespace

// Floats of workspace admm_tv_adaptive_solve needs: z, u' (4 plane sets),
// s, y and two transform intermediates (4 more), the partial sums, and the
// matrices' tf32 halves.
extern "C" long admm_tv_adaptive_workspace(int n_planes, int h, int w) {
  return 8L * n_planes * h * w + 2L * n_planes * chunks_per_plane(h, w) +
         4L * ((long)h * h + (long)w * w);
}

// hty, x and the exit state zx, zy, ux, uy are (n_planes, h, w) f32; habs2
// and d2 are (h, w), pre-scaled by h*w; lmbd_rho0 = {lmbd, rho0} on the
// device. work holds admm_tv_adaptive_workspace floats; state 2 * n_blocks
// BlockStates. Outputs iters (n_blocks,) int32 and stats (3, n_blocks) =
// r, s, rho. stage_ns: null, or 8 zeroed counters that receive the device
// nanoseconds of the prologue, the four product stages, the residual,
// finalize and right-hand-side stages, summed over the iterations. One
// cooperative launch; no host synchronisation.
extern "C" int admm_tv_adaptive_solve(
    const float* hty, const float* habs2, const float* d2, const float* m0, const float* m1,
    const float* m2, const float* m3, int n_mats, const float* lmbd_rho0, float* x,
    float* zx, float* zy, float* ux, float* uy, float* work, void* state, int* iters,
    float* stats, unsigned long long* stage_ns, int n_planes, int g, int h, int w, int mode,
    int maxit, float tol, int adapt, float rho_mu, float rho_scale, int use_fast,
    float fast_switch, int fast_cap, float scale, void* stream_handle) {
  cudaStream_t stream = (cudaStream_t)stream_handle;
  if (n_mats != 2 && n_mats != 4) return (int)cudaErrorInvalidValue;
  if (g <= 0 || n_planes % g != 0) return (int)cudaErrorInvalidValue;
  if (mode != admm::kAniso && mode != admm::kSample && mode != admm::kJoint)
    return (int)cudaErrorInvalidValue;
  const long set = (long)n_planes * h * w;
  float* planes[8];
  for (int i = 0; i < 8; ++i) planes[i] = work + i * set;
  Adaptive p{};
  const float* m[4] = {m0, m1, m2, m3};
  p.chunks = chunks_per_plane(h, w);
  p.mats = tiled::make_mats(m, n_mats, h, w, work + 8 * set + 2L * n_planes * p.chunks);
  float *y = planes[5], *a = planes[6], *d = planes[7];
  p.n_a = tiled::left_first_stages(p.mats, n_planes, h, w, planes[4], y, a, d, habs2, d2, p.t1a,
                                   &p.t1b);
  tiled::left_first_stages(p.mats, n_planes, h, w, y, x, a, d, nullptr, nullptr, p.t2a, &p.t2b);
  p.hty = hty;
  p.lmbd_rho0 = lmbd_rho0;
  p.x = x;
  p.zx = zx;
  p.zy = zy;
  p.ux = ux;
  p.uy = uy;
  p.zx1 = planes[0];
  p.zy1 = planes[1];
  p.ux1 = planes[2];
  p.uy1 = planes[3];
  p.s = planes[4];
  p.partial = work + 8 * set;
  p.st = (BlockState*)state;
  p.iters = iters;
  p.stats = stats;
  p.stage_ns = stage_ns;
  p.n_planes = n_planes;
  p.g = g;
  p.h = h;
  p.w = w;
  p.mode = mode;
  p.n_blocks = n_planes / g;
  p.use_fast = use_fast;
  p.sc = Schedule{maxit, fast_cap, tol, fast_switch};
  p.ad = Adapt{adapt, rho_mu, rho_scale, 1.0f / rho_scale};
  p.scale = scale;
  const cudaError_t err = tiled::big_tiles(n_planes, h, w) ? launch_k3<tiled::BigTile>(p, stream)
                                                           : launch_k3<tiled::SmallTile>(p, stream);
  return (int)err;
}
