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
// T is the cas or Hartley-pair transform of tiled_gemm.cuh, left stage first
// as the TPU kernel's _make_xform. 'mixed' runs single-pass bf16 operands
// while r or s is above the switch (and k < fast_cap), then resets r, s to 1
// so at least one exact iteration measures the exit residuals.
//
// Bound on the H100: operations, as K2's: 4 (cas) or 8 (Hartley pair)
// products of 2 H^2 W flops per plane per iteration actually run, summed
// over the blocks' iteration counts. A TPU block keeps its state in VMEM and
// its stopping test in a scalar register; here the state lives in device
// memory (in L2 at 256^2) and the host cannot see a block's residuals
// without waiting for the card. The design keeps every decision on the card:
//   * a BlockState per block (run, phase, k, r, s, rho, factor), double
//     buffered by iteration parity: iteration `it` reads st[it & 1] and its
//     finalize writes st[(it & 1) ^ 1];
//   * every kernel of an iteration skips the tiles of planes whose block is
//     not running, so a stopped block's x, z and u stay as its last executed
//     iteration left them and iteration counts are exact;
//   * the products take each block's phase (operand rounding) and its own
//     spectrum 1 / (habs2 + rho_b d2) in the epilogue;
//   * the chain is split in three launches: (a) z, the unscaled u' and
//     per-tile partial sums of |Dx - z|^2 and |rho D^T(z - z_old)|^2, the
//     neighbours' z recomputed as K1 does; (b) one block of threads reduces
//     the partials in a fixed order (no float atomics: a run is reproducible)
//     and updates the BlockStates; (c) the next right-hand side and u'/f;
//   * the host launches iterations in chunks of `poll` and reads a pinned
//     copy of the count of running blocks one chunk late, so the card never
//     waits for the host; the chunk launched after the last block stopped
//     runs masked (its tiles exit at once).
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <initializer_list>

#include "admm_chain.cuh"
#include "tiled_gemm.cuh"

namespace {

using tiled::BlockState;

constexpr int kThreads = 256;

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

__global__ void init_kernel(BlockState* st, const float* __restrict__ lmbd_rho0,
                            int n_blocks, int fast, Schedule sc) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  BlockState s;
  s.k = 0;
  s.pad = 0;
  s.r = 1.0f;
  s.s = 1.0f;
  s.rho = lmbd_rho0[1];
  s.factor = 1.0f;
  s.fast = fast;
  schedule(s, sc);
  st[b] = s;
}

// Sum over the CTA in a fixed order: warp shuffles, then warp 0 over the
// warps' sums.
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
  return v;
}

// (a) z, u' = a - z, and the tile's sums of rx^2 + ry^2 and sdual^2.
// grid (tiles per plane, planes); partial[p * tiles + tile] and the dual
// sums at partial[n_planes * tiles + ...].
template <int MODE>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const float* __restrict__ x, const float* __restrict__ ux,
                const float* __restrict__ uy, const float* __restrict__ zx_old,
                const float* __restrict__ zy_old, const BlockState* __restrict__ st,
                const float* __restrict__ lmbd_rho0, float* __restrict__ zx_new,
                float* __restrict__ zy_new, float* __restrict__ unx,
                float* __restrict__ uny, float* __restrict__ partial, int n_planes, int g,
                int h, int w) {
  __shared__ float red[kThreads / 32];
  const int p = blockIdx.y;
  const int blk = p / g;
  const BlockState b = st[blk];
  if (!b.run) return;
  const float rho = b.rho;
  const float tau = fmaxf(lmbd_rho0[0] / rho, 0.0f);  // the clip form needs tau >= 0
  const long hw = (long)h * w;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  float rr = 0.0f, ss = 0.0f;
  if (idx < hw) {
    const int i = (int)(idx / w);
    const int j = (int)(idx % w);
    const int jr = j == w - 1 ? 0 : j + 1;
    const int id = i == h - 1 ? 0 : i + 1;
    const long plane = (long)p * hw;
    const long group = (long)blk * g * hw;
    float dx, dy, ax, ay, zx, zy;
    admm::shrink_at<MODE>(x, ux, uy, plane, group, g, i, j, h, w, tau, dx, dy, ax, ay, zx, zy);
    float e0, e1, e2, e3, zx_r, zy_r, zx_d, zy_d;
    admm::shrink_at<MODE>(x, ux, uy, plane, group, g, i, jr, h, w, tau, e0, e1, e2, e3, zx_r,
                          zy_r);
    admm::shrink_at<MODE>(x, ux, uy, plane, group, g, id, j, h, w, tau, e0, e1, e2, e3, zx_d,
                          zy_d);
    const float dzx = zx - zx_old[plane + idx];
    const float dzx_r = zx_r - zx_old[plane + (long)i * w + jr];
    const float dzy = zy - zy_old[plane + idx];
    const float dzy_d = zy_d - zy_old[plane + (long)id * w + j];
    const float sdual = rho * (dzx - dzx_r + dzy - dzy_d);
    const float rx = dx - zx;
    const float ry = dy - zy;
    rr = rx * rx + ry * ry;
    ss = sdual * sdual;
    zx_new[plane + idx] = zx;
    zy_new[plane + idx] = zy;
    unx[plane + idx] = ax - zx;
    uny[plane + idx] = ay - zy;
  }
  rr = cta_sum(rr, red);
  __syncthreads();
  ss = cta_sum(ss, red);
  if (threadIdx.x == 0) {
    const long at = (long)p * gridDim.x + blockIdx.x;
    partial[at] = rr;
    partial[(long)n_planes * gridDim.x + at] = ss;
  }
}

// (b) one CTA: per running block, reduce its planes' partials in a fixed
// order, update r, s, rho, k and the schedule; count the blocks still
// running. Blocks that did not run carry over with factor 1.
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const BlockState* __restrict__ cur, BlockState* __restrict__ nxt,
                const float* __restrict__ partial, int n_blocks, int g, int tiles,
                int n_planes, float scale, Adapt ad, Schedule sc, int* __restrict__ n_run) {
  __shared__ float red[kThreads / 32];
  int running = 0;
  const long per_block = (long)g * tiles;
  const float* dual = partial + (long)n_planes * tiles;
  for (int blk = 0; blk < n_blocks; ++blk) {
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
      sum_r += partial[blk * per_block + t];
      sum_s += dual[blk * per_block + t];
    }
    sum_r = cta_sum(sum_r, red);
    __syncthreads();
    sum_s = cta_sum(sum_s, red);
    __syncthreads();
    if (threadIdx.x == 0) {
      const float r = sqrtf(sum_r) / scale;
      const float s = sqrtf(sum_s) / scale;
      float factor = 1.0f;
      if (ad.on) {
        if (r > ad.mu * s)
          factor = ad.grow;
        else if (s > ad.mu * r)
          factor = ad.shrink;
      }
      b.k += 1;
      b.r = r;
      b.s = s;
      b.rho = b.rho * factor;
      b.factor = factor;
      schedule(b, sc);
      nxt[blk] = b;
      running += b.run;
    }
  }
  if (threadIdx.x == 0) *n_run = running;
}

// (c) for the planes that ran: s = hty + rho_new D^T(z - u'/f), u = u'/f,
// and z moves into the state buffers.
__global__ void __launch_bounds__(kThreads)
rhs_kernel(const float* __restrict__ hty, const float* __restrict__ zx_new,
           const float* __restrict__ zy_new, const float* __restrict__ unx,
           const float* __restrict__ uny, const BlockState* __restrict__ cur,
           const BlockState* __restrict__ nxt, float* __restrict__ s,
           float* __restrict__ ux, float* __restrict__ uy, float* __restrict__ zx,
           float* __restrict__ zy, int g, int h, int w) {
  const int p = blockIdx.y;
  const int blk = p / g;
  if (!cur[blk].run) return;
  const long hw = (long)h * w;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hw) return;
  const float rho = nxt[blk].rho;
  const float inv_f = 1.0f / nxt[blk].factor;
  const int i = (int)(idx / w);
  const int j = (int)(idx % w);
  const int jr = j == w - 1 ? 0 : j + 1;
  const int id = i == h - 1 ? 0 : i + 1;
  const long plane = (long)p * hw;
  const long right = plane + (long)i * w + jr;
  const long down = plane + (long)id * w + j;
  const long at = plane + idx;
  const float uxs = unx[at] * inv_f;
  const float uys = uny[at] * inv_f;
  const float tx = zx_new[at] - uxs;
  const float ty = zy_new[at] - uys;
  const float tx_r = zx_new[right] - unx[right] * inv_f;
  const float ty_d = zy_new[down] - uny[down] * inv_f;
  s[at] = hty[at] + rho * (tx - tx_r + ty - ty_d);
  ux[at] = uxs;
  uy[at] = uys;
  zx[at] = zx_new[at];
  zy[at] = zy_new[at];
}

__global__ void stats_kernel(const BlockState* __restrict__ st, int n_blocks,
                             int* __restrict__ iters, float* __restrict__ stats) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  iters[b] = st[b].k;
  stats[b] = st[b].r;
  stats[n_blocks + b] = st[b].s;
  stats[2 * n_blocks + b] = st[b].rho;
}

int tiles_per_plane(int h, int w) { return (int)(((long)h * w + kThreads - 1) / kThreads); }

struct Buffers {
  float *zx1, *zy1, *ux1, *uy1, *s, *y, *partial;
};

cudaError_t launch_residual(int mode, const dim3& grid, const float* x, const float* ux,
                            const float* uy, const float* zx, const float* zy,
                            const BlockState* cur, const float* lmbd_rho0, const Buffers& wb,
                            int n_planes, int g, int h, int w, cudaStream_t stream) {
  switch (mode) {
    case admm::kAniso:
      residual_kernel<admm::kAniso><<<grid, kThreads, 0, stream>>>(
          x, ux, uy, zx, zy, cur, lmbd_rho0, wb.zx1, wb.zy1, wb.ux1, wb.uy1, wb.partial,
          n_planes, g, h, w);
      break;
    case admm::kSample:
      residual_kernel<admm::kSample><<<grid, kThreads, 0, stream>>>(
          x, ux, uy, zx, zy, cur, lmbd_rho0, wb.zx1, wb.zy1, wb.ux1, wb.uy1, wb.partial,
          n_planes, g, h, w);
      break;
    case admm::kJoint:
      residual_kernel<admm::kJoint><<<grid, kThreads, 0, stream>>>(
          x, ux, uy, zx, zy, cur, lmbd_rho0, wb.zx1, wb.zy1, wb.ux1, wb.uy1, wb.partial,
          n_planes, g, h, w);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace admm_tv_adaptive_solve needs: z, u' (4 planes sets),
// s, y and two transform intermediates (4 more), and the partial sums.
extern "C" long admm_tv_adaptive_workspace(int n_planes, int h, int w) {
  return 8L * n_planes * h * w + 2L * n_planes * tiles_per_plane(h, w);
}

// hty, x and the exit state zx, zy, ux, uy are (n_planes, h, w) f32; habs2
// and d2 are (h, w), pre-scaled by h*w; lmbd_rho0 = {lmbd, rho0} on the
// device. work holds admm_tv_adaptive_workspace floats; state 2 * n_blocks
// BlockStates; n_run one int on the device and host_run two pinned ints.
// Outputs iters (n_blocks,) int32 and stats (3, n_blocks) = r, s, rho.
extern "C" int admm_tv_adaptive_solve(
    const float* hty, const float* habs2, const float* d2, const float* m0, const float* m1,
    const float* m2, const float* m3, int n_mats, const float* lmbd_rho0, float* x,
    float* zx, float* zy, float* ux, float* uy, float* work, void* state, int* n_run,
    int* host_run, int* iters, float* stats, int n_planes, int g, int h, int w, int mode,
    int maxit, float tol, int adapt, float rho_mu, float rho_scale, int use_fast,
    float fast_switch, int fast_cap, float scale, int poll, void* stream_handle) {
  cudaStream_t stream = (cudaStream_t)stream_handle;
  if (n_mats != 2 && n_mats != 4) return (int)cudaErrorInvalidValue;
  if (g <= 0 || n_planes % g != 0 || poll <= 0 || n_planes > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = n_planes / g;
  const long hw = (long)h * w;
  const size_t bytes = (size_t)n_planes * hw * sizeof(float);
  const int tiles = tiles_per_plane(h, w);
  BlockState* st = (BlockState*)state;
  Buffers wb;
  float* planes[8];
  for (int i = 0; i < 8; ++i) planes[i] = work + i * (long)n_planes * hw;
  wb.zx1 = planes[0];
  wb.zy1 = planes[1];
  wb.ux1 = planes[2];
  wb.uy1 = planes[3];
  wb.s = planes[4];
  wb.y = planes[5];
  wb.partial = work + 8L * n_planes * hw;
  const tiled::Problem p{{m0, m1, m2, m3}, n_mats, n_planes, h, w, planes[7], planes[6],
                         stream};
  const Schedule sc{maxit, fast_cap, tol, fast_switch};
  const Adapt ad{adapt, rho_mu, rho_scale, 1.0f / rho_scale};

  for (float* t : {x, zx, zy, ux, uy}) cudaMemsetAsync(t, 0, bytes, stream);
  cudaMemcpyAsync(wb.s, hty, bytes, cudaMemcpyDeviceToDevice, stream);
  init_kernel<<<(n_blocks + 127) / 128, 128, 0, stream>>>(st, lmbd_rho0, n_blocks, use_fast, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // every block starts alike: the host knows whether the first runs
  BlockState first{0, use_fast, 0, 0, 1.0f, 1.0f, 0.0f, 1.0f};
  schedule(first, sc);
  const dim3 chain_grid((unsigned)tiles, (unsigned)n_planes);
  cudaEvent_t ready[2];
  for (auto& ev : ready) cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
  int it = 0, slot = 0, pending = -1;
  while (first.run && it < maxit && err == cudaSuccess) {
    const int chunk = poll < maxit - it ? poll : maxit - it;
    for (int c = 0; c < chunk && err == cudaSuccess; ++c, ++it) {
      const BlockState* cur = st + (it & 1) * n_blocks;
      BlockState* nxt = st + ((it & 1) ^ 1) * n_blocks;
      // the block's own spectrum in the first transform, none in the second
      const tiled::Spectrum spectrum{habs2, h, d2, cur, g};
      const tiled::Spectrum blocks{nullptr, 1, nullptr, cur, g};
      err = tiled::apply_left<tiled::kPerBlock>(p, wb.s, wb.y, spectrum);
      if (err == cudaSuccess) err = tiled::apply_left<tiled::kPerBlock>(p, wb.y, x, blocks);
      if (err == cudaSuccess)
        err = launch_residual(mode, chain_grid, x, ux, uy, zx, zy, cur, lmbd_rho0, wb,
                              n_planes, g, h, w, stream);
      if (err == cudaSuccess) {
        finalize_kernel<<<1, kThreads, 0, stream>>>(cur, nxt, wb.partial, n_blocks, g, tiles,
                                                    n_planes, scale, ad, sc, n_run);
        err = cudaGetLastError();
      }
      if (err == cudaSuccess) {
        rhs_kernel<<<chain_grid, kThreads, 0, stream>>>(hty, wb.zx1, wb.zy1, wb.ux1, wb.uy1,
                                                        cur, nxt, wb.s, ux, uy, zx, zy, g, h,
                                                        w);
        err = cudaGetLastError();
      }
    }
    if (err != cudaSuccess) break;
    cudaMemcpyAsync(host_run + slot, n_run, sizeof(int), cudaMemcpyDeviceToHost, stream);
    cudaEventRecord(ready[slot], stream);
    if (pending >= 0) {
      cudaEventSynchronize(ready[pending]);
      if (host_run[pending] == 0) break;
    }
    pending = slot;
    slot ^= 1;
  }
  for (auto& ev : ready) cudaEventDestroy(ev);
  if (err != cudaSuccess) return (int)err;
  // the state after the last launched iteration
  stats_kernel<<<(n_blocks + 127) / 128, 128, 0, stream>>>(st + (it & 1) * n_blocks, n_blocks,
                                                            iters, stats);
  return (int)cudaGetLastError();
}
