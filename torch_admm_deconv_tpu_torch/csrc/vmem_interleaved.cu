// K4: the interleaved fixed-iteration TV-ADMM solve, one launch per solve.
//
// Replaces the TPU kernel torch_admm_deconv_tpu/kernels/vmem_solver.py
// (_make_interleaved_kernel, reached through admm_tv_vmem with
// schedule='interleaved' in aniso and 'joint' modes). Per plane:
//
//   s <- hty, u <- 0
//   repeat maxit:  x = T((T s) * freq)      freq carries 1/(H*W)
//                  s, u <- chain(x, u)      (the K1 chain)
//   return x                                (zeros when maxit == 0)
//
// T takes its left (H-side) stage first, as the TPU kernel's _make_xform:
// the cas transform (T_h v) T_w, or the Hartley pair
// (T_h v) C_w + (T_h' v) S_w. T_h' is T_h with its rows permuted,
// T_h'[k] = T_h[(H - k) % H] (ops/hartley.py), so T_h' v is T_h v with its
// rows permuted: the kernel computes T_h v once and reads its row
// (H - k) % H for row k of T_h' v. The m1 argument is not read.
//
// Design. The modes of K4 never couple planes, so each plane advances
// through its iterations alone: a thread-block cluster of CL CTAs owns a
// plane (clusters take planes in turn), and only the CL CTAs that share it
// ever synchronise, with cluster barriers (release / acquire), never with a
// grid barrier or the host. Clusters in different phases share the card:
// one plane's tensor-core stage runs beside another's chain. The unit of
// work is a plane, not the TPU kernel's packed group of `pack` planes: the
// group existed to fill a TPU grid program's VMEM, and a cluster's shared
// memory holds one plane. CTA r of a cluster keeps rows [r ms, (r+1) ms) of
// two plane buffers (the transform's operand and its stage result), so the
// state stays on chip:
//   left stage   Q = T_h S: its rows of T_h from L2, all of S from the
//                cluster's slabs through distributed shared memory;
//   right stage  S = Q T_w (* freq), or Q C_w + perm(Q) S_w: its own slab,
//                the permuted rows from the other slabs, T_w from L2;
//   chain        x from its slab and one halo row of each neighbouring CTA
//                (circular at the plane's edges), u in L2 (double-buffered
//                because neighbours read it), s' into the free slab.
// Five cluster barriers an iteration. A plane too large for the cluster's
// shared memory (2 ms W floats a CTA; 512^2 at CL = 8 needs 256 KB) keeps
// its two buffers in an L2 workspace instead: the same kernel, templated on
// ON_CHIP, with the same cluster synchronisation.
//
// Products run on the tensor cores with tiled_gemm.cuh's mma.sync
// fragments (32 x 128 output tiles, 64 x 128 where a CTA owns more than 32
// rows; 32 deep, two stages): 3xTF32 in 'high'
// (each operand split with split_tf32 as its fragment is read, each k8
// step's hi product taken from zero and added in f32, the small terms
// apart: tiled::compute_exact), one bf16 pass in the fast phase of 'mixed'.
// Operands reach shared memory through registers (16-byte loads where a row
// is aligned), the next stage's loads in flight under this stage's MMAs:
// cp.async cannot read distributed shared memory.
//
// Bound on the H100: operations, as K2 (4 products of 2 H W (H or W) flops
// a plane an iteration, three TF32 passes each in 'high').
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cooperative_groups.h>

#include "admm_chain.cuh"
#include "tiled_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = tiled::THREADS;
// A CTA's output tile: 32 rows where it owns 32 rows or fewer (two CTAs an
// SM at 128 registers), 64 where it owns more (one CTA an SM): a 64-row
// tile loads 1.7x fewer floats per multiply-add. 128 columns, 32 deep.
using SmallTile = tiled::Tile<32, 128, 32, 2>;  // A [32][36], B [32][136]; no lo stage
using BigTile = tiled::Tile<64, 128, 32, 2>;
template <class T>
struct Staging {
  static constexpr int STAGE = T::A_FLOATS + T::B_FLOATS;
  static constexpr int RING = 2 * STAGE;
  static constexpr int A_VEC = T::BM * T::BK / 4 / THREADS;  // float4 a thread per A stage
  static constexpr int A_ROW4 = T::BK / 4;                   // float4 in a row of an A stage
  static constexpr int B_VEC = T::BK * T::BN / 4 / THREADS;
  static constexpr int B_ROW4 = T::BN / 4;
  static_assert(A_VEC * THREADS * 4 == T::BM * T::BK && B_VEC * THREADS * 4 == T::BK * T::BN,
                "staging assumes 256 threads");
};
constexpr size_t SMEM_LIMIT = 232448;

struct Params {
  const float* hty;
  const float* freq;
  const float* m[4];  // th, (thp, not read), tw | cw, sw
  int n_mats;
  const float* rho_tau;
  float* out;
  float *ux[2], *uy[2];
  float* slabs;  // L2 path: (n_planes, 2, h, lds); null on chip
  unsigned long long* stage_ns;
  int n_planes, h, w, lds, ms, maxit, fast_iters;
};

// The plane a cluster works on: row i of buffer b, wherever it lives.
template <bool ON_CHIP>
struct Plane {
  float* buf[2];  // on chip: this CTA's slabs; in L2: the plane's buffers
  int ms, lds, rank;
  float inv_ms;   // 1 / ms: the owner of row i is (i + 1/2) / ms rounded down, exact
                  // in float32 since the quotient is below the cluster size

  __device__ float* row(int b, int i) const {
    if (ON_CHIP) {
      const int owner = __float2int_rz(((float)i + 0.5f) * inv_ms);
      float* local = buf[b] + (i - owner * ms) * lds;
      if (owner == rank) return local;
      cg::cluster_group cluster = cg::this_cluster();
      return cluster.map_shared_rank(local, owner);
    }
    return buf[b] + (long)i * lds;
  }
  // row r0 + li of buffer b, owned by this CTA
  __device__ float* own(int b, int li) const {
    return ON_CHIP ? buf[b] + li * lds : buf[b] + (long)(rank * ms + li) * lds;
  }
};

// Loads of values other CTAs of the cluster wrote during the launch: from
// distributed shared memory, or from L2 past the SM's L1 (not coherent).
template <bool ON_CHIP>
__device__ __forceinline__ float4 ld_state4(const float* p) {
  return ON_CHIP ? *reinterpret_cast<const float4*>(p) : __ldcg(reinterpret_cast<const float4*>(p));
}
template <bool ON_CHIP>
__device__ __forceinline__ float ld_state(const float* p) {
  return ON_CHIP ? *p : __ldcg(p);
}

// An operand's rows: a matrix in device memory, or a plane buffer (rows
// permuted k -> (h - k) % h for the Hartley pair's T_h' v).
struct Rows {
  const float* m;  // matrix, row-major with leading dimension ld; null: buffer
  int ld, buf, perm;
};

template <bool ON_CHIP>
__device__ __forceinline__ const float* row_of(const Plane<ON_CHIP>& pl, const Rows& src, int k,
                                               int h) {
  if (src.m != nullptr) return src.m + (long)k * src.ld;
  return pl.row(src.buf, src.perm ? (k == 0 ? 0 : h - k) : k);
}

// 4 floats at columns c .. c + 3 of a row, zero past `cols`.
template <bool ON_CHIP>
__device__ __forceinline__ float4 load4(const float* p, int c, int cols, bool vec, bool state) {
  if (vec && c + 3 < cols) return state ? ld_state4<ON_CHIP>(p + c) : *reinterpret_cast<const float4*>(p + c);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = c + q < cols ? (state ? ld_state<ON_CHIP>(p + c + q) : p[c + q]) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

struct Product {
  Rows a[2], b[2];  // a[1], b[1]: the second term of the Hartley pair
  int terms, k, n;
  int dst;           // buffer of the output rows
  const float* spec;  // null, or (h, w) multiplied in the epilogue
};

// This CTA's rows of one product stage, tile by tile.
template <class T, bool ON_CHIP>
__device__ void product(const Plane<ON_CHIP>& pl, const Product& pr, int rows, int h, bool fast,
                        float* ring) {
  using S = Staging<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp >> 2) * T::WM, wn0 = (warp & 3) * T::WN;
  const int r0 = pl.rank * pl.ms;
  const int tiles_m = (rows + T::BM - 1) / T::BM, tiles_n = (pr.n + T::BN - 1) / T::BN;
  const int kt = (pr.k + T::BK - 1) / T::BK;
  const int steps = pr.terms * kt;

  // Every CTA of every cluster reads the same matrix tiles: each starts its
  // tiles and its depth steps at its own offset, so that they do not all
  // ask L2 (and one CTA's slab) for the same lines at once. The depth
  // rotation changes the order of a product's float32 sums from CTA to CTA.
  const int n_tiles = tiles_m * tiles_n;
  const int rot = (int)blockIdx.x;
  for (int tile0 = 0; tile0 < n_tiles; ++tile0) {
    const int tile = (tile0 + rot) % n_tiles;
    const int tm = tile / tiles_n, tn = tile % tiles_n;
    const int row0 = tm * T::BM, col0 = tn * T::BN;
    float acc[T::MI][T::NI][4], small[T::MI][T::NI][4];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = small[mi][ni][q] = 0.0f;

    // thread tid stages float4 number tid + 256 q of an A stage (A_ROW4 a
    // row) and of a B stage (B_ROW4 a row)
    float4 ra[S::A_VEC], rb[S::B_VEC];
    auto load = [&](int step) {
      const int term = step / kt;
      const int k0 = (step % kt + rot) % kt * T::BK;
      const Rows& A = pr.a[term];
      const Rows& B = pr.b[term];
      const bool avec = A.m == nullptr || (A.ld & 3) == 0;
#pragma unroll
      for (int q = 0; q < S::A_VEC; ++q) {
        const int l = threadIdx.x + q * THREADS;
        const int r = row0 + l / S::A_ROW4, c = k0 + l % S::A_ROW4 * 4;
        ra[q] = r < rows ? load4<ON_CHIP>(row_of(pl, A, r0 + r, h), c, pr.k, avec, A.m == nullptr)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      const bool bvec = B.m == nullptr || (B.ld & 3) == 0;
#pragma unroll
      for (int q = 0; q < S::B_VEC; ++q) {
        const int l = threadIdx.x + q * THREADS;
        const int r = k0 + l / S::B_ROW4, c = col0 + l % S::B_ROW4 * 4;
        rb[q] = r < pr.k ? load4<ON_CHIP>(row_of(pl, B, r, h), c, pr.n, bvec, B.m == nullptr)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    };
    auto store = [&](int stage) {
      float* As = ring + stage * S::STAGE;
      float* Bs = As + T::A_FLOATS;
#pragma unroll
      for (int q = 0; q < S::A_VEC; ++q) {
        const int l = threadIdx.x + q * THREADS;
        *reinterpret_cast<float4*>(As + l / S::A_ROW4 * T::LDA + l % S::A_ROW4 * 4) = ra[q];
      }
#pragma unroll
      for (int q = 0; q < S::B_VEC; ++q) {
        const int l = threadIdx.x + q * THREADS;
        *reinterpret_cast<float4*>(Bs + l / S::B_ROW4 * T::LDB + l % S::B_ROW4 * 4) = rb[q];
      }
    };

    load(0);
    store(0);
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      if (step + 1 < steps) load(step + 1);  // in flight under this step's products
      const float* As = ring + (step & 1) * S::STAGE;
      const float* Bs = As + T::A_FLOATS;
      if (fast)
        tiled::compute_fast<T>(As, Bs, acc, wm0, wn0, g, t);
      else
        tiled::compute_exact<T, 0>(As, Bs, As, acc, small, wm0, wn0, g, t);
      if (step + 1 < steps) store((step + 1) & 1);
      __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int li = row0 + wm0 + mi * 16 + g + half * 8;
          const int col = col0 + wn0 + ni * 8 + 2 * t;
          if (li >= rows) continue;
          float* out = pl.own(pr.dst, li);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= pr.n) continue;
            // the small terms' sum first, then the hi products (0 + v in bf16)
            float v = small[mi][ni][2 * half + e] + acc[mi][ni][2 * half + e];
            if (pr.spec != nullptr) v *= pr.spec[(long)(r0 + li) * pr.n + col + e];
            out[col + e] = v;
          }
        }
  }
}

// The chain on this CTA's rows: x in buffer xb (halo rows from the
// neighbouring CTAs), u[cur] -> u[cur ^ 1] in L2, s' into buffer sb; x to
// `out` on the last iteration. Each thread takes whole pixels, neighbouring
// threads neighbouring columns.
template <int MODE, bool ON_CHIP>
__device__ void chain(const Plane<ON_CHIP>& pl, const Params& p, int rows, int xb, int sb,
                      int cur, const float* hty, float* out, long plane, float rho, float tau) {
  const int h = p.h, w = p.w;
  const int r0 = pl.rank * pl.ms;
  const float *ux = p.ux[cur] + plane, *uy = p.uy[cur] + plane;
  float *uxo = p.ux[cur ^ 1] + plane, *uyo = p.uy[cur ^ 1] + plane;
  for (int li = 0; li < rows; ++li) {
    const int i = r0 + li;
    const int iu = i == 0 ? h - 1 : i - 1, id = i == h - 1 ? 0 : i + 1;
    const float* xr = pl.own(xb, li);
    const float* xu = pl.row(xb, iu);
    const float* xd = pl.row(xb, id);
    float* sr = pl.own(sb, li);
    for (int j = threadIdx.x; j < w; j += THREADS) {
      const int jl = j == 0 ? w - 1 : j - 1, jr = j == w - 1 ? 0 : j + 1;
      const float xc = xr[j];
      const long at = (long)i * w + j, at_r = (long)i * w + jr, at_d = (long)id * w + j;
      float zx, zy, zxr, zyr, zxd, zyd;
      // (i, j)
      const float ax = (xc - xr[jl]) + ld_state<false>(ux + at);
      const float ay = (xc - ld_state<ON_CHIP>(xu + j)) + ld_state<false>(uy + at);
      admm::shrink_pixel<MODE>(ax, ay, tau, zx, zy);
      // (i, j + 1): its t_x
      const float xcr = xr[jr];
      const float axr = (xcr - xc) + ld_state<false>(ux + at_r);
      const float ayr = (xcr - ld_state<ON_CHIP>(xu + jr)) + ld_state<false>(uy + at_r);
      admm::shrink_pixel<MODE>(axr, ayr, tau, zxr, zyr);
      // (i + 1, j): its t_y
      const float xcd = ld_state<ON_CHIP>(xd + j);
      const float axd = (xcd - ld_state<ON_CHIP>(xd + jl)) + ld_state<false>(ux + at_d);
      const float ayd = (xcd - xc) + ld_state<false>(uy + at_d);
      admm::shrink_pixel<MODE>(axd, ayd, tau, zxd, zyd);
      const float uxn = ax - zx, uyn = ay - zy;
      const float tx = zx - uxn, ty = zy - uyn;
      const float txr = zxr - (axr - zxr), tyd = zyd - (ayd - zyd);
      sr[j] = hty[at] + rho * (tx - txr + ty - tyd);
      uxo[at] = uxn;
      uyo[at] = uyn;
      if (out != nullptr) out[at] = xc;
    }
  }
}

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

template <int MODE, bool ON_CHIP, class T, int MIN_CTAS>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) k4_persistent(const __grid_constant__ Params p) {
  extern __shared__ float4 smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n_clusters = gridDim.x / cl;
  const int cluster_id = blockIdx.x / cl;
  const int h = p.h, w = p.w;
  const long hw = (long)h * w;
  const int rows = max(0, min(p.ms, h - rank * p.ms));
  const float rho = p.rho_tau[0], tau = p.rho_tau[1];
  tiled::StageClock clock(p.stage_ns);

  Plane<ON_CHIP> pl;
  pl.ms = p.ms;
  pl.lds = p.lds;
  pl.rank = rank;
  pl.inv_ms = 1.0f / (float)p.ms;
  const bool pair = p.n_mats == 4;
  // left stage: rows of T_h times the whole operand; right stage: the own
  // slab times T_w, or times C_w plus the permuted rows times S_w
  Product left{}, right{};
  left.terms = 1;
  left.k = h;
  left.n = w;
  left.a[0] = Rows{p.m[0], h, 0, 0};
  right.terms = pair ? 2 : 1;
  right.k = w;
  right.n = w;
  right.b[0] = Rows{p.m[pair ? 2 : 1], w, 0, 0};
  right.b[1] = Rows{pair ? p.m[3] : nullptr, w, 0, 0};

  for (int plane = cluster_id; plane < p.n_planes; plane += n_clusters) {
    const long off = plane * hw;
    if (ON_CHIP) {
      pl.buf[0] = ring + Staging<T>::RING;
      pl.buf[1] = pl.buf[0] + p.ms * p.lds;
    } else {
      pl.buf[0] = p.slabs + (long)plane * 2 * h * p.lds;
      pl.buf[1] = pl.buf[0] + (long)h * p.lds;
    }
    // s <- hty, u <- 0 on this CTA's rows
    for (int idx = threadIdx.x; idx < rows * w; idx += THREADS) {
      const int li = idx / w, j = idx % w;
      const long at = off + (long)(rank * p.ms + li) * w + j;
      pl.own(0, li)[j] = p.hty[at];
      p.ux[0][at] = 0.0f;
      p.uy[0][at] = 0.0f;
    }
    cluster_sync();  // also: the previous plane's readers are done
    clock.mark(0);
    int src = 0;
    for (int it = 0; it < p.maxit; ++it) {
      const bool fast = it < p.fast_iters;
      const int other = src ^ 1;
      left.b[0] = Rows{nullptr, 0, src, 0};
      left.dst = other;
      right.a[0] = Rows{nullptr, 0, other, 0};
      right.a[1] = Rows{nullptr, 0, other, 1};
      right.dst = src;
      // y = T(s) * freq, then x = T(y), both left stage first
      for (int tr = 0; tr < 2; ++tr) {
        left.spec = nullptr;
        product<T, ON_CHIP>(pl, left, rows, h, fast, ring);
        cluster_sync();
        clock.mark(1 + 2 * tr);
        right.spec = tr == 0 ? p.freq : nullptr;
        product<T, ON_CHIP>(pl, right, rows, h, fast, ring);
        cluster_sync();
        clock.mark(2 + 2 * tr);
      }
      chain<MODE, ON_CHIP>(pl, p, rows, src, other, it & 1, p.hty + off,
                           it == p.maxit - 1 ? p.out + off : nullptr, off, rho, tau);
      cluster_sync();
      clock.mark(5);
      src = other;
    }
  }
}

// The launch's shape: cluster size, where the planes live, the clusters.
struct Config {
  int cl, on_chip, big, ms, lds, n_clusters;
  size_t smem;
};

// p == null: *clusters receives how many clusters of c.cl CTAs of the
// kernel for c fit on the card at once; else the launch with p.
template <int MODE, bool ON_CHIP>
cudaError_t clustered(const Config& c, const Params* p, int* clusters, cudaStream_t stream) {
  auto kernel = c.big ? k4_persistent<MODE, ON_CHIP, BigTile, 1>
                      : k4_persistent<MODE, ON_CHIP, SmallTile, 2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p == nullptr ? c.cl : c.n_clusters * c.cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (p == nullptr) return cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, *p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t clustered(int mode, const Config& c, const Params* p, int* clusters,
                      cudaStream_t stream) {
  if (mode == admm::kAniso)
    return c.on_chip ? clustered<admm::kAniso, true>(c, p, clusters, stream)
                     : clustered<admm::kAniso, false>(c, p, clusters, stream);
  return c.on_chip ? clustered<admm::kJoint, true>(c, p, clusters, stream)
                   : clustered<admm::kJoint, false>(c, p, clusters, stream);
}

Config shape(int cl, int h, int w, bool on_chip) {
  Config c{};
  c.cl = cl;
  c.on_chip = on_chip;
  c.ms = (h + cl - 1) / cl;
  c.big = c.ms > SmallTile::BM;
  c.lds = (w + 3) & ~3;
  c.smem = (size_t)(c.big ? Staging<BigTile>::RING : Staging<SmallTile>::RING) * sizeof(float) +
           (on_chip ? 2 * (size_t)c.ms * c.lds * sizeof(float) : 0);
  return c;
}

// The cluster size in {2, 4, 8} under which an SM works through the fewest
// plane rows (the rows a CTA owns, times the CTAs an SM holds at once,
// times the rounds the clusters take over the planes), the 64-row tile on
// a tie (its loads per multiply-add are fewer), then the smaller cluster.
// The planes stay on chip where the cluster's shared memory holds them.
cudaError_t choose(int n_planes, int h, int w, int mode, Config* out) {
  const int sizes[3] = {2, 4, 8};
  const long sms = tiled::sm_count();
  long best = -1;
  for (int on_chip = 1; on_chip >= 0 && best < 0; --on_chip) {
    for (int cl : sizes) {
      Config c = shape(cl, h, w, on_chip != 0);
      if (c.smem > SMEM_LIMIT) continue;
      int clusters = 0;
      const cudaError_t err = clustered(mode, c, nullptr, &clusters, nullptr);
      if (err != cudaSuccess) return err;
      if (clusters < 1) continue;
      c.n_clusters = clusters < n_planes ? clusters : n_planes;
      const long per_sm = ((long)c.n_clusters * c.cl + sms - 1) / sms;
      const long rounds = (n_planes + c.n_clusters - 1) / c.n_clusters;
      const long rows = 2 * (long)c.ms * per_sm * rounds - c.big;  // the big tile wins a tie
      if (best < 0 || rows < best) {
        *out = c;
        best = rows;
      }
    }
  }
  return best >= 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The L2 plane buffers follow the four u planes, 16-byte aligned.
long slab_offset(int n_planes, int h, int w) { return (4L * n_planes * h * w + 3) & ~3L; }

}  // namespace

// Floats of the workspace a solve needs: u_x and u_y twice, and the two
// plane buffers where the planes do not fit the clusters' shared memory.
extern "C" long admm_tv_vmem_interleaved_workspace(int n_planes, int h, int w, int mode) {
  Config c{};
  if (choose(n_planes, h, w, mode, &c) != cudaSuccess) return -1;
  return slab_offset(n_planes, h, w) + (c.on_chip ? 0 : 2L * n_planes * h * c.lds);
}

// hty and out are (n_planes, h, w) f32; freq is (h, w) and carries 1/(h*w);
// m0..m3 the transform matrices (cas: th, tw; Hartley pair: th, thp, cw,
// sw, with thp[k] = th[(h - k) % h]: m1 is not read); rho_tau = {rho, tau}
// on the device; work holds admm_tv_vmem_interleaved_workspace floats.
// pack: the planes of a TPU grid program (a divisor of n_planes); the unit
// here is a plane, so it is only checked.
// stage_ns: null, or 6 zeroed counters that receive cluster 0's device
// nanoseconds of the prologue, the four product stages and the chain,
// summed over its planes and iterations. Modes: aniso and 'joint'.
extern "C" int admm_tv_vmem_interleaved(const float* hty, const float* freq, const float* m0,
                                        const float* m1, const float* m2, const float* m3,
                                        int n_mats, const float* rho_tau, float* out,
                                        float* work, unsigned long long* stage_ns, int n_planes,
                                        int pack, int h, int w, int mode, int maxit,
                                        int fast_iters, void* stream_handle) {
  cudaStream_t stream = (cudaStream_t)stream_handle;
  if (n_mats != 2 && n_mats != 4) return (int)cudaErrorInvalidValue;
  if (mode != admm::kAniso && mode != admm::kJoint) return (int)cudaErrorInvalidValue;
  if (pack <= 0 || n_planes <= 0 || n_planes % pack != 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  if (maxit <= 0) {
    cudaMemsetAsync(out, 0, (size_t)n_planes * h * w * sizeof(float), stream);
    return (int)cudaGetLastError();
  }
  Config c{};
  cudaError_t err = choose(n_planes, h, w, mode, &c);
  if (err != cudaSuccess) return (int)err;
  const long planes = (long)n_planes * h * w;
  Params p{};
  p.hty = hty;
  p.freq = freq;
  p.m[0] = m0;
  p.m[1] = m1;
  p.m[2] = m2;
  p.m[3] = m3;
  p.n_mats = n_mats;
  p.rho_tau = rho_tau;
  p.out = out;
  for (int i = 0; i < 2; ++i) {
    p.ux[i] = work + i * planes;
    p.uy[i] = work + (2 + i) * planes;
  }
  p.slabs = c.on_chip ? nullptr : work + slab_offset(n_planes, h, w);
  p.stage_ns = stage_ns;
  p.n_planes = n_planes;
  p.h = h;
  p.w = w;
  p.lds = c.lds;
  p.ms = c.ms;
  p.maxit = maxit;
  p.fast_iters = fast_iters;
  return (int)clustered(mode, c, &p, nullptr, stream);
}
