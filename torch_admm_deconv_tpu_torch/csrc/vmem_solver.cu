// K2: the whole fixed-iteration TV-ADMM solve.
//
// K2 (admm_tv_vmem_solve) replaces the TPU kernel
// torch_admm_deconv_tpu/kernels/vmem_solver.py (_make_kernel, reached
// through admm_tv_vmem -> _admm_tv_vmem_impl with schedule='batched').
// K4, the interleaved schedule, is vmem_interleaved.cu.
//
//   s <- hty, u <- 0
//   repeat maxit:  x = T((T s) * freq)      freq carries 1/(H*W)
//                  s, u <- chain(x, u)      (admm_chain.cuh, the K1 chain)
//   return x                                (zeros when maxit == 0)
//
// T is the separable cas transform T_h v T_w (2 products) when the PSF is
// absent or axis-symmetric, else the 2-D Hartley pair
// (T_h v) C_w + (T_h' v) S_w (4 products); the products are tiled_gemm.cuh's
// tensor-core tiles (3xTF32 exact, one bf16 pass in the fast phase).
// K2's stage order follows the TPU kernel's `apply`: right (W-side) stage
// over all planes, then the per-plane left (H-side) stage on the cas path;
// both left stages, then the summed right stage on the Hartley path. The
// spectrum multiply is fused into the epilogue of the first transform's last
// stage.
//
// Bound on the H100: operations. At (1, 3, 256, 256) and 100 iterations the
// cas path does 4 products of 2*256^3 flops per plane per iteration, about
// 40 GFLOP a solve (x3 as 3xTF32 tensor-core passes) on ~5 MB of state. A
// TPU block keeps its state in VMEM; a 256^2 f32 plane (256 KB) exceeds a
// block's 227 KB of shared memory, so here the state (s, u, y, a, hty) and
// the matrices stay in the 50 MB L2 instead. K2 is one cooperative launch
// per solve: a CTA per resident slot walks the tiles of each product stage
// and the pixels of the chain stage, and a grid barrier (which also orders
// the memory: the chain reads neighbours other CTAs wrote) separates the 5
// stages of an iteration, so no host loop and no launch gaps remain. The
// matrices are split into their tf32 halves once, in the launch's prologue.
// The product tiles shrink to 32 x 32 when 64 x 64 would leave SMs idle.
// u is double-buffered because neighbours read it.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "admm_chain.cuh"
#include "tiled_gemm.cuh"

namespace {

using tiled::Gemm;
using tiled::Mats;

struct Fixed {
  Mats mats;
  // the 4 product stages of an iteration: T1 (s -> y, * freq), T2 (y -> x);
  // stage 1 of T1 reads hty in the first iteration, s after
  Gemm t1a[2][2], t1b, t2a[2], t2b;
  int n_a;  // jobs in a transform's first stage
  const float* hty;
  const float* rho_tau;
  float *out, *s, *ux[2], *uy[2];
  unsigned long long* stage_ns;  // K2_STAGES slots, or null
  int planes, g, h, w, mode, maxit, fast_iters;
};

// stage_ns slots: prologue, the 4 product stages, the chain
constexpr int K2_STAGES = 6;

// dst = T(src) (* mult) in K2's order; returns the jobs of its first stage.
int right_first_stages(const Mats& mats, int planes, int h, int w, const float* src, float* dst,
                       const float* mult, float* a, float* d, Gemm* first, Gemm* last) {
  const long hw = (long)h * w;
  if (mats.n == 2) {
    // right stage over the (planes*h, w) block, then the per-plane left stage
    first[0] = Gemm{tiled::Operand{src, nullptr, nullptr, 0}, tiled::matrix(mats, 1),
                    tiled::kNone, tiled::kNone, a, 0, planes * h, w, w, 1, nullptr, 1, nullptr};
    *last = Gemm{tiled::matrix(mats, 0), tiled::planes_of(a, hw), tiled::kNone, tiled::kNone,
                 dst, hw, h, w, h, planes, mult, h, nullptr};
    return 1;
  }
  // both per-plane left stages, then one summed right stage
  first[0] = Gemm{tiled::matrix(mats, 0), tiled::planes_of(src, hw), tiled::kNone, tiled::kNone,
                  d, hw, h, w, h, planes, nullptr, 1, nullptr};
  first[1] = Gemm{tiled::matrix(mats, 1), tiled::planes_of(src, hw), tiled::kNone, tiled::kNone,
                  a, hw, h, w, h, planes, nullptr, 1, nullptr};
  *last = Gemm{tiled::Operand{d, nullptr, nullptr, 0}, tiled::matrix(mats, 2),
               tiled::Operand{a, nullptr, nullptr, 0}, tiled::matrix(mats, 3), dst, 0,
               planes * h, w, w, 1, mult, h, nullptr};
  return 2;
}

template <int MODE>
__device__ void chain_pass(const Fixed& p, int cur) {
  // kUnroll pixels a thread: their loads issue before any of their stores
  constexpr int kUnroll = 2;
  const long hw = (long)p.h * p.w;
  const long total = hw * p.planes;
  const long stride = (long)gridDim.x * blockDim.x;
  const float rho = p.rho_tau[0], tau = p.rho_tau[1];
  const float *ux = p.ux[cur], *uy = p.uy[cur];
  float *uxo = p.ux[cur ^ 1], *uyo = p.uy[cur ^ 1];
  for (long at0 = (long)blockIdx.x * blockDim.x + threadIdx.x; at0 < total;
       at0 += kUnroll * stride) {
    float sv[kUnroll], uxv[kUnroll], uyv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long at = at0 + q * stride;
      if (at < total) {
        const int plane = (int)(at / hw);
        admm::chain_eval<MODE>(p.out, ux, uy, p.hty, rho, tau, plane, p.g, p.h, p.w,
                               at - plane * hw, sv[q], uxv[q], uyv[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long at = at0 + q * stride;
      if (at < total) {
        p.s[at] = sv[q];
        uxo[at] = uxv[q];
        uyo[at] = uyv[q];
      }
    }
  }
}

__device__ void chain_stage(const Fixed& p, int cur) {
  switch (p.mode) {
    case admm::kAniso:
      chain_pass<admm::kAniso>(p, cur);
      break;
    case admm::kSample:
      chain_pass<admm::kSample>(p, cur);
      break;
    default:
      chain_pass<admm::kJoint>(p, cur);
  }
}

// K2: the whole solve in one cooperative launch.
template <class T>
__global__ void __launch_bounds__(tiled::THREADS, tiled::MIN_CTAS)
k2_persistent(const __grid_constant__ Fixed p) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  tiled::StageClock clock(p.stage_ns);
  const tiled::Blocks uniform{nullptr, 1};
  tiled::split_matrices(p.mats);
  const long total = (long)p.h * p.w * p.planes;
  for (long at = (long)blockIdx.x * blockDim.x + threadIdx.x; at < total;
       at += (long)gridDim.x * blockDim.x) {
    p.ux[0][at] = 0.0f;
    p.uy[0][at] = 0.0f;
  }
  grid.sync();
  clock.mark(0);
  for (int it = 0; it < p.maxit; ++it) {
    const bool fast = it < p.fast_iters;
    tiled::run_stage<T>(p.t1a[it == 0 ? 0 : 1], p.n_a, fast, uniform, smem);
    grid.sync();
    clock.mark(1);
    tiled::run_stage<T>(&p.t1b, 1, fast, uniform, smem);
    grid.sync();
    clock.mark(2);
    tiled::run_stage<T>(p.t2a, p.n_a, fast, uniform, smem);
    grid.sync();
    clock.mark(3);
    tiled::run_stage<T>(&p.t2b, 1, fast, uniform, smem);
    grid.sync();
    clock.mark(4);
    chain_stage(p, it & 1);
    grid.sync();
    clock.mark(5);
  }
}

template <class T>
cudaError_t launch_k2(const Fixed& p, cudaStream_t stream) {
  return tiled::launch_cooperative(k2_persistent<T>, p, T::SMEM, stream);
}

}  // namespace

// Floats of the matrices' tf32 halves a solve needs in `split`.
extern "C" long admm_tv_vmem_split_floats(int h, int w) { return 4L * ((long)h * h + (long)w * w); }

// hty, out and the scratch planes s, ux0, ux1, uy0, uy1, y, a are
// (n_planes, h, w) f32; d only on the Hartley-pair path (n_mats == 4),
// else null. freq is (h, w) and carries 1/(h*w). rho_tau = {rho, tau}.
// split holds admm_tv_vmem_split_floats(h, w) floats. stage_ns: null, or 6
// zeroed counters that receive the device nanoseconds of the prologue, the
// four product stages and the chain, summed over the iterations.
extern "C" int admm_tv_vmem_solve(const float* hty, const float* freq, const float* m0,
                                  const float* m1, const float* m2, const float* m3,
                                  int n_mats, const float* rho_tau, float* out, float* s,
                                  float* ux0, float* ux1, float* uy0, float* uy1,
                                  float* y, float* a, float* d, float* split,
                                  unsigned long long* stage_ns, int n_planes,
                                  int g, int h, int w, int mode, int maxit, int fast_iters,
                                  void* stream_handle) {
  cudaStream_t stream = (cudaStream_t)stream_handle;
  if (n_mats != 2 && n_mats != 4) return (int)cudaErrorInvalidValue;
  if (mode != admm::kAniso && mode != admm::kSample && mode != admm::kJoint)
    return (int)cudaErrorInvalidValue;
  if (maxit <= 0) {
    cudaMemsetAsync(out, 0, (size_t)n_planes * h * w * sizeof(float), stream);
    return (int)cudaGetLastError();
  }
  const float* m[4] = {m0, m1, m2, m3};
  Fixed p{};
  p.mats = tiled::make_mats(m, n_mats, h, w, split);
  for (int first = 0; first < 2; ++first)
    p.n_a = right_first_stages(p.mats, n_planes, h, w, first == 0 ? hty : s, y, freq, a, d,
                               p.t1a[first], &p.t1b);
  right_first_stages(p.mats, n_planes, h, w, y, out, nullptr, a, d, p.t2a, &p.t2b);
  p.hty = hty;
  p.rho_tau = rho_tau;
  p.out = out;
  p.s = s;
  p.ux[0] = ux0;
  p.ux[1] = ux1;
  p.uy[0] = uy0;
  p.uy[1] = uy1;
  p.stage_ns = stage_ns;
  p.planes = n_planes;
  p.g = g;
  p.h = h;
  p.w = w;
  p.mode = mode;
  p.maxit = maxit;
  p.fast_iters = fast_iters;
  const cudaError_t err = tiled::big_tiles(n_planes, h, w) ? launch_k2<tiled::BigTile>(p, stream)
                                                           : launch_k2<tiled::SmallTile>(p, stream);
  return (int)err;
}
