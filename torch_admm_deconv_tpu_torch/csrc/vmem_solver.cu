// K2 and K4: the whole fixed-iteration TV-ADMM solve.
//
// K2 (admm_tv_vmem_solve) replaces the TPU kernel
// torch_admm_deconv_tpu/kernels/vmem_solver.py (_make_kernel, reached
// through admm_tv_vmem -> _admm_tv_vmem_impl with schedule='batched').
// K4 (admm_tv_vmem_interleaved) replaces _make_interleaved_kernel, reached
// through admm_tv_vmem(schedule='interleaved') in aniso and 'joint' modes.
//
//   s <- hty, u <- 0
//   repeat maxit:  x = T((T s) * freq)      freq carries 1/(H*W)
//                  s, u <- chain(x, u)      (admm_chain.cuh, the K1 chain)
//   return x                                (zeros when maxit == 0)
//
// T is the separable cas transform T_h v T_w (2 products) when the PSF is
// absent or axis-symmetric, else the 2-D Hartley pair
// (T_h v) C_w + (T_h' v) S_w (4 products); the products are tiled_gemm.cuh's.
// K2's stage order follows the TPU kernel's `apply`: right (W-side) stage
// over all planes, then the per-plane left (H-side) stage on the cas path;
// both left stages, then the summed right stage on the Hartley path. The
// spectrum multiply is fused into the epilogue of the first transform's last
// stage.
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
// K4: on the TPU the interleaved schedule completes one plane's iteration
// before the next so that one plane's matrix-unit work overlaps another's
// vector tail. Its Hopper counterpart keeps K2's math with the TPU
// interleaved kernel's transform order (left stage first, _make_xform) and
// runs each packed group of planes (the TPU kernel's grid program) as its
// own sequence of product and chain launches on its own stream, so that one
// group's chain overlaps another's products. The streams wait on an event
// of the caller's stream at the start and the caller's stream waits on each
// of them at the end. Same bound as K2; at 256^2 the products are short and
// the solve is bound by launches.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <mutex>

#include "admm_chain.cuh"
#include "tiled_gemm.cuh"

namespace {

using tiled::kNoSpectrum;
using tiled::Problem;
using tiled::Spectrum;

Spectrum fixed_spectrum(const float* freq, int rows) {
  Spectrum sp = kNoSpectrum;
  sp.spec = freq;
  sp.rows = rows;
  return sp;
}

// dst = T(src) (* mult): one full transform over all planes, K2's order.
template <int ROUND>
cudaError_t apply_right(const Problem& p, const float* src, float* dst, const float* mult) {
  const long hw = (long)p.h * p.w;
  const Spectrum sp = fixed_spectrum(mult, p.h);
  cudaError_t err;
  if (p.n_mats == 2) {
    // right stage over the (planes*h, w) block, then the per-plane left stage
    err = tiled::gemm<ROUND>(src, p.mats[1], nullptr, nullptr, p.a, p.planes * p.h, p.w, p.w,
                             0, 0, 0, 1, kNoSpectrum, p.stream);
    if (err != cudaSuccess) return err;
    return tiled::gemm<ROUND>(p.mats[0], p.a, nullptr, nullptr, dst, p.h, p.w, p.h, 0, hw, hw,
                              p.planes, sp, p.stream);
  }
  // both per-plane left stages, then one summed right stage
  err = tiled::gemm<ROUND>(p.mats[0], src, nullptr, nullptr, p.d, p.h, p.w, p.h, 0, hw, hw,
                           p.planes, kNoSpectrum, p.stream);
  if (err != cudaSuccess) return err;
  err = tiled::gemm<ROUND>(p.mats[1], src, nullptr, nullptr, p.a, p.h, p.w, p.h, 0, hw, hw,
                           p.planes, kNoSpectrum, p.stream);
  if (err != cudaSuccess) return err;
  return tiled::gemm<ROUND>(p.d, p.mats[2], p.a, p.mats[3], dst, p.planes * p.h, p.w, p.w, 0,
                            0, 0, 1, sp, p.stream);
}

template <int ROUND>
cudaError_t x_update(const Problem& p, const float* s, const float* freq, float* y,
                     float* x, bool left_first) {
  cudaError_t err;
  if (left_first) {
    err = tiled::apply_left<ROUND>(p, s, y, fixed_spectrum(freq, p.h));
    if (err != cudaSuccess) return err;
    return tiled::apply_left<ROUND>(p, y, x, kNoSpectrum);
  }
  err = apply_right<ROUND>(p, s, y, freq);
  if (err != cudaSuccess) return err;
  return apply_right<ROUND>(p, y, x, nullptr);
}

// The planes [first, first + p.planes) of one solve: its buffers and stream.
struct Group {
  Problem p;
  const float* hty;
  float *out, *s, *ux0, *ux1, *uy0, *uy1, *y;
  int g;
};

Group group_at(const Problem& whole, int first, int planes, int g, const float* hty,
               float* out, float* s, float* ux0, float* ux1, float* uy0, float* uy1,
               float* y, cudaStream_t stream) {
  const long off = (long)first * whole.h * whole.w;
  Group gr;
  gr.p = whole;
  gr.p.planes = planes;
  gr.p.a = whole.a + off;
  gr.p.d = whole.d != nullptr ? whole.d + off : nullptr;
  gr.p.stream = stream;
  gr.hty = hty + off;
  gr.out = out + off;
  gr.s = s + off;
  gr.ux0 = ux0 + off;
  gr.ux1 = ux1 + off;
  gr.uy0 = uy0 + off;
  gr.uy1 = uy1 + off;
  gr.y = y + off;
  gr.g = g;
  return gr;
}

// Iteration `it` of one group's solve.
cudaError_t iterate(const Group& gr, const float* freq, const float* rho_tau, int mode,
                    int it, int fast_iters, bool left_first) {
  const float* s_in = it == 0 ? gr.hty : gr.s;  // x, z, u start at zero: RHS hty
  cudaError_t err = it < fast_iters
                        ? x_update<tiled::kFast>(gr.p, s_in, freq, gr.y, gr.out, left_first)
                        : x_update<tiled::kExact>(gr.p, s_in, freq, gr.y, gr.out, left_first);
  if (err != cudaSuccess) return err;
  float* ux[2] = {gr.ux0, gr.ux1};
  float* uy[2] = {gr.uy0, gr.uy1};
  const int cur = it & 1;
  return admm::launch_chain(mode, gr.out, ux[cur], uy[cur], gr.hty, rho_tau, gr.s,
                            ux[cur ^ 1], uy[cur ^ 1], gr.p.planes, gr.g, gr.p.h, gr.p.w,
                            gr.p.stream);
}

constexpr int kStreams = 8;  // groups beyond this many share streams
constexpr int kDevices = 16;

// The side streams of the current device, made on first use.
cudaStream_t* stream_pool() {
  static cudaStream_t pool[kDevices][kStreams];
  static std::once_flag once[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kDevices) return nullptr;
  std::call_once(once[dev], [dev] {
    for (auto& st : pool[dev]) cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  });
  return pool[dev];
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
  Problem whole{{m0, m1, m2, m3}, n_mats, n_planes, h, w, d, a, stream};
  cudaMemsetAsync(ux0, 0, bytes, stream);
  cudaMemsetAsync(uy0, 0, bytes, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Group gr = group_at(whole, 0, n_planes, g, hty, out, s, ux0, ux1, uy0, uy1, y, stream);
  for (int it = 0; it < maxit; ++it) {
    err = iterate(gr, freq, rho_tau, mode, it, fast_iters, false);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K4: the same buffers as admm_tv_vmem_solve; the planes run in groups of
// `pack` (a divisor of n_planes), each group on a stream of its own. Modes:
// aniso and 'joint' (per-plane shrinkage) only.
extern "C" int admm_tv_vmem_interleaved(const float* hty, const float* freq, const float* m0,
                                        const float* m1, const float* m2, const float* m3,
                                        int n_mats, const float* rho_tau, float* out,
                                        float* s, float* ux0, float* ux1, float* uy0,
                                        float* uy1, float* y, float* a, float* d,
                                        int n_planes, int pack, int h, int w, int mode,
                                        int maxit, int fast_iters, void* stream_handle) {
  cudaStream_t caller = (cudaStream_t)stream_handle;
  const size_t bytes = (size_t)n_planes * h * w * sizeof(float);
  if (n_mats != 2 && n_mats != 4) return (int)cudaErrorInvalidValue;
  if (mode == admm::kSample || pack <= 0 || n_planes % pack != 0)
    return (int)cudaErrorInvalidValue;
  if (maxit <= 0) {
    cudaMemsetAsync(out, 0, bytes, caller);
    return (int)cudaGetLastError();
  }
  cudaMemsetAsync(ux0, 0, bytes, caller);
  cudaMemsetAsync(uy0, 0, bytes, caller);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_groups = n_planes / pack;
  const int n_streams = n_groups < kStreams ? n_groups : kStreams;
  cudaStream_t* pool = stream_pool();
  if (pool == nullptr) return (int)cudaErrorInvalidDevice;
  cudaEvent_t start;
  cudaEventCreateWithFlags(&start, cudaEventDisableTiming);
  cudaEventRecord(start, caller);
  for (int i = 0; i < n_streams; ++i) cudaStreamWaitEvent(pool[i], start, 0);

  const Problem whole{{m0, m1, m2, m3}, n_mats, n_planes, h, w, d, a, caller};
  err = cudaGetLastError();
  // iteration-major launch order: the groups' launches interleave on the
  // host, so the card runs one group's chain beside another's products
  for (int it = 0; it < maxit && err == cudaSuccess; ++it) {
    for (int k = 0; k < n_groups && err == cudaSuccess; ++k) {
      const Group gr = group_at(whole, k * pack, pack, 1, hty, out, s, ux0, ux1, uy0, uy1,
                                y, pool[k % n_streams]);
      err = iterate(gr, freq, rho_tau, mode, it, fast_iters, true);
    }
  }
  // join even after a failed launch, so the caller's stream never runs
  // ahead of work already queued on the side streams
  for (int i = 0; i < n_streams; ++i) {
    cudaEvent_t done;
    cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
    cudaEventRecord(done, pool[i]);
    cudaStreamWaitEvent(caller, done, 0);
    cudaEventDestroy(done);  // released once the caller's stream has passed it
  }
  cudaEventDestroy(start);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
