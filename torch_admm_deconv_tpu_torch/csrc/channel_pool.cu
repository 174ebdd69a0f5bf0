// The spatial gates' channel pool: per-pixel median and mode across channels.
//
// Replaces no TPU kernel. The JAX package's channel_pool
// (torch_admm_deconv_tpu/models/attention.py:229) sorts a (B*H*W, C) view
// and finds the mode from the sorted rows, which XLA fuses on the TPU. On the
// card the same code is torch.sort's key-value radix sort, a cummax scan and
// a dozen int64 passes over the rows: about 0.65 ms a gate at
// (1, 86, 256, 256), the largest part of a flagship request's glue.
//
// Bound on the H100: memory bytes. A call reads B*C*H*W floats once and
// writes two B*H*W planes (22.5 MB at the flagship's gates, about 7 us at
// 3.35 TB/s). The selection itself is integer compare-and-swap, a few
// thousand a pixel, on the SMs' integer pipes.
//
// Design: one thread a pixel, neighbouring threads on neighbouring pixels,
// so each channel's loads are coalesced. A thread loads its C values as
// order-preserving 32-bit keys: -0 as +0, and each NaN as a key of its own
// above +inf's, in channel order, so NaN sorts last, in the order a stable
// sort leaves it, and is a run of one. It sorts them with Batcher's odd-even
// merge network, then one unrolled pass over the sorted keys takes the
// median at (C-1)/2 and the first longest run of equal keys: the smallest of
// the most frequent values. Every comparator puts the smaller key at the
// lower index, so a network of the next power of two P sorts NC <= P keys
// once the comparators that reach past NC, and the sub-networks that lie
// there, are left out; that is done at compile time for NC, C rounded up to
// 8 or a multiple of 16, and the NC - C positions above C hold keys of their
// own above every NaN's. Nothing but the two planes is written, and the keys
// stay in registers (constant indices after unrolling). For 129 <= C <= 256
// they live in shared memory, one column per thread, and the same network
// runs as loops that leave out what reaches past C. When the caller needs a
// gradient, a second pass over the pixel's values (cache hits) writes the
// channel of each selected element: the median's by its stable rank, the
// mode's as the first channel holding its key.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 256;
constexpr int REG_THREADS = 128;
constexpr int SMEM_THREADS = 32;
constexpr uint32_t OWN_KEYS = 0xffffff00u;  // NaN and pad keys: OWN_KEYS | position

struct PoolArgs {
  const float* x;
  float *med, *mode;
  uint8_t *med_idx, *mode_idx;  // both null unless a gradient is needed
  int c, hw, npix;
};

// the key of value v at channel i
__device__ __forceinline__ uint32_t key_of(float v, int i) {
  if (v != v) return OWN_KEYS | (uint32_t)i;
  const uint32_t b = __float_as_uint(__fadd_rn(v, 0.0f));  // -0 + 0 = +0
  return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t k) {
  if (k >= OWN_KEYS) return __uint_as_float(0x7fc00000u);
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ void cmpx(uint32_t& lo, uint32_t& hi) {
  const uint32_t a = lo, b = hi;
  lo = min(a, b);
  hi = max(a, b);
}

// Batcher's odd-even merge of k[LO..HI] (inclusive) at stride R, without the
// comparators that reach past NC
template <int NC, int LO, int HI, int R, int P>
__device__ __forceinline__ void oe_merge(uint32_t (&k)[P]) {
  if constexpr (LO + R < NC) {
    constexpr int STEP = 2 * R;
    if constexpr (STEP < HI - LO) {
      oe_merge<NC, LO, HI, STEP>(k);
      oe_merge<NC, LO + R, HI, STEP>(k);
#pragma unroll
      for (int i = LO + R; i < HI - R; i += STEP)
        if (i + R < NC) cmpx(k[i], k[i + R]);
    } else {
      cmpx(k[LO], k[LO + R]);
    }
  }
}

template <int NC, int LO, int HI, int P>
__device__ __forceinline__ void oe_sort(uint32_t (&k)[P]) {
  if constexpr (HI > LO && LO < NC) {
    constexpr int MID = LO + (HI - LO) / 2;
    oe_sort<NC, LO, MID>(k);
    oe_sort<NC, MID + 1, HI>(k);
    oe_merge<NC, LO, HI, 1>(k);
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// The gradient's channels: the median's by its stable rank among equal
// keys, the mode's as the first channel holding its key.
__device__ __forceinline__ void write_index(const PoolArgs& a, const float* src, int q, uint32_t med,
                                            uint32_t best) {
  const int n = a.c, hw = a.hw;
  int less = 0;
  for (int c = 0; c < n; ++c) less += key_of(__ldg(src + (size_t)c * hw), c) < med;
  const int rank = (n - 1) / 2 - less;
  int seen = 0, mi = 0, mo = -1;
  for (int c = 0; c < n; ++c) {
    const uint32_t v = key_of(__ldg(src + (size_t)c * hw), c);
    if (v == med) {
      if (seen == rank) mi = c;
      ++seen;
    }
    if (v == best && mo < 0) mo = c;
  }
  a.med_idx[q] = (uint8_t)mi;
  a.mode_idx[q] = (uint8_t)mo;
}

// C in [LOW, NC]: positions below LOW always hold values
template <int NC, int LOW>
__global__ void __launch_bounds__(REG_THREADS) channel_pool_regs(const __grid_constant__ PoolArgs a) {
  constexpr int P = pow2_at_least(NC);
  const int q = blockIdx.x * REG_THREADS + threadIdx.x;
  if (q >= a.npix) return;
  const int n = a.c, hw = a.hw;
  const int b = q / hw;
  const float* src = a.x + (size_t)b * n * hw + (q - b * hw);
  uint32_t k[P];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i < LOW) {
      k[i] = key_of(__ldg(src + (size_t)i * hw), i);
    } else {  // a pad above C reads channel C - 1 and keeps a key of its own
      const float v = __ldg(src + (size_t)min(i, n - 1) * hw);
      k[i] = i < n ? key_of(v, i) : OWN_KEYS | (uint32_t)i;
    }
  }
  oe_sort<NC, 0, P - 1>(k);

  const int mid = (n - 1) / 2;
  uint32_t med = k[0], best = k[0];
  int run = 1, best_len = 1;
#pragma unroll
  for (int i = 1; i < NC; ++i) {
    run = k[i] == k[i - 1] ? run + 1 : 1;
    if (run > best_len) {  // strictly longer: ties keep the smaller value
      best_len = run;
      best = k[i];
    }
    if (i >= (LOW - 1) / 2 && i <= (NC - 1) / 2 && i == mid) med = k[i];
  }
  a.med[q] = value_of(med);
  a.mode[q] = value_of(best);
  if (a.med_idx != nullptr) write_index(a, src, q, med, best);
}

__global__ void __launch_bounds__(SMEM_THREADS) channel_pool_smem(const __grid_constant__ PoolArgs a) {
  __shared__ uint32_t keys[MAX_C * SMEM_THREADS];
  const int q = blockIdx.x * SMEM_THREADS + threadIdx.x;
  if (q >= a.npix) return;
  const int n = a.c, hw = a.hw;
  const int b = q / hw;
  const float* src = a.x + (size_t)b * n * hw + (q - b * hw);
  uint32_t* k = keys + threadIdx.x;  // k[i * SMEM_THREADS]: this thread's key i
  for (int i = 0; i < n; ++i) k[i * SMEM_THREADS] = key_of(__ldg(src + (size_t)i * hw), i);
  // the same network as loops (Knuth's form), without what reaches past C
  // (a pair in one aligned block of 2p: their xor is below 2p)
  for (int p = 1; p < MAX_C; p <<= 1)
    for (int d = p; d >= 1; d >>= 1)
      for (int j = d & (p - 1); j + d < n; j += 2 * d)
        for (int i = j; i < min(j + d, n - d); ++i)
          if ((i ^ (i + d)) < 2 * p) cmpx(k[i * SMEM_THREADS], k[(i + d) * SMEM_THREADS]);

  const int mid = (n - 1) / 2;
  uint32_t prev = k[0], med = prev, best = prev;
  int run = 1, best_len = 1;
  for (int i = 1; i < n; ++i) {
    const uint32_t v = k[i * SMEM_THREADS];
    run = v == prev ? run + 1 : 1;
    if (run > best_len) {
      best_len = run;
      best = v;
    }
    if (i == mid) med = v;
    prev = v;
  }
  a.med[q] = value_of(med);
  a.mode[q] = value_of(best);
  if (a.med_idx != nullptr) write_index(a, src, q, med, best);
}

template <int NC, int LOW>
cudaError_t launch_regs(const PoolArgs& a, cudaStream_t st) {
  channel_pool_regs<NC, LOW><<<(a.npix + REG_THREADS - 1) / REG_THREADS, REG_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (b, c, hw) float32, contiguous; med, mode: (b, hw); med_idx, mode_idx:
// (b, hw) channel indices, or both null. 1 <= c <= 256.
extern "C" int channel_pool_select(const float* x, float* med, float* mode, uint8_t* med_idx,
                                   uint8_t* mode_idx, int b, int c, int hw, void* stream) {
  if (b <= 0 || hw <= 0 || c < 1 || c > MAX_C) return (int)cudaErrorInvalidValue;
  if ((long long)b * hw > INT_MAX - REG_THREADS) return (int)cudaErrorInvalidValue;
  if ((med_idx == nullptr) != (mode_idx == nullptr)) return (int)cudaErrorInvalidValue;
  const PoolArgs a{x, med, mode, med_idx, mode_idx, c, hw, b * hw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 8) return (int)launch_regs<8, 1>(a, st);
  if (c <= 16) return (int)launch_regs<16, 9>(a, st);
  if (c <= 32) return (int)launch_regs<32, 17>(a, st);
  if (c <= 48) return (int)launch_regs<48, 33>(a, st);
  if (c <= 64) return (int)launch_regs<64, 49>(a, st);
  if (c <= 80) return (int)launch_regs<80, 65>(a, st);
  if (c <= 96) return (int)launch_regs<96, 81>(a, st);
  if (c <= 112) return (int)launch_regs<112, 97>(a, st);
  if (c <= 128) return (int)launch_regs<128, 113>(a, st);
  channel_pool_smem<<<(a.npix + SMEM_THREADS - 1) / SMEM_THREADS, SMEM_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
