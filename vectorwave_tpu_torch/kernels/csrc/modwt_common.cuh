// Shared pieces of the MODWT filter-bank kernels (sm_90a).
//
// Conventions shared by modwt_analysis.cu, modwt_synthesis.cu,
// modwt_denoise.cu and the exact tier's modwt_exact_{analysis,synthesis}.cu:
//   * data are [batch, n] rows, float32 or bfloat16; the first three kernels
//     compute in fp32 FMA and store in the input type; the exact kernels
//     read and write float32 (hi, lo) pairs and compute in fp64 FMA with
//     fp64 taps;
//   * taps arrive as one small fp32 device tensor, already scaled by 1/sqrt(2)
//     per stage: [lo[0..L), hi[0..L)] (the denoise kernel takes the analysis
//     pair followed by the synthesis pair);
//   * the signal is extended past [0, n) either periodically (index taken
//     modulo n, so n may be shorter than the cascade span) or with zeros;
//     the analysis kernel also takes the per-level mirror and an external
//     left halo (CascadeEdge), the denoise kernel the external halo, the
//     synthesis kernel an external right halo per plane, and the exact
//     pair the same two halos on (hi, lo) pairs (the tiled tier's edges);
//   * one block serves one (signal, tile of `tile` outputs); the grid is
//     flattened to blockIdx.x = signal * tiles_per_row + tile_index, so the
//     batch is not bounded by gridDim.y;
//   * each C entry point returns cudaGetLastError() after its launch, so a
//     refused launch (too much shared memory, bad configuration) reaches the
//     Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vw {

constexpr int kMaxLevels = 10;
constexpr int kMaxPlanes = kMaxLevels + 1;
constexpr int kMaxTaps = 128;
constexpr int kThreads = 256;
// Dynamic shared memory one block may use on Hopper (227 KB).
constexpr int kMaxSharedBytes = 232448;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Plane pointers travel by value in the kernel's parameter block, so the
// planes need not be stacked into one tensor.
struct PlanePtrs {
  void* p[kMaxPlanes];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sample g of the extended row: periodic wraps ((g % n) + n) % n, zero
// reads 0 outside [0, n).
template <typename T>
__device__ __forceinline__ float load_ext(const T* __restrict__ row,
                                          long long g, long long n,
                                          bool periodic) {
  if (periodic) {
    long long m = g % n;
    if (m < 0) m += n;
    return to_f32(row[m]);
  }
  return (g >= 0 && g < n) ? to_f32(row[g]) : 0.0f;
}

// Sample g of a row whose left neighbour's last `halo_len` samples are
// `halo` (the external edge): g < 0 reads halo[halo_len + g], and 0 before
// the halo starts; g >= n reads 0.  A halo longer than a kernel's span is
// read only in its last span samples.
template <typename T>
__device__ __forceinline__ float load_halo(const T* __restrict__ row,
                                           const T* __restrict__ halo, int halo_len,
                                           long long g, long long n) {
  if (g < 0) {
    const long long h = halo_len + g;
    return h >= 0 ? to_f32(halo[h]) : 0.0f;
  }
  return g < n ? to_f32(row[g]) : 0.0f;
}

// Sample g >= 0 of a row whose right neighbour's first `halo_len` samples
// are `halo` (the synthesis's external right edge): g < n reads the row,
// n <= g < n + halo_len reads halo[g - n], and later samples read 0.  The
// synthesis reads forward only, so g < 0 never occurs.
template <typename T>
__device__ __forceinline__ float load_right_halo(const T* __restrict__ row,
                                                 const T* __restrict__ halo,
                                                 int halo_len, long long g,
                                                 long long n) {
  if (g < n) return to_f32(row[g]);
  const long long h = g - n;
  return h < halo_len ? to_f32(halo[h]) : 0.0f;
}

// Left edges of the analysis cascade: zero, periodic, the per-level
// half-point mirror at the signal start (the symmetric analysis), or an
// external halo (the streaming tier's carry).
enum CascadeEdge : int {
  kCascadeZero = 0,
  kCascadePeriodic = 1,
  kCascadeMirror = 2,
  kCascadeExternal = 3
};

// Sample g of the row extended by `edge`: as load_ext for zero and periodic;
// the mirror reads row[-1 - g] for g < 0, and 0 where that, or g, lies
// past n; the external edge is load_halo.
template <typename T>
__device__ __forceinline__ float load_edge(const T* __restrict__ row,
                                           const T* __restrict__ halo, int halo_len,
                                           long long g, long long n, int edge) {
  if (edge == kCascadePeriodic) return load_ext(row, g, n, true);
  if (edge == kCascadeExternal) return load_halo(row, halo, halo_len, g, n);
  if (edge == kCascadeMirror && g < 0) g = -1 - g;
  return load_ext(row, g, n, false);
}

// Reach of level j's filters before an output, (L - 1) 2^(j-1): the mirror
// mode reflects that many samples at every level, and its deepest level
// needs (L - 1) 2^(J-1) samples of signal and of a block's tile.
__host__ __device__ __forceinline__ int level_reach(int taps, int level) {
  return (taps - 1) << (level - 1);
}

// Cascade span (L - 1)(2^J - 1): how far the J-level composite filter reaches.
__host__ __device__ __forceinline__ int cascade_span(int taps, int levels) {
  return (taps - 1) * ((1 << levels) - 1);
}

// Span of the levels first .. first + levels - 1 of the cascade:
// (L - 1) 2^(first-1) (2^levels - 1).
__host__ __device__ __forceinline__ int cascade_span_from(int taps, int first,
                                                          int levels) {
  return cascade_span(taps, levels) << (first - 1);
}

inline bool valid_config(long long batch, long long n, int levels, int taps,
                         int tile) {
  return batch >= 1 && n >= 1 && levels >= 1 && levels <= kMaxLevels &&
         taps >= 1 && taps <= kMaxTaps && tile >= 1;
}

// --- double-float (hi, lo) float32 pairs, the exact tier's planes ---------
//
// A pair is read as the double hi + lo and written back as hi = the float32
// round of v and lo = the float32 round of v - hi: about 48 significant bits,
// with hi the correctly rounded float32 value.

// Plane pointers of the exact kernels: (hi, lo) of each plane, in order.
struct PairPtrs {
  void* p[2 * kMaxPlanes];
};

// Sample g of the extended pair row as a double (lo may be null: then the
// row is the float32 hi alone).
__device__ __forceinline__ double load_ext_pair(const float* __restrict__ hi,
                                                const float* __restrict__ lo,
                                                long long g, long long n,
                                                bool periodic) {
  long long m = g;
  if (periodic) {
    m = g % n;
    if (m < 0) m += n;
  } else if (g < 0 || g >= n) {
    return 0.0;
  }
  const double v = static_cast<double>(hi[m]);
  return lo == nullptr ? v : v + static_cast<double>(lo[m]);
}

// The exact analysis's external left edge: a halo of raw float32 samples
// whose lo word is zero; g < 0 reads halo[halo_len + g], 0 before the halo
// starts, and g >= n reads 0.  (The synthesis's right edge, a (hi, lo) halo
// pair per plane, is read as its windows are copied: modwt_exact_synthesis.cu.)
__device__ __forceinline__ double load_left_halo_pair(
    const float* __restrict__ hi, const float* __restrict__ lo,
    const float* __restrict__ halo, int halo_len, long long g, long long n) {
  if (g < 0) {
    const long long h = halo_len + g;
    return h >= 0 ? static_cast<double>(halo[h]) : 0.0;
  }
  return load_ext_pair(hi, lo, g, n, false);
}

__device__ __forceinline__ void store_pair(float* __restrict__ hi,
                                           float* __restrict__ lo, long long i,
                                           double v) {
  const float h = __double2float_rn(v);
  hi[i] = h;
  lo[i] = __double2float_rn(v - static_cast<double>(h));
}

// --- asynchronous copies from device memory to shared memory (cp.async) ---
//
// A copy is in flight until cp_async_wait_all() (every copy of the thread)
// or cp_async_wait_one() (all but the latest committed group); a barrier
// after the wait makes the block's copies visible to every thread.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --- register-blocked tap runs (the bank, cascade, denoise and exact kernels)
//
// A thread owns kBlock outputs u, u + d, ..., u + (kBlock - 1) d of one
// residue class mod d, so that taps i and i + 1 read the same samples one
// step of d apart; taps go in steps of kBlock - 1, that many new samples a
// step.  The kernels take kRunBlock = 9 (steps of kRunChunk = 8 taps), in
// fp32 and in fp64.

constexpr int kRunBlock = 9;
constexpr int kRunChunk = 8;

// The thread's first output in a chunk of kThreads kBlock outputs for a
// stride 2^shift dividing kThreads: u = (tid mod d) + d kBlock (tid / d).
// An odd block keeps the 32 lanes of a warp on 32 banks (fp64: each half
// warp on 16 bank pairs) for every d, and for d <= 32 a warp's outputs are
// the 32 kBlock after its first.
template <int kBlock = kRunBlock>
__device__ __forceinline__ int run_base(int shift) {
  const int d = 1 << shift;
  return (threadIdx.x & (d - 1)) +
         ((static_cast<int>(threadIdx.x) >> shift) << shift) * kBlock;
}

// Window sample m of the thread's run: w[m] = src[m d].
template <bool kUnit, typename Src>
__device__ __forceinline__ auto run_sample(const Src& src, int m, int d) {
  return src[kUnit ? m : m * d];
}

// A window of (hi, lo) float32 pairs read as doubles, hi + lo (the exact
// tier's planes in shared memory): the arithmetic of load_ext_pair.
struct PairRow {
  const float* hi;
  const float* lo;
  __device__ __forceinline__ double operator[](int i) const {
    return static_cast<double>(hi[i]) + static_cast<double>(lo[i]);
  }
  __device__ __forceinline__ PairRow operator+(int k) const { return {hi + k, lo + k}; }
};

__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return fma(a, b, c); }

// Taps p[0 .. C) as 16-byte broadcasts (p on 16 bytes).
template <int C>
__device__ __forceinline__ void load_taps(const float* p, float (&t)[C]) {
#pragma unroll
  for (int k = 0; k < C / 4; ++k) {
    const float4 q = reinterpret_cast<const float4*>(p)[k];
    t[4 * k] = q.x;
    t[4 * k + 1] = q.y;
    t[4 * k + 2] = q.z;
    t[4 * k + 3] = q.w;
  }
}

template <int C>
__device__ __forceinline__ void load_taps(const double* p, double (&t)[C]) {
#pragma unroll
  for (int k = 0; k < C / 2; ++k) {
    const double2 q = reinterpret_cast<const double2*>(p)[k];
    t[2 * k] = q.x;
    t[2 * k + 1] = q.y;
  }
}

// Analysis runs (backward reads).  Taps i0 .. i0 + C - 1 (C = kBlock - 1)
// of the lo and hi filters: output r reads w[r - i0 - t] for tap i0 + t.
// `fresh` is loaded with w[m0 .. m0 + C), m0 = -(i0 + C - 1); `old` holds
// w[m0 + C .. m0 + 2C), the previous step's `fresh`.  kGuard: samples
// outside [m_lo, m_hi) read 0; they feed only zero (padded) taps or outputs
// that are not stored.
template <bool kUnit, bool kGuard, typename V, int kBlock, typename Src>
__device__ __forceinline__ void pair_step(V (&a)[kBlock], V (&d)[kBlock],
                                          V (&fresh)[kBlock - 1],
                                          const V (&old)[kBlock - 1], const Src& src,
                                          int m0, int s, const V* lo, const V* hi,
                                          int m_lo, int m_hi) {
  constexpr int C = kBlock - 1;
#pragma unroll
  for (int e = 0; e < C; ++e) {
    const int m = m0 + e;
    fresh[e] = !kGuard || (m >= m_lo && m < m_hi) ? run_sample<kUnit>(src, m, s) : V(0);
  }
  V tl[C], th[C];
  load_taps(lo, tl);
  load_taps(hi, th);
#pragma unroll
  for (int t = 0; t < C; ++t) {
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      const int e = r - t + C - 1;
      const V v = e < C ? fresh[e] : old[e - C];
      a[r] = fma_of(tl[t], v, a[r]);
      d[r] = fma_of(th[t], v, d[r]);
    }
  }
}

// The thread's kBlock outputs of one level: a[r], d[r] = the lo and hi sums
// of w[r - k], w[m] = src[m s], over `taps` (a multiple of kBlock - 1)
// padded taps.
template <bool kUnit, bool kGuard, typename V, int kBlock, typename Src>
__device__ __forceinline__ void pair_run(V (&a)[kBlock], V (&d)[kBlock], const Src& src,
                                         int s, const V* lo, const V* hi, int taps,
                                         int m_lo, int m_hi) {
  constexpr int C = kBlock - 1;
  V u[C], v[C];
#pragma unroll
  for (int e = 0; e < C; ++e) {
    v[e] = !kGuard || e + 1 < m_hi ? run_sample<kUnit>(src, e + 1, s) : V(0);
  }
  int i0 = 0;
  for (; i0 + 2 * C <= taps; i0 += 2 * C) {
    pair_step<kUnit, kGuard>(a, d, u, v, src, -(i0 + C - 1), s, lo + i0, hi + i0, m_lo,
                             m_hi);
    pair_step<kUnit, kGuard>(a, d, v, u, src, -(i0 + 2 * C - 1), s, lo + i0 + C,
                             hi + i0 + C, m_lo, m_hi);
  }
  if (i0 < taps) {
    pair_step<kUnit, kGuard>(a, d, u, v, src, -(i0 + C - 1), s, lo + i0, hi + i0, m_lo,
                             m_hi);
  }
}

// Synthesis runs (forward reads).  Taps i0 .. i0 + C - 1: output r reads
// w[r + i0 + t] for tap i0 + t.  `old` holds w[i0 .. i0 + C); `fresh` is
// loaded with w[m0 .. m0 + C), m0 = i0 + C.  kGuard: samples from m_hi on
// read 0; they feed only zero (padded) taps or outputs that are not stored.
template <bool kUnit, bool kGuard, typename V, int kBlock, typename Src>
__device__ __forceinline__ void fwd_step(V (&acc)[kBlock], V (&fresh)[kBlock - 1],
                                         const V (&old)[kBlock - 1], const Src& src,
                                         int m0, int s, const V* v, int m_hi) {
  constexpr int C = kBlock - 1;
#pragma unroll
  for (int e = 0; e < C; ++e) {
    fresh[e] = !kGuard || m0 + e < m_hi ? run_sample<kUnit>(src, m0 + e, s) : V(0);
  }
  V tv[C];
  load_taps(v, tv);
#pragma unroll
  for (int t = 0; t < C; ++t) {
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      const int e = r + t;
      acc[r] = fma_of(tv[t], e < C ? old[e] : fresh[e - C], acc[r]);
    }
  }
}

// acc[r] += the sum of v[i] w[r + i], w[m] = src[m s], over `taps` (a
// multiple of kBlock - 1) padded taps.
template <bool kUnit, bool kGuard, typename V, int kBlock, typename Src>
__device__ __forceinline__ void fwd_run(V (&acc)[kBlock], const Src& src, int s,
                                        const V* v, int taps, int m_hi) {
  constexpr int C = kBlock - 1;
  V a[C], b[C];
#pragma unroll
  for (int e = 0; e < C; ++e) {
    b[e] = !kGuard || e < m_hi ? run_sample<kUnit>(src, e, s) : V(0);
  }
  int i0 = 0;
  for (; i0 + 2 * C <= taps; i0 += 2 * C) {
    fwd_step<kUnit, kGuard>(acc, a, b, src, i0 + C, s, v + i0, m_hi);
    fwd_step<kUnit, kGuard>(acc, b, a, src, i0 + 2 * C, s, v + i0 + C, m_hi);
  }
  if (i0 < taps) fwd_step<kUnit, kGuard>(acc, a, b, src, i0 + C, s, v + i0, m_hi);
}

// fwd_step for two tap rows on the same samples: a[r] += lo . w[r + i0 ..],
// d[r] += hi . w[r + i0 ..].
template <bool kUnit, bool kGuard, typename V, int kBlock, typename Src>
__device__ __forceinline__ void fwd_pair_step(V (&a)[kBlock], V (&d)[kBlock],
                                              V (&fresh)[kBlock - 1],
                                              const V (&old)[kBlock - 1], const Src& src,
                                              int m0, int s, const V* lo, const V* hi,
                                              int m_hi) {
  constexpr int C = kBlock - 1;
#pragma unroll
  for (int e = 0; e < C; ++e) {
    fresh[e] = !kGuard || m0 + e < m_hi ? run_sample<kUnit>(src, m0 + e, s) : V(0);
  }
  V tl[C], th[C];
  load_taps(lo, tl);
  load_taps(hi, th);
#pragma unroll
  for (int t = 0; t < C; ++t) {
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      const int e = r + t;
      const V v = e < C ? old[e] : fresh[e - C];
      a[r] = fma_of(tl[t], v, a[r]);
      d[r] = fma_of(th[t], v, d[r]);
    }
  }
}

// fwd_run of the lo and the hi taps over the same samples, each sample
// loaded once for both sums.
template <bool kUnit, bool kGuard, typename V, int kBlock, typename Src>
__device__ __forceinline__ void fwd_pair_run(V (&a)[kBlock], V (&d)[kBlock], const Src& src,
                                             int s, const V* lo, const V* hi, int taps,
                                             int m_hi) {
  constexpr int C = kBlock - 1;
  V u[C], v[C];
#pragma unroll
  for (int e = 0; e < C; ++e) {
    v[e] = !kGuard || e < m_hi ? run_sample<kUnit>(src, e, s) : V(0);
  }
  int i0 = 0;
  for (; i0 + 2 * C <= taps; i0 += 2 * C) {
    fwd_pair_step<kUnit, kGuard>(a, d, u, v, src, i0 + C, s, lo + i0, hi + i0, m_hi);
    fwd_pair_step<kUnit, kGuard>(a, d, v, u, src, i0 + 2 * C, s, lo + i0 + C, hi + i0 + C,
                                 m_hi);
  }
  if (i0 < taps) {
    fwd_pair_step<kUnit, kGuard>(a, d, u, v, src, i0 + C, s, lo + i0, hi + i0, m_hi);
  }
}

// A synthesis level's sum of c_j (lo taps) and d_j (hi taps) into the
// thread's outputs.
template <bool kUnit, bool kGuard, typename V, int kBlock, typename SrcC, typename SrcD>
__device__ __forceinline__ void level_run(V (&acc)[kBlock], const SrcC& c, const SrcD& d,
                                          int s, const V* lo, const V* hi, int taps,
                                          int m_hi) {
  fwd_run<kUnit, kGuard>(acc, c, s, lo, taps, m_hi);
  fwd_run<kUnit, kGuard>(acc, d, s, hi, taps, m_hi);
}

// --- cascade windows in shared memory (modwt_analysis.cu, modwt_synthesis.cu)

// Taps padded with zeros to whole steps of kRunChunk, so that every tap
// step reads its taps as two 16-byte broadcasts.
__host__ __device__ __forceinline__ int padded_taps(int taps) {
  return (taps + kRunChunk - 1) & ~(kRunChunk - 1);
}

// Floats of one window row of `width` samples: up to 3 before it, so that
// the window can start where its source starts modulo 16 bytes, rounded up
// to 16 bytes, so that the next row starts on 16 bytes too.
__host__ __device__ __forceinline__ int window_row_floats(int width) {
  return (width + 6) & ~3;
}

// The tile of a cascade launch (modwt_analysis.cu, modwt_synthesis.cu): the
// caller's preferred `tile`, no longer than the row (a shorter row would only
// reserve shared memory it never uses), halved until `bytes_of(tile)` fit a
// block, not below 128 (nor below a shorter row), and at least `least`; 0
// where that does not fit.  The Python wrappers read it through the library.
template <typename Bytes>
inline int cascade_tile(int tile, long long n, int least, Bytes bytes_of) {
  const size_t limit = static_cast<size_t>(kMaxSharedBytes);
  int t = n < tile ? static_cast<int>(n) : tile;
  while (t > 128 && bytes_of(t) > limit) t = t / 2 > 128 ? t / 2 : 128;
  if (t < least) t = least;
  return bytes_of(t) <= limit ? t : 0;
}

// Where a window of source sample `src` starts in its row: the float32
// source's place modulo 16 bytes, so that the window's body copies in
// 16-byte pieces (bfloat16 windows are converted as they are stored, and
// start at 0).
template <typename T>
__device__ __forceinline__ int window_offset(const T* src) {
  return sizeof(T) == sizeof(float) ? static_cast<int>((reinterpret_cast<size_t>(src) >> 2) & 3)
                                    : 0;
}

// dst[0 .. count) = src[0 .. count), by the whole block.  float32: cp.async,
// 16 bytes at a time where dst and src agree modulo 16 bytes, else 4, in
// flight until the caller waits; bfloat16: pairs read as 4 bytes where they
// line up, converted and stored.
template <typename T>
__device__ __forceinline__ void copy_row_window(float* dst, const T* __restrict__ src, int count) {
  if (count <= 0) return;
  int head = 0, body = 0;
  if constexpr (sizeof(T) == sizeof(float)) {
    const float* from = reinterpret_cast<const float*>(src);
    if (((reinterpret_cast<size_t>(dst) ^ reinterpret_cast<size_t>(from)) & 15) == 0) {
      head = min(count, static_cast<int>(((16 - (reinterpret_cast<size_t>(from) & 15)) & 15) >> 2));
      body = (count - head) >> 2;
      for (int i = threadIdx.x; i < body; i += blockDim.x) {
        cp_async16(dst + head + 4 * i, from + head + 4 * i);
      }
    }
    for (int q = threadIdx.x; q < head; q += blockDim.x) cp_async4(dst + q, from + q);
    for (int q = head + 4 * body + threadIdx.x; q < count; q += blockDim.x) {
      cp_async4(dst + q, from + q);
    }
  } else {
    if ((reinterpret_cast<size_t>(src) & 3) == 0) {
      body = count >> 1;
      const __nv_bfloat162* from = reinterpret_cast<const __nv_bfloat162*>(src);
      for (int i = threadIdx.x; i < body; i += blockDim.x) {
        const float2 f = __bfloat1622float2(from[i]);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
      }
    }
    for (int q = 2 * body + threadIdx.x; q < count; q += blockDim.x) dst[q] = to_f32(src[q]);
  }
}

// Opt in to more than 48 KB of dynamic shared memory where a launch needs it;
// returns the error of the attribute call, or of the size check.
template <typename Kernel>
inline cudaError_t reserve_shared(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vw
