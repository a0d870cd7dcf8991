// Exact-tier MODWT analysis in one pass: (x_hi [, x_lo]) -> (hi, lo) pairs
// of d_j0 .. d_{j0+K-1} and a_{j0+K-1}.
//
// Replaces the TPU kernel vectorwave_tpu/kernels/modwt_exact.py
// `_exact_analysis_call`.  The TPU has no f32 or f64 matrix path, so that
// kernel cuts its operands into 8-bit bf16 slices, runs 19-21 error-free
// slice-pair matmuls per band of the composite filters and sums them with
// two_sum chains into double-float planes.  Hopper has native fp64, so here
// the block runs the same per-level a trous cascade as modwt_analysis.cu,
//     a_j[p] = sum_k lo[k] a_{j-1}[p - 2^{j-1} k],
//     d_j[p] = sum_k hi[k] a_{j-1}[p - 2^{j-1} k],
// in fp64 FMA on fp64 taps, which equals the composite form for periodic and
// zero edges.  Input pairs are read as hi + lo in double; every output is
// written as a float32 (hi, lo) pair (store_pair), so the planes keep the
// ExactMODWTResult contract of about 48 bits with hi correctly rounded.
//
// `first` is the level of the first stage (stride 2^(first-1)): the
// symmetric exact cascade runs one level per launch on a mirrored row, and
// a deep cascade whose halo does not fit shared memory runs as several
// launches, each continuing from the previous one's approximation pair.
// `direct` serves one level whose halo alone does not fit shared memory
// (long filters at levels 8-10): each output reads its L inputs straight
// from device memory instead of a shared window.
//
// External left halo (`halo=` of `analysis_exact`, the tiled exact tier's
// neighbour exchange): `halo` holds [batch, halo_len] raw float32 samples
// just left of each row, whose lo word is zero (f32 neighbour samples are
// exact); the window's samples before 0 read the halo, and 0 before it, as
// the zero edge of [halo | x] does.  Only a one-launch window plan takes
// it: the later launches of a split plan read an approximation pair that
// the neighbour never sent, so the wrapper runs a split plan on [halo | x]
// with zero edges instead.
//
// What bounds it on the H100: device-memory bytes.  Per sample it reads 4 B
// (8 B with x_lo) and writes 8 (K+1) B, 60 B for K = 6 (0.150 ms at
// 128 x 65536 and 3.35 TB/s), against 2 L K = 96 fp64 FMAs (0.047 ms at 34
// TFLOP/s fp64).  The design, modwt_analysis.cu's in fp64 (as
// modwt_exact_synthesis.cu is modwt_synthesis.cu's):
//   * the window [t0 - S, t0 + n_out), S = (L-1) 2^(j0-1) (2^K - 1),
//     arrives by cp.async as a float hi row and, given x_lo, a lo row, 16
//     bytes at a time (each row starts where its source does modulo 16
//     bytes); only its samples before 0 take the edge rule (wrapped, zero,
//     or the halo);
//   * the block converts the window once into a double row, hi + lo (a
//     run that added them as it loads, as modwt_exact_synthesis.cu does,
//     converts each sample about 2.4 times at 5 outputs a run); each
//     level's approximation goes to the other slot's double row;
//   * level j runs on stride s = 2^(j-1) with the register runs of
//     modwt_common.cuh in fp64 (pair_run): a thread owns kExactAnalysisBlock
//     outputs of one residue class mod s, each loaded sample feeding the lo
//     and the hi sum, taps in steps of kExactAnalysisBlock - 1 read as
//     16-byte broadcasts (padded with zeros to whole steps of 8); a stride
//     above kThreads takes several passes, and a run that reaches past the
//     window's end or reads padded taps loads only what its outputs need;
//   * the details are stored from registers as (hi, lo) pairs, except at
//     s < 8, where a thread's outputs are too far apart for full sectors:
//     there each warp stages its 32 x kExactAnalysisBlock contiguous details
//     in a buffer of its own and stores them on consecutive addresses
//     (where the buffers fit shared memory);
//   * shared memory is the fp64 taps, two slots of tile + S doubles (the
//     window's hi and lo rows, then the levels' double rows, in turns) and
//     the staging buffers.
#include "modwt_common.cuh"

namespace vw {

// Outputs a thread's run holds, taps in steps of kExactAnalysisBlock - 1:
// the pair of fp64 sums holds twice the registers of the exact synthesis's
// one sum.
constexpr int kExactAnalysisBlock = 5;
// Strides whose details are staged (modwt_analysis.cu's kStagedStride).
constexpr int kExactStagedStride = 8;

// Shared memory of one window block: the padded fp64 tap pair, two slots of
// tile + span doubles (rounded as window rows) and, with `stage`, the
// detail staging buffers.
inline size_t exact_analysis_bytes(int L, int first, int levels, int tile, bool stage) {
  return sizeof(double) *
         (2 * static_cast<size_t>(padded_taps(L)) +
          2 * static_cast<size_t>(
                  window_row_floats(tile + cascade_span_from(L, first, levels))) +
          (stage ? kThreads * kExactAnalysisBlock : 0));
}

// The block stages the details where the buffers fit shared memory.
inline bool exact_analysis_stages(int L, int first, int levels, int tile) {
  return exact_analysis_bytes(L, first, levels, tile, true) <=
         static_cast<size_t>(kMaxSharedBytes);
}

inline size_t exact_analysis_shared_bytes(int L, int first, int levels, int tile) {
  return exact_analysis_bytes(L, first, levels, tile,
                              exact_analysis_stages(L, first, levels, tile));
}

// The tile a window launch uses for the caller's preferred `tile`
// (cascade_tile).  Below 128 only where the gates' rule, 8 (2 L + 2 (128 +
// span)) bytes, leaves less room than the padded taps and rounded rows take
// (a few long filters at levels 9-10).
inline int exact_analysis_tile(int L, int first, int levels, long long n, int tile) {
  const auto bytes_of = [=](int t) { return exact_analysis_shared_bytes(L, first, levels, t); };
  int t = cascade_tile(tile, n, 1, bytes_of);
  for (int u = n < 64 ? static_cast<int>(n) : 64; t == 0 && u >= 1; u /= 2) {
    if (bytes_of(u) <= static_cast<size_t>(kMaxSharedBytes)) t = u;
  }
  return t;
}

// One level on stride 2^shift over window indices [start, width): the
// approximation to `nxt`, the detail's outputs o = q - span in [0, n_out)
// to (dh, dl), staged by the warp at strides below kExactStagedStride where
// `staged` (the warp's buffer) is given.
template <typename Src>
__device__ __forceinline__ void exact_analysis_level(double* nxt, const Src& cur, int shift,
                                                     int start, int width, int span,
                                                     int n_out, const double* lo,
                                                     const double* hi, int lp, int L,
                                                     float* dh, float* dl,
                                                     double* staged) {
  constexpr int K = kExactAnalysisBlock;
  const int s = 1 << shift;
  const int warp0 = static_cast<int>(threadIdx.x) & ~31;
  const bool stage_here = staged != nullptr && s < kExactStagedStride;
  // chunks of `group` K outputs, each in group / kThreads passes
  const int group = max(s, kThreads);
  for (int c0 = start; c0 < width; c0 += group * K) {
    for (int pass = 0; pass < group; pass += kThreads) {
      const int q0 = c0 + pass + (s <= kThreads ? run_base<K>(shift) : threadIdx.x);
      double a[K], d[K];
#pragma unroll
      for (int r = 0; r < K; ++r) a[r] = d[r] = 0.0;
      // the thread's outputs q0 + r s below the window's end
      const int lim = q0 < width ? min(K, (width - q0 + s - 1) >> shift) : 0;
      if (lim > 0) {
        const Src src = cur + q0;
        if (lim == K && lp == L) {
          if (s == 1) {
            pair_run<true, false>(a, d, src, 1, lo, hi, lp, 1 - L, lim);
          } else {
            pair_run<false, false>(a, d, src, s, lo, hi, lp, 1 - L, lim);
          }
        } else if (s == 1) {
          pair_run<true, true>(a, d, src, 1, lo, hi, lp, 1 - L, lim);
        } else {
          pair_run<false, true>(a, d, src, s, lo, hi, lp, 1 - L, lim);
        }
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if (r < lim) nxt[q0 + r * s] = a[r];
        }
      }
      if (stage_here) {
        // the warp's 32 K outputs run on from its first, cw0
        const int cw0 = c0 + warp0 * K;
#pragma unroll
        for (int r = 0; r < K; ++r) staged[q0 - cw0 + r * s] = d[r];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = 32 * k + static_cast<int>(threadIdx.x) - warp0;
          const int o = cw0 + i - span;
          if (o >= 0 && o < n_out) store_pair(dh, dl, o, staged[i]);
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int o = q0 + r * s - span;
          if (r < lim && o >= 0 && o < n_out) store_pair(dh, dl, o, d[r]);
        }
      }
    }
  }
}

// Two blocks to an SM where shared memory holds them (128 registers a
// thread): the fp64 runs' sums and samples take about 100.
__global__ void __launch_bounds__(kThreads, 2)
modwt_exact_analysis_kernel(const float* __restrict__ x_hi,
                            const float* __restrict__ x_lo,
                            const float* __restrict__ halo, int halo_len,
                            const __grid_constant__ PairPtrs out,
                            const double* __restrict__ taps, long long n, int first,
                            int levels, int L, int tile, int tiles_per_row, int periodic,
                            int direct, int stage) {
  extern __shared__ __align__(16) double smem_d[];
  const int lp = padded_taps(L);
  double* s_lo = smem_d;
  double* s_hi = smem_d + lp;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const float* row_hi = x_hi + row_off;
  const float* row_lo = x_lo == nullptr ? nullptr : x_lo + row_off;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));

  for (int k = threadIdx.x; k < lp; k += blockDim.x) {
    s_lo[k] = k < L ? taps[k] : 0.0;
    s_hi[k] = k < L ? taps[L + k] : 0.0;
  }
  if (direct) {  // one level, no window
    __syncthreads();
    const int s = 1 << (first - 1);
    float* dh = static_cast<float*>(out.p[0]) + row_off + t0;
    float* dl = static_cast<float*>(out.p[1]) + row_off + t0;
    float* ah = static_cast<float*>(out.p[2]) + row_off + t0;
    float* al = static_cast<float*>(out.p[3]) + row_off + t0;
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
      double a = 0.0;
      double d = 0.0;
      for (int k = 0; k < L; ++k) {
        const double v = load_ext_pair(row_hi, row_lo,
                                       t0 + o - static_cast<long long>(k) * s, n,
                                       periodic != 0);
        a = fma(s_lo[k], v, a);
        d = fma(s_hi[k], v, d);
      }
      store_pair(dh, dl, o, d);
      store_pair(ah, al, o, a);
    }
    return;
  }
  const int span = cascade_span_from(L, first, levels);
  const int row = window_row_floats(tile + span);  // doubles a slot, floats a half
  double* const slot_a = smem_d + 2 * lp;
  double* const slot_b = slot_a + row;
  // this warp's detail staging buffer
  double* staged = stage ? slot_b + row + (static_cast<int>(threadIdx.x) & ~31) *
                                              kExactAnalysisBlock
                         : nullptr;
  // window [t0 - span, t0 + n_out) of the extended signal, what the tile's
  // outputs read, as a hi and a lo row in slot a; its first `before`
  // samples lie before the signal start
  const int width = n_out + span;
  const long long g0 = t0 - span;
  const int before = static_cast<int>(max(-g0, 0LL));
  float* const wh = reinterpret_cast<float*>(slot_a) +
                    ((window_offset(row_hi + g0 + before) - before) & 3);
  float* const wl = reinterpret_cast<float*>(slot_a) + row +
                    (row_lo == nullptr ? 0
                                       : (window_offset(row_lo + g0 + before) - before) & 3);
  const float* row_halo = halo == nullptr ? nullptr : halo + b * halo_len;
  for (int q = threadIdx.x; q < before; q += blockDim.x) {
    const long long g = g0 + q;
    float vh = 0.0f, vl = 0.0f;
    if (row_halo != nullptr) {
      const long long h = halo_len + g;
      if (h >= 0) vh = row_halo[h];
    } else if (periodic) {
      long long m = g % n;
      if (m < 0) m += n;
      vh = row_hi[m];
      vl = row_lo == nullptr ? 0.0f : row_lo[m];
    }
    wh[q] = vh;
    wl[q] = vl;
  }
  copy_row_window(wh + before, row_hi + g0 + before, width - before);
  if (row_lo != nullptr) copy_row_window(wl + before, row_lo + g0 + before, width - before);
  cp_async_wait_all();
  __syncthreads();
  // the window as doubles, hi + lo, in slot b
  for (int q = threadIdx.x; q < width; q += blockDim.x) {
    const double v = static_cast<double>(wh[q]);
    slot_b[q] = row_lo == nullptr && q >= before ? v : v + static_cast<double>(wl[q]);
  }
  __syncthreads();

  int valid = 0;  // first window index where the current level is exact
  const double* cur = slot_b;
  double* nxt = slot_a;
  for (int i = 0; i < levels; ++i) {
    const int shift = first - 1 + i;
    const int start = valid + ((L - 1) << shift);
    float* dh = static_cast<float*>(out.p[2 * i]) + row_off + t0;
    float* dl = static_cast<float*>(out.p[2 * i + 1]) + row_off + t0;
    exact_analysis_level(nxt, cur, shift, start, width, span, n_out, s_lo, s_hi, lp, L, dh,
                         dl, staged);
    __syncthreads();
    cur = nxt;  // the next level writes over the previous row
    nxt = nxt == slot_b ? slot_a : slot_b;
    valid = start;
  }
  float* ah = static_cast<float*>(out.p[2 * levels]) + row_off + t0;
  float* al = static_cast<float*>(out.p[2 * levels + 1]) + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    store_pair(ah, al, o, cur[span + o]);
  }
}

}  // namespace vw

// A non-null `halo` of halo_len >= 1 samples a row selects the external left
// edge; periodic and direct must then be 0.  `tile` is the preferred tile of
// a window launch: it uses vw_modwt_exact_analysis_tile's (a direct launch
// takes `tile` as it is).
extern "C" int vw_modwt_exact_analysis(const void* x_hi, const void* x_lo,
                                       const void* halo, int halo_len,
                                       void* const* outs, const void* taps,
                                       long long batch, long long n, int first,
                                       int levels, int taps_len, int tile,
                                       int periodic, int direct, void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || first < 1 ||
      first + levels - 1 > vw::kMaxLevels || (direct && levels != 1) ||
      (halo != nullptr && (halo_len < 1 || periodic || direct))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vw::PairPtrs planes{};
  for (int i = 0; i < 2 * (levels + 1); ++i) planes.p[i] = outs[i];
  if (!direct) tile = vw::exact_analysis_tile(taps_len, first, levels, n, tile);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool stage = !direct && vw::exact_analysis_stages(taps_len, first, levels, tile);
  const size_t bytes = direct ? 2 * sizeof(double) * vw::padded_taps(taps_len)
                              : vw::exact_analysis_bytes(taps_len, first, levels, tile, stage);
  cudaError_t err = vw::reserve_shared(vw::modwt_exact_analysis_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vw::modwt_exact_analysis_kernel<<<static_cast<unsigned>(blocks), vw::kThreads, bytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_hi), static_cast<const float*>(x_lo),
      static_cast<const float*>(halo), halo_len, planes,
      static_cast<const double*>(taps), n, first, levels, taps_len, tile,
      static_cast<int>(tiles), periodic, direct, stage ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The tile of a window launch for a preferred `tile` (clamped to the row,
// halved until a block fits shared memory); 0 where none fits.
extern "C" int vw_modwt_exact_analysis_tile(int taps_len, int first, int levels,
                                            long long n, int tile) {
  return vw::valid_config(1, n, levels, taps_len, tile) && first >= 1 &&
                 first + levels - 1 <= vw::kMaxLevels
             ? vw::exact_analysis_tile(taps_len, first, levels, n, tile)
             : 0;
}

// Shared memory of one window block at `tile`, in bytes.
extern "C" long long vw_modwt_exact_analysis_shared_bytes(int taps_len, int first,
                                                          int levels, int tile) {
  return vw::valid_config(1, 1, levels, taps_len, tile) && first >= 1 &&
                 first + levels - 1 <= vw::kMaxLevels
             ? static_cast<long long>(
                   vw::exact_analysis_shared_bytes(taps_len, first, levels, tile))
             : 0;
}
