// Fused J-level denoise in one pass: analysis -> per-(signal, level)
// threshold -> synthesis, with the coefficient planes kept in shared memory.
//
// Replaces the TPU kernel vectorwave_tpu/kernels/modwt_mxu.py
// `_composite_denoise_call`, which runs composite banded-matmul analysis,
// shrinks the planes in VMEM and runs composite synthesis, so that device
// memory sees only x in and x_hat out.  Mode "none" makes it the one-pass
// round trip (`modwt_roundtrip_fused`).  Here both halves are the per-level
// a trous cascades of modwt_analysis.cu and modwt_synthesis.cu:
//   * the block holds x over [t0 - S, t0 + n_out + S) with S = (L-1)(2^J-1)
//     (wrapped, zero-extended, or in stream mode read from the halo left of
//     0, below);
//   * analysis runs over the whole window and keeps d_1..d_J (thresholded)
//     for the plane window [t0, t0 + n_out + S_j), S_j = (L-1)(2^j-1), what
//     level j's synthesis reads, and a_J on [t0, t0 + n_out + S);
//   * soft is d - clamp(d, -t, t), hard keeps |d| > t, none passes d;
//   * on a zero boundary the plane samples at positions >= n are zeroed
//     before synthesis, because the inverse zero-extends the coefficients
//     while the window's tail holds the analysis of zero-extended x;
//   * synthesis runs from coarse to fine into [t0, t0 + n_out).
//
// Stream mode (`run_denoise_composite_stream`, the streaming denoiser's
// step): a zero boundary whose left side is an external halo, [batch,
// halo_len] values of x's type holding the raw stream just before the
// block.  The window reads halo[halo_len + g] for g < 0 (0 before the halo;
// load_halo) and 0 past n; the plane samples past n are zeroed as on the
// zero boundary, so the inverse is block-local with zero coefficients on
// the right (the TPU kernel's `zero_tail`).  Synthesis reads only forward,
// so the left needs no coefficient extension.  Nothing else changes: the
// mode is a load rule.
//
// What bounds it on the H100: device-memory traffic is 8 B per sample for
// float32 (0.025 ms at 128 x 65536), against 4 L J FMAs per sample (192 for
// db4 at J = 6: 0.048 ms at 67 TFLOP/s fp32) plus each tile's recomputed
// window, so it is bound by its own arithmetic and the shared-memory loads
// that feed it.  The design is the cascade pair's (modwt_analysis.cu,
// modwt_synthesis.cu), with the planes in shared memory between the halves:
//   * the window of x is copied into shared memory with cp.async, 16 bytes
//     at a time (the row starts where the source does modulo 16 bytes); only
//     its samples outside [0, n) take the edge rule, and bfloat16 is
//     converted as it is stored;
//   * each analysis level runs on stride s = 2^(j-1) with the register runs
//     of modwt_common.cuh: a thread owns kRunBlock = 9 outputs of one
//     residue class mod s, each loaded sample feeds the lo and the hi sum,
//     and the taps, padded with zeros to whole steps of 8, are read as
//     16-byte broadcasts; a stride above kThreads takes several passes, and
//     a run that reaches past the window or reads padded taps loads only
//     what its outputs need;
//   * the detail is shrunk in registers and stored once into its plane row,
//     zero past n on a zero edge;
//   * the synthesis runs modwt_synthesis.cu's forward runs on the plane rows
//     and the running approximation, which starts as a_J in the analysis's
//     own row; only the last level's output goes to device memory, on
//     consecutive addresses;
//   * shared memory holds the padded taps, two window rows of tile + 2 S and
//     the J plane rows: 76 KB at the wrapper's preferred tile of 2048 for
//     db4 J = 6, three blocks an SM (measured 1.5x faster than 1024, whose
//     recompute and blocks cost more than the occupancy gains, and faster
//     than 4096, one block an SM; two or four blocks' register budgets were
//     slower or no faster).
// Every precision tier (float32, bf16_3x, bf16) runs this same fp32 kernel,
// which meets each tier's error contract; the thresholded planes stay fp32
// in shared memory for bfloat16 input too.
#include "modwt_common.cuh"

namespace vw {

enum ShrinkMode : int { kNone = 0, kSoft = 1, kHard = 2 };

__device__ __forceinline__ float shrink(float d, float t, int mode) {
  if (mode == kSoft) return d - fminf(fmaxf(d, -t), t);
  if (mode == kHard) return fabsf(d) > t ? d : 0.0f;
  return d;
}

// Where plane row j (1-based) starts among the plane rows: rows 1 .. j-1 of
// tile + S_i floats each, sum_i S_i = (L-1)(2^j - 1 - j).
__host__ __device__ __forceinline__ int denoise_plane_offset(int L, int j, int tile) {
  return (j - 1) * tile + (L - 1) * ((1 << j) - 1 - j);
}

// Shared memory of one block: the four padded tap rows, two window rows of
// tile + 2 S and the J plane rows.
inline size_t denoise_shared_bytes(int L, int levels, int tile) {
  return sizeof(float) *
         (4 * static_cast<size_t>(padded_taps(L)) +
          2 * static_cast<size_t>(window_row_floats(tile + 2 * cascade_span(L, levels))) +
          static_cast<size_t>(denoise_plane_offset(L, levels + 1, tile)));
}

// The tile a launch uses for the caller's preferred `tile` (cascade_tile).
inline int denoise_tile(int L, int levels, long long n, int tile) {
  return cascade_tile(tile, n, 1, [=](int t) { return denoise_shared_bytes(L, levels, t); });
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
modwt_denoise_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const float* __restrict__ thresholds,
                     const float* __restrict__ taps, const T* __restrict__ halo,
                     int halo_len, long long n, int levels,
                     int L, int tile, int tiles_per_row, int periodic,
                     int mode) {
  extern __shared__ __align__(16) float smem[];
  const int span = cascade_span(L, levels);
  const int lp = padded_taps(L);
  const int row_floats = window_row_floats(tile + 2 * span);
  float* a_lo = smem;
  float* a_hi = smem + lp;
  float* r_lo = smem + 2 * lp;
  float* r_hi = smem + 3 * lp;
  float* const planes = smem + 4 * lp + 2 * row_floats;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const T* row = x + row_off;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const bool wrap = periodic != 0;
  // the x window [t0 - span, t0 + n_out + span) and the plane window
  // [t0, t0 + n_out + span); plane samples from `keep` on lie past n and
  // are zero on a zero edge
  const int width = n_out + 2 * span;
  const int pw = n_out + span;
  const int keep = wrap ? pw : static_cast<int>(min(static_cast<long long>(pw), n - t0));

  for (int k = threadIdx.x; k < lp; k += blockDim.x) {
    a_lo[k] = k < L ? taps[k] : 0.0f;
    a_hi[k] = k < L ? taps[L + k] : 0.0f;
    r_lo[k] = k < L ? taps[2 * L + k] : 0.0f;
    r_hi[k] = k < L ? taps[3 * L + k] : 0.0f;
  }
  // window samples [before, before + inside) lie in [0, n); the rest take
  // the edge rule
  const long long g0 = t0 - span;
  const int before = static_cast<int>(max(-g0, 0LL));
  const int inside = static_cast<int>(min(static_cast<long long>(width), n - g0)) - before;
  const int off = window_offset(row + g0 + before) - (before & 3);
  float* cur = smem + 4 * lp + (off & 3);
  float* nxt = cur + row_floats;
  const T* halo_row = halo == nullptr ? nullptr : halo + b * halo_len;
  const int edge = wrap ? kCascadePeriodic : halo_row != nullptr ? kCascadeExternal
                                                                 : kCascadeZero;
  for (int q = threadIdx.x; q < before; q += blockDim.x) {
    cur[q] = load_edge(row, halo_row, halo_len, g0 + q, n, edge);
  }
  copy_row_window(cur + before, row + g0 + before, inside);
  for (int q = before + inside + threadIdx.x; q < width; q += blockDim.x) {
    cur[q] = load_edge(row, halo_row, halo_len, g0 + q, n, edge);
  }
  cp_async_wait_all();
  __syncthreads();

  // analysis over the window, thresholding the details as they are stored
  int valid = 0;  // first window index where the current level is exact
  for (int j = 1; j <= levels; ++j) {
    const int shift = j - 1;
    const int s = 1 << shift;
    const int first = valid + (L - 1) * s;
    const float th = thresholds[b * levels + (j - 1)];
    // plane row j holds plane samples [0, n_out + S_j): window index
    // q = span + r for plane sample r
    float* plane = planes + denoise_plane_offset(L, j, tile) - span;
    const int plane_end = span + n_out + cascade_span(L, j);
    const int zero_from = span + keep;
    const int group = max(s, kThreads);
    for (int c0 = first; c0 < width; c0 += group * kRunBlock) {
      for (int p = 0; p < group; p += kThreads) {
        const int q0 = c0 + p + (s <= kThreads ? run_base(shift) : threadIdx.x);
        if (q0 >= width) continue;
        // the thread's outputs q0 + r s below the window's end
        const int lim = min(kRunBlock, (width - q0 + s - 1) >> shift);
        float a[kRunBlock], d[kRunBlock];
#pragma unroll
        for (int r = 0; r < kRunBlock; ++r) a[r] = d[r] = 0.0f;
        const float* src = cur + q0;
        const int m_lo = 1 - L;
        if (lim == kRunBlock && lp == L) {
          if (s == 1) {
            pair_run<true, false>(a, d, src, 1, a_lo, a_hi, lp, m_lo, lim);
          } else {
            pair_run<false, false>(a, d, src, s, a_lo, a_hi, lp, m_lo, lim);
          }
        } else if (s == 1) {
          pair_run<true, true>(a, d, src, 1, a_lo, a_hi, lp, m_lo, lim);
        } else {
          pair_run<false, true>(a, d, src, s, a_lo, a_hi, lp, m_lo, lim);
        }
#pragma unroll
        for (int r = 0; r < kRunBlock; ++r) {
          const int q = q0 + r * s;
          if (r < lim) {
            nxt[q] = a[r];
            if (q >= span && q < plane_end) {
              plane[q] = q >= zero_from ? 0.0f : shrink(d[r], th, mode);
            }
          }
        }
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    valid = first;
  }

  // synthesis from coarse to fine with forward reads, from c_J = a_J on the
  // plane window (zero past n on a zero edge)
  float* c = cur + span;
  float* o = nxt;
  for (int r = keep + threadIdx.x; r < pw; r += blockDim.x) c[r] = 0.0f;
  __syncthreads();
  int valid_end = pw;  // the current level is exact on [0, valid_end)
  for (int j = levels; j >= 1; --j) {
    const int shift = j - 1;
    const int s = 1 << shift;
    const int new_end = valid_end - (L - 1) * s;
    const float* plane = planes + denoise_plane_offset(L, j, tile);
    const int group = max(s, kThreads);
    for (int c0 = 0; c0 < new_end; c0 += group * kRunBlock) {
      for (int p = 0; p < group; p += kThreads) {
        const int q0 = c0 + p + (s <= kThreads ? run_base(shift) : threadIdx.x);
        if (q0 >= new_end) continue;
        // the thread's outputs q0 + r s below the level's end
        const int lim = min(kRunBlock, (new_end - q0 + s - 1) >> shift);
        const int m_hi = lim + L - 1;
        float acc[kRunBlock];
#pragma unroll
        for (int r = 0; r < kRunBlock; ++r) acc[r] = 0.0f;
        if (lim == kRunBlock && lp == L) {
          if (s == 1) {
            level_run<true, false>(acc, c + q0, plane + q0, 1, r_lo, r_hi, lp, m_hi);
          } else {
            level_run<false, false>(acc, c + q0, plane + q0, s, r_lo, r_hi, lp, m_hi);
          }
        } else if (s == 1) {
          level_run<true, true>(acc, c + q0, plane + q0, 1, r_lo, r_hi, lp, m_hi);
        } else {
          level_run<false, true>(acc, c + q0, plane + q0, s, r_lo, r_hi, lp, m_hi);
        }
#pragma unroll
        for (int r = 0; r < kRunBlock; ++r) {
          if (r < lim) o[q0 + r * s] = acc[r];
        }
      }
    }
    __syncthreads();
    float* tmp = c;
    c = o;
    o = tmp;
    valid_end = new_end;
  }
  T* dst = out + row_off + t0;
  for (int q = threadIdx.x; q < n_out; q += blockDim.x) dst[q] = from_f32<T>(c[q]);
}

template <typename T>
cudaError_t launch_denoise(const void* x, void* out, const float* thresholds,
                           const float* taps, const void* halo, int halo_len,
                           long long batch, long long n,
                           int levels, int L, int tile, int periodic, int mode,
                           cudaStream_t stream) {
  tile = denoise_tile(L, levels, n, tile);
  if (tile == 0) return cudaErrorInvalidValue;
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = denoise_shared_bytes(L, levels, tile);
  cudaError_t err = reserve_shared(modwt_denoise_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  modwt_denoise_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), thresholds, taps,
      static_cast<const T*>(halo), halo_len, n, levels, L, tile,
      static_cast<int>(tiles), periodic, mode);
  return cudaGetLastError();
}

}  // namespace vw

// halo: null, or in stream mode (periodic == 0) [batch, halo_len] values of
// x's type, the raw samples left of each row.  `tile` is the preferred tile:
// the launch uses vw_modwt_denoise_tile's.
extern "C" int vw_modwt_denoise(const void* x, void* out, const void* thresholds,
                                const void* taps, const void* halo, int halo_len,
                                long long batch, long long n, int levels,
                                int taps_len, int tile, int periodic, int mode,
                                int dtype, void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || mode < vw::kNone ||
      mode > vw::kHard || (halo == nullptr) != (halo_len == 0) || halo_len < 0 ||
      (halo != nullptr && periodic != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* th = static_cast<const float*>(thresholds);
  const float* t = static_cast<const float*>(taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_denoise<float>(x, out, th, t, halo, halo_len, batch, n, levels,
                                    taps_len, tile, periodic, mode, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_denoise<__nv_bfloat16>(x, out, th, t, halo, halo_len, batch, n,
                                            levels, taps_len, tile, periodic, mode, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tile of a launch for a preferred `tile` (clamped to the row, halved
// until a block fits shared memory); 0 where none fits.
extern "C" int vw_modwt_denoise_tile(int taps_len, int levels, long long n, int tile) {
  return vw::valid_config(1, n, levels, taps_len, tile)
             ? vw::denoise_tile(taps_len, levels, n, tile)
             : 0;
}

// Shared memory of one block at `tile`, in bytes.
extern "C" long long vw_modwt_denoise_shared_bytes(int taps_len, int levels, int tile) {
  return vw::valid_config(1, 1, levels, taps_len, tile)
             ? static_cast<long long>(vw::denoise_shared_bytes(taps_len, levels, tile))
             : 0;
}
