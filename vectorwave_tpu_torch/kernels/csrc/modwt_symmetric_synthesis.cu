// Symmetric-boundary inverse MODWT body with the edge splice, and its
// transpose (the gradient with respect to the planes).
//
// Replaces the TPU kernel vectorwave_tpu/kernels/modwt_symmetric.py
// `_symsyn2_call` and, in adjoint mode, its transpose `_symsyn_adjoint_kernel`
// (the composite analysis call with `planes_override`).  The TPU kernel sums
// every plane filtered by its rebased two-sided composed filter (up to 442
// taps, 1288 nonzero for db4 J = 6) as banded 128x128 matmuls over a
// [H | tile | H] window, then blends the head and tail inverse values in.
// Here the composition is not formed: the block runs it level by level, from
// coarse to fine, as the alignment-shifted per-level ops
//     c_{j-1}[t] = sum_l lo[l] c_j[t + sa 2^{j-1} l + oa]
//                + sum_l hi[l] d_j[t + sd 2^{j-1} l + od],
// with (sa, oa, sd, od) from the symmetric alignment table of each level and
// every plane zero outside [0, n).  The intermediates c_j are NOT clipped to
// [0, n): the composed filters of the definition read both ways, so each
// level is computed on its whole window.  That is exactly the composed-filter
// sum and costs 2 L J FMAs per output (96 for db4 J = 6, 128 for sym8 J = 4).
// The first span_l outputs are then stored from `head` and the last span_r
// from `tail` ([batch, span] fp32 each, the plain symmetric inverse of a
// short head and tail window).
//
// Adjoint mode reads a signal c ([batch, n], read as zero outside its
// interior [span_l, n - span_r)) and writes J+1 planes: the same ops
// transposed (sign flipped, offset negated), run from fine to coarse,
//     v_j[u] = sum_l lo[l] v_{j-1}[u - sa 2^{j-1} l - oa],  v_0 = c,
//     grad d_j[u] = sum_l hi[l] v_{j-1}[u - sd 2^{j-1} l - od],
//     grad a_J = v_J.
//
// The window of every level, relative to the block's first output, and the
// base and stride of each op's reads into the windows come from the host as
// a plan of kPlanStride ints per level (modwt_composite.symmetric_plan),
// made for `tile` outputs:
//   forward: [e_j, len_j, ed_j, bA, stA, bD, stD, 0] for c_j and d_j;
//   adjoint: [e_{j-1}, len_{j-1}, bA, stA, bD, stD, 0, 0] for v_{j-1}.
// Every window extends the tile by a fixed count, so a ragged last block
// takes each window shortened by tile - n_out.
//
// What bounds it on the H100: device-memory bytes, as modwt_synthesis.cu.
// The forward kernel reads J+1 planes (4 (J+1) B per sample, plus each
// window's halo and the splice rows) and writes 4 B, 32 B for J = 6 against
// 96 FMAs (0.080 ms and 0.024 ms at 128 x 65536), so fp32 CUDA cores
// suffice.  The forward design is modwt_synthesis.cu's on the
// alignment-shifted ops:
//   * a backward op, c_j[t - s l + b] (step stA = -s), is a forward read of
//     the reversed taps from (L-1) s samples earlier; the block keeps four
//     tap rows in shared memory (lo and hi, each forward and reversed, zero
//     padded after the last tap to whole steps of kRunChunk), so every op is
//     a forward run (fwd_run);
//   * each plane's window is copied with cp.async, 16 bytes at a time (each
//     window starts where its source does modulo 16 bytes); only its parts
//     outside [0, n) are zero-filled; bfloat16 is converted as it is stored;
//   * three rows of tile + S, S = (L-1)(2^J-1) (53 KB at tile 4096 for db4
//     J = 6, four blocks an SM): the running approximation, the next level's
//     and d_j's window, the next detail copied once the level is done;
//   * level j runs on stride s = 2^(j-1) with the register runs of
//     modwt_common.cuh: a thread owns kSymBlock outputs of one residue class
//     mod s, taps in steps of 8 as 16-byte broadcasts; a stride above
//     kThreads takes several passes, and a run that reaches past the level's
//     end or reads padded taps loads only what its outputs need (kGuard);
//   * the last level's outputs are stored on consecutive addresses, with
//     the first span_l taken from `head` and the last span_r from `tail`.
//
// The adjoint has the shape of an analysis: it reads 4 B a sample and
// writes 4 (J+1) B (32 B for J = 6, 0.080 ms at 128 x 65536) against the
// same 2 L J FMAs, so it too is bound by device-memory bytes, and its design
// is modwt_analysis.cu's on the transposed ops:
//   * v_0, the cotangent over its window, is copied with cp.async as the
//     forward's planes are (copy_zero_window), zero outside the interior
//     [span_l, n - span_r): the spliced outputs' cotangent goes to the head
//     and tail inverses, not to the body, so the caller needs no mask pass;
//   * every op is a forward run on the four tap rows, as in the forward;
//     v_j goes over its window (the next level's, or the tile at the last
//     level) into the other shared row, grad d_j over the block's outputs to
//     device memory, in runs of kSymBlock outputs on each residue class;
//   * as forward runs, a level's two ops read the same row a constant shift
//     apart (whatever their directions): one pair run feeds both sums from
//     each sample (fwd_pair_run) over the union of their outputs, where that
//     union is at most 5/8 of the two ranges together; past that the pair
//     run's extra sums cost more than its shared loads save (measured at
//     tile 4096: db4 J = 6, unions of 0.50-0.53, 1.23x faster merged; sym8
//     J = 8, levels 1-6 at 0.63-0.66, 1.20x slower), and each op takes its
//     own run;
//   * at strides below 8 each warp stages its 32 x kSymBlock details in a
//     buffer of its own and stores them on consecutive addresses, where the
//     buffers fit (modwt_analysis.cu's staging);
//   * two rows of tile + S + kAdjointExcess and the buffers (78 KB at the
//     launch tile, 8192, for db4 J = 6; 8192 beats 4096 by 1-17%, most at
//     sym8 J = 8, whose span is 3825), and grad a_J = v_J stored on
//     consecutive addresses.
#include "modwt_common.cuh"

namespace vw {

constexpr int kPlanStride = 8;
// Outputs a thread's forward run holds (the cascade pair's run).
constexpr int kSymBlock = kRunBlock;
// Strides whose grad d_j the adjoint stages (modwt_analysis.cu's
// kStagedStride), and its buffers: kSymBlock outputs a lane, one a warp.
constexpr int kAdjointStagedStride = 8;
constexpr int kAdjointStageFloats = kThreads * kSymBlock;
// How far an adjoint window may reach past tile + S: the grad d_j and v_j
// reads of a level sit up to a few samples apart (the alignment table's
// offsets), at most 3 for every registered wavelet; a launch whose plan
// reaches further is refused.
constexpr int kAdjointExcess = 3;

// Shared memory of one forward block: four padded tap rows and three rows
// of tile + span.
inline size_t symmetric_forward_bytes(int L, int levels, int tile) {
  return sizeof(float) *
         (4 * static_cast<size_t>(padded_taps(L)) +
          3 * static_cast<size_t>(window_row_floats(tile + cascade_span(L, levels))));
}

// The forward kernel's tile for the caller's preferred `tile` (cascade_tile).
inline int symmetric_forward_tile(int L, int levels, long long n, int tile) {
  return cascade_tile(tile, n, 1,
                      [=](int t) { return symmetric_forward_bytes(L, levels, t); });
}

// The plane `row` over [g0, g0 + count), zero outside [begin, n), into
// `base`; returns where the window starts there (its part inside the row
// starts where its source does modulo 16 bytes).  A bfloat16 window that
// starts on an odd sample (most do: the plan's windows start at odd offsets)
// copies that sample alone, so that the rest goes as 4-byte pairs.  One
// cp.async group.
template <typename T>
__device__ __forceinline__ float* copy_zero_window(float* base, const T* __restrict__ row,
                                                   long long g0, int count, long long n,
                                                   long long begin = 0) {
  const long long first = max(g0, begin);
  const long long end = min(g0 + count, n);
  const int inside = end > first ? static_cast<int>(end - first) : 0;
  const int before = inside > 0 ? static_cast<int>(first - g0) : count;
  float* w = base + (inside > 0 ? (window_offset(row + first) - before) & 3 : 0);
  for (int q = threadIdx.x; q < before; q += blockDim.x) w[q] = 0.0f;
  for (int q = before + inside + threadIdx.x; q < count; q += blockDim.x) w[q] = 0.0f;
  if (inside > 0) {
    const int lead = sizeof(T) < sizeof(float) &&
                     (reinterpret_cast<size_t>(row + first) & 3) != 0;
    if (lead && threadIdx.x == 0) w[before] = to_f32(row[first]);
    copy_row_window(w + before + lead, row + first + lead, inside - lead);
  }
  cp_async_commit();
  return w;
}

// Four blocks to an SM (64 registers a thread), as modwt_synthesis.cu.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
symmetric_synthesis_kernel(const __grid_constant__ PlanePtrs in, T* __restrict__ out,
                           const float* __restrict__ head,
                           const float* __restrict__ tail,
                           const float* __restrict__ taps,
                           const int* __restrict__ plan, long long n, int levels,
                           int L, int tile, int tiles_per_row, int span_l, int span_r) {
  extern __shared__ __align__(16) float smem[];
  const int lp = padded_taps(L);
  const int row_floats = window_row_floats(tile + cascade_span(L, levels));
  float* const s_taps = smem;  // lo, lo reversed, hi, hi reversed
  float* cur_row = smem + 4 * lp;
  float* nxt_row = cur_row + row_floats;
  float* const det_row = nxt_row + row_floats;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const int cut = tile - n_out;  // the plan's windows are for `tile` outputs

  for (int k = threadIdx.x; k < lp; k += blockDim.x) {
    const bool real = k < L;
    s_taps[k] = real ? taps[k] : 0.0f;
    s_taps[lp + k] = real ? taps[L - 1 - k] : 0.0f;
    s_taps[2 * lp + k] = real ? taps[L + k] : 0.0f;
    s_taps[3 * lp + k] = real ? taps[2 * L - 1 - k] : 0.0f;
  }
  auto plane = [&](int i) { return static_cast<const T*>(in.p[i]) + row_off; };
  // c_J = a_J and d_J over their windows
  const int* p = plan + kPlanStride * (levels - 1);
  float* cur = copy_zero_window(cur_row, plane(levels), t0 + p[0], p[1] - cut, n);
  const float* det = copy_zero_window(det_row, plane(levels - 1), t0 + p[2], p[1] - cut, n);
  for (int j = levels; j >= 1; --j) {
    p = plan + kPlanStride * (j - 1);
    const int shift = j - 1;
    const int s = 1 << shift;
    // c_{j-1}'s window, what the next level (or the tile) reads
    const int new_len = j > 1 ? p[1 - kPlanStride] - cut : n_out;
    // an op with step st < 0 reads the reversed taps from (L-1)|st| earlier
    const float* lo = s_taps + (p[4] < 0 ? lp : 0);
    const float* hi = s_taps + (p[6] < 0 ? 3 * lp : 2 * lp);
    const float* src_c = cur + p[3] + min(p[4], 0) * (L - 1);
    const float* src_d = det + p[5] + min(p[6], 0) * (L - 1);
    cp_async_wait_all();
    __syncthreads();
    const int group = max(s, kThreads);
    for (int c0 = 0; c0 < new_len; c0 += group * kSymBlock) {
      for (int pass = 0; pass < group; pass += kThreads) {
        const int q0 =
            c0 + pass + (s <= kThreads ? run_base<kSymBlock>(shift) : threadIdx.x);
        if (q0 >= new_len) continue;
        // the thread's outputs q0 + r s below the window's end
        const int lim = min(kSymBlock, (new_len - q0 + s - 1) >> shift);
        const int m_hi = lim + L - 1;
        float acc[kSymBlock];
#pragma unroll
        for (int r = 0; r < kSymBlock; ++r) acc[r] = 0.0f;
        if (lim == kSymBlock && lp == L) {
          if (s == 1) {
            level_run<true, false>(acc, src_c + q0, src_d + q0, 1, lo, hi, lp, m_hi);
          } else {
            level_run<false, false>(acc, src_c + q0, src_d + q0, s, lo, hi, lp, m_hi);
          }
        } else if (s == 1) {
          level_run<true, true>(acc, src_c + q0, src_d + q0, 1, lo, hi, lp, m_hi);
        } else {
          level_run<false, true>(acc, src_c + q0, src_d + q0, s, lo, hi, lp, m_hi);
        }
#pragma unroll
        for (int r = 0; r < kSymBlock; ++r) {
          if (r < lim) nxt_row[q0 + r * s] = acc[r];
        }
      }
    }
    __syncthreads();
    if (j > 1) {  // d_{j-1}: level j read the last of d_j
      det = copy_zero_window(det_row, plane(j - 2), t0 + p[2 - kPlanStride],
                             p[1 - kPlanStride] - cut, n);
    }
    cur = nxt_row;  // c_{j-1}; the next level writes over c_j's row
    nxt_row = cur_row;
    cur_row = cur;
  }
  const long long tail_start = n - span_r;
  T* dst = out + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const long long t = t0 + o;
    float v = cur[o];
    if (t < span_l) {
      v = head[b * span_l + t];
    } else if (t >= tail_start) {
      v = tail[b * span_r + (t - tail_start)];
    }
    dst[o] = from_f32<T>(v);
  }
}

// Floats of one adjoint row: the widest window, tile + S + kAdjointExcess.
__host__ __device__ __forceinline__ int adjoint_row_floats(int L, int levels, int tile) {
  return window_row_floats(tile + cascade_span(L, levels) + kAdjointExcess);
}

// Shared memory of one adjoint block: four padded tap rows, two rows and,
// with `stage`, the detail staging buffers.
inline size_t symmetric_adjoint_bytes(int L, int levels, int tile, bool stage) {
  return sizeof(float) * (4 * static_cast<size_t>(padded_taps(L)) +
                          2 * static_cast<size_t>(adjoint_row_floats(L, levels, tile)) +
                          (stage ? kAdjointStageFloats : 0));
}

// The adjoint block stages its details where the buffers fit.
inline bool symmetric_adjoint_stages(int L, int levels, int tile) {
  return symmetric_adjoint_bytes(L, levels, tile, true) <=
         static_cast<size_t>(kMaxSharedBytes);
}

inline size_t symmetric_adjoint_shared_bytes(int L, int levels, int tile) {
  return symmetric_adjoint_bytes(L, levels, tile, symmetric_adjoint_stages(L, levels, tile));
}

// The adjoint's tile for the caller's preferred `tile` (cascade_tile); below
// 128 only where the gates' rule, 4 (2 L + 2 width) bytes, leaves less room
// than the padded taps and rounded rows take.
inline int symmetric_adjoint_tile(int L, int levels, long long n, int tile) {
  const auto bytes_of = [=](int t) { return symmetric_adjoint_shared_bytes(L, levels, t); };
  int t = cascade_tile(tile, n, 1, bytes_of);
  for (int u = n < 64 ? static_cast<int>(n) : 64; t == 0 && u >= 1; u /= 2) {
    if (bytes_of(u) <= static_cast<size_t>(kMaxSharedBytes)) t = u;
  }
  return t;
}

// A thread's run of the adjoint: both sums from one sample (kV and kD), or
// one of them.
template <bool kV, bool kD, bool kUnit, bool kGuard>
__device__ __forceinline__ void adjoint_run(float (&a)[kSymBlock], float (&d)[kSymBlock],
                                            const float* src, int s, const float* lo,
                                            const float* hi, int taps, int m_hi) {
  if constexpr (kV && kD) {
    fwd_pair_run<kUnit, kGuard>(a, d, src, s, lo, hi, taps, m_hi);
  } else if constexpr (kV) {
    fwd_run<kUnit, kGuard>(a, src, s, lo, taps, m_hi);
  } else {
    fwd_run<kUnit, kGuard>(d, src, s, hi, taps, m_hi);
  }
}

// One adjoint level's runs on stride 2^shift over run positions [p0, p1) of
// `src`: with kV, v_j[p] = sum_i lo[i] src[p + s i] into nxt for p in
// [0, v_len); with kD, grad d_j[p - delta] = sum_i hi[i] src[p + s i] for
// p - delta in [0, n_out), into dj.  Chunks of `group` kSymBlock positions,
// each in group / kThreads passes; with kStage (strides below 8) each warp's
// details go through its buffer, `staged`.
template <bool kV, bool kD, bool kStage, typename T>
__device__ __forceinline__ void adjoint_level(const float* src, int p0, int p1, int shift,
                                              const float* lo, const float* hi, int L,
                                              int lp, float* nxt, int v_len, T* dj,
                                              int delta, int n_out, float* staged) {
  const int s = 1 << shift;
  const int group = max(s, kThreads);
  const int warp0 = static_cast<int>(threadIdx.x) & ~31;
  for (int c0 = p0; c0 < p1; c0 += group * kSymBlock) {
    for (int pass = 0; pass < group; pass += kThreads) {
      const int q0 =
          c0 + pass + (s <= kThreads ? run_base<kSymBlock>(shift) : threadIdx.x);
      float a[kSymBlock], d[kSymBlock];
#pragma unroll
      for (int r = 0; r < kSymBlock; ++r) a[r] = d[r] = 0.0f;
      // the thread's positions q0 + r s below p1
      const int lim = q0 < p1 ? min(kSymBlock, (p1 - q0 + s - 1) >> shift) : 0;
      if (lim > 0) {
        const float* w = src + q0;
        const int m_hi = lim + L - 1;
        if (lim == kSymBlock && lp == L) {
          if (s == 1) {
            adjoint_run<kV, kD, true, false>(a, d, w, 1, lo, hi, lp, m_hi);
          } else {
            adjoint_run<kV, kD, false, false>(a, d, w, s, lo, hi, lp, m_hi);
          }
        } else if (s == 1) {
          adjoint_run<kV, kD, true, true>(a, d, w, 1, lo, hi, lp, m_hi);
        } else {
          adjoint_run<kV, kD, false, true>(a, d, w, s, lo, hi, lp, m_hi);
        }
        if constexpr (kV) {
#pragma unroll
          for (int r = 0; r < kSymBlock; ++r) {
            const int p = q0 + r * s;
            if (r < lim && p >= 0 && p < v_len) nxt[p] = a[r];
          }
        }
      }
      if constexpr (kD) {
        if constexpr (kStage) {
          // the warp's 32 kSymBlock positions run on from its first, cw0
          const int cw0 = c0 + warp0 * kSymBlock;
#pragma unroll
          for (int r = 0; r < kSymBlock; ++r) staged[q0 - cw0 + r * s] = d[r];
          __syncwarp();
#pragma unroll
          for (int k = 0; k < kSymBlock; ++k) {
            const int i = 32 * k + static_cast<int>(threadIdx.x) - warp0;
            const int q = cw0 + i - delta;
            if (q >= 0 && q < n_out) dj[q] = from_f32<T>(staged[i]);
          }
          __syncwarp();
        } else {
#pragma unroll
          for (int r = 0; r < kSymBlock; ++r) {
            const int q = q0 + r * s - delta;
            if (r < lim && q >= 0 && q < n_out) dj[q] = from_f32<T>(d[r]);
          }
        }
      }
    }
  }
}

// Two blocks to an SM (128 registers a thread): at the launch tile, 8192,
// shared memory holds two blocks (78 KB each for db4 J = 6) whatever the
// registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
symmetric_adjoint_kernel(const T* __restrict__ c, const __grid_constant__ PlanePtrs out,
                         const float* __restrict__ taps,
                         const int* __restrict__ plan, long long n, int levels,
                         int L, int tile, int tiles_per_row, int span_l, int span_r,
                         int stage) {
  extern __shared__ __align__(16) float smem[];
  const int lp = padded_taps(L);
  const int row_floats = adjoint_row_floats(L, levels, tile);
  float* const s_taps = smem;  // lo, lo reversed, hi, hi reversed
  float* cur_row = smem + 4 * lp;
  float* nxt_row = cur_row + row_floats;
  // this warp's detail staging buffer
  float* const stage_buf =
      stage ? nxt_row + row_floats + (static_cast<int>(threadIdx.x) & ~31) * kSymBlock
            : nullptr;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const int cut = tile - n_out;  // the plan's windows are for `tile` outputs

  for (int k = threadIdx.x; k < lp; k += blockDim.x) {
    const bool real = k < L;
    s_taps[k] = real ? taps[k] : 0.0f;
    s_taps[lp + k] = real ? taps[L - 1 - k] : 0.0f;
    s_taps[2 * lp + k] = real ? taps[L + k] : 0.0f;
    s_taps[3 * lp + k] = real ? taps[2 * L - 1 - k] : 0.0f;
  }
  // v_0: the cotangent over its window, zero outside the interior
  float* cur = copy_zero_window(cur_row, c + row_off, t0 + plan[0], plan[1] - cut,
                                n - span_r, span_l);
  for (int j = 1; j <= levels; ++j) {
    const int* p = plan + kPlanStride * (j - 1);
    const int shift = j - 1;
    // v_j's window, what the next level (or the tile) reads
    const int v_len = j < levels ? plan[kPlanStride * j + 1] - cut : n_out;
    // an op with step st < 0 reads the reversed taps from (L-1)|st| earlier
    const float* lo = s_taps + (p[3] < 0 ? lp : 0);
    const float* hi = s_taps + (p[5] < 0 ? 3 * lp : 2 * lp);
    const float* src_a = cur + p[2] + min(p[3], 0) * (L - 1);
    const float* src_d = cur + p[4] + min(p[5], 0) * (L - 1);
    T* dj = static_cast<T*>(out.p[j - 1]) + row_off + t0;
    const bool stage_here = stage_buf != nullptr && (1 << shift) < kAdjointStagedStride;
    const int delta = static_cast<int>(src_d - src_a);
    const int p0 = min(0, delta), p1 = max(v_len, delta + n_out);
    cp_async_wait_all();
    __syncthreads();
    if (8 * (p1 - p0) <= 5 * (v_len + n_out)) {
      // one pair run over the union of both ops' positions, where it costs
      // less than two runs (the note at the head of the file)
      if (stage_here) {
        adjoint_level<true, true, true>(src_a, p0, p1, shift, lo, hi, L, lp, nxt_row, v_len,
                                        dj, delta, n_out, stage_buf);
      } else {
        adjoint_level<true, true, false>(src_a, p0, p1, shift, lo, hi, L, lp, nxt_row, v_len,
                                         dj, delta, n_out, nullptr);
      }
    } else {  // two runs, the details unstaged
      adjoint_level<true, false, false>(src_a, 0, v_len, shift, lo, hi, L, lp, nxt_row,
                                        v_len, dj, 0, n_out, nullptr);
      adjoint_level<false, true, false>(src_d, 0, n_out, shift, lo, hi, L, lp, nxt_row,
                                        v_len, dj, 0, n_out, nullptr);
    }
    cur = nxt_row;  // v_j; the next level writes over v_{j-1}'s row
    nxt_row = cur_row;
    cur_row = cur;
  }
  __syncthreads();
  T* aj = static_cast<T*>(out.p[levels]) + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) aj[o] = from_f32<T>(cur[o]);
}

template <typename T>
cudaError_t launch_symmetric(void* const* planes, void* signal, const float* head,
                             const float* tail, const float* taps, const int* plan,
                             long long batch, long long n, int levels, int L,
                             int tile, int width, int span_l, int span_r,
                             int adjoint, cudaStream_t stream) {
  PlanePtrs ptrs{};
  for (int i = 0; i <= levels; ++i) ptrs.p[i] = planes[i];
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  if (adjoint) {
    // the adjoint plan's widest window, v_0's, fits a row
    if (width > tile + cascade_span(L, levels) + kAdjointExcess) return cudaErrorInvalidValue;
    const bool stage = symmetric_adjoint_stages(L, levels, tile);
    const size_t bytes = symmetric_adjoint_bytes(L, levels, tile, stage);
    err = reserve_shared(symmetric_adjoint_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    symmetric_adjoint_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
        static_cast<const T*>(signal), ptrs, taps, plan, n, levels, L, tile,
        static_cast<int>(tiles), span_l, span_r, stage ? 1 : 0);
  } else {
    // the forward plan's widest window is c_J's, tile + span
    if (width != tile + cascade_span(L, levels)) return cudaErrorInvalidValue;
    const size_t bytes = symmetric_forward_bytes(L, levels, tile);
    err = reserve_shared(symmetric_synthesis_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    symmetric_synthesis_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes,
                                    stream>>>(
        ptrs, static_cast<T*>(signal), head, tail, taps, plan, n, levels, L, tile,
        static_cast<int>(tiles), span_l, span_r);
  }
  return cudaGetLastError();
}

}  // namespace vw

// Forward (adjoint = 0): planes d_1..d_J, a_J -> signal, with the splice from
// head [batch, span_l] and tail [batch, span_r] (fp32); `tile` is the one
// vw_modwt_symmetric_synthesis_tile gives, and the plan is made for it.
// Adjoint (adjoint = 1): signal -> planes, the signal read as zero outside
// [span_l, n - span_r); head and tail are not read; `tile` is the one
// vw_modwt_symmetric_adjoint_tile gives, and the plan is made for it.
// plan: kPlanStride ints per level on the device; width: the longest window
// of the plan.
extern "C" int vw_modwt_symmetric_synthesis(
    void* const* planes, void* signal, const void* head, const void* tail,
    const void* taps, const void* plan, long long batch, long long n, int levels,
    int taps_len, int tile, int width, int span_l, int span_r, int adjoint,
    int dtype, void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || width < tile ||
      span_l < 0 || span_r < 0 || span_l + span_r > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* h = static_cast<const float*>(head);
  const float* tl = static_cast<const float*>(tail);
  const float* t = static_cast<const float*>(taps);
  const int* p = static_cast<const int*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_symmetric<float>(planes, signal, h, tl, t, p, batch, n, levels,
                                      taps_len, tile, width, span_l, span_r, adjoint, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_symmetric<__nv_bfloat16>(planes, signal, h, tl, t, p, batch, n,
                                              levels, taps_len, tile, width, span_l,
                                              span_r, adjoint, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The forward kernel's tile for a preferred `tile` (clamped to the row,
// halved until a block fits shared memory); 0 where none fits.
extern "C" int vw_modwt_symmetric_synthesis_tile(int taps_len, int levels, long long n,
                                                 int tile) {
  return vw::valid_config(1, n, levels, taps_len, tile)
             ? vw::symmetric_forward_tile(taps_len, levels, n, tile)
             : 0;
}

// Shared memory of one forward block at `tile`, in bytes.
extern "C" long long vw_modwt_symmetric_synthesis_shared_bytes(int taps_len, int levels,
                                                               int tile) {
  return vw::valid_config(1, 1, levels, taps_len, tile)
             ? static_cast<long long>(vw::symmetric_forward_bytes(taps_len, levels, tile))
             : 0;
}

// The adjoint kernel's tile for a preferred `tile` (clamped to the row,
// halved until a block fits shared memory, below 128 only where the gates'
// rule leaves less room than the block's layout takes); 0 where none fits.
extern "C" int vw_modwt_symmetric_adjoint_tile(int taps_len, int levels, long long n,
                                               int tile) {
  return vw::valid_config(1, n, levels, taps_len, tile)
             ? vw::symmetric_adjoint_tile(taps_len, levels, n, tile)
             : 0;
}

// Shared memory of one adjoint block at `tile`, in bytes.
extern "C" long long vw_modwt_symmetric_adjoint_shared_bytes(int taps_len, int levels,
                                                             int tile) {
  return vw::valid_config(1, 1, levels, taps_len, tile)
             ? static_cast<long long>(
                   vw::symmetric_adjoint_shared_bytes(taps_len, levels, tile))
             : 0;
}
