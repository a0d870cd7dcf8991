// J-level MODWT analysis in one pass: x -> d_1..d_J, a_J.
//
// Replaces two TPU kernels of vectorwave_tpu/kernels/modwt_mxu.py:
// `_composite_analysis_call`, which computes every plane directly from x
// with a precomposed composite filter as banded 128x128 bf16 matmuls (the
// only fast path of the TPU's matrix unit), and `_mxu_analysis_call`, which
// runs the per-level cascade as banded 128x256 matmuls, with an optional
// per-level mirror.  Here the plane filters are not composed: the block runs
// the per-level a trous cascade in shared memory,
//     a_j[p] = sum_k lo[k] a_{j-1}[p - 2^{j-1} k],
//     d_j[p] = sum_k hi[k] a_{j-1}[p - 2^{j-1} k],
// which equals the composite form exactly for periodic and zero edges (both
// are causal) and costs 2 L J FMAs per sample (96 for db4 at J = 6) instead
// of the composite's 1288.
//
// What bounds it on the H100: device-memory bytes.  The kernel reads 4 B
// and writes 4 (J+1) B per sample (32 B for J = 6: 0.080 ms for 128 x 65536
// at 3.35 TB/s) against 2 L J FMAs (96 for db4 J = 6: 0.024 ms at 67
// TFLOP/s fp32), so fp32 CUDA cores suffice and tensor cores would not
// help.  The cascade reaches back over a halo of S = (L-1)(2^J-1) samples,
// so a block recomputes a window of tile + S samples (441 of 4096 for db4
// J = 6).  The design keeps that arithmetic and its shared-memory traffic
// near the byte time (measured, its own instruction rate and latency hold
// it at about 56% of the byte bound):
//   * the window of x is copied into shared memory with cp.async, 16 bytes
//     at a time (the row starts where the source does modulo 16 bytes), and
//     only its samples before the signal start take the edge rule;
//   * level j runs on stride s = 2^(j-1) with the register blocks of
//     modwt_common.cuh (run_base): a thread owns kRunBlock = 9 outputs of
//     one residue class mod s, so one step of 8 taps loads 8 samples, each
//     feeding the lo and the hi sum, and 4 broadcast 16-byte tap loads, for
//     144 FMAs (the taps padded with zeros to whole steps);
//   * a stride above kThreads (s = 512 at J = 10) takes s / kThreads passes
//     of kThreads residues each;
//   * a thread's run that reaches past the window's end or reads the padded
//     taps loads only the samples its outputs need (kGuard);
//   * the approximation goes to the next level's row in shared memory; the
//     detail is stored from registers, except at s < 8, where a thread's
//     outputs are too far apart for full 32-byte sectors: there each warp
//     stages its 32 x 9 contiguous outputs in a buffer of its own and stores
//     them on consecutive addresses (where the buffer fits shared memory);
//   * the row pair and the buffers take 45 KB at tile 4096 for db4 J = 6.
// Every precision tier (float32, bf16_3x, bf16) runs this same fp32
// kernel, which meets each tier's error contract.  In bfloat16 the
// approximations stay fp32 between levels (the TPU cascade rounds each to
// bf16), and the window is converted as it is stored (no cp.async).
//
// Edges (`edge`, CascadeEdge): zero, periodic, mirror or external.  The mirror is the
// symmetric analysis: before level j, the level's input at g in
// [-(L-1) 2^(j-1), 0) is its own value at -1 - g (a half-point reflection at
// the signal start; level 1 reflects x as the window loads).  That is exact
// for n >= (L-1) 2^(J-1), where the reflection's source lies in the signal;
// shorter signals need the period-2n extension and take the plain path.  A
// block whose window starts before 0 (t0 < S, block 0 and, with a small
// tile, a few after it) reflects its own window, which needs the sources
// [0, (L-1) 2^(J-1)) in it: the tile is at least that long.  Those blocks'
// outputs at p >= 0 stay exact at every level, as the cascade's validity
// bookkeeping below assumes for zero and periodic edges; values it computes
// before 0 are overwritten by the next reflection or never read.
//
// External edge (`edge="external"` of `_composite_analysis_call`, the
// streaming tier's carry and the tiled tier's neighbour exchange): `halo`
// holds each row's left neighbour, [batch, halo_len] in the input type, and
// the window reads halo[halo_len + g] for g < 0 (0 before the halo) and 0
// past n (load_halo).  The extended row is then a zero-edge row with the
// halo in front, so the zero edge's validity bookkeeping holds unchanged: a
// block whose window starts before 0 (t0 < S; with a span longer than the
// tile, several blocks of a row) reads the halo as it loads its window, and
// a halo shorter than S reads zeros before it, as the plain version, the
// zero-edge cascade of [halo | x] sliced back to n, does.
//
// Head splice (`head_samples` of `_composite_analysis_call`): with a `head`
// of [J+1, batch, head_samples] fp32 values, every plane's outputs at
// positions < head_samples are stored from it instead of from the cascade.
// The streaming tier's symmetric first block calls it together with the
// external edge: the head of the plain symmetric cascade of the block's
// first S samples replaces the outputs the mirror reaches.  It is a
// template flag (kSplice): a launch without a head runs a kernel whose
// stores do not test for one.
#include "modwt_common.cuh"

namespace vw {

// Floats of the detail staging buffers: kRunBlock outputs a lane, 32 lanes
// a warp, one buffer a warp.
constexpr int kStageFloats = kThreads * kRunBlock;
// Strides whose details are staged: below 8 a thread's outputs leave gaps
// in every 32-byte sector a warp store touches.
constexpr int kStagedStride = 8;

// Shared memory of one block: the padded tap pair, two window rows of
// tile + span, and, with `stage`, the detail staging buffers.
inline size_t analysis_bytes(int L, int levels, int tile, bool stage) {
  return sizeof(float) *
         (2 * static_cast<size_t>(padded_taps(L)) +
          2 * static_cast<size_t>(window_row_floats(tile + cascade_span(L, levels))) +
          (stage ? kStageFloats : 0));
}

// The block stages the details where the buffers fit shared memory.
inline bool analysis_stages(int L, int levels, int tile) {
  return analysis_bytes(L, levels, tile, true) <= static_cast<size_t>(kMaxSharedBytes);
}

inline size_t analysis_shared_bytes(int L, int levels, int tile) {
  return analysis_bytes(L, levels, tile, analysis_stages(L, levels, tile));
}

// The tile a launch uses for the caller's preferred `tile` (cascade_tile);
// the mirror's holds at least its reach, (L - 1) 2^(J-1).
inline int analysis_tile(int L, int levels, long long n, int tile, int edge) {
  return cascade_tile(tile, n, edge == kCascadeMirror ? level_reach(L, levels) : 1,
                      [=](int t) { return analysis_shared_bytes(L, levels, t); });
}

// kSplice: the head splice; without it no store looks at `head`.
template <typename T, bool kSplice>
__global__ void __launch_bounds__(kThreads, 3)
modwt_analysis_kernel(const T* __restrict__ x, const __grid_constant__ PlanePtrs out,
                      const float* __restrict__ taps,
                      const float* __restrict__ head, int head_samples,
                      const T* __restrict__ halo, int halo_len,
                      long long n, int levels, int L, int tile,
                      int tiles_per_row, int edge, int stage) {
  extern __shared__ __align__(16) float smem[];
  const int span = cascade_span(L, levels);
  const int lp = padded_taps(L);
  const int row_floats = window_row_floats(tile + span);
  float* s_lo = smem;
  float* s_hi = smem + lp;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const T* row = x + row_off;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  // head values of this row, plane p at head_row + p * head_plane
  const long long head_plane = static_cast<long long>(gridDim.x / tiles_per_row) *
                               head_samples;
  const float* head_row = head == nullptr ? nullptr : head + b * head_samples;
  const T* halo_row = halo == nullptr ? nullptr : halo + b * halo_len;
  const int head_end =
      kSplice ? static_cast<int>(min(static_cast<long long>(n_out),
                                     max(static_cast<long long>(head_samples) - t0, 0LL)))
              : 0;

  for (int k = threadIdx.x; k < lp; k += blockDim.x) {
    s_lo[k] = k < L ? taps[k] : 0.0f;
    s_hi[k] = k < L ? taps[L + k] : 0.0f;
  }
  // window [t0 - span, t0 + n_out) of the extended signal, what the tile's
  // outputs read; its first `before` samples lie before the signal start
  const int width = n_out + span;
  const long long g0 = t0 - span;
  const int before = static_cast<int>(max(-g0, 0LL));
  const int off = window_offset(row + g0 + before) - (before & 3);
  float* cur = smem + 2 * lp + (off & 3);
  float* nxt = cur + row_floats;
  // this warp's detail staging buffer; the warp's first thread
  const int warp0 = static_cast<int>(threadIdx.x) & ~31;
  float* staged = stage ? smem + 2 * lp + 2 * row_floats + warp0 * kRunBlock : nullptr;
  for (int q = threadIdx.x; q < before; q += blockDim.x) {
    cur[q] = load_edge(row, halo_row, halo_len, g0 + q, n, edge);
  }
  copy_row_window(cur + before, row + g0 + before, width - before);
  cp_async_wait_all();
  __syncthreads();

  int valid = 0;  // first window index where the current level is exact
  for (int j = 1; j <= levels; ++j) {
    const int shift = j - 1;
    const int s = 1 << shift;
    if (edge == kCascadeMirror && j > 1 && before > 0) {
      // window index q holds g = q - before; g in [-reach, 0) takes the
      // value at -1 - g, window index 2 before - 1 - q
      for (int q = max(before - level_reach(L, j), 0) + threadIdx.x; q < before;
           q += blockDim.x) {
        cur[q] = cur[2 * before - 1 - q];
      }
      __syncthreads();
    }
    const int first = valid + (L - 1) * s;
    T* dj = static_cast<T*>(out.p[j - 1]) + row_off + t0;
    auto store = [&](int o, float v) {  // output o of d_j, if the tile holds it
      if (o >= 0 && o < n_out) {
        dj[o] = from_f32<T>(kSplice && o < head_end
                                ? head_row[(j - 1) * head_plane + t0 + o] : v);
      }
    };
    const bool stage_here = staged != nullptr && s < kStagedStride;
    // outputs [first, width): chunks of `group` kRunBlock outputs, each in
    // group / kThreads passes
    const int group = max(s, kThreads);
    for (int c0 = first; c0 < width; c0 += group * kRunBlock) {
      for (int p = 0; p < group; p += kThreads) {
        const int q0 = c0 + p + (s <= kThreads ? run_base(shift) : threadIdx.x);
        float a[kRunBlock], d[kRunBlock];
#pragma unroll
        for (int r = 0; r < kRunBlock; ++r) a[r] = d[r] = 0.0f;
        // the thread's outputs q0 + r s below the window's end
        const int lim = q0 < width ? min(kRunBlock, (width - q0 + s - 1) >> shift) : 0;
        if (lim > 0) {
          const float* src = cur + q0;
          const int m_lo = 1 - L;
          if (lim == kRunBlock && lp == L) {
            if (s == 1) {
              pair_run<true, false>(a, d, src, 1, s_lo, s_hi, lp, m_lo, lim);
            } else {
              pair_run<false, false>(a, d, src, s, s_lo, s_hi, lp, m_lo, lim);
            }
          } else if (s == 1) {
            pair_run<true, true>(a, d, src, 1, s_lo, s_hi, lp, m_lo, lim);
          } else {
            pair_run<false, true>(a, d, src, s, s_lo, s_hi, lp, m_lo, lim);
          }
#pragma unroll
          for (int r = 0; r < kRunBlock; ++r) {
            if (r < lim) nxt[q0 + r * s] = a[r];
          }
        }
        if (stage_here) {
          // the warp's 32 kRunBlock outputs run on from its first, cw0
          const int cw0 = c0 + warp0 * kRunBlock;
#pragma unroll
          for (int r = 0; r < kRunBlock; ++r) staged[q0 - cw0 + r * s] = d[r];
          __syncwarp();
#pragma unroll
          for (int k = 0; k < kRunBlock; ++k) {
            const int i = 32 * k + static_cast<int>(threadIdx.x) - warp0;
            store(cw0 + i - span, staged[i]);
          }
          __syncwarp();
        } else {
#pragma unroll
          for (int r = 0; r < kRunBlock; ++r) {
            if (r < lim) store(q0 + r * s - span, d[r]);
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
  T* aj = static_cast<T*>(out.p[levels]) + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    aj[o] = from_f32<T>(kSplice && o < head_end ? head_row[levels * head_plane + t0 + o]
                                                : cur[span + o]);
  }
}

template <typename T, bool kSplice>
cudaError_t launch_analysis_kernel(const void* x, void* const* outs, const float* taps,
                                   const float* head, int head_samples,
                                   const void* halo, int halo_len, long long batch,
                                   long long n, int levels, int L, int tile, int edge,
                                   cudaStream_t stream) {
  PlanePtrs planes{};
  for (int i = 0; i <= levels; ++i) planes.p[i] = outs[i];
  tile = analysis_tile(L, levels, n, tile, edge);
  if (tile == 0) return cudaErrorInvalidValue;
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool stage = analysis_stages(L, levels, tile);
  const size_t bytes = analysis_bytes(L, levels, tile, stage);
  cudaError_t err = reserve_shared(modwt_analysis_kernel<T, kSplice>, bytes);
  if (err != cudaSuccess) return err;
  modwt_analysis_kernel<T, kSplice><<<static_cast<unsigned>(blocks), kThreads, bytes,
                                      stream>>>(
      static_cast<const T*>(x), planes, taps, head, head_samples,
      static_cast<const T*>(halo), halo_len, n, levels, L, tile,
      static_cast<int>(tiles), edge, stage ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_analysis(const void* x, void* const* outs, const float* taps,
                            const float* head, int head_samples, const void* halo,
                            int halo_len, long long batch, long long n, int levels,
                            int L, int tile, int edge, cudaStream_t stream) {
  return head == nullptr
             ? launch_analysis_kernel<T, false>(x, outs, taps, head, head_samples, halo,
                                                halo_len, batch, n, levels, L, tile,
                                                edge, stream)
             : launch_analysis_kernel<T, true>(x, outs, taps, head, head_samples, halo,
                                               halo_len, batch, n, levels, L, tile, edge,
                                               stream);
}

}  // namespace vw

// head: null (no splice) or [levels + 1, batch, head_samples] fp32 values.
// halo: [batch, halo_len] values of x's type, given with the external edge
// only.  edge: vw::CascadeEdge; the mirror takes n >= (L - 1) 2^(levels-1).
// `tile` is the preferred tile: the launch uses vw_modwt_analysis_tile's.
extern "C" int vw_modwt_analysis(const void* x, void* const* outs,
                                 const void* taps, const void* head,
                                 int head_samples, const void* halo, int halo_len,
                                 long long batch, long long n, int levels,
                                 int taps_len, int tile, int edge, int dtype,
                                 void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || head_samples < 0 ||
      (head == nullptr) != (head_samples == 0) || edge < vw::kCascadeZero ||
      edge > vw::kCascadeExternal ||
      (edge == vw::kCascadeExternal) != (halo != nullptr) ||
      (halo == nullptr) != (halo_len == 0) || halo_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (edge == vw::kCascadeMirror && n < vw::level_reach(taps_len, levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* t = static_cast<const float*>(taps);
  const float* h = static_cast<const float*>(head);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_analysis<float>(x, outs, t, h, head_samples, halo, halo_len,
                                     batch, n, levels, taps_len, tile, edge, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_analysis<__nv_bfloat16>(x, outs, t, h, head_samples, halo,
                                             halo_len, batch, n, levels, taps_len,
                                             tile, edge, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tile of a launch for a preferred `tile` (clamped to the row, halved
// until a block fits shared memory, the mirror's at least its reach); 0 where
// none fits.
extern "C" int vw_modwt_analysis_tile(int taps_len, int levels, long long n, int tile,
                                      int edge) {
  return vw::valid_config(1, n, levels, taps_len, tile)
             ? vw::analysis_tile(taps_len, levels, n, tile, edge)
             : 0;
}

// Shared memory of one block at `tile`, in bytes.
extern "C" long long vw_modwt_analysis_shared_bytes(int taps_len, int levels, int tile) {
  return vw::valid_config(1, 1, levels, taps_len, tile)
             ? static_cast<long long>(vw::analysis_shared_bytes(taps_len, levels, tile))
             : 0;
}
