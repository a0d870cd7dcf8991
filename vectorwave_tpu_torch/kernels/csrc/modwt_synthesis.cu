// J-level inverse MODWT in one pass: d_1..d_J, a_J -> x.
//
// Replaces two TPU kernels of vectorwave_tpu/kernels/modwt_mxu.py:
// `_composite_synthesis_call`, which sums every plane filtered with forward
// reads by its composite reconstruction filter, as banded 128x128 bf16
// matmuls, and `_mxu_synthesis_call`, which runs the inverse cascade level
// by level as banded 128x128 matmuls, the arithmetic of this kernel.  Here
// the block runs the inverse cascade from coarse to fine in shared memory,
// with forward reads,
//     c_{j-1}[p] = sum_k lo[k] c_j[p + 2^{j-1} k] + hi[k] d_j[p + 2^{j-1} k],
// starting from c_J = a_J; it equals the composite form exactly for periodic
// and zero right edges and costs 2 L J FMAs per sample.  With the analysis
// taps it is the exact adjoint of modwt_analysis.cu, so it is also that
// kernel's gradient.
//
// What bounds it on the H100: device-memory bytes.  The kernel reads J+1
// planes (4 (J+1) B per sample, plus each tile's right halo of S =
// (L-1)(2^J-1) samples) and writes 4 B, 32 B for J = 6 against 96 FMAs, so
// fp32 CUDA cores suffice.  The design, the analysis kernel's with forward
// reads (as modwt_bank_synthesis.cu is modwt_bank_analysis.cu's):
//   * each plane's window is copied into shared memory with cp.async, 16
//     bytes at a time (the rows start where the planes do modulo 16 bytes),
//     and only its samples past the row's end take the edge rule;
//   * three rows of tile + S (53 KB at tile 4096 for db4 J = 6, four blocks
//     an SM): the running approximation, the next level's, and d_j's
//     window, copied while the block waits (a second detail buffer, the
//     next copy in flight during a level's arithmetic, measured 2-4% slower
//     at tile 4096: it leaves three blocks an SM);
//   * level j runs on stride s = 2^(j-1) with the register blocks of
//     modwt_common.cuh: a thread owns kRunBlock = 9 outputs of one residue
//     class mod s, output r reading w[r + i] for tap i, so a step of 8 taps
//     loads 8 samples of c_j (and then of d_j) for 72 FMAs, with the taps,
//     padded with zeros to whole steps, as 16-byte broadcasts;
//   * a stride above kThreads (s = 512 at J = 10) takes s / kThreads passes,
//     and a run that reaches past the level's end or reads the padded taps
//     loads only what its outputs need;
//   * each level's result goes to a shared row; the last is stored on
//     consecutive addresses.
// Every precision tier (float32, bf16_3x, bf16) runs this same fp32 kernel,
// which meets each tier's error contract; bfloat16 windows are converted as
// they are stored (no cp.async).
//
// External right halo (`halo=` of `run_synthesis_composite`, the tiled
// tier's neighbour exchange): `halos` holds, for each of the J+1 planes, the
// [batch, halo_len] samples just right of the row's end, in the input type,
// and the windows read them through load_right_halo: the row below n, the
// halo on [n, n + halo_len), zeros after it.  The extended row is then a
// zero-edge row with the halo behind it, so the zero edge's bookkeeping
// holds unchanged, any halo_len >= 1 and any n (a span longer than the tile
// reads the halo from several blocks of a row).  The TPU pads the halo into
// 128-lane rows; here it is read in place.  The J+1 halo pointers travel by
// value, like the planes'.
#include "modwt_common.cuh"

namespace vw {

// Shared memory of one block: the padded tap pair, two rows for the running
// approximation and one for the detail, each of tile + span.
inline size_t synthesis_shared_bytes(int L, int levels, int tile) {
  return sizeof(float) *
         (2 * static_cast<size_t>(padded_taps(L)) +
          3 * static_cast<size_t>(window_row_floats(tile + cascade_span(L, levels))));
}

// The tile a launch uses for the caller's preferred `tile` (cascade_tile).
inline int synthesis_tile(int L, int levels, long long n, int tile) {
  return cascade_tile(tile, n, 1, [=](int t) { return synthesis_shared_bytes(L, levels, t); });
}

// Four blocks to an SM (64 registers a thread) where shared memory holds
// them: measured faster than three with more registers at every tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
modwt_synthesis_kernel(const __grid_constant__ PlanePtrs in,
                       const __grid_constant__ PlanePtrs halos, int halo_len,
                       T* __restrict__ out, const float* __restrict__ taps,
                       long long n, int levels, int L, int tile,
                       int tiles_per_row, int periodic) {
  extern __shared__ __align__(16) float smem[];
  const int span = cascade_span(L, levels);
  const int lp = padded_taps(L);
  const int row_floats = window_row_floats(tile + span);
  float* s_lo = smem;
  float* s_hi = smem + lp;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const long long halo_off = b * halo_len;
  // every row starts where a_J's window does modulo 16 bytes
  const int off = window_offset(static_cast<const T*>(in.p[levels]) + row_off + t0);
  float* cur = smem + 2 * lp + off;
  float* nxt = cur + row_floats;
  float* const det = nxt + row_floats;
  // dst[0 .. count) = plane i over [t0, t0 + count), extended past n by the
  // right halo or the edge rule; one cp.async group
  auto copy = [&](float* dst, int i, int count) {
    const T* row = static_cast<const T*>(in.p[i]) + row_off;
    const int inside = static_cast<int>(min(static_cast<long long>(count), n - t0));
    copy_row_window(dst, row + t0, inside);
    for (int q = inside + threadIdx.x; q < count; q += blockDim.x) {
      const long long g = t0 + q;
      dst[q] = halo_len > 0
                   ? load_right_halo(row, static_cast<const T*>(halos.p[i]) + halo_off,
                                     halo_len, g, n)
                   : load_ext(row, g, n, periodic != 0);
    }
    cp_async_commit();
  };

  for (int k = threadIdx.x; k < lp; k += blockDim.x) {
    s_lo[k] = k < L ? taps[k] : 0.0f;
    s_hi[k] = k < L ? taps[L + k] : 0.0f;
  }
  // c_J = a_J and d_J over the window [t0, t0 + n_out + span), what the
  // tile's outputs read
  int valid_end = n_out + span;  // the current level is exact on [0, valid_end)
  copy(cur, levels, valid_end);
  copy(det, levels - 1, valid_end);
  for (int j = levels; j >= 1; --j) {
    const int shift = j - 1;
    const int s = 1 << shift;
    const int new_end = valid_end - (L - 1) * s;
    cp_async_wait_all();
    __syncthreads();
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
            level_run<true, false>(acc, cur + q0, det + q0, 1, s_lo, s_hi, lp, m_hi);
          } else {
            level_run<false, false>(acc, cur + q0, det + q0, s, s_lo, s_hi, lp, m_hi);
          }
        } else if (s == 1) {
          level_run<true, true>(acc, cur + q0, det + q0, 1, s_lo, s_hi, lp, m_hi);
        } else {
          level_run<false, true>(acc, cur + q0, det + q0, s, s_lo, s_hi, lp, m_hi);
        }
#pragma unroll
        for (int r = 0; r < kRunBlock; ++r) {
          if (r < lim) nxt[q0 + r * s] = acc[r];
        }
      }
    }
    __syncthreads();
    if (j > 1) copy(det, j - 2, new_end);  // d_{j-1}: level j read the last of d_j
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    valid_end = new_end;
  }
  T* dst = out + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) dst[o] = from_f32<T>(cur[o]);
}

template <typename T>
cudaError_t launch_synthesis(const void* const* ins, const void* const* halo_ptrs,
                             int halo_len, void* out, const float* taps,
                             long long batch, long long n, int levels, int L,
                             int tile, int periodic, cudaStream_t stream) {
  PlanePtrs planes{};
  PlanePtrs halos{};
  for (int i = 0; i <= levels; ++i) {
    planes.p[i] = const_cast<void*>(ins[i]);
    if (halo_len > 0) halos.p[i] = const_cast<void*>(halo_ptrs[i]);
  }
  tile = synthesis_tile(L, levels, n, tile);
  if (tile == 0) return cudaErrorInvalidValue;
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = synthesis_shared_bytes(L, levels, tile);
  cudaError_t err = reserve_shared(modwt_synthesis_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  modwt_synthesis_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      planes, halos, halo_len, static_cast<T*>(out), taps, n, levels, L, tile,
      static_cast<int>(tiles), periodic);
  return cudaGetLastError();
}

}  // namespace vw

// `halos` (J+1 pointers to [batch, halo_len] rows) and halo_len > 0 select
// the external right edge; periodic must then be 0.  `tile` is the preferred
// tile: the launch uses vw_modwt_synthesis_tile's.
extern "C" int vw_modwt_synthesis(const void* const* ins, const void* const* halos,
                                  int halo_len, void* out, const void* taps,
                                  long long batch, long long n, int levels,
                                  int taps_len, int tile, int periodic, int dtype,
                                  void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || halo_len < 0 ||
      (halo_len > 0 && (halos == nullptr || periodic != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* t = static_cast<const float*>(taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_synthesis<float>(ins, halos, halo_len, out, t, batch, n, levels,
                                      taps_len, tile, periodic, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_synthesis<__nv_bfloat16>(ins, halos, halo_len, out, t, batch, n,
                                              levels, taps_len, tile, periodic, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tile of a launch for a preferred `tile` (clamped to the row, halved
// until a block fits shared memory); 0 where none fits.
extern "C" int vw_modwt_synthesis_tile(int taps_len, int levels, long long n, int tile) {
  return vw::valid_config(1, n, levels, taps_len, tile)
             ? vw::synthesis_tile(taps_len, levels, n, tile)
             : 0;
}

// Shared memory of one block at `tile`, in bytes.
extern "C" long long vw_modwt_synthesis_shared_bytes(int taps_len, int levels, int tile) {
  return vw::valid_config(1, 1, levels, taps_len, tile)
             ? static_cast<long long>(vw::synthesis_shared_bytes(taps_len, levels, tile))
             : 0;
}
