// Exact-tier inverse MODWT in one pass: (hi, lo) pairs of d_j0 .. d_{j0+K-1}
// and a_{j0+K-1} -> the (hi, lo) pair of the level j0 - 1 approximation
// (x itself for j0 = 1).
//
// Replaces the TPU kernel vectorwave_tpu/kernels/modwt_exact.py
// `_exact_synthesis_call`, which sums every double-float plane filtered by
// its composite reconstruction filter as error-free sliced bf16 matmuls
// combined with two_sum chains (the TPU's matrix unit has no f32 or f64
// path).  Here the block runs the inverse cascade of modwt_synthesis.cu from
// coarse to fine in fp64 FMA on fp64 taps, with forward reads,
//     c_{j-1}[p] = sum_k lo[k] c_j[p + 2^{j-1} k] + hi[k] d_j[p + 2^{j-1} k],
// starting from c = the approximation; it equals the composite form for
// periodic and zero right edges.  Pairs are read as hi + lo in double and
// the result is written as a float32 (hi, lo) pair (store_pair), so hi is
// the correctly rounded float32 reconstruction.
//
// `first` is the level of the finest stage: a deep cascade whose halo does
// not fit shared memory runs as several launches from coarse to fine, each
// taking the previous one's output pair as its approximation.  `direct`
// serves one level whose halo alone does not fit shared memory: each output
// reads its 2 L inputs straight from device memory.
//
// External right halo (`halo=` of `synthesis_exact`, the tiled exact tier's
// neighbour exchange): `halos` holds, for each of the K+1 planes, a (hi, lo)
// pair of [batch, halo_len] samples just right of the row's end: the plane
// below n, the halo pair on [n, n + halo_len), zeros after it.  Only a
// one-launch window plan takes it;
// the wrapper runs a split plan on [plane | halo] with zero edges instead.
//
// What bounds it on the H100: device-memory bytes.  Per sample it reads
// 8 (K+1) B and writes 8 B (64 B for K = 6: 0.160 ms at 128 x 65536 and
// 3.35 TB/s), plus each tile's right halo of S = (L-1)(2^K-1) samples per
// plane, against 2 L K fp64 FMAs (96 for db4: 0.047 ms at 34 TFLOP/s fp64).
// The design, modwt_synthesis.cu's in fp64:
//   * each plane's window arrives by cp.async as a float hi row and a float
//     lo row, 16 bytes at a time (each row starts where its plane does
//     modulo 16 bytes); only its samples past n take the edge rule or the
//     right halo pair;
//   * a run combines hi + lo into a double as it loads a sample, and the
//     running approximation stays in double rows;
//   * level j runs on stride s = 2^(j-1) with the register runs of
//     modwt_common.cuh in fp64: a thread owns kExactBlock outputs of one
//     residue class mod s, taps in steps of kExactBlock - 1 read as 16-byte
//     broadcasts (padded with zeros to whole steps of 8); a stride above
//     kThreads takes several passes, and a run that reaches past the level's
//     end or reads padded taps loads only what its outputs need;
//   * shared memory is the fp64 taps and three slots of tile + S doubles,
//     each a (hi, lo) window or a double row: the approximation, the
//     detail and the level's output; the next detail is copied once the
//     level is done (a fourth slot, that copy in flight during the level's
//     arithmetic, measured 2% slower at its best tile, 3072, than one slot
//     at 4096, where two blocks share an SM);
//   * the result is stored as (hi, lo) on consecutive addresses.
#include "modwt_common.cuh"

namespace vw {

// Outputs a thread's run holds, taps in steps of kExactBlock - 1: the fp32
// kernels' run, measured faster than 3 and 5 (tools/ab_port_kernels.py
// xvariants), 128 registers and no spills at two blocks an SM.
constexpr int kExactBlock = 9;

// Shared memory of one block: the padded fp64 tap pair and three slots of
// tile + span doubles (rounded as window rows).
inline size_t exact_synthesis_shared_bytes(int L, int first, int levels, int tile) {
  return sizeof(double) *
         (2 * static_cast<size_t>(padded_taps(L)) +
          3 * static_cast<size_t>(
                  window_row_floats(tile + cascade_span_from(L, first, levels))));
}

// The tile a launch uses for the caller's preferred `tile` (cascade_tile).
inline int exact_synthesis_tile(int L, int first, int levels, long long n, int tile) {
  return cascade_tile(tile, n, 1, [=](int t) {
    return exact_synthesis_shared_bytes(L, first, levels, t);
  });
}

// One level of the inverse cascade: out[q] for q < new_end from the running
// approximation c (a (hi, lo) window or a double row) and the detail d.
template <typename SrcC>
__device__ __forceinline__ void exact_level(double* out, const SrcC& c, const PairRow& d,
                                            int shift, int new_end, const double* lo,
                                            const double* hi, int lp, int L) {
  const int s = 1 << shift;
  const int group = max(s, kThreads);
  for (int c0 = 0; c0 < new_end; c0 += group * kExactBlock) {
    for (int p = 0; p < group; p += kThreads) {
      const int q0 =
          c0 + p + (s <= kThreads ? run_base<kExactBlock>(shift) : threadIdx.x);
      if (q0 >= new_end) continue;
      // the thread's outputs q0 + r s below the level's end
      const int lim = min(kExactBlock, (new_end - q0 + s - 1) >> shift);
      const int m_hi = lim + L - 1;
      double acc[kExactBlock];
#pragma unroll
      for (int r = 0; r < kExactBlock; ++r) acc[r] = 0.0;
      if (lim == kExactBlock && lp == L) {
        if (s == 1) {
          level_run<true, false>(acc, c + q0, d + q0, 1, lo, hi, lp, m_hi);
        } else {
          level_run<false, false>(acc, c + q0, d + q0, s, lo, hi, lp, m_hi);
        }
      } else if (s == 1) {
        level_run<true, true>(acc, c + q0, d + q0, 1, lo, hi, lp, m_hi);
      } else {
        level_run<false, true>(acc, c + q0, d + q0, s, lo, hi, lp, m_hi);
      }
#pragma unroll
      for (int r = 0; r < kExactBlock; ++r) {
        if (r < lim) out[q0 + r * s] = acc[r];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
modwt_exact_synthesis_kernel(const __grid_constant__ PairPtrs in,
                             const __grid_constant__ PairPtrs halos, int halo_len,
                             float* __restrict__ out_hi,
                             float* __restrict__ out_lo,
                             const double* __restrict__ taps, long long n,
                             int first, int levels, int L, int tile,
                             int tiles_per_row, int periodic, int direct) {
  extern __shared__ __align__(16) double smem_d[];
  const int lp = padded_taps(L);
  double* s_lo = smem_d;
  double* s_hi = smem_d + lp;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const long long halo_off = b * halo_len;

  for (int k = threadIdx.x; k < lp; k += blockDim.x) {
    s_lo[k] = k < L ? taps[k] : 0.0;
    s_hi[k] = k < L ? taps[L + k] : 0.0;
  }
  if (direct) {  // one level, no window
    __syncthreads();
    const int s = 1 << (first - 1);
    const float* dh = static_cast<const float*>(in.p[0]) + row_off;
    const float* dl = static_cast<const float*>(in.p[1]) + row_off;
    const float* ah = static_cast<const float*>(in.p[2]) + row_off;
    const float* al = static_cast<const float*>(in.p[3]) + row_off;
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
      double c = 0.0;
      for (int k = 0; k < L; ++k) {
        const long long g = t0 + o + static_cast<long long>(k) * s;
        c = fma(s_lo[k], load_ext_pair(ah, al, g, n, periodic != 0), c);
        c = fma(s_hi[k], load_ext_pair(dh, dl, g, n, periodic != 0), c);
      }
      store_pair(out_hi + row_off + t0, out_lo + row_off + t0, o, c);
    }
    return;
  }
  const int span = cascade_span_from(L, first, levels);
  const int row = window_row_floats(tile + span);  // doubles a slot, floats a half
  // the slots: the approximation, the detail and the level's output
  double* c_slot = smem_d + 2 * lp;
  double* const d_slot = c_slot + row;
  double* o_slot = d_slot + row;
  // plane i over [t0, t0 + count) into `slot` as a hi and a lo row, extended
  // past n by the right halo pair or the edge rule; one cp.async group
  auto copy = [&](double* slot, int i, int count) {
    const float* h = static_cast<const float*>(in.p[2 * i]) + row_off;
    const float* l = static_cast<const float*>(in.p[2 * i + 1]);
    l = l == nullptr ? nullptr : l + row_off;
    float* dh = reinterpret_cast<float*>(slot) + window_offset(h + t0);
    float* dl = reinterpret_cast<float*>(slot) + row + (l == nullptr ? 0 : window_offset(l + t0));
    const int inside = static_cast<int>(min(static_cast<long long>(count), n - t0));
    copy_row_window(dh, h + t0, inside);
    if (l != nullptr) {
      copy_row_window(dl, l + t0, inside);
    } else {
      for (int q = threadIdx.x; q < inside; q += blockDim.x) dl[q] = 0.0f;
    }
    for (int q = inside + threadIdx.x; q < count; q += blockDim.x) {
      const long long g = t0 + q;
      float vh = 0.0f, vl = 0.0f;
      if (halo_len > 0) {
        const long long k = g - n;
        if (k < halo_len) {
          vh = static_cast<const float*>(halos.p[2 * i])[halo_off + k];
          vl = static_cast<const float*>(halos.p[2 * i + 1])[halo_off + k];
        }
      } else if (periodic) {
        const long long m = g % n;
        vh = h[m];
        vl = l == nullptr ? 0.0f : l[m];
      }
      dh[q] = vh;
      dl[q] = vl;
    }
    cp_async_commit();
    return PairRow{dh, dl};
  };

  // the approximation and the coarsest detail over [t0, t0 + n_out + span),
  // what the tile's outputs read
  int valid_end = n_out + span;  // the current level is exact on [0, valid_end)
  const PairRow a = copy(c_slot, levels, valid_end);
  PairRow d = copy(d_slot, levels - 1, valid_end);
  const double* c = nullptr;  // the running approximation after the first level
  for (int i = levels - 1; i >= 0; --i) {
    const int shift = first - 1 + i;
    const int new_end = valid_end - ((L - 1) << shift);
    cp_async_wait_all();
    __syncthreads();
    if (c == nullptr) {
      exact_level(o_slot, a, d, shift, new_end, s_lo, s_hi, lp, L);
    } else {
      exact_level(o_slot, c, d, shift, new_end, s_lo, s_hi, lp, L);
    }
    __syncthreads();
    // d_{i-1}: level i read the last of d_i
    if (i > 0) d = copy(d_slot, i - 1, new_end);
    c = o_slot;
    double* tmp = c_slot;
    c_slot = o_slot;
    o_slot = tmp;
    valid_end = new_end;
  }
  float* dst_hi = out_hi + row_off + t0;
  float* dst_lo = out_lo + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) store_pair(dst_hi, dst_lo, o, c[o]);
}

}  // namespace vw

// `halos` (2(K+1) pointers, (hi, lo) of each plane, to [batch, halo_len]
// rows) and halo_len > 0 select the external right edge; periodic and direct
// must then be 0.  `tile` is the preferred tile of a window launch: it uses
// vw_modwt_exact_synthesis_tile's (a direct launch takes `tile` as it is).
extern "C" int vw_modwt_exact_synthesis(const void* const* ins,
                                        const void* const* halos, int halo_len,
                                        void* out_hi, void* out_lo, const void* taps,
                                        long long batch, long long n, int first,
                                        int levels, int taps_len, int tile,
                                        int periodic, int direct, void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || first < 1 ||
      first + levels - 1 > vw::kMaxLevels || (direct && levels != 1) || halo_len < 0 ||
      (halo_len > 0 && (halos == nullptr || periodic || direct))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vw::PairPtrs planes{};
  vw::PairPtrs halo_planes{};
  for (int i = 0; i < 2 * (levels + 1); ++i) {
    planes.p[i] = const_cast<void*>(ins[i]);
    if (halo_len > 0) halo_planes.p[i] = const_cast<void*>(halos[i]);
  }
  if (!direct) tile = vw::exact_synthesis_tile(taps_len, first, levels, n, tile);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = direct ? 2 * sizeof(double) * vw::padded_taps(taps_len)
                              : vw::exact_synthesis_shared_bytes(taps_len, first, levels, tile);
  cudaError_t err = vw::reserve_shared(vw::modwt_exact_synthesis_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vw::modwt_exact_synthesis_kernel<<<static_cast<unsigned>(blocks), vw::kThreads, bytes,
                                     static_cast<cudaStream_t>(stream)>>>(
      planes, halo_planes, halo_len, static_cast<float*>(out_hi),
      static_cast<float*>(out_lo),
      static_cast<const double*>(taps), n, first, levels, taps_len, tile,
      static_cast<int>(tiles), periodic, direct);
  return static_cast<int>(cudaGetLastError());
}

// The tile of a window launch for a preferred `tile` (clamped to the row,
// halved until a block fits shared memory); 0 where none fits.
extern "C" int vw_modwt_exact_synthesis_tile(int taps_len, int first, int levels,
                                             long long n, int tile) {
  return vw::valid_config(1, n, levels, taps_len, tile) && first >= 1 &&
                 first + levels - 1 <= vw::kMaxLevels
             ? vw::exact_synthesis_tile(taps_len, first, levels, n, tile)
             : 0;
}

// Shared memory of one window block at `tile`, in bytes.
extern "C" long long vw_modwt_exact_synthesis_shared_bytes(int taps_len, int first,
                                                           int levels, int tile) {
  return vw::valid_config(1, 1, levels, taps_len, tile) && first >= 1 &&
                 first + levels - 1 <= vw::kMaxLevels
             ? static_cast<long long>(
                   vw::exact_synthesis_shared_bytes(taps_len, first, levels, tile))
             : 0;
}
