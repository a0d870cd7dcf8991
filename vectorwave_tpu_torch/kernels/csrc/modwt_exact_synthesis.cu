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
// pair of [batch, halo_len] samples just right of the row's end, read
// through load_right_halo_pair: the plane below n, the halo pair on [n, n +
// halo_len), zeros after it.  Only a one-launch window plan takes it; the
// wrapper runs a split plan on [plane | halo] with zero edges instead.
//
// What bounds it on the H100: per sample it reads 8 (K+1) B and writes 8 B,
// about 0.5 GB at 128 x 65536 with K = 6 (plus each tile's right halo of
// S = (L-1)(2^K-1) samples per plane, L2-served), against 2 L K = 96 fp64
// FMAs and two eight-byte shared loads per FMA pair.  Device-memory reads
// should bound it; the design stages one detail plane at a time in shared
// memory beside the running approximation (three rows of tile + S doubles)
// with coalesced loads of each plane window.
#include "modwt_common.cuh"

namespace vw {

__global__ void __launch_bounds__(kThreads)
modwt_exact_synthesis_kernel(PairPtrs in, PairPtrs halos, int halo_len,
                             float* __restrict__ out_hi,
                             float* __restrict__ out_lo,
                             const double* __restrict__ taps, long long n,
                             int first, int levels, int L, int tile,
                             int tiles_per_row, int periodic, int direct) {
  extern __shared__ double smem_d[];
  const int span = cascade_span_from(L, first, levels);
  const int width = tile + span;
  double* s_lo = smem_d;
  double* s_hi = smem_d + L;
  double* cur = smem_d + 2 * L;
  double* nxt = cur + width;
  double* det = nxt + width;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const long long halo_off = b * halo_len;
  // sample g of plane pair i (hi at 2i, lo at 2i + 1), extended by the
  // right halo or by the edge rule
  auto load = [&](int i, long long g) {
    const float* h = static_cast<const float*>(in.p[2 * i]) + row_off;
    const float* l = static_cast<const float*>(in.p[2 * i + 1]) + row_off;
    if (halo_len > 0) {
      return load_right_halo_pair(
          h, l, static_cast<const float*>(halos.p[2 * i]) + halo_off,
          static_cast<const float*>(halos.p[2 * i + 1]) + halo_off, halo_len, g, n);
    }
    return load_ext_pair(h, l, g, n, periodic != 0);
  };

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_lo[k] = taps[k];
    s_hi[k] = taps[L + k];
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
  // c = the approximation over the window [t0, t0 + tile + span)
  for (int q = threadIdx.x; q < width; q += blockDim.x) cur[q] = load(levels, t0 + q);

  int valid_end = width;  // the current level is exact on [0, valid_end)
  for (int i = levels - 1; i >= 0; --i) {
    const int s = 1 << (first - 1 + i);
    for (int q = threadIdx.x; q < valid_end; q += blockDim.x) det[q] = load(i, t0 + q);
    __syncthreads();
    const int new_end = valid_end - (L - 1) * s;
    for (int q = threadIdx.x; q < new_end; q += blockDim.x) {
      double c = 0.0;
      for (int k = 0; k < L; ++k) {
        c = fma(s_lo[k], cur[q + k * s], c);
        c = fma(s_hi[k], det[q + k * s], c);
      }
      nxt[q] = c;
    }
    __syncthreads();
    double* tmp = cur;
    cur = nxt;
    nxt = tmp;
    valid_end = new_end;
  }
  float* dst_hi = out_hi + row_off + t0;
  float* dst_lo = out_lo + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    store_pair(dst_hi, dst_lo, o, cur[o]);
  }
}

inline size_t exact_synthesis_shared_bytes(int L, int first, int levels, int tile) {
  return sizeof(double) *
         (2 * static_cast<size_t>(L) +
          3 * static_cast<size_t>(tile + cascade_span_from(L, first, levels)));
}

}  // namespace vw

// `halos` (2(K+1) pointers, (hi, lo) of each plane, to [batch, halo_len]
// rows) and halo_len > 0 select the external right edge; periodic and direct
// must then be 0.
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
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = direct ? 2 * sizeof(double) * taps_len
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
