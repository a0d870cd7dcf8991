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
// exact), and the window reads them through load_left_halo_pair: the halo
// for g < 0, 0 before it, 0 past n, as the zero edge of [halo | x] does.
// Only a one-launch window plan takes it: the later launches of a split plan
// read an approximation pair that the neighbour never sent, so the wrapper
// runs a split plan on [halo | x] with zero edges instead.
//
// What bounds it on the H100: per sample it reads 4 B (8 B with x_lo) and
// writes 8 (K+1) B, about 0.5 GB at 128 x 65536 with K = 6, against
// 2 L K = 96 fp64 FMAs and L K = 48 eight-byte shared loads per sample.  At
// 3.35 TB/s the traffic takes ~0.15 ms and the FMAs ~0.05 ms at the fp64
// rate (34 TFLOP/s), so device memory should bound it; the design keeps the
// cascade in shared memory (two rows of tile + span doubles) and writes
// each plane pair straight from registers with coalesced stores.
#include "modwt_common.cuh"

namespace vw {

__global__ void __launch_bounds__(kThreads)
modwt_exact_analysis_kernel(const float* __restrict__ x_hi,
                            const float* __restrict__ x_lo,
                            const float* __restrict__ halo, int halo_len,
                            PairPtrs out, const double* __restrict__ taps, long long n,
                            int first, int levels, int L, int tile,
                            int tiles_per_row, int periodic, int direct) {
  extern __shared__ double smem_d[];
  const int span = cascade_span_from(L, first, levels);
  const int width = tile + span;
  double* s_lo = smem_d;
  double* s_hi = smem_d + L;
  double* cur = smem_d + 2 * L;
  double* nxt = cur + width;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const float* row_lo = x_lo == nullptr ? nullptr : x_lo + row_off;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_lo[k] = taps[k];
    s_hi[k] = taps[L + k];
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
        const double v = load_ext_pair(x_hi + row_off, row_lo,
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
  // window [t0 - span, t0 + tile) of the extended signal
  const long long g0 = t0 - span;
  const float* row_halo = halo == nullptr ? nullptr : halo + b * halo_len;
  for (int q = threadIdx.x; q < width; q += blockDim.x) {
    cur[q] = row_halo != nullptr
                 ? load_left_halo_pair(x_hi + row_off, row_lo, row_halo, halo_len,
                                       g0 + q, n)
                 : load_ext_pair(x_hi + row_off, row_lo, g0 + q, n, periodic != 0);
  }
  __syncthreads();

  int valid = 0;  // first window index where the current level is exact
  for (int i = 0; i < levels; ++i) {
    const int s = 1 << (first - 1 + i);
    const int start = valid + (L - 1) * s;
    float* dh = static_cast<float*>(out.p[2 * i]) + row_off + t0;
    float* dl = static_cast<float*>(out.p[2 * i + 1]) + row_off + t0;
    for (int q = start + threadIdx.x; q < width; q += blockDim.x) {
      double a = 0.0;
      double d = 0.0;
      for (int k = 0; k < L; ++k) {
        const double v = cur[q - k * s];
        a = fma(s_lo[k], v, a);
        d = fma(s_hi[k], v, d);
      }
      nxt[q] = a;
      const int o = q - span;
      if (o >= 0 && o < n_out) store_pair(dh, dl, o, d);
    }
    __syncthreads();
    double* tmp = cur;
    cur = nxt;
    nxt = tmp;
    valid = start;
  }
  float* ah = static_cast<float*>(out.p[2 * levels]) + row_off + t0;
  float* al = static_cast<float*>(out.p[2 * levels + 1]) + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    store_pair(ah, al, o, cur[span + o]);
  }
}

inline size_t exact_analysis_shared_bytes(int L, int first, int levels, int tile) {
  return sizeof(double) *
         (2 * static_cast<size_t>(L) +
          2 * static_cast<size_t>(tile + cascade_span_from(L, first, levels)));
}

}  // namespace vw

// A non-null `halo` of halo_len >= 1 samples a row selects the external left
// edge; periodic and direct must then be 0.
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
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = direct ? 2 * sizeof(double) * taps_len
                              : vw::exact_analysis_shared_bytes(taps_len, first, levels, tile);
  cudaError_t err = vw::reserve_shared(vw::modwt_exact_analysis_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vw::modwt_exact_analysis_kernel<<<static_cast<unsigned>(blocks), vw::kThreads, bytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_hi), static_cast<const float*>(x_lo),
      static_cast<const float*>(halo), halo_len, planes,
      static_cast<const double*>(taps), n, first, levels, taps_len, tile,
      static_cast<int>(tiles), periodic, direct);
  return static_cast<int>(cudaGetLastError());
}
