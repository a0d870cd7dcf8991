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
// What bounds it on the H100: the kernel reads J+1 planes (4 (J+1) B per
// sample, plus the S = (L-1)(2^J-1) sample right halo of each tile) and
// writes 4 B, so device-memory reads dominate its traffic; the arithmetic is
// bound by shared-memory loads, two per FMA pair.  The design stages one
// detail plane at a time in shared memory beside the running approximation
// (three rows of tile + S floats, under 48 KB at tile 2048 for db4 J = 6),
// with coalesced loads of each plane window.  Every precision tier
// (float32, bf16_3x, bf16) runs this same fp32 kernel, which meets each
// tier's error contract; tensor-core tiers are later work.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
modwt_synthesis_kernel(PlanePtrs in, PlanePtrs halos, int halo_len,
                       T* __restrict__ out, const float* __restrict__ taps,
                       long long n, int levels, int L, int tile,
                       int tiles_per_row, int periodic) {
  extern __shared__ float smem[];
  const int span = cascade_span(L, levels);
  const int width = tile + span;
  float* s_lo = smem;
  float* s_hi = smem + L;
  float* cur = smem + 2 * L;
  float* nxt = cur + width;
  float* det = nxt + width;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const long long halo_off = b * halo_len;
  // sample g of plane i, extended by the right halo or by the edge rule
  auto load = [&](int i, long long g) {
    const T* row = static_cast<const T*>(in.p[i]) + row_off;
    if (halo_len > 0) {
      return load_right_halo(row, static_cast<const T*>(halos.p[i]) + halo_off,
                             halo_len, g, n);
    }
    return load_ext(row, g, n, periodic != 0);
  };

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_lo[k] = taps[k];
    s_hi[k] = taps[L + k];
  }
  // c_J = a_J over the window [t0, t0 + tile + span)
  for (int q = threadIdx.x; q < width; q += blockDim.x) cur[q] = load(levels, t0 + q);

  int valid_end = width;  // the current level is exact on [0, valid_end)
  for (int j = levels; j >= 1; --j) {
    const int s = 1 << (j - 1);
    for (int q = threadIdx.x; q < valid_end; q += blockDim.x) {
      det[q] = load(j - 1, t0 + q);
    }
    __syncthreads();
    const int new_end = valid_end - (L - 1) * s;
    for (int q = threadIdx.x; q < new_end; q += blockDim.x) {
      float c = 0.0f;
      for (int k = 0; k < L; ++k) {
        c = fmaf(s_lo[k], cur[q + k * s], c);
        c = fmaf(s_hi[k], det[q + k * s], c);
      }
      nxt[q] = c;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    valid_end = new_end;
  }
  T* dst = out + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) dst[o] = from_f32<T>(cur[o]);
}

inline size_t synthesis_shared_bytes(int L, int levels, int tile) {
  return sizeof(float) * (2 * static_cast<size_t>(L) +
                          3 * static_cast<size_t>(tile + cascade_span(L, levels)));
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
// the external right edge; periodic must then be 0.
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
