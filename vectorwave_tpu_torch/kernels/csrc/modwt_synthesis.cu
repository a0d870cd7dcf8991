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
#include "modwt_common.cuh"

namespace vw {

template <typename T>
__global__ void __launch_bounds__(kThreads)
modwt_synthesis_kernel(PlanePtrs in, T* __restrict__ out,
                       const float* __restrict__ taps, long long n, int levels,
                       int L, int tile, int tiles_per_row, int periodic) {
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

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_lo[k] = taps[k];
    s_hi[k] = taps[L + k];
  }
  // c_J = a_J over the window [t0, t0 + tile + span)
  const T* approx = static_cast<const T*>(in.p[levels]) + row_off;
  for (int q = threadIdx.x; q < width; q += blockDim.x) {
    cur[q] = load_ext(approx, t0 + q, n, periodic != 0);
  }

  int valid_end = width;  // the current level is exact on [0, valid_end)
  for (int j = levels; j >= 1; --j) {
    const int s = 1 << (j - 1);
    const T* dj = static_cast<const T*>(in.p[j - 1]) + row_off;
    for (int q = threadIdx.x; q < valid_end; q += blockDim.x) {
      det[q] = load_ext(dj, t0 + q, n, periodic != 0);
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
cudaError_t launch_synthesis(const void* const* ins, void* out, const float* taps,
                             long long batch, long long n, int levels, int L,
                             int tile, int periodic, cudaStream_t stream) {
  PlanePtrs planes{};
  for (int i = 0; i <= levels; ++i) planes.p[i] = const_cast<void*>(ins[i]);
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = synthesis_shared_bytes(L, levels, tile);
  cudaError_t err = reserve_shared(modwt_synthesis_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  modwt_synthesis_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      planes, static_cast<T*>(out), taps, n, levels, L, tile,
      static_cast<int>(tiles), periodic);
  return cudaGetLastError();
}

}  // namespace vw

extern "C" int vw_modwt_synthesis(const void* const* ins, void* out,
                                  const void* taps, long long batch, long long n,
                                  int levels, int taps_len, int tile, int periodic,
                                  int dtype, void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* t = static_cast<const float*>(taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_synthesis<float>(ins, out, t, batch, n, levels, taps_len, tile,
                                      periodic, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_synthesis<__nv_bfloat16>(ins, out, t, batch, n, levels,
                                              taps_len, tile, periodic, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
