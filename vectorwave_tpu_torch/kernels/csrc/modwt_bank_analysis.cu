// General multi-output filter bank, analysis: x -> P planes,
//     out_p[t] = sum_k v_p[k] x[t - o_p[k]],
// with a zero or periodic left edge.
//
// Replaces the `planes_override` mode of `_composite_analysis_call` in
// vectorwave_tpu/kernels/modwt_mxu.py, where every plane is x filtered by
// its own dense tap vector, each vector turned into banded 128x128 matrices
// for the MXU.  None of that layout carries over.  Here a block loads its
// tile of x with `span` samples of left halo into shared memory once, the
// edge resolved as it loads, and then walks its planes: it stages the
// plane's non-zero taps (offset, value) a chunk at a time beside the window
// and every thread accumulates its outputs in fp32 registers.
//
// What bounds it on the H100: a whole packet tree is bound by operations
// (a sym8 depth-4 tree is 4680 FMAs a sample against 4 (1 + 30) bytes); a
// single à trous pair is bound by bytes (32 FMAs against 12 bytes).  The
// window is read from device memory once for all planes, so the bytes are
// at their least; the arithmetic makes one shared-memory load per FMA
// (conflict-free, the tap a broadcast), which is what limits it.  Where the
// (signal, tile) blocks alone do not fill the card, the planes are split
// over blockIdx.y.  Every precision tier runs this fp32 kernel.
#include "modwt_bank_common.cuh"

namespace vw {

template <typename T>
__global__ void __launch_bounds__(kThreads)
modwt_bank_analysis_kernel(const T* __restrict__ x, BankPtrs out,
                           const int* __restrict__ starts,
                           const int* __restrict__ offs,
                           const float* __restrict__ vals, long long n, int planes,
                           int planes_per_block, int span, int tile,
                           int tiles_per_row, int edge) {
  extern __shared__ float smem[];
  float* win = smem;  // win[q] = x_ext[t0 - span + q]
  float* s_val = win + tile + span;
  int* s_off = reinterpret_cast<int*>(s_val + kTapChunk);

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const T* row = x + row_off;
  for (int q = threadIdx.x; q < tile + span; q += blockDim.x) {
    win[q] = bank_load(row, t0 - span + q, n, edge);
  }

  const int p_begin = blockIdx.y * planes_per_block;
  const int p_end = min(planes, p_begin + planes_per_block);
  for (int p = p_begin; p < p_end; ++p) {
    float acc[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) acc[r] = 0.0f;
    const int k_end = starts[p + 1];
    for (int k0 = starts[p]; k0 < k_end; k0 += kTapChunk) {
      const int count = min(kTapChunk, k_end - k0);
      __syncthreads();  // the window is loaded; the last chunk is consumed
      for (int i = threadIdx.x; i < count; i += blockDim.x) {
        s_off[i] = span - offs[k0 + i];  // output o reads win[o + span - offset]
        s_val[i] = vals[k0 + i];
      }
      __syncthreads();
      for (int i = 0; i < count; ++i) {
        const float v = s_val[i];
        const float* src = win + s_off[i] + threadIdx.x;
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
          if (r * kThreads < tile) acc[r] = fmaf(v, src[r * kThreads], acc[r]);
        }
      }
    }
    T* dst = static_cast<T*>(out.p[p]) + row_off + t0;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int o = threadIdx.x + r * kThreads;
      if (o < n_out) dst[o] = from_f32<T>(acc[r]);
    }
  }
}

template <typename T>
cudaError_t launch_bank_analysis(const void* x, const void* const* outs,
                                 const int* starts, const int* offs,
                                 const float* vals, long long batch, long long n,
                                 int planes, int plane_groups, int span, int tile,
                                 int edge, cudaStream_t stream) {
  BankPtrs ptrs{};
  for (int i = 0; i < planes; ++i) ptrs.p[i] = const_cast<void*>(outs[i]);
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int per_block = (planes + plane_groups - 1) / plane_groups;
  const int groups = (planes + per_block - 1) / per_block;
  const size_t bytes = bank_shared_bytes(span, tile);
  cudaError_t err = reserve_shared(modwt_bank_analysis_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(groups));
  modwt_bank_analysis_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), ptrs, starts, offs, vals, n, planes, per_block, span,
      tile, static_cast<int>(tiles), edge);
  return cudaGetLastError();
}

}  // namespace vw

extern "C" int vw_modwt_bank_analysis(const void* x, const void* const* outs,
                                      const void* starts, const void* offs,
                                      const void* vals, long long batch, long long n,
                                      int planes, int plane_groups, int span, int tile,
                                      int edge, int dtype, void* stream) {
  if (!vw::valid_bank_config(batch, n, planes, span, tile, edge) || plane_groups < 1 ||
      plane_groups > planes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* st = static_cast<const int*>(starts);
  const int* of = static_cast<const int*>(offs);
  const float* va = static_cast<const float*>(vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_bank_analysis<float>(x, outs, st, of, va, batch, n, planes,
                                          plane_groups, span, tile, edge, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_bank_analysis<__nv_bfloat16>(x, outs, st, of, va, batch, n, planes,
                                                  plane_groups, span, tile, edge, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
