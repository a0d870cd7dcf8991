// General multi-output filter bank, synthesis: P planes -> one signal,
//     out[t] = sum_p sum_k v_p[k] c_p[t + o_p[k]],
// with a zero or periodic right edge: the transpose of modwt_bank_analysis.cu
// with the same taps, edges included, and so also that kernel's gradient.
//
// Replaces the `planes_override` mode of `_composite_synthesis_call` in
// vectorwave_tpu/kernels/modwt_mxu.py, which sums every plane filtered with
// forward reads by its own dense tap vector, as banded 128x128 matmuls on
// the MXU.  Here a block keeps one tile of sums in fp32 registers and walks
// the planes: it loads the plane's tile with that plane's own right halo
// into shared memory, the edge resolved as it loads, stages the plane's
// non-zero taps a chunk at a time beside it, and accumulates.  A block
// cannot hold 16 to 62 windows at once, so the planes take turns in one
// window; no atomics, since one block owns its outputs.
//
// What bounds it on the H100: the leaves of a packet tree are bound by
// operations (16 leaves of a sym8 depth-4 tree: 3616 FMAs a sample against
// 4 (16 + 1) bytes), a single pair by bytes.  Each plane's window is read
// from device memory once; the arithmetic makes one conflict-free
// shared-memory load per FMA, which is what limits it.  Every precision
// tier runs this fp32 kernel.
#include "modwt_bank_common.cuh"

namespace vw {

template <typename T>
__global__ void __launch_bounds__(kThreads)
modwt_bank_synthesis_kernel(BankPtrs in, T* __restrict__ out,
                            const int* __restrict__ starts,
                            const int* __restrict__ spans,
                            const int* __restrict__ offs,
                            const float* __restrict__ vals, long long n, int planes,
                            int span, int tile, int tiles_per_row, int edge) {
  extern __shared__ float smem[];
  float* win = smem;  // win[q] = c_p_ext[t0 + q]
  float* s_val = win + tile + span;
  int* s_off = reinterpret_cast<int*>(s_val + kTapChunk);

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));

  float acc[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) acc[r] = 0.0f;

  for (int p = 0; p < planes; ++p) {
    const int k_begin = starts[p];
    const int k_end = starts[p + 1];
    const T* row = static_cast<const T*>(in.p[p]) + row_off;
    const int width = tile + spans[p];
    for (int k0 = k_begin; k0 < k_end; k0 += kTapChunk) {
      const int count = min(kTapChunk, k_end - k0);
      __syncthreads();  // the last window and chunk are consumed
      if (k0 == k_begin) {
        for (int q = threadIdx.x; q < width; q += blockDim.x) {
          win[q] = bank_load(row, t0 + q, n, edge);
        }
      }
      for (int i = threadIdx.x; i < count; i += blockDim.x) {
        s_off[i] = offs[k0 + i];
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
  }
  T* dst = out + row_off + t0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int o = threadIdx.x + r * kThreads;
    if (o < n_out) dst[o] = from_f32<T>(acc[r]);
  }
}

template <typename T>
cudaError_t launch_bank_synthesis(const void* const* ins, void* out, const int* starts,
                                  const int* spans, const int* offs, const float* vals,
                                  long long batch, long long n, int planes, int span,
                                  int tile, int edge, cudaStream_t stream) {
  BankPtrs ptrs{};
  for (int i = 0; i < planes; ++i) ptrs.p[i] = const_cast<void*>(ins[i]);
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = bank_shared_bytes(span, tile);
  cudaError_t err = reserve_shared(modwt_bank_synthesis_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  modwt_bank_synthesis_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes,
                                   stream>>>(
      ptrs, static_cast<T*>(out), starts, spans, offs, vals, n, planes, span, tile,
      static_cast<int>(tiles), edge);
  return cudaGetLastError();
}

}  // namespace vw

extern "C" int vw_modwt_bank_synthesis(const void* const* ins, void* out,
                                       const void* starts, const void* spans,
                                       const void* offs, const void* vals,
                                       long long batch, long long n, int planes,
                                       int span, int tile, int edge, int dtype,
                                       void* stream) {
  if (!vw::valid_bank_config(batch, n, planes, span, tile, edge)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* st = static_cast<const int*>(starts);
  const int* sp = static_cast<const int*>(spans);
  const int* of = static_cast<const int*>(offs);
  const float* va = static_cast<const float*>(vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_bank_synthesis<float>(ins, out, st, sp, of, va, batch, n, planes,
                                           span, tile, edge, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_bank_synthesis<__nv_bfloat16>(ins, out, st, sp, of, va, batch, n,
                                                   planes, span, tile, edge, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
