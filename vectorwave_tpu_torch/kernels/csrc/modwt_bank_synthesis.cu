// General multi-output filter bank, synthesis: P planes -> one signal,
//     out[t] = sum_p sum_k v_p[k] c_p[t + o_p[k]],
// with a zero or periodic right edge: the transpose of modwt_bank_analysis.cu
// with the same taps, edges included, and so also that kernel's gradient.
//
// Replaces the `planes_override` mode of `_composite_synthesis_call` in
// vectorwave_tpu/kernels/modwt_mxu.py, which sums every plane filtered with
// forward reads by its own dense tap vector, as banded 128x128 matmuls on
// the MXU.
//
// What bounds it on the H100: the leaves of a packet tree are bound by
// operations (16 leaves of a sym8 depth-4 tree: 3616 FMAs a sample against
// 4 (16 + 1) bytes), a single pair by bytes.  The design is the analysis
// kernel's with forward reads (the register blocks of
// modwt_bank_common.cuh):
//   * a block owns one (signal, tile of kBankTile outputs) and walks every
//     plane; its sums stay in registers from the first plane to the last and
//     are summed in plane order, with no atomics, so a result is the same on
//     every run;
//   * the runs of every plane are cut on one stride d (the least of the
//     planes' own), so that a thread's outputs are the same for every plane;
//   * output r of a thread reads w[r + i] for tap i of a run, w[m] =
//     c_p[u + first + m d]: tap i + 1 of output r is tap i of output r + 1,
//     so a step of 8 taps reads w[i0 .. i0 + 16), 8 of them carried from the
//     step before;
//   * plane p's window (the tile and spans[p] samples past it) is copied
//     with cp.async into one of two buffers, so plane p + 1's copies are in
//     flight while plane p's runs execute: 16-byte copies where the window
//     lies inside the row and lines up, 4-byte copies elsewhere, the edge
//     applied past the row's end only.  Where two windows do not fit shared
//     memory (the widest spans), one buffer: copy, then compute
//     (`stages` = 1);
//   * bfloat16 planes are read in 4-byte pairs and converted to fp32 as they
//     are stored into the window;
//   * a ragged last tile copies only what its outputs read, and the threads
//     whose outputs all lie past the row's end skip the runs.
// Every precision tier runs this fp32 kernel.
#include "modwt_bank_common.cuh"

namespace vw {

// Taps i0 .. i0 + 7 of a run: output r reads w[r + i0 + t] for tap i0 + t.
// `old` holds w[i0 .. i0 + 8); `fresh` is loaded with w[m0 .. m0 + 8),
// m0 = i0 + 8.
template <bool kUnit>
__device__ __forceinline__ void run_step_fwd(float (&acc)[kRunBlock],
                                             float (&fresh)[kRunChunk],
                                             const float (&old)[kRunChunk], const float* src,
                                             int m0, int d, const float* v) {
#pragma unroll
  for (int e = 0; e < kRunChunk; ++e) fresh[e] = run_sample<kUnit>(src, m0 + e, d);
  const float4 v0 = __ldg(reinterpret_cast<const float4*>(v));
  const float4 v1 = __ldg(reinterpret_cast<const float4*>(v) + 1);
  const float tv[kRunChunk] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int t = 0; t < kRunChunk; ++t) {
#pragma unroll
    for (int r = 0; r < kRunBlock; ++r) {
      const int e = r + t;
      acc[r] = fmaf(tv[t], e < kRunChunk ? old[e] : fresh[e - kRunChunk], acc[r]);
    }
  }
}

// One run of `count` taps (values v[0..count)) into the thread's outputs.
template <bool kUnit>
__device__ __forceinline__ void run_taps_fwd(float (&acc)[kRunBlock], const float* src,
                                             int d, int count,
                                             const float* __restrict__ v) {
  float a[kRunChunk], b[kRunChunk];
  int i0 = 0;
  if (count >= kRunChunk) {
#pragma unroll
    for (int e = 0; e < kRunChunk; ++e) b[e] = run_sample<kUnit>(src, e, d);
    for (; i0 + 2 * kRunChunk <= count; i0 += 2 * kRunChunk) {
      run_step_fwd<kUnit>(acc, a, b, src, i0 + kRunChunk, d, v + i0);
      run_step_fwd<kUnit>(acc, b, a, src, i0 + 2 * kRunChunk, d, v + i0 + kRunChunk);
    }
    if (i0 + kRunChunk <= count) {
      run_step_fwd<kUnit>(acc, a, b, src, i0 + kRunChunk, d, v + i0);
      i0 += kRunChunk;
    }
  }
  for (; i0 < count; ++i0) {
    const float tap = v[i0];
#pragma unroll
    for (int r = 0; r < kRunBlock; ++r) {
      acc[r] = fmaf(tap, run_sample<kUnit>(src, r + i0, d), acc[r]);
    }
  }
}

// win[0 .. count) = the extended row from sample g0 (0 <= g0 < n).  float32:
// cp.async, 16 bytes at a time where the part inside the row starts on 16
// bytes, else 4; past the row's end zeros are stored, or the periodic wrap
// modulo n is copied.  bfloat16: pairs read as 4 bytes where they line up,
// converted and stored.  Returns with the copies in flight.
template <typename T>
__device__ __forceinline__ void copy_bank_window(float* win, const T* __restrict__ row,
                                                 long long g0, int count, long long n,
                                                 int edge) {
  const T* src = row + g0;
  const int inside = static_cast<int>(min(static_cast<long long>(count), n - g0));
  int q0 = 0;
  if constexpr (sizeof(T) == sizeof(float)) {
    const float* from = reinterpret_cast<const float*>(src);
    if ((reinterpret_cast<size_t>(from) & 15) == 0) {
      const int body = inside >> 2;
      for (int i = threadIdx.x; i < body; i += kThreads) cp_async16(win + 4 * i, from + 4 * i);
      q0 = 4 * body;
    }
    for (int q = q0 + threadIdx.x; q < inside; q += kThreads) cp_async4(win + q, from + q);
  } else {
    if ((reinterpret_cast<size_t>(src) & 3) == 0) {
      const int pairs = inside >> 1;
      const __nv_bfloat162* from = reinterpret_cast<const __nv_bfloat162*>(src);
      for (int i = threadIdx.x; i < pairs; i += kThreads) {
        const float2 f = __bfloat1622float2(from[i]);
        win[2 * i] = f.x;
        win[2 * i + 1] = f.y;
      }
      q0 = 2 * pairs;
    }
    for (int q = q0 + threadIdx.x; q < inside; q += kThreads) win[q] = to_f32(src[q]);
  }
  for (int q = inside + threadIdx.x; q < count; q += kThreads) {
    if (edge != kBankPeriodic) {
      win[q] = 0.0f;
      continue;
    }
    const long long m = (g0 + q) % n;
    if constexpr (sizeof(T) == sizeof(float)) {
      cp_async4(win + q, reinterpret_cast<const float*>(row) + m);
    } else {
      win[q] = to_f32(row[m]);
    }
  }
}

// Four blocks to an SM (64 registers a thread), as the analysis.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
modwt_bank_synthesis_kernel(BankPtrs in, T* __restrict__ out,
                            const int* __restrict__ plane_runs,
                            const int* __restrict__ spans, const int* __restrict__ runs,
                            const float* __restrict__ vals, long long n, int planes,
                            int shift, int buffer, int stages, int tiles_per_row,
                            int edge) {
  extern __shared__ __align__(16) float smem[];

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * kBankTile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(kBankTile), n - t0));
  const int d = 1 << shift;
  const int base = run_base(shift);

  // plane p's window, in buffer p mod stages: win[q] = c_p_ext[t0 + q] for
  // q < n_out + spans[p], what the tile's outputs read
  auto copy = [&](int p) {
    copy_bank_window(smem + (p % stages) * buffer,
                     static_cast<const T*>(in.p[p]) + row_off, t0, n_out + spans[p], n,
                     edge);
    cp_async_commit();
  };

  float acc[kRunBlock];
#pragma unroll
  for (int r = 0; r < kRunBlock; ++r) acc[r] = 0.0f;
  copy(0);
  for (int p = 0; p < planes; ++p) {
    if (stages == 2 && p + 1 < planes) {
      copy(p + 1);  // its buffer's last reader, plane p - 1, is done
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (base < n_out) {
      const float* win = smem + (p % stages) * buffer;
      for (int k = plane_runs[p]; k < plane_runs[p + 1]; ++k) {
        const int first = runs[3 * k];
        const int count = runs[3 * k + 1];
        const float* v = vals + runs[3 * k + 2];
        // output base + r d reads win[base + r d + first + i d]
        const float* src = win + base + first;
        if (d == 1) {
          run_taps_fwd<true>(acc, src, 1, count, v);
        } else {
          run_taps_fwd<false>(acc, src, d, count, v);
        }
      }
    }
    __syncthreads();  // the window's buffer is free
    if (stages == 1 && p + 1 < planes) copy(p + 1);
  }
  T* dst = out + row_off + t0;
#pragma unroll
  for (int r = 0; r < kRunBlock; ++r) {
    const int o = base + r * d;
    if (o < n_out) dst[o] = from_f32<T>(acc[r]);
  }
}

// Floats of one window buffer: the tile and the widest span, rounded up to
// 16 bytes so that the second buffer starts on 16 bytes too.
inline size_t bank_buffer_floats(int span) {
  return (static_cast<size_t>(kBankTile) + static_cast<size_t>(span) + 3) & ~size_t{3};
}

template <typename T>
cudaError_t launch_bank_synthesis(const void* const* ins, void* out, const int* plane_runs,
                                  const int* spans, const int* runs, const float* vals,
                                  long long batch, long long n, int planes, int span,
                                  int shift, int stages, int edge, cudaStream_t stream) {
  BankPtrs ptrs{};
  for (int i = 0; i < planes; ++i) ptrs.p[i] = const_cast<void*>(ins[i]);
  const long long tiles = (n + kBankTile - 1) / kBankTile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t buffer = bank_buffer_floats(span);
  const size_t bytes = sizeof(float) * stages * buffer;
  cudaError_t err = reserve_shared(modwt_bank_synthesis_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  modwt_bank_synthesis_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes,
                                   stream>>>(
      ptrs, static_cast<T*>(out), plane_runs, spans, runs, vals, n, planes, shift,
      static_cast<int>(buffer), stages, static_cast<int>(tiles), edge);
  return cudaGetLastError();
}

}  // namespace vw

extern "C" int vw_modwt_bank_synthesis(const void* const* ins, void* out,
                                       const void* plane_runs, const void* spans,
                                       const void* runs, const void* vals, long long batch,
                                       long long n, int planes, int span, int shift,
                                       int stages, int edge, int dtype, void* stream) {
  if (batch < 1 || n < 1 || planes < 1 || planes > vw::kMaxBankPlanes || span < 0 ||
      shift < 0 || (1 << shift) > vw::kThreads || (stages != 1 && stages != 2) ||
      (edge != vw::kBankZero && edge != vw::kBankPeriodic)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* pr = static_cast<const int*>(plane_runs);
  const int* sp = static_cast<const int*>(spans);
  const int* ru = static_cast<const int*>(runs);
  const float* va = static_cast<const float*>(vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_bank_synthesis<float>(ins, out, pr, sp, ru, va, batch, n, planes,
                                           span, shift, stages, edge, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_bank_synthesis<__nv_bfloat16>(ins, out, pr, sp, ru, va, batch, n,
                                                   planes, span, shift, stages, edge, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
