// General multi-output filter bank, analysis: x -> P planes,
//     out_p[t] = sum_k v_p[k] x[t - o_p[k]],
// with a zero or periodic left edge.
//
// Replaces the `planes_override` mode of `_composite_analysis_call` in
// vectorwave_tpu/kernels/modwt_mxu.py, where every plane is x filtered by
// its own dense tap vector, each vector turned into banded 128x128 matrices
// for the MXU.  None of that layout carries over.
//
// What bounds it on the H100: a whole packet tree is bound by operations
// (a sym8 depth-4 tree is 4680 FMAs a sample against 4 (1 + 30) bytes); a
// single à trous pair is bound by bytes (32 FMAs against 12 bytes).  An SM
// issues four warp FMAs a clock but serves one 32-bit warp load from shared
// memory, so a design that loads a window sample for every FMA stops near a
// fifth of the fp32 peak.  This one makes a loaded word feed several FMAs,
// with the register blocks of modwt_bank_common.cuh:
//   * a block loads its tile of x with `span` samples of left halo into
//     shared memory once, the edge resolved as it loads, and walks the
//     planes of its group (blockIdx.y);
//   * output r of a thread reads w[r - i] for tap i of a run, so a step of
//     8 taps reads w[-(i0 + 7) .. 8 - i0];
//   * taps left over after the runs' multiples of 8 are read one at a time.
// The plane groups are cut on the host so that each holds about the same
// number of taps.  Every precision tier runs this fp32 kernel.
#include "modwt_bank_common.cuh"

namespace vw {

// First plane of each plane group and the end of the last, by value.
struct GroupBounds {
  int p[kMaxBankPlanes + 1];
};

// Taps i0 .. i0 + 7 of a run: output r reads w[r - i0 - t] for tap i0 + t.
// `fresh` is loaded with w[m0 .. m0 + 8), m0 = -(i0 + 7); `old` holds
// w[m0 + 8 .. m0 + 16), the previous step's `fresh`.
template <bool kUnit>
__device__ __forceinline__ void run_step(float (&acc)[kRunBlock], float (&fresh)[kRunChunk],
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
      const int e = r - t + kRunChunk - 1;
      acc[r] = fmaf(tv[t], e < kRunChunk ? fresh[e] : old[e - kRunChunk], acc[r]);
    }
  }
}

// One run of `count` taps (values v[0..count)) into the thread's outputs.
template <bool kUnit>
__device__ __forceinline__ void run_taps(float (&acc)[kRunBlock], const float* src, int d,
                                         int count, const float* __restrict__ v) {
  float a[kRunChunk], b[kRunChunk];
  int i0 = 0;
  if (count >= kRunChunk) {
#pragma unroll
    for (int e = 0; e < kRunChunk; ++e) b[e] = run_sample<kUnit>(src, e + 1, d);
    for (; i0 + 2 * kRunChunk <= count; i0 += 2 * kRunChunk) {
      run_step<kUnit>(acc, a, b, src, -(i0 + kRunChunk - 1), d, v + i0);
      run_step<kUnit>(acc, b, a, src, -(i0 + 2 * kRunChunk - 1), d, v + i0 + kRunChunk);
    }
    if (i0 + kRunChunk <= count) {
      run_step<kUnit>(acc, a, b, src, -(i0 + kRunChunk - 1), d, v + i0);
      i0 += kRunChunk;
    }
  }
  for (; i0 < count; ++i0) {
    const float tap = v[i0];
#pragma unroll
    for (int r = 0; r < kRunBlock; ++r) {
      acc[r] = fmaf(tap, run_sample<kUnit>(src, r - i0, d), acc[r]);
    }
  }
}

// win[0 .. count) = the extended row from sample g0.  A window inside the
// row is read with 16-byte loads (float32) and no edge test; with `lead`
// slots free before the window, the block shifts it so that those loads
// land on 16-byte shared slots too.  Returns the window's start.
template <typename T>
__device__ __forceinline__ float* load_window(float* smem, int lead, const T* __restrict__ row,
                                              long long g0, int count, long long n,
                                              int edge) {
  if (g0 < 0 || g0 + count > n) {
    for (int q = threadIdx.x; q < count; q += blockDim.x) {
      smem[q] = bank_load(row, g0 + q, n, edge);
    }
    return smem;
  }
  const T* src = row + g0;
  if constexpr (sizeof(T) == sizeof(float)) {
    const int head =
        min(count, static_cast<int>((0 - (reinterpret_cast<size_t>(src) >> 2)) & 3));
    float* win = smem + (lead == 3 ? (4 - head) & 3 : 0);
    const int body = (count - head) >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    // four loads in flight a thread before the first store
    for (int i0 = threadIdx.x; i0 < body; i0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i0 + k * kThreads < body) v[k] = __ldg(src4 + i0 + k * kThreads);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kThreads;
        if (i >= body) break;
        if (lead == 3) {
          *reinterpret_cast<float4*>(win + head + 4 * i) = v[k];
        } else {
          float* w = win + head + 4 * i;
          w[0] = v[k].x;
          w[1] = v[k].y;
          w[2] = v[k].z;
          w[3] = v[k].w;
        }
      }
    }
    for (int q = threadIdx.x; q < head; q += blockDim.x) win[q] = src[q];
    for (int q = head + 4 * body + threadIdx.x; q < count; q += blockDim.x) {
      win[q] = src[q];
    }
    return win;
  } else {
    for (int q = threadIdx.x; q < count; q += blockDim.x) smem[q] = to_f32(src[q]);
    return smem;
  }
}

// Four blocks to an SM (64 registers a thread): measured faster than three
// with more registers on the tree and the pair alike.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
modwt_bank_analysis_kernel(const T* __restrict__ x, BankPtrs out,
                           const int* __restrict__ plane_runs,
                           const int* __restrict__ plane_shift,
                           const int* __restrict__ runs, const float* __restrict__ vals,
                           GroupBounds groups, long long n, int span, int tiles_per_row,
                           int lead, int edge) {
  extern __shared__ float smem[];

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 =
      static_cast<long long>(blockIdx.x % tiles_per_row) * kBankTile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(kBankTile), n - t0));
  // win[q] = x_ext[t0 - span + q].  A ragged last tile loads only what its
  // outputs read; the threads whose outputs lie past n_out read slots never
  // loaded, and store nothing.
  const float* win = load_window(smem, lead, x + row_off, t0 - span, n_out + span, n, edge);
  __syncthreads();

  for (int p = groups.p[blockIdx.y]; p < groups.p[blockIdx.y + 1]; ++p) {
    const int shift = plane_shift[p];
    const int d = 1 << shift;
    const int base = run_base(shift);
    float acc[kRunBlock];
#pragma unroll
    for (int r = 0; r < kRunBlock; ++r) acc[r] = 0.0f;
    if (base < n_out) {
      for (int k = plane_runs[p]; k < plane_runs[p + 1]; ++k) {
        const int first = runs[3 * k];
        const int count = runs[3 * k + 1];
        const float* v = vals + runs[3 * k + 2];
        // output base + r d reads win[base + r d + span - first - i d]
        const float* src = win + base + span - first;
        if (d == 1) {
          run_taps<true>(acc, src, 1, count, v);
        } else {
          run_taps<false>(acc, src, d, count, v);
        }
      }
    }
    T* dst = static_cast<T*>(out.p[p]) + row_off + t0;
#pragma unroll
    for (int r = 0; r < kRunBlock; ++r) {
      const int o = base + r * d;
      if (o < n_out) dst[o] = from_f32<T>(acc[r]);
    }
  }
}

inline size_t bank_analysis_shared_bytes(int span) {
  return sizeof(float) * (static_cast<size_t>(kBankTile) + static_cast<size_t>(span));
}

// Three slots before the window let the block align it for 16-byte stores;
// the widest spans go without them.
inline int bank_analysis_lead(int span) {
  return bank_analysis_shared_bytes(span) + 3 * sizeof(float) <=
                 static_cast<size_t>(kMaxSharedBytes)
             ? 3
             : 0;
}

template <typename T>
cudaError_t launch_bank_analysis(const void* x, const void* const* outs,
                                 const int* plane_runs, const int* plane_shift,
                                 const int* runs, const float* vals,
                                 const GroupBounds& groups, int group_count,
                                 long long batch, long long n, int planes, int span,
                                 int edge, cudaStream_t stream) {
  BankPtrs ptrs{};
  for (int i = 0; i < planes; ++i) ptrs.p[i] = const_cast<void*>(outs[i]);
  const long long tiles = (n + kBankTile - 1) / kBankTile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int lead = bank_analysis_lead(span);
  const size_t bytes = bank_analysis_shared_bytes(span) + lead * sizeof(float);
  cudaError_t err = reserve_shared(modwt_bank_analysis_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(group_count));
  modwt_bank_analysis_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), ptrs, plane_runs, plane_shift, runs, vals, groups, n,
      span, static_cast<int>(tiles), lead, edge);
  return cudaGetLastError();
}

}  // namespace vw

extern "C" int vw_modwt_bank_analysis(const void* x, const void* const* outs,
                                      const void* plane_runs, const void* plane_shift,
                                      const void* runs, const void* vals,
                                      const int* group_bounds, int group_count,
                                      long long batch, long long n, int planes, int span,
                                      int edge, int dtype, void* stream) {
  if (batch < 1 || n < 1 || planes < 1 || planes > vw::kMaxBankPlanes || span < 0 ||
      (edge != vw::kBankZero && edge != vw::kBankPeriodic) || group_count < 1 ||
      group_count > planes || group_bounds[0] != 0 || group_bounds[group_count] != planes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vw::GroupBounds groups{};
  for (int g = 0; g <= group_count; ++g) {
    if (g > 0 && group_bounds[g] <= group_bounds[g - 1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    groups.p[g] = group_bounds[g];
  }
  const int* pr = static_cast<const int*>(plane_runs);
  const int* ps = static_cast<const int*>(plane_shift);
  const int* ru = static_cast<const int*>(runs);
  const float* va = static_cast<const float*>(vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_bank_analysis<float>(x, outs, pr, ps, ru, va, groups, group_count,
                                          batch, n, planes, span, edge, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_bank_analysis<__nv_bfloat16>(x, outs, pr, ps, ru, va, groups,
                                                  group_count, batch, n, planes, span,
                                                  edge, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
