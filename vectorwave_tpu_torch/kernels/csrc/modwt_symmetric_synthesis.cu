// Symmetric-boundary inverse MODWT body with the edge splice, and its
// transpose (the gradient with respect to the planes).
//
// Replaces the TPU kernel vectorwave_tpu/kernels/modwt_symmetric.py
// `_symsyn2_call` and, in adjoint mode, its transpose `_symsyn_adjoint_kernel`
// (the composite analysis call with `planes_override`).  The TPU kernel sums
// every plane filtered by its rebased two-sided composed filter (up to 442
// taps, 1288 nonzero for db4 J = 6) as banded 128x128 matmuls over a
// [H | tile | H] window, then blends the head and tail inverse values in.
// Here the composition is not formed: the block runs it level by level, from
// coarse to fine, as the alignment-shifted per-level ops
//     c_{j-1}[t] = sum_l lo[l] c_j[t + sa 2^{j-1} l + oa]
//                + sum_l hi[l] d_j[t + sd 2^{j-1} l + od],
// with (sa, oa, sd, od) from the symmetric alignment table of each level and
// every plane zero outside [0, n).  The intermediates c_j are NOT clipped to
// [0, n): the composed filters of the definition read both ways, so each
// level is computed on its whole window.  That is exactly the composed-filter
// sum and costs 2 L J FMAs per output (96 for db4 J = 6, 128 for sym8 J = 4).
// The first span_l outputs are then stored from `head` and the last span_r
// from `tail` ([batch, span] fp32 each, the plain symmetric inverse of a
// short head and tail window).
//
// Adjoint mode reads a signal c ([batch, n], zero outside [0, n)) and writes
// J+1 planes: the same ops transposed (sign flipped, offset negated), run
// from fine to coarse,
//     v_j[u] = sum_l lo[l] v_{j-1}[u - sa 2^{j-1} l - oa],  v_0 = c,
//     grad d_j[u] = sum_l hi[l] v_{j-1}[u - sd 2^{j-1} l - od],
//     grad a_J = v_J.
//
// The window of every level, relative to the block's first output, and the
// base and stride of each op's reads into the windows come from the host as
// a plan of kPlanStride ints per level (modwt_composite.symmetric_plan):
//   forward: [e_j, len_j, ed_j, bA, stA, bD, stD, 0] for c_j and d_j;
//   adjoint: [e_{j-1}, len_{j-1}, bA, stA, bD, stD, 0, 0] for v_{j-1}.
//
// What bounds it on the H100: like modwt_synthesis.cu, device memory for the
// J+1 plane reads (4 (J+1) B per sample plus each window's halo) and one
// shared-memory load per FMA for the arithmetic.  The design keeps the
// running level and one staged plane window in shared memory (three rows of
// at most tile + (L-1)(2^J-1) floats; two in adjoint mode) and writes the
// output once, with the splice applied on the store.
#include "modwt_common.cuh"

namespace vw {

constexpr int kPlanStride = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
symmetric_synthesis_kernel(PlanePtrs in, T* __restrict__ out,
                           const float* __restrict__ head,
                           const float* __restrict__ tail,
                           const float* __restrict__ taps,
                           const int* __restrict__ plan, long long n, int levels,
                           int L, int tile, int tiles_per_row, int width,
                           int span_l, int span_r) {
  extern __shared__ float smem[];
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
  // c_J = a_J over its window
  {
    const int* p = plan + kPlanStride * (levels - 1);
    const T* approx = static_cast<const T*>(in.p[levels]) + row_off;
    for (int q = threadIdx.x; q < p[1]; q += blockDim.x) {
      cur[q] = load_ext(approx, t0 + p[0] + q, n, false);
    }
  }
  for (int j = levels; j >= 1; --j) {
    const int* p = plan + kPlanStride * (j - 1);
    const int len = p[1], ed = p[2], bA = p[3], stA = p[4], bD = p[5], stD = p[6];
    const T* dj = static_cast<const T*>(in.p[j - 1]) + row_off;
    for (int q = threadIdx.x; q < len; q += blockDim.x) {
      det[q] = load_ext(dj, t0 + ed + q, n, false);
    }
    __syncthreads();
    const int len_out = j > 1 ? plan[kPlanStride * (j - 2) + 1] : tile;
    for (int r = threadIdx.x; r < len_out; r += blockDim.x) {
      float c = 0.0f;
      for (int k = 0; k < L; ++k) {
        c = fmaf(s_lo[k], cur[r + bA + stA * k], c);
        c = fmaf(s_hi[k], det[r + bD + stD * k], c);
      }
      nxt[r] = c;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  const long long tail_start = n - span_r;
  T* dst = out + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const long long t = t0 + o;
    float v = cur[o];
    if (t < span_l) {
      v = head[b * span_l + t];
    } else if (t >= tail_start) {
      v = tail[b * span_r + (t - tail_start)];
    }
    dst[o] = from_f32<T>(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
symmetric_adjoint_kernel(const T* __restrict__ c, PlanePtrs out,
                         const float* __restrict__ taps,
                         const int* __restrict__ plan, long long n, int levels,
                         int L, int tile, int tiles_per_row, int width) {
  extern __shared__ float smem[];
  float* s_lo = smem;
  float* s_hi = smem + L;
  float* cur = smem + 2 * L;
  float* nxt = cur + width;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_lo[k] = taps[k];
    s_hi[k] = taps[L + k];
  }
  // v_0 = c over its window
  const T* row = c + row_off;
  for (int q = threadIdx.x; q < plan[1]; q += blockDim.x) {
    cur[q] = load_ext(row, t0 + plan[0] + q, n, false);
  }
  __syncthreads();
  for (int j = 1; j <= levels; ++j) {
    const int* p = plan + kPlanStride * (j - 1);
    const int bA = p[2], stA = p[3], bD = p[4], stD = p[5];
    T* dj = static_cast<T*>(out.p[j - 1]) + row_off + t0;
    for (int q = threadIdx.x; q < n_out; q += blockDim.x) {
      float d = 0.0f;
      for (int k = 0; k < L; ++k) d = fmaf(s_hi[k], cur[q + bD + stD * k], d);
      dj[q] = from_f32<T>(d);
    }
    const int len_out = j < levels ? plan[kPlanStride * j + 1] : tile;
    for (int r = threadIdx.x; r < len_out; r += blockDim.x) {
      float v = 0.0f;
      for (int k = 0; k < L; ++k) v = fmaf(s_lo[k], cur[r + bA + stA * k], v);
      nxt[r] = v;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  T* aj = static_cast<T*>(out.p[levels]) + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) aj[o] = from_f32<T>(cur[o]);
}

inline size_t symmetric_shared_bytes(int L, int width, int adjoint) {
  return sizeof(float) * (2 * static_cast<size_t>(L) +
                          (adjoint ? 2 : 3) * static_cast<size_t>(width));
}

template <typename T>
cudaError_t launch_symmetric(void* const* planes, void* signal, const float* head,
                             const float* tail, const float* taps, const int* plan,
                             long long batch, long long n, int levels, int L,
                             int tile, int width, int span_l, int span_r,
                             int adjoint, cudaStream_t stream) {
  PlanePtrs ptrs{};
  for (int i = 0; i <= levels; ++i) ptrs.p[i] = planes[i];
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = symmetric_shared_bytes(L, width, adjoint);
  cudaError_t err;
  if (adjoint) {
    err = reserve_shared(symmetric_adjoint_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    symmetric_adjoint_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
        static_cast<const T*>(signal), ptrs, taps, plan, n, levels, L, tile,
        static_cast<int>(tiles), width);
  } else {
    err = reserve_shared(symmetric_synthesis_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    symmetric_synthesis_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes,
                                    stream>>>(
        ptrs, static_cast<T*>(signal), head, tail, taps, plan, n, levels, L, tile,
        static_cast<int>(tiles), width, span_l, span_r);
  }
  return cudaGetLastError();
}

}  // namespace vw

// Forward (adjoint = 0): planes d_1..d_J, a_J -> signal, with the splice from
// head [batch, span_l] and tail [batch, span_r] (fp32).  Adjoint (adjoint = 1):
// signal -> planes; head and tail are not read.  plan: kPlanStride ints per
// level on the device; width: the longest window of the plan.
extern "C" int vw_modwt_symmetric_synthesis(
    void* const* planes, void* signal, const void* head, const void* tail,
    const void* taps, const void* plan, long long batch, long long n, int levels,
    int taps_len, int tile, int width, int span_l, int span_r, int adjoint,
    int dtype, void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || width < tile ||
      span_l < 0 || span_r < 0 || span_l + span_r > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* h = static_cast<const float*>(head);
  const float* tl = static_cast<const float*>(tail);
  const float* t = static_cast<const float*>(taps);
  const int* p = static_cast<const int*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_symmetric<float>(planes, signal, h, tl, t, p, batch, n, levels,
                                      taps_len, tile, width, span_l, span_r, adjoint, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_symmetric<__nv_bfloat16>(planes, signal, h, tl, t, p, batch, n,
                                              levels, taps_len, tile, width, span_l,
                                              span_r, adjoint, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
