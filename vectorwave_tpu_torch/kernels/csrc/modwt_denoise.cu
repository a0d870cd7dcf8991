// Fused J-level denoise in one pass: analysis -> per-(signal, level)
// threshold -> synthesis, with the coefficient planes kept in shared memory.
//
// Replaces the TPU kernel vectorwave_tpu/kernels/modwt_mxu.py
// `_composite_denoise_call`, which runs composite banded-matmul analysis,
// shrinks the planes in VMEM and runs composite synthesis, so that device
// memory sees only x in and x_hat out.  Mode "none" makes it the one-pass
// round trip (`modwt_roundtrip_fused`).  Here both halves are the per-level
// a trous cascades of modwt_analysis.cu and modwt_synthesis.cu:
//   * the block loads x over [t0 - S, t0 + tile + S) with S = (L-1)(2^J-1)
//     (wrapped, zero-extended, or in stream mode read from the halo left of
//     0, below);
//   * analysis runs over the whole window and keeps d_1..d_J (thresholded)
//     and a_J for the plane window [t0, t0 + tile + S);
//   * soft is d - clamp(d, -t, t), hard keeps |d| > t, none passes d;
//   * on a zero boundary the plane samples at positions >= n are zeroed
//     before synthesis, because the inverse zero-extends the coefficients
//     while the window's tail holds the analysis of zero-extended x;
//   * synthesis runs from coarse to fine into [t0, t0 + tile).
//
// Stream mode (`run_denoise_composite_stream`, the streaming denoiser's
// step): a zero boundary whose left side is an external halo, [batch,
// halo_len] values of x's type holding the raw stream just before the
// block.  The window reads halo[halo_len + g] for g < 0 (0 before the halo;
// load_halo) and 0 past n; the plane samples past n are zeroed as on the
// zero boundary, so the inverse is block-local with zero coefficients on
// the right (the TPU kernel's `zero_tail`).  Synthesis reads only forward,
// so the left needs no coefficient extension.  Nothing else changes: the
// mode is a load rule.
//
// What bounds it on the H100: device-memory traffic is 8 B per sample for
// float32, so the kernel is bound by shared-memory loads and fp32 throughput
// (4 L J FMAs per sample, plus the recomputed halos of each tile).  The J
// planes of a tile take J (tile + S) floats of shared memory, about 50 KB at
// tile 1024 for db4 J = 6, so the launch opts in to more than 48 KB.  Every
// precision tier (float32, bf16_3x, bf16) runs this same fp32 kernel, which
// meets each tier's error contract; tensor-core tiers are later work.
#include "modwt_common.cuh"

namespace vw {

enum ShrinkMode : int { kNone = 0, kSoft = 1, kHard = 2 };

__device__ __forceinline__ float shrink(float d, float t, int mode) {
  if (mode == kSoft) return d - fminf(fmaxf(d, -t), t);
  if (mode == kHard) return fabsf(d) > t ? d : 0.0f;
  return d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
modwt_denoise_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const float* __restrict__ thresholds,
                     const float* __restrict__ taps, const T* __restrict__ halo,
                     int halo_len, long long n, int levels,
                     int L, int tile, int tiles_per_row, int periodic,
                     int mode) {
  extern __shared__ float smem[];
  const int span = cascade_span(L, levels);
  const int width = tile + 2 * span;  // x window
  const int pw = tile + span;         // plane window
  float* a_lo = smem;
  float* a_hi = smem + L;
  float* r_lo = smem + 2 * L;
  float* r_hi = smem + 3 * L;
  float* cur = smem + 4 * L;
  float* nxt = cur + width;
  float* planes = nxt + width;  // [levels, pw]

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const T* row = x + row_off;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const bool wrap = periodic != 0;

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    a_lo[k] = taps[k];
    a_hi[k] = taps[L + k];
    r_lo[k] = taps[2 * L + k];
    r_hi[k] = taps[3 * L + k];
  }
  const long long g0 = t0 - span;
  const T* halo_row = halo == nullptr ? nullptr : halo + b * halo_len;
  for (int q = threadIdx.x; q < width; q += blockDim.x) {
    cur[q] = halo_row == nullptr ? load_ext(row, g0 + q, n, wrap)
                                 : load_halo(row, halo_row, halo_len, g0 + q, n);
  }
  __syncthreads();

  // analysis over the window, thresholding the detail planes as they appear
  int valid = 0;
  for (int j = 1; j <= levels; ++j) {
    const int s = 1 << (j - 1);
    const int first = valid + (L - 1) * s;
    const float th = thresholds[b * levels + (j - 1)];
    float* plane = planes + (j - 1) * pw;
    for (int q = first + threadIdx.x; q < width; q += blockDim.x) {
      float a = 0.0f;
      float d = 0.0f;
      for (int k = 0; k < L; ++k) {
        const float v = cur[q - k * s];
        a = fmaf(a_lo[k], v, a);
        d = fmaf(a_hi[k], v, d);
      }
      nxt[q] = a;
      const int r = q - span;
      if (r >= 0) {
        const bool outside = !wrap && t0 + r >= n;
        plane[r] = outside ? 0.0f : shrink(d, th, mode);
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    valid = first;
  }
  // c_J = a_J on the plane window (zero past n on a zero boundary)
  for (int r = threadIdx.x; r < pw; r += blockDim.x) {
    const bool outside = !wrap && t0 + r >= n;
    nxt[r] = outside ? 0.0f : cur[span + r];
  }
  __syncthreads();
  {
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // synthesis from coarse to fine with forward reads
  int valid_end = pw;
  for (int j = levels; j >= 1; --j) {
    const int s = 1 << (j - 1);
    const float* plane = planes + (j - 1) * pw;
    const int new_end = valid_end - (L - 1) * s;
    for (int r = threadIdx.x; r < new_end; r += blockDim.x) {
      float c = 0.0f;
      for (int k = 0; k < L; ++k) {
        c = fmaf(r_lo[k], cur[r + k * s], c);
        c = fmaf(r_hi[k], plane[r + k * s], c);
      }
      nxt[r] = c;
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

inline size_t denoise_shared_bytes(int L, int levels, int tile) {
  const size_t span = static_cast<size_t>(cascade_span(L, levels));
  return sizeof(float) * (4 * static_cast<size_t>(L) + 2 * (tile + 2 * span) +
                          static_cast<size_t>(levels) * (tile + span));
}

template <typename T>
cudaError_t launch_denoise(const void* x, void* out, const float* thresholds,
                           const float* taps, const void* halo, int halo_len,
                           long long batch, long long n,
                           int levels, int L, int tile, int periodic, int mode,
                           cudaStream_t stream) {
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = denoise_shared_bytes(L, levels, tile);
  cudaError_t err = reserve_shared(modwt_denoise_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  modwt_denoise_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), thresholds, taps,
      static_cast<const T*>(halo), halo_len, n, levels, L, tile,
      static_cast<int>(tiles), periodic, mode);
  return cudaGetLastError();
}

}  // namespace vw

// halo: null, or in stream mode (periodic == 0) [batch, halo_len] values of
// x's type, the raw samples left of each row.
extern "C" int vw_modwt_denoise(const void* x, void* out, const void* thresholds,
                                const void* taps, const void* halo, int halo_len,
                                long long batch, long long n, int levels,
                                int taps_len, int tile, int periodic, int mode,
                                int dtype, void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || mode < vw::kNone ||
      mode > vw::kHard || (halo == nullptr) != (halo_len == 0) || halo_len < 0 ||
      (halo != nullptr && periodic != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* th = static_cast<const float*>(thresholds);
  const float* t = static_cast<const float*>(taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_denoise<float>(x, out, th, t, halo, halo_len, batch, n, levels,
                                    taps_len, tile, periodic, mode, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_denoise<__nv_bfloat16>(x, out, th, t, halo, halo_len, batch, n,
                                            levels, taps_len, tile, periodic, mode, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
