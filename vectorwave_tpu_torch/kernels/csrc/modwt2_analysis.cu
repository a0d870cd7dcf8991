// One level of the separable 2-D MODWT analysis: LL_{j-1} -> LL_j, LH_j,
// HL_j, HH_j.
//
// Replaces the TPU kernel vectorwave_tpu/kernels/modwt2_pallas.py
// `_modwt2_analysis_call`, which filters an image tile with the composite
// per-level filters of a group of shallow levels (W as banded lane matmuls,
// H as left matmuls) or, for deep levels, one à trous stage on the previous
// LL (its cascade tier).  Both give the 2-D à trous pyramid; here every level
// is one launch of one stage:
//     a_w[r, c] = sum_l lo[l] x[r, c - s l],   d_w[r, c] = sum_l hi[l] x[r, c - s l]
//     ll = sum_l lo[l] a_w[r - s l, c],  hl = sum_l hi[l] a_w[r - s l, c]
//     lh = sum_l lo[l] d_w[r - s l, c],  hh = sum_l hi[l] d_w[r - s l, c]
// (first letter: the filter along H; second: along W).
//
// What bounds it on the H100: one plane read and four written, 20 B per
// pixel, against 6 L FMAs per pixel (48 for db4); at 3.35 TB/s and 67 TFLOP/s
// fp32 it is bound by device memory, and 16 of the 20 bytes are stores.  A
// block owns th output rows of one residue class mod s and tw columns (the
// tile chosen per level by kernels/modwt2.py); rows are gathered by class
// (polyphase along H), so the window is th + L - 1 rows deep at every level.
// It is the design of modwt2_synthesis.cu read for one plane in, four out:
//   * the window (th + L - 1 class rows by tw + s (L - 1) columns) is copied
//     with cp.async, every copy of a warp's rows in flight at once: 16-byte
//     copies where it lies inside the image and lines up, 4-byte copies
//     elsewhere, the edge applied per row and per column outside the image
//     only (copy_window);
//   * both passes read forward, in[t + s l'], with the taps reversed
//     (g[l'] = f[L - 1 - l']);
//   * the W pass: a thread owns kW = 4 outputs c, c + s, c + 2s, c + 3s of
//     one column class and steps through the taps 4 at a time, the samples
//     in registers, 3 carried to the next step; each loaded sample feeds
//     both the low and the high sum, and the taps are 16-byte broadcasts.
//     Lanes are laid out 8 strips by 4 rows with the window's row pitch
//     min(s, 8) words mod 32, so a warp's loads hit 32 banks.  Where the
//     tile is not a multiple of 4s columns, a thread owns one output;
//   * the H pass: a thread owns one column and 4 consecutive class rows and
//     steps through the taps the same way on a_w (ll, hl) and d_w (lh, hh):
//     16 sums from 2 loads a tap;
//   * the stores: neighbouring lanes own neighbouring columns of one output
//     row, so each warp's store of a band is whole 128-byte lines.
#include "modwt2_common.cuh"

namespace vw {

// Two filters along one line, one loaded sample feeding both:
// acc_a[j] += sum_l g_a[l] line[(j + l) stride], acc_b[j] likewise with g_b,
// j < K.  Taps 4 at a time (16-byte broadcasts from shared memory, g_a and
// g_b padded to a multiple of 4), the samples of a step in registers, 3 of
// them carried to the next step; the taps left over one at a time.
template <int K>
__device__ __forceinline__ void filter_line2(float (&acc_a)[K], float (&acc_b)[K],
                                             const float* line, int stride,
                                             const float* g_a, const float* g_b, int L) {
  constexpr int kSpan = K + 3;
  float b[kSpan];
  const int full = L & ~3;
  if (full > 0) {
#pragma unroll
    for (int e = 0; e < K - 1; ++e) b[e] = line[e * stride];
  }
  for (int l0 = 0; l0 < full; l0 += 4) {
#pragma unroll
    for (int e = K - 1; e < kSpan; ++e) b[e] = line[(l0 + e) * stride];
    const float4 a4 = *reinterpret_cast<const float4*>(g_a + l0);
    const float4 b4 = *reinterpret_cast<const float4*>(g_b + l0);
    const float ta[4] = {a4.x, a4.y, a4.z, a4.w};
    const float tb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        acc_a[j] = fmaf(ta[u], b[j + u], acc_a[j]);
        acc_b[j] = fmaf(tb[u], b[j + u], acc_b[j]);
      }
    }
#pragma unroll
    for (int e = 0; e < K - 1; ++e) b[e] = b[e + 4];
  }
  for (int l = full; l < L; ++l) {
    const float ta = g_a[l];
    const float tb = g_b[l];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float v = line[(j + l) * stride];
      acc_a[j] = fmaf(ta, v, acc_a[j]);
      acc_b[j] = fmaf(tb, v, acc_b[j]);
    }
  }
}

// W pass over the window rows: aw[i][c] and dw[i][c], the low and high W
// filters of window row i at output column c.  Strips of kW outputs of one
// column class: strip sigma of a row is class sigma mod s, index sigma / s
// (kW = 4), or column sigma (kW = 1); a warp takes 8 strips of 4 rows.
template <int kW>
__device__ __forceinline__ void analysis_w_pass(float* aw, float* dw, int rpitch,
                                                const float* win, int pitch,
                                                const float* g_lo, const float* g_hi,
                                                int rows, int tw, int s, int L) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 3;
  const int q = lane & 7;
  const int octets = tw / kW / 8;
  const int items = ((rows + 3) >> 2) * octets;
  for (int it = threadIdx.x >> 5; it < items; it += kThreads / 32) {
    const int i = 4 * (it / octets) + r;
    if (i >= rows) continue;
    const int sigma = 8 * (it % octets) + q;
    const int c = kW == 1 ? sigma : (sigma & (s - 1)) + s * kW * (sigma / s);
    float a[kW], d[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) a[j] = d[j] = 0.0f;
    filter_line2<kW>(a, d, win + i * pitch + c, s, g_lo, g_hi, L);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      aw[i * rpitch + c + j * s] = a[j];
      dw[i * rpitch + c + j * s] = d[j];
    }
  }
}

// The four output bands, by value in the parameter block.
struct Bands2 {
  float* ll;
  float* lh;
  float* hl;
  float* hh;
};

template <int kW>
__global__ void __launch_bounds__(kThreads, 3)
modwt2_analysis_kernel(const float* __restrict__ x, Bands2 out,
                       const float* __restrict__ taps, long long H, long long W, int L,
                       int s, int edge, int th, int tw, int pitch, int rpitch, int chunks,
                       int wtiles) {
  extern __shared__ __align__(16) float smem[];
  const int L4 = (L + 3) & ~3;
  const int rows = th + L - 1;
  const int reach = s * (L - 1);
  const int width = tw + reach;
  float* g_lo = smem;
  float* g_hi = smem + L4;
  float* win = smem + 2 * L4;       // rows x width, row pitch `pitch`
  float* aw = win + rows * pitch;   // rows x tw, low along W, row pitch `rpitch`
  float* dw = aw + rows * rpitch;   // rows x tw, high along W

  const Block2 blk = block2(s, th, tw, chunks, wtiles);
  const long long plane = blk.image * H * W;
  // window row i is image row res + s (k0 - (L - 1) + i); column q is image
  // column c0 - reach + q
  const long long col0 = blk.c0 - reach;
  const bool inside = col0 >= 0 && col0 + ((width + 3) & ~3) <= W;
  const bool vec = inside && ((col0 | pitch | W) & 3) == 0 &&
                   (reinterpret_cast<size_t>(x) & 15) == 0;
  copy_window(win, x + plane, blk.res + static_cast<long long>(s) * (blk.k0 - (L - 1)), s,
              H, W, col0, rows, width, pitch, inside, vec, edge);
  // forward reads: out[t] = sum_l' g[l'] in[t - reach + s l'], g reversed
  for (int l = threadIdx.x; l < L4; l += blockDim.x) {
    const bool in = l < L;
    g_lo[l] = in ? taps[L - 1 - l] : 0.0f;
    g_hi[l] = in ? taps[L + L - 1 - l] : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();
  analysis_w_pass<kW>(aw, dw, rpitch, win, pitch, g_lo, g_hi, rows, tw, s, L);
  __syncthreads();

  // H pass: output row k reads a_w, d_w rows k + l' (window rows)
  const int items = ((th + kH - 1) / kH) * tw;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int k = kH * (it / tw);
    const int c = it - (it / tw) * tw;
    const long long col = blk.c0 + c;
    if (col >= W) continue;
    const int n_rows = min(kH, th - k);
    const float* a_col = aw + k * rpitch + c;
    const float* d_col = dw + k * rpitch + c;
    float ll[kH], hl[kH], lh[kH], hh[kH];
#pragma unroll
    for (int j = 0; j < kH; ++j) ll[j] = hl[j] = lh[j] = hh[j] = 0.0f;
    if (n_rows == kH) {
      filter_line2<kH>(ll, hl, a_col, rpitch, g_lo, g_hi, L);
      filter_line2<kH>(lh, hh, d_col, rpitch, g_lo, g_hi, L);
    } else {
      // unrolled, so that the sums stay in registers
#pragma unroll
      for (int j = 0; j < kH; ++j) {
        if (j >= n_rows) break;
        float a_lo[1] = {0.0f}, a_hi[1] = {0.0f}, d_lo[1] = {0.0f}, d_hi[1] = {0.0f};
        filter_line2<1>(a_lo, a_hi, a_col + j * rpitch, rpitch, g_lo, g_hi, L);
        filter_line2<1>(d_lo, d_hi, d_col + j * rpitch, rpitch, g_lo, g_hi, L);
        ll[j] = a_lo[0];
        hl[j] = a_hi[0];
        lh[j] = d_lo[0];
        hh[j] = d_hi[0];
      }
    }
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      const long long r = blk.res + static_cast<long long>(s) * (blk.k0 + k + j);
      if (j < n_rows && r < H) {
        const long long o = plane + r * W + col;
        out.ll[o] = ll[j];
        out.lh[o] = lh[j];
        out.hl[o] = hl[j];
        out.hh[o] = hh[j];
      }
    }
  }
}

inline size_t analysis2_shared_bytes(int L, int th, int pitch, int rpitch) {
  const size_t rows = th + L - 1;
  const size_t L4 = (L + 3) & ~3;
  return sizeof(float) * (2 * L4 + rows * (static_cast<size_t>(pitch) + 2 * rpitch));
}

template <int kW>
cudaError_t launch_analysis2(const float* x, Bands2 out, const float* taps, long long batch,
                             long long h, long long w, int L, int s, int edge, int th,
                             int tw, int pitch, int rpitch, cudaStream_t stream) {
  const Grid2 g = grid2(batch, h, w, s, th, tw);
  if (g.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = analysis2_shared_bytes(L, th, pitch, rpitch);
  cudaError_t err = reserve_shared(modwt2_analysis_kernel<kW>, bytes);
  if (err != cudaSuccess) return err;
  modwt2_analysis_kernel<kW><<<static_cast<unsigned>(g.blocks), kThreads, bytes, stream>>>(
      x, out, taps, h, w, L, s, edge, th, tw, pitch, rpitch, g.chunks, g.wtiles);
  return cudaGetLastError();
}

}  // namespace vw

extern "C" int vw_modwt2_analysis_level(const void* x, void* ll, void* lh, void* hl,
                                        void* hh, const void* taps, long long batch,
                                        long long h, long long w, int taps_len,
                                        int spacing, int edge, int th, int tw, int pitch,
                                        int rpitch, int block, void* stream) {
  if (!vw::valid_config2(batch, h, w, taps_len, spacing, edge, th, tw) ||
      (block != 1 && block != 4) || (block == 4 && tw % (4 * spacing) != 0) ||
      tw % (8 * block) != 0 || pitch < tw + spacing * (taps_len - 1) || rpitch < tw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vw::Bands2 out{static_cast<float*>(ll), static_cast<float*>(lh),
                       static_cast<float*>(hl), static_cast<float*>(hh)};
  const float* xf = static_cast<const float*>(x);
  const float* tf = static_cast<const float*>(taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      block == 4 ? vw::launch_analysis2<4>(xf, out, tf, batch, h, w, taps_len, spacing, edge,
                                           th, tw, pitch, rpitch, s)
                 : vw::launch_analysis2<1>(xf, out, tf, batch, h, w, taps_len, spacing, edge,
                                           th, tw, pitch, rpitch, s);
  return static_cast<int>(err);
}
