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
// fp32 it is bound by device memory.  The design keeps both passes in shared
// memory: a block owns th output rows of one residue class mod s and tw
// columns, loads its (th + L - 1) x (tw + s (L - 1)) input window once with
// coalesced row loads (edge applied per axis as it loads, through row and
// column index tables the block fills once), runs the W pass on
// all window rows and the H pass on its outputs, and writes the four bands
// with coalesced stores.  Rows are gathered by class (polyphase along H), so
// the window is th + L - 1 rows deep at every level; the W halo is read
// again by the neighbouring block, which the grid order keeps in L2.
#include "modwt2_common.cuh"

namespace vw {

__global__ void __launch_bounds__(kThreads)
modwt2_analysis_kernel(const float* __restrict__ x, float* __restrict__ ll,
                       float* __restrict__ lh, float* __restrict__ hl,
                       float* __restrict__ hh, const float* __restrict__ taps,
                       long long H, long long W, int L, int s, int edge, int th,
                       int tw, int chunks, int wtiles) {
  extern __shared__ float smem[];
  const int rows = th + L - 1;
  const int reach = s * (L - 1);
  const int width = tw + reach;
  float* s_lo = smem;
  float* s_hi = smem + L;
  float* win = smem + 2 * L;         // rows x width input window
  float* aw = win + rows * width;    // rows x tw, low along W
  float* dw = aw + rows * tw;        // rows x tw, high along W
  int* row_of = reinterpret_cast<int*>(dw + rows * tw);  // rows image rows
  int* col_of = row_of + rows;                            // width image columns

  const Block2 blk = block2(s, th, tw, chunks, wtiles);
  const long long plane = blk.image * H * W;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_lo[k] = taps[k];
    s_hi[k] = taps[L + k];
  }
  // window row i is image row res + s (k0 - (L - 1) + i); column q is
  // c0 - reach + q
  fill_index(row_of, rows, blk.res + static_cast<long long>(s) * (blk.k0 - (L - 1)), s, H,
             edge);
  fill_index(col_of, width, blk.c0 - reach, 1, W, edge);
  __syncthreads();
  for_each_2d(rows, width, [&](int i, int q) {
    const int gr = row_of[i];
    const int gc = col_of[q];
    win[i * width + q] =
        (gr < 0 || gc < 0) ? 0.0f : x[plane + static_cast<long long>(gr) * W + gc];
  });
  __syncthreads();
  // W pass on every window row: out column c reads window columns
  // c + reach - s l
  for_each_2d(rows, tw, [&](int i, int c) {
    const float* src = win + i * width + c + reach;
    float a = 0.0f, d = 0.0f;
    for (int l = 0; l < L; ++l) {
      const float v = src[-s * l];
      a = fmaf(s_lo[l], v, a);
      d = fmaf(s_hi[l], v, d);
    }
    aw[i * tw + c] = a;
    dw[i * tw + c] = d;
  });
  __syncthreads();
  // H pass: output row k of the block reads window rows k + L - 1 - l
  for_each_2d(th, tw, [&](int k, int c) {
    const long long r = blk.res + static_cast<long long>(s) * (blk.k0 + k);
    const long long col = blk.c0 + c;
    if (r >= H || col >= W) return;
    float v_ll = 0.0f, v_hl = 0.0f, v_lh = 0.0f, v_hh = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int i = (k + L - 1 - l) * tw + c;
      const float a = aw[i];
      const float d = dw[i];
      v_ll = fmaf(s_lo[l], a, v_ll);
      v_hl = fmaf(s_hi[l], a, v_hl);
      v_lh = fmaf(s_lo[l], d, v_lh);
      v_hh = fmaf(s_hi[l], d, v_hh);
    }
    const long long o = plane + r * W + col;
    ll[o] = v_ll;
    lh[o] = v_lh;
    hl[o] = v_hl;
    hh[o] = v_hh;
  });
}

inline size_t analysis2_shared_bytes(int L, int s, int th, int tw) {
  const size_t rows = th + L - 1;
  const size_t width = tw + static_cast<size_t>(s) * (L - 1);
  return sizeof(float) * (2 * static_cast<size_t>(L) + rows * width + 2 * rows * tw) +
         sizeof(int) * (rows + width);
}

}  // namespace vw

extern "C" int vw_modwt2_analysis_level(const void* x, void* ll, void* lh, void* hl,
                                        void* hh, const void* taps, long long batch,
                                        long long h, long long w, int taps_len,
                                        int spacing, int edge, int th, int tw,
                                        void* stream) {
  if (!vw::valid_config2(batch, h, w, taps_len, spacing, edge, th, tw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vw::Grid2 g = vw::grid2(batch, h, w, spacing, th, tw);
  if (g.blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = vw::analysis2_shared_bytes(taps_len, spacing, th, tw);
  cudaError_t err = vw::reserve_shared(vw::modwt2_analysis_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vw::modwt2_analysis_kernel<<<static_cast<unsigned>(g.blocks), vw::kThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(ll), static_cast<float*>(lh),
      static_cast<float*>(hl), static_cast<float*>(hh), static_cast<const float*>(taps),
      h, w, taps_len, spacing, edge, th, tw, g.chunks, g.wtiles);
  return static_cast<int>(cudaGetLastError());
}
