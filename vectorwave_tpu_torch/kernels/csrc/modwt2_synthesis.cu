// One level of the separable 2-D MODWT synthesis: LL_j, LH_j, HL_j, HH_j ->
// LL_{j-1}.
//
// Replaces the TPU kernel vectorwave_tpu/kernels/modwt2_pallas.py
// `_modwt2_synthesis_call`, which sums over the planes of a group of shallow
// levels each filtered by separable forward composite filters (W~, H~), and
// whose `pairs_override` serves its per-level cascade tier and the symmetric
// inverse.  Here every level is one launch of one stage.  The definition
// (twodim.imodwt2_multilevel) runs along H on (ll, hl) and on (lh, hh), then
// along W; the two axes' operators commute, so the kernel runs W first:
//     row_a = W_lo(ll) + W_hi(lh),   row_d = W_lo(hl) + W_hi(hh),
//     out   = H_lo(row_a) + H_hi(row_d),
// where op f reads in[t + sign_f s l + offset_f].  Periodic and zero edges
// read forward with no offset; the symmetric inverse's per-filter alignment
// (twodim._inv_axis) is one more (sign, offset) pair per filter, not another
// kernel.
//
// What bounds it on the H100: four planes read and one written, 20 B per
// pixel, against 6 L FMAs per pixel; bound by device memory.  A block owns th
// output rows of one residue class mod s and tw columns.  It loads one plane
// at a time, the th + L - 1 rows of the class that the plane's H op reads by
// the columns its W ops read (edge applied through index tables the block
// fills), adds the plane's W pass into row_a or row_d, and after the fourth
// plane runs the H pass and stores.  Running W first keeps the W pass to the
// tile's columns and shared memory to one plane window and two tile-wide
// sums.  Rows are gathered by class (polyphase along H), so the window is
// th + L - 1 rows deep at every level.
#include "modwt2_common.cuh"

namespace vw {

struct Ops2 {
  int lo_sign, lo_off, hi_sign, hi_off;
};

__global__ void __launch_bounds__(kThreads)
modwt2_synthesis_kernel(const float* __restrict__ p_ll, const float* __restrict__ p_lh,
                        const float* __restrict__ p_hl, const float* __restrict__ p_hh,
                        float* __restrict__ out, const float* __restrict__ taps,
                        long long H, long long W, int L, int s, Ops2 ops, int wlo,
                        int width, int edge, int th, int tw, int chunks, int wtiles) {
  extern __shared__ float smem[];
  const int rows = th + L - 1;
  float* s_lo = smem;
  float* s_hi = smem + L;
  float* buf = smem + 2 * L;         // rows x width plane window
  float* row_a = buf + rows * width;  // rows x tw, to be filtered low along H
  float* row_d = row_a + rows * tw;   // rows x tw, to be filtered high along H
  int* row_of = reinterpret_cast<int*>(row_d + rows * tw);  // rows image rows
  int* col_of = row_of + rows;                               // width image columns

  const Block2 blk = block2(s, th, tw, chunks, wtiles);
  const long long plane = blk.image * H * W;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_lo[k] = taps[k];
    s_hi[k] = taps[L + k];
  }
  for (int e = threadIdx.x; e < rows * tw; e += blockDim.x) {
    row_a[e] = 0.0f;
    row_d[e] = 0.0f;
  }
  // window column q is image column c0 + wlo + q
  fill_index(col_of, width, blk.c0 + wlo, 1, W, edge);
  // plane p: its W filter is hi (lh, hh), its H filter is hi (hl, hh): it is
  // summed into row_d
  const float* planes[4] = {p_ll, p_lh, p_hl, p_hh};
  for (int p = 0; p < 4; ++p) {
    const bool w_hi = p & 1;
    const bool h_hi = p >> 1;
    const int h_sign = h_hi ? ops.hi_sign : ops.lo_sign;
    const int h_off = h_hi ? ops.hi_off : ops.lo_off;
    const int mrel = min(0, h_sign * (L - 1));
    const float* src = planes[p] + plane;
    __syncthreads();  // the previous plane's W pass is done with buf and row_of
    // window row i is image row res + h_off + s (k0 + mrel + i)
    fill_index(row_of, rows,
               blk.res + h_off + static_cast<long long>(s) * (blk.k0 + mrel), s, H, edge);
    __syncthreads();
    for_each_2d(rows, width, [&](int i, int q) {
      const int gr = row_of[i];
      const int gc = col_of[q];
      buf[i * width + q] =
          (gr < 0 || gc < 0) ? 0.0f : src[static_cast<long long>(gr) * W + gc];
    });
    __syncthreads();
    const float* f = w_hi ? s_hi : s_lo;
    const int w_sign = w_hi ? ops.hi_sign : ops.lo_sign;
    const int w_first = (w_hi ? ops.hi_off : ops.lo_off) - wlo;
    float* dst = h_hi ? row_d : row_a;
    // W pass: output column c reads window column c + offset + sign s l - wlo
    for_each_2d(rows, tw, [&](int i, int c) {
      const float* in = buf + i * width + c + w_first;
      float acc = 0.0f;
      for (int l = 0; l < L; ++l) acc = fmaf(f[l], in[w_sign * s * l], acc);
      dst[i * tw + c] += acc;
    });
  }
  __syncthreads();
  // H pass: output row k reads window row k + sign l - mrel of its filter's sum
  const int mrel_lo = min(0, ops.lo_sign * (L - 1));
  const int mrel_hi = min(0, ops.hi_sign * (L - 1));
  for_each_2d(th, tw, [&](int k, int c) {
    const long long r = blk.res + static_cast<long long>(s) * (blk.k0 + k);
    const long long col = blk.c0 + c;
    if (r >= H || col >= W) return;
    const float* a = row_a + (k - mrel_lo) * tw + c;
    const float* d = row_d + (k - mrel_hi) * tw + c;
    float v = 0.0f;
    for (int l = 0; l < L; ++l) {
      v = fmaf(s_lo[l], a[ops.lo_sign * l * tw], v);
      v = fmaf(s_hi[l], d[ops.hi_sign * l * tw], v);
    }
    out[plane + r * W + col] = v;
  });
}

// Least and greatest read offset of in[t + sign s l + off], l < L.
inline void reach2(int sign, int off, int s, int L, int* lo, int* hi) {
  const int far = off + sign * s * (L - 1);
  *lo = far < off ? far : off;
  *hi = far < off ? off : far;
}

inline size_t synthesis2_shared_bytes(int L, int th, int tw, int width) {
  const size_t rows = th + L - 1;
  return sizeof(float) * (2 * static_cast<size_t>(L) + rows * width + 2 * rows * tw) +
         sizeof(int) * (rows + width);
}

}  // namespace vw

extern "C" int vw_modwt2_synthesis_level(const void* ll, const void* lh, const void* hl,
                                         const void* hh, void* out, const void* taps,
                                         long long batch, long long h, long long w,
                                         int taps_len, int spacing, int lo_sign,
                                         int lo_off, int hi_sign, int hi_off, int edge,
                                         int th, int tw, void* stream) {
  if (!vw::valid_config2(batch, h, w, taps_len, spacing, edge, th, tw) ||
      (lo_sign != 1 && lo_sign != -1) || (hi_sign != 1 && hi_sign != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int a_lo, a_hi, d_lo, d_hi;
  vw::reach2(lo_sign, lo_off, spacing, taps_len, &a_lo, &a_hi);
  vw::reach2(hi_sign, hi_off, spacing, taps_len, &d_lo, &d_hi);
  const int wlo = a_lo < d_lo ? a_lo : d_lo;
  const int whi = a_hi > d_hi ? a_hi : d_hi;
  const int width = tw + whi - wlo;
  const vw::Grid2 g = vw::grid2(batch, h, w, spacing, th, tw);
  if (g.blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = vw::synthesis2_shared_bytes(taps_len, th, tw, width);
  cudaError_t err = vw::reserve_shared(vw::modwt2_synthesis_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const vw::Ops2 ops{lo_sign, lo_off, hi_sign, hi_off};
  vw::modwt2_synthesis_kernel<<<static_cast<unsigned>(g.blocks), vw::kThreads, bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ll), static_cast<const float*>(lh),
      static_cast<const float*>(hl), static_cast<const float*>(hh),
      static_cast<float*>(out), static_cast<const float*>(taps), h, w, taps_len,
      spacing, ops, wlo, width, edge, th, tw, g.chunks, g.wtiles);
  return static_cast<int>(cudaGetLastError());
}
