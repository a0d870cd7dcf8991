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
// where op f reads in[t + sign_f s l + offset_f].  The block turns each op
// into forward reads, in[t + base_f + s l'] with the taps reversed where the
// sign is -1, so the symmetric inverse's per-filter alignment
// (twodim._inv_axis) is two numbers per filter, not another kernel.
//
// What bounds it on the H100: four planes read and one written, 20 B per
// pixel, against 6 L FMAs per pixel; bound by device memory.  A block owns th
// output rows of one residue class mod s and tw columns (the tile chosen per
// level by kernels/modwt2.py).  Split by probe builds, the earlier design
// spent most of its time loading: one scalar load at a time through two
// index tables, a plane at a time behind barriers.  Here:
//   * a plane's window (th + L - 1 rows of the class its H op reads, by the
//     columns its W ops read) is copied with cp.async, every copy of a warp's
//     rows in flight at once: 16-byte copies where the window lies inside
//     the image and lines up, 4-byte copies elsewhere, the edge applied per
//     row and per column outside the image, zeros written where the zero
//     edge reads nothing.  (Bulk copies by the copy engine, a row each,
//     measured no faster: the loads are not bound by the threads' copies);
//   * the two planes summed by one H op (ll and lh, then hl and hh) are in
//     shared memory together (`stages` = 2), so the W pass sums both in
//     registers and stores row_a (then row_d) once; the second pair's copies
//     are in flight while the first pair's H pass runs.  Where two windows
//     do not fit, one plane at a time (`stages` = 1);
//   * the W pass: a thread owns kW = 4 outputs c, c + s, c + 2s, c + 3s of
//     one column class and steps through the taps 4 at a time, the 7
//     samples a step needs in registers, 3 carried to the next; the taps are
//     16-byte broadcasts.  Lanes are laid out 8 strips by 4 rows, and the
//     window's row pitch is min(s, 8) words mod 32, so a warp's loads hit 32
//     banks.  Where the tile is not a multiple of 4s columns, a thread owns
//     one output (kW = 1);
//   * the H pass: a thread owns one column and 4 consecutive class rows and
//     steps through the taps as the W pass does; the sums of row_a stay in
//     registers while row_d is built in the same buffer.
#include "modwt2_common.cuh"

namespace vw {

struct Ops2 {
  int lo_sign, lo_off, hi_sign, hi_off;
};

constexpr int kMaxItems = 4;   // H-pass items a thread owns: (th / kH) tw <= 1024

// One filter along a line of the window, forward reads at stride `stride`:
// acc[j] += sum_l g[l] line[(j + l) stride], j < K.  Taps 4 at a time (16-byte
// broadcasts from shared memory, g padded to a multiple of 4), the samples
// of a step in registers, 3 of them carried to the next step.
template <int K>
__device__ __forceinline__ void filter_line(float (&acc)[K], const float* line, int stride,
                                            const float* g, int L) {
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
    const float4 t4 = *reinterpret_cast<const float4*>(g + l0);
    const float t[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = fmaf(t[u], b[j + u], acc[j]);
    }
#pragma unroll
    for (int e = 0; e < K - 1; ++e) b[e] = b[e + 4];
  }
  for (int l = full; l < L; ++l) {
    const float tap = g[l];
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = fmaf(tap, line[(j + l) * stride], acc[j]);
  }
}

// W pass over the window rows: rowbuf[i][c] (= or +=) the W ops of one or
// two planes.  Strips of kW outputs of one column class: strip sigma of a
// row is class sigma mod s, index sigma / s (kW = 4), or column sigma
// (kW = 1); a warp takes 8 strips of 4 rows.
template <int kW>
__device__ __forceinline__ void w_pass(float* rowbuf, int rpitch, const float* win_a,
                                       const float* g_a, int off_a, const float* win_b,
                                       const float* g_b, int off_b, int pitch, int rows,
                                       int tw, int s, int L, bool add) {
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
    float acc[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) acc[j] = 0.0f;
    filter_line<kW>(acc, win_a + i * pitch + c + off_a, s, g_a, L);
    if (win_b != nullptr) filter_line<kW>(acc, win_b + i * pitch + c + off_b, s, g_b, L);
    float* dst = rowbuf + i * rpitch + c;
#pragma unroll
    for (int j = 0; j < kW; ++j) dst[j * s] = add ? dst[j * s] + acc[j] : acc[j];
  }
}

// H pass: oacc[n][j] += sum_l g[l] rowbuf[k + j + l][c] for the thread's
// items n (row group k / kH, column c).
__device__ __forceinline__ void h_pass(float (&oacc)[kMaxItems][kH], const float* rowbuf,
                                       int rpitch, const float* g, int th, int tw, int L) {
  const int items = ((th + kH - 1) / kH) * tw;
#pragma unroll
  for (int n = 0; n < kMaxItems; ++n) {
    const int it = threadIdx.x + n * kThreads;
    if (it >= items) break;
    const int k = kH * (it / tw);
    const int c = it % tw;
    const float* col = rowbuf + k * rpitch + c;
    if (k + kH <= th) {
      filter_line<kH>(oacc[n], col, rpitch, g, L);
    } else {
      for (int j = 0; j < th - k; ++j) {
        float one[1] = {0.0f};
        filter_line<1>(one, col + j * rpitch, rpitch, g, L);
        oacc[n][j] += one[0];
      }
    }
  }
}

// Forward-read form of op (sign, off): base offset and taps g[l'] =
// f[sign > 0 ? l' : L - 1 - l'], zero-padded to a multiple of 4.
__device__ __forceinline__ int forward_base(int sign, int off, int s, int L) {
  return sign > 0 ? off : off - s * (L - 1);
}

// Three blocks to an SM: what the planner's tiles leave room for in shared
// memory, so the registers may go to 85 a thread.
template <int kW>
__global__ void __launch_bounds__(kThreads, 3)
modwt2_synthesis_kernel(const float* __restrict__ p_ll, const float* __restrict__ p_lh,
                        const float* __restrict__ p_hl, const float* __restrict__ p_hh,
                        float* __restrict__ out, const float* __restrict__ taps,
                        long long H, long long W, int L, int s, Ops2 ops, int wlo,
                        int width, int pitch, int rpitch, int stages, int edge, int th,
                        int tw, int chunks, int wtiles) {
  extern __shared__ __align__(16) float smem[];
  const int L4 = (L + 3) & ~3;
  const int rows = th + L - 1;
  float* g_lo = smem;
  float* g_hi = smem + L4;
  float* win0 = smem + 2 * L4;
  float* win1 = win0 + rows * pitch;
  float* rowbuf = win0 + stages * rows * pitch;

  const Block2 blk = block2(s, th, tw, chunks, wtiles);
  const long long plane = blk.image * H * W;
  for (int l = threadIdx.x; l < L4; l += blockDim.x) {
    const bool in = l < L;
    g_lo[l] = in ? taps[ops.lo_sign > 0 ? l : L - 1 - l] : 0.0f;
    g_hi[l] = in ? taps[L + (ops.hi_sign > 0 ? l : L - 1 - l)] : 0.0f;
  }
  const int base_lo = forward_base(ops.lo_sign, ops.lo_off, s, L);
  const int base_hi = forward_base(ops.hi_sign, ops.hi_off, s, L);
  // window column q is image column c0 + wlo + q
  const long long col0 = blk.c0 + wlo;
  const bool inside = col0 >= 0 && col0 + ((width + 3) & ~3) <= W;
  const bool vec = inside && ((col0 | pitch | W) & 3) == 0;

  float oacc[kMaxItems][kH];
#pragma unroll
  for (int n = 0; n < kMaxItems; ++n) {
#pragma unroll
    for (int j = 0; j < kH; ++j) oacc[n][j] = 0.0f;
  }
  // plane 2h + w has H filter h and W filter w (ll, lh, hl, hh)
  auto copy = [&](int p, float* dst) {
    const int h_base = (p >> 1) ? base_hi : base_lo;
    const float* src = p == 0 ? p_ll : p == 1 ? p_lh : p == 2 ? p_hl : p_hh;
    const bool aligned = (reinterpret_cast<size_t>(src) & 15) == 0;
    // window row i is image row res + h_base + s (k0 + i)
    copy_window(dst, src + plane,
                blk.res + h_base + static_cast<long long>(s) * blk.k0, s, H, W, col0, rows,
                width, pitch, inside, vec && aligned, edge);
  };
  if (stages == 2) {
    copy(0, win0);
    copy(1, win1);
  }
  for (int h = 0; h < 2; ++h) {
    if (stages == 2) {
      cp_async_wait_all();
      __syncthreads();
      w_pass<kW>(rowbuf, rpitch, win0, g_lo, base_lo - wlo, win1, g_hi, base_hi - wlo,
                 pitch, rows, tw, s, L, false);
      __syncthreads();  // the windows are free; row_a (row_d) is complete
      if (h == 0) {
        copy(2, win0);
        copy(3, win1);
      }
    } else {
      for (int w = 0; w < 2; ++w) {
        copy(2 * h + w, win0);
        cp_async_wait_all();
        __syncthreads();
        w_pass<kW>(rowbuf, rpitch, win0, w ? g_hi : g_lo, (w ? base_hi : base_lo) - wlo,
                   nullptr, nullptr, 0, pitch, rows, tw, s, L, w == 1);
        __syncthreads();
      }
    }
    h_pass(oacc, rowbuf, rpitch, h ? g_hi : g_lo, th, tw, L);
    __syncthreads();  // the next pair's W pass overwrites the row buffer
  }

  const int items = ((th + kH - 1) / kH) * tw;
#pragma unroll
  for (int n = 0; n < kMaxItems; ++n) {
    const int it = threadIdx.x + n * kThreads;
    if (it >= items) break;
    const int k0 = kH * (it / tw);
    const long long col = blk.c0 + it % tw;
    if (col >= W) continue;
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      const int k = k0 + j;
      const long long r = blk.res + static_cast<long long>(s) * (blk.k0 + k);
      if (k < th && r < H) out[plane + r * W + col] = oacc[n][j];
    }
  }
}

// Least and greatest read offset of in[t + sign s l + off], l < L.
inline void reach2(int sign, int off, int s, int L, int* lo, int* hi) {
  const int far = off + sign * s * (L - 1);
  *lo = far < off ? far : off;
  *hi = far < off ? off : far;
}

inline size_t synthesis2_shared_bytes(int L, int th, int tw, int pitch, int rpitch,
                                      int stages) {
  const size_t rows = th + L - 1;
  const size_t L4 = (L + 3) & ~3;
  return sizeof(float) * (2 * L4 + rows * (stages * static_cast<size_t>(pitch) + rpitch));
}

template <int kW>
cudaError_t launch_synthesis2(const void* ll, const void* lh, const void* hl,
                              const void* hh, void* out, const void* taps, long long batch,
                              long long h, long long w, int L, int s, Ops2 ops, int wlo,
                              int width, int pitch, int rpitch, int stages, int edge,
                              int th, int tw, cudaStream_t stream) {
  const Grid2 g = grid2(batch, h, w, s, th, tw);
  if (g.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = synthesis2_shared_bytes(L, th, tw, pitch, rpitch, stages);
  cudaError_t err = reserve_shared(modwt2_synthesis_kernel<kW>, bytes);
  if (err != cudaSuccess) return err;
  modwt2_synthesis_kernel<kW><<<static_cast<unsigned>(g.blocks), kThreads, bytes, stream>>>(
      static_cast<const float*>(ll), static_cast<const float*>(lh),
      static_cast<const float*>(hl), static_cast<const float*>(hh),
      static_cast<float*>(out), static_cast<const float*>(taps), h, w, L, s, ops, wlo,
      width, pitch, rpitch, stages, edge, th, tw, g.chunks, g.wtiles);
  return cudaGetLastError();
}

}  // namespace vw

extern "C" int vw_modwt2_synthesis_level(const void* ll, const void* lh, const void* hl,
                                         const void* hh, void* out, const void* taps,
                                         long long batch, long long h, long long w,
                                         int taps_len, int spacing, int lo_sign,
                                         int lo_off, int hi_sign, int hi_off, int edge,
                                         int th, int tw, int stages, int pitch, int rpitch,
                                         int block, void* stream) {
  if (!vw::valid_config2(batch, h, w, taps_len, spacing, edge, th, tw) ||
      (lo_sign != 1 && lo_sign != -1) || (hi_sign != 1 && hi_sign != -1) ||
      (stages != 1 && stages != 2) || (block != 1 && block != 4) ||
      (block == 4 && tw % (4 * spacing) != 0) || tw % (8 * block) != 0 ||
      ((th + vw::kH - 1) / vw::kH) * tw > vw::kMaxItems * vw::kThreads || rpitch < tw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int a_lo, a_hi, d_lo, d_hi;
  vw::reach2(lo_sign, lo_off, spacing, taps_len, &a_lo, &a_hi);
  vw::reach2(hi_sign, hi_off, spacing, taps_len, &d_lo, &d_hi);
  const int wlo = a_lo < d_lo ? a_lo : d_lo;
  const int whi = a_hi > d_hi ? a_hi : d_hi;
  const int width = tw + whi - wlo;
  if (pitch < width) return static_cast<int>(cudaErrorInvalidValue);
  const vw::Ops2 ops{lo_sign, lo_off, hi_sign, hi_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      block == 4 ? vw::launch_synthesis2<4>(ll, lh, hl, hh, out, taps, batch, h, w, taps_len,
                                            spacing, ops, wlo, width, pitch, rpitch, stages,
                                            edge, th, tw, s)
                 : vw::launch_synthesis2<1>(ll, lh, hl, hh, out, taps, batch, h, w, taps_len,
                                            spacing, ops, wlo, width, pitch, rpitch, stages,
                                            edge, th, tw, s);
  return static_cast<int>(err);
}
