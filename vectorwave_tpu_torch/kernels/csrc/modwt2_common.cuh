// Shared pieces of the 2-D MODWT level kernels (sm_90a):
// modwt2_analysis.cu and modwt2_synthesis.cu.
//
//   * images are [batch, H, W] float32, contiguous; the kernels compute in
//     fp32 FMA;
//   * taps arrive as one small fp32 device tensor [lo[0..L), hi[0..L)],
//     already scaled by 1/sqrt(2);
//   * level j filters at spacing s = 2^(j-1) along both axes;
//   * a block owns `th` output rows of one residue class mod s (rows
//     res + s (k0 + k), k < th) and `tw` adjacent columns.  An à trous op at
//     spacing s reads only rows of one residue class, so the block loads
//     th + L - 1 rows whatever the level (polyphase along H), and a window of
//     tw + reach columns along W.  The grid is flattened: blockIdx.x =
//     ((image * s + res) * chunks + chunk) * wtiles + column tile, so blocks
//     that share rows are neighbours and share the column halo in L2;
//   * the edge is applied per axis where a window is loaded: periodic takes
//     the index mod n (so a span above n works), zero reads 0 outside [0, n),
//     symmetric takes it mod 2n and mirrors the upper half (the half-point
//     symmetric extension of ops/convolve.py); a window is copied with
//     cp.async, whole rows a warp (copy_window);
//   * the tile (th, tw), the window's row pitch and the W-pass block come
//     from the wrapper's planner (kernels/modwt2.py), per level;
//   * each C entry point returns cudaGetLastError() after its launch, or
//     cudaErrorInvalidValue for arguments it does not take.
#pragma once

#include "modwt_common.cuh"

namespace vw {

enum Edge : int { kEdgePeriodic = 0, kEdgeZero = 1, kEdgeSymmetric = 2 };

// Class rows a thread owns in either kernel's H pass.
constexpr int kH = 4;

// Index of sample g of the extended axis of length n, or -1 where the zero
// edge reads 0.
__device__ __forceinline__ long long edge_index(long long g, long long n, int edge) {
  if (edge == kEdgeZero) return (g >= 0 && g < n) ? g : -1;
  const long long p = edge == kEdgeSymmetric ? 2 * n : n;
  long long m = g % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// Grid of one level launch.
struct Grid2 {
  long long blocks;
  int chunks;
  int wtiles;
};

inline Grid2 grid2(long long batch, long long h, long long w, int s, int th, int tw) {
  const long long rows_per_class = (h + s - 1) / s;
  const long long chunks = (rows_per_class + th - 1) / th;
  const long long wtiles = (w + tw - 1) / tw;
  return Grid2{batch * s * chunks * wtiles, static_cast<int>(chunks),
               static_cast<int>(wtiles)};
}

inline bool valid_config2(long long batch, long long h, long long w, int taps, int s,
                          int edge, int th, int tw) {
  return batch >= 1 && h >= 1 && w >= 1 && taps >= 1 && taps <= kMaxTaps && s >= 1 &&
         s <= (1 << (kMaxLevels - 1)) && edge >= kEdgePeriodic &&
         edge <= kEdgeSymmetric && th >= 1 && tw >= 1 && th * tw <= 4096;
}

// Copies rows x width of plane `src` into dst (row pitch `pitch`): window
// row i is image row edge(row0 + s i), column q image column edge(col0 + q).
// A warp takes whole rows.  `vec`: the columns lie inside the image, col0,
// the pitch and W are multiples of 4 and the plane 16-byte aligned, so
// 16-byte copies serve the row (rounded up to 4 columns, which the image
// holds); else 4-byte copies.
__device__ __forceinline__ void copy_window(float* dst, const float* __restrict__ src,
                                            long long row0, int s, long long H, long long W,
                                            long long col0, int rows, int width, int pitch,
                                            bool inside, bool vec, int edge) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows; i += kThreads / 32) {
    float* d = dst + i * pitch;
    const long long gr = edge_index(row0 + static_cast<long long>(s) * i, H, edge);
    if (gr < 0) {
      for (int q = lane; q < width; q += 32) d[q] = 0.0f;
      continue;
    }
    const float* row = src + gr * W;
    if (vec) {
      const float* from = row + col0;
      for (int q = 4 * lane; q < width; q += 128) cp_async16(d + q, from + q);
    } else if (inside) {
      const float* from = row + col0;
      for (int q = lane; q < width; q += 32) cp_async4(d + q, from + q);
    } else {
      for (int q = lane; q < width; q += 32) {
        const long long g = col0 + q;
        const long long gc = (g >= 0 && g < W) ? g : edge_index(g, W, edge);
        if (gc < 0) {
          d[q] = 0.0f;
        } else {
          cp_async4(d + q, row + gc);
        }
      }
    }
  }
}

// The block's place in the grid: image, row residue, first row index k0 of
// the class, first column c0.
struct Block2 {
  long long image;
  int res;
  int k0;
  long long c0;
};

__device__ __forceinline__ Block2 block2(int s, int th, int tw, int chunks, int wtiles) {
  long long bid = blockIdx.x;
  Block2 blk;
  blk.c0 = static_cast<long long>(bid % wtiles) * tw;
  bid /= wtiles;
  blk.k0 = static_cast<int>(bid % chunks) * th;
  bid /= chunks;
  blk.res = static_cast<int>(bid % s);
  blk.image = bid / s;
  return blk;
}

}  // namespace vw
