// J-level MODWT analysis in one pass: x -> d_1..d_J, a_J.
//
// Replaces two TPU kernels of vectorwave_tpu/kernels/modwt_mxu.py:
// `_composite_analysis_call`, which computes every plane directly from x
// with a precomposed composite filter as banded 128x128 bf16 matmuls (the
// only fast path of the TPU's matrix unit), and `_mxu_analysis_call`, which
// runs the per-level cascade as banded 128x256 matmuls, with an optional
// per-level mirror.  Here the plane filters are not composed: the block runs
// the per-level a trous cascade in shared memory,
//     a_j[p] = sum_k lo[k] a_{j-1}[p - 2^{j-1} k],
//     d_j[p] = sum_k hi[k] a_{j-1}[p - 2^{j-1} k],
// which equals the composite form exactly for periodic and zero edges (both
// are causal) and costs 2 L J FMAs per sample (96 for db4 at J = 6) instead
// of the composite's 1288.
//
// What bounds it on the H100: each FMA reads one shared-memory word, so the
// cascade is bound by shared-memory bandwidth and fp32 throughput (the cascade
// reaches back over a halo of S = (L-1)(2^J-1) samples, recomputing a
// window of tile + S samples per block), not by device memory: the kernel
// reads 4 B and writes 4 (J+1) B per sample.  The design keeps the whole
// cascade in shared memory (two ping-pong rows of tile + S floats), reads
// the tap pair once per shared load (lo and hi share it), and writes the
// detail planes straight from registers with coalesced stores.  Every
// precision tier (float32, bf16_3x, bf16) runs this same fp32 kernel, which
// meets each tier's error contract; tensor-core tiers are later work.  In
// bfloat16 the approximations stay fp32 between levels (the TPU cascade
// rounds each to bf16).
//
// Edges (`edge`, CascadeEdge): zero, periodic, mirror or external.  The mirror is the
// symmetric analysis: before level j, the level's input at g in
// [-(L-1) 2^(j-1), 0) is its own value at -1 - g (a half-point reflection at
// the signal start; level 1 reflects x as the window loads).  That is exact
// for n >= (L-1) 2^(J-1), where the reflection's source lies in the signal;
// shorter signals need the period-2n extension and take the plain path.  A
// block whose window starts before 0 (t0 < S, block 0 and, with a small
// tile, a few after it) reflects its own window, which needs the sources
// [0, (L-1) 2^(J-1)) in it: the tile is at least that long.  Those blocks'
// outputs at p >= 0 stay exact at every level, as the cascade's validity
// bookkeeping below assumes for zero and periodic edges; values it computes
// before 0 are overwritten by the next reflection or never read.
//
// External edge (`edge="external"` of `_composite_analysis_call`, the
// streaming tier's carry and the tiled tier's neighbour exchange): `halo`
// holds each row's left neighbour, [batch, halo_len] in the input type, and
// the window reads halo[halo_len + g] for g < 0 (0 before the halo) and 0
// past n (load_halo).  The extended row is then a zero-edge row with the
// halo in front, so the zero edge's validity bookkeeping holds unchanged: a
// block whose window starts before 0 (t0 < S; with a span longer than the
// tile, several blocks of a row) reads the halo as it loads its window, and
// a halo shorter than S reads zeros before it, as the plain version, the
// zero-edge cascade of [halo | x] sliced back to n, does.
//
// Head splice (`head_samples` of `_composite_analysis_call`): with a `head`
// of [J+1, batch, head_samples] fp32 values, every plane's outputs at
// positions < head_samples are stored from it instead of from the cascade.
// The streaming tier's symmetric first block calls it together with the
// external edge: the head of the plain symmetric cascade of the block's
// first S samples replaces the outputs the mirror reaches.  It is a
// template flag (kSplice): a launch without a head runs a kernel whose
// stores do not test for one.
#include "modwt_common.cuh"

namespace vw {

// kSplice: the head splice; without it no store looks at `head`.
template <typename T, bool kSplice>
__global__ void __launch_bounds__(kThreads)
modwt_analysis_kernel(const T* __restrict__ x, PlanePtrs out,
                      const float* __restrict__ taps,
                      const float* __restrict__ head, int head_samples,
                      const T* __restrict__ halo, int halo_len,
                      long long n, int levels, int L, int tile,
                      int tiles_per_row, int edge) {
  extern __shared__ float smem[];
  const int span = cascade_span(L, levels);
  const int width = tile + span;
  float* s_lo = smem;
  float* s_hi = smem + L;
  float* cur = smem + 2 * L;
  float* nxt = cur + width;

  const long long b = blockIdx.x / tiles_per_row;
  const long long t0 = static_cast<long long>(blockIdx.x % tiles_per_row) * tile;
  const long long row_off = b * n;
  const T* row = x + row_off;
  const int n_out = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  // head values of this row, plane p at head_row + p * head_plane
  const long long head_plane = static_cast<long long>(gridDim.x / tiles_per_row) *
                               head_samples;
  const float* head_row = head == nullptr ? nullptr : head + b * head_samples;
  const T* halo_row = halo == nullptr ? nullptr : halo + b * halo_len;
  const int head_end =
      kSplice ? static_cast<int>(min(static_cast<long long>(n_out),
                                     max(static_cast<long long>(head_samples) - t0, 0LL)))
              : 0;

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_lo[k] = taps[k];
    s_hi[k] = taps[L + k];
  }
  // window [t0 - span, t0 + tile) of the extended signal; its first `before`
  // samples lie before the signal start
  const long long g0 = t0 - span;
  const int before = static_cast<int>(max(-g0, 0LL));
  for (int q = threadIdx.x; q < width; q += blockDim.x) {
    cur[q] = load_edge(row, halo_row, halo_len, g0 + q, n, edge);
  }
  __syncthreads();

  int valid = 0;  // first window index where the current level is exact
  for (int j = 1; j <= levels; ++j) {
    const int s = 1 << (j - 1);
    if (edge == kCascadeMirror && j > 1 && before > 0) {
      // window index q holds g = q - before; g in [-reach, 0) takes the
      // value at -1 - g, window index 2 before - 1 - q
      for (int q = max(before - level_reach(L, j), 0) + threadIdx.x; q < before;
           q += blockDim.x) {
        cur[q] = cur[2 * before - 1 - q];
      }
      __syncthreads();
    }
    const int first = valid + (L - 1) * s;
    T* dj = static_cast<T*>(out.p[j - 1]) + row_off + t0;
    for (int q = first + threadIdx.x; q < width; q += blockDim.x) {
      float a = 0.0f;
      float d = 0.0f;
      for (int k = 0; k < L; ++k) {
        const float v = cur[q - k * s];
        a = fmaf(s_lo[k], v, a);
        d = fmaf(s_hi[k], v, d);
      }
      nxt[q] = a;
      const int o = q - span;
      if (o >= 0 && o < n_out) {
        dj[o] = from_f32<T>(kSplice && o < head_end
                                ? head_row[(j - 1) * head_plane + t0 + o] : d);
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    valid = first;
  }
  T* aj = static_cast<T*>(out.p[levels]) + row_off + t0;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    aj[o] = from_f32<T>(kSplice && o < head_end ? head_row[levels * head_plane + t0 + o]
                                                : cur[span + o]);
  }
}

inline size_t analysis_shared_bytes(int L, int levels, int tile) {
  return sizeof(float) * (2 * static_cast<size_t>(L) +
                          2 * static_cast<size_t>(tile + cascade_span(L, levels)));
}

template <typename T, bool kSplice>
cudaError_t launch_analysis_kernel(const void* x, void* const* outs, const float* taps,
                                   const float* head, int head_samples,
                                   const void* halo, int halo_len, long long batch,
                                   long long n, int levels, int L, int tile, int edge,
                                   cudaStream_t stream) {
  PlanePtrs planes{};
  for (int i = 0; i <= levels; ++i) planes.p[i] = outs[i];
  const long long tiles = (n + tile - 1) / tile;
  const long long blocks = batch * tiles;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = analysis_shared_bytes(L, levels, tile);
  cudaError_t err = reserve_shared(modwt_analysis_kernel<T, kSplice>, bytes);
  if (err != cudaSuccess) return err;
  modwt_analysis_kernel<T, kSplice><<<static_cast<unsigned>(blocks), kThreads, bytes,
                                      stream>>>(
      static_cast<const T*>(x), planes, taps, head, head_samples,
      static_cast<const T*>(halo), halo_len, n, levels, L, tile,
      static_cast<int>(tiles), edge);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_analysis(const void* x, void* const* outs, const float* taps,
                            const float* head, int head_samples, const void* halo,
                            int halo_len, long long batch, long long n, int levels,
                            int L, int tile, int edge, cudaStream_t stream) {
  return head == nullptr
             ? launch_analysis_kernel<T, false>(x, outs, taps, head, head_samples, halo,
                                                halo_len, batch, n, levels, L, tile,
                                                edge, stream)
             : launch_analysis_kernel<T, true>(x, outs, taps, head, head_samples, halo,
                                               halo_len, batch, n, levels, L, tile, edge,
                                               stream);
}

}  // namespace vw

// head: null (no splice) or [levels + 1, batch, head_samples] fp32 values.
// halo: [batch, halo_len] values of x's type, given with the external edge
// only.  edge: vw::CascadeEdge; the mirror takes n and tile >=
// (L - 1) 2^(levels-1).
extern "C" int vw_modwt_analysis(const void* x, void* const* outs,
                                 const void* taps, const void* head,
                                 int head_samples, const void* halo, int halo_len,
                                 long long batch, long long n, int levels,
                                 int taps_len, int tile, int edge, int dtype,
                                 void* stream) {
  if (!vw::valid_config(batch, n, levels, taps_len, tile) || head_samples < 0 ||
      (head == nullptr) != (head_samples == 0) || edge < vw::kCascadeZero ||
      edge > vw::kCascadeExternal ||
      (edge == vw::kCascadeExternal) != (halo != nullptr) ||
      (halo == nullptr) != (halo_len == 0) || halo_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (edge == vw::kCascadeMirror) {
    const int reach = vw::level_reach(taps_len, levels);
    if (tile < reach || n < reach) return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* t = static_cast<const float*>(taps);
  const float* h = static_cast<const float*>(head);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == vw::kFloat32) {
    err = vw::launch_analysis<float>(x, outs, t, h, head_samples, halo, halo_len,
                                     batch, n, levels, taps_len, tile, edge, s);
  } else if (dtype == vw::kBFloat16) {
    err = vw::launch_analysis<__nv_bfloat16>(x, outs, t, h, head_samples, halo,
                                             halo_len, batch, n, levels, taps_len,
                                             tile, edge, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
