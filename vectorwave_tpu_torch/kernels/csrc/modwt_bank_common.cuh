// Shared pieces of the general filter-bank kernels (sm_90a),
// modwt_bank_analysis.cu and modwt_bank_synthesis.cu.
//
// A bank is P planes, each with its own tap vector.  The taps arrive sparse,
// so an à trous filter costs its L non-zeros and not its (L-1) s + 1 dense
// taps.  A whole packet tree is thousands of taps (more than constant memory
// holds), so they live in device memory:
//   * data are [batch, n] rows, float32 or bfloat16; the kernels compute in
//     fp32 FMA and store in the input type;
//   * one block serves one (signal, tile of outputs) and keeps its window of
//     the signal in shared memory; the sums stay in registers;
//   * the synthesis takes plane p's non-zero taps offs[starts[p] ..
//     starts[p+1]) with the fp32 values beside them, stages kTapChunk of
//     them at a time in shared memory, and a thread owns the outputs
//     threadIdx.x + r kThreads, r < tile / kThreads;
//   * the analysis takes the taps as runs on one stride per plane (see
//     modwt_bank_analysis.cu);
//   * the plane pointers travel by value in the kernel's parameter block
//     (kMaxBankPlanes of them, 512 bytes).
#pragma once

#include "modwt_common.cuh"

namespace vw {

constexpr int kMaxBankPlanes = 64;
constexpr int kPerThread = 8;
constexpr int kTapChunk = 1024;

// Edges of the bank: zero or periodic.  An external halo slab (the left or
// right neighbour's samples) would be a third value.
enum BankEdge : int { kBankZero = 0, kBankPeriodic = 1 };

struct BankPtrs {
  void* p[kMaxBankPlanes];
};

// Sample g of the extended row: inside [0, n) the row itself; outside it 0,
// or for the periodic edge the wrap modulo n (so n may be shorter than the
// span).  The modulo is taken only outside the row.
template <typename T>
__device__ __forceinline__ float bank_load(const T* __restrict__ row, long long g,
                                           long long n, int edge) {
  if (g >= 0 && g < n) return to_f32(row[g]);
  if (edge != kBankPeriodic) return 0.0f;
  long long m = g % n;
  if (m < 0) m += n;
  return to_f32(row[m]);
}

inline size_t bank_shared_bytes(int span, int tile) {
  return sizeof(float) * (static_cast<size_t>(tile) + static_cast<size_t>(span)) +
         (sizeof(float) + sizeof(int)) * static_cast<size_t>(kTapChunk);
}

inline bool valid_bank_config(long long batch, long long n, int planes, int span,
                              int tile, int edge) {
  return batch >= 1 && n >= 1 && planes >= 1 && planes <= kMaxBankPlanes &&
         span >= 0 && tile >= kThreads && tile <= kThreads * kPerThread &&
         tile % kThreads == 0 && (edge == kBankZero || edge == kBankPeriodic);
}

}  // namespace vw
