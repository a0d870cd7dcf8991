// Shared pieces of the general filter-bank kernels (sm_90a),
// modwt_bank_analysis.cu and modwt_bank_synthesis.cu.
//
// A bank is P planes, each with its own tap vector.  The taps arrive sparse,
// so an à trous filter costs its L non-zeros and not its (L-1) s + 1 dense
// taps.  A whole packet tree is thousands of taps (more than constant memory
// holds), so they live in device memory:
//   * data are [batch, n] rows, float32 or bfloat16; the kernels compute in
//     fp32 FMA and store in the input type;
//   * one block serves one (signal, tile of kBankTile outputs) and keeps its
//     window of the signal in shared memory; the sums stay in registers;
//   * the host cuts each plane's taps into runs (first offset o, count c) on
//     one stride d per plane, a power of two dividing kThreads (1 for a
//     packet tree, 2^(j-1) for an à trous pair), values padded so that each
//     run starts on 16 bytes (modwt_bank.bank_runs);
//   * a thread owns kRunBlock = 9 outputs u, u + d, ..., u + 8d of one
//     residue class mod d (run_base, modwt_common.cuh): a run of 8 taps
//     needs 8 new samples, kept in registers and carried to the next 8 (two
//     arrays that swap roles), and 2 broadcast 16-byte loads of taps, for
//     72 FMAs;
//   * the plane pointers travel by value in the kernel's parameter block
//     (kMaxBankPlanes of them, 512 bytes).
#pragma once

#include "modwt_common.cuh"

namespace vw {

constexpr int kMaxBankPlanes = 64;
constexpr int kBankTile = kThreads * kRunBlock;

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

}  // namespace vw
