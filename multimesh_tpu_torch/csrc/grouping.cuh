// Block-level element slots for the kernels that run on rows grouped by
// element (newton_rows.cu, polish_pairs.cu, apply_pairs.cu).
//
// A block takes kBlockRows consecutive entries of the grouping permutation
// (mmt_group_rows), so its rows share a few elements.  assign_slots finds
// the runs of equal elements among them with a ballot per warp and gives
// run r shared-memory slot r; the caller stages each slotted element's data
// once, and a row whose run has no slot (more than SLOTS runs in the block:
// sparse chunks, rows in no particular order) reads global memory instead.
#pragma once

#include <cuda_runtime.h>

namespace mmt_grouping {

constexpr int kBlockRows = 128;  // rows (threads) of a block
constexpr int kWarps = kBlockRows / 32;

// Slots of `bytes` each that fit in `budget` bytes, at most one per row.
__host__ __device__ constexpr int slots_for(int budget, int bytes) {
  return budget / bytes < kBlockRows ? budget / bytes : kBlockRows;
}

template <int SLOTS> struct SlotTable {
  int row_elem[kBlockRows];
  int elem[SLOTS];  // element of slot s < staged
  int warp_runs[kWarps];
};

// Called by every thread of the block with its row's element e and whether
// the row takes part (in range and a valid id).  Returns the row's slot
// (>= SLOTS: none; meaningless for a row that does not take part) and sets
// `staged` to the number of filled slots; tab.elem is ready on return.
template <int SLOTS>
__device__ __forceinline__ int assign_slots(SlotTable<SLOTS>& tab, int e,
                                            bool ok, int& staged) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  tab.row_elem[t] = ok ? e : -1;
  __syncthreads();
  const bool start = ok && (t == 0 || tab.row_elem[t - 1] != e);
  const unsigned starts = __ballot_sync(0xffffffffu, start);
  if (lane == 0) tab.warp_runs[warp] = __popc(starts);
  __syncthreads();
  int runs = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? tab.warp_runs[w] : 0;
    runs += tab.warp_runs[w];
  }
  // (2u << lane) - 1: the lanes up to and including this one
  const int slot = before + __popc(starts & ((2u << lane) - 1u)) - 1;
  if (start && slot < SLOTS) tab.elem[slot] = e;
  __syncthreads();
  staged = runs < SLOTS ? runs : SLOTS;
  return slot;
}

}  // namespace mmt_grouping
