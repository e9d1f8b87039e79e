// Masked max-rank multi-LoRA forward (B6) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_lora.py:62, fused_lora_pallas /
// _fused_lora_kernel, the Pallas TPU kernel over stacked adapters with
// one adapter per token tile, which kept xa in a scratch buffer revisited
// across its d_out grid steps.
//
//   xa = bf16(mask_{lane < rank[k]}(x_tile · A[k])),  y_tile = xa · B[k]
//
// x (T, d_in) bf16, A (K, d_in, r_pad) bf16, B (K, r_pad, d_out) bf16,
// tile_map (T / block_t,) int32 adapter per token tile, ranks (K,) int32
// -> y (T, d_out) bf16, unscaled, rounded once.  A and B are read through
// strides (last dim contiguous), so the packed (d, K*r_pad) pair's
// stacked view needs no copy; tile_map and ranks are read on the device.
//
// Bound on the H100: bytes.  x is read and y written once; A[k] and B[k]
// are re-read from L2 by every row block of their adapter.  At the
// training step (T 8192, d 2048) the bound is 0.020 ms.
//
// Design: the CTA routine of lora_fwd.cuh, shared with the ragged forward
// (B1).  A CTA of 64, 32 or 16 rows of one adapter computes its masked xa
// once, for every lane, from x and A boxes that the TMA brings through a
// ring, keeps it in shared memory, then streams B[k] in 128-column boxes
// through a second ring and stores y as boxes.  The packed pair's stacked
// view (lanes of the K adapters interleaved in A's rows) is one 2-D map
// with A[k] from column k * r_pad; contiguous stacks are a 3-D map.
//
// Summation order: the routine's (x·A by k-step class, the classes added
// in order, the mask, one rounding; xa·B one accumulator per tile over
// ascending 16-lane chunks), so B6 equals B1 on one uniform layout and
// the B7 pair (narrow x·A[k], the mask, wide xa·B[k]) bit for bit.
#include "lora_fwd.cuh"

namespace {

using namespace repro;

// The tile's adapter k: A[k]'s lanes at column k * a_col_step of an
// interleaved A (the packed pair's stacked view: one 2-D map), or matrix
// k of contiguous stacks (a 3-D map).
struct MaskedSeg {
  const int* tile_map;
  const int* ranks;
  int r_pad, a_col_step, a_stacked;

  __device__ lora_fwd::Seg at(int tile) const {
    const int k = tile_map[tile];
    return {k * a_col_step, a_stacked ? k : 0, 0, k, r_pad, ranks[k]};
  }
};

}  // namespace

// K stacked adapters; rows: token rows a CTA (64, 32 or 16, dividing
// block_t); col_splits: CTAs that share one row block's output columns.
// The wrapper picks both (fused_lora.lora_fwd_geometry) and checks the
// operands.
extern "C" int fused_lora_fwd_launch(const void* x, const void* a,
                                     const void* b, const void* tile_map,
                                     const void* ranks, void* out, int T,
                                     int d_in, int d_out, int r_pad, int K,
                                     long a_k, long a_row, long b_k,
                                     long b_row, int block_t, int rows,
                                     int col_splits, void* stream) {
  // lanes of the K matrices interleaved in A's rows (the packed pair's
  // stacked view): one matrix of a_row columns, A[k] from column k a_k
  const bool stacked = a_k >= a_row;
  repro::lora_fwd::Operands o{};
  o.x = static_cast<const __nv_bfloat16*>(x);
  o.w1 = {static_cast<const __nv_bfloat16*>(a), stacked ? r_pad : a_row, d_in,
          a_row, stacked ? a_k : a_row * d_in, stacked ? K : 1};
  o.w2 = {static_cast<const __nv_bfloat16*>(b), d_out, r_pad, b_row, b_k, K};
  o.out = out;
  o.T = T;
  o.d_k = d_in;
  o.d_n = d_out;
  const MaskedSeg seg{static_cast<const int*>(tile_map),
                      static_cast<const int*>(ranks), r_pad,
                      stacked ? 0 : static_cast<int>(a_k), stacked ? 1 : 0};
  return repro::lora_fwd::launch<__nv_bfloat16, repro::lora_fwd::Forward>(
      o, seg, (r_pad + 15) / 16 * 16, block_t, rows, col_splits,
      static_cast<cudaStream_t>(stream));
}
