// Ragged multi-LoRA forward (B1) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ragged.py:152, ragged_lora_fwd /
// _fwd_kernel, the Pallas TPU kernel whose flat grid visits only the
// ACTIVE (token tile, rank tile) pairs of the packed ragged layout.
//
//   y[t] = Σ_{rank tiles of adapter(t)} mask(x_t · A[:, rt]) · B[rt, :]
//
// x (T, d_in) bf16, A (d_in, R) bf16, B (R, d_out) bf16 -> y (T, d_out)
// f32, unscaled.  ``tiles`` (n_tiles, 3) int32 gives each token tile its
// adapter's (first packed column, padded width, true rank): the TPU
// kernel's scalar-prefetched (tile, rtile, first, lanes) vectors folded
// per tile, read by each CTA itself from a device array the wrapper
// caches per RaggedMeta.  A CTA works on its adapter's own segment only,
// so no padding to the group's widest rank ever runs.
//
// Bound on the H100: bytes.  Each token row costs 2 (true rank) (d_in +
// d_out) flops against 2 d_in bytes of x and 4 d_out bytes of f32 y: far
// under the 295 flop/byte ridge at LoRA ranks (0.030 ms at the training
// step, T 8192, d 2048); at decode (T = the requests) the time is latency.
//
// Design: the CTA routine of lora_fwd.cuh, shared with the masked forward
// (B6): 64, 32 or 16 rows of one adapter a CTA, its masked xa computed
// once for the whole segment from x and A boxes that the TMA brings
// through a ring (A's box at the segment's first packed column), kept in
// shared memory, then B's segment streamed in 128-column boxes through a
// second ring whose first blocks load during x·A, y stored as f32 boxes;
// output columns split over CTAs only where the row CTAs leave the card
// under-filled.
//
// Summation order: the routine's (lora_fwd.cuh), in its Forward
// orientation, so y equals the dgrad (B2, the Backward orientation) fed
// x, B^T and A^T bit for bit, and bf16(y) equals B6 on one uniform
// layout.
#include "lora_fwd.cuh"

// max_width: the widest segment of the layout; rows: token rows a CTA
// (64, 32 or 16, dividing block_t); col_splits: CTAs that share one row
// block's output columns.  The wrapper picks (fused_lora.
// lora_fwd_geometry) and checks.
extern "C" int ragged_lora_fwd_launch(const void* x, const void* a,
                                      const void* b, const void* tiles,
                                      void* out, int T, int d_in, int d_out,
                                      int R, int max_width, int block_t,
                                      int rows, int col_splits,
                                      void* stream) {
  using namespace repro;
  lora_fwd::Operands o{};
  o.x = static_cast<const __nv_bfloat16*>(x);
  o.w1 = lora_fwd::packed_a(a, d_in, R);
  o.w2 = lora_fwd::packed_b(b, R, d_out);
  o.out = out;
  o.T = T;
  o.d_k = d_in;
  o.d_n = d_out;
  return lora_fwd::launch<float, lora_fwd::Forward>(
      o, lora_fwd::RaggedSeg{static_cast<const int*>(tiles)},
      (max_width + 15) / 16 * 16, block_t, rows, col_splits,
      static_cast<cudaStream_t>(stream));
}
