// Ragged multi-LoRA backward for Hopper (sm_90a): the four kernels of the
// ragged custom VJP (src/repro/kernels/ops.py, _make_ragged_pallas_fn).
//
// Replaces, in src/repro/kernels/ragged.py:
//   ragged_lora_dgrad / _dgrad_kernel  dx   = Σ_rt mask(dy_s·B[rt]^T)·A[:,rt]^T
//   ragged_xa / _xa_kernel             xa   = mask(x·A[:,seg(t)])   packed (T,R)
//   ragged_dxa / _dxa_kernel           dxa  = mask(dy_s·B[seg(t)]^T) packed (T,R)
//   ragged_wgrad / _wgrad_kernel       out[seg_k] = Σ_{t in k} u[t,seg_k]^T·v_t
//
// Shapes and types: dy_s (T, d_out) bf16, x (T, d_in) bf16, A (d_in, R)
// and B (R, d_out) bf16 packed ragged; dx (T, d_in) f32; xa and dxa (T, R)
// bf16; wgrad u (T, R) bf16, v (T, d) bf16 -> (R, d) f32.
//
// dgrad, xa and dxa read the per-token-tile table of the forward kernel
// ((first packed column, padded width, true rank) of the tile's adapter,
// RaggedMeta.tile_table) and run the LoRA routine of lora_fwd.cuh, the
// forward's (B1): the dgrad in its Backward orientation (dy_s for x, B's
// segment rows as W1 = B_seg^T, A's segment columns as W2 = A_seg^T, both
// read in place); dxa is its phase 1 alone in that orientation, xa phase
// 1 alone in the Forward one.  Every entry of xa and dxa outside the
// token's own segment is written as zero (Pallas leaves those blocks
// unwritten; the reference never reads them).
//
// wgrad runs the two-pass routine of lora_tile.cuh, the grouped wgrad's
// (grouped.cu): the adapter of each token tile and each adapter's packed
// segment (first column, padded width) come from small device tables
// (RaggedMeta); each CTA takes one chunk of token tiles at a fixed
// position, up to 64 lanes of one adapter's segment and 64 columns of v,
// and a second pass adds each adapter's chunk partials in tile order --
// the loop that the TPU grid ran as revisits of one output block
// (ragged.py:19-25), without atomics and in one order with B8, so the
// two families' gradients agree bit for bit.  Rows of adapters that own
// no tiles are written as zeros.
//
// Bound on the H100: bytes, as for the forward (ragged_lora.cu): each
// token's work is (true rank) x (d_in + d_out) multiply-adds against the
// 2 (d_in + d_out) bytes of its activation rows, far under the 295
// flop/byte ridge at LoRA ranks (dgrad at the training step, T 8192,
// 2048 -> 2048: 0.030 ms; xa, dxa 0.011 ms).  What the design does about
// it: dy_s or x is read from device memory once, in TMA boxes, by CTAs of
// 64, 32 or 16 rows, and the output leaves as boxes (the routine's
// notes); the wgrad reads v once for up to 64 lanes of a segment.
#include "lora_fwd.cuh"
#include "lora_tile.cuh"

// dx (T, d_in) f32 = Σ mask(dy_s · B_seg^T) · A_seg^T.  max_width: the
// widest segment; rows: token rows a CTA (64, 32 or 16, dividing
// block_t); col_splits: CTAs sharing one row block's d_in columns.  The
// wrapper picks both (fused_lora.lora_fwd_geometry over d_in) and checks
// the operands.
extern "C" int ragged_dgrad_launch(const void* dy, const void* a,
                                   const void* b, const void* tiles,
                                   void* dx, int T, int d_in, int d_out,
                                   int R, int max_width, int block_t,
                                   int rows, int col_splits, void* stream) {
  using namespace repro;
  lora_fwd::Operands o{};
  o.x = static_cast<const __nv_bfloat16*>(dy);
  o.w1 = lora_fwd::packed_b(b, R, d_out);
  o.w2 = lora_fwd::packed_a(a, d_in, R);
  o.out = dx;
  o.T = T;
  o.d_k = d_out;
  o.d_n = d_in;
  return lora_fwd::launch<float, lora_fwd::Backward>(
      o, lora_fwd::RaggedSeg{static_cast<const int*>(tiles)},
      (max_width + 15) / 16 * 16, block_t, rows, col_splits,
      static_cast<cudaStream_t>(stream));
}

// The packed (T, R) bf16 phase 1: transposed = 0, xa = x · A_seg (x (T,
// d), w = A (d, R)); transposed = 1, dxa = dy_s · B_seg^T (dy_s (T, d), w
// = B (R, d)).  rows: token rows a CTA (fused_lora.lora_packed_rows).
extern "C" int ragged_packed_launch(const void* x, const void* w,
                                    const void* tiles, void* out, int T,
                                    int d, int R, int max_width, int block_t,
                                    int rows, int transposed, void* stream) {
  using namespace repro;
  lora_fwd::Operands o{};
  o.x = static_cast<const __nv_bfloat16*>(x);
  o.w1 = transposed ? lora_fwd::packed_b(w, R, d)
                    : lora_fwd::packed_a(w, d, R);
  o.out = out;
  o.T = T;
  o.d_k = d;
  o.d_n = R;
  const lora_fwd::RaggedSeg seg{static_cast<const int*>(tiles)};
  const int wr = (max_width + 15) / 16 * 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return transposed
             ? lora_fwd::launch_packed<lora_fwd::Backward>(o, seg, wr,
                                                           block_t, rows, st)
             : lora_fwd::launch_packed<lora_fwd::Forward>(o, seg, wr,
                                                          block_t, rows, st);
}

// The ragged wgrad through the shared two-pass routine of lora_tile.cuh:
// u (T, R) packed, v (T, d) -> (R, d).  tile_jobs: adapter of each token
// tile; seg: per adapter (first packed column, padded width), in column
// order.  W: n_tiles slots of max_width * d floats.
extern "C" int ragged_wgrad_launch(const void* u, const void* v,
                                   const void* tile_jobs, const void* seg,
                                   void* out, void* work, int T, int R,
                                   int d, int n_seg, int max_width,
                                   int block_t, int chunk_tiles,
                                   void* stream) {
  return repro::lora::wgrad_launch(
      static_cast<const __nv_bfloat16*>(u), R,
      static_cast<const __nv_bfloat16*>(v), d, d,
      static_cast<const int*>(tile_jobs), T / block_t, block_t, chunk_tiles,
      static_cast<const int*>(seg), n_seg, 0, max_width,
      static_cast<float*>(work), static_cast<long>(max_width) * d, d, 1,
      static_cast<float*>(out), static_cast<long>(R) * d,
      static_cast<cudaStream_t>(stream));
}
