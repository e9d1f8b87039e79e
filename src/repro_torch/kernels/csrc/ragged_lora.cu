// Ragged multi-LoRA forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ragged.py, ragged_lora_fwd / _fwd_kernel,
// the Pallas TPU kernel whose flat grid visits only the ACTIVE (token
// tile, rank tile) pairs of the packed ragged layout.
//
//   y[t] = Σ_{rank tiles of adapter(t)} mask(x_t · A[:, rt]) · B[rt, :]
//
// x (T, d_in) bf16, A (d_in, R) bf16, B (R, d_out) bf16 -> y (T, d_out)
// f32, unscaled.  ``tiles`` (n_tiles, 3) int32 gives each token tile its
// adapter's (first packed column, padded width, true rank): the TPU
// kernel's scalar-prefetched (tile, rtile, first, lanes) vectors folded
// per tile, read by each CTA itself from a device array the wrapper
// caches per RaggedMeta.
//
// Bound on the H100: bytes.  At decode T is the number of requests, so
// the work is T·R·(d_in + d_out) multiply-adds against reading A and B
// once: far under the 295 flop/byte ridge.  At prefill it stays memory
// bound until T·(true rank)/(d_in+d_out) nears the ridge.  Design: one
// CTA per 16 token rows x a range of output columns; the CTA computes
// its rows' xa once (only the adapter's own rank lanes, so padding waste
// to the group max never runs) and reuses it across its columns from
// shared memory.  Rows of one adapter share a launch with every other
// adapter's rows.  Known cost: CTAs that share rows but not columns each
// recompute xa (col_groups in build.py keeps that small); a later
// version computes xa once per row group and streams B with TMA.
#include "lora_tile.cuh"

namespace {

using namespace repro;

__global__ void __launch_bounds__(lora::kThreads)
ragged_lora_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ b,
                       const int* __restrict__ tiles,
                       float* __restrict__ out, int T, int d_in, int d_out,
                       int R, int block_t, int cols_per_cta) {
  __shared__ lora::Smem s;
  const int row0 = blockIdx.x * lora::kRows;
  const int tile = row0 / block_t;     // block_t % 16 == 0: one adapter
  const int col0 = tiles[3 * tile];
  const int width = tiles[3 * tile + 1];
  const int rank = tiles[3 * tile + 2];
  const int col_begin = blockIdx.y * cols_per_cta;
  lora::lora_rows<float>(
      x + static_cast<long>(row0) * d_in, d_in, a + col0, R,
      b + static_cast<long>(col0) * d_out, d_out, width, rank, d_in, d_out,
      min(lora::kRows, T - row0), col_begin,
      lora::col_end_of(col_begin, cols_per_cta, d_out),
      out + static_cast<long>(row0) * d_out, d_out, s);
}

}  // namespace

extern "C" int ragged_lora_fwd_launch(const void* x, const void* a,
                                      const void* b, const void* tiles,
                                      void* out, int T, int d_in, int d_out,
                                      int R, int block_t, int col_groups,
                                      void* stream) {
  const int per = repro::lora::cols_per_cta(d_out, col_groups);
  dim3 grid((T + repro::lora::kRows - 1) / repro::lora::kRows,
            (d_out + per - 1) / per);
  ragged_lora_fwd_kernel<<<grid, repro::lora::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const int*>(tiles),
      static_cast<float*>(out), T, d_in, d_out, R, block_t, per);
  return static_cast<int>(cudaGetLastError());
}
