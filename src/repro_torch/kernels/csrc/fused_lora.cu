// Masked max-rank multi-LoRA forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_lora.py, fused_lora_pallas /
// _fused_lora_kernel, the Pallas TPU kernel over stacked adapters with
// one adapter per token tile.
//
//   xa = mask_{lane < rank[k]}(x_tile · A[k]),  y_tile = xa · B[k]
//
// x (T, d_in) bf16, A (K, d_in, r_pad) bf16, B (K, r_pad, d_out) bf16,
// tile_map (T / block_t,) int32 adapter per token tile, ranks (K,) int32
// -> y (T, d_out) bf16, unscaled.  A and B are read through strides
// (last dim contiguous), so the packed (d, K*r_pad) pair's stacked view
// needs no copy.
//
// Bound on the H100: bytes, for the reasons given in ragged_lora.cu; on
// a uniform-width set the masked walk does no padding work beyond the
// rank mask.  Design: the same CTA routine as the ragged kernel
// (lora_tile.cuh).  The TPU kernel kept xa in a scratch buffer revisited
// across d_out grid steps; here one CTA owns its rows' xa in shared
// memory and loops over its output columns itself.  tile_map and ranks
// are read on the device, so a launch needs no host copy.
#include "lora_tile.cuh"

namespace {

using namespace repro;

__global__ void __launch_bounds__(lora::kThreads)
fused_lora_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ b,
                      const int* __restrict__ tile_map,
                      const int* __restrict__ ranks,
                      __nv_bfloat16* __restrict__ out, int T, int d_in,
                      int d_out, int r_pad, long a_k, long a_row, long b_k,
                      long b_row, int block_t, int cols_per_cta) {
  __shared__ lora::Smem s;
  const int row0 = blockIdx.x * lora::kRows;
  const int k = tile_map[row0 / block_t];   // block_t % 16 == 0
  const int col_begin = blockIdx.y * cols_per_cta;
  lora::lora_rows<__nv_bfloat16>(
      x + static_cast<long>(row0) * d_in, d_in, a + k * a_k, a_row,
      b + k * b_k, b_row, r_pad, ranks[k], d_in, d_out,
      min(lora::kRows, T - row0), col_begin,
      lora::col_end_of(col_begin, cols_per_cta, d_out),
      out + static_cast<long>(row0) * d_out, d_out, s);
}

}  // namespace

extern "C" int fused_lora_fwd_launch(const void* x, const void* a,
                                     const void* b, const void* tile_map,
                                     const void* ranks, void* out, int T,
                                     int d_in, int d_out, int r_pad,
                                     long a_k, long a_row, long b_k,
                                     long b_row, int block_t, int col_groups,
                                     void* stream) {
  const int per = repro::lora::cols_per_cta(d_out, col_groups);
  dim3 grid((T + repro::lora::kRows - 1) / repro::lora::kRows,
            (d_out + per - 1) / per);
  fused_lora_fwd_kernel<<<grid, repro::lora::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const int*>(tile_map), static_cast<const int*>(ranks),
      static_cast<__nv_bfloat16*>(out), T, d_in, d_out, r_pad, a_k, a_row,
      b_k, b_row, block_t, per);
  return static_cast<int>(cudaGetLastError());
}
