// The masked LoRA family's backward for Hopper (sm_90a): the grouped
// product and the grouped weight gradient of the masked custom VJP
// (src/repro/kernels/ops.py, _make_pallas_fn).
//
// Replaces, in src/repro/kernels/fused_lora.py:
//   grouped_matmul_pallas / _grouped_mm_kernel
//       y_t = x_t · W[tile_map[t / block_t]]
//   grouped_wgrad_pallas / _grouped_wgrad_kernel
//       out[k] = Σ_{t: tile_map[t / block_t] = k} x_t^T · g_t
//
// Shapes and types: x (T, d_in) bf16 contiguous; W (K, d_in, d_out) bf16
// read through strides, either as stored (the last dim contiguous: A[k])
// or transposed in place (the middle dim contiguous: the B[k]^T and
// A[k]^T views of the VJP, never copied); y (T, d_out) bf16, accumulated
// in f32 and rounded once.  g (T, d_g) bf16; out (K, d_x, d_g) f32.
//
// The main path's operands are LoRA-shaped: one side of every product is
// a rank width (16..256) and the other a model width.  So the grouped
// product is the CTA routines of lora_tile.cuh with no rank mask:
//   narrow output (d_out <= 256: xa = x·A, dxa = dy_s·B^T): phase 1 alone,
//     16 rows of one adapter per CTA, the four warps splitting the
//     contraction and meeting in shared memory in a fixed order;
//   wide output, shallow contraction (d_in <= 256: dx = dxa·A^T): the x
//     rows go straight into the xa buffer and phase 2 walks the output
//     columns, which are split over CTAs only when the rows alone do not
//     fill the card.
// The contraction is never split over CTAs, so a result does not depend
// on the launch geometry.
//
// The grouped wgrad runs the two-pass routine of lora_tile.cuh (also
// B5's, ragged_bwd.cu): each CTA takes one chunk of token tiles at a
// fixed position, up to 64 lanes of the narrow operand and 64 columns of
// the wide one, and computes the f32 partial of each run of one
// adapter's tiles in its chunk; a second pass adds each adapter's
// partials in tile order (the TPU kernel revisited one output block
// across an adapter's tiles in tile order, fused_lora.py:98-118).  It
// reads the device tile map itself, needs no host copy of it, uses no
// atomics, and gives an adapter that owns no tile zeros (the Pallas
// wrapper masks uninitialised memory instead, fused_lora.py:160-163).
//
// Bound on the H100: bytes.  At LoRA ranks each product does 2 * rank
// flops per byte of its wide operand, far under the 295 flop/byte ridge.
// What the design does about it: every operand is staged once per pass
// with 16-byte loads; the wgrad reads the wide operand once for all the
// lanes it holds and keeps a four-stage cp.async ring in flight over
// hundreds of CTAs.  The narrow-output product still re-stages the x
// rows once per 16 lanes (the next redesign, B7).
#include "lora_tile.cuh"

namespace {

using namespace repro;
using namespace nvcuda;

// ---------------------------------------------------- narrow output
template <bool kTransW>
__global__ void __launch_bounds__(lora::kThreads)
grouped_mm_narrow_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const int* __restrict__ tile_map,
                         __nv_bfloat16* __restrict__ out, int T, int d_in,
                         int d_out, long w_k, long w_ld, int block_t) {
  __shared__ lora::Smem s;
  const int row0 = blockIdx.x * lora::kRows;
  const int k = tile_map[row0 / block_t];   // block_t % 16 == 0
  const int n_rows = min(lora::kRows, T - row0);
  // rank = width: no lane is masked, the f32 sum is rounded once
  lora::xa_rows<kTransW>(x + static_cast<long>(row0) * d_in, d_in,
                         w + k * w_k, w_ld, d_out, d_out, d_in, n_rows, s);
  const int V = d_out / 8;
  for (int i = threadIdx.x; i < lora::kRows * V; i += lora::kThreads) {
    const int r = i / V, c = (i % V) * 8;
    if (r < n_rows)
      *reinterpret_cast<uint4*>(out + static_cast<long>(row0 + r) * d_out +
                                c) =
          *reinterpret_cast<const uint4*>(&s.xa[r][c]);
  }
}

// ------------------------------------- wide output, shallow contraction
template <bool kTransW>
__global__ void __launch_bounds__(lora::kThreads)
grouped_mm_wide_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const int* __restrict__ tile_map,
                       __nv_bfloat16* __restrict__ out, int T, int d_in,
                       int d_out, long w_k, long w_ld, int block_t,
                       int cols_per_cta) {
  __shared__ lora::Smem s;
  const int row0 = blockIdx.x * lora::kRows;
  const int k = tile_map[row0 / block_t];
  const int n_rows = min(lora::kRows, T - row0);
  // the x rows are the contraction operand of phase 2: staged as they
  // are, zero up to the next whole 16-lane chunk
  const int lanes = (d_in + lora::kLanes - 1) / lora::kLanes * lora::kLanes;
  const int V = lanes / 8;
  for (int i = threadIdx.x; i < lora::kRows * V; i += lora::kThreads) {
    const int r = i / V, c = (i % V) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n_rows && c < d_in)
      v = *reinterpret_cast<const uint4*>(
          x + static_cast<long>(row0 + r) * d_in + c);
    *reinterpret_cast<uint4*>(&s.xa[r][c]) = v;
  }
  __syncthreads();
  const int col_begin = blockIdx.y * cols_per_cta;
  lora::xa_times_b<__nv_bfloat16, kTransW>(
      w + k * w_k, w_ld, d_in, n_rows, col_begin,
      lora::col_end_of(col_begin, cols_per_cta, d_out),
      out + static_cast<long>(row0) * d_out, d_out, s);
}

}  // namespace

// trans_w = 0: W[k] element (i, j) at w[k * w_k + i * w_ld + j];
// trans_w = 1: at w[k * w_k + j * w_ld + i].  narrow = 1 takes the
// narrow-output kernel (d_out <= 256), narrow = 0 the wide one (d_in <=
// 256); the wrapper picks and checks.
extern "C" int grouped_matmul_launch(const void* x, const void* w,
                                     const void* tile_map, void* out, int T,
                                     int d_in, int d_out, long w_k, long w_ld,
                                     int trans_w, int narrow, int block_t,
                                     int col_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const __nv_bfloat16*>(w);
  auto tp = static_cast<const int*>(tile_map);
  auto op = static_cast<__nv_bfloat16*>(out);
  const int row_ctas = (T + repro::lora::kRows - 1) / repro::lora::kRows;
  if (narrow) {
    dim3 grid(row_ctas);
    if (trans_w)
      grouped_mm_narrow_kernel<true><<<grid, repro::lora::kThreads, 0, st>>>(
          xp, wp, tp, op, T, d_in, d_out, w_k, w_ld, block_t);
    else
      grouped_mm_narrow_kernel<false><<<grid, repro::lora::kThreads, 0, st>>>(
          xp, wp, tp, op, T, d_in, d_out, w_k, w_ld, block_t);
  } else {
    const int per = repro::lora::cols_per_cta(d_out, col_groups);
    dim3 grid(row_ctas, (d_out + per - 1) / per);
    if (trans_w)
      grouped_mm_wide_kernel<true><<<grid, repro::lora::kThreads, 0, st>>>(
          xp, wp, tp, op, T, d_in, d_out, w_k, w_ld, block_t, per);
    else
      grouped_mm_wide_kernel<false><<<grid, repro::lora::kThreads, 0, st>>>(
          xp, wp, tp, op, T, d_in, d_out, w_k, w_ld, block_t, per);
  }
  return static_cast<int>(cudaGetLastError());
}

// The grouped wgrad through the shared two-pass routine of lora_tile.cuh.
// The narrow operand (the smaller of d_x and d_g) is u.  x narrow (dB =
// wgrad(xa, dy_s)): out[k] is (d_x lanes, d_g columns), row-major.  g
// narrow (dA = wgrad(x, dxa)): out[k] is (d_x columns, d_g lanes), the
// lanes contiguous.  W: n_tiles slots of d_x * d_g floats.
extern "C" int grouped_wgrad_launch(const void* x, const void* g,
                                    const void* tile_map, void* out,
                                    void* work, int T, int d_x, int d_g,
                                    int num_adapters, int block_t,
                                    int chunk_tiles, void* stream) {
  const bool narrow_x = d_x <= d_g;
  const int narrow = narrow_x ? d_x : d_g;
  const int wide = narrow_x ? d_g : d_x;
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto gp = static_cast<const __nv_bfloat16*>(g);
  return repro::lora::wgrad_launch(
      narrow_x ? xp : gp, narrow, narrow_x ? gp : xp, wide, wide,
      static_cast<const int*>(tile_map), T / block_t, block_t, chunk_tiles,
      nullptr, num_adapters, narrow, narrow, static_cast<float*>(work),
      static_cast<long>(narrow) * wide, narrow_x ? wide : 1,
      narrow_x ? 1 : narrow, static_cast<float*>(out),
      static_cast<long>(num_adapters) * narrow * wide,
      static_cast<cudaStream_t>(stream));
}
