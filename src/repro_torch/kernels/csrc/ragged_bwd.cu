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
// RaggedMeta.tile_table) and run the CTA routines of lora_tile.cuh: the
// dgrad is the forward routine with dy_s for x and both operands read
// transposed in place; xa and dxa are its phase 1 alone.  Every entry of
// xa and dxa outside the token's own segment is written as zero (Pallas
// leaves those blocks unwritten; the reference never reads them).
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
// flop/byte ridge at LoRA ranks.  What the design does about it: every
// operand is staged once per CTA with 16-byte loads, and the wgrad reads
// v once for up to 64 lanes of a segment; dgrad CTAs that split columns
// still recompute their rows' dxa.
#include "lora_tile.cuh"

namespace {

using namespace repro;
using namespace nvcuda;

// ----------------------------------------------------------------- dgrad
__global__ void __launch_bounds__(lora::kThreads)
ragged_dgrad_kernel(const __nv_bfloat16* __restrict__ dy,
                    const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    const int* __restrict__ tiles, float* __restrict__ dx,
                    int T, int d_in, int d_out, int R, int block_t,
                    int cols_per_cta) {
  __shared__ lora::Smem s;
  const int row0 = blockIdx.x * lora::kRows;
  const int tile = row0 / block_t;     // block_t % 16 == 0: one adapter
  const int col0 = tiles[3 * tile];
  const int width = tiles[3 * tile + 1];
  const int rank = tiles[3 * tile + 2];
  const int col_begin = blockIdx.y * cols_per_cta;
  // phase 1 reads B_seg^T (d_out x width): B rows col0.. hold it with
  // stride d_out; phase 2 reads A_seg^T (width x d_in): A columns col0..
  // with stride R
  lora::lora_rows<float, true>(
      dy + static_cast<long>(row0) * d_out, d_out,
      b + static_cast<long>(col0) * d_out, d_out, a + col0, R, width, rank,
      d_out, d_in, min(lora::kRows, T - row0), col_begin,
      lora::col_end_of(col_begin, cols_per_cta, d_in),
      dx + static_cast<long>(row0) * d_in, d_in, s);
}

// -------------------------------------------------------------- xa / dxa
// kTrans = false: xa  = x    · A_seg    (A columns col0.., stride R)
// kTrans = true:  dxa = dy_s · B_seg^T  (B rows col0.., stride d)
template <bool kTrans>
__global__ void __launch_bounds__(lora::kThreads)
ragged_packed_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const int* __restrict__ tiles,
                     __nv_bfloat16* __restrict__ out, int T, int d, int R,
                     int block_t) {
  __shared__ lora::Smem s;
  const int row0 = blockIdx.x * lora::kRows;
  const int tile = row0 / block_t;
  const int col0 = tiles[3 * tile];
  const int width = tiles[3 * tile + 1];
  const int rank = tiles[3 * tile + 2];
  const int n_rows = min(lora::kRows, T - row0);
  const __nv_bfloat16* seg =
      kTrans ? w + static_cast<long>(col0) * d : w + col0;
  lora::xa_rows<kTrans>(x + static_cast<long>(row0) * d, d, seg,
                        kTrans ? d : R, width, rank, d, n_rows, s);
  // the token's own segment from s.xa, every other packed column zero
  for (int i = threadIdx.x; i < lora::kRows * R; i += lora::kThreads) {
    const int r = i / R, c = i % R;
    if (r >= n_rows) continue;
    const int lane = c - col0;
    out[static_cast<long>(row0 + r) * R + c] =
        (lane >= 0 && lane < width) ? s.xa[r][lane] : bf16_zero();
  }
}

}  // namespace

extern "C" int ragged_dgrad_launch(const void* dy, const void* a,
                                   const void* b, const void* tiles,
                                   void* dx, int T, int d_in, int d_out,
                                   int R, int block_t, int col_groups,
                                   void* stream) {
  const int per = repro::lora::cols_per_cta(d_in, col_groups);
  dim3 grid((T + repro::lora::kRows - 1) / repro::lora::kRows,
            (d_in + per - 1) / per);
  ragged_dgrad_kernel<<<grid, repro::lora::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const int*>(tiles),
      static_cast<float*>(dx), T, d_in, d_out, R, block_t, per);
  return static_cast<int>(cudaGetLastError());
}

// transposed = 0: xa (x, A); transposed = 1: dxa (dy_s, B)
extern "C" int ragged_packed_launch(const void* x, const void* w,
                                    const void* tiles, void* out, int T,
                                    int d, int R, int block_t,
                                    int transposed, void* stream) {
  dim3 grid((T + repro::lora::kRows - 1) / repro::lora::kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const __nv_bfloat16*>(w);
  auto tp = static_cast<const int*>(tiles);
  auto op = static_cast<__nv_bfloat16*>(out);
  if (transposed)
    ragged_packed_kernel<true><<<grid, repro::lora::kThreads, 0, st>>>(
        xp, wp, tp, op, T, d, R, block_t);
  else
    ragged_packed_kernel<false><<<grid, repro::lora::kThreads, 0, st>>>(
        xp, wp, tp, op, T, d, R, block_t);
  return static_cast<int>(cudaGetLastError());
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
