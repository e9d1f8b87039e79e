// The two-pass weight gradient that B5 (ragged_wgrad, ragged_bwd.cu) and
// B8 (grouped_wgrad, grouped.cu) both run, so that they sum in one order.
//
// It replaces the TPU kernels' revisited output block
// (src/repro/kernels/ragged.py _wgrad_kernel, fused_lora.py
// _grouped_wgrad_kernel).  Bound on the H100: bytes -- 2 x (rank width)
// flops per byte of the wide operand, far under the 295 flop/byte ridge
// -- so the design reads the wide operand once for up to 64 lanes,
// spreads an adapter's tokens over many CTAs (chunks of token tiles at
// fixed positions, not one CTA walking them all), feeds each CTA through
// a four-stage cp.async ring, and sums the chunks' partials in a second,
// small pass in a fixed order.  Products run on the tensor cores through
// WMMA bf16 16x16x16 tiles with f32 accumulators.
#pragma once

#include "common.cuh"

namespace repro {
namespace lora {

using namespace nvcuda;

constexpr int kThreads = 128;          // 4 warps

// ---- weight gradients (B5 ragged_wgrad, B8 grouped_wgrad): out = u^T·v
// summed over an adapter's token rows, u the narrow operand (a rank
// width), v the wide one (a model width).
//
// The summation order, one rule for both kernels and for their plain
// versions (kernels/fused_lora.py, wgrad_pieces): the token tiles are cut
// into chunks of ``chunk_tiles`` tiles at absolute tile positions, and a
// PIECE is a maximal run of one adapter's tiles inside one chunk
// (piece_start).  Pass 1 (wgrad_partials_kernel) gives each piece's f32
// partial to one CTA per (chunk, 64-lane block, 64-column block): the
// piece's tokens in order, 16 per tensor-core step, accumulated in
// registers, then stored to a workspace slot named by the piece's first
// tile.  Pass 2 (wgrad_reduce_kernel) sums, for every output element,
// its adapter's partials in tile order starting from 0.  No atomics; the
// order depends on the tile map and chunk_tiles only, never on the
// launch geometry, and an adapter that owns no tile gets zeros.
//
// B8 (grouped.cu) reads the adapter of each tile from its device tile
// map and finds u at column 0, ``narrow`` lanes wide; B5 (ragged_bwd.cu)
// reads the same per-tile adapter ids and finds each adapter's u at its
// packed segment (seg[2k] = first column, seg[2k + 1] = padded width).
// On a uniform layout the two sum the same products in the same order,
// bit for bit.
constexpr int kWLanes = 64;            // lanes of u per CTA
constexpr int kWCols = 64;             // columns of v per CTA: 16 a warp
constexpr int kWTok = 32;              // token rows per ring stage
constexpr int kWStages = 4;            // cp.async ring depth
constexpr int kWLd = kWLanes + 8;      // padded smem row (bf16): 144 B

struct __align__(128) WgradSmem {
  __nv_bfloat16 u[kWStages][kWTok][kWLd];   // 18 KB
  __nv_bfloat16 v[kWStages][kWTok][kWLd];   // 18 KB
};                                          // 36 KB static; the f32
//                                             (64 x 64) store tile reuses it

using WgradAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ bool piece_start(const int* __restrict__ tm,
                                            int t, int chunk_tiles) {
  return t % chunk_tiles == 0 || tm[t] != tm[t - 1];
}

// 16-byte async copy to shared memory; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One ring stage: token rows [tok, tok + kWTok) (zeros at and past
// tok_end) of u's ``lanes`` lanes and of v's 64 columns from col0
// (zeros at and past d).
__device__ __forceinline__ void wgrad_stage(
    WgradSmem& s, int b, const __nv_bfloat16* __restrict__ u, long ldu,
    int lanes, const __nv_bfloat16* __restrict__ v, long ldv, int d,
    int col0, int tok, int tok_end) {
  const int lv = lanes / 8;
  for (int i = threadIdx.x; i < kWTok * lv; i += kThreads) {
    const int r = i / lv, c = (i % lv) * 8;
    const bool in = tok + r < tok_end;
    cp_async16(&s.u[b][r][c], in ? u + (tok + r) * ldu + c : u, in);
  }
  constexpr int cv = kWCols / 8;
  for (int i = threadIdx.x; i < kWTok * cv; i += kThreads) {
    const int r = i / cv, c = (i % cv) * 8;
    const bool in = tok + r < tok_end && col0 + c < d;
    cp_async16(&s.v[b][r][c], in ? v + (tok + r) * ldv + col0 + c : v, in);
  }
}

// acc[lt] (lanes 16 lt.. of the CTA's block, columns col0 + 16 warp..)
// += u[tok0:tok1, lanes]^T · v[tok0:tok1, cols], 16 tokens a step in
// token order, through a kWStages-deep cp.async ring.  u points at the
// block's first lane; ``lanes`` is a multiple of 16, at most 64.
__device__ void wgrad_piece(const __nv_bfloat16* __restrict__ u, long ldu,
                            int lanes, const __nv_bfloat16* __restrict__ v,
                            long ldv, int d, int col0, int tok0, int tok1,
                            WgradAcc (&acc)[4], WgradSmem& s) {
  const int warp = threadIdx.x / 32;
  const int n_lt = lanes / 16;
  const int n_st = (tok1 - tok0 + kWTok - 1) / kWTok;
#pragma unroll
  for (int i = 0; i < kWStages - 1; ++i) {
    if (i < n_st)
      wgrad_stage(s, i, u, ldu, lanes, v, ldv, d, col0, tok0 + i * kWTok,
                  tok1);
    cp_async_commit();               // empty groups keep the count uniform
  }
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<kWStages - 2>();   // this thread's part of stage i
    __syncthreads();                 // everyone's; stage i - 1 is free
    const int nxt = i + kWStages - 1;
    if (nxt < n_st)
      wgrad_stage(s, nxt % kWStages, u, ldu, lanes, v, ldv, d, col0,
                  tok0 + nxt * kWTok, tok1);
    cp_async_commit();
    const int b = i % kWStages;
#pragma unroll
    for (int kk = 0; kk < kWTok / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fb, &s.v[b][kk * 16][warp * 16], kWLd);
#pragma unroll
      for (int lt = 0; lt < 4; ++lt) {
        if (lt < n_lt) {
          // u^T (lanes x tokens): u rows read column-major
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fa;
          wmma::load_matrix_sync(fa, &s.u[b][kk * 16][lt * 16], kWLd);
          wmma::mma_sync(acc[lt], fa, fb, acc[lt]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the store
}

namespace {   // the two passes, each library its own copy

// Pass 1.  grid (chunk, 64-lane block, 64-column block).  tm: adapter of
// each token tile.  seg: per adapter (first column of u, width), or null
// (every adapter at column 0, ``narrow`` lanes).  The partial of the
// piece that starts at tile t goes to W + t * slot, element (lane, col)
// at lane * ld_lane + col * ld_col.
__global__ void __launch_bounds__(kThreads)
wgrad_partials_kernel(const __nv_bfloat16* __restrict__ u, long ldu,
                      const __nv_bfloat16* __restrict__ v, long ldv, int d,
                      const int* __restrict__ tm, int n_tiles, int block_t,
                      int chunk_tiles, const int* __restrict__ seg,
                      int narrow, float* __restrict__ W, long slot,
                      long ld_lane, long ld_col) {
  __shared__ WgradSmem s;
  const int lane0 = blockIdx.y * kWLanes;
  const int col0 = blockIdx.z * kWCols;
  const int warp = threadIdx.x / 32;
  const int chunk = static_cast<int>(blockIdx.x);
  const int t_stop = min(n_tiles, (chunk + 1) * chunk_tiles);
  for (int t0 = chunk * chunk_tiles; t0 < t_stop;) {
    const int k = tm[t0];
    int t1 = t0 + 1;
    while (t1 < t_stop && tm[t1] == k) ++t1;
    const int ucol = seg ? seg[2 * k] : 0;
    const int width = seg ? seg[2 * k + 1] : narrow;
    const int lanes = min(kWLanes, width - lane0);
    if (lanes > 0) {                 // uniform over the CTA
      WgradAcc acc[4];
#pragma unroll
      for (int lt = 0; lt < 4; ++lt) wmma::fill_fragment(acc[lt], 0.0f);
      wgrad_piece(u + ucol + lane0, ldu, lanes, v, ldv, d, col0,
                  t0 * block_t, t1 * block_t, acc, s);
      float* tile = reinterpret_cast<float*>(&s);     // [64][kWCols]
#pragma unroll
      for (int lt = 0; lt < 4; ++lt)
        if (lt < lanes / 16)
          wmma::store_matrix_sync(tile + lt * 16 * kWCols + warp * 16,
                                  acc[lt], kWCols, wmma::mem_row_major);
      __syncthreads();
      // neighbouring threads on neighbouring addresses of W
      float* w = W + t0 * slot;
      const bool lanes_inner = ld_lane == 1;
      for (int i = threadIdx.x; i < lanes * kWCols; i += kThreads) {
        const int r = lanes_inner ? i % lanes : i / kWCols;
        const int c = lanes_inner ? i / lanes : i % kWCols;
        if (col0 + c < d)
          w[(lane0 + r) * ld_lane + (col0 + c) * ld_col] =
              tile[r * kWCols + c];
      }
      __syncthreads();               // the tile is the next piece's ring
    }
    t0 = t1;
  }
}

// Pass 2.  One thread per output element i.  seg null (B8): out is (K,
// narrow x d) blocks laid out as the W slots, k = i / (narrow * d).  seg
// given (B5): out is (R, d), row r in adapter k's segment [seg[2k],
// seg[2k] + seg[2k + 1]), its slot offset (r - seg[2k]) * d + col.  The
// CTA first lists the pieces of 256 tiles at a time in shared memory
// (ballots, in tile order); each thread then adds its adapter's.
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float* __restrict__ W, long slot,
                    const int* __restrict__ tm, int n_tiles,
                    int chunk_tiles, const int* __restrict__ seg,
                    int n_seg, int narrow, int d, float* __restrict__ out,
                    long total) {
  __shared__ int s_tile[256], s_k[256], s_warp[8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long i = blockIdx.x * 256L + tid;
  int k = -1;
  long o = 0;
  if (i < total && seg) {
    const int r = static_cast<int>(i / d);
    k = 0;
    while (k + 1 < n_seg && r >= seg[2 * (k + 1)]) ++k;
    o = static_cast<long>(r - seg[2 * k]) * d + i % d;
  } else if (i < total) {
    const long per = static_cast<long>(narrow) * d;
    k = static_cast<int>(i / per);
    o = i % per;
  }
  float acc = 0.0f;
  for (int base = 0; base < n_tiles; base += 256) {
    const int t = base + tid;
    const bool start = t < n_tiles && piece_start(tm, t, chunk_tiles);
    const unsigned ballot = __ballot_sync(0xffffffffu, start);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1)), n = 0;
    for (int w = 0; w < 8; ++w) {
      if (w < warp) pos += s_warp[w];
      n += s_warp[w];
    }
    if (start) {
      s_tile[pos] = t;
      s_k[pos] = tm[t];
    }
    __syncthreads();
    for (int p = 0; p < n; ++p)         // the pieces in tile order
      if (s_k[p] == k) acc += W[s_tile[p] * slot + o];
    __syncthreads();
  }
  if (i < total) out[i] = acc;
}

}  // namespace

// Both passes on ``stream``; returns cudaGetLastError().  W holds n_tiles
// slots of ``slot`` floats (the wrapper allocates it).
inline int wgrad_launch(const __nv_bfloat16* u, long ldu,
                        const __nv_bfloat16* v, long ldv, int d,
                        const int* tm, int n_tiles, int block_t,
                        int chunk_tiles, const int* seg, int n_seg,
                        int narrow, int max_width, float* W, long slot,
                        long ld_lane, long ld_col, float* out, long total,
                        cudaStream_t stream) {
  dim3 grid((n_tiles + chunk_tiles - 1) / chunk_tiles,
            (max_width + kWLanes - 1) / kWLanes, (d + kWCols - 1) / kWCols);
  wgrad_partials_kernel<<<grid, kThreads, 0, stream>>>(
      u, ldu, v, ldv, d, tm, n_tiles, block_t, chunk_tiles, seg, narrow, W,
      slot, ld_lane, ld_col);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        stream>>>(W, slot, tm, n_tiles, chunk_tiles, seg,
                                  n_seg, narrow, d, out, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lora
}  // namespace repro
