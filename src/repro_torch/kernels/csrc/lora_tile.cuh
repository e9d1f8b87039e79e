// The CTA routines shared by the ragged and masked LoRA kernels
// (ragged_lora.cu, fused_lora.cu, ragged_bwd.cu, grouped.cu): 16 token
// rows that belong to ONE adapter, times a range of output columns; and,
// at the end, the weight-gradient accumulation of the two wgrads.
//
//   xa  = mask_{lane < rank}(x_rows · A_seg)    f32, then rounded to bf16
//   out = xa · B_seg                           f32 accumulation
//
// A_seg is the adapter's (d_in x width) operand and B_seg its (width x
// d_out) one.  Each is read either as stored (row-major: element (i, j)
// at p[i * ld + j]) or TRANSPOSED (element (i, j) at p[j * ld + i]): the
// backward's dgrad is the same routine with dy_s for x, B_seg^T for A_seg
// and A_seg^T for B_seg, both read in place from the packed pair.  The
// rank walk that the TPU kernels spread over a revisited grid axis is a
// loop inside the CTA, so every output element is written exactly once,
// by one CTA, with a fixed summation order: no atomics, deterministic,
// and a row's value does not depend on which other rows share the
// launch.  Products run on the tensor cores through WMMA bf16 16x16x16
// tiles with f32 accumulators.  All operands are staged through shared
// memory with 16-byte loads and bounds checks, so d_in, d_out and the
// segment width need be multiples of 8 elements only, not of any tile.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace lora {

using namespace nvcuda;

constexpr int kRows = 16;       // token rows per CTA: one WMMA M tile
constexpr int kCols = 128;      // output columns per inner block: 4 warps x 32
constexpr int kChunk = 256;     // d_in staged per step of x·A
constexpr int kLanes = 16;      // rank lanes per xa chunk: one WMMA K step
constexpr int kMaxWidth = 256;  // widest rank segment a CTA holds (16 chunks)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct __align__(128) Smem {
  __nv_bfloat16 x[kRows][kChunk];       //  8 KB  x rows, one d_in chunk
  __nv_bfloat16 a[kChunk][kLanes];      //  8 KB  A chunk, 16 rank lanes
  float red[kWarps][kRows][kLanes];     //  4 KB  per-warp partial x·A
  __nv_bfloat16 xa[kRows][kMaxWidth];   //  8 KB  masked xa, rounded to bf16
  __nv_bfloat16 b[kLanes][kCols];       //  4 KB  B chunk
  float out[kRows][kCols];              //  8 KB  f32 output block
};                                      // 40 KB: static, under 48 KB

// ---- staging of the three operands into shared memory, 16 bytes (8
// bf16) per load.  The wrapper guarantees what that needs: every pointer
// 16-byte aligned, every row stride, width and extent a multiple of 8
// elements.  Out-of-range vectors become zero.
__device__ __forceinline__ void stage_x(Smem& s,
                                        const __nv_bfloat16* __restrict__ x,
                                        long ldx, int n_rows, int k0,
                                        int d_in) {
  constexpr int V = kChunk / 8;
  for (int i = threadIdx.x; i < kRows * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n_rows && k0 + c < d_in)
      v = *reinterpret_cast<const uint4*>(x + r * ldx + k0 + c);
    *reinterpret_cast<uint4*>(&s.x[r][c]) = v;
  }
}

// A_seg chunk: d_in rows [k0, k0 + kChunk) x 16 lanes of rank chunk rc.
// Stored: s.a[k][lane].  Transposed (A_seg^T is what memory holds, lanes
// as rows): s.a viewed as [kLanes][kChunk], lane-major, so that each
// 16-byte load runs along d_in; the WMMA fragment then reads it
// column-major.
template <bool kTrans>
__device__ __forceinline__ void stage_a(Smem& s,
                                        const __nv_bfloat16* __restrict__ a,
                                        long lda, int k0, int d_in, int rc,
                                        int width) {
  if constexpr (kTrans) {
    constexpr int V = kChunk / 8;
    __nv_bfloat16 (*at)[kChunk] =
        reinterpret_cast<__nv_bfloat16 (*)[kChunk]>(&s.a[0][0]);
    for (int i = threadIdx.x; i < kLanes * V; i += kThreads) {
      const int r = i / V, c = (i % V) * 8;
      const int lane = rc * kLanes + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (lane < width && k0 + c < d_in)
        v = *reinterpret_cast<const uint4*>(a + lane * lda + k0 + c);
      *reinterpret_cast<uint4*>(&at[r][c]) = v;
    }
  } else {
    constexpr int V = kLanes / 8;
    for (int i = threadIdx.x; i < kChunk * V; i += kThreads) {
      const int r = i / V, c = (i % V) * 8;
      const int lane = rc * kLanes + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + r < d_in && lane < width)
        v = *reinterpret_cast<const uint4*>(a + (k0 + r) * lda + lane);
      *reinterpret_cast<uint4*>(&s.a[r][c]) = v;
    }
  }
}

// B_seg chunk: 16 lanes of rank chunk rc x output columns [c0, c0 +
// kCols).  Stored: s.b[lane][col].  Transposed: s.b viewed as
// [kCols][kLanes], column-major for the fragment.
template <bool kTrans>
__device__ __forceinline__ void stage_b(Smem& s,
                                        const __nv_bfloat16* __restrict__ b,
                                        long ldb, int rc, int width, int c0,
                                        int col_end) {
  if constexpr (kTrans) {
    constexpr int V = kLanes / 8;
    __nv_bfloat16 (*bt)[kLanes] =
        reinterpret_cast<__nv_bfloat16 (*)[kLanes]>(&s.b[0][0]);
    for (int i = threadIdx.x; i < kCols * V; i += kThreads) {
      const int r = i / V, c = (i % V) * 8;
      const int lane = rc * kLanes + c, col = c0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (lane < width && col < col_end)
        v = *reinterpret_cast<const uint4*>(b + col * ldb + lane);
      *reinterpret_cast<uint4*>(&bt[r][c]) = v;
    }
  } else {
    constexpr int V = kCols / 8;
    for (int i = threadIdx.x; i < kLanes * V; i += kThreads) {
      const int r = i / V, c = (i % V) * 8;
      const int lane = rc * kLanes + r, col = c0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (lane < width && col < col_end)
        v = *reinterpret_cast<const uint4*>(b + lane * ldb + col);
      *reinterpret_cast<uint4*>(&s.b[r][c]) = v;
    }
  }
}

template <bool kTrans>
using FragB = wmma::fragment<
    wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
    typename std::conditional<kTrans, wmma::col_major,
                              wmma::row_major>::type>;

// Phase 1: s.xa[:, 0:width) = bf16(mask_{lane < rank}(x_rows · A_seg)),
// every 16-lane chunk of the segment.  The four warps split the d_in
// steps; their partial sums meet in ``red``.
template <bool kTransA>
__device__ void xa_rows(const __nv_bfloat16* __restrict__ x, long ldx,
                        const __nv_bfloat16* __restrict__ a, long lda,
                        int width, int rank, int d_in, int n_rows, Smem& s) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n_rc = (width + kLanes - 1) / kLanes;
  for (int rc = 0; rc < n_rc; ++rc) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < d_in; k0 += kChunk) {
      stage_x(s, x, ldx, n_rows, k0, d_in);
      stage_a<kTransA>(s, a, lda, k0, d_in, rc, width);
      __syncthreads();
      for (int kk = warp; kk < kChunk / 16; kk += kWarps) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        FragB<kTransA> fb;
        wmma::load_matrix_sync(fa, &s.x[0][kk * 16], kChunk);
        if constexpr (kTransA)
          wmma::load_matrix_sync(fb, &s.a[0][0] + kk * 16, kChunk);
        else
          wmma::load_matrix_sync(fb, &s.a[kk * 16][0], kLanes);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      __syncthreads();
    }
    wmma::store_matrix_sync(&s.red[warp][0][0], acc, kLanes,
                            wmma::mem_row_major);
    __syncthreads();
    // rank mask on the f32 value, THEN round to bf16 (the reference's
    // order: ragged.py _fwd_kernel / _dgrad_kernel / _xa_kernel /
    // _dxa_kernel, fused_lora.py _fused_lora_kernel)
    for (int i = tid; i < kRows * kLanes; i += kThreads) {
      const int r = i / kLanes, c = i % kLanes;
      const int lane = rc * kLanes + c;
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += s.red[w][r][c];
      s.xa[r][lane] = __float2bfloat16(lane < rank ? v : 0.0f);
    }
    __syncthreads();
  }
}

// Phase 2: out[:, cols] = s.xa · B_seg[:, cols], block by block.
template <typename OutT, bool kTransB>
__device__ void xa_times_b(const __nv_bfloat16* __restrict__ b, long ldb,
                           int width, int n_rows, int col_begin, int col_end,
                           OutT* __restrict__ out, long ldo, Smem& s) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n_rc = (width + kLanes - 1) / kLanes;
  for (int c0 = col_begin; c0 < col_end; c0 += kCols) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[2];
    wmma::fill_fragment(o[0], 0.0f);
    wmma::fill_fragment(o[1], 0.0f);
    for (int rc = 0; rc < n_rc; ++rc) {
      stage_b<kTransB>(s, b, ldb, rc, width, c0, col_end);
      __syncthreads();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &s.xa[0][rc * kLanes], kMaxWidth);
      for (int j = 0; j < 2; ++j) {
        FragB<kTransB> fb;
        if constexpr (kTransB)
          wmma::load_matrix_sync(
              fb, &s.b[0][0] + (warp * 32 + j * 16) * kLanes, kLanes);
        else
          wmma::load_matrix_sync(fb, &s.b[0][warp * 32 + j * 16], kCols);
        wmma::mma_sync(o[j], fa, fb, o[j]);
      }
      __syncthreads();
    }
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&s.out[0][warp * 32 + j * 16], o[j], kCols,
                              wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int col = c0 + c;
      if (r < n_rows && col < col_end) store_out(&out[r * ldo + col], s.out[r][c]);
    }
    __syncthreads();
  }
}

// The whole LoRA product for 16 rows: phase 1, then phase 2.  kTrans
// reads both A_seg and B_seg transposed (the dgrad).
template <typename OutT, bool kTrans = false>
__device__ void lora_rows(const __nv_bfloat16* __restrict__ x, long ldx,
                          const __nv_bfloat16* __restrict__ a, long lda,
                          const __nv_bfloat16* __restrict__ b, long ldb,
                          int width, int rank, int d_in, int d_out,
                          int n_rows, int col_begin, int col_end,
                          OutT* __restrict__ out, long ldo, Smem& s) {
  xa_rows<kTrans>(x, ldx, a, lda, width, rank, d_in, n_rows, s);
  xa_times_b<OutT, kTrans>(b, ldb, width, n_rows, col_begin, col_end, out,
                           ldo, s);
}

// ---- weight gradients: out = u^T · v summed over token rows, for one
// 16-lane slice of the narrow operand u and one 128-column block of the
// wide operand v.  The caller walks its rows (the runs of token tiles
// of one adapter) in a fixed order and accumulates on the tensor cores
// in registers: the loop that the TPU grids ran as revisits of one
// output block, so there are no atomics and the sum is deterministic.
constexpr int kTok = 64;               // token rows staged per step

struct __align__(128) WgradSmem {
  __nv_bfloat16 u[kTok][kLanes];       //  2 KB  u rows, the CTA's 16 lanes
  __nv_bfloat16 v[kTok][kCols];        // 16 KB  v rows, one column block
  float out[kLanes][kCols];            //  8 KB  f32 output block
};

using WgradAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += u[t_begin:t_end, 0:16)^T · v[t_begin:t_end, c0:c0 + kCols).
// u points at the CTA's first lane (16 lanes, 16-byte aligned), v at
// column 0 of its rows; columns >= d stage as zero.
__device__ void wgrad_rows(const __nv_bfloat16* __restrict__ u, long ldu,
                           const __nv_bfloat16* __restrict__ v, long ldv,
                           int d, int c0, int t_begin, int t_end,
                           WgradAcc (&acc)[2], WgradSmem& s) {
  const int tid = threadIdx.x, warp = tid / 32;
  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    const int n = min(kTok, t_end - t0);
    for (int i = tid; i < kTok * (kLanes / 8); i += kThreads) {
      const int r = i / (kLanes / 8), c = (i % (kLanes / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < n)
        val = *reinterpret_cast<const uint4*>(
            u + static_cast<long>(t0 + r) * ldu + c);
      *reinterpret_cast<uint4*>(&s.u[r][c]) = val;
    }
    for (int i = tid; i < kTok * (kCols / 8); i += kThreads) {
      const int r = i / (kCols / 8), c = (i % (kCols / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < n && c0 + c < d)
        val = *reinterpret_cast<const uint4*>(
            v + static_cast<long>(t0 + r) * ldv + c0 + c);
      *reinterpret_cast<uint4*>(&s.v[r][c]) = val;
    }
    __syncthreads();
    for (int kk = 0; kk < kTok / 16; ++kk) {
      // u^T (lanes x tokens): u rows read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa;
      wmma::load_matrix_sync(fa, &s.u[kk * 16][0], kLanes);
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &s.v[kk * 16][warp * 32 + j * 16],
                               kCols);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
}

// Writes the CTA's (16 lanes x kCols) block: lane r, column c0 + c goes
// to out[r * ld_lane + (c0 + c) * ld_col], columns >= d skipped.  The
// element order follows whichever of the two strides is 1, so that
// neighbouring threads write neighbouring addresses.
__device__ void wgrad_store(WgradAcc (&acc)[2], float* __restrict__ out,
                            long ld_lane, long ld_col, int d, int c0,
                            WgradSmem& s) {
  const int tid = threadIdx.x, warp = tid / 32;
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&s.out[0][warp * 32 + j * 16], acc[j], kCols,
                            wmma::mem_row_major);
  __syncthreads();
  const bool lanes_inner = ld_lane == 1;
  for (int i = tid; i < kLanes * kCols; i += kThreads) {
    const int r = lanes_inner ? i % kLanes : i / kCols;
    const int c = lanes_inner ? i / kLanes : i % kCols;
    if (c0 + c < d) out[r * ld_lane + (c0 + c) * ld_col] = s.out[r][c];
  }
}

// Column range of CTA ``blockIdx.y`` when ``cols_per_cta`` columns each.
__device__ __forceinline__ int col_end_of(int col_begin, int cols_per_cta,
                                          int d_out) {
  return min(d_out, col_begin + cols_per_cta);
}

inline int cols_per_cta(int d_out, int col_groups) {
  const int per = (d_out + col_groups - 1) / col_groups;
  return ((per + kCols - 1) / kCols) * kCols;
}

}  // namespace lora
}  // namespace repro
