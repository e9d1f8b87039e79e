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
// Bound on the H100: bytes.  At LoRA ranks each product does 2 * rank
// flops per byte of its wide operand (x for the narrow output, y for the
// wide one), far under the 295 flop/byte ridge, so the design reads the
// wide operand once, with 16-byte copies kept in flight.
//
// The grouped product, one of two kernels by shape:
//   narrow output (d_out <= 256: xa = x·A, dxa = dy_s·B^T).  A CTA takes
//     ``rows`` token rows of one adapter (64, or 32 / 16 where fewer CTAs
//     would not fill the card; the wrapper picks) and up to 64 output
//     lanes (all of them on the main path, r_pad <= 64), so each x
//     element is read from device memory once.  x and A come through a
//     three-stage cp.async ring of 128-deep contraction steps, A's chunk
//     staged once per step for every lane; 8 warps, each owning one
//     class of 16-deep k-steps (kk mod 4) for half of the CTA's 16 x 16
//     output tiles.  The summation order is exactly phase 1 of
//     lora_fwd.cuh's LoRA routine (B3, B4, and x·W1 of B1, B2, B6): one
//     WMMA accumulator per class fed in ascending k by the same tensor-
//     core instruction, the four classes added in order 0..3 from 0.0f,
//     then one rounding -- so B7 narrow and B3/B4 agree bit for bit on
//     one layout;
//   wide output, shallow contraction (d_in <= 256: dx = dxa·A^T).  A CTA
//     takes ``rows`` rows and 256 output columns; the rows (all of
//     d_in) are staged once, then 128-column blocks of W come through two
//     stages, the next block's copies in flight while the current one
//     multiplies.  Each 16 x 16 output tile is one accumulator over the
//     16-lane chunks in ascending order (the routine's xa·W2 order: phase
//     2 of B2, so that B7 wide over B7 narrow equals B2 bit for bit); the
//     epilogue rounds through a per-warp scratch tile and leaves as
//     16-byte rows.
// The contraction is never split over CTAs, no atomics: a result does not
// depend on the launch geometry.
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
// It reads the wide operand once for all the lanes it holds and keeps a
// four-stage cp.async ring in flight over hundreds of CTAs.
#include <cstdint>
#include <type_traits>

#include "lora_tile.cuh"

namespace {

using namespace repro;
using namespace nvcuda;
using lora::cp_async16;
using lora::cp_async_commit;
using lora::cp_async_wait;

constexpr int kGThreads = 256;        // 8 warps
constexpr int kNLanes = 64;           // narrow: output lanes per CTA
constexpr int kNK = 128;              // narrow: d_in per ring stage
constexpr int kNStages = 3;           // narrow: cp.async ring depth
constexpr int kNXLd = kNK + 8;        // narrow: padded x row (bf16)
constexpr int kNAsLd = kNLanes + 8;   // narrow: stored A row (a k)
constexpr int kNAtLd = kNK + 8;       // narrow: transposed A row (a lane)
constexpr int kNAElems = kNK * kNAsLd > kNLanes * kNAtLd ? kNK * kNAsLd
                                                         : kNLanes * kNAtLd;
constexpr int kWCol = 128;            // wide: output columns per block
constexpr int kWCta = 2 * kWCol;      // wide: output columns per CTA
constexpr int kWLdS = kWCol + 8;      // wide: stored W row (bf16)

template <bool kTrans>
using FragW = wmma::fragment<
    wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
    typename std::conditional<kTrans, wmma::col_major,
                              wmma::row_major>::type>;
using FragX = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ---------------------------------------------------- narrow output
// Ring stage: x [BM][kNXLd] (kNK contraction columns), then A's chunk
// for every lane: stored [kNK][kNAsLd] (row k, lanes along it);
// transposed [kNLanes][kNAtLd] (row lane, k along it: what memory holds,
// read by the fragment column-major).
template <int BM>
__host__ __device__ constexpr int narrow_stage_elems() {
  return BM * kNXLd + kNAElems;
}

template <int BM>
__host__ __device__ constexpr int narrow_smem_bytes() {
  return kNStages * narrow_stage_elems<BM>() * 2;
}

template <int BM, bool kTransW>
__device__ __forceinline__ void narrow_stage(
    __nv_bfloat16* st, const __nv_bfloat16* __restrict__ x, int d_in,
    const __nv_bfloat16* __restrict__ w, long w_ld, int lane0, int d_out,
    int n_lanes, int k0) {
  __nv_bfloat16* xs = st;
  __nv_bfloat16* as = st + BM * kNXLd;
  for (int c = threadIdx.x; c < BM * (kNK / 8); c += kGThreads) {
    const int r = c / (kNK / 8), k = k0 + (c % (kNK / 8)) * 8;
    const bool in = k < d_in;
    cp_async16(xs + r * kNXLd + (k - k0),
               in ? x + static_cast<long>(r) * d_in + k : x, in);
  }
  if constexpr (kTransW) {          // lane rows, k contiguous
    for (int c = threadIdx.x; c < n_lanes * (kNK / 8); c += kGThreads) {
      const int l = c / (kNK / 8), kc = (c % (kNK / 8)) * 8;
      const bool in = lane0 + l < d_out && k0 + kc < d_in;
      cp_async16(as + l * kNAtLd + kc,
                 in ? w + static_cast<long>(lane0 + l) * w_ld + k0 + kc : w,
                 in);
    }
  } else {                          // k rows, lanes contiguous
    const int per_row = n_lanes / 8;
    for (int c = threadIdx.x; c < kNK * per_row; c += kGThreads) {
      const int kr = c / per_row, l = (c % per_row) * 8;
      const bool in = k0 + kr < d_in && lane0 + l < d_out;
      cp_async16(as + kr * kNAsLd + l,
                 in ? w + static_cast<long>(k0 + kr) * w_ld + lane0 + l : w,
                 in);
    }
  }
}

template <int BM, bool kTransW>
__global__ void __launch_bounds__(kGThreads)
grouped_mm_narrow_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const int* __restrict__ tile_map,
                         __nv_bfloat16* __restrict__ out, int d_in,
                         int d_out, long w_k, long w_ld, int block_t) {
  constexpr int RT = BM / 16;                // row tiles
  constexpr bool kSplitRows = RT >= 2;       // else the lane tiles split
  constexpr int RW = kSplitRows ? RT / 2 : RT;
  constexpr int LW = kSplitRows ? 4 : 2;     // lane tiles a warp may own
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int warp = threadIdx.x / 32;
  const int cls = warp & 3, h = warp >> 2;   // k-step class, half
  const int row0 = blockIdx.x * BM;
  const int lane0 = blockIdx.y * kNLanes;
  const int k = tile_map[row0 / block_t];    // block_t % BM == 0
  const int n_lanes = min(kNLanes, (d_out - lane0 + 15) / 16 * 16);
  const int LT = n_lanes / 16;
  const __nv_bfloat16* xr = x + static_cast<long>(row0) * d_in;
  const __nv_bfloat16* wk = w + k * w_k;

  Acc acc[RW][LW];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < LW; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_st = (d_in + kNK - 1) / kNK;
#pragma unroll
  for (int i = 0; i < kNStages - 1; ++i) {
    if (i < n_st)
      narrow_stage<BM, kTransW>(ring + i * narrow_stage_elems<BM>(), xr, d_in,
                                wk, w_ld, lane0, d_out, n_lanes, i * kNK);
    cp_async_commit();               // empty groups keep the count uniform
  }
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<kNStages - 2>();   // this thread's part of stage i
    __syncthreads();                 // everyone's; stage i - 1 is free
    const int nxt = i + kNStages - 1;
    if (nxt < n_st)
      narrow_stage<BM, kTransW>(
          ring + (nxt % kNStages) * narrow_stage_elems<BM>(), xr, d_in, wk,
          w_ld, lane0, d_out, n_lanes, nxt * kNK);
    cp_async_commit();
    const __nv_bfloat16* xs = ring + (i % kNStages) * narrow_stage_elems<BM>();
    const __nv_bfloat16* as = xs + BM * kNXLd;
    // this warp's class: k-steps kk = cls, cls + 4, ... of the stage, in
    // ascending order; a stage is a whole number of 4-step groups, so the
    // global k-step (kNK / 16) i + kk has class cls too
#pragma unroll
    for (int kk = cls; kk < kNK / 16; kk += 4) {
      FragX fx[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int rt = kSplitRows ? h + 2 * r : r;
        wmma::load_matrix_sync(fx[r], xs + rt * 16 * kNXLd + kk * 16, kNXLd);
      }
#pragma unroll
      for (int j = 0; j < LW; ++j) {
        const int lt = kSplitRows ? j : h + 2 * j;
        if (lt < LT) {
          FragW<kTransW> fw;
          if constexpr (kTransW)
            wmma::load_matrix_sync(fw, as + lt * 16 * kNAtLd + kk * 16,
                                   kNAtLd);
          else
            wmma::load_matrix_sync(fw, as + kk * 16 * kNAsLd + lt * 16,
                                   kNAsLd);
#pragma unroll
          for (int r = 0; r < RW; ++r)
            wmma::mma_sync(acc[r][j], fx[r], fw, acc[r][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the partials

  // red[class][row][lane], f32: each class's partial of every tile
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int rt = kSplitRows ? h + 2 * r : r;
#pragma unroll
    for (int j = 0; j < LW; ++j) {
      const int lt = kSplitRows ? j : h + 2 * j;
      if (lt < LT)
        wmma::store_matrix_sync(
            red + (cls * BM + rt * 16) * kNLanes + lt * 16, acc[r][j],
            kNLanes, wmma::mem_row_major);
    }
  }
  __syncthreads();
  // the classes added in order from 0.0f (the routine's x·W1 order), one
  // rounding,
  // 8 lanes (16 bytes) a thread
  const int V = n_lanes / 8;
  for (int i = threadIdx.x; i < BM * V; i += kGThreads) {
    const int r = i / V, l = (i % V) * 8;
    if (lane0 + l >= d_out) continue;
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float v2[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v += red[(c * BM + r) * kNLanes + l + e + u];
        v2[u] = v;
      }
      __nv_bfloat162 p = __floats2bfloat162_rn(v2[0], v2[1]);
      packed[e / 2] = *reinterpret_cast<uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(out + static_cast<long>(row0 + r) * d_out +
                              lane0 + l) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// ------------------------------------- wide output, shallow contraction
// Shared memory: the rows' x [BM][ldx] (ldx = lanes + 8, lanes = d_in
// rounded up to 16), two stages of one 128-column block of W -- stored
// [lanes][kWLdS], transposed [kWCol][ldx] -- and a 16 x 16 f32 scratch
// tile per warp.
template <bool kTransW>
__host__ __device__ constexpr int wide_stage_elems(int lanes) {
  return kTransW ? kWCol * (lanes + 8) : lanes * kWLdS;
}

template <int BM, bool kTransW>
__host__ __device__ constexpr int wide_smem_bytes(int lanes) {
  return (BM * (lanes + 8) + 2 * wide_stage_elems<kTransW>(lanes)) * 2 +
         (kGThreads / 32) * 256 * 4;
}

template <bool kTransW>
__device__ __forceinline__ void wide_stage(
    __nv_bfloat16* ws, const __nv_bfloat16* __restrict__ w, long w_ld,
    int d_in, int lanes, int c0, int col_end) {
  if constexpr (kTransW) {          // column rows, lanes contiguous
    const int per_row = lanes / 8, ld = lanes + 8;
    for (int c = threadIdx.x; c < kWCol * per_row; c += kGThreads) {
      const int col = c / per_row, l = (c % per_row) * 8;
      const bool in = l < d_in && c0 + col < col_end;
      cp_async16(ws + col * ld + l,
                 in ? w + static_cast<long>(c0 + col) * w_ld + l : w, in);
    }
  } else {                          // lane rows, columns contiguous
    constexpr int per_row = kWCol / 8;
    for (int c = threadIdx.x; c < lanes * per_row; c += kGThreads) {
      const int l = c / per_row, col = (c % per_row) * 8;
      const bool in = l < d_in && c0 + col < col_end;
      cp_async16(ws + l * kWLdS + col,
                 in ? w + static_cast<long>(l) * w_ld + c0 + col : w, in);
    }
  }
}

template <int BM, bool kTransW>
__global__ void __launch_bounds__(kGThreads)
grouped_mm_wide_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const int* __restrict__ tile_map,
                       __nv_bfloat16* __restrict__ out, int d_in,
                       int d_out, long w_k, long w_ld, int block_t) {
  constexpr int RT = BM / 16;          // row tiles; a warp owns one, and
  constexpr int CW = RT;               // CW of a block's 8 column tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lanes = (d_in + 15) / 16 * 16, ldx = lanes + 8;
  const int n_rc = lanes / 16;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wst = xs + BM * ldx;
  const int ws_elems = wide_stage_elems<kTransW>(lanes);
  float* scratch = reinterpret_cast<float*>(wst + 2 * ws_elems);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rt = warp % RT, ct0 = (warp / RT) * CW;
  float* scr = scratch + warp * 256;
  const int row0 = blockIdx.x * BM;
  const int k = tile_map[row0 / block_t];
  const int col_begin = blockIdx.y * kWCta;
  const int col_end = min(d_out, col_begin + kWCta);
  const __nv_bfloat16* wk = w + k * w_k;

  // the rows' x, zero up to the next whole 16-lane chunk, with W's first
  // column block
  const int V = lanes / 8;
  for (int c = threadIdx.x; c < BM * V; c += kGThreads) {
    const int r = c / V, l = (c % V) * 8;
    const bool in = l < d_in;
    cp_async16(xs + r * ldx + l,
               in ? x + static_cast<long>(row0 + r) * d_in + l : x, in);
  }
  wide_stage<kTransW>(wst, wk, w_ld, d_in, lanes, col_begin, col_end);
  cp_async_commit();

  const int n_blk = (col_end - col_begin + kWCol - 1) / kWCol;
  for (int b = 0; b < n_blk; ++b) {
    const int c0 = col_begin + b * kWCol;
    if (b + 1 < n_blk) {       // the next block's W, into the stage freed
      wide_stage<kTransW>(wst + ((b + 1) & 1) * ws_elems, wk, w_ld, d_in,
                          lanes, c0 + kWCol, col_end);   // at b - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ws = wst + (b & 1) * ws_elems;
    Acc acc[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int rc = 0; rc < n_rc; ++rc) {        // ascending rank chunks
      FragX fx;
      wmma::load_matrix_sync(fx, xs + rt * 16 * ldx + rc * 16, ldx);
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        FragW<kTransW> fw;
        const int ct = ct0 + j;
        if constexpr (kTransW)
          wmma::load_matrix_sync(fw, ws + ct * 16 * ldx + rc * 16, ldx);
        else
          wmma::load_matrix_sync(fw, ws + rc * 16 * kWLdS + ct * 16, kWLdS);
        wmma::mma_sync(acc[j], fx, fw, acc[j]);
      }
    }
    // round once; two lanes a row, 8 columns (16 bytes) each
    const int r = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = c0 + (ct0 + j) * 16 + cc;
      if (col < col_end) {
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          __nv_bfloat162 p = __floats2bfloat162_rn(scr[r * 16 + cc + e],
                                                   scr[r * 16 + cc + e + 1]);
          packed[e / 2] = *reinterpret_cast<uint32_t*>(&p);
        }
        *reinterpret_cast<uint4*>(
            out + static_cast<long>(row0 + rt * 16 + r) * d_out + col) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      __syncwarp();
    }
    __syncthreads();               // stage b & 1 is free for block b + 2
  }
}

template <int BM, bool kTransW>
cudaError_t launch_narrow(const __nv_bfloat16* x, const __nv_bfloat16* w,
                          const int* tm, __nv_bfloat16* out, int T, int d_in,
                          int d_out, long w_k, long w_ld, int block_t,
                          cudaStream_t st) {
  constexpr int bytes = narrow_smem_bytes<BM>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_mm_narrow_kernel<BM, kTransW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(T / BM, (d_out + kNLanes - 1) / kNLanes);
  grouped_mm_narrow_kernel<BM, kTransW><<<grid, kGThreads, bytes, st>>>(
      x, w, tm, out, d_in, d_out, w_k, w_ld, block_t);
  return cudaGetLastError();
}

template <int BM, bool kTransW>
cudaError_t launch_wide(const __nv_bfloat16* x, const __nv_bfloat16* w,
                        const int* tm, __nv_bfloat16* out, int T, int d_in,
                        int d_out, long w_k, long w_ld, int block_t,
                        cudaStream_t st) {
  // sized for the widest contraction (256), set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_mm_wide_kernel<BM, kTransW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      wide_smem_bytes<BM, kTransW>(256));
  if (attr != cudaSuccess) return attr;
  const int bytes = wide_smem_bytes<BM, kTransW>((d_in + 15) / 16 * 16);
  dim3 grid(T / BM, (d_out + kWCta - 1) / kWCta);
  grouped_mm_wide_kernel<BM, kTransW><<<grid, kGThreads, bytes, st>>>(
      x, w, tm, out, d_in, d_out, w_k, w_ld, block_t);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_rows(const __nv_bfloat16* x, const __nv_bfloat16* w,
                        const int* tm, __nv_bfloat16* out, int T, int d_in,
                        int d_out, long w_k, long w_ld, bool trans,
                        bool narrow, int block_t, cudaStream_t st) {
  if (narrow)
    return trans ? launch_narrow<BM, true>(x, w, tm, out, T, d_in, d_out,
                                           w_k, w_ld, block_t, st)
                 : launch_narrow<BM, false>(x, w, tm, out, T, d_in, d_out,
                                            w_k, w_ld, block_t, st);
  return trans ? launch_wide<BM, true>(x, w, tm, out, T, d_in, d_out, w_k,
                                       w_ld, block_t, st)
               : launch_wide<BM, false>(x, w, tm, out, T, d_in, d_out, w_k,
                                        w_ld, block_t, st);
}

}  // namespace

// trans_w = 0: W[k] element (i, j) at w[k * w_k + i * w_ld + j];
// trans_w = 1: at w[k * w_k + j * w_ld + i].  narrow = 1 takes the
// narrow-output kernel (d_out <= 256), narrow = 0 the wide one (d_in <=
// 256); rows (16, 32 or 64, dividing block_t) token rows a CTA.  The
// wrapper picks and checks.
extern "C" int grouped_matmul_launch(const void* x, const void* w,
                                     const void* tile_map, void* out, int T,
                                     int d_in, int d_out, long w_k, long w_ld,
                                     int trans_w, int narrow, int block_t,
                                     int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const __nv_bfloat16*>(w);
  auto tp = static_cast<const int*>(tile_map);
  auto op = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  switch (rows) {
    case 64:
      err = launch_rows<64>(xp, wp, tp, op, T, d_in, d_out, w_k, w_ld,
                            trans_w, narrow, block_t, st);
      break;
    case 32:
      err = launch_rows<32>(xp, wp, tp, op, T, d_in, d_out, w_k, w_ld,
                            trans_w, narrow, block_t, st);
      break;
    case 16:
      err = launch_rows<16>(xp, wp, tp, op, T, d_in, d_out, w_k, w_ld,
                            trans_w, narrow, block_t, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
