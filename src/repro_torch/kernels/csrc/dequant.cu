// The quantized backbone's dequant-matmul for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_lora.py, dequant_matmul_pallas /
// _dequant_mm_kernel, and the second launch of its custom VJP
// (src/repro/kernels/ops.py, _make_dequant_pallas_fn):
//
//   y = bf16((x · q) * scale)      x (T, K) bf16, q (K, N) int8,
//                                  scale (N,) f32 or none (unit scales)
//
// The int8 tile is converted to bf16 as it is staged into shared memory
// (values in -127..127 are exact in bf16); the tensor cores multiply bf16
// by bf16 and accumulate in f32; the epilogue multiplies the f32 sum by
// the column's scale and rounds once to bf16.  No bf16 copy of q ever
// reaches device memory: halving the weight bytes is the point.
//
// q is read through its strides, either as stored (element (k, n) at
// q[k * ldq + n]: the forward, q (d_in, d_out)) or transposed in place
// (element (k, n) at q[n * ldq + k]: the backward's dx = dys · q^T, q
// still the (d_in, d_out) codes).  Both stage 16-byte row segments with
// coalesced loads; the transposed tile is kept in shared memory as it
// lies in device memory and read by the tensor cores as a col_major
// operand, so no transposed copy is made.
//
// Design: one CTA per (BM rows, BN columns) output tile; the whole
// contraction stays in the CTA (no split-K, no atomics: a result does not
// depend on the launch geometry).  K walks in steps of 32 through two
// shared-memory stages: the next step's x and q are loaded into
// registers while the tensor cores work on the current stage (WMMA
// 16x16x16 bf16 fragments, f32 accumulators in registers), then
// converted and stored into the other stage.  Two tile shapes: 128 x 128
// with 8 warps (each 32 x 64) where that gives every SM a CTA; 64 x 64
// with 4 warps (each 32 x 32) for short row counts (decode), so the
// weight stream is spread over more SMs.  Edges are masked here: rows
// past T, columns past N and contraction steps past K are zero-filled
// and not stored.  The wrapper checks K and N are multiples of 16 and the
// operands 16-byte aligned.
//
// Bound on the H100: at training shapes (T = 8192) operations (2 T K N
// flops against T K + T N bf16 and K N int8 bytes: 0.07-0.19 ms a call);
// at decode (64 rows) bytes, nearly all of them the int8 codes.  A later
// version moves to wgmma with TMA-fed stages and keeps the int8 tile in
// shared memory until the warpgroup converts it.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBK = 32;    // contraction step
constexpr int kPad = 8;    // bf16 elements of padding per shared row

template <int BM, int BN, int WM, int WN, bool kTrans>
struct Cfg {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kWarps = (BM / WM) * kWarpsN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kFm = WM / 16, kFn = WN / 16;
  static constexpr int kLdx = kBK + kPad;              // x tile [BM][kLdx]
  // q tile, bf16: stored [kBK][BN + kPad], transposed [BN][kBK + kPad]
  static constexpr int kLdw = kTrans ? kBK + kPad : BN + kPad;
  static constexpr int kXElems = BM * kLdx;
  static constexpr int kWElems = kTrans ? BN * kLdw : kBK * kLdw;
  static constexpr int kStage = kXElems + kWElems;
  static constexpr int kXPer = BM * kBK / 8 / kThreads;   // 16 B chunks
  static constexpr int kWPer = kBK * BN / 16 / kThreads;  // 16 B chunks
  static_assert(BM * kBK / 8 % kThreads == 0, "x chunks per thread");
  static_assert(kBK * BN / 16 % kThreads == 0, "q chunks per thread");
  static_assert(2 * kStage * 2 >= kWarps * 256 * 4, "epilogue scratch");
  static_assert(2 * kStage * 2 <= 48 * 1024, "static shared memory");
};

// Byte b of w as a sign-extended int8, in f32 (exact).
__device__ __forceinline__ float i8_lane(uint32_t w, int b) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * b)) >> 24);
}

// Two int8 lanes (bytes b, b + 1 of w) -> two bf16, packed.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(i8_lane(w, b), i8_lane(w, b + 1));
  return *reinterpret_cast<uint32_t*>(&p);
}

// 16 int8 codes -> 16 bf16 at dst (32 bytes, 16-byte aligned).
__device__ __forceinline__ void store_i8x16(const uint4 v,
                                            __nv_bfloat16* dst) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(i8x2_bf16(v.x, 0), i8x2_bf16(v.x, 2), i8x2_bf16(v.y, 0),
                    i8x2_bf16(v.y, 2));
  d[1] = make_uint4(i8x2_bf16(v.z, 0), i8x2_bf16(v.z, 2), i8x2_bf16(v.w, 0),
                    i8x2_bf16(v.w, 2));
}

template <int BM, int BN, int WM, int WN, bool kTrans>
__global__ void __launch_bounds__(Cfg<BM, BN, WM, WN, kTrans>::kThreads)
dequant_mm_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ q,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int T, int K, int N,
                  long ldq) {
  using C = Cfg<BM, BN, WM, WN, kTrans>;
  using LayoutB = std::conditional_t<kTrans, wmma::col_major,
                                     wmma::row_major>;
  __shared__ __align__(128) __nv_bfloat16 smem[2 * C::kStage];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::kFm][C::kFn];
#pragma unroll
  for (int i = 0; i < C::kFm; ++i)
#pragma unroll
    for (int j = 0; j < C::kFn; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 xr[C::kXPer], wr[C::kWPer];
  // global -> registers: the contraction step starting at k0
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < C::kXPer; ++p) {
      const int c = tid + p * C::kThreads;
      const int r = c / (kBK / 8), k = k0 + (c % (kBK / 8)) * 8;
      xr[p] = make_uint4(0, 0, 0, 0);
      if (m0 + r < T && k < K)
        xr[p] = *reinterpret_cast<const uint4*>(
            x + static_cast<long>(m0 + r) * K + k);
    }
#pragma unroll
    for (int p = 0; p < C::kWPer; ++p) {
      const int c = tid + p * C::kThreads;
      wr[p] = make_uint4(0, 0, 0, 0);
      if (kTrans) {          // rows of q^T's memory: n, 16 codes along k
        const int n = n0 + c / (kBK / 16), k = k0 + (c % (kBK / 16)) * 16;
        if (n < N && k < K)
          wr[p] = *reinterpret_cast<const uint4*>(
              q + static_cast<long>(n) * ldq + k);
      } else {               // rows k, 16 codes along n
        const int k = k0 + c / (BN / 16), n = n0 + (c % (BN / 16)) * 16;
        if (k < K && n < N)
          wr[p] = *reinterpret_cast<const uint4*>(
              q + static_cast<long>(k) * ldq + n);
      }
    }
  };
  // registers -> shared stage s, the codes converted to bf16
  auto store = [&](int s) {
    __nv_bfloat16* xs = smem + s * C::kStage;
    __nv_bfloat16* ws = xs + C::kXElems;
#pragma unroll
    for (int p = 0; p < C::kXPer; ++p) {
      const int c = tid + p * C::kThreads;
      *reinterpret_cast<uint4*>(xs + (c / (kBK / 8)) * C::kLdx +
                                (c % (kBK / 8)) * 8) = xr[p];
    }
#pragma unroll
    for (int p = 0; p < C::kWPer; ++p) {
      const int c = tid + p * C::kThreads;
      const int per_row = kTrans ? kBK / 16 : BN / 16;
      store_i8x16(wr[p], ws + (c / per_row) * C::kLdw + (c % per_row) * 16);
    }
  };

  const int n_k = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) load((kt + 1) * kBK);
    const __nv_bfloat16* xs = smem + cur * C::kStage;
    const __nv_bfloat16* ws = xs + C::kXElems;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[C::kFm];
#pragma unroll
      for (int i = 0; i < C::kFm; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wm * WM + i * 16) * C::kLdx +
                                          kk * 16, C::kLdx);
#pragma unroll
      for (int j = 0; j < C::kFn; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB>
            fb;
        const int n = wn * WN + j * 16;
        wmma::load_matrix_sync(
            fb, kTrans ? ws + n * C::kLdw + kk * 16
                       : ws + (kk * 16) * C::kLdw + n, C::kLdw);
#pragma unroll
        for (int i = 0; i < C::kFm; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    if (kt + 1 < n_k) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: each warp parks one 16 x 16 f32 tile at a time in its own
  // scratch (the stages are free after the last barrier), scales it per
  // column, rounds to bf16 and writes 8 columns per lane
  float* scr = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < C::kFm; ++i)
#pragma unroll
    for (int j = 0; j < C::kFn; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * WM + i * 16 + r;
      const int col = n0 + wn * WN + j * 16 + c;
      if (row < T && col < N) {
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float a = scr[r * 16 + c + e], b = scr[r * 16 + c + e + 1];
          if (scale != nullptr) {
            a *= scale[col + e];
            b *= scale[col + e + 1];
          }
          __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
          packed[e / 2] = *reinterpret_cast<uint32_t*>(&p);
        }
        *reinterpret_cast<uint4*>(out + static_cast<long>(row) * N + col) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      __syncwarp();
    }
}

template <int BM, int BN, int WM, int WN, bool kTrans>
void launch(const __nv_bfloat16* x, const int8_t* q, const float* scale,
            __nv_bfloat16* out, int T, int K, int N, long ldq,
            cudaStream_t st) {
  using C = Cfg<BM, BN, WM, WN, kTrans>;
  dim3 grid((T + BM - 1) / BM, (N + BN - 1) / BN);
  dequant_mm_kernel<BM, BN, WM, WN, kTrans><<<grid, C::kThreads, 0, st>>>(
      x, q, scale, out, T, K, N, ldq);
}

}  // namespace

// out (T, N) bf16 = bf16((x (T, K) · q) * scale).  trans_q = 0: q element
// (k, n) at q[k * ldq + n]; trans_q = 1: at q[n * ldq + k].  scale may be
// null (unit scales: the backward's dx).  small = 1 takes the 64 x 64
// tile (the wrapper picks it when 128 x 128 tiles would not give every SM
// a CTA).
extern "C" int dequant_matmul_launch(const void* x, const void* q,
                                     const void* scale, void* out, int T,
                                     int K, int N, long ldq, int trans_q,
                                     int small, void* stream) {
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto qp = static_cast<const int8_t*>(q);
  auto sp = static_cast<const float*>(scale);
  auto op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (small) {
    if (trans_q)
      launch<64, 64, 32, 32, true>(xp, qp, sp, op, T, K, N, ldq, st);
    else
      launch<64, 64, 32, 32, false>(xp, qp, sp, op, T, K, N, ldq, st);
  } else {
    if (trans_q)
      launch<128, 128, 32, 64, true>(xp, qp, sp, op, T, K, N, ldq, st);
    else
      launch<128, 128, 32, 64, false>(xp, qp, sp, op, T, K, N, ldq, st);
  }
  return static_cast<int>(cudaGetLastError());
}
