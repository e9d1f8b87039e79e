// The quantized backbone's dequant-matmul for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_lora.py, dequant_matmul_pallas /
// _dequant_mm_kernel, and the second launch of its custom VJP
// (src/repro/kernels/ops.py, _make_dequant_pallas_fn):
//
//   y = bf16((x · q) * scale)      x (T, K) bf16, q (K, N) int8,
//                                  scale (N,) f32 or none (unit scales)
//
// q is read through its strides, either as stored (element (k, n) at
// q[k * ldq + n]: the forward, q (d_in, d_out)) or transposed in place
// (element (k, n) at q[n * ldq + k]: the backward's dx = dys · q^T, q
// still the (d_in, d_out) codes); one kernel template serves both.  No
// bf16 copy of q ever reaches device memory: halving the weight bytes is
// the point.
//
// Bound on the H100: at training shapes (T = 8192) operations (2 T K N
// flops against T K + T N bf16 and K N int8 bytes: 0.07-0.19 ms a call at
// the bf16 tensor-core peak); at decode (64 rows) bytes, nearly all of
// them the int8 codes.  What the design does about it:
//   * wgmma: a CTA computes a 256-token x 128-column output tile; two
//     consumer warpgroups of 128 tokens each run, per 16-deep k-step, two
//     m64n128k16 products (bf16, f32 accumulate in 2 x 64 registers a
//     thread) that share one B operand;
//   * TMA: one thread of the producer warpgroup does nothing but load,
//     64-deep steps ahead of their use: the x tile (256 x 64 bf16) in the
//     128-byte swizzle wgmma reads, into a four-stage ring that the
//     consumers release; the q tile as int8 (8 KB: half of what a bf16
//     tile would take) into a six-stage ring that the conversion
//     releases, so the codes -- at decode the whole of the traffic -- run
//     up to six steps ahead.  Each load completes on its stage's
//     mbarrier; rows, columns and steps past T, N and K arrive as zeros;
//   * the conversion: the producer's other three warps turn each step's
//     codes into a swizzled bf16 tile (three of them, so the conversion
//     runs up to two steps ahead of the products) and signal the
//     consumers, which release a tile when its products are done.  wgmma
//     reads both operands from shared memory (SS).  The register-A
//     alternative (y^T = q^T · x^T with the codes as A fragments) needs,
//     for each thread, 2-byte pieces of four 8-byte groups of a code row
//     per k-step, which no 16-byte load or byte permute delivers in fewer
//     instructions than converting the tile once; the SS tile is
//     converted once for all 256 tokens.  Codes become bf16 by the exact
//     magic-number route: byte into the mantissa of 2^23 (prmt), subtract
//     2^23 + 128 (the sign bit flipped first), keep the top half (prmt)
//     -- values in -128..127 are exact;
//   * every hand-off between the three roles polls its mbarrier with a
//     short sleep (a suspended wait resumes hundreds of cycles late, a
//     step here is about a thousand);
//   * the column tiles vary fastest over the grid, so the CTAs resident
//     at one time share a few x row blocks and all of q in L2;
//   * the forward's stored q is an MN-major B operand (features along
//     the 128-byte rows, two 64-feature parts), the backward's q^T a
//     K-major one: only the tensor map and the descriptor differ;
//   * the epilogue multiplies the f32 sum by the column's scale, rounds
//     once to bf16, and leaves through shared memory as 16-byte rows.
// Row invariance: the tile shape, the instruction shapes and the k order
// are fixed, never chosen by T; rows past T are zero-filled and not
// stored; no split of K, no atomics.  A row's output depends on its x
// row, q, the scale, K and N only, so a 16-row call and an 8192-row call
// give its row the same bits (what keeps fused and solo serving equal).
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace repro::sm90;

constexpr int kBM = 256;                 // tokens a CTA: 2 x 128
constexpr int kBN = 128;                 // output columns a CTA
constexpr int kBK = 64;                  // contraction depth a step
constexpr int kXStages = 4;              // x ring
constexpr int kQStages = 6;              // code ring
constexpr int kConv = 3;                 // converted bf16 tiles
constexpr int kThreads = 384;            // producer + two consumers
constexpr int kXBytes = kBM * kBK * 2;   // 32 KB, 128-byte swizzle
constexpr int kQBytes = kBK * kBN;       // 8 KB of codes
constexpr int kCBytes = kBK * kBN * 2;   // 16 KB bf16
constexpr int kOffQ = kXStages * kXBytes;
constexpr int kOffConv = kOffQ + kQStages * kQBytes;
constexpr int kOffBar = kOffConv + kConv * kCBytes;
constexpr int kConvThreads = 96;         // warps 1-3 of the producer
// xfull[kXStages], xempty[kXStages], qfull[kQStages], qempty[kQStages],
// ready[kConv], freed[kConv]
constexpr int kBars = 2 * kXStages + 2 * kQStages + 2 * kConv;
constexpr int kSmem = kOffBar + kBars * 8;
constexpr int kLdo = kBN + 8;            // epilogue row (bf16): 272 B
static_assert(kBM * kLdo * 2 <= kOffConv, "epilogue tile in the rings");
static_assert(kSmem + 1024 <= 232448, "shared memory");

// 4 int8 codes -> 4 bf16 (two packed pairs), exactly
__device__ __forceinline__ uint2 i8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;                // x + 128, unsigned
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b));
    f[b] -= 8388736.0f;                              // 2^23 + 128
  }
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// One step's codes as the bf16 B operand in tile ``conv``, by the
// producer's kConvThreads converting threads (qs and conv: byte offsets
// from the aligned base ``sb``): stored q (64 k-rows of 128 codes, as
// TMA lands them) becomes an MN-major tile (two 64-column parts, each 64
// k-rows of 128 bytes); transposed q^T (128 column rows of 64 codes) a
// K-major one (128 rows of 64 k, 128 bytes each).  A thread's loads
// first, then its conversions and stores, so that they overlap.
template <bool kTrans>
__device__ __forceinline__ void convert(unsigned char* sb, uint32_t qs,
                                        uint32_t conv, int pt) {
  constexpr int kChunks = kQBytes / 16;
  constexpr int kPer = (kChunks + kConvThreads - 1) / kConvThreads;
  uint4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = pt + kConvThreads * i;
    if (c < kChunks)
      v[i] = *reinterpret_cast<const uint4*>(sb + qs + c * 16);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = pt + kConvThreads * i;
    if (c >= kChunks) break;
    const uint2 a = i8x4_bf16(v[i].x), b = i8x4_bf16(v[i].y);
    const uint2 e = i8x4_bf16(v[i].z), f = i8x4_bf16(v[i].w);
    uint32_t lo, hi;
    if constexpr (kTrans) {
      const int nr = c / (kBK / 16), j = c % (kBK / 16);
      lo = swz<128>(conv, nr, 2 * j);
      hi = swz<128>(conv, nr, 2 * j + 1);
    } else {
      const int kr = c / (kBN / 16), j = c % (kBN / 16);
      const uint32_t part = conv + (j / 4) * (kBK * 128);
      lo = swz<128>(part, kr, 2 * (j % 4));
      hi = swz<128>(part, kr, 2 * (j % 4) + 1);
    }
    *reinterpret_cast<uint4*>(sb + lo) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(sb + hi) = make_uint4(e.x, e.y, f.x, f.y);
  }
}

// k-step kk (16 deep) of the converted tile
template <bool kTrans>
__device__ __forceinline__ uint64_t b_desc(uint32_t conv, int kk) {
  if constexpr (kTrans)           // K-major: 32 bytes along each row
    return desc<128>(conv + kk * 32, 1024);
  else                            // MN-major: 16 k-rows; parts 8 KB apart
    return desc<128>(conv + kk * 16 * 128, kBK * 128);
}

template <bool kTrans>
__global__ void __launch_bounds__(kThreads, 1)
dequant_mm_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_q,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int T, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms
  unsigned char* sb = smem_raw + (base - raw);       // the same, generic
  uint64_t* xfull = reinterpret_cast<uint64_t*>(sb + kOffBar);
  uint64_t* xempty = xfull + kXStages;   // a step's products are done
  uint64_t* qfull = xempty + kXStages;
  uint64_t* qempty = qfull + kQStages;   // a step's codes are read
  uint64_t* ready = qempty + kQStages;   // a step's codes are converted
  uint64_t* freed = ready + kConv;       // a bf16 tile's products done

  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_k = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], 256);
    }
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], kConvThreads);
    }
    for (int c = 0; c < kConv; ++c) {
      mbar_init(&ready[c], kConvThreads);
      mbar_init(&freed[c], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if (tid == 0) {
      // ---- loads, one thread: each step's codes once the converters
      // read the codes kQStages steps back, its x once the consumers
      // released the x kXStages steps back
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tm_q)) : "memory");
      for (int i = 0; i < n_k; ++i) {
        const int qs = i % kQStages, xs = i % kXStages;
        if (i >= kQStages) mbar_spin(&qempty[qs], (i / kQStages - 1) & 1);
        mbar_expect_tx(&qfull[qs], kQBytes);
        if constexpr (kTrans)
          tma_load2(base + kOffQ + qs * kQBytes, &tm_q, i * kBK, n0,
                   &qfull[qs]);
        else
          tma_load2(base + kOffQ + qs * kQBytes, &tm_q, n0, i * kBK,
                   &qfull[qs]);
        if (i >= kXStages) mbar_spin(&xempty[xs], (i / kXStages - 1) & 1);
        mbar_expect_tx(&xfull[xs], kXBytes);
        tma_load2(base + xs * kXBytes, &tm_x, i * kBK, m0, &xfull[xs]);
      }
    }
    if (tid < 32) return;
    // ---- conversion, warps 1-3
    const int pt = tid - 32;
    for (int j = 0; j < n_k; ++j) {
      const int s = j % kQStages, c = j % kConv;
      mbar_spin(&qfull[s], (j / kQStages) & 1);
      if (j >= kConv) mbar_spin(&freed[c], (j / kConv - 1) & 1);
      convert<kTrans>(sb, kOffQ + s * kQBytes, kOffConv + c * kCBytes, pt);
      fence_proxy_async();        // the converted codes, to wgmma
      mbar_arrive(&ready[c]);
      mbar_arrive(&qempty[s]);    // this thread's codes of step j are read
    }
    return;
  }

  // ---- consumers: 128 token rows each, two 64-row blocks
  const int cw = wg - 1, ct = tid - 128;
  const int warp = (ct % 128) / 32, lane = ct % 32;
  const bool in0 = m0 + cw * 128 < T, in1 = m0 + cw * 128 + 64 < T;
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.0f;
  for (int j = 0; j < n_k; ++j) {
    const int s = j % kXStages, c = j % kConv;
    mbar_spin(&xfull[s], (j / kXStages) & 1);   // the x tile
    mbar_spin(&ready[c], (j / kConv) & 1);      // the converted codes
    if (in0) {
      const uint32_t xs = base + s * kXBytes + cw * 128 * 128;
      const uint32_t conv = base + kOffConv + c * kCBytes;
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t bd = b_desc<kTrans>(conv, kk);
        wgmma_ss<kTrans ? 0 : 1>(acc0, desc<128>(xs + kk * 32, 1024), bd, 1);
        if (in1)
          wgmma_ss<kTrans ? 0 : 1>(
              acc1, desc<128>(xs + 64 * 128 + kk * 32, 1024), bd, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();            // step j - 1's products are done
      fence_regs(acc0);
      fence_regs(acc1);
    }
    if (j > 0) {
      mbar_arrive(&xempty[(j - 1) % kXStages]);
      mbar_arrive(&freed[(j - 1) % kConv]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  // both consumers' products are done: the rings take the output tile
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  // ---- scale, round once, stage the tile, leave as 16-byte rows
  const int cq = 2 * (lane % 4);
  auto stage_rows = [&](const float (&acc)[64], int h) {
    const int ra = cw * 128 + h * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = n0 + 8 * i + cq;
      float s0 = 1.0f, s1 = 1.0f;
      if (scale != nullptr && col < N) {
        s0 = scale[col];
        s1 = scale[col + 1];
      }
      unsigned char* at = sb + (ra * kLdo + 8 * i + cq) * 2;
      *reinterpret_cast<uint32_t*>(at) =
          pack_bf16(acc[4 * i] * s0, acc[4 * i + 1] * s1);
      *reinterpret_cast<uint32_t*>(at + 8 * kLdo * 2) =
          pack_bf16(acc[4 * i + 2] * s0, acc[4 * i + 3] * s1);
    }
  };
  stage_rows(acc0, 0);
  stage_rows(acc1, 1);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int c = ct; c < kBM * (kBN / 8); c += 256) {
    const int r = c / (kBN / 8), j = c % (kBN / 8);
    if (m0 + r >= T || n0 + j * 8 >= N) continue;
    *reinterpret_cast<uint4*>(out + static_cast<long>(m0 + r) * N + n0 +
                              j * 8) =
        *reinterpret_cast<const uint4*>(sb + (r * kLdo + j * 8) * 2);
  }
}

// a 2-D map of a row-major (rows, cols) matrix with a row stride of
// ``ld`` elements, read in (box_rows, box_cols) boxes
bool make_map2(CUtensorMap* tm, CUtensorMapDataType type, const void* p,
               long rows, long cols, long ld, int elem, int box_rows,
               int box_cols, CUtensorMapSwizzle swizzle) {
  const long dims[2] = {cols, rows}, strides[1] = {ld};
  const int box[2] = {box_cols, box_rows};
  return make_map(tm, type, p, 2, dims, strides, elem, box, swizzle);
}

template <bool kTrans>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_q,
                   const float* scale, __nv_bfloat16* out, int T, int K,
                   int N, dim3 grid, cudaStream_t st) {
  constexpr int bytes = kSmem + 1024;        // + room to align to 1 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      dequant_mm_kernel<kTrans>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  dequant_mm_kernel<kTrans><<<grid, kThreads, bytes, st>>>(tm_x, tm_q, scale,
                                                          out, T, K, N);
  return cudaGetLastError();
}

}  // namespace

// out (T, N) bf16 = bf16((x (T, K) · q) * scale).  trans_q = 0: q element
// (k, n) at q[k * ldq + n]; trans_q = 1: at q[n * ldq + k].  scale may be
// null (unit scales: the backward's dx).  One kBM x kBN tile shape for
// every T, the grid one CTA per output tile; a CUDA library without
// tensor maps is refused.
extern "C" int dequant_matmul_launch(const void* x, const void* q,
                                     const void* scale, void* out, int T,
                                     int K, int N, long ldq, int trans_q,
                                     void* stream) {
  CUtensorMap tm_x, tm_q;
  bool ok = make_map2(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, T, K, K, 2,
                      kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && (trans_q ? make_map2(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N,
                                  K, ldq, 1, kBN, kBK,
                                  CU_TENSOR_MAP_SWIZZLE_NONE)
                      : make_map2(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K,
                                  N, ldq, 1, kBK, kBN,
                                  CU_TENSOR_MAP_SWIZZLE_NONE));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  const auto sp = static_cast<const float*>(scale);
  const auto op = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      trans_q ? launch<true>(tm_x, tm_q, sp, op, T, K, N, grid, st)
              : launch<false>(tm_x, tm_q, sp, op, T, K, N, grid, st);
  return static_cast<int>(err);
}
