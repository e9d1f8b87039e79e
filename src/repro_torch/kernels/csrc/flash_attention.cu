// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd /
// _flash_fwd_kernel, the Pallas TPU online-softmax kernel over a flat
// (batch*heads) layout.
//
//   o = softmax(q k^T * hd^-0.5 [causal mask]) v
//
// q (BH, Sq, hd) bf16, k (BH / groups, Skv, hd) bf16 and v (BH / groups,
// Skv, vd) bf16 -> o (BH, Sq, vd) bf16 and lse (BH, Sq) f32, the
// log-sum-exp of each row's scaled scores (m + log l, what
// _chunked_attention_fwd returns beside the output and what the training
// backward recomputes p from), at the (hd, vd) pairs (32, 32), (64, 64),
// (128, 128), (192, 128) (MLA: q/k of nope 128 + rope 64, v of 128) and
// (80, 80) (hubert-xlarge), one instantiation each.  The TPU kernel takes
// any hd and vd; these are the pairs the model configs reach.  Query head
// bh reads kv head bh / groups, so GQA needs no repeated copy of k and v.
// Arithmetic follows the TPU kernel: scores in f32, masked keys at -1e30,
// running max m, running sum l of the f32 probabilities, p rounded to
// bf16 before the p·v product, the f32 accumulator rounded once at the
// end, rows with l == 0 divided by 1; kv tiles strictly above the
// diagonal are skipped.
//
// Bound on the H100: at the training and serving shapes (S 192..512) the
// work is ~S/2 flops per byte of q, k, v and o, under the 295 flop/byte
// ridge, so bytes bound it, and the S x S scores must never reach device
// memory.  What the design does about it:
//   * one warpgroup (128 threads) per 64 query rows of one head;
//     S = Q·K^T is a wgmma m64n64k16 chain (hd / 16 k-steps, bf16, f32
//     accumulate) with Q and K read from shared memory; the online
//     softmax runs on the accumulator registers, whose layout is fixed (a
//     thread holds two rows, a quad of lanes shares a row), so the row
//     max and sum are two shuffles and the rescale of O happens in
//     registers; P is converted in registers to the bf16 A fragments of
//     the second wgmma chain, O += P·V (m64n{tile vd}k16: 16, 32 or 64
//     accumulator registers a thread), with V read from shared memory as
//     an MN-major B operand.  S, P and O never touch shared memory;
//   * a tile row is 64 bytes at width 32 (the 64-byte swizzle), 128 at
//     width 64 (the 128-byte swizzle), and two or three 128-byte column
//     parts at widths 128 and 192 (each part its own 128-byte-swizzled
//     block; the k-steps of S walk the parts, P·V's descriptor steps
//     between them by its leading byte offset).  Q and K take the tile of
//     hd, V and O the tile of vd: at (192, 128) S has 12 k-steps over
//     three parts and O is the 128-wide accumulator;
//   * width 80 (160-byte rows, which fit no swizzle atom) sits in the
//     128-wide tile with columns 80..127 zero-filled by the copies
//     themselves (cp.async with source size 0), in shared memory only:
//     S takes the 5 k-steps of the 80 real columns, P·V runs at n128 and
//     the 48 zero columns of O are never stored.  No padded copy of q, k
//     or v is made in device memory;
//   * K/V tiles of 64 keys come through a two-stage ring: 16-byte
//     cp.async copies into the swizzled layout wgmma reads, each stage
//     completed by an mbarrier that every thread's copies arrive on
//     (cp.async.mbarrier.arrive.noinc), so the copies of tile j + 1
//     overlap the math of tile j; rows past Skv are zero-filled;
//   * only the diagonal tile and the tile that holds Skv are masked, and
//     the longest causal query tiles are launched first;
//   * the output goes back through shared memory (the Q tile's, free by
//     then, at least as large as the O tile) to leave the CTA as
//     coalesced 16-byte rows.
// A row's output and lse depend only on its own q and its keys up to the
// causal frontier, at every width: the tile grid is fixed by absolute
// positions, masked keys add exact zeros, the instruction shapes are
// fixed by (hd, vd) alone, and no sum crosses rows or CTAs -- not on Sq,
// Skv or BH.  No atomics, no split over keys.
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace repro::sm90;

constexpr int kBQ = 64;            // query rows per CTA: one wgmma M
constexpr int kBK = 64;            // keys per tile: the wgmma N of S
constexpr int kThreads = 128;      // one warpgroup
constexpr float kNegBig = -1e30f;  // the reference's NEG_BIG

// the tile width that holds rows of width d: 80 sits in the 128 tile
__host__ __device__ constexpr int tile_width(int d) {
  return d == 80 ? 128 : d;
}

// The shared-memory geometry of a 64-row tile of TW columns.
template <int TW>
struct Tile {
  static constexpr int kRowB = TW * 2 < 128 ? TW * 2 : 128;  // swizzle
  static constexpr int kParts = TW * 2 / kRowB;   // 128-byte column parts
  static constexpr int kPartB = 64 * kRowB;       // bytes of one part
  static constexpr int kBytes = kParts * kPartB;  // 64 * TW * 2
  static constexpr int kChunks = TW / 8;          // 16-byte chunks a row
  static constexpr int kPartChunks = kRowB / 16;
  static_assert(TW == 32 || TW == 64 || TW == 128 || TW == 192,
                "tile width");

  // chunk j (8 columns) of row r
  static __device__ __forceinline__ uint32_t at(uint32_t tile, int r,
                                                int j) {
    return swz<kRowB>(tile + (j / kPartChunks) * kPartB, r,
                      j % kPartChunks);
  }
  // the operand of k-step kk (16 columns, 32 bytes) of a K-major tile
  static __device__ __forceinline__ uint64_t kstep(uint32_t tile, int kk) {
    const int byte = kk * 32;
    return desc<kRowB>(tile + (byte / kRowB) * kPartB + byte % kRowB,
                       8 * kRowB);
  }
  // keys 16 kk.. of an MN-major V tile, all TW columns
  static __device__ __forceinline__ uint64_t vstep(uint32_t tile, int kk) {
    return desc<kRowB>(tile + kk * 16 * kRowB, kPartB);
  }
};

// rows [r0, r0 + 64) of a (rows, W) bf16 matrix into a swizzled tile of
// TW >= W columns; rows at and past n_rows and columns at and past W
// become zeros
template <int TW, int W>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int r0,
                                          int n_rows) {
  using G = Tile<TW>;
  for (int i = threadIdx.x; i < kBK * G::kChunks; i += kThreads) {
    const int r = i / G::kChunks, j = i % G::kChunks;
    const bool in = r0 + r < n_rows && j < W / 8;
    cp_async16(G::at(tile, r, j),
               in ? src + static_cast<long>(r0 + r) * W + j * 8 : src, in);
  }
}

// The accumulator layout of m64nNk16 (f32): see hopper.cuh.
template <int HD, int VD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int BH, int Sq, int Skv, int groups, int causal,
                 float scale) {
  constexpr int TQ = tile_width(HD), TV = tile_width(VD);
  using GQ = Tile<TQ>;
  using GV = Tile<TV>;
  static_assert(GQ::kBytes >= GV::kBytes, "O leaves through the Q tile");
  constexpr int kAccO = TV / 2;            // O accumulator registers
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;                 // then K[0], K[1], V[0], V[1]
  auto sK = [base](int st) { return base + (1 + st) * GQ::kBytes; };
  auto sV = [base](int st) {
    return base + 3 * GQ::kBytes + st * GV::kBytes;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gbase + 3 * GQ::kBytes + 2 * GV::kBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int q0 = qt * kBQ;
  const __nv_bfloat16* qb = q + static_cast<long>(bh) * Sq * HD;
  const __nv_bfloat16* kb = k + static_cast<long>(bh / groups) * Skv * HD;
  const __nv_bfloat16* vb = v + static_cast<long>(bh / groups) * Skv * VD;

  if (tid == 0) {
    mbar_init(&full[0], kThreads);
    mbar_init(&full[1], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int n_kv = (Skv + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, qt + 1);

  // stage 0: Q with the first K/V tile
  load_tile<TQ, HD>(sQ, qb, q0, Sq);
  load_tile<TQ, HD>(sK(0), kb, 0, Skv);
  load_tile<TV, VD>(sV(0), vb, 0, Skv);
  mbar_arrive_copies(&full[0]);

  const int ra = warp * 16 + lane / 4;           // this thread's rows:
  const int qa = q0 + ra, qb8 = qa + 8;          // ra and ra + 8
  const int cq = 2 * (lane % 4);                 // first column in a block
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.0f, l_b = 0.0f;
  float acc_o[kAccO];
#pragma unroll
  for (int i = 0; i < kAccO; ++i) acc_o[i] = 0.0f;

  for (int j = 0; j < n_kv; ++j) {
    const int s = j & 1;
    const int kv0 = j * kBK;
    if (j + 1 < n_kv) {                   // the next tile, into the stage
      load_tile<TQ, HD>(sK(s ^ 1), kb, kv0 + kBK, Skv);   // freed at j - 1
      load_tile<TV, VD>(sV(s ^ 1), vb, kv0 + kBK, Skv);
      mbar_arrive_copies(&full[s ^ 1]);
    }
    mbar_wait(&full[s], (j >> 1) & 1);
    fence_proxy_async();

    // ---- S = Q K^T (64 x 64, f32) over the HD real columns
    float acc_s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)       // 32 bytes of K per step
      wgmma_ss<0>(acc_s, GQ::kstep(sQ, kk), GQ::kstep(sK(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    // ---- online softmax on the accumulator registers
    const bool masked = (causal && kv0 + kBK - 1 > q0) || kv0 + kBK > Skv;
    float mx_a = kNegBig, mx_b = kNegBig;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = acc_s[4 * i + e] * scale;
        if (masked) {
          const int kpos = kv0 + 8 * i + cq + (e & 1);
          const int qpos = e < 2 ? qa : qb8;
          if (kpos >= Skv || (causal && kpos > qpos)) x = kNegBig;
        }
        acc_s[4 * i + e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
    // a quad of lanes holds one row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(acc_s[4 * i + e] - (e < 2 ? mn_a : mn_b));
        acc_s[4 * i + e] = p;
        if (e < 2) sum_a += p;
        else sum_b += p;
      }
    }
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int i = 0; i < kAccO / 4; ++i) {
      acc_o[4 * i] *= corr_a;
      acc_o[4 * i + 1] *= corr_a;
      acc_o[4 * i + 2] *= corr_b;
      acc_o[4 * i + 3] *= corr_b;
    }

    // ---- O += P V: P as bf16 A fragments straight from the S registers
    // (keys 16 kk.. of the S layout are the A layout of k-step kk); the
    // fragments stay live until the chain is done, wgmma reads them late
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h)
        pf[kk][h] = pack_bf16(acc_s[8 * kk + 2 * h], acc_s[8 * kk + 2 * h + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)   // 16 keys a step
      wgmma_rs(acc_o, pf[kk], GV::vstep(sV(s), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) asm volatile("" : "+r"(pf[kk][h]) :: "memory");
    }
    __syncthreads();                      // stage s is free for tile j + 2
  }

  // ---- out = O / l in bf16, through the Q tile's shared memory
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const float den_a = l_a == 0.0f ? 1.0f : l_a;
  const float den_b = l_b == 0.0f ? 1.0f : l_b;
  const float inv_a = 1.0f / den_a, inv_b = 1.0f / den_b;
#pragma unroll
  for (int i = 0; i < kAccO / 4; ++i) {
    const uint32_t lo = pack_bf16(acc_o[4 * i] * inv_a, acc_o[4 * i + 1] * inv_a);
    const uint32_t hi = pack_bf16(acc_o[4 * i + 2] * inv_b,
                                  acc_o[4 * i + 3] * inv_b);
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(GV::at(sQ, ra, i) + cq * 2), "r"(lo) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(GV::at(sQ, ra + 8, i) + cq * 2), "r"(hi) : "memory");
  }
  if (lane % 4 == 0) {
    if (qa < Sq) lse[static_cast<long>(bh) * Sq + qa] = m_a + logf(den_a);
    if (qb8 < Sq) lse[static_cast<long>(bh) * Sq + qb8] = m_b + logf(den_b);
  }
  __syncthreads();
  __nv_bfloat16* ob = o + static_cast<long>(bh) * Sq * VD;
  constexpr int kOutChunks = VD / 8;       // the real columns only
  for (int i = tid; i < kBQ * kOutChunks; i += kThreads) {
    const int r = i / kOutChunks, jc = i % kOutChunks;
    if (q0 + r >= Sq) continue;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(GV::at(sQ, r, jc)) : "memory");
    *reinterpret_cast<uint4*>(ob + static_cast<long>(q0 + r) * VD + jc * 8) =
        val;
  }
}

template <int HD, int VD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int Sq, int Skv, int groups, int causal, float scale,
           cudaStream_t stream) {
  // Q, K[2], V[2], the two stage barriers, + room to align to 1 KB
  constexpr int bytes = 3 * Tile<tile_width(HD)>::kBytes
                        + 2 * Tile<tile_width(VD)>::kBytes + 2 * 8 + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, VD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<HD, VD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), BH, Sq, Skv, groups, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o,
                                          void* lse, int BH,
                                          int Sq, int Skv, int hd, int vd,
                                          int groups, int causal,
                                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_PAIR(H, V)                                              \
  if (hd == H && vd == V)                                                   \
    return launch<H, V>(q, k, v, o, lse, BH, Sq, Skv, groups, causal, scale, \
                        st);
  REPRO_FLASH_PAIR(32, 32)
  REPRO_FLASH_PAIR(64, 64)
  REPRO_FLASH_PAIR(128, 128)
  REPRO_FLASH_PAIR(192, 128)
  REPRO_FLASH_PAIR(80, 80)
#undef REPRO_FLASH_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
