// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd /
// _flash_fwd_kernel, the Pallas TPU online-softmax kernel over a flat
// (batch*heads) layout.
//
//   o = softmax(q k^T * hd^-0.5 [causal mask]) v
//
// q (BH, Sq, 64) bf16, k/v (BH / groups, Skv, 64) bf16 -> o (BH, Sq, 64)
// bf16 and lse (BH, Sq) f32, the log-sum-exp of each row's scaled scores
// (m + log l, what _chunked_attention_fwd returns beside the output and
// what the training backward recomputes p from).  Query head bh reads kv
// head bh / groups, so GQA needs no repeated copy of k and v.  Arithmetic
// follows the TPU kernel: scores in f32, masked keys at -1e30, running
// max m, running sum l of the f32 probabilities, p rounded to bf16 before
// the p·v product, the f32 accumulator rounded once at the end, rows with
// l == 0 divided by 1; kv tiles strictly above the diagonal are skipped.
//
// Bound on the H100: at the training and serving shapes (S 192..512, hd
// 64) the work is ~S/2 flops per byte of q, k, v and o, under the 295
// flop/byte ridge, so bytes bound it, and the S x S scores must never
// reach device memory.  What the design does about it:
//   * one warpgroup (128 threads) per 64 query rows of one head;
//     S = Q·K^T is a wgmma m64n64k16 chain (bf16, f32 accumulate) with Q
//     and K read from shared memory; the online softmax runs on the
//     accumulator registers, whose layout is fixed (a thread holds two
//     rows, a quad of lanes shares a row), so the row max and sum are two
//     shuffles and the rescale of O happens in registers; P is converted
//     in registers to the bf16 A fragments of the second wgmma chain,
//     O += P·V, with V read from shared memory as an MN-major B operand.
//     S, P and O never touch shared memory;
//   * K/V tiles of 64 keys come through a two-stage ring: 16-byte
//     cp.async copies into the 128-byte-swizzled layout wgmma reads,
//     each stage completed by an mbarrier that every thread's copies
//     arrive on (cp.async.mbarrier.arrive.noinc), so the copies of tile
//     j + 1 overlap the math of tile j; rows past Skv are zero-filled;
//   * only the diagonal tile and the tile that holds Skv are masked, and
//     the longest causal query tiles are launched first;
//   * the output goes back through shared memory (the Q tile's, free by
//     then) to leave the CTA as coalesced 16-byte rows.
// A row's output and lse depend only on its own q and its keys up to the
// causal frontier: the tile grid is fixed by absolute positions, masked
// keys add exact zeros, and no sum crosses rows or CTAs -- not on Sq,
// Skv or BH.  No atomics, no split over keys.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kHd = 64;            // head dim: one 128-byte swizzled row
constexpr int kBQ = 64;            // query rows per CTA: one wgmma M
constexpr int kBK = 64;            // keys per tile: the wgmma N of S
constexpr int kThreads = 128;      // one warpgroup
constexpr int kTileBytes = kBQ * kHd * 2;    // 8 KB, 1024-byte aligned
constexpr float kNegBig = -1e30f;  // the reference's NEG_BIG

// shared memory: Q, K[2], V[2] tiles, then the two stage barriers
constexpr int kSmemBytes = 5 * kTileBytes + 2 * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte chunk j of row r of a 64 x 64 bf16 tile in the 128-byte swizzle
// (what wgmma's B128 layout reads): chunk j sits at j ^ (r % 8).
__device__ __forceinline__ uint32_t swz(uint32_t tile, int r, int j) {
  return tile + r * 128 + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// rows [r0, r0 + 64) of a (rows, 64) bf16 matrix into a swizzled tile;
// rows at and past n_rows become zeros
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int r0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < kBK * 8; i += kThreads) {
    const int r = i / 8, j = i % 8;
    const bool in = r0 + r < n_rows;
    cp_async16(swz(tile, r, j),
               in ? src + static_cast<long>(r0 + r) * kHd + j * 8 : src, in);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// arrives on *bar once all of this thread's earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (B128).  Both
// offsets are 1024 bytes, one 8-row swizzle atom: the stride between
// 8-row groups; the leading offset is unused for a 64-wide bf16 tile.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(64) << 16)
         | (static_cast<uint64_t>(64) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the accumulator registers are written asynchronously: pin every use
// after the wait
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define WGMMA_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define WGMMA_D32_OPS(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
      "+f"(d[30]), "+f"(d[31])

// d (+)= A·B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, m64n64k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator layout of m64nNk16 (f32): thread t = 32 w + l holds
// rows 16 w + l / 4 (elements 4 i, 4 i + 1) and that + 8 (elements
// 4 i + 2, 4 i + 3), columns 8 i + 2 (l % 4) and + 1, i < N / 8.
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int BH, int Sq, int Skv, int groups, int causal,
                 float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;                 // then K[0], K[1], V[0], V[1]
  auto sK = [base](int st) { return base + (1 + st) * kTileBytes; };
  auto sV = [base](int st) { return base + (3 + st) * kTileBytes; };
  uint64_t* full = reinterpret_cast<uint64_t*>(gbase + 5 * kTileBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int q0 = qt * kBQ;
  const __nv_bfloat16* qb = q + static_cast<long>(bh) * Sq * kHd;
  const __nv_bfloat16* kb = k + static_cast<long>(bh / groups) * Skv * kHd;
  const __nv_bfloat16* vb = v + static_cast<long>(bh / groups) * Skv * kHd;

  if (tid == 0) {
    mbar_init(&full[0], kThreads);
    mbar_init(&full[1], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int n_kv = (Skv + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, qt + 1);

  // stage 0: Q with the first K/V tile
  load_tile(sQ, qb, q0, Sq);
  load_tile(sK(0), kb, 0, Skv);
  load_tile(sV(0), vb, 0, Skv);
  mbar_arrive_copies(&full[0]);

  const int ra = warp * 16 + lane / 4;           // this thread's rows:
  const int qa = q0 + ra, qb8 = qa + 8;          // ra and ra + 8
  const int cq = 2 * (lane % 4);                 // first column in a block
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.0f, l_b = 0.0f;
  float acc_o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_o[i] = 0.0f;

  for (int j = 0; j < n_kv; ++j) {
    const int s = j & 1;
    const int kv0 = j * kBK;
    if (j + 1 < n_kv) {                   // the next tile, into the stage
      load_tile(sK(s ^ 1), kb, kv0 + kBK, Skv);   // freed at j - 1
      load_tile(sV(s ^ 1), vb, kv0 + kBK, Skv);
      mbar_arrive_copies(&full[s ^ 1]);
    }
    mbar_wait(&full[s], (j >> 1) & 1);
    // the generic-proxy copies, seen by wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

    // ---- S = Q K^T (64 x 64, f32)
    float acc_s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)      // 32 bytes of K per step
      wgmma_ss(acc_s, desc_b128(sQ + kk * 32), desc_b128(sK(s) + kk * 32),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
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
    for (int i = 0; i < 8; ++i) {
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
    for (int kk = 0; kk < kBK / 16; ++kk)   // 16 keys: two swizzle atoms
      wgmma_rs(acc_o, pf[kk], desc_b128(sV(s) + kk * 2048));
    wgmma_commit();
    wgmma_wait_all();
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
  for (int i = 0; i < 8; ++i) {
    const uint32_t lo = pack_bf16(acc_o[4 * i] * inv_a, acc_o[4 * i + 1] * inv_a);
    const uint32_t hi = pack_bf16(acc_o[4 * i + 2] * inv_b,
                                  acc_o[4 * i + 3] * inv_b);
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(swz(sQ, ra, i) + cq * 2), "r"(lo) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(swz(sQ, ra + 8, i) + cq * 2), "r"(hi) : "memory");
  }
  if (lane % 4 == 0) {
    if (qa < Sq) lse[static_cast<long>(bh) * Sq + qa] = m_a + logf(den_a);
    if (qb8 < Sq) lse[static_cast<long>(bh) * Sq + qb8] = m_b + logf(den_b);
  }
  __syncthreads();
  __nv_bfloat16* ob = o + static_cast<long>(bh) * Sq * kHd;
  for (int i = tid; i < kBQ * 8; i += kThreads) {
    const int r = i / 8, jc = i % 8;
    if (q0 + r >= Sq) continue;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(swz(sQ, r, jc)) : "memory");
    *reinterpret_cast<uint4*>(ob + static_cast<long>(q0 + r) * kHd + jc * 8) =
        val;
  }
}

}  // namespace

extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o,
                                          void* lse, int BH,
                                          int Sq, int Skv, int hd, int groups,
                                          int causal, float scale,
                                          void* stream) {
  if (hd != kHd) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = kSmemBytes + 1024;     // + room to align to 1 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), BH, Sq, Skv, groups, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
