// The LoRA forward's CTA routine for Hopper (sm_90a), shared by the
// ragged forward (B1, ragged_lora.cu) and the masked forward (B6,
// fused_lora.cu): BM token rows that belong to ONE adapter, times a range
// of output columns.
//
//   xa  = bf16(mask_{lane < rank}(x_rows · A_seg))   once per CTA
//   out = xa · B_seg                                f32 accumulation,
//                                                   stored f32 or bf16
//
// Bound on the H100: bytes.  Each token row costs 2 (true rank) (d_in +
// d_out) flops against its 2 d_in bytes of x and its 2 or 4 d_out bytes
// of output: at LoRA ranks far under the 295 flop/byte ridge.  So the
// design reads x once from device memory, writes the output once, and
// keeps enough bytes in flight to cover the latency:
//   * rows a CTA: 64, 32 or 16 (dividing block_t, so one adapter), picked
//     by the wrapper (fused_lora.lora_fwd_geometry) to fill the card with
//     row CTAs alone where T allows; the output columns are split over
//     CTAs only where it does not (decode, nano slices), and each such
//     CTA recomputes its rows' xa;
//   * every operand moves through the TMA in boxes of tensor maps (x, A,
//     B in; the output out), one request a box, completing on mbarriers
//     (loads) and bulk groups (stores).  On the H100 one CTA a SM moves
//     only 6-20 GB/s an SM through 16-byte cp.async copies and st.global
//     stores, whatever the ring depth, and about as little through
//     row-by-row 1D bulk copies (~26 ns a request), against the ~25 GB/s
//     an SM's share of device memory (PERF.md);
//   * x·A, once per CTA for all lanes of the segment (64 lanes a pass):
//     a ring of 128-deep stages (two 64-column x boxes, one A box), two
//     16-deep k-steps of each class a stage, 8 warps each owning one
//     class (kk mod 4) for half of the CTA's 16 x 16 tiles (grouped.cu's
//     narrow kernel); the masked, rounded xa stays in shared memory;
//   * xa·B: 128-column blocks of B_seg (two 64-column boxes) through a
//     second ring whose first blocks load during x·A when shared memory
//     holds both rings, each warp owning 16 x 16 output tiles; a warp
//     stages its tiles of a block (two buffers) and stores them as boxes;
//   * the rings' depths are set per launch (make_layout) from the CTAs
//     each SM must hold: deep where one CTA a SM covers the grid
//     (training, decode), shallower where the grid is several waves;
//   * boxes land in the TMA's 32/64/128-byte swizzles, which keep the
//     fragment loads (ldmatrix) free of bank conflicts; products are
//     mma.sync m16n8k16, the HMMA.16816.F32.BF16 that WMMA's 16x16x16
//     issues twice (WMMA's load_matrix_sync compiles here to generic
//     loads and register transposes).
//
// The summation orders are those of lora_tile.cuh's lora_rows (B2 still
// runs it; B3 / B4 run its xa_rows), exactly, so B1 and B6 agree with
// each other on one layout, with the B7 pair (narrow x·A, mask, wide
// xa·B), and with lora_rows, bit for bit:
//   x·A  one accumulator per 16 x 16 tile per class of k-steps, fed in
//        ascending k by the same tensor-core instruction; the four classes
//        added in order 0..3 from 0.0f; the rank mask on the f32 value;
//        one rounding to bf16 (round to nearest even);
//   xa·B one accumulator per 16 x 16 output tile over the 16-lane chunks
//        of the segment in ascending order, from 0.0f.
// The contraction is never split over CTAs and nothing is atomic: an
// element's value does not depend on the rows per CTA, the column split,
// the ring depths or which other rows share the launch (fused == solo
// serving).
#pragma once

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace repro {
namespace lora_fwd {

using sm90::fence_proxy_async;
using sm90::make_map;
using sm90::mbar_expect_tx;
using sm90::smem_u32;
using sm90::tma_load2;
using sm90::tma_load3;
using sm90::tma_store2;

constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kK = 128;               // d_in per x·A stage: 8 k-steps
constexpr int kLanes = 64;            // xa lanes per x·A pass
constexpr int kCols = 128;            // output columns per xa·B block
constexpr int kMaxWidth = 256;        // widest segment (lanes)
constexpr int kMaxStages = 4;         // of either ring
constexpr int kSmemCta = 232448;      // an H100 CTA's shared memory
constexpr int kSmemPerSm = 233472;    // an SM's, 1 KB of it per CTA
//                                       reserved by the runtime

// A CTA's adapter: the coordinates of its A and B boxes (lane column and
// stacked index of A_seg, first row and stacked index of B_seg), the
// padded width and the true rank.
struct Seg {
  int a_col, a_idx, b_row, b_idx, width, rank;
};

// The dynamic shared memory of one launch (byte offsets from a 1024-byte
// aligned base) and the ring depths: s1 stages of x·A (stage bytes; lw
// lanes a pass in an A box), sb of B (bst bytes).  The f32 class
// partials (row rld floats) reuse the x·A ring, and so does the output
// staging when early: the B ring has room of its own, its first blocks
// loading during x·A; else the B ring and the staging reuse the x·A ring
// after it.
struct Layout {
  int s1, sb, lw, stage, bst, rld, bring, stg, xa, total, early;
};

template <int BM, typename OutT>
inline Layout make_layout(int wr, int budget) {
  Layout L{};
  L.lw = wr <= 16 ? 16 : (wr <= 32 ? 32 : kLanes);
  L.rld = L.lw + 4;
  L.stage = 2 * BM * 128 + kK * L.lw * 2;
  L.bst = 2 * wr * 128;
  const int red = 4 * BM * L.rld * 4;
  const int stg = kWarps * 2 * 16 * BM * static_cast<int>(sizeof(OutT));
  const int xa = (BM * (wr + 8) * 2 + 1023) / 1024 * 1024;
  static const int depth[][2] = {{4, 4}, {4, 3}, {3, 3}, {3, 2}, {2, 2}};
  for (int early = 1; early >= 0; --early)
    for (const auto& d : depth) {
      int r0 = d[0] * L.stage;
      r0 = ((r0 > red ? r0 : red) + 1023) / 1024 * 1024;  // 1 KB apart
      if (early) {
        r0 = r0 > stg ? r0 : stg;
        L.bring = r0;
        L.stg = 0;
        L.xa = r0 + d[1] * L.bst;
      } else {
        L.bring = 0;
        L.stg = d[1] * L.bst;
        L.xa = r0 > L.stg + stg ? r0 : L.stg + stg;
      }
      L.total = L.xa + xa + 1024;    // + room to align the base to 1 KB
      if (L.total <= budget) {
        L.s1 = d[0];
        L.sb = d[1];
        L.early = early;
        return L;
      }
    }
  L.total = 0;                       // nothing fits: refused
  return L;
}

// The byte offset of 16-byte chunk ``j`` of row ``r`` in a box of rows of
// ``span`` bytes (32, 64 or 128) in the TMA's swizzle of that span.
__device__ __forceinline__ uint32_t swz(int span, int r, int j) {
  const int x = span == 128 ? (r & 7) : (span == 64 ? (r >> 1) & 3
                                                    : (r >> 2) & 1);
  return r * span + ((j ^ x) << 4);
}

// ------------------------------------------------- the tensor cores
// Four 8 x 8 bf16 matrices; lane i names row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// d += a (16 x 16, row-major fragment) · b (16 x 8, two registers)
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's row and 8-column offset in a 16 x 16 fragment: as stored (the
// A operand: rows, then k) and transposed (the B operand, k rows: the
// registers 0, 1 then hold columns 0..7, 2, 3 columns 8..15).
__device__ __forceinline__ int frag_row(bool trans) {
  const int lane = threadIdx.x % 32;
  return trans ? (lane & 7) + ((lane >> 3) & 1) * 8 : lane & 15;
}

__device__ __forceinline__ int frag_col() {
  return ((threadIdx.x % 32) >> 4) * 8;
}

// ------------------------------------------------------------- x·A
template <int BM>
struct Tiling {      // warp w: class w & 3, half w >> 2 of the tiles
  static constexpr int RT = BM / 16;                // row tiles
  static constexpr bool kSplitRows = RT >= 2;       // else lane tiles split
  static constexpr int RW = kSplitRows ? RT / 2 : RT;
  static constexpr int LW = kSplitRows ? 4 : 2;     // lane tiles a warp may own
};

// xa[:, lane0:lane0 + n_lanes) of the CTA's rows, masked and rounded.
// g1: x·A stages issued so far in the launch (names each buffer's phase).
// A stage: x box 0 (BM rows of k0..k0 + 63), x box 1 (k0 + 64..), the A
// box (kK k rows of L.lw lanes), each in its swizzle.
template <int BM>
__device__ __forceinline__ void xa_pass(
    const CUtensorMap* tm_x, const CUtensorMap* tm_a, int row0, int d_in,
    const Seg& sg, int lane0, int n_lanes, const Layout& L,
    unsigned char* ring, uint64_t* bars, int& g1, __nv_bfloat16* xa,
    int xa_ld) {
  using G = Tiling<BM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cls = warp & 3, h = warp >> 2;
  const int LT = n_lanes / 16;
  const int aspan = L.lw * 2;
  float acc[G::RW][G::LW][2][4];
#pragma unroll
  for (int i = 0; i < G::RW; ++i)
#pragma unroll
    for (int j = 0; j < G::LW; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][s][e] = 0.0f;

  const int n_st = (d_in + kK - 1) / kK;
  const int g0 = g1;
  auto issue = [&](int i) {          // one thread
    const int b = (g0 + i) % L.s1;
    const uint32_t st = smem_u32(ring + b * L.stage);
    fence_proxy_async();             // generic reads of the buffer done
    mbar_expect_tx(bars + b, L.stage);
    tma_load2(st, tm_x, i * kK, row0, bars + b);
    tma_load2(st + BM * 128, tm_x, i * kK + 64, row0, bars + b);
    tma_load3(st + 2 * BM * 128, tm_a, sg.a_col + lane0, i * kK, sg.a_idx,
              bars + b);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < L.s1 - 1 && i < n_st; ++i) issue(i);
#pragma unroll 1
  for (int i = 0; i < n_st; ++i) {
    __syncthreads();                 // stage i - 1 is read: its buffer
    const int nxt = i + L.s1 - 1;    // is free
    if (threadIdx.x == 0 && nxt < n_st) issue(nxt);
    const int b = (g0 + i) % L.s1;
    sm90::mbar_wait(bars + b, ((g0 + i) / L.s1) & 1);
    const uint32_t xs = smem_u32(ring + b * L.stage);
    const uint32_t as = xs + 2 * BM * 128;
    // this warp's class: k-steps cls and cls + 4 of the stage, ascending;
    // a stage is a whole number of 4-step groups, so the global k-step
    // (kK / 16) i + kk has class cls too
#pragma unroll
    for (int kk = cls; kk < kK / 16; kk += 4) {
      const int kc = kk * 16 + frag_col();            // 0..127
      unsigned fx[G::RW][4];
#pragma unroll
      for (int r = 0; r < G::RW; ++r) {
        const int row =
            (G::kSplitRows ? h + 2 * r : r) * 16 + frag_row(false);
        ldsm_x4(xs + (kc >> 6) * BM * 128 + swz(128, row, (kc & 63) >> 3),
                fx[r]);
      }
      const int kr = kk * 16 + frag_row(true);
#pragma unroll
      for (int j = 0; j < G::LW; ++j) {
        const int lt = G::kSplitRows ? j : h + 2 * j;
        if (lt < LT) {
          unsigned fa[4];
          ldsm_x4_t(as + swz(aspan, kr, (lt * 16 + frag_col()) >> 3), fa);
#pragma unroll
          for (int r = 0; r < G::RW; ++r) {
            mma16816(acc[r][j][0], fx[r], fa[0], fa[1]);
            mma16816(acc[r][j][1], fx[r], fa[2], fa[3]);
          }
        }
      }
    }
  }
  g1 = g0 + n_st;
  __syncthreads();                   // the ring is read: free for the
  //                                    partials
  // red[class][row][L.rld] f32: each class's partial of every tile
  float* red = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < G::RW; ++r) {
    const int rt = G::kSplitRows ? h + 2 * r : r;
#pragma unroll
    for (int j = 0; j < G::LW; ++j) {
      const int lt = G::kSplitRows ? j : h + 2 * j;
      if (lt < LT)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float* p = red + (cls * BM + rt * 16 + g) * L.rld + lt * 16 +
                     s * 8 + 2 * q;
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[r][j][s][0], acc[r][j][s][1]);
          *reinterpret_cast<float2*>(p + 8 * L.rld) =
              make_float2(acc[r][j][s][2], acc[r][j][s][3]);
        }
    }
  }
  __syncthreads();
  // the classes added in order from 0.0f, the rank mask on the f32
  // value, one rounding; 8 lanes (16 bytes) a thread
  for (int i = threadIdx.x; i < BM * (kLanes / 8); i += kThreads) {
    const int r = i >> 3, l = (i & 7) * 8;
    if (l >= n_lanes) continue;
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float v2[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v += red[(c * BM + r) * L.rld + l + e + u];
        v2[u] = lane0 + l + e + u < sg.rank ? v : 0.0f;
      }
      packed[e / 2] = sm90::pack_bf16(v2[0], v2[1]);
    }
    *reinterpret_cast<uint4*>(xa + r * xa_ld + lane0 + l) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  __syncthreads();                   // xa is written; the ring is free
}

// ------------------------------------------------------ the kernel
// Seg_::at(tile) names the adapter of a token tile (ragged: the per-tile
// table; masked: the tile map and ranks).  The maps: x (d_in, T), A
// (lanes, d_in, stacked), B (d_out, rows, stacked), out (d_out, T), their
// boxes as launch_rows encodes them.  wr: the widest segment of the
// launch, rounded up to 16 lanes.
template <int BM, typename OutT, typename Seg_>
__global__ void __launch_bounds__(kThreads, BM == 64 ? 1 : 2)
lora_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_o, Seg_ seg, int d_in,
                int d_out, int wr, int block_t, int cols_per_cta, Layout L) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * kMaxStages];   // x·A ring, then B ring
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem;
  unsigned char* bring = smem + L.bring;
  __nv_bfloat16* xa = reinterpret_cast<__nv_bfloat16*>(smem + L.xa);
  uint64_t* bbars = bars + kMaxStages;
  const int xa_ld = wr + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int row0 = blockIdx.x * BM;          // block_t % BM == 0
  const Seg sg = seg.at(row0 / block_t);
  const int wpad = (sg.width + 15) / 16 * 16;
  const int col_begin = blockIdx.y * cols_per_cta;
  const int col_end = min(d_out, col_begin + cols_per_cta);
  const int n_blk = (col_end - col_begin + kCols - 1) / kCols;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kMaxStages; ++i) sm90::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // B block blk of the segment: two 64-column boxes of wr rows
  auto b_issue = [&](int blk) {      // one thread
    const int b = blk % L.sb;
    const uint32_t bs = smem_u32(bring + b * L.bst);
    fence_proxy_async();
    mbar_expect_tx(bbars + b, L.bst);
    for (int hb = 0; hb < 2; ++hb)
      tma_load3(bs + hb * wr * 128, &tm_b, col_begin + blk * kCols + 64 * hb,
                sg.b_row, sg.b_idx, bbars + b);
  };
  if (L.early && threadIdx.x == 0)   // B's first blocks fly during x·A
    for (int i = 0; i < L.sb - 1 && i < n_blk; ++i) b_issue(i);
  int g1 = 0;
#pragma unroll 1
  for (int lane0 = 0; lane0 < wpad; lane0 += kLanes)
    xa_pass<BM>(&tm_x, &tm_a, row0, d_in, sg, lane0,
                min(kLanes, wpad - lane0), L, ring, bars, g1, xa, xa_ld);
  if (!L.early && threadIdx.x == 0)
    for (int i = 0; i < L.sb - 1 && i < n_blk; ++i) b_issue(i);

  // warp w: row tile w % RT, column tiles CW (w / RT).. of each block,
  // staged in its two buffers as output boxes of ``bc`` columns x 16 rows
  constexpr int RT = BM / 16, CW = RT;
  constexpr int kOut = static_cast<int>(sizeof(OutT));
  constexpr int bc = BM * kOut <= 128 ? BM : 128 / kOut;  // box columns
  constexpr int ospan = bc * kOut;                         // its row bytes
  const int rt = warp % RT, ct0 = (warp / RT) * CW;
  unsigned char* stg = smem + L.stg + warp * 2 * 16 * BM * kOut;
  const uint32_t xa_s = smem_u32(xa);
  const int n_rc = wpad / 16;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int blk = 0; blk < n_blk; ++blk) {
    __syncthreads();                 // block blk - 1 is read: its buffer
    const int nxt = blk + L.sb - 1;  // is free
    if (threadIdx.x == 0 && nxt < n_blk) b_issue(nxt);
    const int b = blk % L.sb;
    sm90::mbar_wait(bbars + b, (blk / L.sb) & 1);
    const uint32_t bs = smem_u32(bring + b * L.bst);
    if (sg.width < wpad) {           // rows past the width: zeros, as
      __syncthreads();               // lora_rows reads them
      for (int i = threadIdx.x; i < (wpad - sg.width) * 16; i += kThreads)
        *reinterpret_cast<uint4*>(bring + b * L.bst +
                                  ((i >> 3) & 1) * wr * 128 +
                                  (sg.width + (i >> 4)) * 128 +
                                  (i & 7) * 16) = make_uint4(0, 0, 0, 0);
      __syncthreads();
    }
    float acc[CW][2][4];
#pragma unroll
    for (int j = 0; j < CW; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][s][e] = 0.0f;
#pragma unroll 1
    for (int rc = 0; rc < n_rc; ++rc) {      // ascending rank chunks
      unsigned fx[4];
      ldsm_x4(xa_s + ((rt * 16 + frag_row(false)) * xa_ld + rc * 16 +
                      frag_col()) * 2, fx);
      const int kr = rc * 16 + frag_row(true);
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int col = (ct0 + j) * 16 + frag_col();  // 0..127
        unsigned fb[4];
        ldsm_x4_t(bs + (col >> 6) * wr * 128 + swz(128, kr, (col & 63) >> 3),
                  fb);
        mma16816(acc[j][0], fx, fb[0], fb[1]);
        mma16816(acc[j][1], fx, fb[2], fb[3]);
      }
    }
    // stage the warp's 16 x 16 CW tile in buffer blk % 2 (its store of
    // two blocks ago has been read), then one box store a bc columns
    unsigned char* buf = stg + (blk & 1) * 16 * BM * kOut;
    if (lane == 0) sm90::bulk_wait_read<1>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CW; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = g + 8 * hr, col = j * 16 + s * 8 + 2 * q;
          const int cb = (col % bc) * kOut;
          unsigned char* p = buf + (col / bc) * 16 * ospan +
                             swz(ospan, row, cb >> 4) + (cb & 15);
          const float v0 = acc[j][s][2 * hr], v1 = acc[j][s][2 * hr + 1];
          if constexpr (std::is_same<OutT, float>::value)
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(p) = sm90::pack_bf16(v0, v1);
        }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      const int col = col_begin + blk * kCols + ct0 * 16;
      for (int ob = 0; ob < BM / bc; ++ob)
        if (col + ob * bc < col_end)
          tma_store2(&tm_o, col + ob * bc, row0 + rt * 16,
                     smem_u32(buf + ob * 16 * ospan));
      sm90::bulk_commit();
    }
  }
  if (lane == 0) sm90::bulk_wait<0>();      // no store outlives the CTA
}

// ------------------------------------------------------ the launch
// The swizzle of boxes whose rows are ``span`` bytes (32, 64 or 128).
inline CUtensorMapSwizzle swizzle_of(int span) {
  return span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : CU_TENSOR_MAP_SWIZZLE_32B);
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// The operands of a launch: x (T, d_in) contiguous; A a_n stacked
// (d_in, a_cols) matrices, element (k, lane) of matrix i at a + i * a_k +
// k * a_row + lane; B likewise b_n stacked (b_rows, d_out) ones (b_k,
// b_row); out (T, d_out) contiguous.
struct Operands {
  const __nv_bfloat16* x;
  const __nv_bfloat16* a;
  long a_cols, a_row, a_k, a_n;
  const __nv_bfloat16* b;
  long b_rows, b_row, b_k, b_n;
  void* out;
  int T, d_in, d_out;
};

// Launch on ``st``: grid (T / BM, column CTAs), ``col_splits`` CTAs
// sharing a row block's columns, each a whole number of kCols blocks; the
// rings as deep as the CTAs an SM must hold allow (up to 4 a SM, as many
// as the grid needs and the registers allow).
template <int BM, typename OutT, typename Seg_>
cudaError_t launch_rows(const Operands& o, const Seg_& seg, int wr,
                        int block_t, int col_splits, cudaStream_t st) {
  // once: the kernel's static shared memory (its mbarriers) and
  // registers, the dynamic shared memory left to it, the CTAs an SM's
  // registers hold
  struct Fit { cudaError_t err; int stat, dyn, by_regs; };
  static const Fit fit = [] {
    cudaFuncAttributes fa{};
    Fit f{cudaFuncGetAttributes(&fa, lora_fwd_kernel<BM, OutT, Seg_>), 0, 0,
          1};
    if (f.err != cudaSuccess) return f;
    f.stat = static_cast<int>(fa.sharedSizeBytes);
    f.dyn = kSmemCta - f.stat;
    f.err = cudaFuncSetAttribute(lora_fwd_kernel<BM, OutT, Seg_>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 f.dyn);
    const int regs = fa.numRegs > 0 ? (fa.numRegs + 7) / 8 * 8 : 256;
    f.by_regs = 65536 / (regs * kThreads);
    return f;
  }();
  if (fit.err != cudaSuccess) return fit.err;
  if (wr % 16 || wr > kMaxWidth || o.T % BM || block_t % BM)
    return cudaErrorInvalidValue;
  const int blocks = (o.d_out + kCols - 1) / kCols;
  const int per = (blocks + col_splits - 1) / col_splits * kCols;
  const dim3 grid(o.T / BM, (o.d_out + per - 1) / per);
  const int ctas = static_cast<int>(grid.x * grid.y);
  int per_sm = (ctas + sm_count() - 1) / sm_count();
  per_sm = per_sm < fit.by_regs ? per_sm : fit.by_regs;
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  Layout L{};
  for (; per_sm >= 1 && L.total == 0; --per_sm) {
    const int budget = kSmemPerSm / per_sm - 1024 - fit.stat;
    L = make_layout<BM, OutT>(wr, budget < fit.dyn ? budget : fit.dyn);
  }
  if (L.total == 0) return cudaErrorInvalidValue;

  constexpr int kOut = static_cast<int>(sizeof(OutT));
  constexpr int bc = BM * kOut <= 128 ? BM : 128 / kOut;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_x, tm_a, tm_b, tm_o;
  const long x_dims[2] = {o.d_in, o.T}, x_str[1] = {o.d_in};
  const int x_box[2] = {64, BM};
  const long a_dims[3] = {o.a_cols, o.d_in, o.a_n};
  const long a_str[2] = {o.a_row, o.a_k};
  const int a_box[3] = {L.lw, kK, 1};
  const long b_dims[3] = {o.d_out, o.b_rows, o.b_n};
  const long b_str[2] = {o.b_row, o.b_k};
  const int b_box[3] = {64, wr, 1};
  const long o_dims[2] = {o.d_out, o.T}, o_str[1] = {o.d_out};
  const int o_box[2] = {bc, 16};
  const bool ok =
      make_map(&tm_x, bf, o.x, 2, x_dims, x_str, 2, x_box,
               swizzle_of(128)) &&
      make_map(&tm_a, bf, o.a, 3, a_dims, a_str, 2, a_box,
               swizzle_of(L.lw * 2)) &&
      make_map(&tm_b, bf, o.b, 3, b_dims, b_str, 2, b_box,
               swizzle_of(128)) &&
      make_map(&tm_o, kOut == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : bf,
               o.out, 2, o_dims, o_str, kOut, o_box, swizzle_of(bc * kOut));
  if (!ok) return cudaErrorInvalidValue;
  lora_fwd_kernel<BM, OutT, Seg_><<<grid, kThreads, L.total, st>>>(
      tm_x, tm_a, tm_b, tm_o, seg, o.d_in, o.d_out, wr, block_t, per, L);
  return cudaGetLastError();
}

// ``rows``: 64, 32 or 16 token rows a CTA (the wrapper's geometry).
template <typename OutT, typename Seg_>
int launch(const Operands& o, const Seg_& seg, int wr, int block_t, int rows,
           int col_splits, cudaStream_t st) {
  if (col_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (rows) {
    case 64:
      err = launch_rows<64, OutT>(o, seg, wr, block_t, col_splits, st);
      break;
    case 32:
      err = launch_rows<32, OutT>(o, seg, wr, block_t, col_splits, st);
      break;
    case 16:
      err = launch_rows<16, OutT>(o, seg, wr, block_t, col_splits, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace lora_fwd
}  // namespace repro
