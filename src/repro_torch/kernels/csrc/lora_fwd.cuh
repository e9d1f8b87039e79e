// The LoRA CTA routine for Hopper (sm_90a), shared by five kernels: BM
// token rows that belong to ONE adapter, times a range of output columns.
//
//   xa  = bf16(mask_{lane < rank}(x_rows · W1_seg))  once per CTA
//   out = xa · W2_seg                                f32 accumulation,
//                                                    stored f32 or bf16
//
// in one of two orientations of the adapter's pair, both read in place
// from the packed pair or the stacks, never copied:
//   Forward   W1 = A_seg (d_in x lanes), W2 = B_seg (lanes x d_out): the
//             ragged forward B1 (ragged_lora.cu), the masked forward B6
//             (fused_lora.cu), and phase 1 alone, B3's xa = x·A_seg
//             (ragged_bwd.cu);
//   Backward  x = dy_s, W1 = B_seg^T, W2 = A_seg^T: the ragged dgrad B2,
//             dx = mask(dy_s·B_seg^T)·A_seg^T, and phase 1 alone, B4's
//             dxa = dy_s·B_seg^T (ragged_bwd.cu).
// Phase 1 alone (lora_packed_kernel) writes the masked, rounded xa into
// the packed (T, R) layout: the segment's lanes, zeros in every other
// column.
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
//     CTA recomputes its rows' xa; phase 1 alone takes the rows only;
//   * every operand moves through the TMA in boxes of tensor maps (x, W1,
//     W2 in; the output out), one request a box, completing on mbarriers
//     (loads) and bulk groups (stores).  On the H100 one CTA a SM moves
//     only 6-20 GB/s an SM through 16-byte cp.async copies and st.global
//     stores, whatever the ring depth, and about as little through
//     row-by-row 1D bulk copies (~26 ns a request), against the ~25 GB/s
//     an SM's share of device memory (PERF.md);
//   * x·W1, once per CTA for all lanes of the segment (64 lanes a pass):
//     a ring of 128-deep stages (two 64-column x boxes; one W1 box of 128
//     k rows (Forward) or two of 64 k columns (Backward)), two 16-deep
//     k-steps of each class a stage, 8 warps each owning one class (kk
//     mod 4) for half of the CTA's 16 x 16 tiles (grouped.cu's narrow
//     kernel); the masked, rounded xa stays in shared memory;
//   * xa·W2: 128-column blocks of W2 (two 64-column boxes of lane rows
//     (Forward), or lane boxes of 128 column rows (Backward)) through a
//     second ring whose first blocks load during x·W1 when shared memory
//     holds both rings, each warp owning 16 x 16 output tiles; a warp
//     stages its tiles of a block (two buffers) and stores them as boxes;
//   * the rings' depths are set per launch (make_layout) from the CTAs
//     each SM must hold: deep where one CTA a SM covers the grid
//     (training, decode), shallower where the grid is several waves;
//   * boxes land in the TMA's 32/64/128-byte swizzles, which keep the
//     fragment loads (ldmatrix) free of bank conflicts: transposing where
//     a weight's lanes (Forward W1) or output columns (Forward W2) are
//     contiguous, as stored where its contraction is (both Backward
//     weights); products are mma.sync m16n8k16, the HMMA.16816.F32.BF16
//     that WMMA's 16x16x16 issues twice (WMMA's load_matrix_sync compiles
//     here to generic loads and register transposes).
//
// The summation orders, the same in both orientations and in grouped.cu's
// B7, so that B1 and B6 agree with each other on one layout and with the
// B7 pair (narrow x·A, mask, wide xa·B), B1 with B2 fed x, B^T and A^T,
// and B2, B3 and B4 with B7, bit for bit:
//   x·W1  one accumulator per 16 x 16 tile per class of k-steps, fed in
//         ascending k by the same tensor-core instruction; the four
//         classes added in order 0..3 from 0.0f; the rank mask on the f32
//         value; one rounding to bf16 (round to nearest even);
//   xa·W2 one accumulator per 16 x 16 output tile over the 16-lane chunks
//         of the segment in ascending order, from 0.0f.
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
constexpr int kK = 128;               // contraction per x·W1 stage: 8 k-steps
constexpr int kLanes = 64;            // xa lanes per x·W1 pass
constexpr int kCols = 128;            // output columns per xa·W2 block
constexpr int kMaxWidth = 256;        // widest segment (lanes)
constexpr int kMaxStages = 4;         // of either ring
constexpr int kSmemCta = 232448;      // an H100 CTA's shared memory
constexpr int kSmemPerSm = 233472;    // an SM's, 1 KB of it per CTA
//                                       reserved by the runtime

// The orientation of the two weights (a type, so that a kernel's symbol
// names it).  Forward: W1's rows are the contraction (d_in) with its
// lanes contiguous, W2's rows are lanes with the output columns
// contiguous.  Backward: W1's rows are lanes with the contraction (d_out)
// contiguous, W2's rows are the output columns (d_in) with the lanes
// contiguous.
struct Forward {
  static constexpr bool kBwd = false;
};
struct Backward {
  static constexpr bool kBwd = true;
};

// A CTA's adapter: the lane coordinate and stacked index of its W1 and
// W2 boxes (A_seg's first column or B_seg's first row, by orientation),
// the padded width and the true rank.
struct Seg {
  int lane1, stack1, lane2, stack2, width, rank;
};

// The ragged kernels' adapter of a token tile (B1-B4): its packed
// segment's first column of A, which is its first row of B, its padded
// width and its true rank, from the per-tile table.
struct RaggedSeg {
  const int* tiles;

  __device__ Seg at(int tile) const {
    const int col0 = tiles[3 * tile];
    return {col0, 0, col0, 0, tiles[3 * tile + 1], tiles[3 * tile + 2]};
  }
};

// The dynamic shared memory of one launch (byte offsets from a 1024-byte
// aligned base) and the ring depths: s1 stages of x·W1 (stage bytes; lw
// lanes a pass in a W1 box), sb of W2 (bst bytes; Backward: nbx boxes of
// lw lanes).  The f32 class partials (row rld floats) reuse the x·W1
// ring, and so does the output staging when early: the W2 ring has room
// of its own, its first blocks loading during x·W1; else the W2 ring and
// the staging reuse the x·W1 ring after it.  Phase 1 alone (packed) has
// no W2 ring; its staging reuses the x·W1 ring.
struct Layout {
  int s1, sb, lw, nbx, stage, bst, rld, bring, stg, xa, total, early;
};

template <int BM, typename OutT, typename Dir>
inline Layout make_layout(int wr, int budget, bool packed) {
  Layout L{};
  L.lw = wr <= 16 ? 16 : (wr <= 32 ? 32 : kLanes);
  L.nbx = (wr + L.lw - 1) / L.lw;
  L.rld = L.lw + 4;
  L.stage = 2 * BM * 128 + kK * L.lw * 2;
  L.bst = Dir::kBwd ? L.nbx * kCols * L.lw * 2 : 2 * wr * 128;
  const int red = 4 * BM * L.rld * 4;
  const int out = static_cast<int>(sizeof(OutT));
  const int stg = packed ? 2 * BM * 128 : kWarps * 2 * 16 * BM * out;
  const int xa = (BM * (wr + 8) * 2 + 1023) / 1024 * 1024;
  static const int depth[][2] = {{4, 4}, {4, 3}, {3, 3}, {3, 2}, {2, 2}};
  for (int early = packed ? 0 : 1; early >= 0; --early)
    for (const auto& d : depth) {
      const int sb = packed ? 0 : d[1];
      int r0 = d[0] * L.stage;
      r0 = ((r0 > red ? r0 : red) + 1023) / 1024 * 1024;  // 1 KB apart
      if (early) {
        r0 = r0 > stg ? r0 : stg;
        L.bring = r0;
        L.stg = 0;
        L.xa = r0 + sb * L.bst;
      } else {
        L.bring = 0;
        L.stg = sb * L.bst;
        L.xa = r0 > L.stg + stg ? r0 : L.stg + stg;
      }
      L.total = L.xa + xa + 1024;    // + room to align the base to 1 KB
      if (L.total <= budget) {
        L.s1 = d[0];
        L.sb = sb;
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

// The same for a B operand stored with its columns as rows and k
// contiguous (the Backward weights), read as stored: a lane's column
// (the row it addresses) and 8-deep k offset; registers 0, 1 again hold
// columns 0..7, 2, 3 columns 8..15.
__device__ __forceinline__ int wfrag_row() {
  const int lane = threadIdx.x % 32;
  return (lane & 7) + (lane >> 4) * 8;
}

__device__ __forceinline__ int wfrag_col() {
  return (((threadIdx.x % 32) >> 3) & 1) * 8;
}

// ------------------------------------------------------------- x·W1
template <int BM>
struct Tiling {      // warp w: class w & 3, half w >> 2 of the tiles
  static constexpr int RT = BM / 16;                // row tiles
  static constexpr bool kSplitRows = RT >= 2;       // else lane tiles split
  static constexpr int RW = kSplitRows ? RT / 2 : RT;
  static constexpr int LW = kSplitRows ? 4 : 2;     // lane tiles a warp may own
};

// xa[:, lane0:lane0 + n_lanes) of the CTA's rows, masked and rounded.
// g1: x·W1 stages issued so far in the launch (names each buffer's
// phase).  A stage: x box 0 (BM rows of k0..k0 + 63), x box 1 (k0 +
// 64..), then W1: Forward one box (kK k rows of L.lw lanes), Backward two
// (L.lw lane rows of k0.. and of k0 + 64..), each in its swizzle.
template <int BM, typename Dir>
__device__ __forceinline__ void xa_pass(
    const CUtensorMap* tm_x, const CUtensorMap* tm_w, int row0, int d_k,
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

  const int n_st = (d_k + kK - 1) / kK;
  const int g0 = g1;
  auto issue = [&](int i) {          // one thread
    const int b = (g0 + i) % L.s1;
    const uint32_t st = smem_u32(ring + b * L.stage);
    fence_proxy_async();             // generic reads of the buffer done
    mbar_expect_tx(bars + b, L.stage);
    tma_load2(st, tm_x, i * kK, row0, bars + b);
    tma_load2(st + BM * 128, tm_x, i * kK + 64, row0, bars + b);
    if constexpr (Dir::kBwd)
      for (int hb = 0; hb < 2; ++hb)
        tma_load3(st + 2 * BM * 128 + hb * L.lw * 128, tm_w,
                  i * kK + 64 * hb, sg.lane1 + lane0, sg.stack1, bars + b);
    else
      tma_load3(st + 2 * BM * 128, tm_w, sg.lane1 + lane0, i * kK,
                sg.stack1, bars + b);
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
      const int kw = kk * 16 + wfrag_col();
#pragma unroll
      for (int j = 0; j < G::LW; ++j) {
        const int lt = G::kSplitRows ? j : h + 2 * j;
        if (lt < LT) {
          unsigned fa[4];
          if constexpr (Dir::kBwd)
            ldsm_x4(as + (kw >> 6) * L.lw * 128 +
                        swz(128, lt * 16 + wfrag_row(), (kw & 63) >> 3),
                    fa);
          else
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

// ------------------------------------------------------ the kernels
// Seg_::at(tile) names the adapter of a token tile (ragged: the per-tile
// table; masked: the tile map and ranks).  The maps: x (d_k, T), W1 and
// W2 (inner, outer, stacked) in the orientation's roles, out (d_n, T),
// their boxes as launch_rows encodes them.  wr: the widest segment of
// the launch, rounded up to 16 lanes.
template <int BM, typename OutT, typename Seg_, typename Dir>
__global__ void __launch_bounds__(kThreads, BM == 64 ? 1 : 2)
lora_kernel(const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_w1,
            const __grid_constant__ CUtensorMap tm_w2,
            const __grid_constant__ CUtensorMap tm_o, Seg_ seg, int d_k,
            int d_n, int wr, int block_t, int cols_per_cta, Layout L) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * kMaxStages];   // x·W1 ring, then W2 ring
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
  const int col_end = min(d_n, col_begin + cols_per_cta);
  const int n_blk = (col_end - col_begin + kCols - 1) / kCols;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kMaxStages; ++i) sm90::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // block blk of W2, the segment's lanes for kCols output columns:
  // Forward two 64-column boxes of wr lane rows, Backward nbx boxes of
  // L.lw lanes for kCols column rows
  auto b_issue = [&](int blk) {      // one thread
    const int b = blk % L.sb;
    const uint32_t bs = smem_u32(bring + b * L.bst);
    const int col = col_begin + blk * kCols;
    fence_proxy_async();
    mbar_expect_tx(bbars + b, L.bst);
    if constexpr (Dir::kBwd)
      for (int bx = 0; bx < L.nbx; ++bx)
        tma_load3(bs + bx * kCols * L.lw * 2, &tm_w2, sg.lane2 + bx * L.lw,
                  col, sg.stack2, bbars + b);
    else
      for (int hb = 0; hb < 2; ++hb)
        tma_load3(bs + hb * wr * 128, &tm_w2, col + 64 * hb, sg.lane2,
                  sg.stack2, bbars + b);
  };
  if (L.early && threadIdx.x == 0)   // W2's first blocks fly during x·W1
    for (int i = 0; i < L.sb - 1 && i < n_blk; ++i) b_issue(i);
  int g1 = 0;
#pragma unroll 1
  for (int lane0 = 0; lane0 < wpad; lane0 += kLanes)
    xa_pass<BM, Dir>(&tm_x, &tm_w1, row0, d_k, sg, lane0,
                     min(kLanes, wpad - lane0), L, ring, bars, g1, xa,
                     xa_ld);
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
    if (sg.width < wpad) {           // lanes past the width (the next
      __syncthreads();               // adapter's): zeros, as in a
      unsigned char* w = bring + b * L.bst;     // zero-padded chunk
      if constexpr (Dir::kBwd)       // 8-lane chunks of every column row
        for (int i = threadIdx.x; i < kCols * ((wpad - sg.width) / 8);
             i += kThreads) {
          const int l = sg.width + (i / kCols) * 8;
          *reinterpret_cast<uint4*>(
              w + (l / L.lw) * kCols * L.lw * 2 +
              swz(L.lw * 2, i % kCols, (l % L.lw) >> 3)) =
              make_uint4(0, 0, 0, 0);
        }
      else                           // whole lane rows of both boxes
        for (int i = threadIdx.x; i < (wpad - sg.width) * 16; i += kThreads)
          *reinterpret_cast<uint4*>(w + ((i >> 3) & 1) * wr * 128 +
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
      const int kl = rc * 16 + wfrag_col();
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int col = (ct0 + j) * 16;               // 0..112
        unsigned fb[4];
        if constexpr (Dir::kBwd)
          ldsm_x4(bs + (kl / L.lw) * kCols * L.lw * 2 +
                      swz(L.lw * 2, col + wfrag_row(), (kl % L.lw) >> 3),
                  fb);
        else
          ldsm_x4_t(bs + ((col + frag_col()) >> 6) * wr * 128 +
                        swz(128, kr, ((col + frag_col()) & 63) >> 3),
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

// Phase 1 alone into the packed layout (B3, B4): out (T, R) bf16, each
// row's lanes lane1.. lane1 + width from xa, zeros in every other column,
// as 64-lane boxes of BM rows staged in two buffers (the x·W1 ring, free
// after the last pass).
template <int BM, typename Seg_, typename Dir>
__global__ void __launch_bounds__(kThreads, BM == 64 ? 1 : 2)
lora_packed_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_o, Seg_ seg,
                   int d_k, int R, int wr, int block_t, Layout L) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[kMaxStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* xa = reinterpret_cast<__nv_bfloat16*>(smem + L.xa);
  const int xa_ld = wr + 8;
  const int row0 = blockIdx.x * BM;          // block_t % BM == 0
  const Seg sg = seg.at(row0 / block_t);
  const int wpad = (sg.width + 15) / 16 * 16;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxStages; ++i) sm90::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int g1 = 0;
#pragma unroll 1
  for (int lane0 = 0; lane0 < wpad; lane0 += kLanes)
    xa_pass<BM, Dir>(&tm_x, &tm_w, row0, d_k, sg, lane0,
                     min(kLanes, wpad - lane0), L, smem, bars, g1, xa,
                     xa_ld);
#pragma unroll 1
  for (int c = 0; c < (R + 63) / 64; ++c) {
    unsigned char* buf = smem + (c & 1) * BM * 128;
    if (threadIdx.x == 0) sm90::bulk_wait_read<1>();  // box c - 2 is read
    __syncthreads();
    for (int i = threadIdx.x; i < BM * 8; i += kThreads) {
      const int l = c * 64 + (i & 7) * 8 - sg.lane1;  // the segment's lane
      *reinterpret_cast<uint4*>(buf + i * 16) =
          l >= 0 && l < sg.width
              ? *reinterpret_cast<const uint4*>(xa + (i >> 3) * xa_ld + l)
              : make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store2(&tm_o, c * 64, row0, smem_u32(buf));
      sm90::bulk_commit();
    }
  }
  if (threadIdx.x == 0) sm90::bulk_wait<0>();  // no store outlives the CTA
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

// A weight: n stacked matrices of ``outer`` rows of ``inner`` contiguous
// bf16, rows ``ld`` and matrices ``stack_ld`` elements apart.
struct Mat {
  const __nv_bfloat16* p;
  long inner, outer, ld, stack_ld, n;
};

// The packed ragged pair, both orientations' weights: A (d_in, R), lanes
// contiguous; B (R, d), output columns contiguous.
inline Mat packed_a(const void* a, int d_in, int R) {
  return {static_cast<const __nv_bfloat16*>(a), R, d_in, R,
          static_cast<long>(R) * d_in, 1};
}

inline Mat packed_b(const void* b, int R, int d) {
  return {static_cast<const __nv_bfloat16*>(b), d, R, d,
          static_cast<long>(R) * d, 1};
}

// The operands of a launch: x (T, d_k) contiguous; the weights in the
// orientation's roles (Forward: w1 (d_k rows, lanes), w2 (lane rows, d_n);
// Backward: w1 (lane rows, d_k), w2 (d_n rows, lanes)); out (T, d_n)
// contiguous (phase 1 alone: (T, R) with d_n = R).
struct Operands {
  const __nv_bfloat16* x;
  Mat w1, w2;
  void* out;
  int T, d_k, d_n;
};

// A kernel's static shared memory (its mbarriers) and registers, the
// dynamic shared memory left to it, the CTAs an SM's registers hold.
struct Fit {
  cudaError_t err;
  int stat, dyn, by_regs;
};

template <typename Kernel>
Fit fit_of(Kernel kernel) {
  cudaFuncAttributes fa{};
  Fit f{cudaFuncGetAttributes(&fa, kernel), 0, 0, 1};
  if (f.err != cudaSuccess) return f;
  f.stat = static_cast<int>(fa.sharedSizeBytes);
  f.dyn = kSmemCta - f.stat;
  f.err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f.dyn);
  const int regs = fa.numRegs > 0 ? (fa.numRegs + 7) / 8 * 8 : 256;
  f.by_regs = 65536 / (regs * kThreads);
  return f;
}

// The rings as deep as the CTAs an SM must hold allow (up to 4 a SM, as
// many as ``ctas`` needs and the registers allow); total 0: nothing fits.
template <int BM, typename OutT, typename Dir>
Layout fit_layout(const Fit& fit, int ctas, int wr, bool packed) {
  int per_sm = (ctas + sm_count() - 1) / sm_count();
  per_sm = per_sm < fit.by_regs ? per_sm : fit.by_regs;
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  Layout L{};
  for (; per_sm >= 1 && L.total == 0; --per_sm) {
    const int budget = kSmemPerSm / per_sm - 1024 - fit.stat;
    L = make_layout<BM, OutT, Dir>(wr, budget < fit.dyn ? budget : fit.dyn,
                                   packed);
  }
  return L;
}

// The maps both kernels read: x in 64-column boxes of BM rows, W1 in the
// orientation's boxes (Forward L.lw lanes x kK k rows, Backward 64 k x
// L.lw lane rows), each in the swizzle of its row bytes.
inline bool map_weight(CUtensorMap* tm, const Mat& m, int box_inner,
                       int box_outer) {
  const long dims[3] = {m.inner, m.outer, m.n}, str[2] = {m.ld, m.stack_ld};
  const int box[3] = {box_inner, box_outer, 1};
  return make_map(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, m.p, 3, dims, str, 2,
                  box, swizzle_of(box_inner * 2));
}

template <int BM, typename Dir>
bool map_phase1(CUtensorMap* tm_x, CUtensorMap* tm_w1, const Operands& o,
                const Layout& L) {
  const long x_dims[2] = {o.d_k, o.T}, x_str[1] = {o.d_k};
  const int x_box[2] = {64, BM};
  return make_map(tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, o.x, 2, x_dims,
                  x_str, 2, x_box, swizzle_of(128)) &&
         (Dir::kBwd ? map_weight(tm_w1, o.w1, 64, L.lw)
                    : map_weight(tm_w1, o.w1, L.lw, kK));
}

// Launch on ``st``: grid (T / BM, column CTAs), ``col_splits`` CTAs
// sharing a row block's columns, each a whole number of kCols blocks.
template <int BM, typename OutT, typename Dir, typename Seg_>
cudaError_t launch_rows(const Operands& o, const Seg_& seg, int wr,
                        int block_t, int col_splits, cudaStream_t st) {
  static const Fit fit = fit_of(lora_kernel<BM, OutT, Seg_, Dir>);
  if (fit.err != cudaSuccess) return fit.err;
  if (wr % 16 || wr > kMaxWidth || o.T % BM || block_t % BM)
    return cudaErrorInvalidValue;
  const int blocks = (o.d_n + kCols - 1) / kCols;
  const int per = (blocks + col_splits - 1) / col_splits * kCols;
  const dim3 grid(o.T / BM, (o.d_n + per - 1) / per);
  const Layout L = fit_layout<BM, OutT, Dir>(
      fit, static_cast<int>(grid.x * grid.y), wr, false);
  if (L.total == 0) return cudaErrorInvalidValue;

  constexpr int kOut = static_cast<int>(sizeof(OutT));
  constexpr int bc = BM * kOut <= 128 ? BM : 128 / kOut;
  CUtensorMap tm_x, tm_w1, tm_w2, tm_o;
  const long o_dims[2] = {o.d_n, o.T}, o_str[1] = {o.d_n};
  const int o_box[2] = {bc, 16};
  const bool ok =
      map_phase1<BM, Dir>(&tm_x, &tm_w1, o, L) &&
      (Dir::kBwd ? map_weight(&tm_w2, o.w2, L.lw, kCols)
                 : map_weight(&tm_w2, o.w2, 64, wr)) &&
      make_map(&tm_o,
               kOut == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               o.out, 2, o_dims, o_str, kOut, o_box, swizzle_of(bc * kOut));
  if (!ok) return cudaErrorInvalidValue;
  lora_kernel<BM, OutT, Seg_, Dir><<<grid, kThreads, L.total, st>>>(
      tm_x, tm_w1, tm_w2, tm_o, seg, o.d_k, o.d_n, wr, block_t, per, L);
  return cudaGetLastError();
}

// Phase 1 alone on ``st``: grid (T / BM), out (T, R) bf16 in unswizzled
// 64-lane boxes of BM rows.
template <int BM, typename Dir, typename Seg_>
cudaError_t launch_packed_rows(const Operands& o, const Seg_& seg, int wr,
                               int block_t, cudaStream_t st) {
  static const Fit fit = fit_of(lora_packed_kernel<BM, Seg_, Dir>);
  if (fit.err != cudaSuccess) return fit.err;
  if (wr % 16 || wr > kMaxWidth || o.T % BM || block_t % BM)
    return cudaErrorInvalidValue;
  const dim3 grid(o.T / BM);
  const Layout L = fit_layout<BM, __nv_bfloat16, Dir>(
      fit, static_cast<int>(grid.x), wr, true);
  if (L.total == 0) return cudaErrorInvalidValue;

  CUtensorMap tm_x, tm_w1, tm_o;
  const long o_dims[2] = {o.d_n, o.T}, o_str[1] = {o.d_n};
  const int o_box[2] = {64, BM};
  const bool ok =
      map_phase1<BM, Dir>(&tm_x, &tm_w1, o, L) &&
      make_map(&tm_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, o.out, 2, o_dims,
               o_str, 2, o_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  lora_packed_kernel<BM, Seg_, Dir><<<grid, kThreads, L.total, st>>>(
      tm_x, tm_w1, tm_o, seg, o.d_k, o.d_n, wr, block_t, L);
  return cudaGetLastError();
}

// ``rows``: 64, 32 or 16 token rows a CTA (the wrapper's geometry).
template <typename OutT, typename Dir, typename Seg_>
int launch(const Operands& o, const Seg_& seg, int wr, int block_t, int rows,
           int col_splits, cudaStream_t st) {
  if (col_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (rows) {
    case 64:
      err = launch_rows<64, OutT, Dir>(o, seg, wr, block_t, col_splits, st);
      break;
    case 32:
      err = launch_rows<32, OutT, Dir>(o, seg, wr, block_t, col_splits, st);
      break;
    case 16:
      err = launch_rows<16, OutT, Dir>(o, seg, wr, block_t, col_splits, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename Dir, typename Seg_>
int launch_packed(const Operands& o, const Seg_& seg, int wr, int block_t,
                  int rows, cudaStream_t st) {
  cudaError_t err;
  switch (rows) {
    case 64:
      err = launch_packed_rows<64, Dir>(o, seg, wr, block_t, st);
      break;
    case 32:
      err = launch_packed_rows<32, Dir>(o, seg, wr, block_t, st);
      break;
    case 16:
      err = launch_packed_rows<16, Dir>(o, seg, wr, block_t, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace lora_fwd
}  // namespace repro
