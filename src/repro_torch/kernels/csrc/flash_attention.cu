// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd /
// _flash_fwd_kernel, the Pallas TPU online-softmax kernel over a flat
// (batch*heads) layout.
//
//   o = softmax(q k^T * hd^-0.5 [causal mask]) v
//
// q (BH, Sq, hd) bf16, k/v (BH / groups, Skv, hd) bf16 -> o (BH, Sq, hd)
// bf16 and lse (BH, Sq) f32, the log-sum-exp of each row's scaled scores
// (m + log l, what _chunked_attention_fwd returns beside the output and
// what the training backward recomputes p from).  Query head bh reads kv head bh / groups, so GQA needs no
// repeated copy of k and v.  Arithmetic follows the TPU kernel: scores in
// f32, masked keys at -1e30, running max m, running sum l of the f32
// probabilities, p rounded to bf16 before the p·v product, rows with
// l == 0 divided by 1; kv tiles strictly above the diagonal are skipped.
//
// Bound on the H100: at the serving prefill (S ~ 200, hd 64) the work is
// ~S/2 flops per byte of q, k, v and o -- under the 295 flop/byte ridge,
// so bytes bound it, and the S x S scores must never reach device memory.
// Design: one CTA per (64 query rows, head); four warps own 16 rows
// each.  Per 64-key tile: k and v staged in shared memory, S = q k^T on
// the tensor cores (WMMA bf16, f32 accumulate) into shared memory, the
// online-softmax update by two lanes per row, then O += P v with the f32
// accumulator held in shared memory (WMMA fragments have no fixed
// element layout, so the per-row rescale happens there).  A later
// version keeps O in registers with mma.sync / wgmma fragments and
// double-buffers k/v with TMA.
#include "common.cuh"

namespace {

using namespace nvcuda;
using repro::bf16_zero;

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = 4;          // 16 query rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr float kNegBig = -1e30f;  // the reference's NEG_BIG

template <int HD>
struct FlashSmem {
  __nv_bfloat16 q[kBQ][HD];
  __nv_bfloat16 k[kBK][HD];
  __nv_bfloat16 v[kBK][HD];
  float s[kBQ][kBK];
  __nv_bfloat16 p[kBQ][kBK];
  float o[kBQ][HD];
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int groups, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FlashSmem<HD>& s = *reinterpret_cast<FlashSmem<HD>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const __nv_bfloat16* qb = q + static_cast<long>(bh) * Sq * HD;
  const __nv_bfloat16* kb = k + static_cast<long>(bh / groups) * Skv * HD;
  const __nv_bfloat16* vb = v + static_cast<long>(bh / groups) * Skv * HD;
  __nv_bfloat16* ob = o + static_cast<long>(bh) * Sq * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    s.q[r][c] = (q0 + r < Sq) ? qb[static_cast<long>(q0 + r) * HD + c]
                              : bf16_zero();
    s.o[r][c] = 0.0f;
  }

  // two lanes per query row; each owns half of the key tile's columns
  // and half of the head dim
  const int row = warp * 16 + lane / 2, half = lane % 2;
  const int qpos = q0 + row;
  float m = kNegBig, l = 0.0f;

  int n_kv = (Skv + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * kBK;
    __syncthreads();                      // all warps done with the last tile
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const bool in = kv0 + r < Skv;
      const long off = static_cast<long>(kv0 + r) * HD + c;
      s.k[r][c] = in ? kb[off] : bf16_zero();
      s.v[r][c] = in ? vb[off] : bf16_zero();
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, &s.q[warp * 16][kk * 16], HD);
        wmma::load_matrix_sync(fb, &s.k[n * 16][kk * 16], HD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&s.s[warp * 16][n * 16], acc, kBK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax for (row, half)
    float sv[kBK / 2];
    float mx = kNegBig;
#pragma unroll
    for (int c = 0; c < kBK / 2; ++c) {
      const int col = half * (kBK / 2) + c;
      const int kpos = kv0 + col;
      float x = s.s[row][col] * scale;
      if (kpos >= Skv || (causal && kpos > qpos)) x = kNegBig;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kBK / 2; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      s.p[row][half * (kBK / 2) + c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) s.o[row][half * (HD / 2) + c] *= corr;
    __syncwarp();

    // O += P V for this warp's 16 rows
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, &s.o[warp * 16][n * 16], HD,
                             wmma::mem_row_major);
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, &s.p[warp * 16][kk * 16], kBK);
        wmma::load_matrix_sync(fb, &s.v[kk * 16][n * 16], HD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&s.o[warp * 16][n * 16], acc, HD,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qpos < Sq) {
    const float den = (l == 0.0f) ? 1.0f : l;
    for (int c = 0; c < HD / 2; ++c) {
      const int col = half * (HD / 2) + c;
      ob[static_cast<long>(qpos) * HD + col] =
          __float2bfloat16(s.o[row][col] / den);
    }
    if (half == 0) lse[static_cast<long>(bh) * Sq + qpos] = m + logf(den);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           void* lse, int BH, int Sq, int Skv, int groups, int causal, float scale,
           cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(FlashSmem<HD>));
  // above 48 KB of dynamic shared memory only after this opt-in (once)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Skv, groups, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o,
                                          void* lse, int BH,
                                          int Sq, int Skv, int hd, int groups,
                                          int causal, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, lse, BH, Sq, Skv, groups, causal, scale, st);
    case 64: return launch<64>(q, k, v, o, lse, BH, Sq, Skv, groups, causal, scale, st);
    case 128: return launch<128>(q, k, v, o, lse, BH, Sq, Skv, groups, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
