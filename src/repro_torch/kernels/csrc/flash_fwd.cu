// GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_fwd_kernel
// (Pallas, reached through _fwd / _flash_fn / gqa_flash_attention).
//
// Layout: q [BKV, S, G, hd], k/v [BKV, S, hd] (BKV = batch x kv heads, G query
// heads share one kv head); o like q; lse [BKV, S, G] fp32, the natural-log
// logsumexp of each row's scaled scores (the backward reads it). Masks are
// explicit: a masked (row, key) pair gets p = 0, never exp(NEG_INF - NEG_INF)
// = 1, and a tile masked for a whole row leaves that row's running max, sum
// and accumulator exactly as they are, so skipping a tile equals visiting it.
// The row sum is clamped at 1e-30. Any S works: ragged tile edges are masked.
//
// What bounds it on this card: at the serving prefill shape (BKV = 48, S =
// 512, G = 3, hd = 64, bf16, causal) q, k, v, o and lse are ~25 MB (7.6 us
// at 3.35 TB/s) against ~4.8 GFLOP of causal products (4.9 us at 989 TFLOP/s
// on the bf16 tensor cores); at the training shape (BKV = 24, S = 1024) the
// same bytes meet ~9.7 GFLOP (9.8 us). So the products have to run on the
// tensor cores, and the flops grow with S^2.
//
// bf16 inputs (every launch of the serving and training paths): a
// tensor-core sweep (wgmma, bf16 operands, fp32 accumulators), the design of
// flash_bwd.cu's dq sweep with its dP product replaced by an online softmax.
//   * Packed rows. The G query heads of a position are adjacent rows of q, so
//     for one kv head q is an [S G, 64] matrix and row r has position r / G.
//     One block (one warpgroup, 128 threads) per (tile of 64 packed q rows,
//     row of BKV), the last tile first (the longest causal walks start
//     first). The masks compare r / G with the key.
//   * The Q tile stays in shared memory; the block walks the kv tiles the
//     tile sees (flash_attention.dq_kv_tiles), K and V double-buffered by
//     16-byte cp.async into 128-byte-swizzled tiles (csrc/hopper_tiles.cuh),
//     zero-filled past the ragged edge.
//   * Per kv tile: S = Q K^T (both operands K-major in shared memory) into an
//     m64n64 fp32 accumulator; each thread holds 16 columns of two rows, a
//     quad of threads a whole row. The online softmax runs on those
//     registers in base 2 (scores times scale log2 e, masked after scaling):
//     the row max over the quad by two shuffles, the correction
//     exp2(m_old - m_new) applied to the thread's part of the row sum and to
//     the O accumulator's two rows, p = exp2(s - m_new) where unmasked. Then
//     O += P V with P packed to bf16 in registers as the A operand and V
//     MN-major (the transpose bit). O stays in registers for the whole walk.
//   * Epilogue: the row sums are summed over the quad, o = O / max(l, 1e-30)
//     stored as bf16 pairs, lse = m ln 2 + log(l). Each block writes only its
//     own rows (no atomics), so the result is bitwise repeatable.
//   * Per block: Q + 2 x (K, V) = 5 tiles of 8 KB plus the 1 KB alignment,
//     41,984 bytes of dynamic shared memory; two m64n64 fp32 accumulators of
//     32 registers a thread. The serving and training shapes launch 1,152
//     blocks each on 132 SMs.
//   * Numbers: the one rounding the plain version does not make is P's, to
//     bf16 as the operand of the PV product; scores, max, sums and the
//     accumulator stay fp32.
//
// Head dim 128 (the paper's Gemma3-style ladder, every rung): the same sweep
// with rows of two 64-column panels (csrc/hopper_tiles.cuh). S = Q K^T takes
// 8 k16 steps across the panels, O is two m64n64 accumulators (64 registers
// a thread), one PV product per panel of V. A staged tile is 16 KB, so Q +
// 2 x (K, V) is 80 KB + 1 KB alignment (82,944 bytes, set once per device
// with cudaFuncSetAttribute); two blocks share an SM (166 of 227 KB), at
// 160 registers a thread (ptxas, no spills). At
// the ladder's training shape (BKV = 32, S = 2048, G = 1, hd = 128, causal)
// the products are ~34 GFLOP (35 us on the tensor cores) against ~67 MB
// of q, k, v and o (20 us): operations bound.
//
// Head dim 80 (zamba2's shared block): the hd-128 sweep's two panels, the
// second staged with its columns 80 .. 127 zero-filled by cp.async (16-byte
// copies of nothing), so S = Q K^T takes the 5 live k16 steps and the PV
// product computes 128 columns of which the first 80 are stored (zero
// columns of V add only output columns that are never written). A row of 80
// bf16 is 160 bytes: the 16-byte copies stay aligned, though rows no longer
// start on 128-byte lines. Per tile 5 + 8 products against the 10 the head
// dim needs; the shared memory and registers are hd 128's.
//
// Head dim 112 (kimi-k2's 64:8 heads): hd 80's route with more of the
// second panel live. Columns 112 .. 127 are zero-filled when staged, S = Q
// K^T takes 7 k16 steps, and the PV product's second panel stores its
// columns 64 .. 111. A row is 224 bytes, so the 16-byte copies stay aligned.
// Shared memory and registers are hd 128's.
//
// fp32 inputs keep the CUDA-core sweep: one block per (row of BKV, tile of BQ
// positions); TPR = ceil(hd / 64) threads own one (position, query head)
// row, each keeping hd / TPR of its dims (64; 40 at hd 80, 56 at hd 112) of
// q and acc in registers (float4 groups TPR i + t of the row for part t), the
// parts' partial dot products summed by a shuffle. A loop inside the block
// walks the kv tiles of flash_attention.visited_kv_range at the tile sizes
// (BQ, BKV) = (32, 64) at hd 64 and (16, 32) at hd 80, 112 and 128 (at most
// the same registers a thread and 32 KB of static shared memory); each K/V
// tile is staged once in fp32 shared memory and read by all G heads of the
// block (broadcast reads). The online softmax updates once per CH keys;
// masked entries get p = 0 explicitly. A block runs BQ G TPR = 32 G threads,
// so past G = 8 (mistral-large's G = 12) it takes BQ / 2 positions: 16 G
// threads, at most 256 up to G = 16. The kv tiles stay (BQ, BKV)'s, and a
// row's arithmetic does not depend on BQ (skipping a tile masked for the
// whole row is exact), so the halved block computes the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tiles.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;

// ---------------------------------------------------------------------------
// fp32: CUDA-core sweep over positions
// ---------------------------------------------------------------------------

// the fp32 sweep's tiles at head dim HD: TPR threads a row, BQ q positions a
// block (times G heads times TPR threads <= 256), BKV kv positions a staged tile
template <int HD>
struct Fp32Tiles {
  static constexpr int TPR = hopper::panels<HD>();
  static constexpr int BQ = 32 / TPR;
  static constexpr int BKV = 64 / TPR;
};
constexpr int CH = 16;  // keys per online-softmax update

template <int HD, int BQ>
__global__ void __launch_bounds__(256) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int S, int G, int nq, int causal,
    int window, float scale) {
  constexpr int TPR = Fp32Tiles<HD>::TPR, BKV = Fp32Tiles<HD>::BKV;
  constexpr int D = HD / TPR;  // dims a thread holds: 64 (40 at hd 80, 56 at hd 112)
  __shared__ __align__(16) float Ks[BKV][HD];
  __shared__ __align__(16) float Vs[BKV][HD];

  const int b = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // longest causal rows first
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int pos = qi * BQ + r / G;
  const int g = r % G;
  const bool row_ok = pos < S;
  const long long row = ((long long)b * S + pos) * G + g;
  // the lanes of this row's TPR threads (for __shfl_xor_sync)
  const unsigned rmask = ((1u << TPR) - 1) << ((tid & 31) & ~(TPR - 1));

  float qr[D], acc[D];
#pragma unroll
  for (int h4 = 0; h4 < D / 4; ++h4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * h4 + e] = row_ok ? q[row * HD + 4 * (TPR * h4 + part) + e] : 0.f;
      acc[4 * h4 + e] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  // visited kv tiles [lo, hi): visited_kv_range at tile sizes (BQ, BKV)
  const int nkv = (S + BKV - 1) / BKV;
  const int q_first = qi * BQ;
  int hi = nkv;
  if (causal) hi = min(nkv, (q_first + BQ - 1) / BKV + 1);
  int lo = 0;
  if (window)
    while (lo < hi - 1 && q_first - (lo * BKV + BKV - 1) >= window) ++lo;

  const float* kb = k + (long long)b * S * HD;
  const float* vb = v + (long long)b * S * HD;
  for (int kj = lo; kj < hi; ++kj) {
    const int kv0 = kj * BKV;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < BKV * HD; i += blockDim.x) {
      const int j = i / HD, h = i % HD;
      const bool ok = kv0 + j < S;
      const long long off = (long long)(kv0 + j) * HD + h;
      Ks[j][h] = ok ? kb[off] : 0.f;
      Vs[j][h] = ok ? vb[off] : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
#pragma unroll 1
    for (int j0 = 0; j0 < BKV; j0 += CH) {
      const int c0 = kv0 + j0;
      // a chunk masked for the whole row would leave (m, l, acc) exactly as
      // they are (corr = 1, p = 0), so skipping it is exact
      if (c0 >= S || (causal && c0 > pos) || (window && pos - (c0 + CH - 1) >= window)) continue;
      float s[CH];
      unsigned valid = 0u;
      float cmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = c0 + c;
        const bool ok = col < S && (!causal || col <= pos) && (!window || pos - col < window);
        const float4* kr = reinterpret_cast<const float4*>(Ks[j0 + c]);
        float d = 0.f;
#pragma unroll
        for (int h4 = 0; h4 < D / 4; ++h4) {
          const float4 kk = kr[TPR * h4 + part];
          d = fmaf(qr[4 * h4], kk.x, d);
          d = fmaf(qr[4 * h4 + 1], kk.y, d);
          d = fmaf(qr[4 * h4 + 2], kk.z, d);
          d = fmaf(qr[4 * h4 + 3], kk.w, d);
        }
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1) d += __shfl_xor_sync(rmask, d, off);
        s[c] = ok ? d * scale : NEG_INF;
        valid |= ok ? (1u << c) : 0u;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int h = 0; h < D; ++h) acc[h] *= corr;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float p = ((valid >> c) & 1u) ? expf(s[c] - m_new) : 0.f;
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs[j0 + c]);
#pragma unroll
        for (int h4 = 0; h4 < D / 4; ++h4) {
          const float4 vv = vr[TPR * h4 + part];
          acc[4 * h4] = fmaf(p, vv.x, acc[4 * h4]);
          acc[4 * h4 + 1] = fmaf(p, vv.y, acc[4 * h4 + 1]);
          acc[4 * h4 + 2] = fmaf(p, vv.z, acc[4 * h4 + 2]);
          acc[4 * h4 + 3] = fmaf(p, vv.w, acc[4 * h4 + 3]);
        }
      }
      m = m_new;
    }
  }
  if (!row_ok) return;
  l = fmaxf(l, 1e-30f);
#pragma unroll
  for (int h4 = 0; h4 < D / 4; ++h4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[row * HD + 4 * (TPR * h4 + part) + e] = acc[4 * h4 + e] / l;
  }
  if (part == 0) lse[row] = m + logf(l);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core sweep over packed rows
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using hopper::TILE_BYTES;
constexpr int TILE = hopper::TILE_ROWS;  // packed q rows and kv positions per tile
constexpr int WG = hopper::WARPGROUP;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// Q, 2 x (K, V) tiles of panels<HD>() panels each; alignment
template <int HD>
constexpr int smem_bytes() { return 5 * hopper::panels<HD>() * TILE_BYTES + 1024; }

template <int HD>
__global__ void __launch_bounds__(WG, 2) flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int bkv, int S, int G, int causal, int window,
    float scale) {
  using namespace hopper;
  constexpr int NP = panels<HD>();     // 64-column panels of a row
  constexpr int TB = NP * TILE_BYTES;  // bytes of one staged tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK0 = sQ + TB;  // K of stage s at sK0 + s TB, V at + 2 TB

  const int tid = threadIdx.x;
  const int SG = S * G;
  const int nqt = (SG + TILE - 1) / TILE;
  const int b = blockIdx.x % bkv;
  const int r0 = (nqt - 1 - (int)(blockIdx.x / bkv)) * TILE;  // last q-row tile first
  const int nrows = min(TILE, SG - r0);
  // the kv tiles this q-row tile sees (flash_attention.dq_kv_tiles)
  const int p_first = r0 / G, p_last = (r0 + nrows - 1) / G;
  const int lo = window ? max(0, p_first - window + 1) / TILE : 0;
  const int hi = causal ? p_last / TILE + 1 : (S + TILE - 1) / TILE;

  const long long qrow0 = (long long)b * SG + r0;
  stage_tile<HD>(sQ, q + qrow0 * HD, nrows, tid);  // in the first stage's group
  const bf16* kb = k + (long long)b * S * HD;
  const bf16* vb = v + (long long)b * S * HD;
  auto stage_kv = [&](int kj, int s) {
    const int n = min(TILE, S - kj * TILE);
    stage_tile<HD>(sK0 + s * TB, kb + (long long)kj * TILE * HD, n, tid);
    stage_tile<HD>(sK0 + (2 + s) * TB, vb + (long long)kj * TILE * HD, n, tid);
    cp_async_commit();
  };
  stage_kv(lo, 0);

  const int w = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  int pos[2];
  bool row_ok[2];
  // per accumulator row (q rows r0 + 16 w + g (+ 8)): the running max of the
  // base-2 scores and this thread's part of the row sum (its 16 columns)
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * w + g + 8 * h;
    row_ok[h] = row < SG;
    pos[h] = row / G;
    m[h] = NEG_INF;
    l[h] = 0.f;
  }
  const float scale_log2 = scale * LOG2E;
  float acc[NP][32], sa[32];  // O's panels; S, then P
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sa[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[p][i] = 0.f;
  }

  for (int kj = lo; kj < hi; ++kj) {
    const int s = (kj - lo) & 1;
    if (kj + 1 < hi) {
      stage_kv(kj + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t sK = sK0 + s * TB, sV = sK0 + (2 + s) * TB;

    // S = Q K^T ([64 q rows, 64 keys], contraction over hd)
    fence_regs(sa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sa, desc_k_major(sQ, kk), desc_k_major(sK, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);

    // scale to base 2 and mask (after scaling: no NEG_INF - NEG_INF below);
    // column n of S is key kj TILE + n
    uint32_t okm = 0u;  // bit i: sa[i] is an unmasked pair
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kj * TILE + 8 * j + 2 * c + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool ok = row_ok[h] && unmasked(pos[h], key, S, causal, window);
          sa[i] = ok ? sa[i] * scale_log2 : NEG_INF;
          okm |= (uint32_t)ok << i;
          mx[h] = fmaxf(mx[h], sa[i]);
        }
      }
    }
    // the row max over the quad, then the correction of the running state:
    // exactly 1 where the tile is masked for the whole row (m_new = m)
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    // P in place of S, zero where masked; O's rows rescaled
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sa[i] = ((okm >> i) & 1u) ? exp2f(sa[i] - m[h]) : 0.f;
      l[h] += sa[i];
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[p][i] *= corr[h];
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_frag(sa, kk, pf[kk]);

    // O += P V: contraction over the keys, V MN-major, one panel of O at a time
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn(acc[p], pf[kk], desc_mn_major(sV + p * TILE_BYTES, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pf[kk]);
    __syncthreads();  // stage s is free for tile kj + 2
  }

  // the row sums over the quad (every lane takes part), then each row's
  // o and lse
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const float lsum = fmaxf(l[h], 1e-30f);
    const long long row = qrow0 + 16 * w + g + 8 * h;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      bf16* out = o + row * HD + 64 * p + 2 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (64 * p + 8 * j >= HD) continue;  // the zero-filled columns of hd 80 and 112
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16x2(acc[p][i] / lsum, acc[p][i + 1] / lsum);
      }
    }
    if (c == 0) lse[row] = m[h] * LN2 + logf(lsum);
  }
}

template <int HD, int BQ>
void launch_fp32(const void* q, const void* k, const void* v, void* o, void* lse, int bkv, int S,
                 int G, int causal, int window, float scale, cudaStream_t st) {
  const int nq = (S + BQ - 1) / BQ;
  flash_fwd_kernel<HD, BQ><<<bkv * nq, BQ * G * Fp32Tiles<HD>::TPR, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, G, nq, causal, window, scale);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bkv, int S,
           int G, int causal, int window, float scale, int dtype, cudaStream_t st) {
  static bool smem_set[hopper::kMaxDevices] = {};  // one flag array per head dim
  if (dtype == 0) {
    if (G <= 8)
      launch_fp32<HD, Fp32Tiles<HD>::BQ>(q, k, v, o, lse, bkv, S, G, causal, window, scale, st);
    else  // half the positions a block, so that BQ G TPR <= 256 (see the top note)
      launch_fp32<HD, Fp32Tiles<HD>::BQ / 2>(q, k, v, o, lse, bkv, S, G, causal, window, scale,
                                             st);
  } else if (dtype == 1) {
    // above 48 KB of dynamic shared memory (hd 80, 112 and 128) the limit must be raised
    if (HD > 64) {
      if (int rc = hopper::allow_smem(flash_fwd_wgmma_kernel<HD>, smem_bytes<HD>(), smem_set))
        return rc;
    }
    const int nqt = (S * G + TILE - 1) / TILE;
    flash_fwd_wgmma_kernel<HD><<<bkv * nqt, WG, smem_bytes<HD>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), bkv, S, G, causal, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core sweep), 1 = bfloat16 (tensor-core sweep);
// hd 64, 80, 112 or 128; G 1 .. 16. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bkv, int S, int G, int hd, int causal, int window, float scale,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > 16) return (int)cudaErrorInvalidValue;
  if (hd == 64) return launch<64>(q, k, v, o, lse, bkv, S, G, causal, window, scale, dtype, st);
  if (hd == 128) return launch<128>(q, k, v, o, lse, bkv, S, G, causal, window, scale, dtype, st);
  if (hd == 80) return launch<80>(q, k, v, o, lse, bkv, S, G, causal, window, scale, dtype, st);
  if (hd == 112) return launch<112>(q, k, v, o, lse, bkv, S, G, causal, window, scale, dtype, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The fp32 sweep's tiles (q positions, kv positions) at hd 64, the bf16
// sweep's (packed q rows, kv positions), the fp32 sweep's at hd 128, 80 and
// 112 (each for G <= 8; past G = 8 a block takes half the positions), checked
// by the wrapper against flash_attention.FP32_TILES, FLASH_BWD_ROWS and
// FLASH_BWD_KEYS; then the bf16 block's dynamic shared memory in bytes at hd
// 64, 128, 80 and 112.
extern "C" int flash_fwd_tiles(int* bq, int* bkv, int* rows, int* keys, int* bq128, int* bkv128,
                               int* bq80, int* bkv80, int* bq112, int* bkv112, int* smem,
                               int* smem128, int* smem80, int* smem112) {
  *bq = Fp32Tiles<64>::BQ;
  *bkv = Fp32Tiles<64>::BKV;
  *rows = TILE;
  *keys = TILE;
  *bq128 = Fp32Tiles<128>::BQ;
  *bkv128 = Fp32Tiles<128>::BKV;
  *bq80 = Fp32Tiles<80>::BQ;
  *bkv80 = Fp32Tiles<80>::BKV;
  *bq112 = Fp32Tiles<112>::BQ;
  *bkv112 = Fp32Tiles<112>::BKV;
  *smem = smem_bytes<64>();
  *smem128 = smem_bytes<128>();
  *smem80 = smem_bytes<80>();
  *smem112 = smem_bytes<112>();
  return 0;
}
