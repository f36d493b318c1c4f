// GQA flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:_dq_kernel and
// _dkv_kernel (Pallas, reached through _bwd / _flash_fn's custom VJP).
//
// Layout as the forward: q, do [BKV, S, G, hd]; k, v [BKV, S, hd]; lse and
// dl = rowsum(do * o) [BKV, S, G] fp32. dq like q, dk and dv like k. From
// them p = exp(scale q k^T - lse) (masked explicitly), ds = p (do v^T - dl),
// dq = scale ds k, dk = scale ds^T q and dv = p^T do, dk and dv summed over
// the G query heads of their kv head.
//
// What bounds it on this card: at the training shape (BKV = 24, S = 1024,
// G = 3, hd = 64, bf16, causal) the two sweeps read ~40 MB and write ~12 MB
// (about 15 us at 3.35 TB/s) against 6 hd (dq: three products) and 8 hd (dkv:
// four) flops per unmasked (row, key) pair, 1.57 million pairs per kv head:
// ~14.5 and ~19.3 GFLOP, 15 and 20 us on the 989 TFLOP/s bf16 tensor cores.
// So the bound is operations, and the products have to run on the tensor
// cores.
//
// bf16 inputs: two tensor-core sweeps (wgmma, bf16 operands, fp32
// accumulators), each writing only its own rows (no atomics: deterministic).
//   * Packed rows. The G query heads of a position are adjacent rows of q
//     and do, so for one kv head q and do are [S G, 64] matrices and row r
//     has position r / G. Both sweeps tile those rows, 64 to a tile (21 1/3
//     positions at G = 3), so no G wastes a tensor-core row; the causal and
//     window masks compare r / G with the key. A 64-wide bf16 row is 128
//     bytes, exactly the 128-byte swizzle of wgmma's shared-memory operands.
//   * dkv: one block (one warpgroup, 128 threads) per (kv tile of 64
//     positions, row of BKV), kv tile 0 first (the longest causal walk). K
//     and V stay in shared memory; the block walks the q-row tiles that see
//     the tile (dkv_row_tiles in flash_attention.py). Per tile: S^T = K Q^T
//     and dP^T = V dO^T (both operands K-major in shared memory); P^T and
//     dS^T in registers from lse and dl; then dV += P^T dO and dK += dS^T Q
//     with A from registers (the accumulators packed to bf16) and dO or Q
//     as an MN-major B (transpose bit).
//   * dq: one block per (q-row tile, row of BKV), last tile first; Q and dO
//     stay in shared memory, the block walks the kv tiles up to the diagonal
//     (dq_kv_tiles): S = Q K^T, dP = dO V^T, dQ += dS K (A from registers, K
//     MN-major).
//   * Overlap within a block: the first two products are committed as two
//     wgmma groups, so the exponentials of P run while the second product
//     does, and each later product is issued as soon as its operand is
//     packed (in dkv, dV += P^T dO runs while dS^T is formed).
//   * Staging: 16-byte cp.async into the swizzled layout, zero-filled past
//     the ragged edge, double-buffered: the next streamed tile (q, do, lse,
//     dl in dkv; K and V in dq) loads while the current one is used.
//   * Per block: 6 tiles of 8 KB (+ lse / dl in dkv) = 50 KB of dynamic
//     shared memory with the 1 KB alignment; four m64n64 fp32 accumulators
//     (dkv) or three (dq) of 32 registers a thread: ptxas gives dkv 220 and
//     dq 157 registers, no spills, so two dkv or three dq blocks share an
//     SM. The training shape launches 384 dkv and 1152 dq blocks on 132
//     SMs; the causal walks run 3 to 48 tiles (dkv) and 1 to 16 (dq),
//     longest first.
//   * Numbers: p and ds are rounded to bf16 as operands of the second
//     products (the plain versions keep them in fp32); the sums stay fp32.
//
// Head dim 128 (the paper's Gemma3-style ladder): rows of two 64-column
// panels (csrc/hopper_tiles.cuh), 8 k16 steps for the products that
// contract over hd, and one m64n64 product per panel for those whose N is
// hd. A staged tile is 16 KB.
//   * dq: one warpgroup; dQ is two m64n64 accumulators (64 registers a
//     thread) beside S and dP (32 each). Q, dO and 2 x (K, V) are 96 KB of
//     dynamic shared memory, two blocks an SM.
//   * dkv: dK and dV of a whole 128-wide row would be 128 accumulator
//     registers a thread, with S^T and dP^T 64 more and the bf16 operands
//     32: past the 255 a thread has, so it would spill. So a block is two
//     warpgroups, warpgroup p owning columns 64 p .. 64 p + 63 of dK and dV
//     (the hd-64 sweep's 32 + 32 registers). Each warpgroup recomputes the
//     full S^T and dP^T (both contract over all 128 dims) and multiplies
//     them into its panel of dO and Q. The cost: the two score products run
//     twice, 6 products of a tile instead of 4 (1.5x the tensor-core work of
//     dkv); the gain: no spills, the staged K, V, Q, dO tiles read by both
//     warpgroups from one copy. K, V and 2 x (Q, dO) are 96 KB (+ lse, dl),
//     one block (8 warps) an SM, as the hd-64 sweep's two blocks of 4.
//   * ptxas gives dq 201 and dkv 222 registers a thread at hd 128, no
//     spills.
//
// Head dim 80 (zamba2's shared block): hd 128's layout, two panels a row,
// the second zero-filled past column 79 when staged (csrc/hopper_tiles.cuh);
// the products that contract over hd take the 5 live k16 steps, dq keeps two
// m64n64 dQ accumulators and stores columns < 80, and dkv runs hd 128's two
// warpgroups, the second owning dK and dV's columns 64 .. 127 of which it
// stores 64 .. 79. Shared memory as hd 128's.
//
// Head dim 112 (kimi-k2): hd 80's route with columns 112 .. 127 zero-filled,
// 7 k16 steps for the products that contract over hd; dq stores columns <
// 112, dkv's second warpgroup its columns 64 .. 111.
//
// fp32 inputs keep the CUDA-core sweeps (no fp32 tensor-core product does
// the same arithmetic): blocks as above but over positions, TPR = hd / 32
// neighbouring threads share a row (32 dims each, float2 reads, float2
// group TPR i + t for part t; the dot products are summed across the group
// by shuffles), K/V (dq) or q/do (dkv) staged in shared memory as fp32. The
// shuffles' groups need a power of two, so hd 112 takes TPR = 4 parts of 28
// dims (hd / 32 would be 3). The tiles shrink with hd so that a thread holds
// the same registers and a block the same 32 KB of static shared memory: dq
// 16 (hd 64) or 8 (hd 112, 128) positions a block against staged K/V tiles
// of 4096 / hd keys (64, 51, 36, 32); dkv 32 keys a block against staged q/do
// tiles of 4096 / hd rows (each loop takes a ragged last tile). A dq block
// runs DQ_BQ G TPR = 32 G threads, so past G = 8 (mistral-large's 12) it
// takes half the positions (16 G threads, at most 256 up to G = 16); a row's
// arithmetic does not depend on them. dkv's blocks do not grow with G.
// Masked pairs are never computed in either route (explicit masking: they add
// exactly zero), and ragged tile edges are masked, so any S works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA-core sweeps over positions
// ---------------------------------------------------------------------------

// the fp32 sweeps' tiles at head dim HD (the bf16 sweeps' are below)
template <int HD>
struct Fp32Tiles {
  // threads a row, 32 dims each (40 at hd 80); a power of two, so hd 112
  // takes 4 parts of 28
  static constexpr int TPR = HD == 112 ? 4 : HD / 32;
  static constexpr int PART = HD / TPR;      // = 32 (40 at hd 80, 28 at hd 112)
  static constexpr int DQ_BQ = 32 / TPR;     // q positions per dq block at G <= 8 (x G x TPR)
  static constexpr int DQ_BKV = 4096 / HD;   // kv positions per staged K/V tile (dq)
  static constexpr int DKV_BKV = 32;         // kv positions per dkv block (times TPR threads)
  static constexpr int DKV_ROWS = 4096 / HD; // q rows (positions x G) per staged q/do tile
  static_assert(HD == TPR * PART && PART % 2 == 0, "whole float2 groups a thread");
};

// the lanes of this thread's group of TPR (for __shfl_xor_sync)
template <int TPR>
__device__ __forceinline__ unsigned group_mask() {
  return ((1u << TPR) - 1) << ((threadIdx.x & 31) & ~(TPR - 1));
}

template <int TPR>
__device__ __forceinline__ float group_sum(float d, unsigned mask) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) d += __shfl_xor_sync(mask, d, off);
  return d;
}

// part h of a row: its float2 groups TPR i + h, i < PART / 2
template <int HD>
__device__ __forceinline__ void load_part(const float* __restrict__ row, int h, float* dst) {
  constexpr int TPR = Fp32Tiles<HD>::TPR;
#pragma unroll
  for (int i = 0; i < Fp32Tiles<HD>::PART / 2; ++i) {
    dst[2 * i] = row[2 * (TPR * i + h)];
    dst[2 * i + 1] = row[2 * (TPR * i + h) + 1];
  }
}

template <int HD>
__device__ __forceinline__ void store_part(float* __restrict__ row, int h, const float* src,
                                           float mult) {
  constexpr int TPR = Fp32Tiles<HD>::TPR;
#pragma unroll
  for (int i = 0; i < Fp32Tiles<HD>::PART / 2; ++i) {
    row[2 * (TPR * i + h)] = mult * src[2 * i];
    row[2 * (TPR * i + h) + 1] = mult * src[2 * i + 1];
  }
}

// partial dot of a register part-row with the matching part of a shared row
template <int HD>
__device__ __forceinline__ float dot_part(const float* r, const float* srow, int h) {
  constexpr int TPR = Fp32Tiles<HD>::TPR;
  const float2* s2 = reinterpret_cast<const float2*>(srow);
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < Fp32Tiles<HD>::PART / 2; ++i) {
    const float2 x = s2[TPR * i + h];
    d = fmaf(r[2 * i], x.x, d);
    d = fmaf(r[2 * i + 1], x.y, d);
  }
  return d;
}

template <int HD>
__device__ __forceinline__ void axpy_part(float a, const float* srow, int h, float* acc) {
  constexpr int TPR = Fp32Tiles<HD>::TPR;
  const float2* s2 = reinterpret_cast<const float2*>(srow);
#pragma unroll
  for (int i = 0; i < Fp32Tiles<HD>::PART / 2; ++i) {
    const float2 x = s2[TPR * i + h];
    acc[2 * i] = fmaf(a, x.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(a, x.y, acc[2 * i + 1]);
  }
}

template <int HD, int DQ_BQ>
__global__ void __launch_bounds__(256) flash_dq_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dl,
    float* __restrict__ dq, int S, int G, int nq, int causal, int window, float scale) {
  using T = Fp32Tiles<HD>;
  constexpr int TPR = T::TPR, PART = T::PART, DQ_BKV = T::DQ_BKV;
  __shared__ __align__(16) float Ks[DQ_BKV][HD];
  __shared__ __align__(16) float Vs[DQ_BKV][HD];

  const int b = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // longest causal rows first
  const int tid = threadIdx.x;
  const int r = tid / TPR, h = tid % TPR;
  const int pos = qi * DQ_BQ + r / G;
  const bool row_ok = pos < S;
  const long long row = ((long long)b * S + (row_ok ? pos : 0)) * G + r % G;
  const unsigned gm = group_mask<TPR>();

  float qr[PART], dor[PART], acc[PART];
  load_part<HD>(q + row * HD, h, qr);
  load_part<HD>(dout + row * HD, h, dor);
#pragma unroll
  for (int i = 0; i < PART; ++i) acc[i] = 0.f;
  const float lse_r = lse[row], dl_r = dl[row];

  // visited kv tiles [lo, hi): visited_kv_range at tile sizes (DQ_BQ, DQ_BKV)
  const int nkv = (S + DQ_BKV - 1) / DQ_BKV;
  const int q_first = qi * DQ_BQ;
  int hi = nkv;
  if (causal) hi = min(nkv, (q_first + DQ_BQ - 1) / DQ_BKV + 1);
  int lo = 0;
  if (window)
    while (lo < hi - 1 && q_first - (lo * DQ_BKV + DQ_BKV - 1) >= window) ++lo;

  const float* kb = k + (long long)b * S * HD;
  const float* vb = v + (long long)b * S * HD;
  for (int kj = lo; kj < hi; ++kj) {
    const int kv0 = kj * DQ_BKV;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < DQ_BKV * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD;
      const bool ok = kv0 + j < S;
      const long long off = (long long)(kv0 + j) * HD + d;
      Ks[j][d] = ok ? kb[off] : 0.f;
      Vs[j][d] = ok ? vb[off] : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
    // the keys of this tile the row sees: [j_lo, j_hi)
    int j_hi = min(DQ_BKV, S - kv0);
    if (causal) j_hi = min(j_hi, pos - kv0 + 1);
    const int j_lo = window ? max(0, pos - window + 1 - kv0) : 0;
    for (int j = j_lo; j < j_hi; ++j) {
      const float s = group_sum<TPR>(dot_part<HD>(qr, Ks[j], h), gm);
      const float dp = group_sum<TPR>(dot_part<HD>(dor, Vs[j], h), gm);
      const float p = expf(s * scale - lse_r);
      axpy_part<HD>(p * (dp - dl_r), Ks[j], h, acc);
    }
  }
  if (row_ok) store_part<HD>(dq + row * HD, h, acc, scale);
}

template <int HD>
__global__ void __launch_bounds__(Fp32Tiles<HD>::TPR * Fp32Tiles<HD>::DKV_BKV)
    flash_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dl,
                          float* __restrict__ dk, float* __restrict__ dv, int S, int G, int nkv,
                          int causal, int window, float scale) {
  using T = Fp32Tiles<HD>;
  constexpr int TPR = T::TPR, PART = T::PART, DKV_BKV = T::DKV_BKV, DKV_ROWS = T::DKV_ROWS;
  __shared__ __align__(16) float Qs[DKV_ROWS][HD];
  __shared__ __align__(16) float Ds[DKV_ROWS][HD];
  __shared__ float Ls[DKV_ROWS], Dls[DKV_ROWS];

  const int b = blockIdx.x / nkv;
  const int kv0 = (int)(blockIdx.x % nkv) * DKV_BKV;
  const int tid = threadIdx.x;
  const int col = kv0 + tid / TPR, h = tid % TPR;
  const bool col_ok = col < S;
  const long long krow = (long long)b * S + (col_ok ? col : 0);
  const unsigned gm = group_mask<TPR>();

  float kr[PART], vr[PART], dka[PART], dva[PART];
  load_part<HD>(k + krow * HD, h, kr);
  load_part<HD>(v + krow * HD, h, vr);
#pragma unroll
  for (int i = 0; i < PART; ++i) dka[i] = dva[i] = 0.f;

  // q positions that see any key of this tile: from the causal diagonal to
  // the window's far edge
  const int p_lo = causal ? kv0 : 0;
  const int p_hi = window ? min(S, kv0 + DKV_BKV - 1 + window) : S;
  const int bq = DKV_ROWS / G;  // positions per staged q tile
  for (int p0 = p_lo; p0 < p_hi; p0 += bq) {
    const int nrows = min(bq, p_hi - p0) * G;
    const long long base = ((long long)b * S + p0) * G;  // first (position, head) row
    __syncthreads();
    for (int i = tid; i < nrows * HD; i += blockDim.x) {
      Qs[i / HD][i % HD] = q[base * HD + i];
      Ds[i / HD][i % HD] = dout[base * HD + i];
    }
    for (int i = tid; i < nrows; i += blockDim.x) {
      Ls[i] = lse[base + i];
      Dls[i] = dl[base + i];
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int rr = 0; rr < nrows; ++rr) {
      const int pos = p0 + rr / G;
      if ((causal && col > pos) || (window && pos - col >= window)) continue;
      const float s = group_sum<TPR>(dot_part<HD>(kr, Qs[rr], h), gm);
      const float dp = group_sum<TPR>(dot_part<HD>(vr, Ds[rr], h), gm);
      const float p = expf(s * scale - Ls[rr]);
      axpy_part<HD>(p, Ds[rr], h, dva);
      axpy_part<HD>(p * (dp - Dls[rr]), Qs[rr], h, dka);
    }
  }
  if (col_ok) {
    store_part<HD>(dk + krow * HD, h, dka, scale);
    store_part<HD>(dv + krow * HD, h, dva, 1.f);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core sweeps over packed rows
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using hopper::TILE_BYTES;
constexpr int TILE = hopper::TILE_ROWS;  // packed q rows and kv positions per tile
constexpr int WG = hopper::WARPGROUP;
constexpr float LOG2E = 1.4426950408889634f;
// dq: Q, dO, 2 x (K, V); dkv: K, V, 2 x (Q, dO, lse, dl); tiles of
// panels<HD>() panels; alignment
template <int HD>
constexpr int dq_smem() { return 6 * hopper::panels<HD>() * TILE_BYTES + 1024; }
template <int HD>
constexpr int dkv_smem() { return 6 * hopper::panels<HD>() * TILE_BYTES + 4 * TILE * 4 + 1024; }

// one warpgroup a block at hd 64 (two blocks an SM); at hd 80 and 128 one
// warpgroup per 64-column panel of dK and dV (see the top note)
template <int HD>
__global__ void __launch_bounds__(WG * hopper::panels<HD>(), HD == 64 ? 2 : 1)
    flash_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dl,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int bkv, int S, int G, int causal, int window,
    float scale) {
  using namespace hopper;
  constexpr int NP = panels<HD>();     // panels of a row, and warpgroups of the block
  constexpr int THREADS = NP * WG;
  constexpr int TB = NP * TILE_BYTES;  // bytes of one staged tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + TB;
  const uint32_t sQ0 = sK + 2 * TB;  // Q of stage s at sQ0 + s TB, dO at + 2 TB
  float* sL = reinterpret_cast<float*>(smem + 6 * TB);  // lse of stage s at sL + s TILE
  float* sDl = sL + 2 * TILE;

  const int tid = threadIdx.x;
  const int b = blockIdx.x % bkv;
  const int k0 = (blockIdx.x / bkv) * TILE;  // kv tile 0 first: the longest causal walk
  const int k1 = min(k0 + TILE, S);
  const int SG = S * G;
  // the q-row tiles that see a key of this tile (flash_attention.dkv_row_tiles)
  const int p_lo = causal ? k0 : 0;
  const int p_hi = window ? min(S, k1 - 1 + window) : S;  // positions [p_lo, p_hi)
  const int t_lo = p_lo * G / TILE, t_hi = (p_hi * G + TILE - 1) / TILE;

  const long long qbase = (long long)b * SG;  // first packed row of this kv head
  const bf16* qb = q + qbase * HD;
  const bf16* dob = dout + qbase * HD;
  const float* lb = lse + qbase;
  const float* dlb = dl + qbase;
  auto stage_q = [&](int t, int s) {
    const int r0 = t * TILE, n = min(TILE, SG - r0);
    stage_tile<HD, THREADS>(sQ0 + s * TB, qb + (long long)r0 * HD, n, tid);
    stage_tile<HD, THREADS>(sQ0 + (2 + s) * TB, dob + (long long)r0 * HD, n, tid);
    if (NP == 1 || tid < 2 * TILE) {
      const int i = tid & (TILE - 1);
      const float* src = (tid < TILE ? lb : dlb) + r0 + (i < n ? i : 0);
      cp_async_4(smem_u32((tid < TILE ? sL : sDl) + s * TILE + i), src, i < n);
    }
    cp_async_commit();
  };
  const long long kbase = ((long long)b * S + k0) * HD;
  stage_tile<HD, THREADS>(sK, k + kbase, k1 - k0, tid);  // in the first stage's group
  stage_tile<HD, THREADS>(sV, v + kbase, k1 - k0, tid);
  stage_q(t_lo, 0);

  // this warpgroup's panel of dK and dV, and its thread
  const int wg = NP == 1 ? 0 : tid / WG, t = NP == 1 ? tid : tid % WG;
  const int w = t >> 5, g = (t & 31) >> 2, c = t & 3;
  const int key_a = k0 + 16 * w + g;  // accumulator rows: keys key_a and key_a + 8
  const float scale_log2 = scale * LOG2E;
  float dK[32], dV[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dK[i] = dV[i] = st[i] = dpt[i] = 0.f;

  for (int t_ = t_lo; t_ < t_hi; ++t_) {
    const int s = (t_ - t_lo) & 1;
    if (t_ + 1 < t_hi) {
      stage_q(t_ + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t sQ = sQ0 + s * TB, sD = sQ0 + (2 + s) * TB;

    // S^T = K Q^T and dP^T = V dO^T ([64 keys, 64 q rows], contraction over
    // hd) as two groups; then dV += P^T dO and dK += dS^T Q (contraction over
    // the q rows, into this warpgroup's panel), each issued as soon as its
    // operand is formed, so the exponentials and the products overlap
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(st, desc_k_major(sK, kk), desc_k_major(sQ, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dpt, desc_k_major(sV, kk), desc_k_major(sD, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in
    fence_regs(st);

    // P^T in place, masked explicitly; column n is q row t_ TILE + n
    const float* L = sL + s * TILE;
    const float* Dl = sDl + s * TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * c + e, row = t_ * TILE + n;
        const int pos = row / G;
        const bool row_ok = row < SG;
        const float lse2 = L[n] * LOG2E;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool ok = row_ok && unmasked(pos, key_a + 8 * h, S, causal, window);
          st[i] = ok ? exp2f(fmaf(st[i], scale_log2, -lse2)) : 0.f;
        }
      }
    }
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_frag(st, kk, pf[kk]);
    fence_regs(dV);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(dV, pf[kk], desc_mn_major(sD + wg * TILE_BYTES, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in (dV may still run)
    fence_regs(dpt);

    // dS^T = P^T (dP^T - dl) in place: zero where P^T is masked to zero
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dln = Dl[8 * j + 2 * c + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          dpt[i] = st[i] * (dpt[i] - dln);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_frag(dpt, kk, dsf[kk]);
    fence_regs(dK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(dK, dsf[kk], desc_mn_major(sQ + wg * TILE_BYTES, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dV);
    fence_regs(dK);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pf[kk]);
      fence_regs(dsf[kk]);
    }
    __syncthreads();  // stage s is free for tile t_ + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_a + 8 * h;
    if (key >= S) continue;
    const long long off = ((long long)b * S + key) * HD + 64 * wg + 2 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (HD % 64 && 64 * wg + 8 * j >= HD) continue;  // the zero-filled columns of hd 80, 112
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack_bf16x2(scale * dK[i], scale * dK[i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_bf16x2(dV[i], dV[i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(WG, 2) flash_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dl,
    bf16* __restrict__ dq, int bkv, int S, int G, int causal, int window, float scale) {
  using namespace hopper;
  constexpr int NP = panels<HD>();     // 64-column panels of a row
  constexpr int TB = NP * TILE_BYTES;  // bytes of one staged tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem), sD = sQ + TB;
  const uint32_t sK0 = sQ + 2 * TB;  // K of stage s at sK0 + s TB, V at + 2 TB

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
  stage_tile<HD>(sD, dout + qrow0 * HD, nrows, tid);
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
  float lse2[2], dlr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // accumulator rows: q rows r0 + 16 w + g (+ 8)
    const int row = r0 + 16 * w + g + 8 * h;
    row_ok[h] = row < SG;
    pos[h] = row / G;
    lse2[h] = row_ok[h] ? lse[qrow0 - r0 + row] * LOG2E : 0.f;
    dlr[h] = row_ok[h] ? dl[qrow0 - r0 + row] : 0.f;
  }
  const float scale_log2 = scale * LOG2E;
  float dQ[NP][32], sa[32], dpa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sa[i] = dpa[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) dQ[p][i] = 0.f;
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

    // S = Q K^T and dP = dO V^T ([64 q rows, 64 keys], contraction over hd)
    // as two groups: P is formed while dP runs
    fence_regs(sa);
    fence_regs(dpa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sa, desc_k_major(sQ, kk), desc_k_major(sK, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dpa, desc_k_major(sD, kk), desc_k_major(sV, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();  // S is in
    fence_regs(sa);

    // P in place of S, masked explicitly; column n is key kj TILE + n
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kj * TILE + 8 * j + 2 * c + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool ok = row_ok[h] && unmasked(pos[h], key, S, causal, window);
          sa[i] = ok ? exp2f(fmaf(sa[i], scale_log2, -lse2[h])) : 0.f;
        }
      }
    }
    wgmma_wait<0>();  // dP is in
    fence_regs(dpa);
    // dS = P (dP - dl) in place of dP: zero where P is masked to zero
#pragma unroll
    for (int i = 0; i < 32; ++i) dpa[i] = sa[i] * (dpa[i] - dlr[(i >> 1) & 1]);
    uint32_t dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_frag(dpa, kk, dsf[kk]);

    // dQ += dS K: contraction over the keys, one panel of dQ at a time
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(dQ[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn(dQ[p], dsf[kk], desc_mn_major(sK + p * TILE_BYTES, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(dQ[p]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(dsf[kk]);
    __syncthreads();  // stage s is free for tile kj + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      bf16* out = dq + (qrow0 + 16 * w + g + 8 * h) * HD + 64 * p + 2 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (64 * p + 8 * j >= HD) continue;  // the zero-filled columns of hd 80 and 112
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16x2(scale * dQ[p][i], scale * dQ[p][i + 1]);
      }
    }
  }
}

int check(int G, int hd, int dtype) {
  if ((hd != 64 && hd != 80 && hd != 112 && hd != 128) || G < 1 || G > 16 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int HD, int DQ_BQ>
void launch_dq_fp32(const void* q, const void* k, const void* v, const void* dout, const float* l,
                    const float* d, void* dq, int bkv, int S, int G, int causal, int window,
                    float scale, cudaStream_t st) {
  const int nq = (S + DQ_BQ - 1) / DQ_BQ;
  flash_dq_fp32_kernel<HD, DQ_BQ><<<bkv * nq, DQ_BQ * G * Fp32Tiles<HD>::TPR, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), l, d, static_cast<float*>(dq), S, G, nq, causal, window,
      scale);
}

// the dynamic shared memory limit of each bf16 sweep is raised once per device
// (hopper::allow_smem), with one flag array per sweep and head dim

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* l,
              const float* d, void* dq, int bkv, int S, int G, int causal, int window,
              float scale, int dtype, cudaStream_t st) {
  static bool smem_set[hopper::kMaxDevices] = {};
  if (dtype == 0) {
    constexpr int BQ = Fp32Tiles<HD>::DQ_BQ;
    if (G <= 8)
      launch_dq_fp32<HD, BQ>(q, k, v, dout, l, d, dq, bkv, S, G, causal, window, scale, st);
    else  // half the positions a block, so that DQ_BQ G TPR <= 256 (see the top note)
      launch_dq_fp32<HD, BQ / 2>(q, k, v, dout, l, d, dq, bkv, S, G, causal, window, scale, st);
  } else {
    if (int rc = hopper::allow_smem(flash_dq_wgmma_kernel<HD>, dq_smem<HD>(), smem_set))
      return rc;
    const int nqt = (S * G + TILE - 1) / TILE;
    flash_dq_wgmma_kernel<HD><<<bkv * nqt, WG, dq_smem<HD>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), l, d, static_cast<bf16*>(dq), bkv, S, G, causal, window,
        scale);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* l,
               const float* d, void* dk, void* dv, int bkv, int S, int G, int causal, int window,
               float scale, int dtype, cudaStream_t st) {
  static bool smem_set[hopper::kMaxDevices] = {};
  if (dtype == 0) {
    using T = Fp32Tiles<HD>;
    const int nkv = (S + T::DKV_BKV - 1) / T::DKV_BKV;
    flash_dkv_fp32_kernel<HD><<<bkv * nkv, T::TPR * T::DKV_BKV, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, d, static_cast<float*>(dk), static_cast<float*>(dv),
        S, G, nkv, causal, window, scale);
  } else {
    if (int rc = hopper::allow_smem(flash_dkv_wgmma_kernel<HD>, dkv_smem<HD>(), smem_set))
      return rc;
    const int nkt = (S + TILE - 1) / TILE;
    flash_dkv_wgmma_kernel<HD><<<bkv * nkt, WG * hopper::panels<HD>(), dkv_smem<HD>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), l, d, static_cast<bf16*>(dk), static_cast<bf16*>(dv), bkv,
        S, G, causal, window, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core sweeps), 1 = bfloat16 (tensor-core sweeps);
// hd 64, 80, 112 or 128; G 1 .. 16. Each returns cudaGetLastError() after
// its launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* dl, void* dq, int bkv, int S, int G, int hd,
                        int causal, int window, float scale, int dtype, void* stream) {
  if (int rc = check(G, hd, dtype)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dl);
  if (hd == 64)
    return launch_dq<64>(q, k, v, dout, l, d, dq, bkv, S, G, causal, window, scale, dtype, st);
  if (hd == 80)
    return launch_dq<80>(q, k, v, dout, l, d, dq, bkv, S, G, causal, window, scale, dtype, st);
  if (hd == 112)
    return launch_dq<112>(q, k, v, dout, l, d, dq, bkv, S, G, causal, window, scale, dtype, st);
  return launch_dq<128>(q, k, v, dout, l, d, dq, bkv, S, G, causal, window, scale, dtype, st);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dl, void* dk, void* dv, int bkv, int S, int G,
                         int hd, int causal, int window, float scale, int dtype, void* stream) {
  if (int rc = check(G, hd, dtype)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dl);
  if (hd == 64)
    return launch_dkv<64>(q, k, v, dout, l, d, dk, dv, bkv, S, G, causal, window, scale, dtype,
                          st);
  if (hd == 80)
    return launch_dkv<80>(q, k, v, dout, l, d, dk, dv, bkv, S, G, causal, window, scale, dtype,
                          st);
  if (hd == 112)
    return launch_dkv<112>(q, k, v, dout, l, d, dk, dv, bkv, S, G, causal, window, scale, dtype,
                           st);
  return launch_dkv<128>(q, k, v, dout, l, d, dk, dv, bkv, S, G, causal, window, scale, dtype,
                         st);
}

// The bf16 sweeps' tiles (packed q rows, kv positions), checked by the wrapper
// against flash_attention.FLASH_BWD_ROWS / FLASH_BWD_KEYS, and their dynamic
// shared memory per block in bytes (dq, dkv) at hd 64, then at hd 128, 80
// and 112.
extern "C" int flash_bwd_tiles(int* rows, int* keys, int* dq_smem64, int* dkv_smem64,
                               int* dq_smem128, int* dkv_smem128, int* dq_smem80,
                               int* dkv_smem80, int* dq_smem112, int* dkv_smem112) {
  *rows = TILE;
  *keys = TILE;
  *dq_smem64 = dq_smem<64>();
  *dkv_smem64 = dkv_smem<64>();
  *dq_smem128 = dq_smem<128>();
  *dkv_smem128 = dkv_smem<128>();
  *dq_smem80 = dq_smem<80>();
  *dkv_smem80 = dkv_smem<80>();
  *dq_smem112 = dq_smem<112>();
  *dkv_smem112 = dkv_smem<112>();
  return 0;
}

extern "C" const char* flash_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
