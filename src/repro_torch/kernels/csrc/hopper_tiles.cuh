// Tile machinery for Hopper (sm_90a) tensor-core kernels: bf16 tiles of
// 64-element (128-byte) rows staged by cp.async into shared memory in the
// 128-byte swizzle, wgmma descriptors over them, and the m64n64k16 bf16
// products with fp32 accumulators (A from shared memory or from registers).
//
// Shared-memory tile: TILE_ROWS rows of 64 bf16, row r at byte 128 r, its
// 16-byte chunk c at chunk c ^ (r % 8) of the row (the layout TMA's
// SWIZZLE_128B writes and wgmma's 128B layout reads; the tile must start on
// a 1024-byte boundary, since the swizzle is taken from address bits).
// A row of hd = 128 bf16 (256 bytes) is staged as two such tiles, panels
// of 64 columns TILE_BYTES apart: columns 64 p .. 64 p + 63 in panel p. A
// K-major k-slice (16 columns) lies inside one panel, and an MN-major
// operand whose N is the head dim is taken one 64-wide panel (one swizzle
// atom) at a time, as one m64n64 product per panel. A row of hd = 80 is two
// panels too, the second zero-filled past column 79: a product contracting
// over the head dim takes the 5 live k16 slices, one whose N is the head dim
// computes the second panel's 64 columns, and only the first 16 are stored.
//
// Register fragments of one warpgroup (128 threads; warp w, lane l, g = l / 4,
// c = l % 4). The m64nN accumulator d[] holds rows 16 w + g (d[4 j + 0, 1])
// and 16 w + g + 8 (d[4 j + 2, 3]) at columns 8 j + 2 c and 8 j + 2 c + 1.
// An A operand in registers for k-slice kk (columns 16 kk .. 16 kk + 15) is
// then the accumulator's d[8 kk .. 8 kk + 7] packed in pairs to bf16x2: the
// accumulator of one product is the A operand of the next, with no shuffle.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int ROW_BYTES = 128;  // 64 bf16
constexpr int TILE_ROWS = 64;   // rows of one staged tile (the wgmma M)
constexpr int TILE_BYTES = TILE_ROWS * ROW_BYTES;
constexpr int WARPGROUP = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p in shared memory (the swizzled
// tiles need it; a kernel asks for 1024 bytes more dynamic shared memory)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// whether query position pos sees key position key (flash attention's masks)
__device__ __forceinline__ bool unmasked(int pos, int key, int S, int causal, int window) {
  return key < S && (!causal || key <= pos) && (!window || pos - key < window);
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read then)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// make this thread's generic-proxy writes to shared memory (cp.async, st.shared)
// visible to the async proxy that wgmma reads through; a barrier follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 64-column panels a staged row of HD bf16 takes: HD = 80 (zamba2) takes two,
// the second holding columns 64 .. 79 and zeros
template <int HD>
__host__ __device__ constexpr int panels() { return (HD + 63) / 64; }

// Stage a tile of TILE_ROWS rows of HD bf16 (row i at rows + HD i) into the
// swizzled tile at `tile` (panels<HD>() panels); rows >= nvalid, and the
// columns of the last panel past HD, are zero-filled (so they add nothing to
// a product that contracts over the head dim). All THREADS threads of the
// block call it; 8 panels<HD>() neighbouring threads stage one row.
template <int HD = 64, int THREADS = WARPGROUP>
__device__ __forceinline__ void stage_tile(uint32_t tile, const __nv_bfloat16* rows, int nvalid,
                                           int tid) {
  constexpr int NP = panels<HD>();
  constexpr int CHUNKS = 8 * NP;  // 16-byte chunks of a staged row
  constexpr int LIVE = HD / 8;    // of them, the ones that hold columns < HD
  constexpr int SHIFT = NP == 1 ? 3 : 4;
  static_assert(HD % 16 == 0 && NP <= 2 && TILE_ROWS * CHUNKS % THREADS == 0,
                "one or two panels, whole k16 slices, whole chunks a thread");
#pragma unroll
  for (int it = 0; it < TILE_ROWS * CHUNKS / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i >> SHIFT, ch = i & (CHUNKS - 1);
    if (LIVE == CHUNKS) {
      const bool ok = r < nvalid;
      cp_async_16(tile + (ch >> 3) * TILE_BYTES + r * ROW_BYTES + (((ch & 7) ^ (r & 7)) << 4),
                  rows + (ok ? r : 0) * HD + ch * 8, ok);
    } else {
      const bool ok = r < nvalid && ch < LIVE;
      cp_async_16(tile + (ch >> 3) * TILE_BYTES + r * ROW_BYTES + (((ch & 7) ^ (r & 7)) << 4),
                  rows + (ok ? r * HD + ch * 8 : 0), ok);
    }
  }
}

// wgmma descriptor of a 128B-swizzled tile: start address >> 4 (bits 0-13),
// leading byte offset >> 4 (16-29), stride byte offset >> 4 (32-45), layout
// 1 = 128B swizzle (62-63). The stride between 8-row groups is 1024 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// K-major operand (the contraction runs along the rows): k-slice kk of 16
// elements starts 32 bytes further into each row of its panel kk / 4; the
// leading offset is unused in this layout.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * TILE_BYTES + (kk & 3) * 32, 16);
}

// MN-major operand (the contraction runs along the rows, N = the 64 columns
// of one panel; pass the panel's address): k-slice kk is rows 16 kk .. 16 kk
// + 15, two 8-row groups 1024 bytes apart. N = 64 is one swizzle atom wide,
// so the leading offset (the next atom along N) is never taken; it is set to
// the group stride too.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * ROW_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of these registers across an
// asynchronous wgmma (call before it is issued and after wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand of k-slice kk from an m64n64 fp32 accumulator (see the top note)
__device__ __forceinline__ void acc_to_frag(const float (&d)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

#define HOPPER_D32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (acc_to_frag), B in
// shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef HOPPER_D32

// A kernel's dynamic shared memory limit, raised once per device at its first
// launch (above 48 KB it must be), so that a launch inside a CUDA graph
// capture makes no attribute call. `done` is the kernel's own flag array.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    if (cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
      return (int)e;
    done[dev] = true;
  }
  return 0;
}

}  // namespace hopper
