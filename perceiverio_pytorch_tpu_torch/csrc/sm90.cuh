// Hopper (sm_90a) building blocks of the port's hand-written kernels:
// cp.async copies and the loaders built on them, proxy and barrier fences,
// the core-matrix shared-memory layout that wgmma reads without a swizzle,
// wgmma descriptors, and the wgmma.mma_async products (bf16 x bf16 -> fp32)
// at every N of 8 to 256, each operand K-major or MN-major.
//
// Shared-memory layout.  A tile of R rows by C columns of bf16 (C a multiple
// of 8) is stored as 8 x 8 "core matrices" of 128 contiguous bytes (8 rows of
// 16 bytes).  The core matrix of rows 8i.. and columns 8j.. starts at byte
// i * (16 C) + j * 128.  This is wgmma's layout without a swizzle
// ("interleave"), and it takes any C that is a multiple of 8, so a ragged
// head width pads to the next multiple of 16 (322 -> 336) rather than to a
// whole 64-column swizzle atom (322 -> 384).  One loader serves every
// operand, and the descriptor says how the operand is read; in both cases
// LBO is the step between core matrices along K and SBO the step along M or
// N:
//   * K-major (the reduction dimension runs along the columns: Q, P, and K
//     as the B of S = Q K^T): LBO = 128 bytes, SBO = 16 C bytes;
//   * MN-major (the reduction dimension runs along the rows, with the
//     transpose flag TRANS_A or TRANS_B: V as the B of O = P V; a Q or dO
//     tile as the A of dK^T = Q^T dS or dV^T = dO^T P): LBO = 16 C bytes,
//     SBO = 128 bytes.
// Eight threads that copy 16 bytes each into rows 0..7 of one core matrix
// write 128 contiguous bytes, so the loaders walk rows fastest.
//
// The wgmma products read B from shared memory and A from shared memory, or
// (the _rA forms) from registers.  A thread's fragment of an m64nN fp32
// accumulator is N/2 floats: d[4j + 2h + c] holds row 16 w + l / 4 + 8 h,
// column 8 j + 2 (l % 4) + c, for warp w of the warpgroup and lane l.  A
// register A fragment of 64 x 16 bf16 is four 32-bit registers: a[i] holds
// the pair of columns 2 (l % 4) + 8 (i / 2), + 1 of row 16 w + l / 4 +
// 8 (i % 2) -- so the pairs (d[8k + 2i], d[8k + 2i + 1]) of an accumulator,
// rounded to bf16, are the A fragment of its columns 16k .. 16k + 15.
//
// Rows that are not 16-byte aligned (a 261-wide bf16 row is 522 bytes; an
// offset view) cannot take 16-byte cp.async copies.  The realigning loader
// reads the aligned 16-byte chunks that cover a row, shifts each pair of
// neighbours in registers by the row's offset within its chunk, and stores
// 16-byte chunks of the tile, zeros past the row's width: realign_rows
// loads the chunks into registers; cover_rows and shift_rows copy them into
// the tile with cp.async and shift them there in place.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a tile with C columns in the core-matrix
// layout.
__device__ __forceinline__ uint32_t cm_offset(int r, int c, int C) {
  return (uint32_t)((r >> 3) * (C * 16) + (c >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2);
}

// ---- cp.async: global -> shared without a register round trip ----------

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

// 16 bytes when `valid`, else 16 zero bytes (src is not read).
__device__ __forceinline__ void cp_async_16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes when `valid`, else 4 zero bytes (src is not read).
__device__ __forceinline__ void cp_async_4_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Makes the mbarrier track this thread's earlier cp.async copies: it
// receives one arrival when they have all landed (.noinc: the barrier's
// count includes that arrival).
__device__ __forceinline__ void cp_async_mbar_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- fences ----------------------------------------------------------------

// Makes this thread's writes to shared memory (st.shared, completed
// cp.async) visible to the async proxy that wgmma reads through.  Each
// writer issues it before the barrier that hands the tile to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Orders earlier register and shared-memory accesses before the wgmma that
// follow (needed whenever an accumulator was touched by other code).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that the accumulator registers change here, so that it
// moves no read of them across a wgmma_wait (the products write them
// asynchronously, which the asm operands alone do not say).
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of an operand in the core-matrix layout without a
// swizzle: start address, leading and stride byte offsets (all in 16-byte
// units; layout type 0, base offset 0).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// A descriptor moved on by `bytes` (a multiple of 16) in shared memory.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], A and B from shared memory, fp32
// accumulator d[N / 2]; TRANS_A = 1 reads A MN-major, TRANS_B = 1 reads B
// MN-major.  scale_d = 0 ignores the old accumulator.

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n8k16(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n16k16(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int N, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64k16(float* d, uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 8) wgmma_m64n8k16<TRANS_A, TRANS_B>(d, a, b, scale_d);
  else if constexpr (N == 16) wgmma_m64n16k16<TRANS_A, TRANS_B>(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_m64n32k16<TRANS_A, TRANS_B>(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16<TRANS_A, TRANS_B>(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_m64n128k16<TRANS_A, TRANS_B>(d, a, b, scale_d);
  else if constexpr (N == 256) wgmma_m64n256k16<TRANS_A, TRANS_B>(d, a, b, scale_d);
  else static_assert(N == 8, "wgmma_m64k16: N must be 8, 16, 32, 64, 128 or 256");
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N] with A from registers (four 32-bit
// registers of bf16 pairs, laid out as the header says), B from shared
// memory; TRANS_B = 1 reads B MN-major.

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_rA(float* d, const uint32_t* a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rA(float* d, const uint32_t* a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_m64k16_rA(float* d, const uint32_t* a, uint64_t b,
                                                int scale_d) {
  if constexpr (N == 32) wgmma_m64n32k16_rA<TRANS_B>(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16_rA<TRANS_B>(d, a, b, scale_d);
  else static_assert(N == 32, "wgmma_m64k16_rA: N must be 32 or 64");
}

// 2^x on the SFU (ex2.approx.ftz: results below 2^-126 flush to 0; 2^-inf
// is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as a bf16 pair in one register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N] for any N that is a multiple of 8,
// as products of 256, 128, ..., 8 columns from column OFF on: the product
// of columns c.. reads B from `b` moved on by (c / 8) * n8_bytes and
// accumulates into d[c / 2 ..].
template <int N, int TRANS_A, int TRANS_B, int OFF = 0>
__device__ __forceinline__ void wgmma_cols(float* d, uint64_t a, uint64_t b, uint32_t n8_bytes,
                                           int scale_d) {
  static_assert(N % 8 == 0, "wgmma_cols: N must be a multiple of 8");
  if constexpr (N > 0) {
    constexpr int n = N >= 256 ? 256 : N >= 128 ? 128 : N >= 64 ? 64 : N >= 32 ? 32
                    : N >= 16 ? 16 : 8;
    wgmma_m64k16<n, TRANS_A, TRANS_B>(d + OFF / 2, a, desc_add(b, (OFF / 8) * n8_bytes), scale_d);
    wgmma_cols<N - n, TRANS_A, TRANS_B, OFF + n>(d, a, b, n8_bytes, scale_d);
  }
}

// ---- barriers ----------------------------------------------------------------

// Barrier ID (1..15; 0 is __syncthreads) over the 128 threads of one
// warpgroup.  The id is an immediate: with a register id ptxas reserves all
// 16 of the block's barriers.
template <int ID>
__device__ __forceinline__ void warpgroup_sync() {
  static_assert(ID >= 1 && ID <= 15, "barrier 0 is __syncthreads");
  asm volatile("bar.sync %0, 128;\n" ::"n"(ID) : "memory");
}

// mbarriers in shared memory: init (once, before a __syncthreads), arrive
// (release), and a wait for the phase of the given parity (acquire).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra LAB_DONE;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- loaders ---------------------------------------------------------------

// Copies rows [0, rows) x columns [0, cols) of a bf16 matrix with row stride
// `ld` (elements) into a tile with C columns in the core-matrix layout, in
// units of E = VEC / 2 elements, with THREADS threads.  Thread tid takes row
// 8 i + tid % 8 and units tid / 8, tid / 8 + THREADS / 8, ...: eight threads
// fill one core matrix.  VEC = 2 copies through registers; the others are
// cp.async copies that the caller commits and waits for.
template <int THREADS, int VEC>
__device__ __forceinline__ void copy_rows(char* tile, const __nv_bfloat16* g, long long ld,
                                          int rows, int cols, int C, int tid) {
  constexpr int E = VEC / 2;
  const int units = cols / E;
  const int r8 = tid & 7;
#pragma unroll 1
  for (int r = r8; r < rows; r += 8) {
    const __nv_bfloat16* src = g + (long long)r * ld;
    for (int u = tid >> 3; u < units; u += THREADS / 8) {
      const int c = u * E;
      char* dst = tile + cm_offset(r, c, C);
      if constexpr (VEC == 2) {
        *reinterpret_cast<__nv_bfloat16*>(dst) = src[c];
      } else {
        cp_async<VEC>(smem_addr(dst), src + c);
      }
    }
  }
}

// copy_rows at the granularity `vec` (copy_vec) picked for the source.
template <int THREADS>
__device__ __forceinline__ void load_rows(char* tile, const __nv_bfloat16* g, long long ld,
                                          int rows, int cols, int C, int vec, int tid) {
  switch (vec) {
    case 16: copy_rows<THREADS, 16>(tile, g, ld, rows, cols, C, tid); break;
    case 8: copy_rows<THREADS, 8>(tile, g, ld, rows, cols, C, tid); break;
    case 4: copy_rows<THREADS, 4>(tile, g, ld, rows, cols, C, tid); break;
    default: copy_rows<THREADS, 2>(tile, g, ld, rows, cols, C, tid); break;
  }
}

// Largest copy granularity (bytes) that the base address, the batch, token
// and head strides (elements) and the row width all allow.
inline int copy_vec(const void* ptr, long long sb, long long st, long long sh, int width) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(ptr);
  for (int vec = 16; vec > 2; vec /= 2) {
    const long long bytes[4] = {sb * 2, st * 2, sh * 2, (long long)width * 2};
    bool ok = a % vec == 0;
    for (long long x : bytes) ok = ok && x % vec == 0;
    if (ok) return vec;
  }
  return 2;
}

// ---- the realigning loader -----------------------------------------------


// Bytes [off, off + 16) of the 32 bytes lo:hi (off even, 0 to 14).
__device__ __forceinline__ uint4 shift_chunk(const uint4& lo, const uint4& hi, int off) {
  const uint32_t wd[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const bool by2 = off & 8;     // two words first,
  const bool by1 = off & 4;     // then one,
  const int s = (off & 3) * 8;  // then 0 or 16 bits
  uint32_t x2[6], x1[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) x2[j] = by2 ? wd[j + 2] : wd[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) x1[j] = by1 ? x2[j + 1] : x2[j];
  return make_uint4(__funnelshift_r(x1[0], x1[1], s), __funnelshift_r(x1[1], x1[2], s),
                    __funnelshift_r(x1[2], x1[3], s), __funnelshift_r(x1[3], x1[4], s));
}

// A chunk with only its first `valid` bytes kept (valid even; <= 0: none).
__device__ __forceinline__ uint4 keep_bytes(uint4 c, long long valid) {
  if (valid >= 16) return c;
  uint32_t o[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long keep = valid - 4 * j;
    o[j] = keep >= 4 ? o[j] : keep >= 2 ? (o[j] & 0xFFFFu) : 0u;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Chunks c0 .. c0 + n - 1 (n <= NB; 8 columns each) of one row of a tile
// with C columns: the row's source starts at `row` (any 2-byte alignment)
// and holds `nbytes` valid bytes.  Loads the n + 1 aligned 16-byte chunks
// that cover them -- only those that hold a valid byte, so nothing outside
// the chunks of the row's first and last valid bytes is read -- shifts
// each neighbouring pair by the offset, zeroes the bytes past nbytes, and
// stores 16 bytes a chunk.
template <int NB>
__device__ __forceinline__ void realign_run(char* tile, const char* row, int nbytes, int r, int c0,
                                            int n, int C) {
  const unsigned long long first = reinterpret_cast<unsigned long long>(row) + 16ull * c0;
  const unsigned long long stop = reinterpret_cast<unsigned long long>(row) + nbytes;
  const int off = (int)(first & 15);
  const unsigned long long base = first - off;
  uint4 w[NB + 1];
#pragma unroll
  for (int i = 0; i <= NB; ++i) {
    const unsigned long long a = base + 16ull * i;
    if ((i < n || (i == n && off != 0)) && a < stop) {
      w[i] = __ldg(reinterpret_cast<const uint4*>(a));
    } else {
      w[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  char* dst = tile + cm_offset(r, 8 * c0, C);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    if (i < n) {
      // Valid bytes of this chunk: <= 0 past the row's end.
      const long long valid = (long long)stop - (long long)(first + 16ull * i);
      *reinterpret_cast<uint4*>(dst + 128 * i) =
          keep_bytes(shift_chunk(w[i], w[i + 1], off), valid);
    }
  }
}

// Rows [0, R) x columns [0, C) of a tile in the core-matrix layout (R a
// multiple of 8, C of 8) from a bf16 matrix with row stride `ld` (elements)
// at any 2-byte alignment: source rows [0, rows) x columns [0, cols), zeros
// elsewhere (pad columns, rows past the end), written through registers.
// Thread tid takes rows 8 i + tid % 8 of one octet of rows and a run of
// that octet's chunks (a share of R / 8 x C / 8 units, in runs of at most
// NB chunks, one aligned load a chunk and one more a run), so that eight
// threads store one core matrix and a thread's loads walk along its row.
template <int THREADS, int NB>
__device__ __forceinline__ void realign_rows(char* tile, const __nv_bfloat16* g, long long ld,
                                             int rows, int R, int cols, int C, int tid) {
  constexpr int G = THREADS / 8;
  const int nch = C >> 3;
  const int units = (R >> 3) * nch;
  const int per = (units + G - 1) / G;
  const int r8 = tid & 7;
  int u = (tid >> 3) * per;
  const int end = min(units, u + per);
  while (u < end) {
    const int oct = u / nch;
    const int c0 = u - oct * nch;
    const int n = min(NB, min(nch - c0, end - u));
    const int r = 8 * oct + r8;
    realign_run<NB>(tile, reinterpret_cast<const char*>(g + (long long)r * ld),
                    r < rows ? 2 * cols : 0, r, c0, n, C);
    u += n;
  }
}

// The narrow kernels' tile loader: rows [0, rows) x columns [0, cols) of a
// bf16 matrix with row stride `ld` into a tile of R rows and C columns,
// zeros elsewhere, with THREADS threads (thread tid from 0).  `aligned`
// (every row 16-byte aligned, so cols is a multiple of 8): 16-byte cp.async
// copies, zero-filled past the rows and columns, which the caller commits
// or tracks on an mbarrier; else the realigning loader, whose stores are
// done when it returns.
template <int THREADS, int R, int C>
__device__ __forceinline__ void load_tile(char* tile, const __nv_bfloat16* g, long long ld,
                                          int rows, int cols, bool aligned, int tid) {
  if (!aligned) {
    realign_rows<THREADS, 4>(tile, g, ld, rows, R, cols, C, tid);
    return;
  }
  constexpr int nch = C / 8;
#pragma unroll 4
  for (int u = tid; u < R * nch; u += THREADS) {
    const int r = ((u >> 3) / nch) * 8 + (u & 7);
    const int c = ((u >> 3) % nch) * 8;
    const bool ok = r < rows && c < cols;
    cp_async_16_zfill(smem_addr(tile + cm_offset(r, c, C)), ok ? g + (long long)r * ld + c : g,
                      ok);
  }
}

// The asynchronous form, in two passes over a tile with C columns.
// cover_rows copies, for each row r < rows, the aligned 16-byte chunks that
// hold a byte of the source row (columns [0, cols) at g + r ld, any 2-byte
// alignment) into chunk slots 0, 1, ... of tile row r, with 16-byte
// cp.async copies (the caller commits and waits, then syncs the block).
// It needs ceil((14 + 2 cols) / 16) <= C / 8 (cover_fits).  shift_rows then
// moves each such row left by its source's offset within its first chunk,
// in place: slot j < nout becomes bytes [16 j, 16 j + 16) of the row, zeros
// past its end.  nout = C / 8 writes every slot (a Q or K tile, whose pad
// columns enter the products and must be zero); a V tile may stop at
// ceil(cols / 8), since its pad columns feed only output columns that are
// dropped.  Rows past `rows` keep what they held.
__host__ __device__ __forceinline__ bool cover_fits(int cols, int C) {
  return (14 + 2 * cols + 15) / 16 <= C / 8;
}

template <int THREADS>
__device__ __forceinline__ void cover_rows(char* tile, const __nv_bfloat16* g, long long ld,
                                           int rows, int cols, int C, int tid) {
  const int r8 = tid & 7;
#pragma unroll 1
  for (int r = r8; r < rows; r += 8) {
    const unsigned long long a = reinterpret_cast<unsigned long long>(g + (long long)r * ld);
    const unsigned long long base = a & ~15ull;
    const int n = (int)((a - base + 2ull * cols + 15) >> 4);
    char* dst = tile + cm_offset(r, 0, C);
    for (int j = tid >> 3; j < n; j += THREADS / 8)
      cp_async<16>(smem_addr(dst + 128 * j), reinterpret_cast<const void*>(base + 16ull * j));
  }
}

// THREADS / R consecutive threads (lanes of one warp) share a row: each
// reads the slot after its run of slots, then, after a __syncwarp, shifts
// its run four slots at a time, reading slots j + 1 .. j + 4 before it
// writes slots j .. j + 3.
template <int THREADS, int R>
__device__ __forceinline__ void shift_rows(char* tile, const __nv_bfloat16* g, long long ld,
                                           int rows, int cols, int C, int nout, int tid) {
  constexpr int P = THREADS / R;
  static_assert(P >= 1 && 32 % P == 0, "shift_rows: a row's threads must share a warp");
  const int r = tid / P;
  const int per = (nout + P - 1) / P;
  const int j0 = (tid % P) * per;
  const int j1 = min(nout, j0 + per);
  char* row = tile + cm_offset(r, 0, C);
  const bool live = r < rows && j0 < j1;
  uint4 after = make_uint4(0u, 0u, 0u, 0u);
  if (live && j1 < C / 8) after = *reinterpret_cast<const uint4*>(row + 128 * j1);
  __syncwarp();
  if (!live) return;
  const int off = (int)(reinterpret_cast<unsigned long long>(g + (long long)r * ld) & 15);
  const long long nbytes = 2ll * cols;
  auto slot = [&](int j) { return reinterpret_cast<uint4*>(row + 128 * j); };
  uint4 cur = *slot(j0);
  int j = j0;
#pragma unroll 1
  for (; j + 4 <= j1; j += 4) {
    const uint4 n0 = *slot(j + 1), n1 = *slot(j + 2), n2 = *slot(j + 3);
    const uint4 n3 = j + 4 < j1 ? *slot(j + 4) : after;
    *slot(j) = keep_bytes(shift_chunk(cur, n0, off), nbytes - 16ll * j);
    *slot(j + 1) = keep_bytes(shift_chunk(n0, n1, off), nbytes - 16ll * (j + 1));
    *slot(j + 2) = keep_bytes(shift_chunk(n1, n2, off), nbytes - 16ll * (j + 2));
    *slot(j + 3) = keep_bytes(shift_chunk(n2, n3, off), nbytes - 16ll * (j + 3));
    cur = n3;
  }
#pragma unroll 1
  for (; j < j1; ++j) {
    const uint4 nxt = j + 1 < j1 ? *slot(j + 1) : after;
    *slot(j) = keep_bytes(shift_chunk(cur, nxt, off), nbytes - 16ll * j);
    cur = nxt;
  }
}

}  // namespace sm90
