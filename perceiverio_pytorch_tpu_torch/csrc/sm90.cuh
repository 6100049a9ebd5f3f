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
// Every wgmma here reads both operands from shared memory.  A thread's
// fragment of an m64nN fp32 accumulator is N/2 floats: d[4j + 2h + c] holds
// row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + c, for warp w of the
// warpgroup and lane l.

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

}  // namespace sm90
