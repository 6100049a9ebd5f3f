// Building blocks of the long-KV kernels (flash_attention_fwd_longkv_sm90.cu:
// K1; flash_attention_bwd_longkv_sm90.cu: K2 and K3), which stream the keys
// and values of a long walk through shared memory by TMA: the tensor maps
// (cuTensorMapEncodeTiled, looked up at run time), a TMA load counted on an
// mbarrier and the arrival that expects its bytes, the wgmma descriptors of
// 128- and 64-byte swizzled chunks, ring positions, named barriers, a
// wgmma wait of a count known only after unrolling, and the copy of rows
// that TMA cannot address (not 16-byte aligned: the pixel encoder's
// 522-byte rows, offset views) into 16-byte aligned rows.
//
// A chunk is a box of `rows` rows x 64 bf16 columns (128 bytes a row),
// written by TMA in wgmma's 128-byte swizzle: 8-row groups of 1024 bytes.
// Read K-major (the reduction along the columns: Q, K as S's operands), a
// k16 step moves 32 bytes on; read MN-major (the reduction along the rows: V
// as the B of P V, a Q or dO chunk as the A of dK^T or dV^T), 16 rows are
// 2048 bytes.  A chunk of 32 columns (64 bytes a row: the 704-wide K1's V
// chunks, an N = 32 operand read MN-major) takes the 64-byte swizzle: 8-row
// groups of 512 bytes, 16 rows 1024.  TMA zero-fills columns past the row's
// width and rows past the tensor's end, and counts the whole box's bytes on
// the barrier.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace longkv {

// One TMA copy of the box of `tmap` at (column, head, row, batch) into
// `dst`, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(char* dst, const CUtensorMap* tmap, int col, int h,
                                         int row, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(sm90::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(col), "r"(h), "r"(row), "r"(b),
      "r"(sm90::smem_addr(bar))
      : "memory");
}

// This thread's arrival on `bar`, which then also waits for `bytes`.
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   sm90::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A wgmma descriptor of a 128-byte swizzled chunk, K-major or MN-major (M
// or N = 64 columns, one atom): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t make_desc_sw128(const char* p) {
  return sm90::make_desc(sm90::smem_addr(p), 16, 1024) | (1ull << 62);
}

// The same of a 64-byte swizzled chunk of 32 columns (one atom), read
// MN-major: 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t make_desc_sw64(const char* p) {
  return sm90::make_desc(sm90::smem_addr(p), 16, 512) | (2ull << 62);
}

// Named barriers over N threads (0 is __syncthreads; the id an immediate:
// with a register id ptxas reserves all of the block's barriers).
template <int ID, int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

template <int ID, int N>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

// Slot c on from slot s0 of a ring of n slots (c <= n).
__device__ __forceinline__ int ring_at(int s0, int c, int n) {
  return s0 + c >= n ? s0 + c - n : s0 + c;
}

// wgmma.wait_group with a count known only after unrolling.
__device__ __forceinline__ void wgmma_wait_n(int n) {
  switch (n) {
    case 0: sm90::wgmma_wait<0>(); break;
    case 1: sm90::wgmma_wait<1>(); break;
    case 2: sm90::wgmma_wait<2>(); break;
    case 3: sm90::wgmma_wait<3>(); break;
    case 4: sm90::wgmma_wait<4>(); break;
    case 5: sm90::wgmma_wait<5>(); break;
    case 6: sm90::wgmma_wait<6>(); break;
    default: sm90::wgmma_wait<7>(); break;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (looked up at run time), or null.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A start and batch, token and head strides (elements) that are multiples
// of 16 bytes: what a TMA copy addresses (a row may end anywhere).
inline bool tma_aligned(const void* ptr, long long sb, long long st, long long sh) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 && sb * 2 % 16 == 0 &&
         st * 2 % 16 == 0 && sh * 2 % 16 == 0;
}

// A tensor map of a [B, T, H, W] bf16 tensor (strides in elements, every
// one of them and the address 16-byte aligned) in boxes of `rows` rows x 64
// columns at (column, head, row, batch), written to shared memory in wgmma's
// 128-byte swizzle (or of 32 columns in the 64-byte swizzle); columns past W
// and rows past T read as zeros.
inline bool make_tmap(CUtensorMap* map, const void* ptr, int B, int T, int H, int W,
                      long long sb, long long st, long long sh, int rows, int cols = 64) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || !tma_aligned(ptr, sb, st, sh)) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The copy into aligned rows: dst [B, T, H, W8] (contiguous, W8 = W rounded
// up to 8: 16-byte rows) from src [B, T, H, W] at any 2-byte aligned
// strides, zeros in columns [W, W8).  Eight columns a thread.
__global__ void copy_rows_kernel(const __nv_bfloat16* src, __nv_bfloat16* dst, int B, int T,
                                 int H, int W, int W8, long long sb, long long st,
                                 long long sh) {
  const long long units = (long long)B * T * H * (W8 / 8);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < units;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / (W8 / 8);
    const int c0 = (int)(i - row * (W8 / 8)) * 8;
    const int h = (int)(row % H);
    const long long bt = row / H;
    const __nv_bfloat16* s = src + (bt / T) * sb + (bt % T) * st + h * sh;
    __align__(16) __nv_bfloat16 out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = c0 + j < W ? s[c0 + j] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(dst + row * W8 + c0) = *reinterpret_cast<const uint4*>(out);
  }
}

// Launches copy_rows_kernel on `stream`; returns a cudaError_t.
inline int copy_rows(const void* src, void* dst, int batch, int t, int heads, int w, long long sb,
                     long long st, long long sh, void* stream) {
  if (batch < 1 || t < 1 || heads < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int w8 = (w + 7) / 8 * 8;
  const long long units = (long long)batch * t * heads * (w8 / 8);
  const long long blocks = (units + 255) / 256 < 132 * 16 ? (units + 255) / 256 : 132 * 16;
  copy_rows_kernel<<<(int)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(dst), batch, t, heads,
      w, w8, sb, st, sh);
  return (int)cudaGetLastError();
}

}  // namespace longkv
