// Flash attention forward for Hopper (sm_90a): one hand-written kernel.
//
// Replaces `_flash_kernel` (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py,
// launched by `_flash_forward` through `pl.pallas_call`).  Same semantics:
//   out = softmax(scale * Q K^T) V per (batch, head), online softmax over key
//   tiles with an fp32 running max m, sum l and accumulator; the scale is
//   applied after the QK^T product; keys at or beyond kv_len and keys whose
//   kv_mask byte is 0 get probability 0; a row whose keys are all masked
//   gives exactly 0; rows whose q_mask byte is 0 are written as 0; the
//   optional lse is m + log(l), +inf where l == 0 (q_mask does not touch it).
//   Inputs fp32 or bf16, all arithmetic in IEEE fp32 on the CUDA cores: no
//   TF32, no tensor cores, and no fast-math intrinsics.
//
// What bounds it on an H100.  Every flow site is compute-bound.  Per 368x496
// tile: the encoder cross-attend (2048 queries x 182,528 keys, d = 322) is
// 4.8e11 FLOP, each of the 24 latent self-attends (2048 x 2048, 16 heads of
// d = 32) 8.6e9 FLOP, the decoder cross-attend (182,528 queries x 2048 keys,
// d = 512) 7.7e11 FLOP, against at most about 0.5 GB read per site (the
// encoder's K and V in fp32): far above the card's FLOP-per-byte balance.
//
// Design.  One block of 256 threads (16 x 16) owns 64 query rows of one
// (batch, head) and walks all key tiles of 64 keys in a loop (the Pallas
// grid's sequential K axis).  The block's Q rows stay in shared memory for
// the whole walk, transposed and in fp32 (64 x 512 x 4 B = 128 KB at d = 512),
// so Q is read from device memory once.  Per key tile:
//   1. S = Q K^T: K is staged 32 head dims at a time; each thread holds a
//      4 x 4 register tile of S (rows ty*4.., keys tx*4..).  A ragged head
//      width (322, 41) is zero-padded inside shared memory to a multiple
//      of 32, which leaves Q K^T unchanged.
//   2. Masking by key index and kv_mask, then the online-softmax update; the
//      row max and sum are reduced over the 16 threads of a row by warp
//      shuffles.  P goes to shared memory, transposed.
//   3. O += P V: V is staged 64 columns at a time; each thread keeps a
//      4 x 4 register tile of O per 64-column chunk.  The template argument
//      NV (chunks of 64 value columns, up to 8 for d = 512) sizes that
//      register accumulator, so a 512-wide fp32 row never leaves registers:
//      it is spread over the 16 threads of the row.
// Ragged Tk is handled by masking keys at or past kv_len and zero-filling the
// staged K and V rows.
//
// What it does not do yet.  It uses neither wgmma nor TMA, and stages tiles
// with plain loads and no double buffering, so it reaches a fraction of the
// fp32 CUDA-core peak and none of the tensor-core rate that bf16 allows.  Its
// grid is one block per 64 query rows: the encoder site at batch 1 (one head,
// 2048 queries) launches 32 blocks on 132 SMs.  Splitting the key walk over
// blocks (split-KV, with a merge of the partial m/l/O) is later work, as are
// head widths above 512 (multimodal's 704).
//
// Interface: a plain C function, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int DC = 32;         // head dims per staged K chunk
constexpr int VC = 64;         // value columns per staged V chunk
constexpr int THREADS = 256;   // 16 x 16
constexpr int KT_LD = BK + 4;  // row length of the transposed K chunk
constexpr int PT_LD = BQ + 4;  // row length of the transposed P tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kv_mask;  // [B, Tk] or null
  const uint8_t* q_mask;   // [B, Tq] or null
  void* out;               // [B, Tq, H, Dv], contiguous
  float* lse;              // [B, H, Tq] or null
  int H, Tq, Tk, kv_len, D, Dv, Dp;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
};

size_t smem_bytes(int Dp) {
  return sizeof(float) *
         ((size_t)Dp * BQ + (size_t)DC * KT_LD + (size_t)BK * PT_LD + (size_t)BK * VC);
}

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [Dp][BQ]
  float* Kt = Qt + (size_t)p.Dp * BQ;           // [DC][KT_LD]
  float* Pt = Kt + DC * KT_LD;                  // [BK][PT_LD]
  float* Vs = Pt + BK * PT_LD;                  // [BK][VC]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;

  // The block's Q rows, transposed to [d][row], fp32, zero-padded.
  for (int idx = tid; idx < BQ * p.Dp; idx += THREADS) {
    const int i = idx / p.Dp;
    const int d = idx - i * p.Dp;
    float val = 0.f;
    if (q0 + i < p.Tq && d < p.D) val = to_f(qg[(long long)(q0 + i) * p.q_st + d]);
    Qt[d * BQ + i] = val;
  }

  float m_i[4], l_i[4];
  float acc[NV][4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
  }
#pragma unroll
  for (int mv = 0; mv < NV; ++mv)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mv][r][c] = 0.f;

  const int n_tiles = (p.kv_len + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;

    // 1. S = Q K^T over head-dim chunks.
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;

    for (int d0 = 0; d0 < p.Dp; d0 += DC) {
      __syncthreads();  // Qt written / previous Kt and Pt reads done
      for (int idx = tid; idx < BK * DC; idx += THREADS) {
        const int j = idx / DC;
        const int dd = idx - j * DC;
        const int key = k0 + j;
        const int d = d0 + dd;
        float val = 0.f;
        if (key < p.kv_len && d < p.D) val = to_f(kg[(long long)key * p.k_st + d]);
        Kt[dd * KT_LD + j] = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float4 qa = *reinterpret_cast<const float4*>(&Qt[(d0 + dd) * BQ + ty * 4]);
        const float4 kb = *reinterpret_cast<const float4*>(&Kt[dd * KT_LD + tx * 4]);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
      }
    }

    // 2. Scale, mask, online softmax.
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + tx * 4 + c;
      ok[c] = key < p.kv_len && (kvm == nullptr || kvm[key] != 0);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = ok[c] ? s[r][c] * p.scale : -INFINITY;
        rmax = fmaxf(rmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m_i[r], rmax);
      // Rows with every key masked so far: exp(-inf - -inf) would be NaN.
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m_i[r] == -INFINITY) ? 0.f : expf(m_i[r] - m_safe);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_safe);
        rsum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_i[r] = l_i[r] * alpha + rsum;
      m_i[r] = m_new;
#pragma unroll
      for (int mv = 0; mv < NV; ++mv)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mv][r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + c) * PT_LD + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);

    // 3. O += P V over value-column chunks.
#pragma unroll
    for (int mv = 0; mv < NV; ++mv) {
      const int c0 = mv * VC;
      if (c0 < p.Dv) {  // uniform over the block
        __syncthreads();  // Pt written / previous Vs reads done
        for (int idx = tid; idx < BK * VC; idx += THREADS) {
          const int j = idx / VC;
          const int cc = idx - j * VC;
          const int key = k0 + j;
          const int col = c0 + cc;
          float val = 0.f;
          if (key < p.kv_len && col < p.Dv) val = to_f(vg[(long long)key * p.v_st + col]);
          Vs[j * VC + cc] = val;
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < BK; ++j) {
          const float4 pa = *reinterpret_cast<const float4*>(&Pt[j * PT_LD + ty * 4]);
          const float4 vb = *reinterpret_cast<const float4*>(&Vs[j * VC + tx * 4]);
          const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
          const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mv][r][c] = fmaf(pv[r], vv[c], acc[mv][r][c]);
        }
      }
    }
  }

  // Finalise: divide by l, wipe empty and q-masked rows, write lse.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= p.Tq) continue;
    const bool keep = p.q_mask == nullptr || p.q_mask[(long long)b * p.Tq + i] != 0;
    const float l = l_i[r];
    const float l_safe = (l == 0.f) ? 1.f : l;
    T* og = static_cast<T*>(p.out) + ((long long)b * p.Tq + i) * p.H * p.Dv +
            (long long)h * p.Dv;
#pragma unroll
    for (int mv = 0; mv < NV; ++mv)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = mv * VC + tx * 4 + c;
        if (col < p.Dv) og[col] = from_f<T>(keep ? acc[mv][r][c] / l_safe : 0.f);
      }
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.H + h) * p.Tq + i] =
          (l == 0.f) ? INFINITY : m_i[r] + logf(l_safe);
  }
}

template <typename T, int NV>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, batch);
  flash_fwd_kernel<T, NV><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  const int nv = (p.Dv + VC - 1) / VC;
  if (nv <= 1) return launch<T, 1>(p, batch, stream);
  if (nv <= 2) return launch<T, 2>(p, batch, stream);
  if (nv <= 3) return launch<T, 3>(p, batch, stream);
  if (nv <= 4) return launch<T, 4>(p, batch, stream);
  if (nv <= 6) return launch<T, 6>(p, batch, stream);
  if (nv <= 8) return launch<T, 8>(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Strides are in elements; the head dim of q, k
// and v must be contiguous.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask, const void* q_mask,
    void* out, void* lse, int dtype, int batch, int heads, int tq, int tk, int kv_len,
    int d, int dv, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
    float scale, void* stream) {
  if (d < 1 || d > 512 || dv < 1 || dv > 512 || kv_len < 0 || kv_len > tk)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.q_mask = static_cast<const uint8_t*>(q_mask);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.H = heads;
  p.Tq = tq;
  p.Tk = tk;
  p.kv_len = kv_len;
  p.D = d;
  p.Dv = dv;
  p.Dp = (d + DC - 1) / DC * DC;
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, batch, s)
                  : dtype == 1 ? dispatch<__nv_bfloat16>(p, batch, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}
