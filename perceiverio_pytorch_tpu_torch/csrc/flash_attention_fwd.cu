// Flash attention forward for fp32 inputs on Hopper (sm_90a), and the merge
// of split-KV partials for both forward kernels.
//
// Replaces `_flash_kernel` (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py,
// launched by `_flash_forward` through `pl.pallas_call`) for fp32 q, k, v;
// bf16 inputs take the wgmma kernel in flash_attention_fwd_sm90.cu.  Same
// semantics:
//   out = softmax(scale * Q K^T) V per (batch, head), online softmax over key
//   tiles with an fp32 running max m, sum l and accumulator; the scale is
//   applied after the QK^T product; keys at or beyond kv_len and keys whose
//   kv_mask byte is 0 get probability 0; a row whose keys are all masked
//   gives exactly 0; rows whose q_mask byte is 0 are written as 0; the
//   optional lse is m + log(l), +inf where l == 0 (q_mask does not touch it).
//   All arithmetic in IEEE fp32 on the CUDA cores: no TF32, no tensor cores,
//   and no fast-math intrinsics, so that fp32 callers get fp32 results.
//
// What bounds it on an H100.  Every flow site is compute-bound.  Per 368x496
// tile: the encoder cross-attend (2048 queries x 182,528 keys, d = 322) is
// 4.8e11 FLOP, each of the 24 latent self-attends (2048 x 2048, 16 heads of
// d = 32) 8.6e9 FLOP, the decoder cross-attend (182,528 queries x 2048 keys,
// d = 512) 7.7e11 FLOP, against at most about 0.5 GB read per site (the
// encoder's K and V in fp32): far above the card's FLOP-per-byte balance.
//
// Design.  One block of 256 threads (16 x 16) owns 64 query rows of one
// (batch, head) and walks the key tiles of 64 keys of its split in a loop
// (the Pallas grid's sequential K axis).  The block's Q rows stay in shared
// memory for the whole walk, transposed and in fp32 (64 x 512 x 4 B = 128 KB
// at d = 512), so Q is read from device memory once.  Per key tile:
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
// Widths above 512 (the multimodal encoder: d = dv = 704).  The resident Q
// takes 704 x 64 x 4 = 176 KB, 218 KB with the staged K, P and V tiles:
// inside the 227 KB a block may use.  Eleven 64-column chunks of O would be
// 176 accumulator registers a thread, so the value columns are split over a
// grid axis of column chunks instead (the wrapper's `col_chunks`: 384 + 320
// at 704, NV = 6): each block recomputes S at the full d and accumulates
// only its columns.  The chunks compute S in the same order, so chunk 0
// alone writes the row's m, l and lse.
//
// Split-KV.  The grid is (q blocks x column chunks x splits, heads, batch):
// a block walks only the key tiles of its split, so a grid that is short of
// query blocks (the encoder at batch 1: 32) still fills the card.  With more than one
// split a block writes its unnormalised O, m and l in fp32 to a workspace,
// and `merge_kernel` below combines the splits of each row in split order
// (deterministic, no atomics), divides by l, applies q_mask and writes the
// lse.  The wrapper (ops/flash_attention.py `_split_plan`) picks the split
// count; the bf16 kernel writes the same partials and uses the same merge.
//
// What it does not do yet: it stages tiles with plain loads and no double
// buffering, and reaches a fraction of the fp32 CUDA-core peak.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes.  They launch on the given stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().

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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* kv_mask;  // [B, Tk] or null
  const uint8_t* q_mask;   // [B, Tq] or null
  float* out;              // [B, Tq, H, Dv], contiguous (one split)
  float* lse;              // [B, H, Tq] or null (one split)
  float* part_o;           // [S, B, H, Tq, Dv] (splits > 1)
  float* part_m;           // [S, B, H, Tq]
  float* part_l;           // [S, B, H, Tq]
  int B, H, Tq, Tk, kv_len, D, Dv, Dp;
  int n_qblocks, n_tiles, tiles_per_split, splits;
  int col_chunks, CW;  // chunk c: value columns [c CW, min((c + 1) CW, Dv))
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
};

size_t smem_bytes(int Dp) {
  return sizeof(float) *
         ((size_t)Dp * BQ + (size_t)DC * KT_LD + (size_t)BK * PT_LD + (size_t)BK * VC);
}

// CHUNKED: the grid splits the value columns (col_chunks > 1, widths above
// 512).  Without it the chunk is 0 and spans Dv at compile time, so the
// kernels of the narrower widths compile as they did before the chunks.
template <int NV, bool CHUNKED>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [Dp][BQ]
  float* Kt = Qt + (size_t)p.Dp * BQ;           // [DC][KT_LD]
  float* Pt = Kt + DC * KT_LD;                  // [BK][PT_LD]
  float* Vs = Pt + BK * PT_LD;                  // [BK][VC]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qb = blockIdx.x % p.n_qblocks;
  const int chunk = CHUNKED ? (blockIdx.x / p.n_qblocks) % p.col_chunks : 0;
  const int split = blockIdx.x / (CHUNKED ? p.n_qblocks * p.col_chunks : p.n_qblocks);
  const int q0 = qb * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t_begin = split * p.tiles_per_split;
  const int t_end = min(p.n_tiles, t_begin + p.tiles_per_split);
  const int cbase = chunk * p.CW;                            // this block's first value column
  const int dv_blk = CHUNKED ? min(p.CW, p.Dv - cbase) : p.Dv;  // and its number of them

  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh + cbase;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;

  // The block's Q rows, transposed to [d][row], fp32, zero-padded.
  for (int idx = tid; idx < BQ * p.Dp; idx += THREADS) {
    const int i = idx / p.Dp;
    const int d = idx - i * p.Dp;
    float val = 0.f;
    if (q0 + i < p.Tq && d < p.D) val = qg[(long long)(q0 + i) * p.q_st + d];
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

  for (int t = t_begin; t < t_end; ++t) {
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
        if (key < p.kv_len && d < p.D) val = kg[(long long)key * p.k_st + d];
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
      if (c0 < dv_blk) {  // uniform over the block
        __syncthreads();  // Pt written / previous Vs reads done
        for (int idx = tid; idx < BK * VC; idx += THREADS) {
          const int j = idx / VC;
          const int cc = idx - j * VC;
          const int key = k0 + j;
          const int col = c0 + cc;
          float val = 0.f;
          if (key < p.kv_len && col < dv_blk) val = vg[(long long)key * p.v_st + col];
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

  // Finalise.  One split: divide by l, wipe empty and q-masked rows, write
  // lse.  Several: write this split's unnormalised O, m and l.
  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= p.Tq) continue;
    const float l = l_i[r];
    const bool row_writer = chunk == 0 && tx == 0;  // every chunk holds the same m, l
    if (p.splits > 1) {
      const long long row = ((long long)split * p.B * p.H + bh) * p.Tq + i;
      float* po = p.part_o + row * p.Dv + cbase;
#pragma unroll
      for (int mv = 0; mv < NV; ++mv)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = mv * VC + tx * 4 + c;
          if (col < dv_blk) po[col] = acc[mv][r][c];
        }
      if (row_writer) {
        p.part_m[row] = (l == 0.f) ? -INFINITY : m_i[r];
        p.part_l[row] = l;
      }
      continue;
    }
    const bool keep = p.q_mask == nullptr || p.q_mask[(long long)b * p.Tq + i] != 0;
    const float l_safe = (l == 0.f) ? 1.f : l;
    float* og = p.out + ((long long)b * p.Tq + i) * p.H * p.Dv + (long long)h * p.Dv + cbase;
#pragma unroll
    for (int mv = 0; mv < NV; ++mv)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = mv * VC + tx * 4 + c;
        if (col < dv_blk) og[col] = keep ? acc[mv][r][c] / l_safe : 0.f;
      }
    if (p.lse != nullptr && row_writer)
      p.lse[bh * p.Tq + i] = (l == 0.f) ? INFINITY : m_i[r] + logf(l_safe);
  }
}

template <int NV, bool CHUNKED = false>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NV, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_qblocks * p.col_chunks * p.splits, p.H, p.B);
  flash_fwd_kernel<NV, CHUNKED><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Combines the splits of one (batch, head, query) row per block, in split
// order: M = max m_s, L = sum l_s exp(m_s - M), out = sum O_s exp(m_s - M) / L
// (0 on q-masked rows and where L = 0), lse = M + log L (+inf where L = 0).
// A split whose keys were all masked (l_s = 0, m_s = -inf) drops out.
template <typename T>
__global__ void merge_kernel(const float* part_o, const float* part_m, const float* part_l,
                             const uint8_t* q_mask, T* out, float* lse, int splits, int B,
                             int H, int Tq, int Dv) {
  const long long rows = (long long)B * H * Tq;
  const long long row = blockIdx.x;  // (b * H + h) * Tq + i
  const int i = (int)(row % Tq);
  const long long bh = row / Tq;
  const int h = (int)(bh % H);
  const int b = (int)(bh / H);
  float m_max = -INFINITY;
  for (int s = 0; s < splits; ++s)
    if (part_l[s * rows + row] > 0.f) m_max = fmaxf(m_max, part_m[s * rows + row]);
  float total = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float l = part_l[s * rows + row];
    if (l > 0.f) total += l * expf(part_m[s * rows + row] - m_max);
  }
  const bool keep = q_mask == nullptr || q_mask[(long long)b * Tq + i] != 0;
  T* og = out + ((long long)b * Tq + i) * H * Dv + (long long)h * Dv;
  for (int col = threadIdx.x; col < Dv; col += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float l = part_l[s * rows + row];
      if (l > 0.f) acc += part_o[(s * rows + row) * Dv + col] * expf(part_m[s * rows + row] - m_max);
    }
    og[col] = from_f<T>((keep && total > 0.f) ? acc / total : 0.f);
  }
  if (lse != nullptr && threadIdx.x == 0) lse[row] = (total > 0.f) ? m_max + logf(total) : INFINITY;
}

}  // namespace

// fp32 q, k, v.  Strides are in elements; the head dim of q, k and v must be
// contiguous.  splits > 1 writes the partials (part_o, part_m, part_l)
// instead of out and lse.  col_chunks splits the value columns over the
// grid: 1 up to dv = 512, 2 above.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask, const void* q_mask,
    void* out, void* lse, void* part_o, void* part_m, void* part_l, int batch, int heads,
    int tq, int tk, int kv_len, int d, int dv, int splits, int tiles_per_split,
    int col_chunks, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
    float scale, void* stream) {
  if (d < 1 || d > 704 || dv < 1 || dv > 704 || kv_len < 0 || kv_len > tk || splits < 1 ||
      col_chunks < 1)
    return (int)cudaErrorInvalidValue;
  // Value columns per chunk, whole 64-column register tiles; each chunk
  // holds some.
  const int cw = (dv + col_chunks - 1) / col_chunks;
  const int CW = (cw + VC - 1) / VC * VC;
  if (CW > 8 * VC || (col_chunks - 1) * CW >= dv) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.q_mask = static_cast<const uint8_t*>(q_mask);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.B = batch;
  p.H = heads;
  p.Tq = tq;
  p.Tk = tk;
  p.kv_len = kv_len;
  p.D = d;
  p.Dv = dv;
  p.Dp = (d + DC - 1) / DC * DC;
  p.n_qblocks = (tq + BQ - 1) / BQ;
  p.n_tiles = (kv_len + BK - 1) / BK;
  p.tiles_per_split = tiles_per_split;
  p.splits = splits;
  p.col_chunks = col_chunks;
  p.CW = CW;
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
  const int nv = CW / VC;
  // Up to dv = 704, two chunks hold at most 384 columns each: 6 tiles of 64.
  if (col_chunks > 1) return nv <= 6 ? (int)launch<6, true>(p, s) : (int)cudaErrorInvalidValue;
  cudaError_t err = nv <= 1   ? launch<1>(p, s)
                    : nv <= 2 ? launch<2>(p, s)
                    : nv <= 3 ? launch<3>(p, s)
                    : nv <= 4 ? launch<4>(p, s)
                    : nv <= 6 ? launch<6>(p, s)
                              : launch<8>(p, s);
  return (int)err;
}

// Merge of split-KV partials (either forward kernel) into out [B, Tq, H, Dv]
// (dtype 0 = fp32, 1 = bf16) and the optional lse [B, H, Tq].
extern "C" int flash_attention_fwd_merge(const void* part_o, const void* part_m,
                                         const void* part_l, const void* q_mask, void* out,
                                         void* lse, int dtype, int splits, int batch, int heads,
                                         int tq, int dv, void* stream) {
  const long long rows = (long long)batch * heads * tq;
  if (rows == 0) return 0;
  const unsigned threads = dv >= 256 ? 256 : dv >= 128 ? 128 : 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* po = static_cast<const float*>(part_o);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const uint8_t* qm = static_cast<const uint8_t*>(q_mask);
  if (dtype == 0)
    merge_kernel<float><<<(unsigned)rows, threads, 0, s>>>(
        po, pm, pl, qm, static_cast<float*>(out), static_cast<float*>(lse), splits, batch,
        heads, tq, dv);
  else if (dtype == 1)
    merge_kernel<__nv_bfloat16><<<(unsigned)rows, threads, 0, s>>>(
        po, pm, pl, qm, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), splits,
        batch, heads, tq, dv);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
