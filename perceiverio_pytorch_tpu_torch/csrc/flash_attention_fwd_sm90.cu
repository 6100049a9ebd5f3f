// Flash attention forward for bf16 inputs on Hopper (sm_90a): wgmma on the
// tensor cores.
//
// Replaces `_flash_kernel` (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py,
// launched by `_flash_forward` through `pl.pallas_call`) for bf16 q, k, v
// that no other bf16 route takes; fp32 inputs take the CUDA-core kernel in
// flash_attention_fwd.cu.  No main-path site takes it now: the flow
// self-attends take the narrow kernel (flash_attention_fwd_narrow_sm90.cu),
// the flow, classification and multimodal encoders the long-KV one
// (flash_attention_fwd_longkv_sm90.cu), the flow decoder the long-Q one
// (flash_attention_fwd_longq_sm90.cu).  It keeps calls off those routes:
// a forced split count (the tests' tool), more query rows or fewer keys
// than the long-KV and long-Q shapes, and widths of 65 to 256.  It was
// the flow sites' kernel until the long-KV K1 took the encoder and the
// long-Q K1 the decoder (here 4.39 and 5.8 ms at batch 1 on an H100;
// PERF.md).  Same
// semantics as the Pallas kernel: S = Q K^T from bf16 x bf16 with fp32
// accumulation, the scale applied after the product; keys at or beyond
// kv_len and keys whose kv_mask byte is 0 get probability 0; an online
// softmax with fp32 running max m and sum l; p is summed into l in fp32 and
// rounded to bf16 before P V (`p.astype(v.dtype)`); O accumulates in fp32; a
// row whose keys are all masked gives exactly 0 and lse = +inf; rows whose
// q_mask byte is 0 are written as 0.  The exponentials are exp2f of logits
// prescaled by scale * log2(e), so m is kept in base 2 and turned back into
// natural units for the lse and the split partials.
//
// What bounds it on an H100 (at the sites it was designed for, which other
// kernels now take).  Every flow site is compute-bound: per 368x496
// tile 4.8e11 FLOP at the encoder cross-attend (2048 queries x 182,528 keys,
// d = 322), 8.6e9 at each latent self-attend (2048 x 2048, 16 heads of 32),
// 7.7e11 at the decoder cross-attend (182,528 x 2048, d = 512), against at
// most 0.24 GB of bf16 read per site.  So is the multimodal encoder
// cross-attend: 1.15e11 FLOP per clip (784 latents x 52,097 keys, one head
// of d = dv = 704) against 0.15 GB.  bf16 on the tensor cores (989 TFLOP/s
// dense) is the only way near that bound.
//
// Design (the choices, in order of what forced them):
//   * wgmma.  Two consumer warpgroups (256 threads) share 64 query rows.
//     Per key tile each computes S for its half of the keys (a 64 x 32 or
//     64 x 64 fp32 fragment, 16 or 32 registers) with m64n32k16 or
//     m64n64k16 products over the head dim; then O_half += P V for its half
//     of the value columns with m64nNk16 products (N = Dv/2 padded, up to
//     256: 128 registers at dv = 512).  One warpgroup owning all 512
//     columns would need 256 registers for O alone, over the cap of 255.
//   * The softmax across the two halves.  The warpgroups exchange their
//     row maxima through shared memory under the barrier that also frees
//     the K tile; each keeps its own partial l (both rescale by the same
//     alpha), and the two are added once, at the end.  Each writes its half
//     of P to shared memory as bf16; both read the whole P as wgmma's A.
//   * Shared memory.  Q stays resident for the whole key walk, beside one
//     K tile, one V tile and P.  A tile holds 128 keys where that fits in
//     the 227 KB a block may use (the encoder's 322, padded to 336: exactly
//     227 KB; the self-attend's 32: 37 KB), else 64 (the decoder's 512: 64
//     + 64 + 64 + 8 KB); 128 keys halve the barriers and wgmma round trips
//     per key, which is what a narrow tile pays for.  The loads are staggered
//     instead of double-buffered: V(t) is fetched while S(t) and the
//     softmax run, and K(t+1) while P V(t) runs, each into the buffer the
//     previous step has just released.  Ragged widths are zero-padded to a
//     multiple of 16 in shared memory (the pad is zeroed once; copies never
//     write it, the realigning loader writes zeros there, or, in a V tile,
//     may leave what it held: V's pad columns feed only dropped output
//     columns).
//   * Layout: wgmma's core-matrix layout without a swizzle (sm90.cuh), which
//     takes any width that is a multiple of 8.  Q, K and P are read K-major;
//     V is read MN-major in its natural [key][column] order through the
//     transpose flag, so no tile is transposed on the way in.
//   * Loads: cp.async copies of the widest granularity that every base
//     address, stride and row width allows (16, 8 or 4 bytes; the flow
//     encoder's rows are 322 bf16 = 644 bytes apart and take 4).  Rows
//     aligned to 2 bytes only (the pixel encoder's 261 = 522 bytes; before,
//     2-byte copies through registers, about 130 a thread per 128-key tile)
//     take the realigning loader in its asynchronous form (sm90.cuh
//     cover_rows, shift_rows): 16-byte cp.async copies of the aligned
//     chunks that cover each row into the row's own slots, then, once they
//     have landed, a pass that shifts each row into place through registers
//     and zeroes its pad.  A realigned K(t + 1) is shifted while P V(t)
//     runs; a realigned V(t) after the softmax, before P V(t) (one more
//     block barrier each).  Where the covering chunks would not fit a
//     row's slots (rows at most 6 columns short of the tile's padded width,
//     such as an odd-offset view of 512 columns), the operand takes 2-byte
//     copies through registers.  Rows that allow 4- or 8-byte copies keep
//     them.  Rows of a tile past the end of its split are not copied (their
//     p is 0, and they hold finite stale data or the initial zeros).
//   * Split-KV.  The grid is (q blocks x column chunks x splits, heads,
//     batch); a block walks the keys of its split only (whole 64-key tiles
//     of the plan; a 128-key tile masks keys past the split's end).  With
//     more than one split it writes its unnormalised O, m (natural units)
//     and l in fp32 to a workspace, and the merge kernel of
//     flash_attention_fwd.cu combines them in split order.  The wrapper
//     picks the splits (ops/flash_attention.py `_split_plan`): 8 at the flow
//     encoder's shape at batch 1 (32 q blocks -> 256 blocks), 2 at 6 tiles,
//     1 at the decoder's and the self-attends'; 10 at the multimodal
//     encoder's (under a forced split count or fp32: the bf16 calls there
//     take the other routes).
//   * Value widths above 512 (the multimodal encoder's single head of 704:
//     d = dv = 704 over 52,097 keys, 784 queries).  Two walls: one
//     warpgroup's half of 704 value columns is 352 fp32 registers a thread
//     for O alone, past the cap of 255 and past wgmma's N <= 256; and Q, a
//     64-key K tile and the V tile at 704 take 229 KB beside P, over the
//     227 KB a block may use.  So the value columns are split over a grid
//     axis of column chunks (the wrapper's `col_chunks`: 2 of 352 at 704):
//     each block computes the whole S = Q K^T at d = 704 and accumulates P V
//     for its chunk only, two warpgroups x 176 columns (88 registers).  S is
//     computed once per chunk, 1.5x the FLOPs of one pass at d = dv; both
//     chunks compute it in the same order, so their m, l and P agree bit for
//     bit and chunk 0 alone writes m, l and the lse.  Tiles hold 32 keys
//     there (Q 88 KB + K 44 KB + V 22 KB + P 4 KB = 159 KB), which is also
//     what a 704-wide Q with dv = 512 takes.
//
// What it does not do yet: no warp specialisation or TMA producer, no
// overlap of one warpgroup's softmax with the other's products, no swizzled
// layouts, and S and P V of a tile run back to back in each warpgroup.
// Heads of at most 64 (the flow self-attends) take the narrow-head kernel of
// flash_attention_fwd_narrow_sm90.cu instead, unless a split count is forced.
//
// Interface: a plain C function, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per block, shared by both warpgroups
constexpr int SPLIT_K = 64;   // keys per tile of the wrapper's split plan
constexpr int THREADS = 256;  // two warpgroups
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use on an H100
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* kv_mask;  // [B, Tk] or null
  const uint8_t* q_mask;   // [B, Tq] or null
  bf16* out;               // [B, Tq, H, Dv], contiguous (one split)
  float* lse;              // [B, H, Tq] or null (one split)
  float* part_o;           // [S, B, H, Tq, Dv] (splits > 1)
  float* part_m;           // [S, B, H, Tq]
  float* part_l;           // [S, B, H, Tq]
  int B, H, Tq, Tk, kv_len, D, Dv, Dp;
  int n_qblocks, tiles_per_split, splits;  // split s: keys [s, s + 1) * tiles * SPLIT_K
  int col_chunks, CW;       // chunk c: value columns [c CW, min((c + 1) CW, Dv))
  int vec_q, vec_k, vec_v;  // cp.async copy bytes (16, 8, 4); 0: 2-byte aligned (realign_vec)
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale_log2;  // softmax scale * log2(e)
};

// The loads of an operand whose rows are aligned to 2 bytes only: the
// realigning loader (cover_rows' cp.async copies, then shift_rows once they
// have landed; 0) where the covering chunks fit the tile's columns, else
// 2-byte copies through registers.
__device__ __forceinline__ int realign_vec(int vec, int cols, int C) {
  return vec ? vec : sm90::cover_fits(cols, C) ? 0 : 2;
}

// Starts loading rows [0, rows) of a tile: cp.async copies of `vec` bytes
// (2: stores through registers), or the covering chunks (vec 0) for the
// caller to commit, wait for and shift.
__device__ __forceinline__ void load_start(char* tile, const bf16* g, long long ld, int rows,
                                           int cols, int C, int vec, int tid) {
  if (vec) sm90::load_rows<THREADS>(tile, g, ld, rows, cols, C, vec, tid);
  else sm90::cover_rows<THREADS>(tile, g, ld, rows, cols, C, tid);
}

// Blocks per SM that an instantiation asks the register allocator to make
// room for: narrow value widths (the self-attend's 32) hold few accumulator
// registers and need several blocks on an SM to hide their latencies.
__host__ __device__ constexpr int min_blocks(int nv) { return nv <= 16 ? 3 : nv <= 64 ? 2 : 1; }

// Dynamic shared memory of a block: Q, one K and one V tile, P, and the
// two warpgroups' row maxima and sums.
template <int NV, int BK>
size_t smem_size(int Dp) {
  return (size_t)((BQ + BK) * Dp + BK * 2 * NV + BQ * BK) * 2 + 4 * BQ * sizeof(float);
}

// NV: value columns per warpgroup (the padded chunk width / 2, a multiple
// of 8).  BK: keys per tile, 128 where the tiles fit in shared memory (fewer
// barriers and wgmma round trips per key), else 64, else 32.
// REALIGN: some operand takes the realigning loader; without it, every
// load is a cp.async copy and the loader's code is compiled out (it cost
// the aligned d = 512 launches about 2% on an H100).
template <int NV, int BK, bool REALIGN>
__global__ void __launch_bounds__(THREADS, min_blocks(NV)) flash_fwd_sm90_kernel(const Params p) {
  constexpr int CV = 2 * NV;            // padded value width in shared memory
  constexpr int HALF_K = BK / 2;        // keys of one warpgroup's S
  constexpr int NS = HALF_K / 2;        // S registers a thread
  extern __shared__ __align__(128) char smem[];
  const int Dp = p.Dp;
  char* sQ = smem;                                  // [BQ][Dp]
  char* sK = sQ + BQ * Dp * 2;                      // [BK][Dp]
  char* sV = sK + BK * Dp * 2;                      // [BK][CV]
  char* sP = sV + BK * CV * 2;                      // [BQ][BK]
  float* red_m = reinterpret_cast<float*>(sP + BQ * BK * 2);  // [2][BQ]
  float* red_l = red_m + 2 * BQ;                               // [2][BQ]
  const size_t tile_bytes = (size_t)((BQ + BK) * Dp + BK * CV + BQ * BK) * 2;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;         // warpgroup: keys [HALF_K wg, HALF_K wg + HALF_K) of S
  const int warp = (tid >> 5) & 3;  // warp within the warpgroup
  const int lane = tid & 31;
  const int row_lo = 16 * warp + (lane >> 2);  // this thread's rows: row_lo, row_lo + 8
  const int qb = blockIdx.x % p.n_qblocks;
  const int chunk = (blockIdx.x / p.n_qblocks) % p.col_chunks;
  const int split = blockIdx.x / (p.n_qblocks * p.col_chunks);
  const int q0 = qb * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k_begin = split * p.tiles_per_split * SPLIT_K;
  const int k_end = min(p.kv_len, k_begin + p.tiles_per_split * SPLIT_K);
  const int c0 = chunk * p.CW;               // this block's first value column
  const int dv_blk = min(p.CW, p.Dv - c0);  // and its number of value columns

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_st;
  const bf16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + h * p.v_sh + c0;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;

  // Zero the tiles once: the pad columns stay zero, rows past Tq as well.
  for (size_t i = tid; i < tile_bytes / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int vec_q = REALIGN ? realign_vec(p.vec_q, p.D, Dp) : p.vec_q;
  const int vec_k = REALIGN ? realign_vec(p.vec_k, p.D, Dp) : p.vec_k;
  const int vec_v = REALIGN ? realign_vec(p.vec_v, dv_blk, CV) : p.vec_v;
  const int q_rows = min(BQ, p.Tq - q0);
  const int k_rows = min(BK, k_end - k_begin);
  const bf16* kg0 = kg + (long long)k_begin * p.k_st;
  load_start(sQ, qg, p.q_st, q_rows, p.D, Dp, vec_q, tid);
  if (k_rows > 0) load_start(sK, kg0, p.k_st, k_rows, p.D, Dp, vec_k, tid);
  sm90::cp_async_commit();
  if (vec_q == 0 || (k_rows > 0 && vec_k == 0)) {
    sm90::cp_async_wait<0>();
    __syncthreads();
    if (vec_q == 0)
      sm90::shift_rows<THREADS, BQ>(sQ, qg, p.q_st, q_rows, p.D, Dp, Dp / 8, tid);
    if (k_rows > 0 && vec_k == 0)
      sm90::shift_rows<THREADS, BK>(sK, kg0, p.k_st, k_rows, p.D, Dp, Dp / 8, tid);
  }

  const uint64_t desc_q = sm90::make_desc(sm90::smem_addr(sQ), 128, 16 * Dp);
  const uint64_t desc_k = sm90::make_desc(sm90::smem_addr(sK + wg * HALF_K * Dp * 2), 128, 16 * Dp);
  const uint64_t desc_p = sm90::make_desc(sm90::smem_addr(sP), 128, 16 * BK);
  const uint64_t desc_v = sm90::make_desc(sm90::smem_addr(sV + wg * NV * 16), 16 * CV, 128);

  float o[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // base-2 running max of rows lo, hi
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int rows = min(BK, k_end - k0);
    const bool more = k0 + BK < k_end;

    // K(t) has landed; every warpgroup is past P V(t - 1).
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    __syncthreads();
    const bf16* vt = vg + (long long)k0 * p.v_st;
    load_start(sV, vt, p.v_st, rows, dv_blk, CV, vec_v, tid);
    sm90::cp_async_commit();

    // S = Q K^T for this warpgroup's half of the keys.
    float s[NS];
    sm90::wgmma_fence();
    for (int ks = 0; ks < Dp / 16; ++ks)
      sm90::wgmma_m64k16<HALF_K, 0, 0>(s, sm90::desc_add(desc_q, ks * 256),
                                       sm90::desc_add(desc_k, ks * 256), ks > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands<NS>(s);

    // Scale (base 2), mask, row maxima of this half.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int key = k0 + wg * HALF_K + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok = key < k_end && (kvm == nullptr || kvm[key] != 0);
      s[i] = ok ? s[i] * p.scale_log2 : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if ((lane & 3) == 0) red_m[wg * BQ + row_lo + 8 * r] = mx[r];
    }
    // The maxima are posted; both warpgroups are done reading K(t).
    __syncthreads();
    const bf16* kn = kg + (long long)(k0 + BK) * p.k_st;
    const int kn_rows = min(BK, k_end - k0 - BK);
    if (more) {
      load_start(sK, kn, p.k_st, kn_rows, p.D, Dp, vec_k, tid);
      sm90::cp_async_commit();
    }

    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float other = red_m[(1 - wg) * BQ + row_lo + 8 * r];
      const float m_new = fmaxf(m_run[r], fmaxf(mx[r], other));
      // Rows with every key masked so far: keep exp2 away from -inf - -inf.
      m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = (m_run[r] == -INFINITY) ? 0.f : exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(s[i] - m_use[r]);
      const float p1 = exp2f(s[i + 1] - m_use[r]);
      l_run[r] += p0 + p1;
      const int col = wg * HALF_K + 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(sP + sm90::cm_offset(row_lo + 8 * r, col, BK)) =
          __floats2bfloat162_rn(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // V(t) has landed (a copied K(t + 1) may still be in flight); P is
    // written.
    if (more) sm90::cp_async_wait<1>();
    else sm90::cp_async_wait<0>();

    if (vec_v == 0) {
      __syncthreads();
      sm90::shift_rows<THREADS, BK>(sV, vt, p.v_st, rows, dv_blk, CV, (dv_blk + 7) / 8, tid);
    }
    sm90::fence_proxy_async();
    __syncthreads();

    // O_half += P V[:, NV wg ..] (a realigned K(t + 1) is shifted while it
    // runs).
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      sm90::wgmma_cols<NV, 0, 1>(o, sm90::desc_add(desc_p, ks * 256),
                                 sm90::desc_add(desc_v, ks * 2 * 16 * CV), 128, 1);
    sm90::wgmma_commit();
    if (more && vec_k == 0) {
      sm90::cp_async_wait<0>();
      __syncthreads();
      sm90::shift_rows<THREADS, BK>(sK, kn, p.k_st, kn_rows, p.D, Dp, Dp / 8, tid);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands<NV / 2>(o);
  }

  sm90::cp_async_wait<0>();  // nothing is left in flight (a split with no tiles)

  // The row sums: over the four lanes of a row, then over the two halves.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if ((lane & 3) == 0) red_l[wg * BQ + row_lo + 8 * r] = l_run[r];
  }
  __syncthreads();

  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + row_lo + 8 * r;
    if (i >= p.Tq) continue;
    const float l = red_l[row_lo + 8 * r] + red_l[BQ + row_lo + 8 * r];
    // Chunk 0 writes the row's m, l and lse (every chunk holds the same).
    const bool row_writer = chunk == 0 && wg == 0 && (lane & 3) == 0;
    if (p.splits > 1) {
      const long long row = ((long long)split * p.B * p.H + bh) * p.Tq + i;
      float* po = p.part_o + row * p.Dv + c0;
#pragma unroll
      for (int j = 0; j < NV / 2; ++j) {
        const int col = wg * NV + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        if (((j >> 1) & 1) == r && col < dv_blk) po[col] = o[j];
      }
      if (row_writer) {
        p.part_m[row] = (l == 0.f) ? -INFINITY : m_run[r] * LN2;
        p.part_l[row] = l;
      }
      continue;
    }
    const bool keep = p.q_mask == nullptr || p.q_mask[(long long)b * p.Tq + i] != 0;
    const float inv = (keep && l > 0.f) ? 1.f / l : 0.f;
    bf16* og = p.out + ((long long)b * p.Tq + i) * p.H * p.Dv + (long long)h * p.Dv + c0;
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) {
      const int col = wg * NV + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      if (((j >> 1) & 1) == r && col < dv_blk) og[col] = __float2bfloat16_rn(o[j] * inv);
    }
    if (p.lse != nullptr && row_writer)
      p.lse[bh * p.Tq + i] = (l == 0.f) ? INFINITY : m_run[r] * LN2 + logf(l);
  }
}

template <int NV, int BK, bool REALIGN>
cudaError_t launch_tiles(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_size<NV, BK>(p.Dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<NV, BK, REALIGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_qblocks * p.col_chunks * p.splits, p.H, p.B);
  flash_fwd_sm90_kernel<NV, BK, REALIGN><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The largest key tile whose shared memory fits: 128 keys up to 168 value
// columns a warpgroup, else 64; 32 for the widest chunks (176 or 256
// columns) beside a wide Q (704: the multimodal encoder).  Up to d = 704
// every instantiation fits one of them; a launch that does not fit is
// refused by cudaFuncSetAttribute, never run.
template <int NV, bool REALIGN>
cudaError_t launch_width(const Params& p, cudaStream_t stream) {
  if constexpr (NV <= 168) {
    if (smem_size<NV, 128>(p.Dp) <= MAX_SMEM) return launch_tiles<NV, 128, REALIGN>(p, stream);
  }
  if constexpr (NV >= 176) {
    if (smem_size<NV, 64>(p.Dp) > MAX_SMEM) return launch_tiles<NV, 32, REALIGN>(p, stream);
  }
  return launch_tiles<NV, 64, REALIGN>(p, stream);
}

// A launch with a realigned operand takes one of three value widths a
// warpgroup (64, 168 or 256, rounded up: the pixel encoder's 261 is 168
// exactly), which keeps the build short.
template <int NV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.vec_q && p.vec_k && p.vec_v) return launch_width<NV, false>(p, stream);
  constexpr int RV = NV <= 64 ? 64 : NV <= 168 ? 168 : 256;
  return launch_width<RV, true>(p, stream);
}

}  // namespace

// Strides are in elements; the head dim of q, k and v must be contiguous.
// splits > 1 writes the partials (part_o, part_m, part_l) instead of out and
// lse.  col_chunks splits the value columns over the grid: 1 up to dv = 512,
// 2 above (at most 256 columns a warpgroup).  Returns a cudaError_t (0 on
// success).
extern "C" int flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, const void* kv_mask, const void* q_mask,
    void* out, void* lse, void* part_o, void* part_m, void* part_l, int batch, int heads,
    int tq, int tk, int kv_len, int d, int dv, int splits, int tiles_per_split,
    int col_chunks, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
    float scale, void* stream) {
  if (d < 1 || d > 704 || dv < 1 || dv > 704 || kv_len < 0 || kv_len > tk || splits < 1 ||
      col_chunks < 1)
    return (int)cudaErrorInvalidValue;
  // Value columns per chunk, a multiple of 16; each chunk holds some.
  const int cw = (dv + col_chunks - 1) / col_chunks;
  const int CW = (cw + 15) / 16 * 16;
  if (CW > 512 || (col_chunks - 1) * CW >= dv) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.q_mask = static_cast<const uint8_t*>(q_mask);
  p.out = static_cast<bf16*>(out);
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
  p.Dp = (d + 15) / 16 * 16;
  p.n_qblocks = (tq + BQ - 1) / BQ;
  p.tiles_per_split = tiles_per_split;
  p.splits = splits;
  p.col_chunks = col_chunks;
  p.CW = CW;
  // cp.async copies of 16, 8 or 4 bytes where the rows allow them; rows
  // aligned to 2 bytes only take the realigning loader (0).
  auto vec = [](const void* x, long long sb, long long st, long long sh, int w) {
    const int bytes = sm90::copy_vec(x, sb, st, sh, w);
    return bytes >= 4 ? bytes : 0;
  };
  p.vec_q = vec(q, q_sb, q_st, q_sh, d);
  p.vec_k = vec(k, k_sb, k_st, k_sh, d);
  p.vec_v = vec(v, v_sb, v_st, v_sh, dv);
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Padded value columns per warpgroup: the smallest instantiation that
  // holds half of a chunk (176: the multimodal encoder's 704 in 2 x 2).
  const int half = CW / 2;
  cudaError_t err = half <= 8     ? launch<8>(p, s)
                    : half <= 16  ? launch<16>(p, s)
                    : half <= 32  ? launch<32>(p, s)
                    : half <= 64  ? launch<64>(p, s)
                    : half <= 128 ? launch<128>(p, s)
                    : half <= 168 ? launch<168>(p, s)
                    : half <= 176 ? launch<176>(p, s)
                                  : launch<256>(p, s);
  return (int)err;
}
