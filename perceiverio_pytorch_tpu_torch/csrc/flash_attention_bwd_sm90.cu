// Flash attention backward for bf16 inputs on Hopper (sm_90a): K2 (dK, dV)
// and K3 (dQ) with wgmma on the tensor cores, and the ordered sum of their
// split partials.
//
// Replaces the two Pallas sweeps of `_pallas_attention_bwd`
// (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py) for bf16 q, k, v:
// `_bwd_dkv_kernel` (K2) and `_bwd_dq_kernel` (K3); fp32 inputs take the
// CUDA-core kernels of flash_attention_bwd.cu.  Same semantics as
// `_bwd_common` and the two kernels: p = exp(scale * q k^T - lse) from the
// forward's log-sum-exp (computed as exp2 of logits prescaled by
// scale * log2(e), as K1 does), 0 for keys at or beyond kv_len, keys whose
// kv_mask byte is 0 and rows with lse = +inf (all keys masked, or past Tq);
// dp = do v^T and ds = p * (dp - delta) in fp32, where the caller computes
// delta = rowsum(do * out) and zeroes do on q-masked rows.  p and ds are
// rounded to bf16 before their products (`p.astype(do.dtype)`,
// `ds.astype(q.dtype)`); K2 accumulates dv += p^T do and dk += scale ds^T q,
// K3 dq += scale ds k, all in fp32, and writes bf16.  Keys past kv_len, keys
// that are masked everywhere and wiped rows come out exactly 0.
//
// What bounds them on an H100.  Per (query, key) pair and head, K2 does
// 4 d + 4 dv FLOP and K3 4 d + 2 dv: per 368x496 flow tile 9.6e11 / 7.2e11
// FLOP at the encoder cross-attend (2048 x 182,528 pairs, d = 322), 1.7e10
// / 1.3e10 at each latent self-attend (16 heads of 32) and 1.5e12 / 1.15e12
// at the decoder cross-attend (182,528 x 2048, d = 512), and 2.3e11 / 1.7e11
// per clip at the multimodal encoder (784 x 52,097 pairs, d = dv = 704),
// against well under 1 GB of inputs and outputs: compute-bound at every
// site, so bf16 on the tensor cores (989 TFLOP/s dense) is the only way near
// the bound.
//
// K2 design: the register wall.  wgmma's M is 64 rows a warpgroup.  With
// keys as M, 64 keys' dK and dV at d = dv = 512 are 64 x 1024 fp32 = 256 KB,
// the whole register file.  So the roles are swapped, and the block is
// small in keys and walks query tiles of 64 rows:
//   * Two warpgroups each own NKW keys of the block (16 a warpgroup, 32 a
//     block, up to d = 256: 32 and 64).  Per query tile a warpgroup
//     computes S = Q K^T and dP = dO V^T for its keys with M = 64 query
//     rows and N = NKW keys (m64n16k16 or m64n32k16 over the head dim; Q
//     and dO are the K-major A, its K or V rows the K-major B), forms P and
//     dS, and writes them as bf16 to shared memory, laid out [query][key].
//     The warpgroups own disjoint keys, so they exchange nothing: a
//     warpgroup barrier hands P and dS to the products.  (Splitting the
//     accumulators' columns over the warpgroups instead, with N = 32 keys,
//     would make each warpgroup's products read P and dS of all the
//     block's keys, formed from an S and a dP computed once per tile, so
//     the two would meet at a block barrier in every tile; the key split
//     holds the same 128 registers and needs none.)
//   * The accumulators are transposed: dV^T += dO^T P and dK^T += Q^T dS
//     with M = head-dim columns (NM tiles of 64), N = NKW keys and K = 64
//     query rows.  A is the resident dO or Q tile read MN-major (wgmma's
//     A-transpose flag), B is the warpgroup's P or dS columns read MN-major.
//     A thread holds 2 * NM * NKW / 2 fp32 accumulators: 128 registers at
//     d = dv = 512 (NM = 8, NKW = 16) or d <= 256 (NM = 4, NKW = 32).
//   * Shared memory: the block's K and V rows, one Q and one dO tile, P and
//     dS, every tile 64 NM columns wide (the M tiles of the transposed
//     products read whole 64-column groups; the pad is zero): 200 KB at the
//     decoder (512), 152 KB at the encoder (322 -> 384), 48 KB at the
//     self-attend (32 -> 64, 64 keys a block).  Loads are staggered, not
//     double-buffered (two Q/dO tiles do not fit at 512): dP runs on dO(t)
//     while Q(t) lands, dO(t + 1) loads while dK^T(t) runs, Q(t + 1) while
//     dP(t + 1) runs.
//   * Widths above 512 (d = dv = 704 = 11 x 64; the multimodal encoder's
//     backward takes the long-KV route, this form the 704-wide calls over
//     fewer keys or at a forced split count).
//     NM = 11 with 16 keys a warpgroup would hold 176 accumulators a
//     thread, and the tiles with 32 keys a block take 278,528 bytes (K and
//     V rows 90,112, a Q and a dO tile 180,224, P and dS 8,192), over the
//     232,448 a block may use.  With 8 keys a warpgroup (16 a block) they
//     take 229,376 and the accumulators 88 registers: `<8, 11>`, S and dP
//     as m64n8k16 products, no column chunks and no recomputation.  The
//     multimodal encoder's 52,097 keys gave 3,257 blocks, one per SM at a
//     time.
//   * The starved grid.  The decoder's 2048 keys give 64 blocks at batch 1
//     on 132 SMs, each walking 2852 query tiles.  The wrapper splits the
//     query range over blocks (ops/flash_attention.py `_dkv_split_plan`: 8
//     splits at the decoder at batch 1, 1 at the encoder and the
//     self-attends); each split writes fp32 partial dK (scaled) and dV to a
//     workspace, and `flash_attention_bwd_sum` adds them in split order and
//     writes bf16: deterministic, no atomics.
//
// K3 design: K1's shape.  A block holds 64 query rows, shared by two
// warpgroups, with the Q and dO tiles resident, and walks key tiles of BK
// (128 at narrow widths, 64 at the encoder's 322, 32 at the decoder's 512:
// what fits beside Q and dO in the 227 KB a block may use; 180 KB at the
// encoder, 196 KB at the decoder).  Per tile each warpgroup computes S and
// dP for half of the keys (no row maximum to exchange: the lse is known),
// forms dS and writes it as bf16; after one block barrier each accumulates
// dQ_half += dS K over its half of the d columns, B being the K tile read
// MN-major as K1 reads V (128 registers at d = 512, as K1's O).  V(t + 1)
// loads while dS and dQ(t) run; K(t + 1) only after dQ(t), which reads K(t).
// The encoder's 32 query blocks at batch 1 split the keys by K1's plan
// (`_split_plan`, 8 splits), each writing its fp32 partial dQ (scaled); the
// same ordered sum adds them, with no rescaling.
//
// K3 above 512 columns of d or dv (the multimodal encoder, 704).  Each
// warpgroup's half of dQ would be 352 columns, 176 accumulators a thread
// beside S and dP, and Q and dO alone take 180,224 bytes.  So, as K1 does at
// 704 (flash_attention_fwd_sm90.cu), the d columns are split over a grid
// axis of column chunks of 352 (the wrapper's `col_chunks`, ceil(d / 352)):
// each block holds Q, dO, K and V at the full width, computes S and dP over
// all of it and accumulates only its chunk's dQ columns, two warpgroups x
// 176 (88 registers, `<176, 16, chunked>`).  16 keys a tile: Q and dO
// 180,224 bytes, K and V 45,056, dS 2,048, in all 227,328.  S and dP are
// computed once per chunk (1.67x the useful FLOPs at 704), in the same
// order, so both chunks form the same dS bit for bit.  The 13 query blocks x
// 2 chunks of the multimodal encoder split the keys by K1's plan counted
// with the chunks (10 splits, 260 blocks).  A template switch keeps the
// narrower instantiations' code as it was.
//
// Both: wgmma's core-matrix layout without a swizzle (sm90.cuh), cp.async
// loads at the widest granularity the base address and strides allow (the
// encoder's 644-byte rows take 4-byte copies; no TMA), widths zero-padded,
// rows past Tq masked through lse = +inf, rows of a tile past the end of its
// range not loaded (their p is 0).  A K2 block whose keys all lie past
// kv_len, and a K3 split with no keys, write zeros without walking.
//
// What they do not do yet: no warp specialisation or TMA producer, no
// overlap of one warpgroup's elementwise work with the other's products,
// the K tile of K3 is not double-buffered; above 512 the tiles are narrow
// (m64n8k16 products for S and dP) and K3 recomputes S and dP per chunk.
// K2 and K3 where at least 4,224 keys meet at most 512 query rows 257 to
// 512 wide (the classification encoders) or at most 1,024 rows 513 to 704
// wide (the multimodal encoder), take
// flash_attention_bwd_longkv_sm90.cu instead, which has them (a TMA
// producer warpgroup, 128-byte swizzled tiles, rows copied into 16-byte
// aligned ones first where TMA cannot address them; K2 persistent, K3 with
// Q and dO resident), unless a split count is forced.
//
// Interface: plain C functions, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes.  Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows of a K2 tile and of a K3 block
constexpr int SPLIT_T = 64;   // rows (K2) or keys (K3) per tile of the wrapper's split plans
constexpr int THREADS = 256;  // two warpgroups
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use on an H100
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;        // [B, Tq, H, Dv], zero on q-masked rows
  const float* lse;        // [B, H, Tq]
  const float* delta;      // [B, H, Tq]
  const uint8_t* kv_mask;  // [B, Tk] or null
  bf16* dq;                // [B, Tq, H, D], contiguous (one split)
  bf16* dk;                // [B, Tk, H, D]
  bf16* dv;                // [B, Tk, H, Dv]
  float* part_q;           // [S, B, Tq, H, D] fp32 (splits > 1)
  float* part_k;           // [S, B, Tk, H, D]
  float* part_v;           // [S, B, Tk, H, Dv]
  int B, H, Tq, Tk, kv_len, D, Dv;
  int D16, Dv16;           // D and Dv rounded up to 16: the reductions of S and dP
  int n_blocks;            // blocks a (batch, head) and split: of keys (K2), of queries (K3)
  int tiles_per_split, splits;  // split s: rows (K2) or keys (K3) [s, s + 1) * tiles * SPLIT_T
  int col_chunks;          // K3 above 512: chunks of the d columns over the grid
  int vec_q, vec_k, vec_v, vec_o;  // copy granularity in bytes
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh;
  float scale;       // softmax scale
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ void load_rows(char* tile, const bf16* g, long long ld, int rows,
                                          int cols, int C, int vec, int tid) {
  sm90::load_rows<THREADS>(tile, g, ld, rows, cols, C, vec, tid);
}

__device__ __forceinline__ void zero_smem(char* smem, size_t bytes, int tid) {
  for (size_t i = tid; i < bytes / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// K2: dK and dV.  NKW keys a warpgroup, NM tiles of 64 head-dim columns.

template <int NKW, int NM>
__host__ __device__ constexpr size_t dkv_smem() {
  return (size_t)((2 * 2 * NKW + 2 * BQ) * 64 * NM + 2 * BQ * 2 * NKW) * 2;
}

template <int NKW, int NM>
__global__ void __launch_bounds__(THREADS, NM <= 2 ? 2 : 1)
    flash_bwd_dkv_sm90_kernel(const Params p) {
  constexpr int BK = 2 * NKW;  // keys per block
  constexpr int C = 64 * NM;   // columns of every tile
  constexpr int NA = NKW / 2;  // registers of one m64 x NKW fp32 fragment
  extern __shared__ __align__(128) char smem[];
  char* sK = smem;              // [BK][C]
  char* sV = sK + BK * C * 2;   // [BK][C]
  char* sQ = sV + BK * C * 2;   // [BQ][C]
  char* sO = sQ + BQ * C * 2;   // [BQ][C]: dO
  char* sP = sO + BQ * C * 2;   // [BQ][BK]
  char* sS = sP + BQ * BK * 2;  // [BQ][BK]: dS

  const int tid = threadIdx.x;
  const int wg = tid >> 7;          // warpgroup: keys [NKW wg, NKW wg + NKW) of the block
  const int warp = (tid >> 5) & 3;  // warp within the warpgroup
  const int lane = tid & 31;
  const int row_lo = 16 * warp + (lane >> 2);  // fragment rows row_lo, row_lo + 8
  const int kb = blockIdx.x % p.n_blocks;
  const int split = blockIdx.x / p.n_blocks;
  const int k0 = kb * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_begin = split * p.tiles_per_split * SPLIT_T;
  const int q_end = min(p.Tq, q_begin + p.tiles_per_split * SPLIT_T);

  float acc_k[NM][NA], acc_v[NM][NA];  // dK^T and dV^T: column 64 j + row, key of the fragment
#pragma unroll
  for (int j = 0; j < NM; ++j)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc_k[j][i] = acc_v[j][i] = 0.f;

  if (k0 < p.kv_len && q_begin < q_end) {  // else every key is past kv_len: zeros
    const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* kg = p.k + b * p.k_sb + h * p.k_sh + (long long)k0 * p.k_st;
    const bf16* vg = p.v + b * p.v_sb + h * p.v_sh + (long long)k0 * p.v_st;
    const bf16* og = p.dout + b * p.o_sb + h * p.o_sh;
    const long long bh = (long long)b * p.H + h;
    const float* lse_g = p.lse + bh * p.Tq;
    const float* delta_g = p.delta + bh * p.Tq;

    // Zero the tiles once: the pad columns stay zero, rows past the ends too.
    zero_smem(smem, dkv_smem<NKW, NM>(), tid);
    __syncthreads();
    const int keys = min(BK, p.kv_len - k0);
    load_rows(sK, kg, p.k_st, keys, p.D, C, p.vec_k, tid);
    load_rows(sV, vg, p.v_st, keys, p.Dv, C, p.vec_v, tid);
    load_rows(sO, og + (long long)q_begin * p.o_st, p.o_st, min(BQ, q_end - q_begin), p.Dv, C,
              p.vec_o, tid);
    sm90::cp_async_commit();
    load_rows(sQ, qg + (long long)q_begin * p.q_st, p.q_st, min(BQ, q_end - q_begin), p.D, C,
              p.vec_q, tid);
    sm90::cp_async_commit();

    // This thread's keys: bit i for fragment register i.
    uint32_t valid = 0;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int key = k0 + wg * NKW + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok = key < p.kv_len &&
                      (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.Tk + key] != 0);
      valid |= (uint32_t)ok << i;
    }

    // K-major operands of S = Q K^T and dP = dO V^T; MN-major ones of
    // dK^T = Q^T dS and dV^T = dO^T P.
    const uint64_t desc_q = sm90::make_desc(sm90::smem_addr(sQ), 128, 16 * C);
    const uint64_t desc_o = sm90::make_desc(sm90::smem_addr(sO), 128, 16 * C);
    const uint64_t desc_k = sm90::make_desc(sm90::smem_addr(sK + wg * NKW * C * 2), 128, 16 * C);
    const uint64_t desc_v = sm90::make_desc(sm90::smem_addr(sV + wg * NKW * C * 2), 128, 16 * C);
    const uint64_t desc_qt = sm90::make_desc(sm90::smem_addr(sQ), 16 * C, 128);
    const uint64_t desc_ot = sm90::make_desc(sm90::smem_addr(sO), 16 * C, 128);
    const uint64_t desc_p = sm90::make_desc(sm90::smem_addr(sP + wg * NKW * 16), 16 * BK, 128);
    const uint64_t desc_s = sm90::make_desc(sm90::smem_addr(sS + wg * NKW * 16), 16 * BK, 128);

    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      const bool more = q0 + BQ < q_end;

      // dO(t) (and, first, K and V) has landed; Q(t) may be in flight.
      sm90::cp_async_wait<1>();
      sm90::fence_proxy_async();
      __syncthreads();
      float lse2[2], dlt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + row_lo + 8 * r;
        lse2[r] = i < p.Tq ? lse_g[i] * LOG2E : INFINITY;  // rows past Tq: p = 0
        dlt[r] = i < p.Tq ? delta_g[i] : 0.f;
      }

      float dp[NA], s[NA];
      sm90::wgmma_fence();
      for (int ks = 0; ks < p.Dv16 / 16; ++ks)
        sm90::wgmma_m64k16<NKW, 0, 0>(dp, sm90::desc_add(desc_o, ks * 256),
                                      sm90::desc_add(desc_v, ks * 256), ks > 0);
      sm90::wgmma_commit();

      // Q(t) has landed.
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      __syncthreads();
      sm90::wgmma_fence();
      for (int ks = 0; ks < p.D16 / 16; ++ks)
        sm90::wgmma_m64k16<NKW, 0, 0>(s, sm90::desc_add(desc_q, ks * 256),
                                      sm90::desc_add(desc_k, ks * 256), ks > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands<NA>(dp);
      sm90::fence_operands<NA>(s);

      // P and dS of this warpgroup's keys, rounded to bf16, as [query][key].
#pragma unroll
      for (int i = 0; i < NA; i += 2) {
        const int r = (i >> 1) & 1;
        float pv[2], dsv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          pv[c] = ((valid >> (i + c)) & 1) ? exp2f(s[i + c] * p.scale_log2 - lse2[r]) : 0.f;
          dsv[c] = pv[c] * (dp[i + c] - dlt[r]);
        }
        const uint32_t off =
            sm90::cm_offset(row_lo + 8 * r, wg * NKW + 8 * (i >> 2) + 2 * (lane & 3), BK);
        *reinterpret_cast<__nv_bfloat162*>(sP + off) = __floats2bfloat162_rn(pv[0], pv[1]);
        *reinterpret_cast<__nv_bfloat162*>(sS + off) = __floats2bfloat162_rn(dsv[0], dsv[1]);
      }
      sm90::fence_proxy_async();
      if (wg == 0)
        sm90::warpgroup_sync<1>();
      else
        sm90::warpgroup_sync<2>();

      // dV^T += dO^T P over the tile's 64 query rows.
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)
#pragma unroll
        for (int j = 0; j < NM; ++j)
          sm90::wgmma_m64k16<NKW, 1, 1>(acc_v[j], sm90::desc_add(desc_ot, j * 1024 + ks * 32 * C),
                                        sm90::desc_add(desc_p, ks * 32 * BK), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NM; ++j) sm90::fence_operands<NA>(acc_v[j]);

      // Both warpgroups are done with dO(t).
      __syncthreads();
      if (more) {
        load_rows(sO, og + (long long)(q0 + BQ) * p.o_st, p.o_st, min(BQ, q_end - q0 - BQ),
                  p.Dv, C, p.vec_o, tid);
        sm90::cp_async_commit();
      }

      // dK^T += Q^T dS.
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)
#pragma unroll
        for (int j = 0; j < NM; ++j)
          sm90::wgmma_m64k16<NKW, 1, 1>(acc_k[j], sm90::desc_add(desc_qt, j * 1024 + ks * 32 * C),
                                        sm90::desc_add(desc_s, ks * 32 * BK), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NM; ++j) sm90::fence_operands<NA>(acc_k[j]);

      // Both warpgroups are done with Q(t).
      __syncthreads();
      if (more) {
        load_rows(sQ, qg + (long long)(q0 + BQ) * p.q_st, p.q_st, min(BQ, q_end - q0 - BQ), p.D,
                  C, p.vec_q, tid);
        sm90::cp_async_commit();
      }
    }
  }

  // Every key below Tk is written, those past kv_len as exact zeros.
#pragma unroll
  for (int j = 0; j < NM; ++j) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int col = 64 * j + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int key = k0 + wg * NKW + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (key >= p.Tk) continue;
      const long long row = ((long long)b * p.Tk + key) * p.H + h;
      const float dk = acc_k[j][i] * p.scale;
      if (p.splits > 1) {
        const long long prow = (long long)split * p.B * p.Tk * p.H + row;
        if (col < p.D) p.part_k[prow * p.D + col] = dk;
        if (col < p.Dv) p.part_v[prow * p.Dv + col] = acc_v[j][i];
      } else {
        if (col < p.D) p.dk[row * p.D + col] = __float2bfloat16_rn(dk);
        if (col < p.Dv) p.dv[row * p.Dv + col] = __float2bfloat16_rn(acc_v[j][i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dQ.  NH d columns a warpgroup, BK keys a tile; with CHUNKED, the grid's
// column chunk c accumulates d columns [2 NH c, 2 NH (c + 1)) only.

template <int BK>
__host__ __device__ size_t dq_smem(int C, int Cv) {
  return (size_t)((BQ + BK) * (C + Cv) + BQ * BK) * 2;
}

// Columns of K3's Q and K tiles: 2 NH, or with CHUNKED every chunk's (the
// chunks' columns, zero past d).
template <int NH, bool CHUNKED>
__host__ __device__ int dq_cols(const Params& p) {
  return CHUNKED ? 2 * NH * p.col_chunks : 2 * NH;
}

template <int NH, int BK, bool CHUNKED>
__global__ void __launch_bounds__(THREADS, NH <= 64 ? 2 : 1)
    flash_bwd_dq_sm90_kernel(const Params p) {
  const int C = dq_cols<NH, CHUNKED>(p);  // columns of the Q and K tiles
  constexpr int HALF_K = BK / 2;   // keys of one warpgroup's S and dP
  constexpr int NS = HALF_K / 2;   // registers of one S or dP fragment
  const int Cv = p.Dv16;           // columns of the dO and V tiles
  extern __shared__ __align__(128) char smem[];
  char* sQ = smem;               // [BQ][C]
  char* sK = sQ + BQ * C * 2;    // [BK][C]
  char* sO = sK + BK * C * 2;    // [BQ][Cv]: dO
  char* sV = sO + BQ * Cv * 2;   // [BK][Cv]
  char* sS = sV + BK * Cv * 2;   // [BQ][BK]: dS

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // keys [HALF_K wg, ..) of S and dP; d columns [NH wg, ..) of dQ
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row_lo = 16 * warp + (lane >> 2);
  const int qb = blockIdx.x % p.n_blocks;
  const int chunk = CHUNKED ? (blockIdx.x / p.n_blocks) % p.col_chunks : 0;
  const int split = blockIdx.x / (CHUNKED ? p.n_blocks * p.col_chunks : p.n_blocks);
  const int c0 = chunk * 2 * NH;  // this block's first dQ column
  const int q0 = qb * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k_begin = split * p.tiles_per_split * SPLIT_T;
  const int k_end = min(p.kv_len, k_begin + p.tiles_per_split * SPLIT_T);

  float acc[NH / 2];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;

  if (k_begin < k_end) {  // else this split has no keys: zeros
    const bf16* kg = p.k + b * p.k_sb + h * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + h * p.v_sh;
    const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;
    const long long bh = (long long)b * p.H + h;

    zero_smem(smem, dq_smem<BK>(C, Cv), tid);
    __syncthreads();
    const int rows = min(BQ, p.Tq - q0);
    load_rows(sQ, p.q + b * p.q_sb + h * p.q_sh + (long long)q0 * p.q_st, p.q_st, rows, p.D, C,
              p.vec_q, tid);
    load_rows(sO, p.dout + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_st, p.o_st, rows, p.Dv,
              Cv, p.vec_o, tid);
    const int first = min(BK, k_end - k_begin);
    load_rows(sK, kg + (long long)k_begin * p.k_st, p.k_st, first, p.D, C, p.vec_k, tid);
    load_rows(sV, vg + (long long)k_begin * p.v_st, p.v_st, first, p.Dv, Cv, p.vec_v, tid);
    sm90::cp_async_commit();

    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + row_lo + 8 * r;
      lse2[r] = i < p.Tq ? p.lse[bh * p.Tq + i] * LOG2E : INFINITY;  // rows past Tq: p = 0
      dlt[r] = i < p.Tq ? p.delta[bh * p.Tq + i] : 0.f;
    }

    const uint64_t desc_q = sm90::make_desc(sm90::smem_addr(sQ), 128, 16 * C);
    const uint64_t desc_o = sm90::make_desc(sm90::smem_addr(sO), 128, 16 * Cv);
    const uint64_t desc_k =
        sm90::make_desc(sm90::smem_addr(sK + wg * HALF_K * C * 2), 128, 16 * C);
    const uint64_t desc_v =
        sm90::make_desc(sm90::smem_addr(sV + wg * HALF_K * Cv * 2), 128, 16 * Cv);
    const uint64_t desc_s = sm90::make_desc(sm90::smem_addr(sS), 128, 16 * BK);
    const uint64_t desc_kt =
        sm90::make_desc(sm90::smem_addr(sK + (c0 + wg * NH) * 16), 16 * C, 128);

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
      const bool more = k0 + BK < k_end;

      // K(t) and V(t) have landed; both warpgroups are past dQ(t - 1).
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      __syncthreads();

      float s[NS], dp[NS];
      sm90::wgmma_fence();
      for (int ks = 0; ks < p.D16 / 16; ++ks)
        sm90::wgmma_m64k16<HALF_K, 0, 0>(s, sm90::desc_add(desc_q, ks * 256),
                                         sm90::desc_add(desc_k, ks * 256), ks > 0);
      for (int ks = 0; ks < Cv / 16; ++ks)
        sm90::wgmma_m64k16<HALF_K, 0, 0>(dp, sm90::desc_add(desc_o, ks * 256),
                                         sm90::desc_add(desc_v, ks * 256), ks > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands<NS>(s);
      sm90::fence_operands<NS>(dp);

      // dS of this warpgroup's keys, rounded to bf16.
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int r = (i >> 1) & 1;
        const int col = wg * HALF_K + 8 * (i >> 2) + 2 * (lane & 3);
        float dsv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + col + c;
          const bool ok = key < k_end && (kvm == nullptr || kvm[key] != 0);
          const float pv = ok ? exp2f(s[i + c] * p.scale_log2 - lse2[r]) : 0.f;
          dsv[c] = pv * (dp[i + c] - dlt[r]);
        }
        *reinterpret_cast<__nv_bfloat162*>(sS + sm90::cm_offset(row_lo + 8 * r, col, BK)) =
            __floats2bfloat162_rn(dsv[0], dsv[1]);
      }

      // dS is whole; both warpgroups are done with V(t).
      sm90::fence_proxy_async();
      __syncthreads();
      if (more) {
        load_rows(sV, vg + (long long)(k0 + BK) * p.v_st, p.v_st, min(BK, k_end - k0 - BK), p.Dv,
                  Cv, p.vec_v, tid);
        sm90::cp_async_commit();
      }

      // dQ[:, c0 + NH wg ..] += dS K[:, c0 + NH wg ..].
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        sm90::wgmma_cols<NH, 0, 1>(acc, sm90::desc_add(desc_s, ks * 256),
                                   sm90::desc_add(desc_kt, ks * 32 * C), 128, 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands<NH / 2>(acc);

      // Both warpgroups are done with K(t).
      __syncthreads();
      if (more) {
        load_rows(sK, kg + (long long)(k0 + BK) * p.k_st, p.k_st, min(BK, k_end - k0 - BK), p.D,
                  C, p.vec_k, tid);
        sm90::cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + row_lo + 8 * r;
    if (i >= p.Tq) continue;
    const long long row = ((long long)b * p.Tq + i) * p.H + h;
#pragma unroll
    for (int j = 0; j < NH / 2; ++j) {
      const int col = c0 + wg * NH + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      if (((j >> 1) & 1) != r || col >= p.D) continue;
      const float dq = acc[j] * p.scale;
      if (p.splits > 1)
        p.part_q[((long long)split * p.B * p.Tq * p.H + row) * p.D + col] = dq;
      else
        p.dq[row * p.D + col] = __float2bfloat16_rn(dq);
    }
  }
}

// ---------------------------------------------------------------------------
// The ordered sum of split partials: out[i] = bf16(sum_s part[s, i]), s in
// order, for one or two arrays in one launch.

__global__ void sum_splits_kernel(const float* part_a, bf16* out_a, long long n_a,
                                  const float* part_b, bf16* out_b, long long n_b, int splits) {
  const long long n = n_a + n_b;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const bool first = i < n_a;
    const long long j = first ? i : i - n_a;
    const long long stride = first ? n_a : n_b;
    const float* src = (first ? part_a : part_b) + j;
    float sum = src[0];
    for (int s = 1; s < splits; ++s) sum += src[s * stride];
    (first ? out_a : out_b)[j] = __float2bfloat16_rn(sum);
  }
}

// ---------------------------------------------------------------------------
// Launch helpers.

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int n_blocks, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Params q = p;
  q.n_blocks = n_blocks;
  kernel<<<dim3(n_blocks * p.col_chunks * p.splits, p.H, p.B), THREADS, smem, stream>>>(q);
  return cudaGetLastError();
}

template <int NKW, int NM>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  static_assert(dkv_smem<NKW, NM>() <= MAX_SMEM, "K2 tiles exceed shared memory");
  return launch(flash_bwd_dkv_sm90_kernel<NKW, NM>, p, (p.Tk + 2 * NKW - 1) / (2 * NKW),
                dkv_smem<NKW, NM>(), stream);
}

// Keys a tile: 128 at narrow widths, else 64 or 32, whichever fits.
template <int NH>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const int n_blocks = (p.Tq + BQ - 1) / BQ;
  const int C = 2 * NH;
  if constexpr (NH <= 64) {
    if (dq_smem<128>(C, p.Dv16) <= MAX_SMEM)
      return launch(flash_bwd_dq_sm90_kernel<NH, 128, false>, p, n_blocks,
                    dq_smem<128>(C, p.Dv16), stream);
  }
  if (dq_smem<64>(C, p.Dv16) <= MAX_SMEM)
    return launch(flash_bwd_dq_sm90_kernel<NH, 64, false>, p, n_blocks, dq_smem<64>(C, p.Dv16),
                  stream);
  return launch(flash_bwd_dq_sm90_kernel<NH, 32, false>, p, n_blocks, dq_smem<32>(C, p.Dv16),
                stream);
}

// Above 512 columns of d or dv: the d columns in chunks of WIDE_CW over the
// grid, 16 keys a tile (Q, dO, K and V at 704 take 227,328 bytes with them).
constexpr int WIDE_NH = 176;
constexpr int WIDE_CW = 2 * WIDE_NH;
constexpr int WIDE_BK = 16;

cudaError_t launch_dq_wide(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_smem<WIDE_BK>(dq_cols<WIDE_NH, true>(p), p.Dv16);
  return launch(flash_bwd_dq_sm90_kernel<WIDE_NH, WIDE_BK, true>, p, (p.Tq + BQ - 1) / BQ, smem,
                stream);
}

}  // namespace

// Strides are in elements; the head dim of q, k, v and dout must be
// contiguous; lse and delta are [B, H, Tq] fp32; dq, dk and dv are
// contiguous.  With splits > 1 each kernel writes its fp32 partials to
// part_q (K3) or part_k and part_v (K2) instead, for flash_attention_bwd_sum.
// flash_attention_bwd_dkv_sm90 (K2) splits the query rows, in ranges of
// tiles_per_split tiles of 64; flash_attention_bwd_dq_sm90 (K3) the keys.
// col_chunks is 1 for K2; for K3 it is 1 up to 512 columns of d and dv, and
// above, ceil(d / 352): the d columns in chunks of 352 over the grid.  Each
// returns a cudaError_t (0 on success).
#define PERCEIVER_BWD_SM90_ARGS                                                         \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,       \
      const void *delta, const void *kv_mask, void *dq, void *dk, void *dv,             \
      void *part_q, void *part_k, void *part_v, int batch, int heads, int tq, int tk,   \
      int kv_len, int d, int dv_width, int splits, int tiles_per_split, int col_chunks, \
      long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,   \
      long long k_sh, long long v_sb, long long v_st, long long v_sh, long long o_sb,   \
      long long o_st, long long o_sh, float scale, void *stream

static bool make_params(Params* p, PERCEIVER_BWD_SM90_ARGS) {
  if (d < 1 || d > 704 || dv_width < 1 || dv_width > 704 || kv_len < 0 || kv_len > tk ||
      splits < 1 || tiles_per_split < 0 || col_chunks < 1)
    return false;
  p->q = static_cast<const bf16*>(q);
  p->k = static_cast<const bf16*>(k);
  p->v = static_cast<const bf16*>(v);
  p->dout = static_cast<const bf16*>(dout);
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->kv_mask = static_cast<const uint8_t*>(kv_mask);
  p->dq = static_cast<bf16*>(dq);
  p->dk = static_cast<bf16*>(dk);
  p->dv = static_cast<bf16*>(dv);
  p->part_q = static_cast<float*>(part_q);
  p->part_k = static_cast<float*>(part_k);
  p->part_v = static_cast<float*>(part_v);
  p->B = batch;
  p->H = heads;
  p->Tq = tq;
  p->Tk = tk;
  p->kv_len = kv_len;
  p->D = d;
  p->Dv = dv_width;
  p->D16 = (d + 15) / 16 * 16;
  p->Dv16 = (dv_width + 15) / 16 * 16;
  p->n_blocks = 0;
  p->tiles_per_split = tiles_per_split;
  p->splits = splits;
  p->col_chunks = col_chunks;
  p->vec_q = sm90::copy_vec(q, q_sb, q_st, q_sh, d);
  p->vec_k = sm90::copy_vec(k, k_sb, k_st, k_sh, d);
  p->vec_v = sm90::copy_vec(v, v_sb, v_st, v_sh, dv_width);
  p->vec_o = sm90::copy_vec(dout, o_sb, o_st, o_sh, dv_width);
  p->q_sb = q_sb;
  p->q_st = q_st;
  p->q_sh = q_sh;
  p->k_sb = k_sb;
  p->k_st = k_st;
  p->k_sh = k_sh;
  p->v_sb = v_sb;
  p->v_st = v_st;
  p->v_sh = v_sh;
  p->o_sb = o_sb;
  p->o_st = o_st;
  p->o_sh = o_sh;
  p->scale = scale;
  p->scale_log2 = scale * LOG2E;
  return true;
}

#define PERCEIVER_BWD_SM90_PASS                                                         \
  q, k, v, dout, lse, delta, kv_mask, dq, dk, dv, part_q, part_k, part_v, batch, heads, \
      tq, tk, kv_len, d, dv_width, splits, tiles_per_split, col_chunks, q_sb, q_st,     \
      q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, scale, stream

// K2: NM tiles of 64 columns hold max(d, dv) (the smallest of 1, 2, 4, 6, 8,
// 11); 32 keys a warpgroup up to 256 columns, 16 up to 512, 8 above.
extern "C" int flash_attention_bwd_dkv_sm90(PERCEIVER_BWD_SM90_ARGS) {
  Params p;
  if (!make_params(&p, PERCEIVER_BWD_SM90_PASS) || (splits > 1 && (!part_k || !part_v)) ||
      col_chunks != 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nm = ((d > dv_width ? d : dv_width) + 63) / 64;
  cudaError_t err = nm <= 1   ? launch_dkv<32, 1>(p, s)
                    : nm <= 2 ? launch_dkv<32, 2>(p, s)
                    : nm <= 4 ? launch_dkv<32, 4>(p, s)
                    : nm <= 6 ? launch_dkv<16, 6>(p, s)
                    : nm <= 8 ? launch_dkv<16, 8>(p, s)
                              : launch_dkv<8, 11>(p, s);
  return (int)err;
}

// K3: up to 512 columns of d and dv, NH, the d columns of a warpgroup, is
// the smallest instantiation that holds half of d rounded up to 16; above,
// the column chunks of launch_dq_wide.
extern "C" int flash_attention_bwd_dq_sm90(PERCEIVER_BWD_SM90_ARGS) {
  Params p;
  const bool wide = d > 512 || dv_width > 512;
  if (!make_params(&p, PERCEIVER_BWD_SM90_PASS) || (splits > 1 && !part_q) ||
      col_chunks != (wide ? (d + WIDE_CW - 1) / WIDE_CW : 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) return (int)launch_dq_wide(p, s);
  const int half = p.D16 / 2;
  cudaError_t err = half <= 16    ? launch_dq<16>(p, s)
                    : half <= 32  ? launch_dq<32>(p, s)
                    : half <= 64  ? launch_dq<64>(p, s)
                    : half <= 128 ? launch_dq<128>(p, s)
                    : half <= 168 ? launch_dq<168>(p, s)
                                  : launch_dq<256>(p, s);
  return (int)err;
}

// out_a = bf16(sum over s of part_a[s]), each part n_a floats, and likewise
// for b (part_b may be null with n_b = 0).  Returns a cudaError_t.
extern "C" int flash_attention_bwd_sum(const void* part_a, void* out_a, long long n_a,
                                       const void* part_b, void* out_b, long long n_b,
                                       int splits, void* stream) {
  if (splits < 1 || n_a < 0 || n_b < 0) return (int)cudaErrorInvalidValue;
  const long long n = n_a + n_b;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16;
  sum_splits_kernel<<<(int)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_a), static_cast<bf16*>(out_a), n_a,
      static_cast<const float*>(part_b), static_cast<bf16*>(out_b), n_b, splits);
  return (int)cudaGetLastError();
}
