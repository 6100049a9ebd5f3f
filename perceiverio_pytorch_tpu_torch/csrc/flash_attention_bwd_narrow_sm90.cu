// Flash attention backward for bf16 inputs with narrow heads (Dqk and Dv up
// to 64) on Hopper (sm_90a): K2 (dK, dV) and K3 (dQ) at the flow model's
// latent self-attends, 2048 queries x 2048 keys in 16 heads of 32.
//
// Replaces `_bwd_dkv_kernel` (K2) and `_bwd_dq_kernel` (K3)
// (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py, launched by
// `_pallas_attention_bwd` through `pl.pallas_call`) for bf16 q, k, v whose
// head widths are both at most 64; wider bf16 heads take
// flash_attention_bwd_sm90.cu and fp32 inputs flash_attention_bwd.cu.  The
// same semantics as both (`_bwd_common`): p = exp(scale * q k^T - lse) from
// the forward's log-sum-exp, computed as exp2 of the scaled logits less lse
// * log2(e); 0 for keys at or beyond kv_len, keys whose kv_mask byte is 0
// and rows with lse = +inf; dp = do v^T and ds = p * (dp - delta) in fp32,
// where the caller computes delta = rowsum(do * out) and zeroes do on
// q-masked rows; p and ds are rounded to bf16 before their products; K2
// accumulates dv += p^T do and dk += ds^T q, K3 dq += ds k, all in fp32,
// scales dk and dq after their products and writes bf16.  Keys past kv_len,
// keys masked everywhere and wiped rows come out exactly 0.  Neither kernel
// splits its walk or uses atomics: two calls give the same bits.
//
// What bounds them on an H100.  Per (query, key) pair and head K2 does 4 d +
// 4 dv FLOP and K3 4 d + 2 dv: at the self-attend, batch 1, 1.7e10 and
// 1.3e10 FLOP, 0.017 and 0.013 ms at 989 TFLOP/s, against 67 M
// exponentials each (about 0.018 ms on the SMs' 16 MUFU lanes each) and five
// or six more fp32 instructions a pair for p, ds and their bf16 packing.
// So, as in the narrow forward (flash_attention_fwd_narrow_sm90.cu), the
// elementwise stream and the products have to overlap: no shared-memory
// round trip of P or dS, no block-wide barrier a tile, and a second
// warpgroup on the SM whose products run under one's elementwise work.
//
// K2 design: keys as M.  At d = dv <= 64 a warpgroup that owns 64 keys
// holds their dK and dV in DP / 2 + NV / 2 fp32 registers a thread (32 at
// d = dv = 32), so the roles of the wide kernel (which puts head columns on
// M because 64 keys' dK and dV at d = 512 fill the register file) swap back:
//   * Per query tile of 64 a warpgroup computes S^T = K Q^T and dP^T = V dO^T
//     (m64n64k16 over the head width: its resident K or V rows the K-major
//     A, the stage's Q or dO rows the K-major B), forms P^T and dS^T in
//     registers, taking each column's lse and delta from the stage, and
//     feeds them, rounded to bf16, as the register A fragments of dV += P^T
//     dO and dK += dS^T Q (sm90.cuh, wgmma_m64k16_rA; dO and Q read MN-major
//     through the transpose flag, as the forward reads V).
//   * A key row of the accumulators depends on that key's K and V rows
//     only, so invalid keys (past kv_len, or kv_mask 0) need no mask in the
//     walk: their rows are written as 0.  Query rows past Tq are zero in the
//     Q and dO stages with lse = delta = 0: their p = 1 meets dO = 0 and their
//     ds = 1 * (0 - 0) = 0, so they add exact zeros.
//   * Two consumer warpgroups (128 keys) and one producer warp make a block
//     of 288 threads; the block's K and V rows are loaded once.  The
//     producer fills a ring of 4 stages of 64 query rows (Q, dO, the rows'
//     lse and delta) with zero-filling cp.async copies, or the realigning
//     loader where a row is not 16-byte aligned (d = 41: 82-byte rows),
//     tracked by full and empty mbarriers as in the narrow forward.  Both
//     warpgroups read every stage.
//   * No query split: at batch 1 the self-attend's 16 heads give 256 blocks
//     of 128 keys, one an SM (two waves on 132 SMs).
//
// K3 design: the narrow forward's shape.  A warpgroup owns 64 query rows,
// with their Q and dO rows, lse and delta resident; the producer warp feeds
// a ring of 4 stages of 64 keys (K and V).  Per key tile it computes S = Q
// K^T and dP = dO V^T (m64n64k16), forms P and dS in registers (the lse is
// known: no row maximum, no rescale) and accumulates dQ += dS K from the
// register A fragment, K read MN-major.  Per-element masking only on the
// tiles that need it: the ragged last one, or every tile of a call with a
// kv_mask.  The keys are never split.
//
// Registers.  At d = dv = 32 K2 takes 123 registers a thread and K3 115
// (tools/kernel_report.py ptxas), so one block of 288 threads runs on an
// SM; a register cap for two blocks an SM makes ptxas spill and serialise the
// wgmma (C7512).  A warpgroup does not overlap its own elementwise work with
// its products: the block's other consumer warpgroup keeps the tensor cores
// busy meanwhile.  Q, K, V and dO tiles use sm90.cuh's core-matrix layout
// (no swizzle); the loaders write every byte of each tile, zeros included.
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

constexpr int NWG = 2;                   // consumer warpgroups, 64 keys (K2) or rows (K3) each
constexpr int BM = 64 * NWG;             // keys (K2) or query rows (K3) of a block
constexpr int BT = 64;                   // query rows (K2) or keys (K3) of a ring stage
constexpr int STAGES = 4;                // stages of the ring
constexpr int THREADS = 128 * NWG + 32;  // the consumers and the producer warp
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;        // [B, Tq, H, Dv], zero on q-masked rows
  const float* lse;        // [B, H, Tq]
  const float* delta;      // [B, H, Tq]
  const uint8_t* kv_mask;  // [B, Tk] or null
  bf16* dq;                // [B, Tq, H, D], contiguous
  bf16* dk;                // [B, Tk, H, D]
  bf16* dv;                // [B, Tk, H, Dv]
  int B, H, Tq, Tk, kv_len, D, Dv;
  int n_tiles;                // ring tiles: ceil(Tq / BT) (K2), ceil(kv_len / BT) (K3)
  int al_q, al_k, al_v, al_o;  // 1: 16-byte cp.async copies; 0: the realigning loader
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh;
  float scale;       // softmax scale
  float scale_log2;  // softmax scale * log2(e)
};

// Shared memory of a K2 block (bytes): its K and V rows, the ring's Q, dO
// and lse/delta stages ([2][BT] floats each), and the stages' full and empty
// mbarriers.
template <int DP, int NV>
struct DkvSmem {
  static constexpr int K = 0;
  static constexpr int V = K + BM * DP * 2;
  static constexpr int Q = V + BM * NV * 2;
  static constexpr int O = Q + STAGES * BT * DP * 2;
  static constexpr int LSE = O + STAGES * BT * NV * 2;
  static constexpr int BAR = LSE + STAGES * 2 * BT * 4;
  static constexpr int SIZE = BAR + 2 * STAGES * 8;
};

// Shared memory of a K3 block: its Q and dO rows, the ring's K and V stages
// and the mbarriers.
template <int DP, int NV>
struct DqSmem {
  static constexpr int Q = 0;
  static constexpr int O = Q + BM * DP * 2;
  static constexpr int K = O + BM * NV * 2;
  static constexpr int V = K + STAGES * BT * DP * 2;
  static constexpr int BAR = V + STAGES * BT * NV * 2;
  static constexpr int SIZE = BAR + 2 * STAGES * 8;
};

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    sm90::mbar_init(&full[s], 32);
    sm90::mbar_init(&empty[s], NWG * 4);
  }
}

// The producer's end of a stage: with 16-byte copies only, each lane's
// arrival comes when its copies land (the warp runs ahead by up to STAGES
// tiles); with realigned rows, stored from registers, the lane waits for
// its copies, fences the stores for the async proxy and arrives.
__device__ __forceinline__ void stage_filled(uint64_t* full, bool async) {
  if (async) {
    sm90::cp_async_mbar_arrive_noinc(full);
  } else {
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    sm90::mbar_arrive(full);
  }
}

// The consumers' resident tiles: loaded by the warpgroup (128 threads),
// waited for and handed to wgmma behind the warpgroup's own barrier.
__device__ __forceinline__ void resident_loaded(int wg) {
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  if (wg == 0) sm90::warpgroup_sync<1>();
  else sm90::warpgroup_sync<2>();
}

// Writes this thread's two rows of an m64 x N fp32 fragment (N / 2
// registers), times `mul`, as bf16 to row r (0: lo, 1: hi) of a matrix
// whose row starts at `g` and holds `width` columns; zeros where !keep.
template <int N>
__device__ __forceinline__ void store_row(bf16* g, const float* acc, int r, int width, float mul,
                                          bool keep, int lane) {
#pragma unroll
  for (int j = 0; j < N / 2; j += 2) {
    if (((j >> 1) & 1) != r) continue;
    const int col = 8 * (j >> 2) + 2 * (lane & 3);
    const float x0 = keep ? acc[j] * mul : 0.f;
    const float x1 = keep ? acc[j + 1] * mul : 0.f;
    if (col + 1 < width && (width & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(g + col) = __floats2bfloat162_rn(x0, x1);
    } else {
      if (col < width) g[col] = __float2bfloat16_rn(x0);
      if (col + 1 < width) g[col + 1] = __float2bfloat16_rn(x1);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dK and dV.  DP: padded head width of Q and K (32 or 64), NV: of V and
// dO.

template <int DP, int NV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_narrow_kernel(const Params p) {
  using L = DkvSmem<DP, NV>;
  extern __shared__ __align__(128) char smem[];
  char* sK = smem + L::K;
  char* sV = smem + L::V;
  char* sQ = smem + L::Q;
  char* sO = smem + L::O;
  float* sL = reinterpret_cast<float*>(smem + L::LSE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * p.H + h;
  // The warpgroup index, read from lane 0 so that the compiler sees it is
  // the same across a warp (warp-uniform role branches: no serialised wgmma).
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row_lo = 16 * warp + (lane >> 2);  // this thread's keys: row_lo, row_lo + 8
  const int kw = k0 + 64 * wg;                 // the warpgroup's first key

  float acc_k[DP / 2], acc_v[NV / 2];  // dK, dV: rows keys, columns head widths
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc_v[i] = 0.f;

  if (k0 < p.kv_len) {  // else every key of the block is past kv_len: zeros
    if (tid == 0) init_ring(full, empty);
    __syncthreads();

    if (wg == NWG) {
      // The producer warp: query tile t into stage t % STAGES once both
      // warpgroups have emptied it.
      const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
      const bf16* og = p.dout + b * p.o_sb + h * p.o_sh;
      const float* lse_g = p.lse + bh * p.Tq;
      const float* dlt_g = p.delta + bh * p.Tq;
      const bool async = p.al_q && p.al_o;
      for (int t = 0; t < p.n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) sm90::mbar_wait(&empty[st], (t / STAGES - 1) & 1);
        const int q0 = t * BT;
        const int rows = min(BT, p.Tq - q0);
        sm90::load_tile<32, BT, DP>(sQ + st * BT * DP * 2, qg + (long long)q0 * p.q_st, p.q_st,
                                    rows, p.D, p.al_q, lane);
        sm90::load_tile<32, BT, NV>(sO + st * BT * NV * 2, og + (long long)q0 * p.o_st, p.o_st,
                                    rows, p.Dv, p.al_o, lane);
        float* sl = sL + st * 2 * BT;
#pragma unroll
        for (int j = lane; j < BT; j += 32) {
          const bool ok = j < rows;
          sm90::cp_async_4_zfill(sm90::smem_addr(sl + j), ok ? lse_g + q0 + j : lse_g, ok);
          sm90::cp_async_4_zfill(sm90::smem_addr(sl + BT + j), ok ? dlt_g + q0 + j : dlt_g, ok);
        }
        stage_filled(&full[st], async);
      }
      sm90::cp_async_wait<0>();  // the warp leaves once its copies have landed
      return;
    }

    // A consumer warpgroup: keys kw .. kw + 63, those below kv_len loaded.
    char* sKw = sK + wg * 64 * DP * 2;
    char* sVw = sV + wg * 64 * NV * 2;
    const int keys = max(0, min(64, p.kv_len - kw));
    sm90::load_tile<128, 64, DP>(sKw, p.k + b * p.k_sb + h * p.k_sh + (long long)kw * p.k_st,
                                 p.k_st, keys, p.D, p.al_k, tid & 127);
    sm90::load_tile<128, 64, NV>(sVw, p.v + b * p.v_sb + h * p.v_sh + (long long)kw * p.v_st,
                                 p.v_st, keys, p.Dv, p.al_v, tid & 127);
    resident_loaded(wg);

    // K-major A (K, V) and B (Q, dO) of S^T and dP^T; MN-major B (Q, dO)
    // of dK += dS^T Q and dV += P^T dO.
    const uint64_t desc_k = sm90::make_desc(sm90::smem_addr(sKw), 128, 16 * DP);
    const uint64_t desc_v = sm90::make_desc(sm90::smem_addr(sVw), 128, 16 * NV);
    const uint64_t desc_q = sm90::make_desc(sm90::smem_addr(sQ), 128, 16 * DP);
    const uint64_t desc_o = sm90::make_desc(sm90::smem_addr(sO), 128, 16 * NV);
    const uint64_t desc_qt = sm90::make_desc(sm90::smem_addr(sQ), 16 * DP, 128);
    const uint64_t desc_ot = sm90::make_desc(sm90::smem_addr(sO), 16 * NV, 128);

    for (int t = 0; t < p.n_tiles; ++t) {
      const int st = t % STAGES;
      const uint32_t q_off = st * BT * DP * 2;
      const uint32_t o_off = st * BT * NV * 2;
      float s[BT / 2], dp[BT / 2];
      // After the full barrier: the stage's copies, made visible to this
      // thread by the barrier, are fenced for the async proxy that wgmma
      // reads.
      sm90::mbar_wait(&full[st], (t / STAGES) & 1);
      sm90::fence_proxy_async();
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        sm90::wgmma_m64k16<BT, 0, 0>(s, sm90::desc_add(desc_k, ks * 256),
                                     sm90::desc_add(desc_q, q_off + ks * 256), ks > 0);
#pragma unroll
      for (int ks = 0; ks < NV / 16; ++ks)
        sm90::wgmma_m64k16<BT, 0, 0>(dp, sm90::desc_add(desc_v, ks * 256),
                                     sm90::desc_add(desc_o, o_off + ks * 256), ks > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands<BT / 2>(s);
      sm90::fence_operands<BT / 2>(dp);

      // P^T and dS^T as register A fragments: element i is key row_lo +
      // 8 ((i >> 1) & 1) and query column 8 (i >> 2) + 2 (lane & 3) + (i & 1).
      const float* sl = sL + st * 2 * BT;
      uint32_t pa[BT / 4], da[BT / 4];
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        const float2 l = *reinterpret_cast<const float2*>(sl + c);
        const float2 dl = *reinterpret_cast<const float2*>(sl + BT + c);
        const float n0 = -l.x * LOG2E, n1 = -l.y * LOG2E;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r;
          const float p0 = sm90::exp2_approx(fmaf(s[i], p.scale_log2, n0));
          const float p1 = sm90::exp2_approx(fmaf(s[i + 1], p.scale_log2, n1));
          pa[i / 2] = sm90::pack_bf16x2(p0, p1);
          da[i / 2] = sm90::pack_bf16x2(p0 * (dp[i] - dl.x), p1 * (dp[i + 1] - dl.y));
        }
      }

      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BT / 16; ++ks)
        sm90::wgmma_m64k16_rA<NV, 1>(acc_v, pa + 4 * ks,
                                     sm90::desc_add(desc_ot, o_off + ks * 2 * 16 * NV), 1);
#pragma unroll
      for (int ks = 0; ks < BT / 16; ++ks)
        sm90::wgmma_m64k16_rA<DP, 1>(acc_k, da + 4 * ks,
                                     sm90::desc_add(desc_qt, q_off + ks * 2 * 16 * DP), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands<NV / 2>(acc_v);
      sm90::fence_operands<DP / 2>(acc_k);
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
    }
  }
  if (wg == NWG) return;

  // Every key below Tk is written; invalid ones as exact zeros.
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + row_lo + 8 * r;
    if (key >= p.Tk) continue;
    const bool keep = key < p.kv_len && (kvm == nullptr || kvm[key] != 0);
    const long long row = ((long long)b * p.Tk + key) * p.H + h;
    store_row<DP>(p.dk + row * p.D, acc_k, r, p.D, p.scale, keep, lane);
    store_row<NV>(p.dv + row * p.Dv, acc_v, r, p.Dv, 1.f, keep, lane);
  }
}

// ---------------------------------------------------------------------------
// K3: dQ.

// This thread's dS over the keys k0 .. k0 + BT - 1 as register A fragments
// (element i: row lo or hi by (i >> 1) & 1, key 8 (i >> 2) + 2 (lane & 3) +
// (i & 1)), from S and dP; nl is -lse * log2(e) of its two rows.  MASKED:
// keys at or past kv_len or with a kv_mask byte of 0 get p = 0.
template <bool MASKED>
__device__ __forceinline__ void ds_tile(const float (&s)[BT / 2], const float (&dp)[BT / 2],
                                        uint32_t (&da)[BT / 4], const float (&nl)[2],
                                        const float (&dlt)[2], int k0, int kv_len,
                                        const uint8_t* kvm, float scale_log2, int lane) {
#pragma unroll
  for (int i = 0; i < BT / 2; i += 2) {
    const int r = (i >> 1) & 1;
    float ds[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float pv = sm90::exp2_approx(fmaf(s[i + c], scale_log2, nl[r]));
      if constexpr (MASKED) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + c;
        const bool ok = key < kv_len && (kvm == nullptr || kvm[key] != 0);
        pv = ok ? pv : 0.f;
      }
      ds[c] = pv * (dp[i + c] - dlt[r]);
    }
    da[i / 2] = sm90::pack_bf16x2(ds[0], ds[1]);
  }
}

template <int DP, int NV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_narrow_kernel(const Params p) {
  using L = DqSmem<DP, NV>;
  extern __shared__ __align__(128) char smem[];
  char* sQ = smem + L::Q;
  char* sO = smem + L::O;
  char* sK = smem + L::K;
  char* sV = smem + L::V;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * p.H + h;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;

  if (tid == 0) init_ring(full, empty);
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == NWG) {
    // The producer warp: key tile t into stage t % STAGES once both
    // warpgroups have emptied it.
    const int lane = tid & 31;
    const bf16* kg = p.k + b * p.k_sb + h * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + h * p.v_sh;
    const bool async = p.al_k && p.al_v;
    for (int t = 0; t < p.n_tiles; ++t) {
      const int st = t % STAGES;
      if (t >= STAGES) sm90::mbar_wait(&empty[st], (t / STAGES - 1) & 1);
      const int k0 = t * BT;
      const int rows = min(BT, p.kv_len - k0);
      sm90::load_tile<32, BT, DP>(sK + st * BT * DP * 2, kg + (long long)k0 * p.k_st, p.k_st,
                                  rows, p.D, p.al_k, lane);
      sm90::load_tile<32, BT, NV>(sV + st * BT * NV * 2, vg + (long long)k0 * p.v_st, p.v_st,
                                  rows, p.Dv, p.al_v, lane);
      stage_filled(&full[st], async);
    }
    sm90::cp_async_wait<0>();
    return;
  }

  // A consumer warpgroup: query rows qw .. qw + 63.
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row_lo = 16 * warp + (lane >> 2);  // this thread's rows: row_lo, row_lo + 8
  const int qw = q0 + 64 * wg;
  char* sQw = sQ + wg * 64 * DP * 2;
  char* sOw = sO + wg * 64 * NV * 2;
  const int rows = min(64, p.Tq - qw);
  sm90::load_tile<128, 64, DP>(sQw, p.q + b * p.q_sb + h * p.q_sh + (long long)qw * p.q_st,
                               p.q_st, rows, p.D, p.al_q, tid & 127);
  sm90::load_tile<128, 64, NV>(sOw, p.dout + b * p.o_sb + h * p.o_sh + (long long)qw * p.o_st,
                               p.o_st, rows, p.Dv, p.al_o, tid & 127);
  float nl[2], dlt[2];  // -lse * log2(e) and delta of rows lo, hi; rows past Tq: p = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qw + row_lo + 8 * r;
    nl[r] = i < p.Tq ? -p.lse[bh * p.Tq + i] * LOG2E : -INFINITY;
    dlt[r] = i < p.Tq ? p.delta[bh * p.Tq + i] : 0.f;
  }
  resident_loaded(wg);

  const uint64_t desc_q = sm90::make_desc(sm90::smem_addr(sQw), 128, 16 * DP);
  const uint64_t desc_o = sm90::make_desc(sm90::smem_addr(sOw), 128, 16 * NV);
  const uint64_t desc_k = sm90::make_desc(sm90::smem_addr(sK), 128, 16 * DP);
  const uint64_t desc_v = sm90::make_desc(sm90::smem_addr(sV), 128, 16 * NV);
  const uint64_t desc_kt = sm90::make_desc(sm90::smem_addr(sK), 16 * DP, 128);

  float acc[DP / 2];  // dQ: rows queries, columns d
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const bool mask_all = kvm != nullptr;
  for (int t = 0; t < p.n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t k_off = st * BT * DP * 2;
    const uint32_t v_off = st * BT * NV * 2;
    float s[BT / 2], dp[BT / 2];
    sm90::mbar_wait(&full[st], (t / STAGES) & 1);
    sm90::fence_proxy_async();
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      sm90::wgmma_m64k16<BT, 0, 0>(s, sm90::desc_add(desc_q, ks * 256),
                                   sm90::desc_add(desc_k, k_off + ks * 256), ks > 0);
#pragma unroll
    for (int ks = 0; ks < NV / 16; ++ks)
      sm90::wgmma_m64k16<BT, 0, 0>(dp, sm90::desc_add(desc_o, ks * 256),
                                   sm90::desc_add(desc_v, v_off + ks * 256), ks > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands<BT / 2>(s);
    sm90::fence_operands<BT / 2>(dp);

    const int k0 = t * BT;
    uint32_t da[BT / 4];
    if (mask_all || k0 + BT > p.kv_len)
      ds_tile<true>(s, dp, da, nl, dlt, k0, p.kv_len, kvm, p.scale_log2, lane);
    else
      ds_tile<false>(s, dp, da, nl, dlt, k0, p.kv_len, kvm, p.scale_log2, lane);

    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BT / 16; ++ks)
      sm90::wgmma_m64k16_rA<DP, 1>(acc, da + 4 * ks,
                                   sm90::desc_add(desc_kt, k_off + ks * 2 * 16 * DP), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands<DP / 2>(acc);
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qw + row_lo + 8 * r;
    if (i < p.Tq)
      store_row<DP>(p.dq + (((long long)b * p.Tq + i) * p.H + h) * p.D, acc, r, p.D, p.scale,
                    true, lane);
  }
}

// ---------------------------------------------------------------------------
// Launch helpers.

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int smem, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, p.H, p.B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, int NV>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  return launch(flash_bwd_dkv_narrow_kernel<DP, NV>, p, DkvSmem<DP, NV>::SIZE,
                (p.Tk + BM - 1) / BM, stream);
}

template <int DP, int NV>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  return launch(flash_bwd_dq_narrow_kernel<DP, NV>, p, DqSmem<DP, NV>::SIZE, (p.Tq + BM - 1) / BM,
                stream);
}

}  // namespace

// Strides are in elements; the head dim of q, k, v and dout must be
// contiguous; lse and delta are [B, H, Tq] fp32; dq, dk and dv are
// contiguous.  Head widths 1 to 64.  Each returns a cudaError_t (0 on
// success).
#define PERCEIVER_BWD_NARROW_ARGS                                                              \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,              \
      const void *delta, const void *kv_mask, void *dq, void *dk, void *dv, int batch,         \
      int heads, int tq, int tk, int kv_len, int d, int dv_width, long long q_sb, long long q_st, \
      long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,           \
      long long v_st, long long v_sh, long long o_sb, long long o_st, long long o_sh,           \
      float scale, void *stream

#define PERCEIVER_BWD_NARROW_PASS                                                           \
  q, k, v, dout, lse, delta, kv_mask, dq, dk, dv, batch, heads, tq, tk, kv_len, d, dv_width, \
      q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh, scale, stream

static bool make_params(Params* p, PERCEIVER_BWD_NARROW_ARGS) {
  if (d < 1 || d > 64 || dv_width < 1 || dv_width > 64 || kv_len < 0 || kv_len > tk ||
      heads > 65535 || batch > 65535)
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
  p->B = batch;
  p->H = heads;
  p->Tq = tq;
  p->Tk = tk;
  p->kv_len = kv_len;
  p->D = d;
  p->Dv = dv_width;
  p->n_tiles = 0;
  p->al_q = sm90::copy_vec(q, q_sb, q_st, q_sh, d) == 16;
  p->al_k = sm90::copy_vec(k, k_sb, k_st, k_sh, d) == 16;
  p->al_v = sm90::copy_vec(v, v_sb, v_st, v_sh, dv_width) == 16;
  p->al_o = sm90::copy_vec(dout, o_sb, o_st, o_sh, dv_width) == 16;
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

// K2: one block per 128 keys, walking every query tile of 64.
extern "C" int flash_attention_bwd_dkv_narrow_sm90(PERCEIVER_BWD_NARROW_ARGS) {
  Params p;
  if (!make_params(&p, PERCEIVER_BWD_NARROW_PASS)) return (int)cudaErrorInvalidValue;
  p.n_tiles = (tq + BT - 1) / BT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dp32 = d <= 32, nv32 = dv_width <= 32;
  cudaError_t err = dp32 ? (nv32 ? launch_dkv<32, 32>(p, s) : launch_dkv<32, 64>(p, s))
                         : (nv32 ? launch_dkv<64, 32>(p, s) : launch_dkv<64, 64>(p, s));
  return (int)err;
}

// K3: one block per 128 query rows, walking every key tile of 64 below kv_len.
extern "C" int flash_attention_bwd_dq_narrow_sm90(PERCEIVER_BWD_NARROW_ARGS) {
  Params p;
  if (!make_params(&p, PERCEIVER_BWD_NARROW_PASS)) return (int)cudaErrorInvalidValue;
  p.n_tiles = (kv_len + BT - 1) / BT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dp32 = d <= 32, nv32 = dv_width <= 32;
  cudaError_t err = dp32 ? (nv32 ? launch_dq<32, 32>(p, s) : launch_dq<32, 64>(p, s))
                         : (nv32 ? launch_dq<64, 32>(p, s) : launch_dq<64, 64>(p, s));
  return (int)err;
}
