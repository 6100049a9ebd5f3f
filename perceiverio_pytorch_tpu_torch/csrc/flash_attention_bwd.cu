// Flash attention backward for fp32 inputs on Hopper (sm_90a): two
// hand-written kernels on the CUDA cores.
//
// Replaces the two Pallas sweeps of `_pallas_attention_bwd`
// (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py) for fp32 q, k, v;
// bf16 inputs take the wgmma kernels of flash_attention_bwd_sm90.cu:
//   * `_bwd_dkv_kernel` (K2): dK and dV, one key block at a time, walking
//     every query block;
//   * `_bwd_dq_kernel` (K3): dQ, one query block at a time, walking every
//     key block.
// Both share `_bwd_common`: recompute p = exp(scale * q k^T - lse) from the
// forward's saved log-sum-exp (a row with lse = +inf, whose keys were all
// masked, gives p = 0), dp = do v^T and ds = p * (dp - delta), where the
// caller computes delta = rowsum(do * out) and zeroes do on q-masked rows.
// Then K2 accumulates dv += p^T do and dk += scale * ds^T q, and K3
// dq += scale * ds k.  Keys at or beyond kv_len and keys whose kv_mask byte
// is 0 get p = 0, so their dk and dv come out exactly 0.  Every sum is IEEE
// fp32 on the CUDA cores, with no TF32, no tensor cores and no fast-math
// intrinsics.
//
// What bounds them on an H100.  Per (query, key) pair and head, K2 does
// 4 d + 4 dv FLOP and K3 4 d + 2 dv.  Per 368x496 flow tile that is
// 9.6e11 / 7.2e11 FLOP at the encoder cross-attend (2048 x 182,528 pairs,
// d = 322), 1.7e10 / 1.3e10 at each of the 24 latent self-attends and
// 1.5e12 / 1.15e12 at the decoder cross-attend (182,528 x 2048, d = 512);
// 2.3e11 / 1.7e11 per clip at the multimodal encoder (784 x 52,097, d = dv
// = 704); against well under 1 GB of inputs and outputs per site:
// compute-bound at every site, as the forward is.
//
// Design.  The Pallas grids walk their last axis in order, carrying the
// accumulator in scratch memory; here that walk is a loop inside one block.
//   K3: one block of 256 threads (16 x 16) owns 64 query rows of one
//   (batch, head), as the forward kernel does.  Its Q rows stay in shared
//   memory, transposed and in fp32, for the whole key walk (128 KB at
//   d = 512); per key tile of 64, K, V and dO are staged 32 head dims at a
//   time for S = Q K^T and dP = dO V^T (each thread a 4 x 4 register tile),
//   dS goes to shared memory, and dQ += dS K runs over 64-column chunks of
//   K with a 4 x 4 register tile per chunk.  The template argument NK
//   (chunks of 64 columns of d, up to 8) sizes that register accumulator,
//   so a 512-wide fp32 row of dQ never leaves registers.  dO is staged
//   again for every key tile because Q and dO together do not fit in
//   shared memory at d = 322 or 512.
//   K2: one block of 256 threads owns 32 keys of one (batch, head): each
//   warp owns 4 keys, and its 32 lanes span 64 query rows (for S^T and
//   dP^T) or 64 output columns (for the accumulators), two each.  Two
//   accumulators, dK and dV, of 32 x 512 fp32 each at the decoder's width
//   are 128 registers a thread at 256 threads; 64 keys a block would need
//   256, which is why the block takes 32.  Its K and V rows stay in shared
//   memory, transposed (64 KB each at d = 512); per query tile of 64, Q and
//   dO are staged in 32-dim chunks for S^T = K Q^T and dP^T = V dO^T, P and
//   dS go to shared memory, and dV += P^T dO, dK += dS^T Q run over 64-column
//   chunks of dO and Q.  The template argument NC (chunks of 64 columns of
//   max(d, dv)) sizes both accumulators.
// Ragged head widths (322, 41, 24) are zero-padded in shared memory to a
// multiple of 32, which leaves every product unchanged; ragged Tq and Tk are
// handled by masking rows at or past Tq (lse = +inf, do = 0) and keys at or
// past kv_len, and by zero-filling the staged rows.
//
// Widths above 512 (the multimodal encoder: d = dv = 704 over 52,097 keys,
// 784 queries).  Shared memory still fits: K3's resident Q is 704 x 64 x 4 =
// 176 KB, 230,912 bytes with its staged tiles; K2's K and V rows 88 KB
// each, 224,256 bytes in all, inside the 232,448 a block may use.  The
// register accumulators do not: eleven 64-column tiles would be 176
// registers a thread for dQ, and as many for dK and dV together.  So, as K1
// does (flash_attention_fwd.cu), the output columns are split over a grid
// axis of column chunks (the wrapper's `col_chunks`: 384 + 320 at 704, the
// template's 6 tiles of 64, 96 registers as at d = 322): each block
// recomputes S and dP at the full width and accumulates only its columns
// (of dQ in K3, of dK and dV in K2).  The chunks compute S and dP in the
// same order, so their P and dS agree bit for bit.  A CHUNKED template
// switch keeps the narrower instantiations' code as it was.  It costs 1.5x
// the useful FLOPs of K2 and 1.67x of K3 at 704.
//
// What they do not do yet.  No TMA, plain staged loads with no double
// buffering, so they reach a fraction of the fp32 CUDA-core peak.  Each grid
// is one block per outer tile and column chunk: at batch 1, K3 at the flow
// encoder (2048 queries) has 32 blocks, at the multimodal encoder 26, and K2
// at the flow decoder (2048 keys) 64, on 132 SMs (the bf16 kernels split
// those walks).
//
// Interface: two plain C functions with one argument list, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes.  Each launches one kernel on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DC = 32;  // head dims per staged chunk of the S and dP products
constexpr int VC = 64;  // output columns per accumulator chunk

// K3 (dQ): 64 query rows a block, 64 keys a tile, 16 x 16 threads.
constexpr int Q3 = 64;
constexpr int K3 = 64;
constexpr int LD3 = 68;  // row length of the transposed K/V chunk and dS tile

// K2 (dK, dV): 32 keys a block, 64 query rows a tile, 8 warps x 32 lanes.
constexpr int K2K = 32;
constexpr int K2Q = 64;
constexpr int LD2Q = K2Q + 4;  // row length of the transposed Q/dO chunk
constexpr int LD2K = K2K + 4;  // row length of the P and dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;        // [B, Tq, H, Dv], strided like q
  const float* lse;        // [B, H, Tq]
  const float* delta;      // [B, H, Tq]
  const uint8_t* kv_mask;  // [B, Tk] or null
  void* dq;                // [B, Tq, H, D], contiguous
  void* dk;                // [B, Tk, H, D], contiguous
  void* dv;                // [B, Tk, H, Dv], contiguous
  int H, Tq, Tk, kv_len, D, Dv, Dp, Dvp;
  int n_blocks;        // query blocks (K3) or key blocks (K2) of a (batch, head)
  int col_chunks, CW;  // chunk c: output columns [c CW, (c + 1) CW)
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh;
  float scale;
};

size_t dq_smem_bytes(const Params& p) {
  return sizeof(float) * ((size_t)p.Dp * Q3 + (size_t)DC * LD3 + (size_t)DC * Q3 +
                          (size_t)K3 * LD3 + (size_t)K3 * VC);
}

size_t dkv_smem_bytes(const Params& p) {
  return sizeof(float) * ((size_t)p.Dp * K2K + (size_t)p.Dvp * K2K + (size_t)DC * LD2Q +
                          2 * (size_t)K2Q * LD2K + (size_t)K2Q * VC + 2 * (size_t)K2Q);
}

// ---------------------------------------------------------------------------
// K3: dQ.  CHUNKED: the grid splits the dQ columns (col_chunks > 1, widths
// above 512); without it the chunk is 0 and spans D at compile time, so the
// kernels of the narrower widths compile as they did before the chunks.
template <int NK, bool CHUNKED>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [Dp][Q3]
  float* Ct = Qt + (size_t)p.Dp * Q3;           // [DC][LD3]: K or V chunk, transposed
  float* Ot = Ct + DC * LD3;                    // [DC][Q3]: dO chunk, transposed
  float* St = Ot + DC * Q3;                     // [K3][LD3]: dS tile, transposed
  float* Ks = St + K3 * LD3;                    // [K3][VC]: K column chunk

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (CHUNKED ? blockIdx.x % p.n_blocks : blockIdx.x) * Q3;
  const int cbase = CHUNKED ? (blockIdx.x / p.n_blocks) * p.CW : 0;  // first dQ column
  const int d_blk = CHUNKED ? min(p.CW, p.D - cbase) : p.D;          // and their number
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* kgc = kg + cbase;  // the K columns of this block's dQ
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* og = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;
  const long long row0 = ((long long)b * p.H + h) * p.Tq;

  // The block's Q rows, transposed to [d][row], fp32, zero-padded.
  for (int idx = tid; idx < Q3 * p.Dp; idx += THREADS) {
    const int i = idx / p.Dp;
    const int d = idx - i * p.Dp;
    float val = 0.f;
    if (q0 + i < p.Tq && d < p.D) val = qg[(long long)(q0 + i) * p.q_st + d];
    Qt[d * Q3 + i] = val;
  }

  // Rows past Tq: lse = +inf gives p = 0, so they contribute nothing.
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    lse_r[r] = i < p.Tq ? p.lse[row0 + i] : INFINITY;
    delta_r[r] = i < p.Tq ? p.delta[row0 + i] : 0.f;
  }

  float acc[NK][4][4];
#pragma unroll
  for (int mk = 0; mk < NK; ++mk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mk][r][c] = 0.f;

  const int n_tiles = (p.kv_len + K3 - 1) / K3;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * K3;

    // 1. S = Q K^T over head-dim chunks.
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d0 = 0; d0 < p.Dp; d0 += DC) {
      __syncthreads();  // Qt written / previous Ct reads done
      for (int idx = tid; idx < K3 * DC; idx += THREADS) {
        const int j = idx / DC;
        const int dd = idx - j * DC;
        const int key = k0 + j;
        const int d = d0 + dd;
        float val = 0.f;
        if (key < p.kv_len && d < p.D) val = kg[(long long)key * p.k_st + d];
        Ct[dd * LD3 + j] = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float4 qa = *reinterpret_cast<const float4*>(&Qt[(d0 + dd) * Q3 + ty * 4]);
        const float4 kb = *reinterpret_cast<const float4*>(&Ct[dd * LD3 + tx * 4]);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
      }
    }

    // 2. P = exp(scale * S - lse) on valid keys, 0 elsewhere.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + tx * 4 + c;
      const bool ok = key < p.kv_len && (kvm == nullptr || kvm[key] != 0);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][c] = ok ? expf(s[r][c] * p.scale - lse_r[r]) : 0.f;
    }

    // 3. dP = dO V^T over head-dim chunks of V.
    float dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[r][c] = 0.f;
    for (int d0 = 0; d0 < p.Dvp; d0 += DC) {
      __syncthreads();  // previous Ct / Ot reads done
      for (int idx = tid; idx < K3 * DC; idx += THREADS) {
        const int j = idx / DC;
        const int dd = idx - j * DC;
        const int key = k0 + j;
        const int col = d0 + dd;
        float val = 0.f;
        if (key < p.kv_len && col < p.Dv) val = vg[(long long)key * p.v_st + col];
        Ct[dd * LD3 + j] = val;
      }
      for (int idx = tid; idx < Q3 * DC; idx += THREADS) {
        const int i = idx / DC;
        const int dd = idx - i * DC;
        const int col = d0 + dd;
        float val = 0.f;
        if (q0 + i < p.Tq && col < p.Dv) val = og[(long long)(q0 + i) * p.o_st + col];
        Ot[dd * Q3 + i] = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float4 oa = *reinterpret_cast<const float4*>(&Ot[dd * Q3 + ty * 4]);
        const float4 vb = *reinterpret_cast<const float4*>(&Ct[dd * LD3 + tx * 4]);
        const float ov[4] = {oa.x, oa.y, oa.z, oa.w};
        const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
    }

    // 4. dS = P * (dP - delta), to shared memory as [key][row].  The last
    //    reads of St (step 5 of the previous tile) are behind the barriers
    //    of steps 1 and 3.
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[r][c] = s[r][c] * (dp[r][c] - delta_r[r]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&St[(tx * 4 + c) * LD3 + ty * 4]) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);

    // 5. dQ += dS K over 64-column chunks of K.
#pragma unroll
    for (int mk = 0; mk < NK; ++mk) {
      const int c0 = mk * VC;
      if (c0 < d_blk) {   // uniform over the block
        __syncthreads();  // St written / previous Ks reads done
        for (int idx = tid; idx < K3 * VC; idx += THREADS) {
          const int j = idx / VC;
          const int cc = idx - j * VC;
          const int key = k0 + j;
          const int col = c0 + cc;
          float val = 0.f;
          if (key < p.kv_len && col < d_blk) val = kgc[(long long)key * p.k_st + col];
          Ks[j * VC + cc] = val;
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < K3; ++j) {
          const float4 sa = *reinterpret_cast<const float4*>(&St[j * LD3 + ty * 4]);
          const float4 kb = *reinterpret_cast<const float4*>(&Ks[j * VC + tx * 4]);
          const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
          const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mk][r][c] = fmaf(sv[r], kv[c], acc[mk][r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= p.Tq) continue;
    float* dqg = static_cast<float*>(p.dq) + ((long long)b * p.Tq + i) * p.H * p.D +
             (long long)h * p.D + cbase;
#pragma unroll
    for (int mk = 0; mk < NK; ++mk)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = mk * VC + tx * 4 + c;
        if (col < d_blk) dqg[col] = acc[mk][r][c] * p.scale;
      }
  }
}

// ---------------------------------------------------------------------------
// K2: dK and dV.  CHUNKED: the grid splits the dK and dV columns, as K3's
// splits dQ's.
template <int NC, bool CHUNKED>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [Dp][K2K]
  float* Vt = Kt + (size_t)p.Dp * K2K;          // [Dvp][K2K]
  float* Ct = Vt + (size_t)p.Dvp * K2K;         // [DC][LD2Q]: Q or dO chunk, transposed
  float* Ps = Ct + DC * LD2Q;                   // [K2Q][LD2K]: P as [row][key]
  float* Ss = Ps + K2Q * LD2K;                  // [K2Q][LD2K]: dS as [row][key]
  float* Rs = Ss + K2Q * LD2K;                  // [K2Q][VC]: dO or Q column chunk
  float* lse_s = Rs + K2Q * VC;                 // [K2Q]
  float* delta_s = lse_s + K2Q;                 // [K2Q]

  const int tid = threadIdx.x;
  const int lane = tid & 31;  // rows lane*2.. (S, dP) or columns lane*2.. (dK, dV)
  const int warp = tid >> 5;  // keys warp*4..
  const int k0 = (CHUNKED ? blockIdx.x % p.n_blocks : blockIdx.x) * K2K;
  const int cbase = CHUNKED ? (blockIdx.x / p.n_blocks) * p.CW : 0;  // first output column
  const int dk_blk = CHUNKED ? max(0, min(p.CW, p.D - cbase)) : p.D;   // dK columns
  const int dv_blk = CHUNKED ? max(0, min(p.CW, p.Dv - cbase)) : p.Dv;  // dV columns
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* og = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* qgc = qg + cbase;  // the Q and dO columns of this block's dK and dV
  const float* ogc = og + cbase;
  const long long row0 = ((long long)b * p.H + h) * p.Tq;

  // The block's K and V rows, transposed to [d][key], fp32, zero-padded.
  for (int idx = tid; idx < K2K * p.Dp; idx += THREADS) {
    const int j = idx / p.Dp;
    const int d = idx - j * p.Dp;
    float val = 0.f;
    if (k0 + j < p.kv_len && d < p.D) val = kg[(long long)(k0 + j) * p.k_st + d];
    Kt[d * K2K + j] = val;
  }
  for (int idx = tid; idx < K2K * p.Dvp; idx += THREADS) {
    const int j = idx / p.Dvp;
    const int d = idx - j * p.Dvp;
    float val = 0.f;
    if (k0 + j < p.kv_len && d < p.Dv) val = vg[(long long)(k0 + j) * p.v_st + d];
    Vt[d * K2K + j] = val;
  }

  bool ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + warp * 4 + r;
    ok[r] = key < p.kv_len &&
            (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.Tk + key] != 0);
  }

  float acc_k[NC][4][2], acc_v[NC][4][2];
#pragma unroll
  for (int mc = 0; mc < NC; ++mc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc_k[mc][r][c] = 0.f;
        acc_v[mc][r][c] = 0.f;
      }

  // A block whose keys all lie past kv_len writes zeros without walking.
  const int n_tiles = k0 < p.kv_len ? (p.Tq + K2Q - 1) / K2Q : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * K2Q;
    __syncthreads();  // previous tile's reads of lse_s, delta_s done
    for (int i = tid; i < K2Q; i += THREADS) {
      const int row = q0 + i;
      lse_s[i] = row < p.Tq ? p.lse[row0 + row] : INFINITY;
      delta_s[i] = row < p.Tq ? p.delta[row0 + row] : 0.f;
    }

    // 1. S^T = K Q^T over head-dim chunks of Q.
    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d0 = 0; d0 < p.Dp; d0 += DC) {
      __syncthreads();  // Kt written / previous Ct reads done
      for (int idx = tid; idx < K2Q * DC; idx += THREADS) {
        const int i = idx / DC;
        const int dd = idx - i * DC;
        const int d = d0 + dd;
        float val = 0.f;
        if (q0 + i < p.Tq && d < p.D) val = qg[(long long)(q0 + i) * p.q_st + d];
        Ct[dd * LD2Q + i] = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float4 ka = *reinterpret_cast<const float4*>(&Kt[(d0 + dd) * K2K + warp * 4]);
        const float2 qb = *reinterpret_cast<const float2*>(&Ct[dd * LD2Q + lane * 2]);
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r][0] = fmaf(kv[r], qb.x, s[r][0]);
          s[r][1] = fmaf(kv[r], qb.y, s[r][1]);
        }
      }
    }

    // 2. dP^T = V dO^T over head-dim chunks of dO.
    float dp[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) dp[r][0] = dp[r][1] = 0.f;
    for (int d0 = 0; d0 < p.Dvp; d0 += DC) {
      __syncthreads();  // previous Ct reads done
      for (int idx = tid; idx < K2Q * DC; idx += THREADS) {
        const int i = idx / DC;
        const int dd = idx - i * DC;
        const int col = d0 + dd;
        float val = 0.f;
        if (q0 + i < p.Tq && col < p.Dv) val = og[(long long)(q0 + i) * p.o_st + col];
        Ct[dd * LD2Q + i] = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float4 va = *reinterpret_cast<const float4*>(&Vt[(d0 + dd) * K2K + warp * 4]);
        const float2 ob = *reinterpret_cast<const float2*>(&Ct[dd * LD2Q + lane * 2]);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          dp[r][0] = fmaf(vv[r], ob.x, dp[r][0]);
          dp[r][1] = fmaf(vv[r], ob.y, dp[r][1]);
        }
      }
    }

    // 3. P and dS = P * (dP - delta), to shared memory as [row][key].  The
    //    last reads of Ps and Ss (step 4 of the previous tile) are behind
    //    the barriers of steps 1 and 2.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float lse = lse_s[lane * 2 + c];
      const float delta = delta_s[lane * 2 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pv = ok[r] ? expf(s[r][c] * p.scale - lse) : 0.f;
        s[r][c] = pv;
        dp[r][c] = pv * (dp[r][c] - delta);
      }
      *reinterpret_cast<float4*>(&Ps[(lane * 2 + c) * LD2K + warp * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(&Ss[(lane * 2 + c) * LD2K + warp * 4]) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    }

    // 4. dV += P^T dO and dK += dS^T Q over 64-column chunks.
#pragma unroll
    for (int mc = 0; mc < NC; ++mc) {
      const int c0 = mc * VC;
      if (c0 < dv_blk) {  // uniform over the block
        __syncthreads();  // Ps written / previous Rs reads done
        for (int idx = tid; idx < K2Q * VC; idx += THREADS) {
          const int i = idx / VC;
          const int cc = idx - i * VC;
          const int col = c0 + cc;
          float val = 0.f;
          if (q0 + i < p.Tq && col < dv_blk) val = ogc[(long long)(q0 + i) * p.o_st + col];
          Rs[i * VC + cc] = val;
        }
        __syncthreads();
#pragma unroll 8
        for (int i = 0; i < K2Q; ++i) {
          const float4 pa = *reinterpret_cast<const float4*>(&Ps[i * LD2K + warp * 4]);
          const float2 ob = *reinterpret_cast<const float2*>(&Rs[i * VC + lane * 2]);
          const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc_v[mc][r][0] = fmaf(pv[r], ob.x, acc_v[mc][r][0]);
            acc_v[mc][r][1] = fmaf(pv[r], ob.y, acc_v[mc][r][1]);
          }
        }
      }
      if (c0 < dk_blk) {  // uniform over the block
        __syncthreads();  // Ss written / previous Rs reads done
        for (int idx = tid; idx < K2Q * VC; idx += THREADS) {
          const int i = idx / VC;
          const int cc = idx - i * VC;
          const int col = c0 + cc;
          float val = 0.f;
          if (q0 + i < p.Tq && col < dk_blk) val = qgc[(long long)(q0 + i) * p.q_st + col];
          Rs[i * VC + cc] = val;
        }
        __syncthreads();
#pragma unroll 8
        for (int i = 0; i < K2Q; ++i) {
          const float4 sa = *reinterpret_cast<const float4*>(&Ss[i * LD2K + warp * 4]);
          const float2 qb = *reinterpret_cast<const float2*>(&Rs[i * VC + lane * 2]);
          const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc_k[mc][r][0] = fmaf(sv[r], qb.x, acc_k[mc][r][0]);
            acc_k[mc][r][1] = fmaf(sv[r], qb.y, acc_k[mc][r][1]);
          }
        }
      }
    }
  }

  // Every key below Tk is written, those past kv_len as exact zeros.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + warp * 4 + r;
    if (key >= p.Tk) continue;
    float* dkg = static_cast<float*>(p.dk) + ((long long)b * p.Tk + key) * p.H * p.D +
             (long long)h * p.D + cbase;
    float* dvg = static_cast<float*>(p.dv) + ((long long)b * p.Tk + key) * p.H * p.Dv +
             (long long)h * p.Dv + cbase;
#pragma unroll
    for (int mc = 0; mc < NC; ++mc)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = mc * VC + lane * 2 + c;
        if (col < dk_blk) dkg[col] = acc_k[mc][r][c] * p.scale;
        if (col < dv_blk) dvg[col] = acc_v[mc][r][c];
      }
  }
}

// ---------------------------------------------------------------------------
// Launch helpers.
template <int N, bool CHUNKED = false>
cudaError_t launch_dq(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<N, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Params q = p;
  q.n_blocks = (p.Tq + Q3 - 1) / Q3;
  const dim3 grid(q.n_blocks * p.col_chunks, p.H, batch);
  flash_bwd_dq_kernel<N, CHUNKED><<<grid, THREADS, smem, stream>>>(q);
  return cudaGetLastError();
}

template <int N, bool CHUNKED = false>
cudaError_t launch_dkv(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<N, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Params q = p;
  q.n_blocks = (p.Tk + K2K - 1) / K2K;
  const dim3 grid(q.n_blocks * p.col_chunks, p.H, batch);
  flash_bwd_dkv_kernel<N, CHUNKED><<<grid, THREADS, smem, stream>>>(q);
  return cudaGetLastError();
}

// The accumulators hold `width` columns in chunks of 64: 1, 2, 3, 4, 6 or 8;
// over column chunks (widths above 512), 6: two chunks of at most 384.
template <bool DQ>
cudaError_t dispatch(const Params& p, int width, int batch, cudaStream_t stream) {
  if (p.col_chunks > 1) {
    if (p.CW > 6 * VC) return cudaErrorInvalidValue;
    return DQ ? launch_dq<6, true>(p, batch, stream) : launch_dkv<6, true>(p, batch, stream);
  }
  const int n = (width + VC - 1) / VC;
#define PERCEIVER_LAUNCH(N) \
  return DQ ? launch_dq<N>(p, batch, stream) : launch_dkv<N>(p, batch, stream)
  if (n <= 1) PERCEIVER_LAUNCH(1);
  if (n <= 2) PERCEIVER_LAUNCH(2);
  if (n <= 3) PERCEIVER_LAUNCH(3);
  if (n <= 4) PERCEIVER_LAUNCH(4);
  if (n <= 6) PERCEIVER_LAUNCH(6);
  if (n <= 8) PERCEIVER_LAUNCH(8);
#undef PERCEIVER_LAUNCH
  return cudaErrorInvalidValue;
}

int run(bool dq_pass, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* kv_mask, void* dq, void* dk,
        void* dv, int batch, int heads, int tq, int tk, int kv_len, int d,
        int dv_width, int col_chunks, long long q_sb, long long q_st, long long q_sh,
        long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
        long long v_sh, long long o_sb, long long o_st, long long o_sh, float scale,
        void* stream) {
  if (d < 1 || d > 704 || dv_width < 1 || dv_width > 704 || kv_len < 0 || kv_len > tk ||
      col_chunks < 1)
    return (int)cudaErrorInvalidValue;
  // The output columns (dQ's: d; dK's and dV's: the wider of d and dv) in
  // col_chunks chunks of whole 64-column register tiles; each chunk holds
  // some.
  const int width = dq_pass ? d : (d > dv_width ? d : dv_width);
  const int cw = (width + col_chunks - 1) / col_chunks;
  const int CW = (cw + VC - 1) / VC * VC;
  if ((col_chunks - 1) * CW >= width || (col_chunks == 1 && width > 8 * VC))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = heads;
  p.Tq = tq;
  p.Tk = tk;
  p.kv_len = kv_len;
  p.D = d;
  p.Dv = dv_width;
  p.Dp = (d + DC - 1) / DC * DC;
  p.Dvp = (dv_width + DC - 1) / DC * DC;
  p.n_blocks = 0;
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
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dq_pass ? dispatch<true>(p, width, batch, s) : dispatch<false>(p, width, batch, s));
}

}  // namespace

// fp32 inputs and outputs.  Strides are in elements; the head dim of q, k,
// v and dout must be contiguous; lse and delta are [B, H, Tq] fp32; dq, dk and
// dv are contiguous.  flash_attention_bwd_dkv (K2) writes dk and dv and
// ignores dq; flash_attention_bwd_dq (K3) writes dq and ignores dk and dv.
// col_chunks splits the kernel's output columns over the grid: 1 up to 512,
// 2 at most (two chunks of at most 384 columns).  Each returns a cudaError_t
// (0 on success).
#define PERCEIVER_BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,       \
      const void *delta, const void *kv_mask, void *dq, void *dk, void *dv,             \
      int batch, int heads, int tq, int tk, int kv_len, int d, int dv_width,            \
      int col_chunks, long long q_sb, long long q_st, long long q_sh, long long k_sb,   \
      long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,   \
      long long o_sb, long long o_st, long long o_sh, float scale, void *stream
#define PERCEIVER_BWD_PASS                                                          \
  q, k, v, dout, lse, delta, kv_mask, dq, dk, dv, batch, heads, tq, tk, kv_len, \
      d, dv_width, col_chunks, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, \
      o_sb, o_st, o_sh, scale, stream

extern "C" int flash_attention_bwd_dkv(PERCEIVER_BWD_ARGS) {
  return run(false, PERCEIVER_BWD_PASS);
}

extern "C" int flash_attention_bwd_dq(PERCEIVER_BWD_ARGS) {
  return run(true, PERCEIVER_BWD_PASS);
}
