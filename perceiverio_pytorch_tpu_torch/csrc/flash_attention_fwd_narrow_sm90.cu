// Flash attention forward for bf16 inputs with narrow heads (Dqk and Dv up
// to 64) on Hopper (sm_90a): the flow model's latent self-attends, 2048
// queries x 2048 keys in 16 heads of 32.
//
// Replaces `_flash_kernel` (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py,
// launched by `_flash_forward` through `pl.pallas_call`) for bf16 q, k, v
// whose head widths are both at most 64; wider bf16 heads take
// flash_attention_fwd_sm90.cu and fp32 inputs flash_attention_fwd.cu.  The
// same semantics as both: S = Q K^T from bf16 x bf16 with fp32 accumulation,
// the scale applied after the product; keys at or beyond kv_len and keys
// whose kv_mask byte is 0 get probability 0; an online softmax with fp32
// running max m and sum l; p is summed into l in fp32 and only then rounded
// to bf16 for P V; O accumulates in fp32; a row whose keys are all masked
// gives exactly 0 and lse = +inf; rows whose q_mask byte is 0 are written as
// 0; the lse is in natural units.  The keys are never split: every row is
// computed by one warpgroup in one walk over the keys, whatever the batch.
//
// What bounds it on an H100.  A self-attend at d = dv = 32 does 2 x 64 FLOP
// per (query, key) pair on the tensor cores but one exponential: at batch 6
// (16 heads, 2048 x 2048) 51.5 GFLOP take 0.052 ms at 989 TFLOP/s, while
// the 403 M exponentials take about 0.11 ms on the SMs' 16 MUFU lanes each.
// So the kernel is bound by the softmax's instruction stream, and what the
// design has to do is keep that stream busy: no shared-memory round trip of
// P, no block-wide barrier per tile, and the products running under the
// exponentials.
//
// Design:
//   * Each consumer warpgroup owns 64 query rows and every value column: at
//     dv = 32 its O is 16 fp32 registers a thread, so no warpgroup exchanges
//     row maxima or sums with another.  Two consumer warpgroups (128 rows)
//     and one producer warp make a block of 288 threads, two blocks an SM.
//   * P stays in registers: the S accumulator's pairs, rounded to bf16, are
//     the A fragment of O += P V (sm90.cuh, wgmma_m64k16_rA), with V read
//     MN-major from shared memory through the transpose flag.
//   * A ring of 4 stages of 64 keys (K and V, 8 KB at d = 32) is fed by the
//     producer warp: 16-byte cp.async copies (zero-filled past the last key
//     and in the pad columns), or the realigning loader where a row is not
//     16-byte aligned (d = 41: 82-byte rows).  A stage is full on an
//     mbarrier once its copies have landed (cp.async.mbarrier.arrive.noinc:
//     the producer does not wait, and runs ahead by up to 4 tiles) or its
//     realigned rows are stored; each consumer warp fences the stage for the
//     async proxy after the wait, and marks it empty once its products have
//     read it.  No __syncthreads after the set-up.
//   * Per tile t a warpgroup issues S(t + 1) = Q K(t + 1)^T and O += P(t)
//     V(t) back to back, waits for both, frees the stage, then runs the
//     softmax of tile t + 1 and rescales O.  While it runs its softmax, the
//     SM's three other consumer warpgroups (two blocks of two) keep the
//     tensor cores busy.  A warpgroup does not overlap its own softmax with
//     its products: issuing S(t + 2) before the softmax of tile t + 1 would
//     hold P of two tiles, 16 more registers a thread, at two blocks an SM.
//   * Per-element masking only on tiles that need it: the last, ragged one,
//     or every tile of a call with a kv_mask.  The exponentials are
//     ex2.approx.ftz (a p below 2^-126 of its row's max counts as 0).
//   * Q, K and V tiles use sm90.cuh's core-matrix layout (no swizzle); the
//     loaders write every byte of each tile, zeros included, so no tile is
//     cleared beforehand.
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

constexpr int NWG = 2;                  // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NWG;            // query rows of a block
constexpr int BK = 64;                  // keys of a stage
constexpr int STAGES = 4;               // stages of the K/V ring
constexpr int THREADS = 128 * NWG + 32; // the consumers and the producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* kv_mask;  // [B, Tk] or null
  const uint8_t* q_mask;   // [B, Tq] or null
  bf16* out;               // [B, Tq, H, Dv], contiguous
  float* lse;              // [B, H, Tq] or null
  int B, H, Tq, Tk, kv_len, D, Dv;
  int n_tiles;              // ceil(kv_len / BK)
  int al_q, al_k, al_v;     // 1: 16-byte cp.async copies; 0: the realigning loader
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale_log2;  // softmax scale * log2(e)
};

// Shared memory of a block (bytes): Q, the ring's K and V stages, and the
// stages' full and empty mbarriers.
template <int DP, int NV>
struct Smem {
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * DP * 2;
  static constexpr int V = K + STAGES * BK * DP * 2;
  static constexpr int BAR = V + STAGES * BK * NV * 2;
  static constexpr int SIZE = BAR + 2 * STAGES * 8;
};

// Scales, masks (where MASKED) and exponentiates this thread's share of S
// for the keys k0 .. k0 + BK - 1, updates the running max and sum of its two
// rows, and returns P as register A fragments and the factor alpha that
// rescales the rows' earlier O.  FUSED (a positive scale): the row max is
// taken over the raw logits and scaled once, and each exponent is one fused
// multiply-add, s * scale - m.
template <bool MASKED, bool FUSED>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], uint32_t (&pa)[BK / 4],
                                             float (&alpha)[2], float (&m_run)[2],
                                             float (&l_run)[2], int k0, int kv_len,
                                             const uint8_t* kvm, float scale_log2, int lane) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float x = FUSED ? s[i] : s[i] * scale_log2;
    if constexpr (MASKED) {
      const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok = key < kv_len && (kvm == nullptr || kvm[key] != 0);
      s[i] = ok ? x : -INFINITY;
    } else {
      s[i] = x;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if constexpr (FUSED) mx[r] *= scale_log2;
    const float m_new = fmaxf(m_run[r], mx[r]);
    // Rows with every key masked so far: keep exp2 away from -inf - -inf.
    m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[r] = (m_run[r] == -INFINITY) ? 0.f : sm90::exp2_approx(m_run[r] - m_use[r]);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const float p0 = sm90::exp2_approx(FUSED ? fmaf(s[i], scale_log2, -m_use[r]) : s[i] - m_use[r]);
    const float p1 =
        sm90::exp2_approx(FUSED ? fmaf(s[i + 1], scale_log2, -m_use[r]) : s[i + 1] - m_use[r]);
    l_run[r] += p0 + p1;
    pa[i / 2] = sm90::pack_bf16x2(p0, p1);
  }
}

// DP: padded head width of Q and K (a multiple of 16), NV: of V and O.
// Two blocks an SM at NV = 32 (112 registers a thread); one at 64.
template <int DP, int NV>
__global__ void __launch_bounds__(THREADS, NV <= 32 ? 2 : 1)
    flash_fwd_narrow_kernel(const Params p) {
  using L = Smem<DP, NV>;
  extern __shared__ __align__(128) char smem[];
  char* sQ = smem + L::Q;
  char* sK = smem + L::K;
  char* sV = smem + L::V;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = p.n_tiles;
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], NWG * 4);
    }
  }
  __syncthreads();

  // The warpgroup index, read from lane 0 so that the compiler sees it is
  // the same across a warp: the roles' branches are then warp-uniform,
  // which keeps ptxas from serialising the wgmma behind them.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == NWG) {
    // The producer warp: tile t into stage t % STAGES once the consumers
    // have emptied it.  With 16-byte copies of K and V the stage's full
    // barrier receives each lane's arrival when its copies land
    // (cp.async.mbarrier.arrive.noinc), so the warp runs ahead by up to
    // STAGES tiles; a realigned operand is stored from registers, fenced and
    // signalled before the next tile.
    const int lane = tid & 31;
    const bf16* kg = p.k + b * p.k_sb + h * p.k_sh;
    const bf16* vg = p.v + b * p.v_sb + h * p.v_sh;
    const bool async = p.al_k && p.al_v;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      if (t >= STAGES) sm90::mbar_wait(&empty[st], (t / STAGES - 1) & 1);
      const int k0 = t * BK;
      const int rows = min(BK, p.kv_len - k0);
      sm90::load_tile<32, BK, DP>(sK + st * BK * DP * 2, kg + (long long)k0 * p.k_st, p.k_st,
                                  rows, p.D, p.al_k, lane);
      sm90::load_tile<32, BK, NV>(sV + st * BK * NV * 2, vg + (long long)k0 * p.v_st, p.v_st,
                                  rows, p.Dv, p.al_v, lane);
      if (async) {
        sm90::cp_async_mbar_arrive_noinc(&full[st]);
      } else {
        sm90::cp_async_commit();
        sm90::cp_async_wait<0>();
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&full[st]);
      }
    }
    sm90::cp_async_wait<0>();  // the warp leaves once its copies have landed
    return;
  }

  // A consumer warpgroup: query rows q0 + 64 wg .. + 63.
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row_lo = 16 * warp + (lane >> 2);  // this thread's rows: row_lo, row_lo + 8
  const int qw = q0 + 64 * wg;
  char* sQw = sQ + wg * 64 * DP * 2;
  sm90::load_tile<128, 64, DP>(sQw, p.q + b * p.q_sb + h * p.q_sh + (long long)qw * p.q_st,
                               p.q_st, min(64, p.Tq - qw), p.D, p.al_q, tid & 127);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  if (wg == 0) sm90::warpgroup_sync<1>();
  else sm90::warpgroup_sync<2>();

  const uint64_t desc_q = sm90::make_desc(sm90::smem_addr(sQw), 128, 16 * DP);
  const uint64_t desc_k = sm90::make_desc(sm90::smem_addr(sK), 128, 16 * DP);
  const uint64_t desc_v = sm90::make_desc(sm90::smem_addr(sV), 16 * NV, 128);

  float o[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // base-2 running max of rows lo, hi
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  float s[BK / 2];
  uint32_t pa[BK / 4];
  const bool mask_all = kvm != nullptr;

  auto issue_s = [&](int t) {
    const int st = t % STAGES;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      sm90::wgmma_m64k16<BK, 0, 0>(s, sm90::desc_add(desc_q, ks * 256),
                                   sm90::desc_add(desc_k, st * BK * DP * 2 + ks * 256), ks > 0);
    sm90::wgmma_commit();
  };
  const bool fused = p.scale_log2 > 0.f;
  auto softmax = [&](int t, uint32_t (&pout)[BK / 4], float (&alpha)[2]) {
    const int k0 = t * BK;
    const bool masked = mask_all || k0 + BK > p.kv_len;
    const float c = p.scale_log2;
    const int n = p.kv_len;
    if (masked && fused) softmax_tile<true, true>(s, pout, alpha, m_run, l_run, k0, n, kvm, c, lane);
    else if (masked) softmax_tile<true, false>(s, pout, alpha, m_run, l_run, k0, n, kvm, c, lane);
    else if (fused) softmax_tile<false, true>(s, pout, alpha, m_run, l_run, k0, n, kvm, c, lane);
    else softmax_tile<false, false>(s, pout, alpha, m_run, l_run, k0, n, kvm, c, lane);
  };

  auto issue_pv = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      sm90::wgmma_m64k16_rA<NV, 1>(o, pa + 4 * ks,
                                   sm90::desc_add(desc_v, st * BK * NV * 2 + ks * 2 * 16 * NV), 1);
    sm90::wgmma_commit();
  };
  // After each full barrier: the stage's copies, made visible to this
  // thread by the barrier, are fenced for the async proxy that wgmma reads.
  if (n_tiles > 0) {
    sm90::mbar_wait(&full[0], 0);
    sm90::fence_proxy_async();
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    sm90::fence_operands<BK / 2>(s);
    float alpha[2];
    softmax(0, pa, alpha);  // O is still 0
  }
  for (int t = 0; t + 1 < n_tiles; ++t) {
    const int st = t % STAGES;
    sm90::wgmma_fence();
    sm90::mbar_wait(&full[(t + 1) % STAGES], ((t + 1) / STAGES) & 1);
    sm90::fence_proxy_async();
    issue_s(t + 1);
    issue_pv(st);
    sm90::wgmma_wait<0>();
    sm90::fence_operands<NV / 2>(o);
    sm90::fence_operands<BK / 2>(s);
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
    float alpha[2];
    softmax(t + 1, pa, alpha);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  }
  if (n_tiles > 0) {  // the last tile's P V
    sm90::wgmma_fence();
    issue_pv((n_tiles - 1) % STAGES);
    sm90::wgmma_wait<0>();
    sm90::fence_operands<NV / 2>(o);
  }

  // The row sums over the four lanes of a row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qw + row_lo + 8 * r;
    if (i >= p.Tq) continue;
    const float l = l_run[r];
    const bool keep = p.q_mask == nullptr || p.q_mask[(long long)b * p.Tq + i] != 0;
    const float inv = (keep && l > 0.f) ? 1.f / l : 0.f;
    bf16* og = p.out + ((long long)b * p.Tq + i) * p.H * p.Dv + (long long)h * p.Dv;
#pragma unroll
    for (int j = 0; j < NV / 2; j += 2) {
      if (((j >> 1) & 1) != r) continue;
      const int col = 8 * (j >> 2) + 2 * (lane & 3);
      if (col + 1 < p.Dv && (p.Dv & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(og + col) =
            __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
      } else {
        if (col < p.Dv) og[col] = __float2bfloat16_rn(o[j] * inv);
        if (col + 1 < p.Dv) og[col + 1] = __float2bfloat16_rn(o[j + 1] * inv);
      }
    }
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[bh * p.Tq + i] = (l == 0.f) ? INFINITY : m_run[r] * LN2 + logf(l);
  }
}

template <int DP, int NV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Smem<DP, NV>::SIZE;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_narrow_kernel<DP, NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_narrow_kernel<DP, NV><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; the head dim of q, k and v must be contiguous.
// Head widths 1 to 64.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd_narrow_sm90(
    const void* q, const void* k, const void* v, const void* kv_mask, const void* q_mask,
    void* out, void* lse, int batch, int heads, int tq, int tk, int kv_len, int d, int dv,
    long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, float scale, void* stream) {
  if (d < 1 || d > 64 || dv < 1 || dv > 64 || kv_len < 0 || kv_len > tk || heads > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.q_mask = static_cast<const uint8_t*>(q_mask);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = batch;
  p.H = heads;
  p.Tq = tq;
  p.Tk = tk;
  p.kv_len = kv_len;
  p.D = d;
  p.Dv = dv;
  p.n_tiles = (kv_len + BK - 1) / BK;
  p.al_q = sm90::copy_vec(q, q_sb, q_st, q_sh, d) == 16;
  p.al_k = sm90::copy_vec(k, k_sb, k_st, k_sh, d) == 16;
  p.al_v = sm90::copy_vec(v, v_sb, v_st, v_sh, dv) == 16;
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
  cudaError_t err = d <= 32 ? (dv <= 32 ? launch<32, 32>(p, s) : launch<32, 64>(p, s))
                            : (dv <= 32 ? launch<64, 32>(p, s) : launch<64, 64>(p, s));
  return (int)err;
}
