// Flash attention forward (K1) for bf16 inputs on Hopper (sm_90a) where a
// (batch, head) has many query rows over a short key range: the flow
// decoder's cross-attend, 182,528 output queries over 2,048 latents, one
// head 512 wide (and d = dv = 257 to 512 wide calls of that shape).
//
// Replaces `_flash_kernel` (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py,
// launched by `_flash_forward` through `pl.pallas_call`) at head widths of
// 257 to 512 with at least 8,448 query rows (a 64-row tile for every SM)
// over at most 8,192 keys (ops/flash_attention.py `launch_plan`, route
// "sm90_longq"; a forced split count keeps flash_attention_fwd_sm90.cu).
// The same contract as flash_attention_fwd_longkv_sm90.cu's kernel: S = Q K^T
// from bf16 x bf16 with fp32 sums, the scale applied after the product;
// keys at or beyond kv_len and keys whose kv_mask byte is 0 get probability
// 0; an online softmax in base 2 (exp2 of the logits prescaled by scale *
// log2(e)) with fp32 running max m and sum l; p summed into l in fp32 and
// rounded to bf16 before P V; O summed in fp32; a row whose keys are all
// masked gives exactly 0 and lse = +inf; rows whose q_mask byte is 0 are
// written as 0; an optional lse in natural units.  The keys are never
// split, so there is no merge.  No atomics: two calls give the same bits.
//
// What bounds it on an H100.  Per (query, key) pair K1 does 2 (d + dv)
// FLOP: 0.766 TFLOP at (B, Tq, Tk) = (1, 182,528, 2,048) and d = dv = 512,
// 0.774 ms at 989 TFLOP/s, against 0.38 GB of bf16 read and written once
// (0.11 ms at 3.35 TB/s).  As in the long-KV kernels, the register file
// holds O for 64 query rows a block (128 KB of fp32 at 512 columns), so
// every 64-row query tile reads its batch entry's K and V (4 MB, which stay
// in L2) again: 2,852 tiles read 12.0 GB out of L2 at batch 1, 2.35 ms at
// the ~5.1 TB/s the long-KV K1 reached.  flash_attention_fwd_sm90.cu
// (`<256, 64>`: a block a tile, consumers issuing their own 16-byte
// cp.async loads into single buffers) took 5.77-5.85 ms there.
//
// The design:
//   * Persistent blocks.  A grid of min(query tiles x B x H, NUM_SMS)
//     blocks, one an SM, walks the query tiles in a fixed order: item =
//     (batch x head, query tile), the tile fastest, so that the blocks
//     walking one batch entry's keys run at the same time; block i takes
//     items i, i + blocks, ...  Every item walks all keys below kv_len.
//   * Q resident for a tile, as the long-KV K1 keeps it (64-column chunks in
//     wgmma's 128-byte swizzle, 64 KB at d = 512).  The consumers release it
//     once S of the tile's last step is done, and a producer warp loads the
//     next tile's Q at once, while that step's softmax, P V and the
//     epilogue run.
//   * A producer warpgroup feeds two TMA rings of 64-key x 64-column chunks
//     (K's 10 slots and V's 9 at 512 wide): warp 0 the K ring, warp 1 the V
//     ring, warp 2 Q, each walking the same items; the rings' positions are
//     running counters that carry from one tile to the next, so the
//     producers run ahead into the next tile while the consumers finish one.
//   * Two consumer warpgroups split the value columns (256 each at 512: 128
//     fp32 registers a thread, setmaxnreg moving the producers' registers
//     to them) and the step's keys (S for 32 keys each over the whole head),
//     with the row maxima and P crossing through shared memory, as the
//     long-KV K1 does (its source note says why).
//   * No clusters: clusters of 2 or 4 blocks on neighbouring tiles, sharing
//     each K and V chunk by TMA multicast, halved or quartered the L2 reads
//     and ran slower on an H100 (PERF.md), so L2 is not what bounds this
//     kernel.
//   * The epilogue stores O as bf16 pairs, four lanes covering 16 bytes of
//     a row, without a block barrier: the stores drain while the consumers
//     start the next tile, whose chunks the producers have already loaded.
//   * Rows that are not 16-byte aligned (offset views), which TMA cannot
//     address, are first copied into 16-byte aligned rows (longkv.cuh
//     copy_rows, through flash_attention_fwd_longkv_sm90.cu's entry point;
//     the wrapper launches it).
//
// Interface: a plain C function, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "longkv.cuh"
#include "sm90.cuh"

namespace {

using namespace longkv;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;              // query rows of a tile
constexpr int BK = 64;              // keys of a step (one ring chunk)
constexpr int NUM_SMS = 132;        // persistent blocks at most (ops/flash_attention.py NUM_SMS)
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
// Registers a thread after setmaxnreg, the 64,512 that 384 threads x 168
// take at launch shared out: the producers keep 56 (TMA issue loops), the
// consumers take 224 (O: NM / 2 x 32, 128 at d = 512; S 16; P 16).
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = (168 * THREADS - 128 * PRODUCER_REGS) / CONSUMERS;
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block may use on an H100
constexpr int MAX_WIDTH = 512;      // the widest head (8 chunks of 64; ops/flash_attention.py)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// Named barriers (0 is __syncthreads) of the two consumer warpgroups: the
// row maxima (and, at the end of a tile, the row sums) posted, P posted.
constexpr int BAR_MAX = 1, BAR_P = 2;

struct Params {
  const uint8_t* kv_mask;  // [B, Tk] or null
  const uint8_t* q_mask;   // [B, Tq] or null
  bf16* out;               // [B, Tq, H, Dv], contiguous
  float* lse;              // [B, H, Tq] or null
  int B, H, Tq, Tk, kv_len, D, Dv;
  int red16;               // 16-column steps of S's reduction: ceil(D / 16)
  int nq;                  // column chunks of 64 of Q and K (d)
  int nv;                  // column chunks of 64 of V (dv)
  int n_tiles;             // query tiles of 64: ceil(Tq / 64)
  int items;               // B x H x n_tiles
  int nkb;                 // steps of 64 keys: ceil(kv_len / 64)
  float scale_log2;        // softmax scale * log2(e)
  // Boxes of 64 columns x 64 query rows (Q) or 64 keys (K, V).
  CUtensorMap tm_q, tm_k, tm_v;
};

// Shared memory of a block with NM column chunks of 64: Q resident (NM
// chunks of 64 rows x 64 columns, 128-byte swizzled), two rings of 64-key
// chunks, K's and V's, sharing what is left, and the exchange areas of the
// row maxima and sums and of P.  Every offset is a multiple of 1024 bytes
// (the swizzle's repeat) from a 1024-byte aligned base.
template <int NM>
struct Smem {
  static constexpr int CH = BQ * 128;  // a resident Q chunk
  static constexpr int SLOT = BK * 128;  // a ring chunk
  static constexpr int Q = 0;
  static constexpr int RING = NM * CH;
  // 1 KB for the barriers, 9 KB for the exchanges and 1 KB to align the base.
  static constexpr int AVAIL = MAX_SMEM - RING - 2048 - 9216;
  static constexpr int FIT = AVAIL / SLOT;
  static constexpr int NSK = FIT - FIT / 2;
  static constexpr int NSV = FIT / 2;
  static constexpr int K = RING;
  static constexpr int V = K + NSK * SLOT;
  static constexpr int BAR = V + NSV * SLOT;
  static constexpr int NBAR = 2 * NSK + 2 * NSV + 2;
  static constexpr int XM = BAR + 1024;  // maxima, then sums: [2 warpgroups][64 rows] fp32 each
  static constexpr int XP = XM + 1024;   // P as bf16 pairs, [2 warpgroups][8][128 threads]
  static constexpr int SIZE = XP + 8192 + 1024;
  // A step's K chunks are held until both warpgroups' S is done, its V
  // chunks until their P V: each ring holds a whole step.
  static_assert(NSK >= NM && NSV >= NM, "a step's chunks must fit the rings");
  static_assert(8 * NBAR <= 1024 && SIZE <= MAX_SMEM, "K1 long-Q tiles exceed shared memory");
  static_assert(RING % 1024 == 0 && K % 1024 == 0 && V % 1024 == 0, "swizzle atoms");
};

struct Work {
  int b, h, tile;
};

// Item `item`: (batch x head, query tile), the tile fastest.
__device__ __forceinline__ Work work_of(const Params& p, int item) {
  Work w;
  const int bh = item / p.n_tiles;
  w.tile = item - bh * p.n_tiles;
  w.h = bh % p.H;
  w.b = bh / p.H;
  return w;
}

// A producer's ring of NS slots: chunk g of the walk goes to slot s in its
// phase ph; from the second lap on, the slot's last chunk must have been
// released.
template <int NS>
struct Ring {
  char* base;
  uint64_t* full;
  uint64_t* empty;
  int s = 0, ph = 0;
  bool lapped = false;

  __device__ __forceinline__ void put(const CUtensorMap* tm, int col, const Work& w, int row) {
    constexpr int SLOT = BK * 128;
    if (lapped) sm90::mbar_wait(&empty[s], ph ^ 1);
    arrive_expect_tx(&full[s], SLOT);
    tma_load(base + s * SLOT, tm, col, w.h, row, w.b, &full[s]);
    if (++s == NS) s = 0, ph ^= 1, lapped = true;
  }
};

template <int NM>
__device__ __forceinline__ void consume(const Params& p, char* smem, int wg);

template <int NM>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_longq_kernel(const __grid_constant__ Params p) {
  using L = Smem<NM>;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty_k = full_k + L::NSK;
  uint64_t* full_v = empty_k + L::NSK;
  uint64_t* empty_v = full_v + L::NSV;
  uint64_t* full_q = empty_v + L::NSV;
  uint64_t* empty_q = full_q + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::NSK; ++s) {
      sm90::mbar_init(&full_k[s], 1);   // the producer, the bytes counted
      sm90::mbar_init(&empty_k[s], 8);  // every consumer warp
    }
    for (int s = 0; s < L::NSV; ++s) {
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_v[s], 4);  // the warps of the warpgroup that reads the chunk
    }
    sm90::mbar_init(full_q, 1);
    sm90::mbar_init(empty_q, 8);  // the consumer warps
  }
  __syncthreads();

  // Warp-uniform roles (read from lane 0, so that ptxas sees them as such
  // and does not serialise the wgmma): 0, 1 the consumer warpgroups, 2 the
  // producers.
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<NM>(p, smem, role);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // Warp 0 of the producers feeds the K ring, warp 1 the V ring, warp 2
    // Q, one thread each, over the block's items.
    const int side = __shfl_sync(0xffffffffu, (tid - CONSUMERS) >> 5, 0);
    if ((tid & 31) == 0) {
      if (side == 0) {
        Ring<L::NSK> ring{smem + L::K, full_k, empty_k};
        for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
          const Work w = work_of(p, item);
          for (int kb = 0; kb < p.nkb; ++kb)
            for (int c = 0; c < p.nq; ++c) ring.put(&p.tm_k, 64 * c, w, kb * BK);
        }
      } else if (side == 1) {
        Ring<L::NSV> ring{smem + L::V, full_v, empty_v};
        for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
          const Work w = work_of(p, item);
          for (int kb = 0; kb < p.nkb; ++kb)
            for (int c = 0; c < p.nv; ++c) ring.put(&p.tm_v, 64 * c, w, kb * BK);
        }
      } else if (side == 2) {
        int j = 0;
        for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++j) {
          const Work w = work_of(p, item);
          if (j > 0) sm90::mbar_wait(empty_q, (j - 1) & 1);
          arrive_expect_tx(full_q, p.nq * L::CH);
          for (int c = 0; c < p.nq; ++c)
            tma_load(smem + L::Q + c * L::CH, &p.tm_q, 64 * c, w.h, w.tile * BQ, w.b, full_q);
        }
      }
    }
    __syncwarp();
  }
}

// What a consumer thread works with: its warpgroup, lane and fragment
// rows, the exchange areas, the ring barriers and the descriptors of Q and
// of the rings' first slots.
template <int NM>
struct Consumer {
  using L = Smem<NM>;
  static constexpr int NA = (NM + 1) / 2;  // O tiles a warpgroup holds at most
  static constexpr int NS = BK / 4;        // registers of one m64 x 32 fp32 fragment (half of S)
  int wg, lane, row_lo, t128, c0, ncw;
  uint64_t *full_k, *empty_k, *full_v, *empty_v, *full_q, *empty_q;
  float* xm;
  uint32_t* xp;
  uint64_t desc_q, desc_k, desc_v;

  __device__ __forceinline__ Consumer(const Params& p, char* smem, int wg_) : wg(wg_) {
    const int tid = threadIdx.x;
    lane = tid & 31;
    row_lo = 16 * ((tid >> 5) & 3) + (lane >> 2);  // fragment rows row_lo, row_lo + 8
    t128 = tid & 127;
    const int half = (p.nv + 1) / 2;
    c0 = wg ? half : 0;
    ncw = wg ? p.nv - half : half;
    full_k = reinterpret_cast<uint64_t*>(smem + L::BAR);
    empty_k = full_k + L::NSK;
    full_v = empty_k + L::NSK;
    empty_v = full_v + L::NSV;
    full_q = empty_v + L::NSV;
    empty_q = full_q + 1;
    xm = reinterpret_cast<float*>(smem + L::XM);
    xp = reinterpret_cast<uint32_t*>(smem + L::XP);
    desc_q = make_desc_sw128(smem + L::Q);
    desc_k = make_desc_sw128(smem + L::K);
    desc_v = make_desc_sw128(smem + L::V);
  }

  // S = Q K^T over the whole head for this warpgroup's 32 keys of the step
  // whose first K chunk lies at ring position ks0 in phase kph, chunk by
  // chunk as they land (not committed).
  __device__ __forceinline__ void issue_s(const Params& p, float* s, int ks0, int kph) const {
    for (int c = 0; c < p.nq; ++c) {
      const int at = ks0 + c;
      const int slot = at >= L::NSK ? at - L::NSK : at;
      sm90::mbar_wait(&full_k[slot], kph ^ (at >= L::NSK));  // TMA: no proxy fence
      const int steps = min(4, p.red16 - 4 * c);
      for (int ks = 0; ks < steps; ++ks)
        sm90::wgmma_m64k16<BK / 2, 0, 0>(
            s, sm90::desc_add(desc_q, c * L::CH + ks * 32),
            sm90::desc_add(desc_k, slot * L::SLOT + wg * (BK / 2) * 128 + ks * 32),
            (c | ks) > 0);
    }
  }

  // Lane c releases the step's K chunk c (from ring position ks0).
  __device__ __forceinline__ void release_k(const Params& p, int ks0) const {
    if (lane < p.nq) sm90::mbar_arrive(&empty_k[ring_at(ks0, lane, L::NSK)]);
  }

  // The online softmax of a step's S (this warpgroup's keys from k0 + 32 wg
  // on, below k_end): scale (base 2), mask where a key may be masked, the
  // row maxima of both warpgroups (through shared memory), the running max
  // and sum rescaled by alpha, then P summed in fp32 and rounded to bf16
  // pairs in wgmma's register-A layout: this warpgroup's k16 steps from its
  // own registers, the other's (read after BAR_P) from shared memory.  The
  // other warpgroup has read the maxima and P of the step before by the
  // time either passes a barrier of this step, so one exchange area each
  // suffices.
  __device__ __forceinline__ void softmax(const Params& p, float* s, int k0, int k_end, int b,
                                          float* m_run, float* l_run, float* alpha,
                                          uint32_t* a) const {
    float mx[2] = {-INFINITY, -INFINITY};
    const int kh = k0 + (BK / 2) * wg;  // this warpgroup's keys
    if (p.kv_mask == nullptr && k0 + BK <= k_end) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] *= p.scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
      const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)b * p.Tk : nullptr;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = kh + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool ok = key < k_end && (kvm == nullptr || kvm[key] != 0);
        s[i] = ok ? s[i] * p.scale_log2 : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if ((lane & 3) == 0) xm[wg * 64 + row_lo + 8 * r] = mx[r];
    }
    named_sync<BAR_MAX, CONSUMERS>();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], fmaxf(mx[r], xm[(1 - wg) * 64 + row_lo + 8 * r]));
      // Rows with every key masked so far: keep exp2 away from -inf - -inf.
      m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = (m_run[r] == -INFINITY) ? 0.f : exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    uint32_t own[8], other[8];
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(s[i] - m_use[r]);
      const float p1 = exp2f(s[i + 1] - m_use[r]);
      l_run[r] += p0 + p1;
      own[i >> 1] = sm90::pack_bf16x2(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) xp[(wg * 8 + i) * 128 + t128] = own[i];
    named_sync<BAR_P, CONSUMERS>();
#pragma unroll
    for (int i = 0; i < 8; ++i) other[i] = xp[((1 - wg) * 8 + i) * 128 + t128];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = wg ? other[i] : own[i];
      a[8 + i] = wg ? own[i] : other[i];
    }
  }

  // O[:, 64 (c0 + j) ..] *= alpha, then += P V[:, 64 (c0 + j) ..] over this
  // warpgroup's V chunks of the step whose first V chunk lies at ring
  // position vs0 in phase vph: V read MN-major, 16 keys a k16 step, P from
  // registers (not committed).
  __device__ __forceinline__ void issue_pv(float (&acc)[NA][32], const float* alpha,
                                           const uint32_t* a, int vs0, int vph) const {
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i >> 1) & 1];
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      if (j < ncw) {
        const int at = vs0 + c0 + j;
        const int slot = at >= L::NSV ? at - L::NSV : at;
        sm90::mbar_wait(&full_v[slot], vph ^ (at >= L::NSV));
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          sm90::wgmma_m64k16_rA<64, 1>(acc[j], a + 4 * ks,
                                       sm90::desc_add(desc_v, slot * L::SLOT + ks * 16 * 128),
                                       1);
      }
    }
  }

  // Lane j releases this warpgroup's V chunk c0 + j of the step (from ring
  // position vs0).
  __device__ __forceinline__ void release_v(int vs0) const {
    if (lane < ncw) sm90::mbar_arrive(&empty_v[ring_at(vs0, c0 + lane, L::NSV)]);
  }

  // A tile's end: each warpgroup's row sums over the four lanes of a row,
  // then the two added through shared memory, warpgroup 0's first, by both
  // (both hold the same m and l; warpgroup 0 writes them); O / l as bf16
  // pairs, four lanes covering 16 bytes of a row where dv is even (every
  // pair 4-byte aligned), q-masked rows 0, and the lse.
  __device__ __forceinline__ void epilogue(const Params& p, const Work& w,
                                           const float (&acc)[NA][32], const float* m_run,
                                           float* l_run) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      if ((lane & 3) == 0) xm[128 + wg * 64 + row_lo + 8 * r] = l_run[r];
    }
    named_sync<BAR_MAX, CONSUMERS>();
    const long long bh = (long long)w.b * p.H + w.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = w.tile * BQ + row_lo + 8 * r;
      if (i >= p.Tq) continue;
      const float l = xm[128 + row_lo + 8 * r] + xm[128 + 64 + row_lo + 8 * r];
      const bool keep = p.q_mask == nullptr || p.q_mask[(long long)w.b * p.Tq + i] != 0;
      const float inv = (keep && l > 0.f) ? 1.f / l : 0.f;
      bf16* og = p.out + ((long long)w.b * p.Tq + i) * p.H * p.Dv + (long long)w.h * p.Dv;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (j >= ncw) continue;
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          if (((e >> 1) & 1) != r) continue;
          const int col = 64 * (c0 + j) + 8 * (e >> 2) + 2 * (lane & 3);
          if ((p.Dv & 1) == 0) {
            if (col < p.Dv)
              *reinterpret_cast<uint32_t*>(og + col) =
                  sm90::pack_bf16x2(acc[j][e] * inv, acc[j][e + 1] * inv);
          } else {
            if (col < p.Dv) og[col] = __float2bfloat16_rn(acc[j][e] * inv);
            if (col + 1 < p.Dv) og[col + 1] = __float2bfloat16_rn(acc[j][e + 1] * inv);
          }
        }
      }
      if (p.lse != nullptr && wg == 0 && (lane & 3) == 0)
        p.lse[bh * p.Tq + i] = (l == 0.f) ? INFINITY : m_run[r] * LN2 + logf(l);
    }
  }
};

// A consumer warpgroup, tile after tile of the block's items.  Per step of
// 64 keys: S = Q K^T for its half of the keys, the online softmax with the
// other warpgroup's row maxima and P, then O += P V over its own O tiles (V
// chunks), each product waited for before what follows it; then the tile's
// epilogue.  (Issuing the next step's S before this step's P V, to run the
// softmax beside P V on the tensor cores, ran 1.36x slower at the flow
// decoder on an H100: PERF.md.)  The rings' positions are running counters
// carried from tile to tile: the slot of the step's first K and V chunk and
// the phase of that slot's lap; chunk c lies c slots on.  After the tile's
// last S, lane 0 of each warp releases Q for the next tile's load.
template <int NM>
__device__ __forceinline__ void consume(const Params& p, char* smem, const int wg) {
  using C = Consumer<NM>;
  using L = Smem<NM>;
  constexpr int NA = C::NA, NS = C::NS;
  const C cw(p, smem, wg);
  int ks0 = 0, kph = 0, vs0 = 0, vph = 0;
  int j = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++j) {
    const Work w = work_of(p, item);
    float acc[NA][32];  // O columns 64 (c0 + t) ..: m64 x 64 fragments
#pragma unroll
    for (int t = 0; t < NA; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // base-2 running max of rows lo, hi
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

    sm90::mbar_wait(cw.full_q, j & 1);
    if (p.nkb == 0 && cw.lane == 0) sm90::mbar_arrive(cw.empty_q);
    for (int kb = 0; kb < p.nkb; ++kb) {
      float s[NS], alpha[2];
      uint32_t a[BK / 4];
      sm90::wgmma_fence();
      cw.issue_s(p, s, ks0, kph);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands<NS>(s);
      cw.release_k(p, ks0);
      if (kb == p.nkb - 1 && cw.lane == 0) sm90::mbar_arrive(cw.empty_q);
      ks0 += p.nq;
      if (ks0 >= L::NSK) ks0 -= L::NSK, kph ^= 1;
      cw.softmax(p, s, kb * BK, p.kv_len, w.b, m_run, l_run, alpha, a);
      cw.issue_pv(acc, alpha, a, vs0, vph);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < NA; ++t) sm90::fence_operands<32>(acc[t]);
      cw.release_v(vs0);
      vs0 += p.nv;
      if (vs0 >= L::NSV) vs0 -= L::NSV, vph ^= 1;
    }
    cw.epilogue(p, w, acc, m_run, l_run);
  }
}

// The kernel at NM column chunks, after the tensor maps of K and V from k
// [B, Tk, H, D] and v [B, Tk, H, Dv] at the given strides.
template <int NM>
cudaError_t launch(Params p, const void* k, long long k_sb, long long k_st, long long k_sh,
                   const void* v, long long v_sb, long long v_st, long long v_sh,
                   cudaStream_t stream) {
  using L = Smem<NM>;
  if (!longkv::make_tmap(&p.tm_k, k, p.B, p.Tk, p.H, p.D, k_sb, k_st, k_sh, BK) ||
      !longkv::make_tmap(&p.tm_v, v, p.B, p.Tk, p.H, p.Dv, v_sb, v_st, v_sh, BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_longq_kernel<NM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SIZE);
  if (err != cudaSuccess) return err;
  kernel<<<min(p.items, NUM_SMS), THREADS, L::SIZE, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K1 on the long-Q route.  Strides are in elements; q, k and v must have
// 16-byte aligned starts and strides (the wrapper copies those that do not
// into aligned rows: flash_attention_fwd_longkv_copy_rows) and a contiguous
// head dim.  Head widths d and dv of 1 to 512 whose wider one is above 256.
// min(ceil(tq / 64) x batch x heads, NUM_SMS) persistent blocks walk the
// query tiles, each over keys [0, kv_len), writing out [B, Tq, H, Dv]
// (contiguous) and lse [B, H, Tq] (if not null).  Returns a cudaError_t (0
// on success; invalid value for operands it does not take).
extern "C" int flash_attention_fwd_longq_sm90(
    const void* q, const void* k, const void* v, const void* kv_mask, const void* q_mask,
    void* out, void* lse, int batch, int heads, int tq, int tk, int kv_len, int d, int dv,
    long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, float scale, void* stream) {
  const int width = d > dv ? d : dv;
  if (d < 1 || dv < 1 || width <= 256 || width > MAX_WIDTH || kv_len < 0 || kv_len > tk ||
      batch < 1 || heads < 1 || tq < 1 || tk < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
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
  p.red16 = (d + 15) / 16;
  p.nq = (d + 63) / 64;
  p.nv = (dv + 63) / 64;
  p.n_tiles = (tq + BQ - 1) / BQ;
  p.nkb = (kv_len + BK - 1) / BK;
  const long long items = (long long)batch * heads * p.n_tiles;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  p.scale_log2 = scale * LOG2E;
  // TMA takes a start and strides that are multiples of 16 bytes (a row may
  // end anywhere: the box reads zeros past it); make_tmap refuses others.
  if (!longkv::make_tmap(&p.tm_q, q, batch, tq, heads, d, q_sb, q_st, q_sh, BQ))
    return (int)cudaErrorInvalidValue;
  return (int)launch<8>(p, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh,
                        static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory (bytes, the alignment pad included) of the
// kernel, and the slots of its K and V rings.  For reports: no launch.
extern "C" int flash_attention_fwd_longq_smem(int* slots_k, int* slots_v) {
  *slots_k = Smem<8>::NSK, *slots_v = Smem<8>::NSV;
  return Smem<8>::SIZE;
}
