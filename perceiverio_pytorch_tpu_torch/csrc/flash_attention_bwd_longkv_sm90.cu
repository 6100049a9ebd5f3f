// Flash attention backward, K2 (dK, dV) and K3 (dQ), for bf16 inputs on
// Hopper (sm_90a) where a (batch, head) has a short query range and many
// keys: the classification encoders' cross-attends, 512 latents over 50,176
// pixels, one head 261 (the pixel variant) or 512 (the 1x1-conv variant)
// wide, and the multimodal encoder's, 784 latents over 52,097 keys, one
// head 704 wide.
//
// Replaces `_bwd_dkv_kernel` (K2) and `_bwd_dq_kernel` (K3)
// (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py, launched by
// `_pallas_attention_bwd` through `pl.pallas_call`) at head widths of 257
// to 512 whose walk is at most 512 query rows, and of 513 to 704 whose walk
// is at most 1,024 query rows, over at least 4,224 keys
// (ops/flash_attention.py `backward_plan`, route "sm90_longkv"; a forced
// split count keeps flash_attention_bwd_sm90.cu).  The same contract as
// that file's kernels: p = exp(scale * q k^T - lse) from the forward's
// log-sum-exp (exp2 of the logits prescaled by scale * log2(e)), 0 for keys
// at or beyond kv_len, keys whose kv_mask byte is 0 and rows with lse = +inf
// (all keys masked, or past Tq); dp = do v^T and ds = p * (dp - delta) in
// fp32, where the caller computes delta = rowsum(do * out) and zeroes do on
// q-masked rows; p and ds are rounded to bf16 before their products; dv +=
// p^T do, dk += scale ds^T q and dq += scale ds k are summed in fp32 and
// written as bf16 (K3's key splits as fp32 partials, added in split order
// by flash_attention_bwd_sum).  Keys past kv_len, keys masked everywhere and
// wiped rows come out exactly 0.  No atomics: two calls give the same bits.
//
// K2 (dK, dV).
//
// What bounds it on an H100.  Per (query, key) pair K2 does 4 d + 4 dv FLOP:
// 0.84 TFLOP at (B, Tq, Tk) = (8, 512, 50,176) and d = 512, 0.85 ms at 989
// TFLOP/s.  The register wall (64 keys' dK and dV at d = 512 fill the
// register file) keeps a block at 32 keys, so every query row is read once
// per 32 keys: 8 x 1,568 blocks x 1 MiB of Q and dO, 13 GB out of L2 into
// shared memory.  The route flash_attention_bwd_sm90.cu takes elsewhere
// (`<16, 8>`, `<16, 6>` at 261) moved that at about 1.4 TB/s: its loads are
// issued by the consumers themselves in 16-byte pieces of eight different
// rows a warp, staggered and not overlapped, each block walks only 8 query
// tiles behind a prologue of its own, and 261-wide rows (522 bytes) took
// 2-byte copies into 6 column tiles of 64.
//
// The design:
//   * Persistent blocks.  One block an SM walks work items (b, h, 32 keys)
//     in steps of the grid, batch entries first and each item's query tiles
//     from a tile of its own (tile_of), so that the blocks running at once
//     read different lines of L2; a block loads the next item's K and V
//     and first tiles while it finishes the last one.
//   * Warp specialisation.  A producer warpgroup keeps the loads in flight:
//     its side 0 feeds the dO ring and the V rows, side 1 the Q ring and the
//     K rows.  The two consumer warpgroups split the four products by role,
//     so that every product is an N = 32 wgmma over all 32 keys (twice the
//     old N = 16: half the shared-memory reads of the A operand per FLOP):
//       warpgroup 0: S = Q K^T, P (fp32, from the lse), dV^T += dO^T P;
//       warpgroup 1: dP = dO V^T, dS = P (dP - delta), dK^T += Q^T dS;
//     each holding one transposed accumulator of NM x 16 fp32 registers a
//     thread (128 at d = 512; setmaxnreg moves the producers' registers to
//     the consumers).  P reaches warpgroup 1 in fp32 through an 8 KB
//     exchange area, so dS is formed from the same fp32 p as before; two
//     named barriers a tile (READY, FREE) hand it over.
//   * A ring of column chunks.  The Q and dO tiles (64 rows x 512 columns,
//     64 KB each at d = 512) cannot be double-buffered beside K, V and the
//     accumulators' operands.  So each ring slot holds one 64-column chunk
//     of a tile (8 KB), with a full and an empty mbarrier.  S and dP start
//     on a tile's first chunk while the rest land, and a chunk is released
//     as soon as the product that reads it last is done with it (dV^T and
//     dK^T are issued chunk by chunk, one commit group each).  At d = 512
//     9 slots fit; at 261 (5 chunks a tile) 8 to 10.
//   * TMA into wgmma's 128-byte swizzle.  One thread a side issues a TMA
//     copy a chunk (a box of 64 rows x 128 bytes) and the K and V rows (NM
//     boxes of 32 rows): whole 128-byte lines, no thread spent on copies,
//     and no proxy fence on the consumers' side.  Copies of 16-byte pieces
//     (by threads, or TMA boxes whose inner dimension is 16 bytes, which the
//     unswizzled core-matrix layout asks for) were the bound of every
//     earlier form of this kernel (PERF.md).
//   * Rows that are not 16-byte aligned (the pixel encoder's 522 bytes;
//     offset views), which TMA cannot address, are first copied into 16-byte
//     aligned rows (copy_rows_kernel; the wrapper launches it): Q and dO (1
//     MB a batch entry at the pixel encoder), read again by every key block,
//     and K and V (843 MB at batch 8), which K3 then reads from the same
//     copies.  (A bulk copy of each item's packed K and V rows, repacked by
//     the producers, ran 0.07 ms slower at the pixel encoder than TMA from
//     the copies, and left K3 to copy them again: PERF.md.)
//   * At d = 261: 5 column tiles of 64 (320 columns), not 6; S and dP
//     reduce over 272.
//   * At 513 to 704 columns (NM = 11 chunks: the multimodal encoder, 0.23
//     TFLOP, 0.23 ms at 989 TFLOP/s) the K and V rows alone take 88 KB, and
//     two rings of a whole tile each no longer fit.  The rings are made
//     unequal: the Q ring holds one tile (11 slots), since dK^T reads its
//     chunks again after dS, which needs the whole S; the dO ring takes what
//     is left (4 slots), since dP and dV^T walk its chunks in the same
//     order, and each releases a chunk as soon as its product on it is done
//     (one commit group a chunk; dV^T and dK^T two groups behind the
//     newest, so that a slot comes free a chunk before it is needed).  The
//     176 accumulator registers a thread fit because the producers keep 24
//     (setmaxnreg) and the consumers 240; P and dS are formed in place in
//     the product's fragment.  Still 32 keys
//     an item: Q and dO are read out of L2 once per 32 keys, half what the
//     16-key blocks of flash_attention_bwd_sm90.cu read there.
//   * The tensor maps, TMA loads, swizzled descriptors, ring positions,
//     named barriers, the wait of an unrolled count and the copy into
//     aligned rows are longkv.cuh's, which K1's long-KV route
//     (flash_attention_fwd_longkv_sm90.cu) shares.
//
// Shared memory is zeroed once; TMA zero-fills columns and rows past the
// tensors, and rows past Tq or kv_len hold zeros or finite stale rows whose
// p is 0.
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
constexpr int BK = 32;              // keys of a work item
constexpr int NF = BK / 2;          // registers of one m64 x 32 fp32 fragment
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int NT = 64;              // producer threads a side (two warps)
constexpr int THREADS = CONSUMERS + 2 * NT;  // and a producer warpgroup
// Registers a thread after setmaxnreg, the 64,512 that 384 threads x 168
// take at launch shared out: the consumers' accumulators take NM x 16 (128
// at NM = 8: 88 and 208; 176 at NM = 11: 24 and 240).
template <int NM>
constexpr int PRODUCER_REGS = NM > 8 ? 24 : 88;
template <int NM>
constexpr int CONSUMER_REGS = (168 * THREADS - 2 * NT * PRODUCER_REGS<NM>) / CONSUMERS;
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block may use on an H100
constexpr int MAX_WIDTH = 704;      // the widest head (11 chunks of 64; ops/flash_attention.py)
constexpr float LOG2E = 1.4426950408889634f;
// Named barriers (0 is __syncthreads): each warpgroup's own, and P handed
// from warpgroup 0 to 1 and the exchange area handed back.
constexpr int BAR_WG0 = 1, BAR_WG1 = 2, BAR_READY = 3, BAR_FREE = 4;

struct Params {
  const float* lse;        // [B, H, Tq]
  const float* delta;      // [B, H, Tq]
  const uint8_t* kv_mask;  // [B, Tk] or null
  bf16* dk;                // [B, Tk, H, D], contiguous
  bf16* dv;                // [B, Tk, H, Dv], contiguous
  int B, H, Tq, Tk, kv_len, D, Dv;
  int D16, Dv16;           // D and Dv rounded up to 16: the reductions of S and dP
  int nq, no;              // column chunks of 64 of Q and K (d), of dO and V (dv)
  int n_tiles;             // query tiles of 64: ceil(Tq / 64)
  int n_kb;                // key blocks of 32 a (batch, head)
  int items;               // n_kb * H * B
  float scale;             // softmax scale
  float scale_log2;        // softmax scale * log2(e)
  // TMA tensor maps (make_tmap): 128-byte swizzled boxes of 64 columns.
  CUtensorMap tm_q, tm_o, tm_k, tm_v;
};

// Shared memory of a block with NM column tiles of 64: the K and V rows as
// NM chunks of 32 rows, P, dS, the fp32 P exchange, and as many ring slots
// (one 128-byte swizzled chunk of 64 rows x 64 columns of Q or dO each) as
// fit, up to two tiles a ring.  Where two rings of a tile do not fit (NM =
// 11), the Q ring holds one tile and the dO ring the slots left (SHORT_O).
// Every offset is a multiple of 1024 bytes (the swizzle's repeat) from a
// 1024-byte aligned base.
template <int NM>
struct Smem {
  static constexpr int C = 64 * NM;         // columns of the K and V rows
  static constexpr int SLOT = BQ * 64 * 2;  // one ring chunk
  static constexpr int K = 0;
  static constexpr int V = K + BK * C * 2;
  static constexpr int P = V + BK * C * 2;    // bf16 P, [64 queries][32 keys]
  static constexpr int S = P + BQ * BK * 2;   // bf16 dS, the same
  static constexpr int PF = S + BQ * BK * 2;  // fp32 P fragments, [NF][128 threads]
  static constexpr int RING = PF + NF * 128 * 4;
  // Barriers: full and empty per slot of both rings, and K's and V's pairs;
  // and 1 KB to align the base.
  static constexpr int FIXED = RING + 8 * (4 * 2 * NM + 4) + 1024;
  static constexpr int FIT = (MAX_SMEM - FIXED) / (2 * SLOT);
  static constexpr bool SHORT_O = FIT < NM;
  static constexpr int NSQ = SHORT_O ? NM : FIT < 2 * NM ? FIT : 2 * NM;
  static constexpr int NSO =
      SHORT_O ? (MAX_SMEM - RING - NSQ * SLOT - 8 * (2 * NSQ + 4) - 1024) / (SLOT + 16) : NSQ;
  static constexpr int Q = RING;
  static constexpr int O = Q + NSQ * SLOT;
  static constexpr int BAR = O + NSO * SLOT;
  static constexpr int NBAR = 2 * NSQ + 2 * NSO + 4;
  static constexpr int SIZE = BAR + 8 * NBAR + 1024;  // with the alignment pad
  static_assert(NSQ >= NM && NSO >= 2, "a tile's Q chunks must fit the Q ring");
  static_assert(SIZE <= MAX_SMEM, "K2 long-KV tiles exceed shared memory");
  static_assert(V % 1024 == 0 && RING % 1024 == 0, "swizzle atoms");
};

// The query tile walked w-th (of n) by the item of key block kb: each item
// starts at its own tile, so that the blocks running at once read
// different tiles (and, items taken batch first, different batch entries)
// rather than all the same lines of L2 at the same time.
__device__ __forceinline__ int tile_of(int w, int kb, int n) { return (w + kb) % n; }

template <int NM>
__device__ __forceinline__ void consume(const Params& p, char* smem, int wg);

// ---------------------------------------------------------------------------
// The kernel.  NM column tiles of 64; two consumer warpgroups and one
// producer warpgroup, whose two sides (two warps each; one thread issues)
// feed dO and V (side 0) and Q and K (side 1).

template <int NM>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_longkv_kernel(const __grid_constant__ Params p) {
  using L = Smem<NM>;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty_q = full_q + L::NSQ;
  uint64_t* full_o = empty_q + L::NSQ;
  uint64_t* empty_o = full_o + L::NSO;
  uint64_t* full_k = empty_o + L::NSO;
  uint64_t* empty_k = full_k + 1;
  uint64_t* full_v = empty_k + 1;
  uint64_t* empty_v = full_v + 1;

  const int tid = threadIdx.x;
  // Zero everything once: the pad rows and columns of the tiles stay
  // finite (TMA zero-fills what lies past the tensors).
  for (int i = tid; i < L::BAR / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  sm90::fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < L::NSQ; ++s) {
      sm90::mbar_init(&full_q[s], 1);  // one TMA copy, its bytes counted
      sm90::mbar_init(&empty_q[s], 8);
    }
    for (int s = 0; s < L::NSO; ++s) {
      sm90::mbar_init(&full_o[s], 1);
      sm90::mbar_init(&empty_o[s], 8);
    }
    // A K or V tile: the TMA copies of its chunks.
    sm90::mbar_init(full_k, 1);
    sm90::mbar_init(empty_k, 4);
    sm90::mbar_init(full_v, 1);
    sm90::mbar_init(empty_v, 4);
  }
  __syncthreads();

  // Warp-uniform roles (read from lane 0, so that ptxas sees them as such
  // and does not serialise the wgmma): 0, 1 the consumer warpgroups, 2 the
  // producers.
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS<NM>));
    consume<NM>(p, smem, role);
    return;
  }
  // The producers give registers to the consumers (384 threads leave 168
  // a thread; the consumers' accumulators alone take 128 at d = 512).
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS<NM>));
  const int side = __shfl_sync(0xffffffffu, (tid - CONSUMERS) / NT, 0);
  const int pt = (tid - CONSUMERS) % NT;
  const int nch = side ? p.nq : p.no;
  const int ns = side ? L::NSQ : L::NSO;
  char* ring = smem + (side ? L::Q : L::O);
  uint64_t* full = side ? full_q : full_o;
  uint64_t* empty = full + ns;
  char* res = smem + (side ? L::K : L::V);
  uint64_t* full_r = side ? full_k : full_v;
  uint64_t* empty_r = full_r + 1;
  const CUtensorMap* tm = side ? &p.tm_q : &p.tm_o;
  const CUtensorMap* tm_r = side ? &p.tm_k : &p.tm_v;
  const int BH = p.B * p.H;
  // The items this block walks, past those whose keys all lie past kv_len
  // (their dK and dV are zeros the consumers write).
  auto first_from = [&](int item) {
    while (item < p.items && (item / BH) * BK >= p.kv_len) item += gridDim.x;
    return item;
  };
  // One thread a side issues the TMA copies of an item's query tiles, chunk
  // by chunk as their slots come free: the ring's next slot s in its phase
  // ph; from the second lap on, the slot's last chunk must have been
  // released.
  int s = 0, ph = 0;
  bool lapped = false;
  auto issue_tiles = [&](int item) {
    const int bh = item % BH, kb = item / BH;
    const int h = bh % p.H, b = bh / p.H;
    for (int w = 0; w < p.n_tiles; ++w) {
      const int t = tile_of(w, kb, p.n_tiles);
      for (int c = 0; c < nch; ++c) {
        if (lapped) sm90::mbar_wait(&empty[s], ph ^ 1);
        arrive_expect_tx(&full[s], L::SLOT);
        tma_load(ring + s * L::SLOT, tm, 64 * c, h, t * BQ, b, &full[s]);
        if (++s == ns) s = 0, ph ^= 1, lapped = true;
      }
    }
  };

  if (pt != 0) return;
  int it = 0;
  for (int item = first_from(blockIdx.x); item < p.items;
       item = first_from(item + gridDim.x), ++it) {
    const int bh = item % BH, kb = item / BH;
    if (it > 0) sm90::mbar_wait(empty_r, (it - 1) & 1);
    arrive_expect_tx(full_r, nch * BK * 128);
    for (int c = 0; c < nch; ++c)
      tma_load(res + c * BK * 128, tm_r, 64 * c, bh % p.H, kb * BK, bh / p.H, full_r);
    issue_tiles(item);
  }
}

// A consumer warpgroup (wg 0 or 1) of the kernel above.
template <int NM>
__device__ __forceinline__ void consume(const Params& p, char* smem, const int wg) {
  using L = Smem<NM>;
  // Commit groups of dV^T or dK^T left in flight before a chunk is
  // released: a whole tile's when both rings hold a tile, else two fewer
  // than the dO ring's slots, so that a slot is released a chunk before
  // the chunk it waits for is needed (one fewer, the most the ring allows,
  // ran 11% slower on an H100: PERF.md).
  constexpr int LAG = L::SHORT_O ? L::NSO - 2 : NM;
  char* sK = smem + L::K;
  char* sV = smem + L::V;
  char* sP = smem + L::P;
  char* sS = smem + L::S;
  float* sPF = reinterpret_cast<float*>(smem + L::PF);
  char* sQ = smem + L::Q;
  char* sO = smem + L::O;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty_q = full_q + L::NSQ;
  uint64_t* full_o = empty_q + L::NSQ;
  uint64_t* empty_o = full_o + L::NSO;
  uint64_t* full_k = empty_o + L::NSO;
  uint64_t* empty_k = full_k + 1;
  uint64_t* full_v = empty_k + 1;
  uint64_t* empty_v = full_v + 1;
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row_lo = 16 * warp + (lane >> 2);  // S/dP rows row_lo, row_lo + 8
  const int t128 = tid & 127;

  // K-major A (a Q or dO chunk) and B (K or V rows) of S and dP, and
  // MN-major A (a chunk) of dV^T and dK^T, all 128-byte swizzled: the K and
  // V rows are NM chunks of 32 rows (4096 bytes apart), a k16 step moves 32
  // bytes on, 16 query rows 2048; B of dV^T and dK^T (P or dS, written by
  // the warpgroups) in sm90.cuh's core-matrix layout, MN-major.
  const uint64_t desc_k = make_desc_sw128(sK);
  const uint64_t desc_v = make_desc_sw128(sV);
  const uint64_t desc_ring_k = make_desc_sw128(wg ? sO : sQ);
  const uint64_t desc_ring_t = make_desc_sw128(wg ? sQ : sO);
  const uint64_t desc_ps = sm90::make_desc(sm90::smem_addr(wg ? sS : sP), 16 * BK, 128);
  constexpr uint32_t K_STEP = 32;         // bytes a k16 step of S or dP moves on
  constexpr uint32_t RES_CHUNK = BK * 128;  // bytes a 64-column chunk of K or V
  constexpr uint32_t Q_STEP = 2048;       // bytes 16 query rows of a chunk
  // Chunks of this warpgroup's first product (S: Q, dP: dO) and of its
  // accumulated one (dV^T: dO, dK^T: Q), their rings' slots and barriers.
  const int n_first = wg ? p.no : p.nq;
  const int n_acc = wg ? p.nq : p.no;
  const int ns_first = wg ? L::NSO : L::NSQ;
  const int ns_acc = wg ? L::NSQ : L::NSO;
  const int red16 = (wg ? p.Dv16 : p.D16) / 16;  // 16-column steps of S's or dP's reduction
  uint64_t* full_first = wg ? full_o : full_q;
  uint64_t* empty_first = wg ? empty_o : empty_q;
  uint64_t* full_acc = wg ? full_q : full_o;
  uint64_t* empty_acc = wg ? empty_q : empty_o;
  const uint64_t desc_res = wg ? desc_v : desc_k;
  // dP releases each dO chunk as soon as its product is done where the dO
  // ring is shorter than a tile.
  const bool step_release = L::SHORT_O && wg == 1;

  float acc[NM][NF];  // dV^T (warpgroup 0) or dK^T (1): column 64 j + row, key of the fragment
#pragma unroll
  for (int j = 0; j < NM; ++j)
#pragma unroll
    for (int i = 0; i < NF; ++i) acc[j][i] = 0.f;

  // The rings' next chunks, kept as running counters: slot and phase of
  // the first product's and of the accumulated one's.
  int fs = 0, fph = 0, as = 0, aph = 0;
  int it = 0;      // items walked
  int tiles = 0;   // tiles walked, over all items
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int bh = item % (p.B * p.H);
    const int kb = item / (p.B * p.H);
    const int h = bh % p.H, b = bh / p.H;
    const int k0 = kb * BK;
    if (k0 < p.kv_len) {
      // This thread's keys: bit i for fragment register i.
      uint32_t valid = 0;
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < NF; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const bool ok = key < p.kv_len &&
                          (p.kv_mask == nullptr || p.kv_mask[(long long)b * p.Tk + key] != 0);
          valid |= (uint32_t)ok << i;
        }
      }
      sm90::mbar_wait(wg ? full_v : full_k, it & 1);
      const float* row_g = (wg ? p.delta : p.lse) + (long long)bh * p.Tq;
      for (int w = 0; w < p.n_tiles; ++w) {
        const int t = tile_of(w, kb, p.n_tiles);
        // lse (warpgroup 0) or delta (1) of this thread's two rows.
        float rowv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = t * BQ + row_lo + 8 * r;
          rowv[r] = i < p.Tq ? row_g[i] * (wg ? 1.f : LOG2E) : (wg ? 0.f : INFINITY);
        }

        // S = Q K^T (0) or dP = dO V^T (1), chunk by chunk as they land.
        float f[NF];
        const int fs0 = fs;
        int prev = fs;
        sm90::wgmma_fence();
        for (int c = 0; c < n_first; ++c) {
          sm90::mbar_wait(&full_first[fs], fph);  // TMA: no proxy fence
          const int steps = min(4, red16 - 4 * c);
          for (int ks = 0; ks < steps; ++ks)
            sm90::wgmma_m64k16<BK, 0, 0>(
                f, sm90::desc_add(desc_ring_k, fs * L::SLOT + ks * K_STEP),
                sm90::desc_add(desc_res, c * RES_CHUNK + ks * K_STEP), (c | ks) > 0);
          if (step_release) {
            sm90::wgmma_commit();
            if (c > 0) {
              sm90::wgmma_wait<1>();
              if (lane == 0) sm90::mbar_arrive(&empty_first[prev]);
            }
          }
          prev = fs;
          if (++fs == ns_first) fs = 0, fph ^= 1;
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operands<NF>(f);
        if (lane == 0) {
          if (step_release)
            sm90::mbar_arrive(&empty_first[prev]);
          else
            for (int c = 0; c < n_first; ++c)
              sm90::mbar_arrive(&empty_first[ring_at(fs0, c, ns_first)]);
          if (w == p.n_tiles - 1) sm90::mbar_arrive(wg ? empty_v : empty_k);
        }

        if (wg == 0) {
          // P in fp32 (to the exchange area) and rounded to bf16 (for dV^T),
          // formed in place.
#pragma unroll
          for (int i = 0; i < NF; ++i)
            f[i] = ((valid >> i) & 1) ? exp2f(f[i] * p.scale_log2 - rowv[(i >> 1) & 1]) : 0.f;
          if (tiles > 0) named_sync<BAR_FREE, CONSUMERS>();  // warpgroup 1 has read the last P
#pragma unroll
          for (int i = 0; i < NF; ++i) sPF[i * 128 + t128] = f[i];
#pragma unroll
          for (int i = 0; i < NF; i += 2) {
            const uint32_t off = sm90::cm_offset(row_lo + 8 * ((i >> 1) & 1),
                                                 8 * (i >> 2) + 2 * (lane & 3), BK);
            *reinterpret_cast<__nv_bfloat162*>(sP + off) = __floats2bfloat162_rn(f[i], f[i + 1]);
          }
          sm90::fence_proxy_async();
          named_arrive<BAR_READY, CONSUMERS>();
          sm90::warpgroup_sync<BAR_WG0>();
        } else {
          // dS = P (dP - delta), formed in place.
          named_sync<BAR_READY, CONSUMERS>();
#pragma unroll
          for (int i = 0; i < NF; ++i) f[i] = sPF[i * 128 + t128] * (f[i] - rowv[(i >> 1) & 1]);
          named_arrive<BAR_FREE, CONSUMERS>();
#pragma unroll
          for (int i = 0; i < NF; i += 2) {
            const uint32_t off = sm90::cm_offset(row_lo + 8 * ((i >> 1) & 1),
                                                 8 * (i >> 2) + 2 * (lane & 3), BK);
            *reinterpret_cast<__nv_bfloat162*>(sS + off) = __floats2bfloat162_rn(f[i], f[i + 1]);
          }
          sm90::fence_proxy_async();
          sm90::warpgroup_sync<BAR_WG1>();
        }
        ++tiles;

        // dV^T += dO^T P (0) or dK^T += Q^T dS (1) over the tile's 64 rows,
        // one commit group a column chunk, each chunk released when its
        // group is done (LAG groups behind the newest).
        int rs = as;  // the slot of the next chunk to release
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < NM; ++j) {
          if (j < n_acc) {
            sm90::mbar_wait(&full_acc[as], aph);
#pragma unroll
            for (int ks = 0; ks < BQ / 16; ++ks)
              sm90::wgmma_m64k16<BK, 1, 1>(
                  acc[j], sm90::desc_add(desc_ring_t, as * L::SLOT + ks * Q_STEP),
                  sm90::desc_add(desc_ps, ks * 32 * BK), 1);
            if (++as == ns_acc) as = 0, aph ^= 1;
          }
          sm90::wgmma_commit();
          if constexpr (LAG < NM) {
            if (j >= LAG) {
              sm90::wgmma_wait<LAG>();
              sm90::fence_operands<NF>(acc[j - LAG]);
              if (j - LAG < n_acc) {
                if (lane == 0) sm90::mbar_arrive(&empty_acc[rs]);
                if (++rs == ns_acc) rs = 0;
              }
            }
          }
        }
#pragma unroll
        for (int j = NM - LAG; j < NM; ++j) {
          wgmma_wait_n(NM - 1 - j);
          sm90::fence_operands<NF>(acc[j]);
          if (j < n_acc) {
            if (lane == 0) sm90::mbar_arrive(&empty_acc[rs]);
            if (++rs == ns_acc) rs = 0;
          }
        }
      }
      ++it;
    }

    // Every key below Tk is written, those past kv_len as exact zeros.
    bf16* out = wg ? p.dk : p.dv;
    const int width = wg ? p.D : p.Dv;
    const float mul = wg ? p.scale : 1.f;
#pragma unroll
    for (int j = 0; j < NM; ++j) {
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int col = 64 * j + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (key < p.Tk && col < width)
          out[(((long long)b * p.Tk + key) * p.H + h) * width + col] =
              __float2bfloat16_rn(acc[j][i] * mul);
        acc[j][i] = 0.f;
      }
    }
  }
  // Warpgroup 1 arrived on FREE after its last tile: match it.
  if (wg == 0 && tiles > 0) named_sync<BAR_FREE, CONSUMERS>();
}

template <int NM>
cudaError_t launch(const Params& p, int blocks, cudaStream_t stream) {
  constexpr int smem = Smem<NM>::SIZE;
  auto kernel = flash_bwd_dkv_longkv_kernel<NM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3 (dQ).
//
// What bounds it on an H100.  Per (query, key) pair K3 does 4 d + 2 dv FLOP:
// 0.63 TFLOP at (B, Tq, Tk) = (8, 512, 50,176) and d = dv = 512, 0.64 ms at
// 989 TFLOP/s (0.33 ms at 261).  Each query tile walks all of its batch
// entry's keys, so K and V stream out of L2 once per tile of 64 rows (6.6 GB
// at 512); HBM sees them once (0.82 GB, 0.25 ms).  The wgmma kernel of
// flash_attention_bwd_sm90.cu took 4.77 ms there (5.49 at 261): its
// consumers issued every load themselves, 2 bytes at a time at 261, and
// waited for K(t + 1) behind dQ(t).
//
// The design:
//   * A block holds 64 query rows: their Q and dO tiles stay resident (64 KB
//     each at d = 512, as 64-column chunks in wgmma's 128-byte swizzle), and
//     it walks its key split in steps of 32 keys.  The keys are split so
//     that all blocks run in one wave (2 splits of 64 tiles at batch 8: 128
//     blocks); each split writes fp32 partials.
//   * A producer warpgroup keeps K and V in flight by TMA, as chunks of 32
//     keys x 64 columns in two rings (K's and V's) that share what shared
//     memory is left (11 and 10 slots at 512, 17 and 16 at 261).  A K chunk
//     is read twice, by S = Q K^T and as B of dQ += dS K, so it is released
//     only after dQ; a V chunk after dP.  Lane c of each warp releases chunk
//     c; the rings' positions are running counters.
//   * Warpgroup 0 forms S = Q K^T and P, warpgroup 1 dP = dO V^T and dS, each
//     an N = 32 product over the step's keys; P crosses in fp32 (8 KB) and dS
//     comes back as bf16 pairs already in wgmma's register-A layout (4 KB),
//     each behind a pair of named barriers.  Then each warpgroup accumulates
//     dQ over half of the 64-column chunks (128 fp32 registers a thread at
//     512; setmaxnreg gives the consumers 224), dS from registers, K read
//     MN-major from the ring.
//   * Rows that are not 16-byte aligned (the pixel encoder's 522 bytes) are
//     read from K2's copies in aligned rows (copy_rows_kernel; K3 makes them
//     itself when K2 did not run first).  Every query tile re-reads K and V,
//     so a per-block repack would run 8 times a batch entry.
//   * Each block loads its own chunks.  Pairs of query tiles in a cluster,
//     each chunk multicast to both, halved the reads out of L2 but ran ~2%
//     slower on an H100, each block waiting on the other's releases, while
//     L2 was not the bound (PERF.md).
//   * At 513 to 704 columns (NM = 11: the multimodal encoder, 784 latents
//     over 52,097 keys; 0.17 TFLOP, 0.17 ms at 989 TFLOP/s) the resident Q
//     and dO tiles take 176 KB, which leaves 9 slots of 32 keys where K and
//     V each need 11.  So a block walks its keys in steps of 16: a ring
//     chunk is 16 keys x 64 columns (2 KB), S and dP are N = 16 products,
//     the P and dS exchanges are halved, and 21 slots fit.  The K ring holds
//     a step and 4 more (15), the V ring 6, each V chunk released as soon
//     as dP's product on it is done (one commit group a chunk).  S and dP
//     are still formed once a step, with no split of the dQ columns (the
//     wgmma kernel's two chunks of 352 formed them twice); dQ's 11 chunks
//     are shared 6 / 5 by the warpgroups (192 registers a thread: the
//     producers keep 24, the consumers 240).

struct DqParams {
  const float* lse;        // [B, H, Tq]
  const float* delta;      // [B, H, Tq]
  const uint8_t* kv_mask;  // [B, Tk] or null
  bf16* dq;                // [B, Tq, H, D], contiguous (one split)
  float* part_q;           // [S, B, Tq, H, D] fp32 (splits > 1)
  int B, H, Tq, Tk, kv_len, D, Dv;
  int D16, Dv16;           // D and Dv rounded up to 16: the reductions of S and dP
  int nq, no;              // column chunks of 64 of Q and K (d), of dO and V (dv)
  int n_tiles;             // query tiles of 64: ceil(Tq / 64)
  int tiles_per_split;     // split s: keys [s, s + 1) * tiles_per_split * 64
  int splits;
  float scale;             // softmax scale
  float scale_log2;        // softmax scale * log2(e)
  // Boxes of 64 columns x 64 (Q, dO) or a step's keys (K, V: DqSmem::BKS) rows.
  CUtensorMap tm_q, tm_o, tm_k, tm_v;
};

constexpr int DQ_SPLIT_T = 64;  // keys a tile of the split plan (ops/flash_attention.py BLOCK_K)
// Registers after setmaxnreg: the producers keep 56 (TMA issue loops), the
// consumers take the rest of the 64,512 (224 a thread): dQ's accumulators
// are NM / 2 x 32 (128 at d = 512); at NM = 11, 24 and 240 (192 of them
// dQ's).
template <int NM>
constexpr int DQ_PRODUCER_REGS = NM > 8 ? 24 : 56;
template <int NM>
constexpr int DQ_CONSUMER_REGS = (168 * THREADS - 2 * NT * DQ_PRODUCER_REGS<NM>) / CONSUMERS;
// Named barriers of the two exchanges: P (READY, FREE as in K2) and dS.
constexpr int BAR_DS_READY = 5, BAR_DS_FREE = 6;

// Shared memory of a K3 block with NM column tiles of 64: the resident Q and
// dO tiles (NM chunks of 64 rows x 64 columns each, 128-byte swizzled), the
// fp32 P exchange, the dS exchange (bf16 pairs in wgmma's register A
// layout), and two rings of chunks of BKS keys x 64 columns, K's and V's,
// sharing what is left.  Every offset is a multiple of 1024 bytes.
template <int NM>
struct DqSmem {
  static constexpr int BKS = NM > 8 ? 16 : BK;   // keys a step
  static constexpr int NFS = BKS / 2;            // registers of one m64 x BKS fp32 fragment
  static constexpr int NAS = BKS / 4;            // registers of dS's register A, a step
  static constexpr int CH = BQ * 128;   // a resident chunk
  static constexpr int SLOT = BKS * 128; // a ring chunk
  static constexpr int Q = 0;
  static constexpr int O = Q + NM * CH;
  static constexpr int PX = O + NM * CH;         // fp32 P, [NFS][128 threads]
  static constexpr int DX = PX + NFS * 128 * 4;  // dS A fragments, [NAS][128 threads]
  static constexpr int RING = DX + NAS * 128 * 4;
  // 1 KB for the barriers and 1 KB to align the base.
  static constexpr int FIT = (MAX_SMEM - RING - 2048) / SLOT;
  // Up to 512 columns each ring holds a step (and more); wider, the K ring
  // holds a step and 4 more and the V ring the rest, each V chunk released
  // as dP is done with it (SHORT_V).
  static constexpr bool SHORT_V = FIT / 2 < NM;
  static constexpr int NSV = SHORT_V ? (FIT - NM + 2) / 2 : FIT / 2;
  static constexpr int NSK = FIT - NSV;
  static constexpr int K = RING;
  static constexpr int V = K + NSK * SLOT;
  static constexpr int BAR = V + NSV * SLOT;
  static constexpr int NBAR = 2 * NSK + 2 * NSV + 2;
  static constexpr int SIZE = BAR + 8 * NBAR + 1024;
  // A block's K chunks are held until dQ has read them: the K ring holds a
  // whole step; the V ring too unless its chunks are released one by one.
  static_assert(NSK >= NM && NSV >= (SHORT_V ? 2 : NM), "a step's chunks must fit the rings");
  static_assert(8 * NBAR <= 1024 && SIZE <= MAX_SMEM, "K3 long-KV tiles exceed shared memory");
  static_assert(O % 1024 == 0 && PX % 1024 == 0 && RING % 1024 == 0, "swizzle atoms");
};

struct DqWork {
  int b, h, bh, tile, split, k_begin, k_end, nkb;
};

template <int NM>
__device__ __forceinline__ void consume_dq(const DqParams& p, char* smem, int wg, const DqWork& w);

template <int NM>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_longkv_kernel(const __grid_constant__ DqParams p) {
  using L = DqSmem<NM>;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty_k = full_k + L::NSK;
  uint64_t* full_v = empty_k + L::NSK;
  uint64_t* empty_v = full_v + L::NSV;
  uint64_t* full_q = empty_v + L::NSV;  // Q, then dO
  uint64_t* full_o = full_q + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::NSK; ++s) {
      sm90::mbar_init(&full_k[s], 1);   // the producer, the bytes counted
      sm90::mbar_init(&empty_k[s], 8);  // every consumer warp
    }
    for (int s = 0; s < L::NSV; ++s) {
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_v[s], 4);  // warpgroup 1's warps
    }
    sm90::mbar_init(full_q, 1);
    sm90::mbar_init(full_o, 1);
  }
  __syncthreads();

  // The block's work: blocks run (split, batch x head, tile), tile fastest.
  DqWork w;
  const int x = blockIdx.x / p.n_tiles;
  w.tile = blockIdx.x % p.n_tiles;
  w.bh = x % (p.B * p.H);
  w.split = x / (p.B * p.H);
  w.h = w.bh % p.H;
  w.b = w.bh / p.H;
  w.k_begin = w.split * p.tiles_per_split * DQ_SPLIT_T;
  w.k_end = min(p.kv_len, w.k_begin + p.tiles_per_split * DQ_SPLIT_T);
  w.nkb = w.k_begin < w.k_end ? (w.k_end - w.k_begin + L::BKS - 1) / L::BKS : 0;

  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(DQ_CONSUMER_REGS<NM>));
    consume_dq<NM>(p, smem, role, w);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DQ_PRODUCER_REGS<NM>));
    // Warp 0 of the producers loads Q and the K ring, warp 1 dO and the V
    // ring, one thread each.
    const int side = __shfl_sync(0xffffffffu, (tid - CONSUMERS) >> 5, 0);
    if (side < 2 && (tid & 31) == 0) {
      const bool kside = side == 0;
      uint64_t* full_r = kside ? full_q : full_o;
      const int nch = kside ? p.nq : p.no;
      arrive_expect_tx(full_r, nch * L::CH);
      for (int c = 0; c < nch; ++c)
        tma_load(smem + (kside ? L::Q : L::O) + c * L::CH, kside ? &p.tm_q : &p.tm_o, 64 * c,
                 w.h, w.tile * BQ, w.b, full_r);
      char* ring = smem + (kside ? L::K : L::V);
      uint64_t* full = kside ? full_k : full_v;
      uint64_t* empty = kside ? empty_k : empty_v;
      const int ns = kside ? L::NSK : L::NSV;
      const CUtensorMap* tm = kside ? &p.tm_k : &p.tm_v;
      // Chunk g of the walk goes to slot s in its phase ph; from the second
      // lap on, the slot's last chunk must have been released.
      int s = 0, ph = 0, g = 0;
      for (int kb = 0; kb < w.nkb; ++kb) {
        for (int c = 0; c < nch; ++c, ++g) {
          if (g >= ns) sm90::mbar_wait(&empty[s], ph ^ 1);
          arrive_expect_tx(&full[s], L::SLOT);
          tma_load(ring + s * L::SLOT, tm, 64 * c, w.h, w.k_begin + kb * L::BKS, w.b, &full[s]);
          if (++s == ns) s = 0, ph ^= 1;
        }
      }
    }
    __syncwarp();
  }
}

// A consumer warpgroup of K3: 0 forms S = Q K^T and P, 1 dP = dO V^T and dS
// (each an N = BKS product over the step's keys, P handed over in fp32),
// then each accumulates dQ += dS K over its half of the column chunks, dS
// from registers (wgmma's register A), K read MN-major from the ring.
template <int NM>
__device__ __forceinline__ void consume_dq(const DqParams& p, char* smem, const int wg,
                                           const DqWork& w) {
  using L = DqSmem<NM>;
  constexpr int BKS = L::BKS, NFS = L::NFS, NAS = L::NAS;
  constexpr int NA = (NM + 1) / 2;  // dQ column chunks a warpgroup holds at most
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty_k = full_k + L::NSK;
  uint64_t* full_v = empty_k + L::NSK;
  uint64_t* empty_v = full_v + L::NSV;
  uint64_t* full_q = empty_v + L::NSV;
  uint64_t* full_o = full_q + 1;
  float* sPX = reinterpret_cast<float*>(smem + L::PX);
  uint32_t* sDX = reinterpret_cast<uint32_t*>(smem + L::DX);
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t128 = tid & 127;
  const int row_lo = 16 * warp + (lane >> 2);  // fragment rows row_lo, row_lo + 8

  // This warpgroup's first product (S: Q and the K ring; dP: dO and the V
  // ring) and its dQ column chunks [c0, c0 + ncw).
  const int n_first = wg ? p.no : p.nq;
  const int red16 = (wg ? p.Dv16 : p.D16) / 16;
  const int ns_first = wg ? L::NSV : L::NSK;
  uint64_t* full_first = wg ? full_v : full_k;
  const uint64_t desc_res = make_desc_sw128(smem + (wg ? L::O : L::Q));
  const uint64_t desc_first = make_desc_sw128(smem + (wg ? L::V : L::K));
  const uint64_t desc_k = make_desc_sw128(smem + L::K);
  const int half = (p.nq + 1) / 2;
  const int c0 = wg ? half : 0;
  const int ncw = wg ? p.nq - half : half;
  // dP releases each V chunk as soon as its product is done where the V
  // ring is shorter than a step.
  const bool step_release = L::SHORT_V && wg == 1;

  // lse * log2(e) (warpgroup 0) or delta (1) of this thread's two rows;
  // rows past Tq: p = 0.
  float rowv[2];
  const float* row_g = (wg ? p.delta : p.lse) + (long long)w.bh * p.Tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = w.tile * BQ + row_lo + 8 * r;
    rowv[r] = i < p.Tq ? row_g[i] * (wg ? 1.f : LOG2E) : (wg ? 0.f : INFINITY);
  }
  const uint8_t* kvm = p.kv_mask ? p.kv_mask + (long long)w.b * p.Tk : nullptr;

  float acc[NA][32];  // dQ columns 64 (c0 + j) ..: m64n64 fragments
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  // Ring positions, kept as running counters (no division in the walk):
  // this warpgroup's first-product ring (slot fs, phase fph) and the slot of
  // the step's first K chunk (ks0).  Chunk c of a step lies c slots on
  // (ring_at): a step's chunks never outnumber the K ring's slots.
  int fs = 0, fph = 0, ks0 = 0;
  sm90::mbar_wait(wg ? full_o : full_q, 0);
  for (int kb = 0; kb < w.nkb; ++kb) {
    const int k0 = w.k_begin + kb * BKS;
    const int fs0 = fs;
    int prev = fs;
    // S (0) or dP (1), chunk by chunk as they land.
    float f[NFS];
    sm90::wgmma_fence();
    for (int c = 0; c < n_first; ++c) {
      sm90::mbar_wait(&full_first[fs], fph);
      const int steps = min(4, red16 - 4 * c);
      for (int ks = 0; ks < steps; ++ks)
        sm90::wgmma_m64k16<BKS, 0, 0>(f, sm90::desc_add(desc_res, c * L::CH + ks * 32),
                                      sm90::desc_add(desc_first, fs * L::SLOT + ks * 32),
                                      (c | ks) > 0);
      if (step_release) {
        sm90::wgmma_commit();
        if (c > 0) {
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(&empty_v[prev]);
        }
      }
      prev = fs;
      if (++fs == ns_first) fs = 0, fph ^= 1;
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands<NFS>(f);

    uint32_t a[NAS];  // dS as bf16 pairs: the register A of dQ's k16 steps
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < NFS; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool ok = key < w.k_end && (kvm == nullptr || kvm[key] != 0);
        f[i] = ok ? exp2f(f[i] * p.scale_log2 - rowv[(i >> 1) & 1]) : 0.f;
      }
      if (kb > 0) named_sync<BAR_FREE, CONSUMERS>();  // warpgroup 1 has read the last P
#pragma unroll
      for (int i = 0; i < NFS; ++i) sPX[i * 128 + t128] = f[i];
      named_arrive<BAR_READY, CONSUMERS>();
      named_sync<BAR_DS_READY, CONSUMERS>();
#pragma unroll
      for (int i = 0; i < NAS; ++i) a[i] = sDX[i * 128 + t128];
      named_arrive<BAR_DS_FREE, CONSUMERS>();
    } else {
      // Lane c releases the step's V chunk c (each was released as dP was
      // done with it where the ring is short).
      if (step_release) {
        if (lane == 0) sm90::mbar_arrive(&empty_v[prev]);
      } else if (lane < p.no) {
        sm90::mbar_arrive(&empty_v[ring_at(fs0, lane, L::NSV)]);
      }
      named_sync<BAR_READY, CONSUMERS>();
#pragma unroll
      for (int i = 0; i < NFS; ++i) f[i] = sPX[i * 128 + t128] * (f[i] - rowv[(i >> 1) & 1]);
      named_arrive<BAR_FREE, CONSUMERS>();
#pragma unroll
      for (int i = 0; i < NAS; ++i) a[i] = sm90::pack_bf16x2(f[2 * i], f[2 * i + 1]);
      if (kb > 0) named_sync<BAR_DS_FREE, CONSUMERS>();  // warpgroup 0 has read the last dS
#pragma unroll
      for (int i = 0; i < NAS; ++i) sDX[i * 128 + t128] = a[i];
      named_arrive<BAR_DS_READY, CONSUMERS>();
      // The step's K chunks: warpgroup 0 waited for them before it formed
      // the P this one has read.
    }

    // dQ[:, 64 (c0 + j) ..] += dS K[:, 64 (c0 + j) ..]: K read MN-major, 16
    // keys (2048 bytes) a k16 step.
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BKS / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (j < ncw) {
          const int s = ring_at(ks0, c0 + j, L::NSK);
          sm90::wgmma_m64k16_rA<64, 1>(acc[j], a + 4 * ks,
                                       sm90::desc_add(desc_k, s * L::SLOT + ks * 2048), 1);
        }
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NA; ++j) sm90::fence_operands<32>(acc[j]);
    // Lane c releases the step's K chunk c.
    if (lane < p.nq) sm90::mbar_arrive(&empty_k[ring_at(ks0, lane, L::NSK)]);
    ks0 = ring_at(ks0, p.nq, L::NSK);
  }
  // Match the other warpgroup's last arrival (FREE from 1, DS_FREE from 0).
  if (w.nkb > 0) {
    if (wg == 0) named_sync<BAR_FREE, CONSUMERS>();
    else named_sync<BAR_DS_FREE, CONSUMERS>();
  }

  // Rows below Tq, columns below D: fp32 partials (scaled) of this split,
  // or bf16 dQ when the keys are not split.
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    if (j >= ncw) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = w.tile * BQ + row_lo + 8 * ((i >> 1) & 1);
      const int col = 64 * (c0 + j) + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (row >= p.Tq || col >= p.D) continue;
      const long long at = (((long long)w.b * p.Tq + row) * p.H + w.h) * p.D + col;
      const float v = acc[j][i] * p.scale;
      if (p.splits > 1)
        p.part_q[(long long)w.split * p.B * p.Tq * p.H * p.D + at] = v;
      else
        p.dq[at] = __float2bfloat16_rn(v);
    }
  }
}

template <int NM>
cudaError_t launch_dq(const DqParams& p, int blocks, cudaStream_t stream) {
  constexpr int smem = DqSmem<NM>::SIZE;
  auto kernel = flash_bwd_dq_longkv_kernel<NM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; the head dim of q, k, v and dout must be
// contiguous; lse and delta are [B, H, Tq] fp32; dk and dv are contiguous.
// Head widths d and dv of 1 to 704 whose wider one is above 256.  q, k, v
// and dout must have 16-byte aligned starts and strides (the wrapper copies
// those that do not into aligned rows: flash_attention_bwd_longkv_copy_rows).
// `blocks` persistent blocks (at most one an SM fits) walk the
// ceil(Tk / 32) * H * B work items.  Returns a cudaError_t (0 on success;
// invalid value for operands it does not take).
extern "C" int flash_attention_bwd_dkv_longkv_sm90(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_mask, void* dk, void* dv, int batch, int heads, int tq,
    int tk, int kv_len, int d, int dv_width, int blocks, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sb, long long o_st, long long o_sh, float scale,
    void* stream) {
  const int width = d > dv_width ? d : dv_width;
  if (d < 1 || dv_width < 1 || width <= 256 || width > MAX_WIDTH || kv_len < 0 || kv_len > tk ||
      blocks < 1 || batch < 1 || heads < 1 || tq < 1 || tk < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = batch;
  p.H = heads;
  p.Tq = tq;
  p.Tk = tk;
  p.kv_len = kv_len;
  p.D = d;
  p.Dv = dv_width;
  p.D16 = (d + 15) / 16 * 16;
  p.Dv16 = (dv_width + 15) / 16 * 16;
  p.nq = (d + 63) / 64;
  p.no = (dv_width + 63) / 64;
  p.n_tiles = (tq + BQ - 1) / BQ;
  p.n_kb = (tk + BK - 1) / BK;
  p.items = p.n_kb * heads * batch;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  if (blocks > p.items) blocks = p.items;
  const int nm = (width + 63) / 64;
  // TMA takes a start and strides that are multiples of 16 bytes (a row may
  // end anywhere: the box reads zeros past it); make_tmap refuses others.
  if (!longkv::make_tmap(&p.tm_q, q, batch, tq, heads, d, q_sb, q_st, q_sh, BQ) ||
      !longkv::make_tmap(&p.tm_o, dout, batch, tq, heads, dv_width, o_sb, o_st, o_sh, BQ) ||
      !longkv::make_tmap(&p.tm_k, k, batch, tk, heads, d, k_sb, k_st, k_sh, BK) ||
      !longkv::make_tmap(&p.tm_v, v, batch, tk, heads, dv_width, v_sb, v_st, v_sh, BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = nm <= 5   ? launch<5>(p, blocks, s)
                          : nm <= 6 ? launch<6>(p, blocks, s)
                          : nm <= 8 ? launch<8>(p, blocks, s)
                                    : launch<11>(p, blocks, s);
  return (int)err;
}

template <int NM>
int dkv_smem(int* slots_q, int* slots_o) {
  *slots_q = Smem<NM>::NSQ, *slots_o = Smem<NM>::NSO;
  return Smem<NM>::SIZE;
}

// The dynamic shared memory (bytes, the alignment pad included) of the
// kernel that flash_attention_bwd_dkv_longkv_sm90 launches when the wider
// head is `width` wide, and the slots of its Q and dO rings in *slots_q and
// *slots_o; -1 for a width it does not launch.  For reports: no launch.
extern "C" int flash_attention_bwd_longkv_smem(int width, int* slots_q, int* slots_o) {
  if (width <= 256 || width > MAX_WIDTH) return -1;
  const int nm = (width + 63) / 64;
  return nm <= 5   ? dkv_smem<5>(slots_q, slots_o)
         : nm <= 6 ? dkv_smem<6>(slots_q, slots_o)
         : nm <= 8 ? dkv_smem<8>(slots_q, slots_o)
                   : dkv_smem<11>(slots_q, slots_o);
}

// dst [B, T, H, W8] (contiguous, W8 = W rounded up to 8) = src [B, T, H, W]
// (strides in elements, the last 1, any 2-byte alignment), zeros in
// columns [W, W8): the long-KV kernels' aligned rows of q, k, v or dout.
// Returns a cudaError_t.
extern "C" int flash_attention_bwd_longkv_copy_rows(const void* src, void* dst, int batch, int t,
                                                    int heads, int w, long long sb, long long st,
                                                    long long sh, void* stream) {
  return longkv::copy_rows(src, dst, batch, t, heads, w, sb, st, sh, stream);
}

// K3 (dQ) on the long-KV route.  Strides are in elements; q, k, v and dout
// must have 16-byte aligned starts and strides (the wrapper copies those
// that do not into aligned rows: flash_attention_bwd_longkv_copy_rows) and
// a contiguous head dim; lse and delta are [B, H, Tq] fp32.  Head widths d
// and dv of 1 to 704 whose wider one is above 256.  Split s of `splits`
// walks keys [s, s + 1) * tiles_per_split * 64 (below kv_len); with splits
// > 1 it writes fp32 partials (scaled) to part_q [S, B, Tq, H, D] for
// flash_attention_bwd_sum, else bf16 dq [B, Tq, H, D] (contiguous).
// Returns a cudaError_t (0 on success; invalid value for operands it does
// not take).
extern "C" int flash_attention_bwd_dq_longkv_sm90(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_mask, void* dq, void* part_q, int batch, int heads, int tq,
    int tk, int kv_len, int d, int dv_width, int splits, int tiles_per_split, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, float scale, void* stream) {
  const int width = d > dv_width ? d : dv_width;
  if (d < 1 || dv_width < 1 || width <= 256 || width > MAX_WIDTH || kv_len < 0 || kv_len > tk ||
      batch < 1 || heads < 1 || tq < 1 || tk < 1 || splits < 1 || tiles_per_split < 0 ||
      (splits > 1 && part_q == nullptr))
    return (int)cudaErrorInvalidValue;
  DqParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.dq = static_cast<bf16*>(dq);
  p.part_q = static_cast<float*>(part_q);
  p.B = batch;
  p.H = heads;
  p.Tq = tq;
  p.Tk = tk;
  p.kv_len = kv_len;
  p.D = d;
  p.Dv = dv_width;
  p.D16 = (d + 15) / 16 * 16;
  p.Dv16 = (dv_width + 15) / 16 * 16;
  p.nq = (d + 63) / 64;
  p.no = (dv_width + 63) / 64;
  p.n_tiles = (tq + BQ - 1) / BQ;
  p.tiles_per_split = tiles_per_split;
  p.splits = splits;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const int nm = (width + 63) / 64;
  const int keys = nm <= 8 ? DqSmem<8>::BKS : DqSmem<11>::BKS;  // a step's: the K and V boxes
  if (!longkv::make_tmap(&p.tm_q, q, batch, tq, heads, d, q_sb, q_st, q_sh, BQ) ||
      !longkv::make_tmap(&p.tm_o, dout, batch, tq, heads, dv_width, o_sb, o_st, o_sh, BQ) ||
      !longkv::make_tmap(&p.tm_k, k, batch, tk, heads, d, k_sb, k_st, k_sh, keys) ||
      !longkv::make_tmap(&p.tm_v, v, batch, tk, heads, dv_width, v_sb, v_st, v_sh, keys))
    return (int)cudaErrorInvalidValue;
  const int blocks = p.n_tiles * batch * heads * splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = nm <= 5   ? launch_dq<5>(p, blocks, s)
                          : nm <= 6 ? launch_dq<6>(p, blocks, s)
                          : nm <= 8 ? launch_dq<8>(p, blocks, s)
                                    : launch_dq<11>(p, blocks, s);
  return (int)err;
}

template <int NM>
int dq_smem(int* slots_k, int* slots_v) {
  *slots_k = DqSmem<NM>::NSK, *slots_v = DqSmem<NM>::NSV;
  return DqSmem<NM>::SIZE;
}

// The dynamic shared memory (bytes, the alignment pad included) of the K3
// kernel at a wider head `width` wide, and the slots of its K and V rings;
// -1 for a width it does not launch.  For reports: no launch.
extern "C" int flash_attention_bwd_dq_longkv_smem(int width, int* slots_k, int* slots_v) {
  if (width <= 256 || width > MAX_WIDTH) return -1;
  const int nm = (width + 63) / 64;
  return nm <= 5   ? dq_smem<5>(slots_k, slots_v)
         : nm <= 6 ? dq_smem<6>(slots_k, slots_v)
         : nm <= 8 ? dq_smem<8>(slots_k, slots_v)
                   : dq_smem<11>(slots_k, slots_v);
}
