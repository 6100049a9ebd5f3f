// Flash attention forward (K1) for bf16 inputs on Hopper (sm_90a) where a
// (batch, head) has a short query range and many keys: the classification
// encoders' cross-attends, 512 latents over 50,176 pixels, one head 512 wide
// (the 1x1-conv variant) or 261 (the pixel variant), the flow encoder's,
// 2,048 latents over 182,528 pixels, one head 322 wide, and the multimodal
// encoder's, 784 latents over 52,097 keys, one head 704 wide.
//
// Replaces `_flash_kernel` (perceiverio_pytorch_tpu/ops/pallas/flash_attention.py,
// launched by `_flash_forward` through `pl.pallas_call`) at head widths of
// 257 to 512 whose walk is at most 2,048 query rows, and of 513 to 704 whose
// walk is at most 1,024 query rows, over at least 4,224 keys
// (ops/flash_attention.py `launch_plan`, route "sm90_longkv"; K2 and K3 take
// their long-KV kernels at the same shape but for at most 512 query rows at
// 257 to 512 columns; a forced split count keeps
// flash_attention_fwd_sm90.cu).  The same contract as that
// file's kernel: S = Q K^T from bf16 x bf16 with fp32 sums, the scale
// applied after the product; keys at or beyond kv_len and keys whose kv_mask
// byte is 0 get probability 0; an online softmax in base 2 (exp2 of the
// logits prescaled by scale * log2(e)) with fp32 running max m and sum l; p
// summed into l in fp32 and rounded to bf16 before P V; O summed in fp32; a
// row whose keys are all masked gives exactly 0 and lse = +inf; rows whose
// q_mask byte is 0 are written as 0; an optional lse in natural units; with
// key splits, fp32 partials (O, m, l) that flash_attention_fwd.cu's merge
// combines in split order.  No atomics: two calls give the same bits.
//
// What bounds it on an H100.  Per (query, key) pair K1 does 2 (d + dv)
// FLOP: 0.84 TFLOP at (B, Tq, Tk) = (16, 512, 50,176) and d = dv = 512,
// 0.85 ms at 989 TFLOP/s, against 1.65 GB of bf16 read once (0.49 ms at 3.35
// TB/s).  The register file bounds a block: O for 64 query rows x 512 value
// columns is 128 KB of fp32, half of an SM's registers, so a block holds 64
// query rows and every query tile streams its batch entry's K and V out of
// L2 again (13.2 GB at batch 16, 8 tiles a batch entry).  The wgmma kernel
// of flash_attention_fwd_sm90.cu (`<256, 64>`) took 5.95 ms there: its
// consumers issued every load themselves in 16-byte pieces into the
// unswizzled layout, nothing double-buffered, and S and P V of a tile ran
// back to back in both warpgroups at once.  At the multimodal encoder (0.115
// TFLOP, 0.12 ms at 989 TFLOP/s; 13 query tiles stream 1.9 GB out of L2)
// its `<176, 32>` took 1.83 ms: above 512 columns it split the value columns
// into two grid chunks of 352, each forming S again (1.5x the tensor FLOPs).
// At the flow encoder (0.481 TFLOP a batch entry, 0.49 ms at 989 TFLOP/s;
// 32 query tiles stream 7.7 GB of K and V at 322 columns, padded to 384 in
// shared memory, out of L2) the wgmma kernel took 4.39 ms at batch 1 and
// about 25 at 6 tiles.
//
// The design:
//   * Q resident.  A block holds 64 query rows: Q stays in shared memory for
//     the whole walk as 64-column chunks in wgmma's 128-byte swizzle (64 KB
//     at d = 512, 88 KB at 704), and the block walks its key split in steps
//     of 64 keys.  The wrapper splits the keys so that the blocks, one an
//     SM, fill whole waves (ops/flash_attention.py `_longkv_fwd_split_plan`:
//     1 split at batch 16, 128 blocks; 2 at 8; 4, 8, 16 at the server's
//     buckets 4, 2, 1; 10 at the multimodal encoder, 130 blocks; 4 at the
//     flow encoder, 128 blocks, and 11 at its 6 tiles, 2,112 blocks in 16
//     waves, where one wave's rule gave 1 split of 192 blocks, 1.45 waves),
//     with the merge after a split call.
//   * A producer warpgroup keeps K and V in flight by TMA (longkv.cuh), as
//     chunks of 64 keys x 64 columns (8 KB) in two rings, K's and V's, that
//     share what shared memory is left (10 and 10 slots at 512, 12 and 11 at
//     261): its warp 0 feeds Q and the K ring, warp 1 the V ring.  Lane c of
//     each consumer warp releases chunk c; the rings' positions are running
//     counters (no division in the walk, but for a constant divisor where
//     a step laps a ring).
//   * Two consumer warpgroups split the value columns (256 each at 512: 128
//     fp32 registers a thread, setmaxnreg moving the producers' registers
//     to them) and the step's keys: warpgroup w forms S = Q K^T for keys
//     [32 w, 32 w + 32) of the step (m64n32 over the whole head, 16
//     registers).  The row maxima cross through shared memory (both then
//     hold the same running max), and each warpgroup's P, rounded to bf16
//     pairs already in wgmma's register-A layout, crosses to the other (8
//     KB), each behind a named barrier; then each forms O += P V over all
//     64 keys for its value columns, P from registers (sm90.cuh
//     wgmma_m64k16_rA), V read MN-major from the ring.  The row sums are
//     kept apart and added once, at the end, in the same order by both.
//     Forming the whole S in each warpgroup instead (1.5x the tensor FLOPs,
//     no exchange, the warpgroups unsynchronised) ran 4-5% slower at 512
//     and as fast at 261 on an H100; making those warpgroups take turns
//     issuing S, 15% slower again (PERF.md).
//   * Rows that are not 16-byte aligned (the pixel encoder's 522 bytes, the
//     flow encoder's 644; offset views), which TMA cannot address, are
//     first copied into 16-byte aligned rows (longkv.cuh copy_rows; the
//     wrapper launches it).  At d = 261 the tiles are 5 column chunks (320
//     columns); S reduces over 272.  At d = 322, 6 chunks (384 columns): S
//     reduces over 336 (one k16 step in the sixth chunk), and the sixth V
//     chunk, 2 real columns, falls to warpgroup 1, whose P V then takes no
//     longer than warpgroup 0's three full chunks, so a narrower tail chunk
//     would not shorten a step.
//   * At 513 to 704 columns (NM = 11 chunks: the multimodal encoder) two
//     walls stand in the way of the design above.  Shared memory: Q resident
//     takes 88 KB, which leaves 16 slots of 8 KB where a step's K and V
//     chunks held whole would need 22.  Registers: O for 64 rows x 704
//     columns split by 64-column chunks (6 / 5) is 192 fp32 registers a
//     thread in warpgroup 0, beside S, P and the walk's state in 240.  So
//     (the WIDE_* constants):
//       - Both rings release each chunk as soon as the product on it is
//         done (one commit group a chunk): the K ring holds 6 slots, the V
//         ring the other 10, its chunks loaded in the order the two
//         warpgroups read them (0, 6, 1, 7, ...) and released WIDE_V_LAG
//         groups behind the newest, so that neither warpgroup waits on the
//         other's chunks.
//       - The O tiles stay 64 columns wide, 6 and 5 a warpgroup (the
//         producers keep 24 registers, the consumers 240, as the 704-wide
//         K2's).  They fit because P's bf16 pairs go straight to the
//         exchange area and are read back in key order (no register holds
//         a warpgroup's half twice), and the block's batch entry, head and
//         tile are worked out again for the epilogue rather than held
//         through the walk: ptxas then spills nothing.
//     The other forms (tools/longkv_forms.py; PERF.md): V in chunks of 32
//     columns (the 64-byte swizzle: a 128-byte swizzled chunk cannot be cut
//     into two N = 32 operands read MN-major), 11 O tiles of 32 a
//     warpgroup (176 registers) beside a K ring of a whole step, ran 9%
//     slower (N = 32 products, twice the TMA copies); other ring splits
//     and lags 1-5%; steps of 32 keys (S as N = 16 products, reading Q
//     twice as often) 1.7x.
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

constexpr int BQ = 64;              // query rows of a block
constexpr int STEP_K = 64;          // keys of a step (one ring chunk; Smem::BK)
constexpr int SPLIT_K = 64;         // keys a tile of the split plan (ops/flash_attention.py BLOCK_K)
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
// Registers a thread after setmaxnreg, the 64,512 that 384 threads x 168
// take at launch shared out: the producers keep 56 (TMA issue loops), the
// consumers take 224 (O: NM / 2 x 32, 128 at d = 512; S 32; P 16); at NM =
// 11, 24 and 240 (O 192 in warpgroup 0).
template <int NM>
constexpr int PRODUCER_REGS = NM > 8 ? 24 : 56;
template <int NM>
constexpr int CONSUMER_REGS = (168 * THREADS - 128 * PRODUCER_REGS<NM>) / CONSUMERS;
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block may use on an H100
constexpr int MAX_WIDTH = 704;      // the widest head (11 chunks of 64; ops/flash_attention.py)
// The form of the 513-704 column instantiation (NM = 11; the forms of
// tools/longkv_forms.py edit these lines): the K ring's slots (fewer than
// 11 are released chunk by chunk; 11, a whole step, after S), the value
// columns of a V chunk and an O tile (64: 6 / 5 tiles a warpgroup; 32: 11
// and 11), the P V commit groups left in flight before a V chunk is
// released, and the keys of a step.
constexpr int WIDE_K_SLOTS = 6;
constexpr int WIDE_V_COLS = 64;
constexpr int WIDE_V_LAG = 1;
constexpr int WIDE_STEP_KEYS = 64;  // keys of a step (32: S as N = 16 products)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// Named barriers (0 is __syncthreads) of the two consumer warpgroups: the
// row maxima (and, at the end, the row sums) posted, P posted.
constexpr int BAR_MAX = 1, BAR_P = 2;

struct Params {
  const uint8_t* kv_mask;  // [B, Tk] or null
  const uint8_t* q_mask;   // [B, Tq] or null
  bf16* out;               // [B, Tq, H, Dv], contiguous (one split)
  float* lse;              // [B, H, Tq] or null (one split)
  float* part_o;           // [S, B, H, Tq, Dv] (splits > 1)
  float* part_m;           // [S, B, H, Tq]
  float* part_l;           // [S, B, H, Tq]
  int B, H, Tq, Tk, kv_len, D, Dv;
  int red16;               // 16-column steps of S's reduction: ceil(D / 16)
  int nq;                  // column chunks of 64 of Q and K (d)
  int n_tiles;             // query tiles of 64: ceil(Tq / 64)
  int tiles_per_split;     // split s: keys [s, s + 1) * tiles_per_split * 64
  int splits;
  float scale_log2;        // softmax scale * log2(e)
  // Boxes of 64 columns (V: Smem::VC) x 64 query rows (Q) or a step's keys.
  CUtensorMap tm_q, tm_k, tm_v;
};

// Shared memory of a block with NM column chunks of 64: Q resident (NM
// chunks of 64 rows x 64 columns, 128-byte swizzled), the exchange areas of
// the row maxima and sums and of P, and two rings, K's (chunks of 64 keys x
// 64 columns) and V's (64 keys x VC columns), sharing what is left.  Every
// offset is a multiple of 1024 bytes (the swizzle's repeat) from a
// 1024-byte aligned base.
template <int NM>
struct Smem {
  static constexpr bool WIDE = NM > 8;                // the 513-704 column form
  static constexpr int VC = WIDE ? WIDE_V_COLS : 64;  // value columns of a V chunk, an O tile
  static constexpr int NA = (NM * 64 / VC + 1) / 2;   // O tiles a warpgroup holds at most
  static constexpr int BK = WIDE ? WIDE_STEP_KEYS : STEP_K;  // keys of a step
  static constexpr int NS = BK / 4;  // registers of one m64 x BK / 2 fp32 fragment (half of S)
  static constexpr int CH = BQ * 128;    // a resident chunk
  static constexpr int SLOT = BK * 128;  // a K ring chunk
  static constexpr int VSLOT = BK * VC * 2;  // a V ring chunk
  static constexpr int Q = 0;
  static constexpr int RING = NM * CH;
  // 1 KB for the barriers, 9 KB for the exchanges and 1 KB to align the base.
  static constexpr int AVAIL = MAX_SMEM - RING - 2048 - 9216;
  static constexpr int FIT = AVAIL / SLOT;
  static constexpr int NSK = WIDE ? WIDE_K_SLOTS : FIT - FIT / 2;
  // The wide V ring: an even count, half of it each warpgroup's.
  static constexpr int NSV = WIDE ? (AVAIL - NSK * SLOT) / VSLOT / 2 * 2 : FIT / 2;
  static constexpr bool K_STREAM = NSK < NM;  // K chunks released one by one
  static constexpr int LAG = WIDE ? WIDE_V_LAG : 0;
  static constexpr int K = RING;
  static constexpr int V = K + NSK * SLOT;
  static constexpr int BAR = V + NSV * VSLOT;
  static constexpr int NBAR = 2 * NSK + 2 * NSV + 1;
  static constexpr int XM = BAR + 1024;  // maxima, then sums: [2 warpgroups][64 rows] fp32 each
  static constexpr int XP = XM + 1024;   // P as bf16 pairs, [2 warpgroups][8][128 threads]
  static constexpr int SIZE = XP + 8192 + 1024;
  // Up to 512 columns a step's K chunks are held until both warpgroups' S
  // is done, its V chunks until their P V: each ring holds a whole step.
  // Wider, a K ring shorter than a step releases each chunk after the
  // product on it (two in use at once), and a warpgroup holds its V chunk
  // j and the LAG before it while the producer fills its half of the ring
  // in order.
  static_assert(WIDE ? (NSK >= 2 && LAG >= 1 && NSV / 2 >= LAG + 1 && NA <= 16)
                     : (NSK >= NM && NSV >= NM),
                "a step's chunks must fit the rings");
  static_assert(8 * NBAR <= 1024 && SIZE <= MAX_SMEM, "K1 long-KV tiles exceed shared memory");
  static_assert(RING % 1024 == 0 && V % 1024 == 0 && VSLOT % 1024 == 0, "swizzle atoms");
  static_assert(BK == 64 || (WIDE && BK == 32), "steps of 64 keys, or 32 in the wide form");
};

struct Work {
  int b, h, bh, tile, split, k_begin, k_end, nkb;
};

// The work of block `block`: blocks run (split, batch x head, tile), tile
// fastest, so that the blocks of one batch entry walk its keys together; a
// split walks its keys in steps of BK.
template <int BK>
__device__ __forceinline__ Work work_of(const Params& p, int block) {
  Work w;
  const int x = block / p.n_tiles;
  w.tile = block % p.n_tiles;
  w.bh = x % (p.B * p.H);
  w.split = x / (p.B * p.H);
  w.h = w.bh % p.H;
  w.b = w.bh / p.H;
  w.k_begin = w.split * p.tiles_per_split * SPLIT_K;
  w.k_end = min(p.kv_len, w.k_begin + p.tiles_per_split * SPLIT_K);
  w.nkb = w.k_begin < w.k_end ? (w.k_end - w.k_begin + BK - 1) / BK : 0;
  return w;
}

// blockIdx.x read again where it is needed (a volatile read, which the
// compiler does not merge with the first): the consumers work out the
// batch entry, head and tile from it where they are used, rather than
// holding them in registers through the walk.
__device__ __forceinline__ int block_id() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
  return x;
}

// A producer's ring of NS slots of BYTES each: chunk g of the walk goes to
// slot s in its phase ph; from the second lap on, the slot's last chunk
// must have been released.
template <int NS, int BYTES>
struct Ring {
  char* base;
  uint64_t* full;
  uint64_t* empty;
  int s = 0, ph = 0;
  bool lapped = false;

  // The box at (col, the step's key row) of `tm`, into the next slot.
  __device__ __forceinline__ void put(const CUtensorMap* tm, int col, const Work& w, int row) {
    if (lapped) sm90::mbar_wait(&empty[s], ph ^ 1);
    arrive_expect_tx(&full[s], BYTES);
    tma_load(base + s * BYTES, tm, col, w.h, w.k_begin + row, w.b, &full[s]);
    if (++s == NS) s = 0, ph ^= 1, lapped = true;
  }
};

template <int NM>
__device__ __forceinline__ void consume(const Params& p, char* smem, int wg, const Work& w);

template <int NM>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_longkv_kernel(const __grid_constant__ Params p) {
  using L = Smem<NM>;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty_k = full_k + L::NSK;
  uint64_t* full_v = empty_k + L::NSK;
  uint64_t* empty_v = full_v + L::NSV;
  uint64_t* full_q = empty_v + L::NSV;

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
  }
  __syncthreads();

  const Work w = work_of<L::BK>(p, blockIdx.x);

  // Warp-uniform roles (read from lane 0, so that ptxas sees them as such
  // and does not serialise the wgmma): 0, 1 the consumer warpgroups, 2 the
  // producers.
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS<NM>));
    consume<NM>(p, smem, role, w);
    return;
  }
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS<NM>));
  // Warp 0 of the producers loads Q and the K ring, warp 1 the V ring, one
  // thread each.
  const int side = __shfl_sync(0xffffffffu, (tid - CONSUMERS) >> 5, 0);
  if ((tid & 31) == 0) {
    if (side == 0) {
      arrive_expect_tx(full_q, p.nq * L::CH);
      for (int c = 0; c < p.nq; ++c)
        tma_load(smem + L::Q + c * L::CH, &p.tm_q, 64 * c, w.h, w.tile * BQ, w.b, full_q);
      Ring<L::NSK, L::SLOT> ring{smem + L::K, full_k, empty_k};
      for (int kb = 0; kb < w.nkb; ++kb)
        for (int c = 0; c < p.nq; ++c) ring.put(&p.tm_k, 64 * c, w, kb * L::BK);
    } else if (side == 1) {
      // The wide V ring takes the two warpgroups' chunks in turn: warpgroup
      // 0's chunk j, then warpgroup 1's half + j.
      const int nv = (p.Dv + L::VC - 1) / L::VC;  // V chunks a step
      const int half = L::WIDE ? (nv + 1) / 2 : nv;
      Ring<L::NSV, L::VSLOT> ring{smem + L::V, full_v, empty_v};
      for (int kb = 0; kb < w.nkb; ++kb) {
        for (int j = 0; j < half; ++j) {
          ring.put(&p.tm_v, L::VC * j, w, kb * L::BK);
          if (L::WIDE && half + j < nv) ring.put(&p.tm_v, L::VC * (half + j), w, kb * L::BK);
        }
      }
    }
  }
  __syncwarp();
}

// A consumer warpgroup: per step of 64 keys, S = Q K^T over the whole head
// for its half of the keys, the online softmax with the other warpgroup's
// row maxima, P of both halves in registers (its own, and the other's
// through shared memory), then O += P V over its own O tiles (V chunks)
// [c0, c0 + ncw).
template <int NM>
__device__ __forceinline__ void consume(const Params& p, char* smem, const int wg,
                                        const Work& w) {
  using L = Smem<NM>;
  constexpr int VC = L::VC;  // value columns of an O tile
  constexpr int NF = VC / 2;  // fp32 registers of one m64 x VC fragment
  constexpr int BK = L::BK, NS = L::NS;
  constexpr int NA = L::NA;
  constexpr int LAG = L::LAG;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty_k = full_k + L::NSK;
  uint64_t* full_v = empty_k + L::NSK;
  uint64_t* empty_v = full_v + L::NSV;
  uint64_t* full_q = empty_v + L::NSV;
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row_lo = 16 * warp + (lane >> 2);  // fragment rows row_lo, row_lo + 8
  const int t128 = tid & 127;
  float* xm = reinterpret_cast<float*>(smem + L::XM);
  uint32_t* xp = reinterpret_cast<uint32_t*>(smem + L::XP);

  const uint64_t desc_q = make_desc_sw128(smem + L::Q);
  const uint64_t desc_k = make_desc_sw128(smem + L::K);
  const uint64_t desc_v = VC == 32 ? make_desc_sw64(smem + L::V) : make_desc_sw128(smem + L::V);
  constexpr uint32_t V_STEP = 16 * VC * 2;  // bytes 16 keys of a V chunk
  const int nv = (p.Dv + VC - 1) / VC;      // V chunks a step
  const int half = (nv + 1) / 2;
  const int c0 = wg ? half : 0;
  const int ncw = wg ? nv - half : half;

  float acc[NA][NF];  // O columns VC (c0 + j) ..: m64 x VC fragments
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int i = 0; i < NF; ++i) acc[j][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // base-2 running max of rows lo, hi
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  // Ring positions as running counters: the slot of the step's first K and
  // V chunk and the phase of that slot's lap; chunk c lies c slots on.  The
  // wide rings, which a step laps, count chunks instead (kpos, vpos: slot
  // and phase by a division by a constant).
  int ks0 = 0, kph = 0, vs0 = 0, vph = 0, kpos = 0, vpos = 0;
  sm90::mbar_wait(full_q, 0);
  for (int kb = 0; kb < w.nkb; ++kb) {
    const int k0 = w.k_begin + kb * BK;
    // S = Q K^T, chunk by chunk as they land.
    float s[NS];
    sm90::wgmma_fence();
    for (int c = 0; c < p.nq; ++c) {
      int slot;
      if constexpr (L::K_STREAM) {
        slot = (kpos + c) % L::NSK;
        sm90::mbar_wait(&full_k[slot], ((kpos + c) / L::NSK) & 1);
      } else {
        const int at = ks0 + c;
        slot = at >= L::NSK ? at - L::NSK : at;
        sm90::mbar_wait(&full_k[slot], kph ^ (at >= L::NSK));  // TMA: no proxy fence
      }
      const int steps = min(4, p.red16 - 4 * c);
      for (int ks = 0; ks < steps; ++ks)
        sm90::wgmma_m64k16<BK / 2, 0, 0>(
            s, sm90::desc_add(desc_q, c * L::CH + ks * 32),
            sm90::desc_add(desc_k, slot * L::SLOT + wg * (BK / 2) * 128 + ks * 32), (c | ks) > 0);
      if constexpr (L::K_STREAM) {
        // Each K chunk released as soon as the product on it is done.
        sm90::wgmma_commit();
        if (c > 0) {
          sm90::wgmma_wait<1>();
          if (lane == 0) sm90::mbar_arrive(&empty_k[(kpos + c - 1) % L::NSK]);
        }
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands<NS>(s);
    if constexpr (L::K_STREAM) {
      if (lane == 0) sm90::mbar_arrive(&empty_k[(kpos + p.nq - 1) % L::NSK]);
      kpos += p.nq;
    } else {
      // Lane c releases the step's K chunk c.
      if (lane < p.nq) sm90::mbar_arrive(&empty_k[ring_at(ks0, lane, L::NSK)]);
      ks0 += p.nq;
      if (ks0 >= L::NSK) ks0 -= L::NSK, kph ^= 1;
    }

    // Scale (base 2), mask where a key may be masked, row maxima.
    float mx[2] = {-INFINITY, -INFINITY};
    const int kh = k0 + (BK / 2) * wg;  // this warpgroup's keys
    if (p.kv_mask == nullptr && k0 + BK <= w.k_end) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] *= p.scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
      const uint8_t* kvm =
          p.kv_mask ? p.kv_mask + (long long)work_of<BK>(p, block_id()).b * p.Tk : nullptr;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = kh + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool ok = key < w.k_end && (kvm == nullptr || kvm[key] != 0);
        s[i] = ok ? s[i] * p.scale_log2 : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
    float alpha[2], m_use[2];
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
    // P: summed in fp32, rounded to bf16 pairs, the register A of P V's
    // k16 steps over this warpgroup's keys; the other's pairs (read after
    // BAR_P) fill the other two steps.  The other warpgroup has read the
    // maxima and P of the step before by the time either passes a barrier
    // of this step, so one exchange area each suffices.
    uint32_t a[BK / 4];
    if constexpr (L::WIDE) {
      // Beside the 176 O registers, each pair goes straight to the exchange
      // area, and all of them are read back after BAR_P in key order.
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = exp2f(s[i] - m_use[r]);
        const float p1 = exp2f(s[i + 1] - m_use[r]);
        l_run[r] += p0 + p1;
        xp[(wg * (NS / 2) + (i >> 1)) * 128 + t128] = sm90::pack_bf16x2(p0, p1);
      }
      named_sync<BAR_P, CONSUMERS>();
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) a[i] = xp[i * 128 + t128];
    } else {
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
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int i = 0; i < NF; ++i) acc[j][i] *= alpha[(i >> 1) & 1];

    // O[:, VC (c0 + j) ..] += P V[:, VC (c0 + j) ..]: V read MN-major, 16
    // keys a k16 step.
    sm90::wgmma_fence();
    if constexpr (L::WIDE) {
      // This warpgroup's chunk j is the step's (2 j + wg)-th in the ring;
      // each is released when its commit group is done, LAG groups behind.
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (j < ncw) {
          const int at = vpos + 2 * j + wg;
          const int slot = at % L::NSV;
          sm90::mbar_wait(&full_v[slot], (at / L::NSV) & 1);
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks)
            sm90::wgmma_m64k16_rA<VC, 1>(acc[j], a + 4 * ks,
                                         sm90::desc_add(desc_v, slot * L::VSLOT + ks * V_STEP), 1);
        }
        sm90::wgmma_commit();
        if (j >= LAG) {
          sm90::wgmma_wait<LAG>();
          sm90::fence_operands<NF>(acc[j - LAG]);
          if (j - LAG < ncw && lane == 0)
            sm90::mbar_arrive(&empty_v[(vpos + 2 * (j - LAG) + wg) % L::NSV]);
        }
      }
#pragma unroll
      for (int j = NA - LAG; j < NA; ++j) {
        wgmma_wait_n(NA - 1 - j);
        sm90::fence_operands<NF>(acc[j]);
        if (j < ncw && lane == 0) sm90::mbar_arrive(&empty_v[(vpos + 2 * j + wg) % L::NSV]);
      }
      vpos += nv;
    } else {
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (j < ncw) {
          const int at = vs0 + c0 + j;
          const int slot = at >= L::NSV ? at - L::NSV : at;
          sm90::mbar_wait(&full_v[slot], vph ^ (at >= L::NSV));
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks)
            sm90::wgmma_m64k16_rA<VC, 1>(acc[j], a + 4 * ks,
                                         sm90::desc_add(desc_v, slot * L::VSLOT + ks * V_STEP), 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NA; ++j) sm90::fence_operands<NF>(acc[j]);
      // Lane j releases this warpgroup's V chunk c0 + j of the step.
      if (lane < ncw) sm90::mbar_arrive(&empty_v[ring_at(vs0, c0 + lane, L::NSV)]);
      vs0 += nv;
      if (vs0 >= L::NSV) vs0 -= L::NSV, vph ^= 1;
    }
  }
  // Each warpgroup's row sums over the four lanes of a row, then the two
  // added through shared memory, warpgroup 0's first, by both: both hold
  // the same m and l, warpgroup 0 writes them.
  const Work e = work_of<BK>(p, block_id());
  const long long bh = (long long)e.b * p.H + e.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if ((lane & 3) == 0) xm[128 + wg * 64 + row_lo + 8 * r] = l_run[r];
  }
  named_sync<BAR_MAX, CONSUMERS>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = e.tile * BQ + row_lo + 8 * r;
    if (i >= p.Tq) continue;
    const float l = xm[128 + row_lo + 8 * r] + xm[128 + 64 + row_lo + 8 * r];
    const bool row_writer = wg == 0 && (lane & 3) == 0;
    if (p.splits > 1) {
      const long long row = ((long long)e.split * p.B * p.H + bh) * p.Tq + i;
      float* po = p.part_o + row * p.Dv;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (j >= ncw) continue;
#pragma unroll
        for (int e = 0; e < NF; ++e) {
          const int col = VC * (c0 + j) + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
          if (((e >> 1) & 1) == r && col < p.Dv) po[col] = acc[j][e];
        }
      }
      if (row_writer) {
        p.part_m[row] = (l == 0.f) ? -INFINITY : m_run[r] * LN2;
        p.part_l[row] = l;
      }
      continue;
    }
    const bool keep = p.q_mask == nullptr || p.q_mask[(long long)e.b * p.Tq + i] != 0;
    const float inv = (keep && l > 0.f) ? 1.f / l : 0.f;
    bf16* og = p.out + ((long long)e.b * p.Tq + i) * p.H * p.Dv + (long long)e.h * p.Dv;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      if (j >= ncw) continue;
#pragma unroll
      for (int e = 0; e < NF; ++e) {
        const int col = VC * (c0 + j) + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (((e >> 1) & 1) == r && col < p.Dv) og[col] = __float2bfloat16_rn(acc[j][e] * inv);
      }
    }
    if (p.lse != nullptr && row_writer)
      p.lse[bh * p.Tq + i] = (l == 0.f) ? INFINITY : m_run[r] * LN2 + logf(l);
  }
}

// The kernel at NM column chunks, after the tensor maps of K and V (boxes of
// a step's keys, V's of its chunks' width) from k [B, Tk, H, D] and v [B,
// Tk, H, Dv] at the given strides.
template <int NM>
cudaError_t launch(Params p, const void* k, long long k_sb, long long k_st, long long k_sh,
                   const void* v, long long v_sb, long long v_st, long long v_sh, int blocks,
                   cudaStream_t stream) {
  using L = Smem<NM>;
  constexpr int smem = L::SIZE;
  if (!longkv::make_tmap(&p.tm_k, k, p.B, p.Tk, p.H, p.D, k_sb, k_st, k_sh, L::BK) ||
      !longkv::make_tmap(&p.tm_v, v, p.B, p.Tk, p.H, p.Dv, v_sb, v_st, v_sh, L::BK, L::VC))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_longkv_kernel<NM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K1 on the long-KV route.  Strides are in elements; q, k and v must have
// 16-byte aligned starts and strides (the wrapper copies those that do not
// into aligned rows: flash_attention_fwd_longkv_copy_rows) and a contiguous
// head dim.  Head widths d and dv of 1 to 704 whose wider one is above 256.
// Split s of `splits` walks keys [s, s + 1) * tiles_per_split * 64 (below
// kv_len); splits > 1 writes the partials (part_o [S, B, H, Tq, Dv], part_m,
// part_l [S, B, H, Tq]) for flash_attention_fwd_merge instead of out [B,
// Tq, H, Dv] (contiguous) and lse [B, H, Tq].  Returns a cudaError_t (0 on
// success; invalid value for operands it does not take).
extern "C" int flash_attention_fwd_longkv_sm90(
    const void* q, const void* k, const void* v, const void* kv_mask, const void* q_mask,
    void* out, void* lse, void* part_o, void* part_m, void* part_l, int batch, int heads, int tq,
    int tk, int kv_len, int d, int dv, int splits, int tiles_per_split, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale, void* stream) {
  const int width = d > dv ? d : dv;
  if (d < 1 || dv < 1 || width <= 256 || width > MAX_WIDTH || kv_len < 0 || kv_len > tk ||
      batch < 1 || heads < 1 || tq < 1 || tk < 1 || splits < 1 || tiles_per_split < 0 ||
      (splits > 1 && (part_o == nullptr || part_m == nullptr || part_l == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
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
  p.red16 = (d + 15) / 16;
  p.nq = (d + 63) / 64;
  p.n_tiles = (tq + BQ - 1) / BQ;
  p.tiles_per_split = tiles_per_split;
  p.splits = splits;
  p.scale_log2 = scale * LOG2E;
  // TMA takes a start and strides that are multiples of 16 bytes (a row may
  // end anywhere: the box reads zeros past it); make_tmap refuses others.
  if (!longkv::make_tmap(&p.tm_q, q, batch, tq, heads, d, q_sb, q_st, q_sh, BQ))
    return (int)cudaErrorInvalidValue;
  const int blocks = p.n_tiles * batch * heads * splits;
  const int nm = (width + 63) / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      nm <= 5   ? launch<5>(p, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh, blocks, s)
      : nm <= 6 ? launch<6>(p, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh, blocks, s)
      : nm <= 8 ? launch<8>(p, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh, blocks, s)
                : launch<11>(p, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh, blocks, s);
  return (int)err;
}

// dst [B, T, H, W8] (contiguous, W8 = W rounded up to 8) = src [B, T, H, W]
// (strides in elements, the last 1, any 2-byte alignment), zeros in
// columns [W, W8): the aligned rows of q, k or v.  Returns a cudaError_t.
extern "C" int flash_attention_fwd_longkv_copy_rows(const void* src, void* dst, int batch, int t,
                                                    int heads, int w, long long sb, long long st,
                                                    long long sh, void* stream) {
  return longkv::copy_rows(src, dst, batch, t, heads, w, sb, st, sh, stream);
}

// The dynamic shared memory (bytes, the alignment pad included) of the
// kernel at a wider head `width` wide, and the slots of its K and V rings;
// -1 for a width it does not launch.  For reports: no launch.
template <int NM>
int smem_of(int* slots_k, int* slots_v) {
  *slots_k = Smem<NM>::NSK, *slots_v = Smem<NM>::NSV;
  return Smem<NM>::SIZE;
}

extern "C" int flash_attention_fwd_longkv_smem(int width, int* slots_k, int* slots_v) {
  if (width <= 256 || width > MAX_WIDTH) return -1;
  const int nm = (width + 63) / 64;
  return nm <= 5   ? smem_of<5>(slots_k, slots_v)
         : nm <= 6 ? smem_of<6>(slots_k, slots_v)
         : nm <= 8 ? smem_of<8>(slots_k, slots_v)
                   : smem_of<11>(slots_k, slots_v);
}
