// The spectro-feature kernels for Hopper (sm_90a), on bf16 tensor cores
// with f32 sums, at every matmul_precision: "highest" as six bf16 passes
// per product, "bf16x3" as three, "default" as one.
//
// Replaces the TPU kernels of tpufeat/pallas/fused.py:
//   - fused.py:669 signal_features (K1/K2): the v4 hop-split body
//     _signal_kernel :401 and the v5 phase-packed body _phase_signal_kernel
//     :598, as signal_mma_kernel below (wgmma). A block stages its frames'
//     samples straight out of the signal.
//   - fused.py:353 dft_mel_log_dct (K3): the body _full_kernel :289. The
//     SAME kernel and entry point, launched over rows [R, fl] as the buffer
//     [1, R*fl] with hop = fl, with the DFT matrix without the kaldi fold.
//   - fused.py:336 mel_log_dct (K4): the body _tail_kernel :282, as
//     tail_mma_kernel below (mma.sync), which shares the split, the passes
//     and the log with the signal kernel.
//
// The function, for each frame f = buf[b, t*hop : t*hop + fl] (zeros past
// M), as the TPU computes it (fused.py:87-143, 238-250):
//   z = f @ CS, then z*z (or |X| for spectrum="magnitude"), then @ fb, then
//   the floored log, then @ dct (none for Whisper and n_mfcc = 0).
// Every product x @ W is a sum of P products of bf16 pieces of x and W,
// hi = bf16_rn(x), mid = bf16_rn(x - hi), lo = bf16_rn(x - hi - mid), taken
// in this order (kernels/signal.py PASS_ORDER):
//   hi.hi + hi.mid + mid.hi + hi.lo + mid.mid + lo.hi
// P = 6 for "highest" (XLA's f32 emulation on the TPU, fused.py:89-91),
// the first three for "bf16x3" (mid is the two-way split's lo), the first
// for "default". Each bf16 product is exact in f32 and summed in f32. The
// constants arrive split and packed (kernels/signal.py mma_blocks).
//
// The signal kernel. A block takes tiles of TM = 128 consecutive frames of
// the whole call: global frame g = b * n_frames + t, whatever utterance or
// stream it belongs to, so a streaming step of 10 frames a stream wastes
// nothing and only the call's last tile is partial. The grid is persistent
// (one block per SM walks the tiles). A block is two consumer warpgroups of
// 64 frames each and one producer thread, of a third warpgroup that gives
// its registers up with setmaxnreg.
//   1. The signal is staged once per tile. The tile's frames cover one span
//      of samples in each row of buf they touch (the dual: one or two rows;
//      a streaming step: about 13 rows of 10 frames), and the consumers copy
//      each span out of buf once (16-byte loads, eight in flight a thread),
//      zeros past M, into shared memory as the bf16 pieces the passes read
//      (hi at one pass; hi and mid at three; at six the f32 samples, split
//      into hi, mid, lo as each fragment is built, since three pieces would
//      not fit beside the ring), 16 bytes of padding after every 128 so
//      that frames a hop apart spread over the banks. Frame r of the tile
//      reads sample k at piece[base(r) + k]. Where the spans do not
//      fit (K3's rows, which do not overlap, at three and six passes, or a
//      hop far past the frame), the tile's frames are staged frame by frame
//      in windows of the depth instead, again for every chunk of z.
//   2. CS and FB stream through a ring of slots in shared memory: the
//      producer brings each slice with bulk copies (cp.async.bulk,
//      completion on a "full" mbarrier; each consumer warp frees a slot on
//      an "empty" one), so the depth loop has no block barrier. Both arrive
//      packed on the host in the 128-byte-swizzled K-major layout that wgmma
//      reads: a CS slice is 64 deep by 128 columns, an FB slice 64 of z's
//      columns deep by the slab's bands. Each slice feeds all 128 frames.
//   3. z[64, 128] of each warpgroup comes from wgmma (m64n128k16, one per
//      16-deep step and pass; m64n64k16 for a chunk of 64 columns) with A
//      from registers: fragments loaded from the staged pieces (ldmatrix
//      where every frame starts 16-byte aligned, hop % 8 == 0; scalar
//      shared loads otherwise), the depth columns at or past fl set to zero
//      (they are the next frame's samples, CS's rows there are zero, and
//      0 * Inf is NaN), against CS's pieces. Each step's P passes run in
//      the pass order into one accumulator. The steps go in groups, each
//      group's fragments built while the group before runs; no branch
//      skips a wgmma inside a group (ptxas would serialize them all).
//   4. z*z (or |X|) never leaves the registers: z's accumulator layout is
//      the A fragment layout of the mel product, so each half of the chunk
//      is squared and split there and fed as wgmma's register A operand
//      (one m64nNk16 for the slab's N = 32 MI bands) against FB's slice;
//      the mel accumulators live across the chunks.
//   5. The log, into a log-mel tile in shared memory over the staged
//      signal, then the DCT (FFMA, every term at P passes in the pass order,
//      the bands in order) or the log-mel, for the tile's valid frames.
// CS's columns are ordered in pairs (Re_k, Im_k), pair 0 holding Re_0 and
// Re_{nb-1}, so a bin's Re and Im land in the same thread of an accumulator
// and |X| is rebuilt in registers; fb's rows follow (for magnitude, pair
// k's row is fb[k] and a zero row). Columns past n_fft (to a multiple of
// 64) are zero. More than SLAB = 128 mel bands run in slabs of 128: the
// tile's whole body once per slab, the DCT summing each slab's bands into
// the output in the order of a single pass.
//
// Bits: the tile, the chunking and the order of every sum are fixed
// whatever the call's shape, with no split-K, and an MMA row depends only
// on its own A row, so a frame's features depend neither on its place in
// the tile, the batch or the call, nor on its neighbours, nor on how its
// samples were staged. A frame reads no sample past its own end.
//
// What bounds the signal kernel on an H100: tensor operations. The dual
// Whisper-80 + MFCC-13 call at B = 128 x 30 s is 3.15e11 FLOP of DFT and
// mel products, so P passes are P x 3.15e11 bf16 tensor FLOP: 1.91 ms at
// the published 989 TFLOP/s dense peak for "highest", 0.96 ms for bf16x3;
// K3 on the MFCC-13 batch's 383,744 rows is P x 1.67e11. Memory is not the
// bound: about 0.6 GB for the dual, 0.18 ms at 3.35 TB/s. The mma.sync
// design before this one stayed at a fifth of the bound because it re-read
// the frames for every chunk of z and the constants for every 64 frames
// through L2, with a block barrier per 32-deep slice (PERF.md); this one
// reads each span once, each constant slice once per 128 frames, and waits
// only on the ring's barriers. What it leaves (PERF.md): the staging, the
// mel product's drain per half and the tail run while the warpgroup's
// tensor work waits. A cluster of two sharing each slice by multicast
// halved the constants' L2 reads but ran 1.5-1.8x slower, both blocks held
// to every slot, so the design keeps one block per slice.
//
// K4's tile is 64 consecutive spectrum rows, one contiguous span of 64 * nb
// floats that one bulk copy (cp.async.bulk, completion on an mbarrier)
// brings into a ring of two or three slots; the grid is persistent (the
// blocks that fit on the card) and steps over the tiles, so the next tiles
// load while this one computes. What bounds it: bytes, 4 * nb in per row
// against 2 * P * nm * (nb + n_mfcc) tensor FLOP; 0.41 GB for the MFCC-13
// batch, 0.124 ms at 3.35 TB/s. But so few FLOP per byte leave the
// instruction slots and the latency of each tile's work as the wall
// (PERF.md), so:
// the mel product and the DCT run on the tensor cores, their B fragments
// (fb's and the DCT's pieces, packed on the host in the order the MMA
// takes them, kernels/staged.py tail_mma_constants) staged once per block
// in shared memory where they fit beside two slots; A fragments come
// straight from the staged f32 rows, split as they are built, each row
// group's two warps taking alternate 16-deep steps (the partial sums meet
// in a fixed order); the log-mel tile feeds the DCT's A fragments. A row
// reads nothing past its own end and no sum depends on R; where two 64-row
// slots do not fit (wide spectra) the tiles have 32 or 16 rows.
//
// The entry points have a plain C interface (loaded with ctypes) and return
// the CUDA error code of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // K4's block, and the signal kernel's
                               // consumer threads
constexpr int SLAB = 128;      // mel bands per pass: MMA_MEL_SLAB

// bf16 pieces of an operand at P passes: hi; hi, lo; hi, mid, lo
__host__ __device__ constexpr int pieces(int P) {
  return P == 6 ? 3 : P == 3 ? 2 : 1;
}

// The (A piece, B piece) of pass p, in the order every sum takes them:
// hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi
__host__ __device__ constexpr int a_piece(int p) {
  return p == 2 || p == 4 ? 1 : p == 5 ? 2 : 0;
}
__host__ __device__ constexpr int b_piece(int p) {
  return p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0;
}

// The DCT's pieces as f32 (hi, mid, lo; bf16x3's (hi, lo) are the first
// two, default's hi the first); unused ones are null.
struct FPieces {
  const float* p[3];
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32
// sum. Registers only, so not volatile: the compiler may schedule it
// between the fragment loads.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The NP pieces of two values, each pair packed as bf16x2: hi = bf16_rn(x),
// then bf16_rn of what is left (x - hi, then x - hi - mid), each difference
// exact in f32.
template <int NP>
__device__ __forceinline__ void split_pair(float x, float y,
                                           uint32_t (&w)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    w[i] = bits(h);
    if (i + 1 < NP) {
      const float2 f = __bfloat1622float2(h);
      x -= f.x;
      y -= f.y;
    }
  }
}

// The same for one value, the pieces as f32.
template <int NP>
__device__ __forceinline__ void split_value(float x, float (&v)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    v[i] = __bfloat162float(__float2bfloat16_rn(x));
    x -= v[i];
  }
}

// The A fragment (16 x 16, row-major) whose first element is t, in an f32
// tile of row stride ld (even; t 8-byte aligned), as NP bf16 pieces:
// a[i] is piece i's fragment.
template <int NP>
__device__ __forceinline__ void frag_f32(uint32_t (&a)[NP][4],
                                         const float* t, int ld) {
  const int lane = threadIdx.x & 31;
  const float* p = t + (lane >> 2) * ld + 2 * (lane & 3);
  const float2 v[4] = {*reinterpret_cast<const float2*>(p),
                       *reinterpret_cast<const float2*>(p + 8 * ld),
                       *reinterpret_cast<const float2*>(p + 8),
                       *reinterpret_cast<const float2*>(p + 8 * ld + 8)};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t w[NP];
    split_pair<NP>(v[r].x, v[r].y, w);
#pragma unroll
    for (int i = 0; i < NP; ++i) a[i][r] = w[i];
  }
}

__device__ __forceinline__ float log_value(float x, int log_kind,
                                           float log_floor) {
  if (log_kind == 1) return logf(fmaxf(x, log_floor));
  if (log_kind == 2) return log10f(fmaxf(x, log_floor));
  return x;
}

// The DCT (the lifter folded in) of the first `valid` rows (at most
// THREADS / 16 * DCT_ROWS) of a log-mel tile (row stride ldm) over its nms
// bands, dct rows m0 .. m0 + nms - 1, to orow[f * d_out + d], by threads
// 0 .. THREADS - 1: thread t takes column t % 16 (then + 16, ...) of rows
// t / 16, t / 16 + 16, ..., every term at P passes in the pass order, the
// bands in order. A later slab (m0 > 0) goes on from the sum stored for the
// slab before, so the bands are summed in order, as in one pass.
constexpr int DCT_ROWS = 8;

template <int P>
__device__ void dct_rows(const float* smel, int ldm, int nms, int m0,
                         const FPieces& dct, int d_out, int valid,
                         float* __restrict__ orow) {
  constexpr int NP = pieces(P);
  const int f0 = threadIdx.x / 16;
  for (int d = threadIdx.x % 16; d < d_out; d += 16) {
    float acc[DCT_ROWS];
#pragma unroll
    for (int u = 0; u < DCT_ROWS; ++u) {
      const int f = f0 + 16 * u;
      acc[u] = m0 && f < valid ? orow[f * d_out + d] : 0.0f;
    }
#pragma unroll 4
    for (int m = 0; m < nms; ++m) {
      float w[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) w[i] = __ldg(dct.p[i] + (m0 + m) * d_out + d);
#pragma unroll
      for (int u = 0; u < DCT_ROWS; ++u) {
        float x[NP];
        split_value<NP>(smel[(f0 + 16 * u) * ldm + m], x);
#pragma unroll
        for (int pass = 0; pass < P; ++pass)
          acc[u] = fmaf(x[a_piece(pass)], w[b_piece(pass)], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < DCT_ROWS; ++u) {
      const int f = f0 + 16 * u;
      if (f < valid) orow[f * d_out + d] = acc[u];
    }
  }
}

// The log-mel as it is: nms bands of the first `valid` rows to orow (row
// stride nm), a row a warp at a time, by threads 0 .. THREADS - 1.
__device__ void store_logmel(const float* smel, int ldm, int nms, int nm,
                             int valid, float* __restrict__ orow) {
  for (int f = threadIdx.x / 32; f < valid; f += THREADS / 32)
    for (int c = threadIdx.x % 32; c < nms; c += 32)
      orow[f * nm + c] = smel[f * ldm + c];
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation, visible to the bulk copies
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's generic accesses of shared memory, ordered before the
// bulk copies it starts next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the one arrival of the barrier's phase, which then also waits for
// `bytes` from the bulk copy
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the barrier's phase of this parity to complete. A phase that
// never completes (a lost copy) ends the kernel with an error after 2^32
// clocks (2-3 s) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 32)) __trap();
}

// n bytes (a multiple of 16, 16-byte aligned at both ends) from global to
// shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(n), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// K1/K3: the signal kernel
// ---------------------------------------------------------------------------

constexpr int TM = 128;          // frames per tile: kernels/signal.py
                                 // MMA_TILE_FRAMES
constexpr int CONSUMERS = 2;     // consumer warpgroups of TM / 2 frames
constexpr int SIG_THREADS = (CONSUMERS + 1) * 128;
constexpr int EMPTY_ARRIVALS = CONSUMERS * 4;  // one per consumer warp
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// the registers at launch that setmaxnreg moves between the warpgroups
constexpr int LAUNCH_REGS =
    (128 * PRODUCER_REGS + CONSUMERS * 128 * CONSUMER_REGS) / SIG_THREADS;
constexpr int NT = 128;          // DFT columns per chunk of z: MMA_COLS
constexpr int NZ = 64;           // half a chunk (a chunk of 64 columns
                                 // runs as one)
constexpr int KS = 64;           // depth of a ring slice (one swizzled
                                 // 128-byte row of bf16): MMA_DEPTH
constexpr int MEL_N = 32;        // bands per 16 accumulator registers
constexpr int HALF_BYTES = NZ * KS * 2;      // a piece of a CS half slice
constexpr int PIECE_BYTES = 2 * HALF_BYTES;  // a piece of a ring slot: 128
                                             // rows (columns or bands)
constexpr int RING_BYTES = 6 * PIECE_BYTES;  // 96 KB
constexpr int SPAN_BYTES = 128 * 1024;       // the staged signal, and the
                                             // log-mel tile over it
constexpr int META_BYTES = 2048;             // barriers, the frame table
constexpr size_t SIG_SMEM =
    1024 + RING_BYTES + SPAN_BYTES + META_BYTES;  // 1024: the alignment
constexpr int LDM = SLAB + 4;    // f32 row stride of the log-mel tile
static_assert(SIG_SMEM <= 232448, "the signal kernel's shared memory");
static_assert(sizeof(float) * TM * LDM <= SPAN_BYTES,
              "the log-mel tile fits over the staged signal");
static_assert(THREADS / 16 * DCT_ROWS == TM, "dct_rows covers the tile");

// The signal kernel's layout at P passes. The staged signal is one f32
// plane (6 passes) or one bf16 plane per piece (hi; hi, mid), PLANE slots
// each; raw sample i sits in slot(i), with 16 bytes of padding after every
// 128, so that frames a multiple of 128 bytes apart (hop 160 as f32, 64 as
// bf16) spread over the banks. CAP raw samples fit a plane.
template <int P>
struct Sig {
  static constexpr int NP = pieces(P);     // pieces of each operand
  static constexpr int STAGE = NP * PIECE_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;   // 6, 3, 2
  static constexpr int PLANE = P == 6 ? SPAN_BYTES / 4 : SPAN_BYTES / NP / 2;
  static constexpr int GROUP = P == 6 ? 32 : 64;      // raw samples per 128 B
  static constexpr int CAP = PLANE / (GROUP + 16 / (P == 6 ? 4 : 2)) * GROUP;
  // frame by frame: windows FW deep, rows FST raw samples apart
  static constexpr int FW = (CAP / TM - 8) / KS * KS;  // 384, 192, 192
  static constexpr int FST = FW + 8;
  // 16-deep steps of a batch of the mel product's fragments: what the
  // registers hold beside z and mel without spilling
  static constexpr int MS = P == 6 ? 2 : 4;
};

template <int P>
__device__ __forceinline__ int slot(int i) {
  return P == 6 ? i + 4 * (i >> 5) : i + 8 * (i >> 6);
}

struct SigArgs {
  const float* buf;
  long long M;                   // samples per row of buf
  long long total;               // frames of the call: B * n_frames
  int n_frames, hop, fl;
  const bf16* cs;                // [nc / 128][slices][NP][128 x 64]
  int nc;                        // DFT columns, 2 * n_bins - 2
  const bf16* fb;                // [slabs][nc / 64][NP][128 x 64]
  int nm, magnitude, log_kind;
  float log_floor;
  FPieces dct;                   // all null for the log-mel
  int d_out;
  float* out;                    // [total, d_out]
};

// The spans of a tile: rows b0 .. b1 of buf, the first from frame t0 on,
// each staged from its first frame's start to its last frame's end,
// rounded up to 8 samples, one after the other: L0 samples for row b0,
// Lfull for each row between, Llast for row b1.
struct TileSpan {
  long long g0, b0, b1, total;
  int valid, t0, L0, Lfull, Llast;
};

__device__ TileSpan tile_span(const SigArgs& a, long long tile) {
  TileSpan s;
  s.g0 = tile * TM;
  s.valid = static_cast<int>(min(static_cast<long long>(TM), a.total - s.g0));
  s.b0 = s.g0 / a.n_frames;
  s.t0 = static_cast<int>(s.g0 - s.b0 * a.n_frames);
  const long long gl = s.g0 + s.valid - 1;
  s.b1 = gl / a.n_frames;
  const int tl = static_cast<int>(gl - s.b1 * a.n_frames);
  const int last = s.b1 == s.b0 ? tl : a.n_frames - 1;
  s.L0 = round_up((last - s.t0) * a.hop + a.fl, 8);
  s.Lfull = s.b1 - s.b0 > 1 ? round_up((a.n_frames - 1) * a.hop + a.fl, 8)
                            : 0;   // only rows of fewer than TM frames
  s.Llast = s.b1 == s.b0 ? s.L0 : round_up(tl * a.hop + a.fl, 8);
  s.total = s.b1 == s.b0 ? s.L0
                         : s.L0 + (s.b1 - s.b0 - 1) * s.Lfull + s.Llast;
  return s;
}

// Where tile row r's frame starts in the staged spans (rows past the
// tile's frames read frame 0's samples; their outputs are not stored).
__device__ int span_base(const SigArgs& a, const TileSpan& s, int r) {
  if (r >= s.valid) return 0;
  const long long g = s.g0 + r;
  const long long b = g / a.n_frames;
  const int t = static_cast<int>(g - b * a.n_frames);
  return b == s.b0 ? (t - s.t0) * a.hop
                   : s.L0 + static_cast<int>(b - s.b0 - 1) * s.Lfull +
                         t * a.hop;
}

// Raw sample i of the staged planes: its pieces (P 1, 3), or as it is
// (P 6).
template <int P>
__device__ __forceinline__ void put_sample(unsigned char* span, int i,
                                           float x) {
  if constexpr (P == 6) {
    reinterpret_cast<float*>(span)[slot<P>(i)] = x;
  } else {
    bf16* p = reinterpret_cast<bf16*>(span) + slot<P>(i);
    const bf16 hi = __float2bfloat16_rn(x);
    p[0] = hi;
    if constexpr (P == 3)
      p[Sig<P>::PLANE] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
}

// Raw samples i and i + 1 (i even: one slot pair) of the staged planes.
template <int P>
__device__ __forceinline__ void put_pair(unsigned char* span, int i, float x,
                                         float y) {
  if constexpr (P == 6) {
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(span) + slot<P>(i)) =
        make_float2(x, y);
  } else {
    uint32_t w[pieces(P)];
    split_pair<pieces(P)>(x, y, w);
#pragma unroll
    for (int q = 0; q < pieces(P); ++q)
      *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(span) +
                                   q * Sig<P>::PLANE + slot<P>(i)) = w[q];
  }
}

constexpr int STAGE_LOADS = 8;   // 16-byte loads in flight per thread

// The tile's spans, by the consumer threads ct: each row's samples from
// its first frame's start, zeros past M. Read in the 16-byte chunks of buf
// that hold them, STAGE_LOADS a thread in flight; a chunk that reaches past
// the row's last sample is read sample by sample.
template <int P>
__device__ void stage_spans(unsigned char* span, const SigArgs& a,
                            const TileSpan& s, int ct) {
  int o = 0;
  for (long long b = s.b0; b <= s.b1; ++b) {
    const int len = b == s.b0 ? s.L0 : b == s.b1 ? s.Llast : s.Lfull;
    const long long s0 = static_cast<long long>(b == s.b0 ? s.t0 : 0) * a.hop;
    const int real = static_cast<int>(
        max(0LL, min(static_cast<long long>(len), a.M - s0)));
    const float* src = a.buf + b * a.M + s0;
    // chunk c holds the span's samples 4c - off .. 4c - off + 3
    const int off = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    const float4* chunks = reinterpret_cast<const float4*>(src - off);
    const int n4 = (len + off + 3) / 4;
    for (int c0 = 0; c0 < n4; c0 += THREADS * STAGE_LOADS) {
      float4 v[STAGE_LOADS];
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u) {
        const int c = c0 + ct + u * THREADS, first = 4 * c - off;
        if (first + 3 < real) {
          v[u] = __ldg(chunks + c);
        } else {
          float e[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            e[q] = first + q >= 0 && first + q < real ? __ldg(src + first + q)
                                                      : 0.0f;
          v[u] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE_LOADS; ++u) {
        const int first = 4 * (c0 + ct + u * THREADS) - off;
        const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        if (first >= 0 && first + 3 < len && !((o + first) & 1)) {
          put_pair<P>(span, o + first, e[0], e[1]);
          put_pair<P>(span, o + first + 2, e[2], e[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (first + q >= 0 && first + q < len)
              put_sample<P>(span, o + first + q, e[q]);
        }
      }
    }
    o += len;
  }
}

// Window w of the depth (samples w * FW .. + FW - 1 of each frame) of the
// tile's frames, frame by frame, rows FST apart, by the consumer threads
// ct: zeros at or past a frame's lim (its end, or the end of its row).
// Read four samples at a time, one 16-byte load where they are aligned and
// inside the frame, WINDOW_LOADS a thread in flight.
constexpr int WINDOW_LOADS = 4;

template <int P>
__device__ void stage_window(unsigned char* span, const SigArgs& a,
                             const long long* fsrc, const int* flim, int w,
                             int ct) {
  constexpr int FW = Sig<P>::FW, FST = Sig<P>::FST, QW = FW / 4;
  const int k0 = w * FW;
  for (int e0 = 0; e0 < TM * QW; e0 += THREADS * WINDOW_LOADS) {
    float4 v[WINDOW_LOADS];
#pragma unroll
    for (int u = 0; u < WINDOW_LOADS; ++u) {
      const int e = e0 + ct + u * THREADS, r = e / QW, k = k0 + 4 * (e - r * QW);
      const float* src = a.buf + fsrc[r] + k;
      if (e < TM * QW && k + 3 < flim[r] &&
          !(reinterpret_cast<uintptr_t>(src) & 15)) {
        v[u] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[q] = e < TM * QW && k + q < flim[r] ? __ldg(src + q) : 0.0f;
        v[u] = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < WINDOW_LOADS; ++u) {
      const int e = e0 + ct + u * THREADS, r = e / QW;
      const int i = r * FST + 4 * (e - r * QW);   // even
      if (e < TM * QW) {
        put_pair<P>(span, i, v[u].x, v[u].y);
        put_pair<P>(span, i + 2, v[u].z, v[u].w);
      }
    }
  }
}

// The A fragment of the signal for the 16-deep step at k0, as NP pieces:
// registers (row g, k0 + 2tq), (row g + 8, same), (row g, k0 + 8 + 2tq),
// (row g + 8, same), each two columns as bf16x2, of the warp's 16 rows,
// whose frames start at fb0 (row g) and fb1 (row g + 8) in the staged
// planes, or with ldmatrix at lbase (row lane % 16). Columns at or past fl
// are zeros.
template <int P>
__device__ __forceinline__ void frag_signal(uint32_t (&a)[pieces(P)][4],
                                            const unsigned char* span,
                                            int k0, int lbase, int fb0,
                                            int fb1, bool ldsm, int fl) {
  constexpr int NP = pieces(P);
  const int lane = threadIdx.x & 31, tq = lane & 3;
  if constexpr (P == 6) {
    const float* x = reinterpret_cast<const float*>(span);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + 2 * tq + 8 * (r >> 1);
      const int i = ((r & 1) ? fb1 : fb0) + k;   // k is even
      float2 v;
      if (i & 1)
        v = make_float2(x[slot<P>(i)], x[slot<P>(i + 1)]);
      else
        v = *reinterpret_cast<const float2*>(x + slot<P>(i));
      uint32_t w[NP];
      split_pair<NP>(k < fl ? v.x : 0.0f, k + 1 < fl ? v.y : 0.0f, w);
#pragma unroll
      for (int q = 0; q < NP; ++q) a[q][r] = w[q];
    }
  } else {
    if (ldsm) {
      const bf16* x = reinterpret_cast<const bf16*>(span) +
                      slot<P>(lbase + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < NP; ++q) ldsm_x4(a[q], x + q * Sig<P>::PLANE);
    } else {
      const uint16_t* x = reinterpret_cast<const uint16_t*>(span);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ((r & 1) ? fb1 : fb0) + k0 + 2 * tq + 8 * (r >> 1);
        const int i0 = slot<P>(i), i1 = slot<P>(i + 1);
#pragma unroll
        for (int q = 0; q < NP; ++q)
          a[q][r] = x[q * Sig<P>::PLANE + i0] |
                    (static_cast<uint32_t>(x[q * Sig<P>::PLANE + i1]) << 16);
      }
    }
    if (k0 + 16 > fl) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + 2 * tq + 8 * (r >> 1);
        const uint32_t keep = k >= fl ? 0u : k + 1 >= fl ? 0xFFFFu : ~0u;
#pragma unroll
        for (int q = 0; q < NP; ++q) a[q][r] &= keep;
      }
    }
  }
}

// The fragments of group n: 16-deep steps GS n .. GS n + GS - 1, those
// short of fl.
template <int P, int GS>
__device__ __forceinline__ void frag_group(uint32_t (&f)[GS][pieces(P)][4],
                                           int n, const unsigned char* span,
                                           int lbase, int fb0, int fb1,
                                           bool ldsm, int fl) {
#pragma unroll
  for (int k = 0; k < GS; ++k)
    if (16 * (GS * n + k) < fl)
      frag_signal<P>(f[k], span, 16 * (GS * n + k), lbase, fb0, fb1, ldsm,
                     fl);
}

// wgmma's shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: 8-row groups 1024 bytes apart (the stride byte offset), the
// layout type in bits 62-63. A 16-deep step within the 64-deep rows is the
// start address plus 32 bytes; 32 rows on is 4096 bytes on.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler's reads and writes of an accumulator, and the
// registers of an A fragment, on their side of the asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int S, int NP>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[S][NP][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[s][q][r])::"memory");
}

// d[R0 .. R0 + R - 1] (64 x N f32, N = 32 R: 16 registers a thread per 32
// columns, column group j of 8 at d[R0 + j / 4][4 (j % 4) ..]) += a (64 x
// 16, bf16, registers) . b (16 x N, bf16, shared memory at b, K-major,
// 128-byte swizzle)
template <int R, int R0 = 0, int T>
__device__ __forceinline__ void wgmma(float (&d)[T][16],
                                      const uint32_t (&a)[4], uint32_t b) {
  static_assert(R >= 1 && R <= 4 && R0 + R <= T, "64 x 32..128");
  if constexpr (R == 1) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[R0 + 0][0]), "+f"(d[R0 + 0][1]), "+f"(d[R0 + 0][2]),
          "+f"(d[R0 + 0][3]), "+f"(d[R0 + 0][4]), "+f"(d[R0 + 0][5]),
          "+f"(d[R0 + 0][6]), "+f"(d[R0 + 0][7]), "+f"(d[R0 + 0][8]),
          "+f"(d[R0 + 0][9]), "+f"(d[R0 + 0][10]), "+f"(d[R0 + 0][11]),
          "+f"(d[R0 + 0][12]), "+f"(d[R0 + 0][13]), "+f"(d[R0 + 0][14]),
          "+f"(d[R0 + 0][15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
          "r"(1));
  } else if constexpr (R == 2) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[R0 + 0][0]), "+f"(d[R0 + 0][1]), "+f"(d[R0 + 0][2]),
          "+f"(d[R0 + 0][3]), "+f"(d[R0 + 0][4]), "+f"(d[R0 + 0][5]),
          "+f"(d[R0 + 0][6]), "+f"(d[R0 + 0][7]), "+f"(d[R0 + 0][8]),
          "+f"(d[R0 + 0][9]), "+f"(d[R0 + 0][10]), "+f"(d[R0 + 0][11]),
          "+f"(d[R0 + 0][12]), "+f"(d[R0 + 0][13]), "+f"(d[R0 + 0][14]),
          "+f"(d[R0 + 0][15]), "+f"(d[R0 + 1][0]), "+f"(d[R0 + 1][1]),
          "+f"(d[R0 + 1][2]), "+f"(d[R0 + 1][3]), "+f"(d[R0 + 1][4]),
          "+f"(d[R0 + 1][5]), "+f"(d[R0 + 1][6]), "+f"(d[R0 + 1][7]),
          "+f"(d[R0 + 1][8]), "+f"(d[R0 + 1][9]), "+f"(d[R0 + 1][10]),
          "+f"(d[R0 + 1][11]), "+f"(d[R0 + 1][12]), "+f"(d[R0 + 1][13]),
          "+f"(d[R0 + 1][14]), "+f"(d[R0 + 1][15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
          "r"(1));
  } else if constexpr (R == 3) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[R0 + 0][0]), "+f"(d[R0 + 0][1]), "+f"(d[R0 + 0][2]),
          "+f"(d[R0 + 0][3]), "+f"(d[R0 + 0][4]), "+f"(d[R0 + 0][5]),
          "+f"(d[R0 + 0][6]), "+f"(d[R0 + 0][7]), "+f"(d[R0 + 0][8]),
          "+f"(d[R0 + 0][9]), "+f"(d[R0 + 0][10]), "+f"(d[R0 + 0][11]),
          "+f"(d[R0 + 0][12]), "+f"(d[R0 + 0][13]), "+f"(d[R0 + 0][14]),
          "+f"(d[R0 + 0][15]), "+f"(d[R0 + 1][0]), "+f"(d[R0 + 1][1]),
          "+f"(d[R0 + 1][2]), "+f"(d[R0 + 1][3]), "+f"(d[R0 + 1][4]),
          "+f"(d[R0 + 1][5]), "+f"(d[R0 + 1][6]), "+f"(d[R0 + 1][7]),
          "+f"(d[R0 + 1][8]), "+f"(d[R0 + 1][9]), "+f"(d[R0 + 1][10]),
          "+f"(d[R0 + 1][11]), "+f"(d[R0 + 1][12]), "+f"(d[R0 + 1][13]),
          "+f"(d[R0 + 1][14]), "+f"(d[R0 + 1][15]), "+f"(d[R0 + 2][0]),
          "+f"(d[R0 + 2][1]), "+f"(d[R0 + 2][2]), "+f"(d[R0 + 2][3]),
          "+f"(d[R0 + 2][4]), "+f"(d[R0 + 2][5]), "+f"(d[R0 + 2][6]),
          "+f"(d[R0 + 2][7]), "+f"(d[R0 + 2][8]), "+f"(d[R0 + 2][9]),
          "+f"(d[R0 + 2][10]), "+f"(d[R0 + 2][11]), "+f"(d[R0 + 2][12]),
          "+f"(d[R0 + 2][13]), "+f"(d[R0 + 2][14]), "+f"(d[R0 + 2][15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
          "r"(1));
  } else if constexpr (R == 4) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[R0 + 0][0]), "+f"(d[R0 + 0][1]), "+f"(d[R0 + 0][2]),
          "+f"(d[R0 + 0][3]), "+f"(d[R0 + 0][4]), "+f"(d[R0 + 0][5]),
          "+f"(d[R0 + 0][6]), "+f"(d[R0 + 0][7]), "+f"(d[R0 + 0][8]),
          "+f"(d[R0 + 0][9]), "+f"(d[R0 + 0][10]), "+f"(d[R0 + 0][11]),
          "+f"(d[R0 + 0][12]), "+f"(d[R0 + 0][13]), "+f"(d[R0 + 0][14]),
          "+f"(d[R0 + 0][15]), "+f"(d[R0 + 1][0]), "+f"(d[R0 + 1][1]),
          "+f"(d[R0 + 1][2]), "+f"(d[R0 + 1][3]), "+f"(d[R0 + 1][4]),
          "+f"(d[R0 + 1][5]), "+f"(d[R0 + 1][6]), "+f"(d[R0 + 1][7]),
          "+f"(d[R0 + 1][8]), "+f"(d[R0 + 1][9]), "+f"(d[R0 + 1][10]),
          "+f"(d[R0 + 1][11]), "+f"(d[R0 + 1][12]), "+f"(d[R0 + 1][13]),
          "+f"(d[R0 + 1][14]), "+f"(d[R0 + 1][15]), "+f"(d[R0 + 2][0]),
          "+f"(d[R0 + 2][1]), "+f"(d[R0 + 2][2]), "+f"(d[R0 + 2][3]),
          "+f"(d[R0 + 2][4]), "+f"(d[R0 + 2][5]), "+f"(d[R0 + 2][6]),
          "+f"(d[R0 + 2][7]), "+f"(d[R0 + 2][8]), "+f"(d[R0 + 2][9]),
          "+f"(d[R0 + 2][10]), "+f"(d[R0 + 2][11]), "+f"(d[R0 + 2][12]),
          "+f"(d[R0 + 2][13]), "+f"(d[R0 + 2][14]), "+f"(d[R0 + 2][15]),
          "+f"(d[R0 + 3][0]), "+f"(d[R0 + 3][1]), "+f"(d[R0 + 3][2]),
          "+f"(d[R0 + 3][3]), "+f"(d[R0 + 3][4]), "+f"(d[R0 + 3][5]),
          "+f"(d[R0 + 3][6]), "+f"(d[R0 + 3][7]), "+f"(d[R0 + 3][8]),
          "+f"(d[R0 + 3][9]), "+f"(d[R0 + 3][10]), "+f"(d[R0 + 3][11]),
          "+f"(d[R0 + 3][12]), "+f"(d[R0 + 3][13]), "+f"(d[R0 + 3][14]),
          "+f"(d[R0 + 3][15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc(b)),
          "r"(1));
  }
}

// One group of z's products, committed as one wgmma group: STEPS 16-deep
// steps from step kk0 (f's first STEPS fragments) of the chunk's NH halves
// (one wgmma of 64 NH columns), each step's P passes in the pass order,
// against the ring slot at b0 (its pieces PIECE_BYTES apart, a step 32
// bytes on).
template <int P, int NH, int STEPS, int GS>
__device__ __forceinline__ void dft_group(float (&z)[4][16],
                                          const uint32_t (&f)[GS][pieces(P)][4],
                                          uint32_t b0, int kk0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) fence_acc(z[i]);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < STEPS; ++k)
#pragma unroll
    for (int pass = 0; pass < P; ++pass)
      wgmma<2 * NH>(z, f[k][a_piece(pass)],
                    b0 + b_piece(pass) * PIECE_BYTES + ((kk0 + k) % 4) * 32);
  wgmma_commit();
}

// dft_group of `steps` (GS, or 1 for the last group of an odd count):
// whole groups on each side of the branch, since ptxas serializes wgmmas
// that a branch skips inside a group.
template <int P, int NH, int GS>
__device__ __forceinline__ void dft_steps(int steps, float (&z)[4][16],
                                          const uint32_t (&f)[GS][pieces(P)][4],
                                          uint32_t b0, int kk0) {
  static_assert(GS <= 2, "a group is one or two steps");
  if (steps == GS)
    dft_group<P, NH, GS>(z, f, b0, kk0);
  else
    dft_group<P, NH, 1>(z, f, b0, kk0);
}

// the named barrier of the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// P passes per product (6: "highest", 3: bf16x3, 1: default); MI mel
// wgmmas of 32 bands per slab.
template <int P, int MI>
__global__ void __launch_bounds__(SIG_THREADS, 1)
signal_mma_kernel(__grid_constant__ const SigArgs a) {
  using L = Sig<P>;
  constexpr int NP = L::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* span = ring + RING_BYTES;   // the signal; the log-mel
  float* smel = reinterpret_cast<float*>(span);
  uint64_t* full = reinterpret_cast<uint64_t*>(span + SPAN_BYTES);
  uint64_t* empty = full + 8;
  long long* fsrc = reinterpret_cast<long long*>(full + 16);  // [TM]
  int* flim = reinterpret_cast<int*>(fsrc + TM);              // [TM]

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], EMPTY_ARRIVALS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const long long n_tiles = (a.total + TM - 1) / TM;
  const int nc16 = round_up(a.nc, 16);
  const int chunks = (nc16 + NT - 1) / NT;
  const int slices = (a.fl + KS - 1) / KS;     // CS's 64-deep slices
  const int fb_blocks = 2 * chunks;            // FB's 64-deep blocks a slab
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  if (wg == CONSUMERS) {
    // ---- the producer: thread 0 of the last warpgroup, the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp != 0 || lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    auto next = [&]() {
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int m0 = 0; m0 < a.nm; m0 += SLAB) {
        const int mt = (min(SLAB, a.nm - m0) + MEL_N - 1) / MEL_N;
        const uint32_t fb_bytes = mt * MEL_N * KS * 2;
        for (int c = 0; c < chunks; ++c) {
          const int nh = min(2, (nc16 - c * NT + NZ - 1) / NZ);
          for (int j = 0; j < slices; ++j) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], nh * NP * HALF_BYTES);
            const bf16* src = a.cs + static_cast<size_t>(c * slices + j) *
                                         NP * (PIECE_BYTES / 2);
            for (int q = 0; q < NP; ++q)
              bulk_load(ring + stage * L::STAGE + q * PIECE_BYTES,
                        src + q * (PIECE_BYTES / 2), nh * HALF_BYTES,
                        &full[stage]);
            next();
          }
          for (int h = 0; h < nh; ++h) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], NP * fb_bytes);
            const bf16* src =
                a.fb + static_cast<size_t>((m0 / SLAB) * fb_blocks + 2 * c +
                                           h) *
                           NP * (PIECE_BYTES / 2);
            for (int q = 0; q < NP; ++q)
              bulk_load(ring + stage * L::STAGE + q * PIECE_BYTES,
                        src + q * (PIECE_BYTES / 2), fb_bytes, &full[stage]);
            next();
          }
        }
      }
    }
  } else {
    // ---- the consumers: tile rows 64 * wg .. 64 * wg + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // 16-deep steps of a group of z's fragments, built while the group
    // before runs: two, but one at six passes with the widest slab, where
    // two spill
    constexpr int GS = P == 6 && MI == 4 ? 1 : 2, GPS = 4 / GS;
    const int ct = threadIdx.x;                // 0 .. THREADS - 1
    const int g = lane / 4, tq = lane % 4;
    const int row0 = 64 * wg + 16 * warp;      // the warp's first tile row
    // the ring's next slot to take and to free: a slice is taken before
    // the one before it is freed
    int tstage = 0, rstage = 0;
    uint32_t tphase = 0;
    auto take = [&]() {
      mbar_wait(&full[tstage], tphase);
      const uint32_t at = smem_addr(ring + tstage * L::STAGE);
      if (++tstage == L::STAGES) {
        tstage = 0;
        tphase ^= 1;
      }
      return at;
    };
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[rstage]);
      if (++rstage == L::STAGES) rstage = 0;
    };
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const TileSpan s = tile_span(a, tile);
      const bool framewise = s.total + 16 > L::CAP;
      const bool ldsm = P != 6 && (framewise || a.hop % 8 == 0);
      // this thread's frame starts: rows g and g + 8 of the warp, and the
      // row it gives ldmatrix (lane % 16)
      int fb0 = 0, fb1 = 0, lbase = 0;
      if (framewise) {
        if (ct < TM) {
          long long src = 0;
          int lim = 0;
          if (ct < s.valid) {
            const long long gf = s.g0 + ct, b = gf / a.n_frames;
            const long long start = (gf - b * a.n_frames) * a.hop;
            src = b * a.M + start;
            lim = static_cast<int>(
                max(0LL, min(static_cast<long long>(a.fl), a.M - start)));
          }
          fsrc[ct] = src;
          flim[ct] = lim;
        }
        consumers_sync();
      } else {
        fb0 = span_base(a, s, row0 + g);
        fb1 = span_base(a, s, row0 + g + 8);
        lbase = span_base(a, s, row0 + (lane & 15));
      }
      for (int m0 = 0; m0 < a.nm; m0 += SLAB) {
        const int nms = min(SLAB, a.nm - m0);
        const int mt = (nms + MEL_N - 1) / MEL_N;
        float mel[MI][16];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int e = 0; e < 16; ++e) mel[i][e] = 0.0f;
        // the staged signal: the tile's spans, once a slab; or frame by
        // frame, the window holding group n's steps, staged where it is not
        // yet (-1: none)
        int staged = -1;
        if (!framewise) {
          stage_spans<P>(span, a, s, ct);
          consumers_sync();
          staged = 0;
        }
        auto restage = [&](int n) {
          const int w = n / GPS * KS / L::FW;
          if (!framewise || w == staged) return;
          if (staged >= 0) consumers_sync();    // the window is read
          stage_window<P>(span, a, fsrc, flim, w, ct);
          fb0 = (row0 + g) * L::FST - w * L::FW;
          fb1 = fb0 + 8 * L::FST;
          lbase = (row0 + (lane & 15)) * L::FST - w * L::FW;
          consumers_sync();
          staged = w;
        };
        const int groups = (a.fl + 16 * GS - 1) / (16 * GS);
        constexpr int MS = L::MS;
        for (int c = 0; c < chunks; ++c) {
          const int c0 = c * NT;
          const int nh = min(2, (nc16 - c0 + NZ - 1) / NZ);
          float z[4][16];   // half h: z[2h], z[2h + 1]
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 16; ++e) z[i][e] = 0.0f;

          // 1. z's chunk: CS's 64-deep slices against the staged signal,
          // group by group, each group's fragments built while the group
          // before it runs on the tensor cores
          uint32_t fa[2][GS][NP][4];
          uint32_t b0 = 0;
          restage(0);
          frag_group<P>(fa[0], 0, span, lbase, fb0, fb1, ldsm, a.fl);
          for (int n = 0; n < groups; n += 2) {
#pragma unroll
            for (int par = 0; par < 2; ++par) {
              // group n + par from fa[par]; then group n + par + 1 into
              // fa[par ^ 1], once the group before, which read it, is done
              const int gn = n + par;
              if (gn >= groups) break;
              if (gn % GPS == 0) b0 = take();
              const int steps = min(GS, (a.fl + 15) / 16 - GS * gn);
              if (nh == 2)
                dft_steps<P, 2>(steps, z, fa[par], b0, GS * gn);
              else
                dft_steps<P, 1>(steps, z, fa[par], b0, GS * gn);
              wgmma_wait<1>();
              fence_frags(fa[par ^ 1]);
              if (gn > 0 && (gn - 1) % GPS == GPS - 1) release();
              if (gn + 1 < groups) {
                restage(gn + 1);
                frag_group<P>(fa[par ^ 1], gn + 1, span, lbase, fb0, fb1,
                              ldsm, a.fl);
              }
            }
          }
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_acc(z[i]);
          fence_frags(fa[0]);
          fence_frags(fa[1]);
          release();                          // the last slice

          // 2. mel += (z*z or |X|) . FB: each half of the chunk as the A
          // operand straight from z's registers, MS steps a batch, against
          // the half's FB slot; z's columns past nc are zeros, and the
          // bands past the slab's are not stored, so every batch issues all
          // its steps over all 32 MI bands (a branch inside a batch would
          // serialize the wgmmas)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h >= nh) break;
            const int msteps = min(4, (nc16 - c0 - NZ * h) / 16);
            const uint32_t bm = take();
#pragma unroll
            for (int k0 = 0; k0 < 4; k0 += MS) {
              if (k0 >= msteps) break;
              uint32_t fm[MS][NP][4];
#pragma unroll
              for (int k = 0; k < MS; ++k) {
                // register r: rows g / g + 8 of z's columns 16kk + 2tq (r =
                // 0, 1), then 16kk + 8 + 2tq (r = 2, 3): accumulator pairs
                // 8kk + 2r
                const int kk = k0 + k;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const int zi = 32 * h + 8 * kk + 2 * r;
                  const float re = z[zi / 16][zi % 16];
                  const float im = z[zi / 16][zi % 16 + 1];
                  float s0, s1;
                  if (!a.magnitude) {
                    s0 = __fmul_rn(re, re);
                    s1 = __fmul_rn(im, im);
                  } else if (c0 + NZ * h + 16 * kk + 8 * (r >> 1) + 2 * tq ==
                             0) {
                    s0 = sqrtf(__fmul_rn(re, re));   // pair 0: Re_0, Re_nb-1
                    s1 = sqrtf(__fmul_rn(im, im));
                  } else {
                    s0 = sqrtf(
                        __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
                    s1 = 0.0f;
                  }
                  uint32_t x[NP];
                  split_pair<NP>(s0, s1, x);
#pragma unroll
                  for (int q = 0; q < NP; ++q) fm[k][q][r] = x[q];
                }
              }
#pragma unroll
              for (int i = 0; i < MI; ++i) fence_acc(mel[i]);
              wgmma_fence();
#pragma unroll
              for (int k = 0; k < MS; ++k)
#pragma unroll
                for (int pass = 0; pass < P; ++pass)
                  wgmma<MI>(mel, fm[k][a_piece(pass)],
                            bm + b_piece(pass) * PIECE_BYTES + (k0 + k) * 32);
              wgmma_commit();
              wgmma_wait<0>();
#pragma unroll
              for (int i = 0; i < MI; ++i) fence_acc(mel[i]);
              fence_frags(fm);
            }
            release();
          }
        }

        // 3. the log, to the log-mel tile over the staged signal
        consumers_sync();   // every warp is done with the signal
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i >= mt) break;
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int row = row0 + g + 8 * ((e >> 1) & 1);
            const int col = MEL_N * i + 8 * (e >> 2) + 2 * tq + (e & 1);
            if (col < nms)
              smel[row * LDM + col] =
                  log_value(mel[i][e], a.log_kind, a.log_floor);
          }
        }
        consumers_sync();

        // 4. the DCT or the log-mel, for the tile's valid frames
        if (a.dct.p[0] != nullptr)
          dct_rows<P>(smel, LDM, nms, m0, a.dct, a.d_out, s.valid,
                      a.out + s.g0 * a.d_out);
        else
          store_logmel(smel, LDM, nms, a.nm, s.valid,
                       a.out + s.g0 * a.nm + m0);
        consumers_sync();   // the tile is read before the signal is staged
      }
    }
  }
}


// ---------------------------------------------------------------------------
// K4: the tail kernel
// ---------------------------------------------------------------------------

constexpr int TAIL_ROWS = 64;    // rows per tile
constexpr int TAIL_SLOTS = 3;    // most tiles in the ring
constexpr size_t TAIL_HEAD = 128;  // the slots' mbarriers, at the front

// One thread: tile t's rows (the last tile's valid ones) into a slot,
// completing on its barrier. One bulk copy brings the span to its last
// 16-byte boundary; the 0-3 floats after it, which only the last tile can
// have, are copied by the thread before its arrival, so the barrier's
// phase covers them too.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ rows,
                                          long long t, int tr, int nb,
                                          long long R, uint64_t* bar) {
  const long long r0 = t * tr;
  const long long n = min(static_cast<long long>(tr), R - r0) * nb;
  const float* src = rows + r0 * nb;
  const uint32_t bulk = static_cast<uint32_t>(n * 4) & ~15u;
  for (long long i = bulk / 4; i < n; ++i) dst[i] = src[i];
  if (bulk) {
    mbar_expect_tx(bar, bulk);
    bulk_load(dst, src, bulk, bar);
  } else {
    mbar_arrive(bar);
  }
}

// The A fragment (16 x 16) of the rows at t, t + ld, ... (row stride ld
// floats, any alignment), columns k0 .. k0 + 15, as NP bf16 pieces. EDGE:
// the columns at or past kmax are zeros and are not read (they are the
// next row's, or past the slot).
template <int NP, bool EDGE>
__device__ __forceinline__ void frag_rows(uint32_t (&a)[NP][4],
                                          const float* t, int ld, int k0,
                                          int kmax) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + 2 * (lane & 3);
  const float* p = t + (lane >> 2) * ld + k;
  // (row, k), (row, k+1), (row+8, k), (row+8, k+1), then the same at k+8
  float x[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int dk = (q & 1) + (q & 4 ? 8 : 0);
    const float* pq = p + (q & 2 ? 8 * ld : 0) + dk;
    x[q] = (!EDGE || k + dk < kmax) ? *pq : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t w[NP];
    split_pair<NP>(x[2 * r], x[2 * r + 1], w);
#pragma unroll
    for (int i = 0; i < NP; ++i) a[i][r] = w[i];
  }
}

// The tail kernel's shared memory for nb bins, nm bands and a DCT of
// dct_out columns (0: none) within `budget` bytes: TAIL_ROWS rows a tile,
// fb's and the DCT's fragments staged once per block where they fit beside
// two slots (else read from device memory), and as many slots as fit, up
// to TAIL_SLOTS; tiles of 32 or 16 rows only where two slots of 64 rows do
// not fit.
struct TailPlan {
  int rows;         // rows per tile
  int slots;        // tiles in the ring (0: nothing fits)
  int ldm;          // f32 row stride of the log-mel tile, past the padding
                    // of the DCT's 16-deep steps
  size_t smel;      // bytes of the log-mel tile, a multiple of 128
  size_t consts;    // bytes of the staged fragments (0: read in place)
  size_t slot;      // bytes of a slot, a multiple of 128
  size_t bytes;     // dynamic shared memory per block
};

size_t round_up_bytes(size_t x) { return (x + 127) / 128 * 128; }

// bytes of a [k, n] matrix as B fragments at NP pieces (kernels/staged.py
// b_fragments): [ceil(k / 16)][ceil(n / 8)][NP][32 lanes] uint2
size_t frag_bytes(int k, int n, int np) {
  return static_cast<size_t>((k + 15) / 16) * ((n + 7) / 8) * np * 32 *
         sizeof(uint2);
}

TailPlan tail_plan(int passes, int nb, int nm, int dct_out, int budget) {
  const int np = pieces(passes);
  const size_t consts = round_up_bytes(
      frag_bytes(nb, nm, np) + (dct_out ? frag_bytes(nm, dct_out, np) : 0));
  TailPlan t{};
  for (int rows = TAIL_ROWS; rows >= 16; rows /= 2) {
    t.rows = rows;
    t.ldm = round_up(nm, 16) + 8;  // rows 8 or 24 banks apart
    t.smel = round_up_bytes(sizeof(float) * rows * t.ldm);
    t.slot = round_up_bytes(sizeof(float) * rows * nb);
    for (int local = 1; local >= 0; --local) {
      t.consts = local ? consts : 0;
      const long long room =
          static_cast<long long>(budget) -
          static_cast<long long>(TAIL_HEAD + t.smel + t.consts);
      t.slots = room > 0 ? static_cast<int>(std::min(
                               static_cast<long long>(TAIL_SLOTS),
                               room / static_cast<long long>(t.slot)))
                         : 0;
      t.bytes = TAIL_HEAD + t.smel + t.consts + t.slots * t.slot;
      if (t.slots >= 2 || (rows == 16 && t.slots >= 1)) return t;
    }
  }
  t.slots = 0;
  return t;
}

// K4: rows [R, nb] -> features [R, d_out]. P passes per product; MI mel
// tiles of 8 per warp and slab. Warp w takes the rows 16 (w / 2) .. + 15
// of a tile (those warps whose rows the tile has) and every other 16-deep
// step of the mel product, from step w % 2: each splits only its own A
// fragments, and the two partial sums of a row meet in the log-mel tile,
// added in a fixed order. The DCT then runs on the tensor cores, its A
// fragments from the log-mel tile (f32, split as they are built), its B
// fragments the DCT's pieces; with no DCT the log-mel is the output.
template <int P, int MI>
__global__ void __launch_bounds__(THREADS, 1)
tail_mma_kernel(const float* __restrict__ rows, long long R, int nb, int tr,
                int slots, int ldm, size_t smel_bytes, size_t const_bytes,
                size_t slot_bytes, const uint2* __restrict__ fb_frags,
                const uint2* __restrict__ dct_frags, int nm, int d_out,
                int log_kind, float log_floor, float* __restrict__ out) {
  constexpr int NP = pieces(P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // [slots]
  float* smel = reinterpret_cast<float*>(smem_raw + TAIL_HEAD);  // [tr][ldm]
  uint2* staged = reinterpret_cast<uint2*>(smem_raw + TAIL_HEAD +
                                           smel_bytes);  // fb's, the DCT's
  unsigned char* ring = smem_raw + TAIL_HEAD + smel_bytes + const_bytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp >> 1, kh = warp & 1;
  const bool mel_warp = rg * 16 < tr;
  const long long n_tiles = (R + tr - 1) / tr;
  const int nks = (nb + 15) / 16;         // 16-deep steps, the last partial
  const int nmt_all = (nm + 7) / 8;
  const int kdt = (nm + 15) / 16, ndt = (d_out + 7) / 8;
  const size_t fb_n = static_cast<size_t>(nks) * nmt_all * NP * 32;

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(bar + s, 1);
    fence_mbar_init();
  }
  // the log-mel tile starts at zero: its columns past nm stay so, the
  // padding of the DCT's last step
  for (int i = tid; i < tr * ldm; i += THREADS) smel[i] = 0.0f;
  // the fragments, staged once: the block keeps them for all its tiles
  const uint2* fbf = fb_frags;
  const uint2* dctf = dct_frags;
  if (const_bytes) {
    const size_t n =
        fb_n + (dct_frags ? static_cast<size_t>(kdt) * ndt * NP * 32 : 0);
    for (size_t i = tid; i < fb_n; i += THREADS) staged[i] = fb_frags[i];
    for (size_t i = fb_n + tid; i < n; i += THREADS)
      staged[i] = dct_frags[i - fb_n];
    fbf = staged;
    if (dct_frags) dctf = staged + fb_n;
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < slots; ++s) {
      const long long t = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (t < n_tiles)
        load_tile(reinterpret_cast<float*>(ring + s * slot_bytes), rows, t,
                  tr, nb, R, bar + s);
    }

  long long it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = static_cast<int>(it % slots);
    mbar_wait(bar + s, static_cast<uint32_t>((it / slots) & 1));
    float* slot = reinterpret_cast<float*>(ring + s * slot_bytes);
    const float* mine = slot + static_cast<size_t>(rg) * 16 * nb;
    const long long r0 = t * tr;
    const int valid = static_cast<int>(min(static_cast<long long>(tr),
                                           R - r0));

    // mel bands m0 .. m0 + nms - 1 (nmt tiles of 8), one slab per pass,
    // then the log to the log-mel tile
    for (int m0 = 0; m0 < nm; m0 += SLAB) {
      const int nms = min(SLAB, nm - m0), nmt = (nms + 7) / 8;
      float acc[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      if (mel_warp) {
#pragma unroll 2
        for (int ks = kh; ks < nks; ks += 2) {
          uint32_t a[NP][4];
          if (16 * ks + 16 <= nb)
            frag_rows<NP, false>(a, mine, nb, 16 * ks, nb);
          else
            frag_rows<NP, true>(a, mine, nb, 16 * ks, nb);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            if (i >= nmt) break;
            const uint2* bp =
                fbf + static_cast<size_t>(ks * nmt_all + m0 / 8 + i) * NP * 32 +
                lane;
            uint2 b[NP];
#pragma unroll
            for (int q = 0; q < NP; ++q) b[q] = bp[q * 32];
#pragma unroll
            for (int pass = 0; pass < P; ++pass)
              mma(acc[i], a[a_piece(pass)], b[b_piece(pass)].x,
                  b[b_piece(pass)].y);
          }
        }
      }
      // the odd steps' sums to the log-mel tile, then the even steps'
      // warp adds its own to them and takes the log
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (!mel_warp || kh != 1 || i >= nmt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * i + 2 * tig + (e & 1);
          if (col < nms)
            smel[(rg * 16 + gid + 8 * (e >> 1)) * ldm + m0 + col] = acc[i][e];
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (!mel_warp || kh != 0 || i >= nmt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * i + 2 * tig + (e & 1);
          float* v = smel + (rg * 16 + gid + 8 * (e >> 1)) * ldm + m0 + col;
          if (col < nms) *v = log_value(acc[i][e] + *v, log_kind, log_floor);
        }
      }
    }
    __syncthreads();  // every warp is done with the slot and the log-mel

    // the slot's next tile loads while this one's DCT runs
    if (tid == 0) {
      const long long next = t + static_cast<long long>(slots) * gridDim.x;
      if (next < n_tiles) {
        fence_proxy_async();
        load_tile(slot, rows, next, tr, nb, R, bar + s);
      }
    }
    if (dctf != nullptr) {
      for (int task = warp; task < (tr / 16) * ndt; task += THREADS / 32) {
        const int g = task / ndt, j = task % ndt;
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int ks = 0; ks < kdt; ++ks) {
          uint32_t a[NP][4];
          frag_f32<NP>(a, smel + g * 16 * ldm + 16 * ks, ldm);
          const uint2* bp =
              dctf + static_cast<size_t>(ks * ndt + j) * NP * 32 + lane;
          uint2 b[NP];
#pragma unroll
          for (int q = 0; q < NP; ++q) b[q] = bp[q * 32];
#pragma unroll
          for (int pass = 0; pass < P; ++pass)
            mma(c, a[a_piece(pass)], b[b_piece(pass)].x, b[b_piece(pass)].y);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g * 16 + gid + 8 * (e >> 1);
          const int col = 8 * j + 2 * tig + (e & 1);
          if (row < valid && col < d_out) out[(r0 + row) * d_out + col] = c[e];
        }
      }
    } else {
      store_logmel(smel, ldm, nm, nm, valid, out + r0 * nm);
    }
    __syncthreads();  // the log-mel tile is read before the next tile's
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int P, int MI>
int sig_prepare(cudaFuncAttributes* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      signal_mma_kernel<P, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SIG_SMEM));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(attr, signal_mma_kernel<P, MI>);
  if (err != cudaSuccess) return static_cast<int>(err);
  // fewer registers at launch than the consumers ask for would stall
  // setmaxnreg: refuse to launch
  return attr->numRegs < LAUNCH_REGS
             ? static_cast<int>(cudaErrorLaunchOutOfResources)
             : 0;
}

template <int P, int MI>
int launch(int device, const SigArgs& args, void* stream) {
  // the SMs of the device this host thread launched on last: the queries
  // take longer than a streaming step's launch
  struct Ready {
    int device = -1, sms = 0;
  };
  static thread_local Ready ready;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ready.device != device) {
    cudaFuncAttributes attr;
    const int err = sig_prepare<P, MI>(&attr);
    if (err) return err;
    Ready now;
    now.device = device;
    e = cudaDeviceGetAttribute(&now.sms, cudaDevAttrMultiProcessorCount,
                               device);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = now;
  }
  const long long tiles = (args.total + TM - 1) / TM;
  const dim3 grid(static_cast<unsigned>(
      std::min(tiles, static_cast<long long>(ready.sms))));
  signal_mma_kernel<P, MI><<<grid, SIG_THREADS, SIG_SMEM,
                             static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int MI>
int resources(int* smem, int* blocks_per_sm, int* regs, int* local_bytes) {
  cudaFuncAttributes attr{};
  const int err = sig_prepare<P, MI>(&attr);
  *smem = static_cast<int>(SIG_SMEM);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, signal_mma_kernel<P, MI>, SIG_THREADS, SIG_SMEM));
}

int pass_index(int passes) {
  return passes == 1 ? 0 : passes == 3 ? 1 : passes == 6 ? 2 : -1;
}

// The signal kernel's instantiation for `passes` and nm mel bands (MI mel
// wgmmas of 32 bands for the widest slab), or -1 where none fits.
int variant(int passes, int nm) {
  const int p = pass_index(passes);
  if (p < 0 || nm < 1) return -1;
  const int mi = round_up(std::min(nm, SLAB), MEL_N) / MEL_N;  // 1 .. 4
  return 4 * p + mi - 1;
}

// The tail kernel's plan on the current device.
int tail_plan_here(int passes, int nb, int nm, int dct_out, TailPlan* plan,
                   int* sms) {
  int device = 0, budget = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *plan = tail_plan(passes, nb, nm, dct_out, budget);
  return plan->slots ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tail kernel's instantiation: MI = 4 mel tiles of 8 per warp where nm
// has at most four, else 16 (one slab).
int tail_variant(int passes, int nm) {
  const int p = pass_index(passes);
  if (p < 0 || nm < 1) return -1;
  return 2 * p + (round_up(nm, 8) / 8 <= 4 ? 0 : 1);
}

template <int P, int MI>
int tail_blocks(const TailPlan& plan, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      tail_mma_kernel<P, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tail_mma_kernel<P, MI>, THREADS, plan.bytes));
}

template <int P, int MI>
int launch_tail(int device, const float* rows, long long R, int nb,
                const uint2* fbf, const uint2* dctf, int nm, int d_out,
                int log_kind, float log_floor, float* out, void* stream) {
  // The plan and the blocks per SM of the last shape this host thread
  // launched the instantiation with: the queries take longer than the
  // launch, and a streaming step launches the same shape every time.
  struct Last {
    int device = -1, nb = 0, nm = 0, dct_out = -1, per_sm = 0, sms = 0;
    TailPlan plan{};
  };
  static thread_local Last last;
  const int dct_out = dctf ? d_out : 0;
  if (last.device != device || last.nb != nb || last.nm != nm ||
      last.dct_out != dct_out) {
    Last now;
    now.device = device;
    now.nb = nb;
    now.nm = nm;
    now.dct_out = dct_out;
    int err = tail_plan_here(P, nb, nm, dct_out, &now.plan, &now.sms);
    if (!err) err = tail_blocks<P, MI>(now.plan, &now.per_sm);
    if (err) return err;
    if (now.per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    last = now;
  }
  const TailPlan& plan = last.plan;
  const long long n_tiles = (R + plan.rows - 1) / plan.rows;
  const dim3 grid(static_cast<unsigned>(std::min(
      n_tiles, static_cast<long long>(last.per_sm) * last.sms)));
  tail_mma_kernel<P, MI><<<grid, THREADS, plan.bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      rows, R, nb, plan.rows, plan.slots, plan.ldm, plan.smel, plan.consts,
      plan.slot, fbf, dctf, nm, d_out, log_kind, log_floor, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1/K2: buf [B, M] -> features [B, n_frames, d_out]; K3: conditioned
// frames [R, fl] -> features [R, d_out], as the buffer [1, R*fl] with
// n_frames = R and hop = fl. The constants arrive split and packed
// (kernels/signal.py mma_blocks), bf16: cs, CS's pieces as
// [round_up(nc, 128) / 128] chunks x [ceil(fl / 64)] slices x 2 halves x
// pieces of 64 columns (in (Re, Im) pairs) x 64 deep; fb, fb's as
// [ceil(nm / 128)] slabs x [round_up(nc, 128) / 64] blocks x pieces of 128
// bands x 64 deep (rows to match CS's columns); each block K-major in
// wgmma's 128-byte swizzle, 16-byte aligned. dct: [nm, d_out] f32 pieces
// (bf16 values), or all three null (the ones the pass count does not read
// may be null). passes: 6 ("highest"), 3 (bf16x3) or 1 (default); any other
// count, or a shape the kernel does not take, returns
// cudaErrorInvalidValue.
extern "C" int tpufeat_signal_features_mma(
    int device, const float* buf, int B, long long M, int n_frames, int hop,
    int fl, const void* cs, int nc, const void* fb, int nm, int magnitude,
    int log_kind, float log_floor, const float* dct_hi, const float* dct_mid,
    const float* dct_lo, int d_out, float* out, int passes, void* stream) {
  if (B < 1 || M < 1 || n_frames < 1 || hop < 1 || fl < 1 || nc < 2 ||
      cs == nullptr || fb == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SigArgs args = {};
  args.buf = buf;
  args.M = M;
  args.total = static_cast<long long>(B) * n_frames;
  args.n_frames = n_frames;
  args.hop = hop;
  args.fl = fl;
  args.cs = static_cast<const bf16*>(cs);
  args.nc = nc;
  args.fb = static_cast<const bf16*>(fb);
  args.nm = nm;
  args.magnitude = magnitude;
  args.log_kind = log_kind;
  args.log_floor = log_floor;
  args.dct = FPieces{{dct_hi, dct_mid, dct_lo}};
  args.d_out = d_out;
  args.out = out;
  switch (variant(passes, nm)) {
    case 0: return launch<1, 1>(device, args, stream);
    case 1: return launch<1, 2>(device, args, stream);
    case 2: return launch<1, 3>(device, args, stream);
    case 3: return launch<1, 4>(device, args, stream);
    case 4: return launch<3, 1>(device, args, stream);
    case 5: return launch<3, 2>(device, args, stream);
    case 6: return launch<3, 3>(device, args, stream);
    case 7: return launch<3, 4>(device, args, stream);
    case 8: return launch<6, 1>(device, args, stream);
    case 9: return launch<6, 2>(device, args, stream);
    case 10: return launch<6, 3>(device, args, stream);
    case 11: return launch<6, 4>(device, args, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The signal kernel's launch on the current device for `passes` and nm mel
// bands: dynamic shared memory per block, blocks per SM, registers per
// thread at launch, and local memory per thread (spills; 0 when none).
extern "C" int tpufeat_signal_mma_resources(int passes, int nm,
                                            int* smem_bytes,
                                            int* blocks_per_sm, int* regs,
                                            int* local_bytes) {
#define TPUFEAT_RESOURCES(P, MI) \
  return resources<P, MI>(smem_bytes, blocks_per_sm, regs, local_bytes)
  switch (variant(passes, nm)) {
    case 0: TPUFEAT_RESOURCES(1, 1);
    case 1: TPUFEAT_RESOURCES(1, 2);
    case 2: TPUFEAT_RESOURCES(1, 3);
    case 3: TPUFEAT_RESOURCES(1, 4);
    case 4: TPUFEAT_RESOURCES(3, 1);
    case 5: TPUFEAT_RESOURCES(3, 2);
    case 6: TPUFEAT_RESOURCES(3, 3);
    case 7: TPUFEAT_RESOURCES(3, 4);
    case 8: TPUFEAT_RESOURCES(6, 1);
    case 9: TPUFEAT_RESOURCES(6, 2);
    case 10: TPUFEAT_RESOURCES(6, 3);
    case 11: TPUFEAT_RESOURCES(6, 4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPUFEAT_RESOURCES
}

// K4: spectrum rows [R, nb] (16-byte aligned) -> features [R, d_out] on the
// current device. fb_frags: fb [nb, nm]'s pieces as the MMA's B fragments,
// dct_frags: the DCT [nm, d_out]'s the same way, or null where the output
// is the log-mel (kernels/staged.py tail_mma_constants). Returns
// cudaErrorInvalidValue for a pass count other than 6, 3 or 1, or where
// not even a 16-row tile fits in shared memory.
extern "C" int tpufeat_mel_log_dct_mma(int device, const float* rows,
                                       long long R, int nb,
                                       const void* fb_frags, int nm,
                                       int log_kind, float log_floor,
                                       const void* dct_frags, int d_out,
                                       float* out, int passes, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto fbf = static_cast<const uint2*>(fb_frags);
  const auto dctf = static_cast<const uint2*>(dct_frags);
#define TPUFEAT_LAUNCH(P, MI)                                          \
  return launch_tail<P, MI>(device, rows, R, nb, fbf, dctf, nm, d_out, \
                            log_kind, log_floor, out, stream)
  switch (tail_variant(passes, nm)) {
    case 0: TPUFEAT_LAUNCH(1, 4);
    case 1: TPUFEAT_LAUNCH(1, 16);
    case 2: TPUFEAT_LAUNCH(3, 4);
    case 3: TPUFEAT_LAUNCH(3, 16);
    case 4: TPUFEAT_LAUNCH(6, 4);
    case 5: TPUFEAT_LAUNCH(6, 16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPUFEAT_LAUNCH
}

// The tail kernel's launch on the current device for `passes`, nb bins, nm
// bands and a DCT of dct_out columns (0: none): dynamic shared memory per
// block, blocks per SM, rows per tile, tiles in the ring, and whether the
// fragments are staged in shared memory (1) or read in place (0).
extern "C" int tpufeat_tail_mma_resources(int passes, int nb, int nm,
                                          int dct_out, int* smem_bytes,
                                          int* blocks_per_sm, int* rows,
                                          int* slots, int* staged) {
  TailPlan plan;
  int sms = 0;
  const int bad = tail_plan_here(passes, nb, nm, dct_out, &plan, &sms);
  if (bad) return bad;
  *smem_bytes = static_cast<int>(plan.bytes);
  *rows = plan.rows;
  *slots = plan.slots;
  *staged = plan.consts ? 1 : 0;
  switch (tail_variant(passes, nm)) {
    case 0: return tail_blocks<1, 4>(plan, blocks_per_sm);
    case 1: return tail_blocks<1, 16>(plan, blocks_per_sm);
    case 2: return tail_blocks<3, 4>(plan, blocks_per_sm);
    case 3: return tail_blocks<3, 16>(plan, blocks_per_sm);
    case 4: return tail_blocks<6, 4>(plan, blocks_per_sm);
    case 5: return tail_blocks<6, 16>(plan, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tpufeat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

