// The spectro-feature kernels for Hopper (sm_90a), on bf16 tensor cores
// (mma.sync m16n8k16, bf16 in, f32 sums), at every matmul_precision:
// "highest" as six bf16 passes per product, "bf16x3" as three, "default"
// as one.
//
// Replaces the TPU kernels of tpufeat/pallas/fused.py:
//   - fused.py:669 signal_features (K1/K2): the v4 hop-split body
//     _signal_kernel :401 and the v5 phase-packed body _phase_signal_kernel
//     :598, as signal_mma_kernel below. A block gathers its frames straight
//     out of the signal.
//   - fused.py:353 dft_mel_log_dct (K3): the body _full_kernel :289. The
//     SAME kernel and entry point, launched over rows [R, fl] as the buffer
//     [1, R*fl] with hop = fl, with the DFT matrix without the kaldi fold.
//   - fused.py:336 mel_log_dct (K4): the body _tail_kernel :282, as
//     tail_mma_kernel below, which shares the split, the passes and the log
//     with the signal kernel.
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
// constants arrive split (kernels/signal.py mma_constants). At P = 1 and 3
// the signal is split once per element as it is staged and z*z once per
// element as it is stored for the mel product; at P = 6 both are staged as
// f32 and split into their three pieces as each MMA fragment is built (the
// three pieces staged would take 135 KB of shared memory, one block per
// SM). The signal kernel splits the log-mel once per term of its DCT
// (FFMA).
//
// The signal kernel's tile. A block takes TM = 64 consecutive frames of the
// whole call: global frame g = b * n_frames + t, whatever utterance or
// stream it belongs to, so a streaming step of 10 frames a stream wastes
// nothing and only the call's last tile is partial. For each chunk of
// NT = 128 DFT columns:
//   1. z[64, 128] accumulates in registers over KC = 32-deep slices: the
//      frames' slice (gathered per frame from buf into registers a slice
//      ahead) and the CS slice (its pieces, cp.async) double-buffered in
//      shared memory; 8 warps of 32 rows x 32 columns. The P products of a
//      slice run into one accumulator per tile, pass by pass over a pair of
//      tiles' four accumulators;
//   2. z*z (or |X|) goes to a shared tile, and mel[64, nm] += tile @
//      fb[chunk, :] on the tensor cores, fb's slices streamed through the
//      same ring; mel stays in registers across chunks.
// Then the log, and the DCT or the log-mel, for the tile's valid frames.
// z never exists whole, and nothing but the signal, the constants and the
// features touches device memory.
// CS's columns are ordered in pairs (Re_k, Im_k), pair 0 holding Re_0 and
// Re_{nb-1}, so a bin's Re and Im land in the same thread of an MMA
// accumulator and |X| is rebuilt in registers; fb's rows follow (for
// magnitude, pair k's row is fb[k] and a zero row). Columns past n_fft
// (to a multiple of 16) are zero and skipped per 8-column tile.
// More than SLAB = 128 mel bands run in slabs of 128: the tile's whole
// body (DFT, spectrum, mel product, log) once per slab, the DCT summing
// each slab's bands into the output in the order of a single pass.
//
// Bits: TM, the chunking and the order of every sum are fixed whatever
// the call's shape, with no split-K, and an MMA row depends only on its
// own A row, so a frame's features depend neither on its place in the
// tile, the batch or the call, nor on its neighbours. A frame reads no
// sample past its own end (K3's rows may be followed by Inf or NaN).
//
// What bounds the signal kernel on an H100: tensor operations. The dual
// Whisper-80 + MFCC-13 call at B = 128 x 30 s is 3.15e11 FLOP of DFT and
// mel products, so P passes are P x 3.15e11 bf16 tensor FLOP: 1.91 ms at
// the published 989 TFLOP/s dense peak for "highest", 0.96 ms for bf16x3;
// K3 on the MFCC-13 batch's 383,744 rows is P x 1.67e11. Memory is not the
// bound: about 0.6 GB for the dual, 0.18 ms at 3.35 TB/s. What the design
// does about that bound: the products run on the tensor cores, all passes
// share one staged tile and one accumulator, and every intermediate stays
// on the SM; "highest" stages f32 so that its three pieces fit two blocks
// per SM (107,520 B of shared memory). It reaches about a fifth of the
// bound (PERF.md); measured there, neither a 128-frame tile nor a third CS
// slice in flight helps. What it leaves: mma.sync rather than wgmma, a
// barrier per 32-deep slice, and the frames re-gathered per column chunk.
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

constexpr int TM = 64;         // frames per block: kernels/signal.py
                               // MMA_TILE_FRAMES
constexpr int THREADS = TM * 4;  // 8 warps: 2 row groups x 4 column groups
constexpr int STAGES = 2;      // constant slices in flight
constexpr int NT = 128;        // DFT columns per chunk: MMA_COLS
constexpr int KC = 32;         // depth of a staged slice: MMA_DEPTH
constexpr int SLAB = 128;      // mel bands per pass, 16 tiles of 8, 4 per
                               // column group: MMA_MEL_SLAB
constexpr int LDA = KC + 8;    // row stride of a frame slice, bf16 or f32
                               // (40 f32: rows 8 banks apart)
constexpr int LDB = NT + 8;    // bf16 row stride of a constant slice
constexpr int LDS = NT + 8;    // row stride of the spectrum tile, bf16 or
                               // f32
constexpr int LDM = SLAB + 4;  // f32 row stride of the log-mel tile

constexpr size_t A_TILE = static_cast<size_t>(TM) * LDA;   // elements
constexpr size_t B_TILE = static_cast<size_t>(KC) * LDB;
constexpr size_t S_TILE = static_cast<size_t>(TM) * LDS;
// both stages of the frames: [2][hi, lo][TM][LDA] bf16 or [2][TM][LDA] f32
constexpr size_t A_BYTES = sizeof(float) * 2 * A_TILE;
// the spectrum tile: [hi, lo][TM][LDS] bf16 or [TM][LDS] f32
constexpr size_t S_BYTES = sizeof(float) * S_TILE;
static_assert(sizeof(float) * TM * LDM <= S_BYTES,
              "the log-mel tile reuses the spectrum tile");
static_assert(TM * KC == THREADS * 8, "each thread stages 8 samples");

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

// Constant slices in the ring, per stage: (hi, lo) or (hi, mid, lo)
template <int P>
__host__ __device__ constexpr int ring_pieces() {
  return P == 6 ? 3 : 2;
}

// frames, the constant ring, the spectrum (the log-mel tile over it)
template <int P>
constexpr size_t smem_bytes() {
  return A_BYTES + sizeof(bf16) * ring_pieces<P>() * STAGES * B_TILE +
         S_BYTES;
}

// A constant's pieces (hi, mid, lo; bf16x3's (hi, lo) are the first two,
// default's hi the first), and the DCT's as f32; unused ones are null.
struct Pieces {
  const bf16* p[3];
};
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

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Rows [r0, r0 + KC) x columns [c0, c0 + width) of a bf16 matrix (row
// stride ld, width a multiple of 8) into a KC x LDB stage, by cp.async.
__device__ __forceinline__ void load_slice(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int ld, int r0, int c0,
                                           int width) {
  const int segs = width / 8;
  for (int i = threadIdx.x; i < KC * segs; i += THREADS) {
    const int r = i / segs, s = i % segs;
    cp_async16(dst + r * LDB + s * 8,
               src + static_cast<size_t>(r0 + r) * ld + c0 + s * 8);
  }
}

// Stage `slice` of a product's constant (its pieces) into its ring slot,
// rows r0 + slice * KC, when slice < n; one cp.async group either way, so
// that the groups count slices.
template <int P>
__device__ __forceinline__ void load_pieces(bf16* ring, const Pieces& src,
                                            int ld, int slice, int n, int r0,
                                            int c0, int width) {
  if (slice < n) {
    bf16* dst = ring + ring_pieces<P>() * (slice % STAGES) * B_TILE;
#pragma unroll
    for (int i = 0; i < pieces(P); ++i)
      load_slice(dst + i * B_TILE, src.p[i], ld, r0 + slice * KC, c0, width);
  }
  cp_async_commit();
}

// The thread's 8 samples k .. k + 7 of its frame, zeros at or past lim
// (the frame's end or the end of its row): nothing past a frame is read.
__device__ __forceinline__ void load_frames(float (&v)[8],
                                            const float* __restrict__ frame,
                                            int lim, int k) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = k + i < lim ? __ldg(frame + k + i) : 0.0f;
}

// The 8 samples to row `row`, columns col .. col + 7, of a frame stage:
// split into their pieces (P 1, 3), or as they are (P 6).
template <int P>
__device__ __forceinline__ void store_frames(const float (&v)[8],
                                             unsigned char* stage, int row,
                                             int col) {
  if constexpr (P == 6) {
    float* d = reinterpret_cast<float*>(stage) + row * LDA + col;
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    constexpr int NP = pieces(P);
    uint32_t w[4][NP];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_pair<NP>(v[2 * q], v[2 * q + 1], w[q]);
    bf16* d = reinterpret_cast<bf16*>(stage) + row * LDA + col;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      *reinterpret_cast<uint4*>(d + i * A_TILE) =
          make_uint4(w[0][i], w[1][i], w[2][i], w[3][i]);
  }
}

// z += frames' slice . CS slice over KS (1 or 2) 16-deep steps: the warp's
// 32 rows x `ntiles` (1-4; FULL: 4) tiles of 8 columns. For each pair of
// column tiles the products run pass by pass over its 4 accumulators, so
// each accumulator's MMAs, in the pass order, have 3 others between them
// instead of none, with no more fragments live than one pair's.
template <int P, int KS, bool FULL>
__device__ __forceinline__ void dft_slice(float (&z)[2][4][4],
                                          const unsigned char* a_stage,
                                          const bf16* b_stage, int wm,
                                          int wn, int ntiles) {
  constexpr int NP = pieces(P);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int kk = ks * 16;
    uint32_t a[2][NP][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = wm * 32 + mi * 16;
      if constexpr (P == 6) {
        frag_f32<NP>(a[mi],
                     reinterpret_cast<const float*>(a_stage) + row * LDA + kk,
                     LDA);
      } else {
        const bf16* ah = reinterpret_cast<const bf16*>(a_stage) +
                         (row + (lane & 15)) * LDA + kk + (lane >> 4) * 8;
#pragma unroll
        for (int i = 0; i < NP; ++i) ldsm_x4(a[mi][i], ah + i * A_TILE);
      }
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (!FULL && 2 * np >= ntiles) break;
      const int off = (kk + (lane & 15)) * LDB + wn * 32 + np * 16 +
                      (lane >> 4) * 8;
      uint32_t b[NP][4];
#pragma unroll
      for (int i = 0; i < NP; ++i) ldsm_x4_t(b[i], b_stage + i * B_TILE + off);
#pragma unroll
      for (int pass = 0; pass < P; ++pass)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!FULL && 2 * np + h >= ntiles) break;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma(z[mi][2 * np + h], a[mi][a_piece(pass)],
                b[b_piece(pass)][2 * h], b[b_piece(pass)][2 * h + 1]);
        }
    }
  }
}

template <int P>
__device__ __forceinline__ void dft_slice_any(float (&z)[2][4][4],
                                              const unsigned char* a_stage,
                                              const bf16* b_stage,
                                              int ksteps, int wm, int wn,
                                              int ntiles) {
  if (ntiles == 4) {
    if (ksteps == 2)
      dft_slice<P, 2, true>(z, a_stage, b_stage, wm, wn, ntiles);
    else
      dft_slice<P, 1, true>(z, a_stage, b_stage, wm, wn, ntiles);
  } else if (ntiles > 0) {
    if (ksteps == 2)
      dft_slice<P, 2, false>(z, a_stage, b_stage, wm, wn, ntiles);
    else
      dft_slice<P, 1, false>(z, a_stage, b_stage, wm, wn, ntiles);
  }
}

// The chunk's spectrum columns to the shared tile, split into their pieces
// (P 1, 3) or as f32 (P 6): power z*z, or magnitude |X_k| in the pair's
// first column and 0 in its second (pair 0: |Re_0| and |Re_{nb-1}|).
template <int P>
__device__ __forceinline__ void store_spectrum(const float (&z)[2][4][4],
                                               unsigned char* tile,
                                               int magnitude, int c0, int wm,
                                               int wn, int ntiles) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    if (nj >= ntiles) break;
    const int col = wn * 32 + nj * 8 + 2 * tig;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + gid + 8 * h;
        const float re = z[mi][nj][2 * h], im = z[mi][nj][2 * h + 1];
        float s0, s1;
        if (!magnitude) {
          s0 = __fmul_rn(re, re);
          s1 = __fmul_rn(im, im);
        } else if (c0 + col == 0) {
          s0 = sqrtf(__fmul_rn(re, re));
          s1 = sqrtf(__fmul_rn(im, im));
        } else {
          s0 = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
          s1 = 0.0f;
        }
        if constexpr (P == 6) {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(tile) +
                                     row * LDS + col) = make_float2(s0, s1);
        } else {
          uint32_t w[pieces(P)];
          split_pair<pieces(P)>(s0, s1, w);
#pragma unroll
          for (int i = 0; i < pieces(P); ++i)
            *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(tile) +
                                         i * S_TILE + row * LDS + col) = w[i];
        }
      }
  }
}

// mel += spectrum tile[:, k0 : k0 + 16 * ksteps] . fb slice: the warp's 32
// rows x mel tiles wn, wn + 4, ... (< nmt), each tile's two accumulators
// pass by pass.
template <int P, int MI>
__device__ __forceinline__ void mel_slice(float (&mel)[2][MI][4],
                                          const unsigned char* tile, int k0,
                                          const bf16* b_stage, int ksteps,
                                          int wm, int wn, int nmt) {
  constexpr int NP = pieces(P);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks >= ksteps) break;
    const int kk = ks * 16;
    uint32_t a[2][NP][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = wm * 32 + mi * 16;
      if constexpr (P == 6) {
        frag_f32<NP>(a[mi],
                     reinterpret_cast<const float*>(tile) + row * LDS + k0 +
                         kk,
                     LDS);
      } else {
        const bf16* ah = reinterpret_cast<const bf16*>(tile) +
                         (row + (lane & 15)) * LDS + k0 + kk +
                         (lane >> 4) * 8;
#pragma unroll
        for (int i = 0; i < NP; ++i) ldsm_x4(a[mi][i], ah + i * S_TILE);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (wn + 4 * i >= nmt) break;
      const int off = (kk + (lane & 15)) * LDB + (wn + 4 * i) * 8;
      uint32_t b[NP][2];
#pragma unroll
      for (int q = 0; q < NP; ++q) ldsm_x2_t(b[q], b_stage + q * B_TILE + off);
#pragma unroll
      for (int pass = 0; pass < P; ++pass)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma(mel[mi][i], a[mi][a_piece(pass)], b[b_piece(pass)][0],
              b[b_piece(pass)][1]);
    }
  }
}

__device__ __forceinline__ float log_value(float x, int log_kind,
                                           float log_floor) {
  if (log_kind == 1) return logf(fmaxf(x, log_floor));
  if (log_kind == 2) return log10f(fmaxf(x, log_floor));
  return x;
}

// The DCT (the lifter folded in) of the first `valid` rows of a log-mel
// tile (row stride ldm) over its nms bands, dct rows m0 .. m0 + nms - 1,
// to orow[f * d_out + d]: every term at P passes in the pass order, the
// bands in order. A later slab (m0 > 0) goes on from the sum stored for
// the slab before, so the bands are summed in order, as in one pass.
template <int P>
__device__ void dct_rows(const float* smel, int ldm, int nms, int m0,
                         const FPieces& dct, int d_out, int valid,
                         float* __restrict__ orow) {
  constexpr int NP = pieces(P);
  for (int o = threadIdx.x; o < valid * d_out; o += THREADS) {
    const int f = o / d_out, d = o % d_out;
    const float* lr = smel + f * ldm;
    float acc = m0 ? orow[o] : 0.0f;
    for (int m = 0; m < nms; ++m) {
      float x[NP], w[NP];
      split_value<NP>(lr[m], x);
#pragma unroll
      for (int i = 0; i < NP; ++i) w[i] = __ldg(dct.p[i] + (m0 + m) * d_out + d);
#pragma unroll
      for (int pass = 0; pass < P; ++pass)
        acc = fmaf(x[a_piece(pass)], w[b_piece(pass)], acc);
    }
    orow[o] = acc;
  }
}

// The log-mel as it is: nms bands of the first `valid` rows to orow (row
// stride nm).
__device__ void store_logmel(const float* smel, int ldm, int nms, int nm,
                             int valid, float* __restrict__ orow) {
  for (int o = threadIdx.x; o < valid * nms; o += THREADS)
    orow[(o / nms) * nm + o % nms] = smel[(o / nms) * ldm + o % nms];
}

// P passes per product (6: "highest", 3: bf16x3, 1: default); MI mel tiles
// per warp.
template <int P, int MI>
__global__ void __launch_bounds__(THREADS, 2)
signal_mma_kernel(const float* __restrict__ buf, long long M, int n_frames,
                  long long total, int hop, int fl, Pieces cs, int nc,
                  Pieces fb, int nm, int magnitude, int log_kind,
                  float log_floor, FPieces dct, int d_out,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sa = smem_raw;                  // frames, 2 stages
  bf16* sb = reinterpret_cast<bf16*>(sa + A_BYTES);  // [STAGES][pieces][KC][LDB]
  unsigned char* ss = reinterpret_cast<unsigned char*>(
      sb + ring_pieces<P>() * STAGES * B_TILE);  // the spectrum tile
  float* smel = reinterpret_cast<float*>(ss);    // [TM][LDM], over it

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const long long g0 = static_cast<long long>(blockIdx.x) * TM;
  const int ncp = round_up(nc, NT), nc16 = round_up(nc, 16);
  const int nmp = round_up(nm, 8);
  const int nk = (fl + KC - 1) / KC;

  // the frame this thread stages: row sf of the tile, samples skk .. + 7
  // of each slice
  const int sf = tid >> 2, skk = (tid & 3) * 8;
  const float* frame = buf;
  int lim = 0;
  {
    const long long g = g0 + sf;
    if (g < total) {
      const long long b = g / n_frames, start = (g - b * n_frames) * hop;
      frame = buf + b * M + start;
      lim = static_cast<int>(
          max(0LL, min(static_cast<long long>(fl), M - start)));
    }
  }

  const int valid = static_cast<int>(min(static_cast<long long>(TM),
                                         total - g0));
  // mel bands m0 .. m0 + nms - 1 (nmt tiles of 8), one slab per pass
  for (int m0 = 0; m0 < nm; m0 += SLAB) {
    const int nms = min(SLAB, nm - m0), nmt = round_up(nms, 8) / 8;
    float mel[2][MI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mel[mi][i][e] = 0.0f;

    for (int c0 = 0; c0 < nc16; c0 += NT) {
      const int ntiles = max(0, min(4, (nc16 - c0 - wn * 32) / 8));
      float z[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) z[mi][nj][e] = 0.0f;

      // 1. z = frames . CS over KC-deep slices: the frames double-buffered,
      // CS in a ring of STAGES slices
      __syncthreads();  // every warp is done with the last chunk's ring
      for (int s = 0; s < STAGES - 1; ++s)
        load_pieces<P>(sb, cs, ncp, s, nk, 0, c0, NT);
      float v[8];
      load_frames(v, frame, lim, skk);
      for (int kc = 0; kc < nk; ++kc) {
        unsigned char* a_stage = sa + (kc & 1) * (A_BYTES / 2);
        const bf16* b_stage = sb + ring_pieces<P>() * (kc % STAGES) * B_TILE;
        store_frames<P>(v, a_stage, sf, skk);
        if (kc + 1 < nk) load_frames(v, frame, lim, (kc + 1) * KC + skk);
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        load_pieces<P>(sb, cs, ncp, kc + STAGES - 1, nk, 0, c0, NT);
        dft_slice_any<P>(z, a_stage, b_stage,
                         min(2, (fl - kc * KC + 15) / 16), wm, wn, ntiles);
      }

      // 2. the spectrum tile, then mel += tile . fb[c0 : c0 + cw, :]
      __syncthreads();  // every warp is done with the DFT's ring
      const int cw = min(NT, nc16 - c0);
      const int ns = (cw + KC - 1) / KC;
      for (int s = 0; s < STAGES - 1; ++s)
        load_pieces<P>(sb, fb, nmp, s, ns, c0, m0, nmt * 8);
      store_spectrum<P>(z, ss, magnitude, c0, wm, wn, ntiles);
      for (int s = 0; s < ns; ++s) {
        const bf16* b_stage = sb + ring_pieces<P>() * (s % STAGES) * B_TILE;
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        load_pieces<P>(sb, fb, nmp, s + STAGES - 1, ns, c0, m0, nmt * 8);
        mel_slice<P, MI>(mel, ss, s * KC, b_stage,
                         min(2, (cw - s * KC) / 16), wm, wn, nmt);
      }
    }

    // 3. the log, to the log-mel tile (over the spectrum tile)
    __syncthreads();
    {
      const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int j = wn + 4 * i;
        if (j >= nmt) break;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = wm * 32 + mi * 16 + gid + 8 * (e >> 1);
            const int col = j * 8 + 2 * tig + (e & 1);
            if (col < nms)
              smel[row * LDM + col] =
                  log_value(mel[mi][i][e], log_kind, log_floor);
          }
      }
    }
    __syncthreads();

    // 4. the DCT or the log-mel, for valid frames
    if (dct.p[0] != nullptr)
      dct_rows<P>(smel, LDM, nms, m0, dct, d_out, valid, out + g0 * d_out);
    else
      store_logmel(smel, LDM, nms, nm, valid, out + g0 * nm + m0);
  }  // the slab
}

// ---------------------------------------------------------------------------
// K4: the tail kernel
// ---------------------------------------------------------------------------

constexpr int TAIL_ROWS = 64;    // rows per tile
constexpr int TAIL_SLOTS = 3;    // most tiles in the ring
constexpr size_t TAIL_HEAD = 128;  // the slots' mbarriers, at the front

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
int launch(int device, const float* buf, int B, long long M, int n_frames,
           int hop, int fl, Pieces cs, int nc, Pieces fb, int nm,
           int magnitude, int log_kind, float log_floor, FPieces dct,
           int d_out, float* out, void* stream) {
  constexpr size_t bytes = smem_bytes<P>();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(signal_mma_kernel<P, MI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * n_frames;
  const dim3 grid(static_cast<unsigned>((total + TM - 1) / TM));
  signal_mma_kernel<P, MI><<<grid, THREADS, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      buf, M, n_frames, total, hop, fl, cs, nc, fb, nm, magnitude, log_kind,
      log_floor, dct, d_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int MI>
int resources(int* smem, int* blocks_per_sm) {
  constexpr size_t bytes = smem_bytes<P>();
  *smem = static_cast<int>(bytes);
  cudaError_t err = cudaFuncSetAttribute(
      signal_mma_kernel<P, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, signal_mma_kernel<P, MI>, THREADS, bytes));
}

int pass_index(int passes) {
  return passes == 1 ? 0 : passes == 3 ? 1 : passes == 6 ? 2 : -1;
}

// The signal kernel's instantiation for `passes` and nm mel bands (MI mel
// tiles of 8 per warp for the widest slab), or -1 where none fits.
int variant(int passes, int nm) {
  const int p = pass_index(passes);
  if (p < 0 || nm < 1) return -1;
  const int mi = (round_up(min(nm, SLAB), 8) / 8 + 3) / 4;  // 1 .. 4
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
// n_frames = R and hop = fl. The constants arrive split
// (kernels/signal.py mma_constants), each as its pieces hi, mid, lo (the
// ones the pass count does not read may be null): cs [round_up(fl, 32),
// round_up(nc, 128)] bf16 with the columns in (Re, Im) pairs, fb
// [round_up(nc, 128), round_up(nm, 8)] bf16 with the rows to match, dct
// [nm, d_out] f32 (bf16 values), or all three null. passes: 6 ("highest"),
// 3 (bf16x3) or 1 (default); any other count returns
// cudaErrorInvalidValue.
extern "C" int tpufeat_signal_features_mma(
    int device, const float* buf, int B, long long M, int n_frames, int hop,
    int fl, const void* cs_hi, const void* cs_mid, const void* cs_lo, int nc,
    const void* fb_hi, const void* fb_mid, const void* fb_lo, int nm,
    int magnitude, int log_kind, float log_floor, const float* dct_hi,
    const float* dct_mid, const float* dct_lo, int d_out, float* out,
    int passes, void* stream) {
  const Pieces cs{{static_cast<const bf16*>(cs_hi),
                   static_cast<const bf16*>(cs_mid),
                   static_cast<const bf16*>(cs_lo)}};
  const Pieces fb{{static_cast<const bf16*>(fb_hi),
                   static_cast<const bf16*>(fb_mid),
                   static_cast<const bf16*>(fb_lo)}};
  const FPieces dct{{dct_hi, dct_mid, dct_lo}};
#define TPUFEAT_LAUNCH(P, MI)                                                \
  return launch<P, MI>(device, buf, B, M, n_frames, hop, fl, cs, nc, fb, nm, \
                       magnitude, log_kind, log_floor, dct, d_out, out,      \
                       stream)
  switch (variant(passes, nm)) {
    case 0: TPUFEAT_LAUNCH(1, 1);
    case 1: TPUFEAT_LAUNCH(1, 2);
    case 2: TPUFEAT_LAUNCH(1, 3);
    case 3: TPUFEAT_LAUNCH(1, 4);
    case 4: TPUFEAT_LAUNCH(3, 1);
    case 5: TPUFEAT_LAUNCH(3, 2);
    case 6: TPUFEAT_LAUNCH(3, 3);
    case 7: TPUFEAT_LAUNCH(3, 4);
    case 8: TPUFEAT_LAUNCH(6, 1);
    case 9: TPUFEAT_LAUNCH(6, 2);
    case 10: TPUFEAT_LAUNCH(6, 3);
    case 11: TPUFEAT_LAUNCH(6, 4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPUFEAT_LAUNCH
}

// The signal kernel's dynamic shared memory per block and how many blocks
// fit on one SM of the current device, for `passes` and nm mel bands.
extern "C" int tpufeat_signal_mma_resources(int passes, int nm,
                                            int* smem_bytes,
                                            int* blocks_per_sm) {
  switch (variant(passes, nm)) {
    case 0: return resources<1, 1>(smem_bytes, blocks_per_sm);
    case 1: return resources<1, 2>(smem_bytes, blocks_per_sm);
    case 2: return resources<1, 3>(smem_bytes, blocks_per_sm);
    case 3: return resources<1, 4>(smem_bytes, blocks_per_sm);
    case 4: return resources<3, 1>(smem_bytes, blocks_per_sm);
    case 5: return resources<3, 2>(smem_bytes, blocks_per_sm);
    case 6: return resources<3, 3>(smem_bytes, blocks_per_sm);
    case 7: return resources<3, 4>(smem_bytes, blocks_per_sm);
    case 8: return resources<6, 1>(smem_bytes, blocks_per_sm);
    case 9: return resources<6, 2>(smem_bytes, blocks_per_sm);
    case 10: return resources<6, 3>(smem_bytes, blocks_per_sm);
    case 11: return resources<6, 4>(smem_bytes, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
