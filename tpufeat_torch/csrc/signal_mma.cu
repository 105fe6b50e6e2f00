// The spectro-feature kernel for Hopper (sm_90a) on bf16 tensor cores
// (mma.sync m16n8k16, bf16 in, f32 sums): matmul_precision "bf16x3" and
// "default". "highest" stays on the fp32 FFMA kernel of signal_features.cu.
//
// Replaces, at those two precisions, the TPU kernels of
// tpufeat/pallas/fused.py:
//   - fused.py:669 signal_features (K1/K2): the v4 hop-split body
//     _signal_kernel :401 and the v5 phase-packed body _phase_signal_kernel
//     :598. A block gathers its frames straight out of the signal.
//   - fused.py:353 dft_mel_log_dct (K3): the body _full_kernel :289. The
//     SAME kernel and entry point, launched over rows [R, fl] as the buffer
//     [1, R*fl] with hop = fl, with the DFT matrix without the kaldi fold.
//
// The function, for each frame f = buf[b, t*hop : t*hop + fl] (zeros past
// M), as the TPU computes it at these precisions (fused.py:87-143, 238-250):
//   z = f @ CS, then z*z (or |X| for spectrum="magnitude"), then @ fb, then
//   the floored log, then @ dct (none for Whisper and n_mfcc = 0).
// Every product x @ W is, for bf16x3, hi(x)*hi(W) + hi(x)*lo(W) +
// lo(x)*hi(W), and for default hi(x)*hi(W), with hi = bf16_rn(x) and
// lo = bf16_rn(x - hi). Each bf16 product is exact in f32 and summed in
// f32. The constants arrive split (kernels/signal.py mma_constants); the
// signal is split once per element as it is staged, z*z once per element
// as it is stored for the mel product, the log-mel once per term of the
// DCT (26 x 13 per frame, FFMA).
//
// The tile. A block takes TM = 64 consecutive frames of the whole call:
// global frame g = b * n_frames + t, whatever utterance or stream it
// belongs to, so a streaming step of 10 frames a stream wastes nothing
// and only the call's last tile is partial. For each chunk of NT = 128
// DFT columns:
//   1. z[64, 128] accumulates in registers over KC = 32-deep slices: the
//      frames' slice (gathered per frame from buf into registers a slice
//      ahead, split into hi/lo bf16 as it is stored) and the CS slice (hi
//      and lo, cp.async) double-buffered in shared memory; 8 warps of 32
//      rows x 32 columns, operands by ldmatrix. The stacked-K product
//      [hi | hi | lo] . [chi ; clo ; chi] runs into one accumulator per
//      tile, pass by pass over a pair of tiles' four accumulators;
//   2. z*z (or |X|), split, goes to a shared tile, and mel[64, nm] +=
//      tile @ fb[chunk, :] on the tensor cores, fb's slices streamed
//      through the same ring; mel stays in registers across chunks.
// Then the log, and the DCT (FFMA on the split operands) or the log-mel,
// for the tile's valid frames. z never exists whole, and nothing but the
// signal, the constants and the features touches device memory.
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
// What bounds it on an H100: tensor operations. The dual Whisper-80 +
// MFCC-13 call at B = 128 x 30 s is 3.15e11 FLOP of DFT and mel products,
// so bf16x3 is 9.45e11 bf16 tensor FLOP, 0.96 ms at the published
// 989 TFLOP/s dense peak, and K3 on the MFCC-13 batch's 383,744 rows is
// 5.0e11, 0.51 ms; default needs one third of each. Memory is not the
// bound: about 0.6 GB for the dual, 0.18 ms at 3.35 TB/s. What the design
// does about that bound: the products run on the tensor cores, all passes
// share one staged tile and one accumulator, the split is done once per
// staged element, and every intermediate stays on the SM. It reaches
// about a fifth of the bound (PERF.md); measured there, neither a
// 128-frame tile (half the L2 reads of CS) nor a third CS slice in flight
// helps, and the 80- and 128-mel variants sit at the 128-register cap of
// two blocks per SM. What it leaves: mma.sync rather than wgmma, a barrier
// per 32-deep slice, and the frames re-gathered for each column chunk.
//
// The entry points have a plain C interface (loaded with ctypes) and return
// the CUDA error code of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
constexpr int LDA = KC + 8;    // bf16 row stride of a frame slice
constexpr int LDB = NT + 8;    // bf16 row stride of a constant slice
constexpr int LDS = NT + 8;    // bf16 row stride of the spectrum tile
constexpr int LDM = SLAB + 4;  // f32 row stride of the log-mel tile

constexpr size_t A_TILE = static_cast<size_t>(TM) * LDA;   // bf16 elements
constexpr size_t B_TILE = static_cast<size_t>(KC) * LDB;
constexpr size_t S_TILE = static_cast<size_t>(TM) * LDS;
// frames [2 stages][hi, lo], constants [STAGES][hi, lo], spectrum [hi, lo]
constexpr size_t SMEM_BYTES = sizeof(bf16) * (4 * A_TILE +
                                              2 * STAGES * B_TILE +
                                              2 * S_TILE);
static_assert(sizeof(float) * TM * LDM <= sizeof(bf16) * 2 * S_TILE,
              "the log-mel tile reuses the spectrum tile");
static_assert(TM * KC == THREADS * 8, "each thread stages 8 samples");

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

// (hi, lo) of two values: hi = bf16_rn(x), lo = bf16_rn(x - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// Stage `slice` of a product's constant (hi and lo) into its ring slot,
// rows r0 + slice * KC, when slice < n; one cp.async group either way, so
// that the groups count slices.
template <int P>
__device__ __forceinline__ void load_pair(bf16* ring,
                                          const bf16* __restrict__ hi,
                                          const bf16* __restrict__ lo, int ld,
                                          int slice, int n, int r0, int c0,
                                          int width) {
  if (slice < n) {
    bf16* dst = ring + 2 * (slice % STAGES) * B_TILE;
    load_slice(dst, hi, ld, r0 + slice * KC, c0, width);
    if (P == 3) load_slice(dst + B_TILE, lo, ld, r0 + slice * KC, c0, width);
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

template <int P>
__device__ __forceinline__ void store_frames(const float (&v)[8], bf16* hi,
                                             bf16* lo) {
  uint4 h, l;
  split2(v[0], v[1], h.x, l.x);
  split2(v[2], v[3], h.y, l.y);
  split2(v[4], v[5], h.z, l.z);
  split2(v[6], v[7], h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  if (P == 3) *reinterpret_cast<uint4*>(lo) = l;
}

// z += frames' slice . CS slice over KS (1 or 2) 16-deep steps: the warp's
// 32 rows x `ntiles` (1-4; FULL: 4) tiles of 8 columns. For each pair of
// column tiles the products run pass by pass over its 4 accumulators
// (hi.hi, then hi.lo, then lo.hi), so each accumulator's MMAs, in the same
// order as ever, have 3 others between them instead of none, with no more
// fragments live than one pair's.
template <int P, int KS, bool FULL>
__device__ __forceinline__ void dft_slice(float (&z)[2][4][4],
                                          const bf16* ahi, const bf16* alo,
                                          const bf16* bhi, const bf16* blo,
                                          int wm, int wn, int ntiles) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int kk = ks * 16;
    uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int off = (wm * 32 + mi * 16 + (lane & 15)) * LDA + kk +
                      (lane >> 4) * 8;
      ldsm_x4(a_hi[mi], ahi + off);
      if (P == 3) ldsm_x4(a_lo[mi], alo + off);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (!FULL && 2 * np >= ntiles) break;
      const int off = (kk + (lane & 15)) * LDB + wn * 32 + np * 16 +
                      (lane >> 4) * 8;
      uint32_t b_hi[4], b_lo[4];
      ldsm_x4_t(b_hi, bhi + off);
      if (P == 3) ldsm_x4_t(b_lo, blo + off);
#pragma unroll
      for (int pass = 0; pass < P; ++pass)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!FULL && 2 * np + h >= ntiles) break;
          const uint32_t(&b)[4] = pass == 1 ? b_lo : b_hi;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma(z[mi][2 * np + h], pass == 2 ? a_lo[mi] : a_hi[mi],
                b[2 * h], b[2 * h + 1]);
        }
    }
  }
}

template <int P>
__device__ __forceinline__ void dft_slice_any(float (&z)[2][4][4],
                                              const bf16* ahi,
                                              const bf16* alo,
                                              const bf16* bhi,
                                              const bf16* blo, int ksteps,
                                              int wm, int wn, int ntiles) {
  if (ntiles == 4) {
    if (ksteps == 2)
      dft_slice<P, 2, true>(z, ahi, alo, bhi, blo, wm, wn, ntiles);
    else
      dft_slice<P, 1, true>(z, ahi, alo, bhi, blo, wm, wn, ntiles);
  } else if (ntiles > 0) {
    if (ksteps == 2)
      dft_slice<P, 2, false>(z, ahi, alo, bhi, blo, wm, wn, ntiles);
    else
      dft_slice<P, 1, false>(z, ahi, alo, bhi, blo, wm, wn, ntiles);
  }
}

// The chunk's spectrum columns, split, to the shared tile: power z*z, or
// magnitude |X_k| in the pair's first column and 0 in its second (pair 0:
// |Re_0| and |Re_{nb-1}|).
template <int P>
__device__ __forceinline__ void store_spectrum(const float (&z)[2][4][4],
                                               bf16* shi, bf16* slo,
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
        uint32_t hi, lo;
        split2(s0, s1, hi, lo);
        *reinterpret_cast<uint32_t*>(shi + row * LDS + col) = hi;
        if (P == 3) *reinterpret_cast<uint32_t*>(slo + row * LDS + col) = lo;
      }
  }
}

// mel += spectrum tile[:, k0 : k0 + 16 * ksteps] . fb slice: the warp's 32
// rows x mel tiles wn, wn + 4, ... (< nmt), each tile's two accumulators
// pass by pass.
template <int P, int MI>
__device__ __forceinline__ void mel_slice(float (&mel)[2][MI][4],
                                          const bf16* shi, const bf16* slo,
                                          int k0, const bf16* bhi,
                                          const bf16* blo, int ksteps, int wm,
                                          int wn, int nmt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks >= ksteps) break;
    const int kk = ks * 16;
    uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int off = (wm * 32 + mi * 16 + (lane & 15)) * LDS + k0 + kk +
                      (lane >> 4) * 8;
      ldsm_x4(a_hi[mi], shi + off);
      if (P == 3) ldsm_x4(a_lo[mi], slo + off);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (wn + 4 * i >= nmt) break;
      const int off = (kk + (lane & 15)) * LDB + (wn + 4 * i) * 8;
      uint32_t b_hi[2], b_lo[2];
      ldsm_x2_t(b_hi, bhi + off);
      if (P == 3) ldsm_x2_t(b_lo, blo + off);
#pragma unroll
      for (int pass = 0; pass < P; ++pass)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma(mel[mi][i], pass == 2 ? a_lo[mi] : a_hi[mi],
              pass == 1 ? b_lo[0] : b_hi[0], pass == 1 ? b_lo[1] : b_hi[1]);
    }
  }
}

// P passes per product (3: bf16x3, 1: default); MI mel tiles per warp.
template <int P, int MI>
__global__ void __launch_bounds__(THREADS, 2)
signal_mma_kernel(const float* __restrict__ buf, long long M, int n_frames,
                  long long total, int hop, int fl,
                  const bf16* __restrict__ cs_hi,
                  const bf16* __restrict__ cs_lo, int nc,
                  const bf16* __restrict__ fb_hi,
                  const bf16* __restrict__ fb_lo, int nm, int magnitude,
                  int log_kind, float log_floor,
                  const float* __restrict__ dct_hi,
                  const float* __restrict__ dct_lo, int d_out,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);  // [stage][hi, lo][TM][LDA]
  bf16* sb = sa + 4 * A_TILE;                    // [STAGES][hi, lo][KC][LDB]
  bf16* ss = sb + 2 * STAGES * B_TILE;           // [hi, lo][TM][LDS]
  float* smel = reinterpret_cast<float*>(ss);    // [TM][LDM], at the end

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
        load_pair<P>(sb, cs_hi, cs_lo, ncp, s, nk, 0, c0, NT);
      float v[8];
      load_frames(v, frame, lim, skk);
      for (int kc = 0; kc < nk; ++kc) {
        bf16* ahi = sa + 2 * (kc & 1) * A_TILE;
        const bf16* bhi = sb + 2 * (kc % STAGES) * B_TILE;
        store_frames<P>(v, ahi + sf * LDA + skk, ahi + A_TILE + sf * LDA + skk);
        if (kc + 1 < nk) load_frames(v, frame, lim, (kc + 1) * KC + skk);
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        load_pair<P>(sb, cs_hi, cs_lo, ncp, kc + STAGES - 1, nk, 0, c0, NT);
        dft_slice_any<P>(z, ahi, ahi + A_TILE, bhi, bhi + B_TILE,
                         min(2, (fl - kc * KC + 15) / 16), wm, wn, ntiles);
      }

      // 2. the spectrum tile, then mel += tile . fb[c0 : c0 + cw, :]
      __syncthreads();  // every warp is done with the DFT's ring
      const int cw = min(NT, nc16 - c0);
      const int ns = (cw + KC - 1) / KC;
      for (int s = 0; s < STAGES - 1; ++s)
        load_pair<P>(sb, fb_hi, fb_lo, nmp, s, ns, c0, m0, nmt * 8);
      store_spectrum<P>(z, ss, ss + S_TILE, magnitude, c0, wm, wn, ntiles);
      for (int s = 0; s < ns; ++s) {
        const bf16* bhi = sb + 2 * (s % STAGES) * B_TILE;
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        load_pair<P>(sb, fb_hi, fb_lo, nmp, s + STAGES - 1, ns, c0, m0,
                     nmt * 8);
        mel_slice<P, MI>(mel, ss, ss + S_TILE, s * KC, bhi, bhi + B_TILE,
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
            float x = mel[mi][i][e];
            if (log_kind == 1) {
              x = logf(fmaxf(x, log_floor));
            } else if (log_kind == 2) {
              x = log10f(fmaxf(x, log_floor));
            }
            if (col < nms) smel[row * LDM + col] = x;
          }
      }
    }
    __syncthreads();

    // 4. the DCT (the lifter folded in) or the log-mel, for valid frames.
    // A later slab's DCT goes on from the sum this thread stored for the slab
    // before, so the bands are summed in order, as in one pass.
    if (dct_hi != nullptr) {
      float* orow = out + g0 * d_out;
      for (int o = tid; o < valid * d_out; o += THREADS) {
        const int f = o / d_out, d = o % d_out;
        const float* lr = smel + f * LDM;
        float acc = m0 ? orow[o] : 0.0f;
        for (int m = 0; m < nms; ++m) {
          const float x = lr[m], xh = bf16_round(x);
          const float dh = __ldg(dct_hi + (m0 + m) * d_out + d);
          acc = fmaf(xh, dh, acc);
          if (P == 3) {
            acc = fmaf(xh, __ldg(dct_lo + (m0 + m) * d_out + d), acc);
            acc = fmaf(bf16_round(x - xh), dh, acc);
          }
        }
        orow[o] = acc;
      }
    } else {
      float* orow = out + g0 * nm + m0;
      for (int o = tid; o < valid * nms; o += THREADS)
        orow[(o / nms) * nm + o % nms] = smel[(o / nms) * LDM + o % nms];
    }
  }  // the slab
}

template <int P, int MI>
int launch(int device, const float* buf, int B, long long M, int n_frames,
           int hop, int fl, const bf16* cs_hi, const bf16* cs_lo, int nc,
           const bf16* fb_hi, const bf16* fb_lo, int nm, int magnitude,
           int log_kind, float log_floor, const float* dct_hi,
           const float* dct_lo, int d_out, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(signal_mma_kernel<P, MI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * n_frames;
  const dim3 grid(static_cast<unsigned>((total + TM - 1) / TM));
  signal_mma_kernel<P, MI><<<grid, THREADS, SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(
      buf, M, n_frames, total, hop, fl, cs_hi, cs_lo, nc, fb_hi, fb_lo, nm,
      magnitude, log_kind, log_floor, dct_hi, dct_lo, d_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int MI>
int resources(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = static_cast<int>(SMEM_BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      signal_mma_kernel<P, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, signal_mma_kernel<P, MI>, THREADS, SMEM_BYTES));
}

// The instantiation for `passes` and nm mel bands (MI mel tiles of 8 per
// warp for the widest slab), or -1 where none fits.
int variant(int passes, int nm) {
  if ((passes != 1 && passes != 3) || nm < 1) return -1;
  const int mi = (round_up(min(nm, SLAB), 8) / 8 + 3) / 4;  // 1 .. 4
  return (passes == 3 ? 4 : 0) + mi - 1;
}

}  // namespace

// K1/K2: buf [B, M] -> features [B, n_frames, d_out]; K3: conditioned
// frames [R, fl] -> features [R, d_out], as the buffer [1, R*fl] with
// n_frames = R and hop = fl. The arguments of tpufeat_signal_features,
// with the constants split (kernels/signal.py mma_constants): cs_hi/lo
// [round_up(fl, 32), round_up(nc, 128)] bf16 with the columns in (Re, Im)
// pairs, fb_hi/lo [round_up(nc, 128), round_up(nm, 8)] bf16 with the rows
// to match, dct_hi/lo [nm, d_out] f32 (bf16 values) or null, and the pass
// count (3: bf16x3, 1: default). Returns cudaErrorInvalidValue for a pass
// count other than 1 or 3.
extern "C" int tpufeat_signal_features_mma(
    int device, const float* buf, int B, long long M, int n_frames, int hop,
    int fl, const void* cs_hi, const void* cs_lo, int nc, const void* fb_hi,
    const void* fb_lo, int nm, int magnitude, int log_kind, float log_floor,
    const float* dct_hi, const float* dct_lo, int d_out, float* out,
    int passes, void* stream) {
  const auto ch = static_cast<const bf16*>(cs_hi);
  const auto cl = static_cast<const bf16*>(cs_lo);
  const auto fh = static_cast<const bf16*>(fb_hi);
  const auto fbl = static_cast<const bf16*>(fb_lo);
#define TPUFEAT_LAUNCH(P, MI)                                               \
  return launch<P, MI>(device, buf, B, M, n_frames, hop, fl, ch, cl, nc, fh, \
                       fbl, nm, magnitude, log_kind, log_floor, dct_hi,      \
                       dct_lo, d_out, out, stream)
  switch (variant(passes, nm)) {
    case 0: TPUFEAT_LAUNCH(1, 1);
    case 1: TPUFEAT_LAUNCH(1, 2);
    case 2: TPUFEAT_LAUNCH(1, 3);
    case 3: TPUFEAT_LAUNCH(1, 4);
    case 4: TPUFEAT_LAUNCH(3, 1);
    case 5: TPUFEAT_LAUNCH(3, 2);
    case 6: TPUFEAT_LAUNCH(3, 3);
    case 7: TPUFEAT_LAUNCH(3, 4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPUFEAT_LAUNCH
}

// The kernel's dynamic shared memory per block and how many blocks fit on
// one SM of the current device, for `passes` and nm mel bands.
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
