// The phase-kernel anatomy family for Hopper (sm_90a): bf16 tensor cores
// (nvcuda::wmma, 16x16x16 bf16 fragments into f32) or fp32 FFMA.
//
// Replaces the eight stand-alone TPU kernels of benchmarks/experiments/,
// which compute one function and differ only in operand layout and in how
// the products are split into bf16:
//   K5a nopad_kernel.py:52 (kern :32)     K5e phase_anatomy2.py:75 (make :31)
//   K5b repack_kernel.py:57 (kern :33)    K5f phase_anatomy3.py:83 (make :32)
//   K5c phase_kernel.py:85 (kern :52)     K5g phase_anatomy4.py:82 (make :38)
//   K5d phase_anatomy.py:84 (make :40)    K5h phase_anatomy5.py:156 (make :65)
//
// The function (kernels/anatomy.py has the contract and the plain twin):
// main [B, R, W] f32 in nblk blocks of TR rows, bnd [B, nblk, 8, W] the
// blocks' successor rows, ext = a block's TR rows then its 8 bnd rows.
// Output frame r*H + p of a block is
//   z = sum over phase p's terms (s, a, K) of ext[r + s, a : a + K] @ D,
//   then the tail: sqlog / log / nolog of m = (z*z) @ FB, or z[:, :NM].
// A bf16 product of N passes is hi*chi (+ hi*clo) (+ lo*chi), with
// hi = bf16_rn(x), lo = bf16_rn(x - hi) made here for the signal and for
// z*z, and the matrices split by the caller; an f32 product is FFMA.
//
// One block computes TM = 64 rows of one phase of one block of one
// utterance: the row tile, over the NC columns of z in chunks of 128:
//   1. for each term and each KC = 32 slice of its depth, stage the
//      signal slice (split into hi/lo, zeros past the tile's valid rows
//      and the term's depth) and the matrix slice in shared memory, and
//      accumulate z's 64 x 128 chunk: 8 warps, each 16 rows x 64 columns
//      (4 wmma accumulators), or FFMA, each thread 8 rows x 4 columns.
//      Each slice is loaded with 16-byte loads into registers while the
//      slice before it is multiplied, then stored to shared memory;
//   2. square the chunk (split into hi/lo for a bf16 mel product) and
//      accumulate its share of the mel product, m += sq[:, chunk] @
//      FB[chunk, :], FB streamed in 32-row slices;
//   3. after the last chunk, the tail, stored for the tile's valid rows.
// dftonly stops after the first chunk and stores z[:, :NM].
// z and the squared spectrum never reach device memory.
//
// What bounds it on an H100 at the phase scripts' shapes (B = 128, 3072
// frames, NC = 512, NM = 128): bf16x3 is 7.7e11 tensor FLOP, about
// 0.78 ms at the published 989 TFLOP/s bf16 dense peak; f32 is 2.6e11
// FLOP, about 3.9 ms at 67 TFLOP/s; every mode moves about 0.46 GB
// (the signal once, the features once), about 0.14 ms at 3.35 TB/s. So
// every mode is operation-bound. The design does the minimum about that
// bound that keeps it simple and right: the bf16 passes run on the tensor
// cores rather than FFMA, all passes of a product share one staged tile
// and one accumulator, no intermediate leaves the SM, and each slice's
// 16-byte loads are in flight while the slice before it is multiplied.
// It stays far from the bound (about 13 % for bf16x3 on an H100, PERF.md):
// wmma (not wgmma), one 64 x 128 tile per block, the matrices restaged by
// every block, the signal split again for each 128 columns, and two
// __syncthreads per 32-deep slice. TMA, wgmma and a persistent schedule
// are later work.
//
// The entry points have a plain C interface (loaded with ctypes) and
// return the CUDA error code of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int MAXH = 4;         // phases: kernels/anatomy.py MAX_PHASES
constexpr int MAXT = 4;         // terms per phase: MAX_TERMS
constexpr int THREADS = 256;    // 8 warps
constexpr int TM = 64;          // rows per block
constexpr int NT = 128;         // z columns per chunk, and NM
constexpr int KC = 32;          // depth per staged slice
constexpr int LDA = KC + 8;     // bf16 signal slice row stride
constexpr int LDB = NT + 8;     // bf16 matrix slice row stride
constexpr int LDZ = NT + 4;     // f32 z chunk row stride
constexpr int LDS = NT + 8;     // bf16 squared chunk row stride
constexpr int ROWS_BND = 8;     // bnd rows per block

struct Terms {
  int n[MAXH];                  // terms of each phase
  int s[MAXH][MAXT];            // row shift
  int a[MAXH][MAXT];            // lane offset
  int k[MAXH][MAXT];            // depth (a multiple of 16)
  int row[MAXH][MAXT];          // first row of the term's matrix
};

// Shared memory regions (bytes), each large enough for its f32 or bf16 use.
constexpr size_t A_BYTES = 2 * TM * LDA * sizeof(bf16);   // >= TM*KC f32
constexpr size_t B_BYTES = 2 * KC * LDB * sizeof(bf16);   // >= KC*NT f32
constexpr size_t Z_BYTES = TM * LDZ * sizeof(float);
constexpr size_t S_BYTES = 2 * TM * LDS * sizeof(bf16);
constexpr size_t SMEM_BYTES = A_BYTES + B_BYTES + Z_BYTES + S_BYTES;
static_assert(A_BYTES >= TM * KC * sizeof(float), "A region");
static_assert(B_BYTES >= KC * NT * sizeof(float), "B region");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void split(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

// A 64 x 128 f32 product tile: wmma fragments (F32 = false) or an FFMA
// register tile (F32 = true), with the same staged-slice interface.
template <bool F32>
struct Tile;

template <>
struct Tile<false> {
  FragC c[4];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(c[j], 0.0f);
  }
  // acc += A[:, k0 : k0 + depth] @ B[0 : depth, :], A hi/lo row-major
  // (stride lda), B hi/lo row-major (stride LDB), depth a multiple of 16.
  __device__ void mma(const bf16* ahi, const bf16* alo, int lda,
                      const bf16* bhi, const bf16* blo, int depth,
                      int passes) {
    const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
    for (int kk = 0; kk < depth; kk += 16) {
      FragA fa_hi, fa_lo;
      wmma::load_matrix_sync(fa_hi, ahi + wm * 16 * lda + kk, lda);
      if (passes >= 3) wmma::load_matrix_sync(fa_lo, alo + wm * 16 * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n0 = wn * 64 + j * 16;
        FragB fb;
        wmma::load_matrix_sync(fb, bhi + kk * LDB + n0, LDB);
        wmma::mma_sync(c[j], fa_hi, fb, c[j]);
        if (passes >= 3) wmma::mma_sync(c[j], fa_lo, fb, c[j]);
        if (passes >= 2) {
          wmma::load_matrix_sync(fb, blo + kk * LDB + n0, LDB);
          wmma::mma_sync(c[j], fa_hi, fb, c[j]);
        }
      }
    }
  }
  __device__ void store(float* z) const {
    const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(z + wm * 16 * LDZ + wn * 64 + j * 16, c[j], LDZ,
                              wmma::mem_row_major);
  }
};

template <>
struct Tile<true> {
  float c[8][4];                 // rows ty*8 + i, columns tx + 32*j
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  }
  // acc += A[:, k0 : k0 + depth] @ B[0 : depth, :], A f32 (stride lda),
  // B f32 row-major (stride NT).
  __device__ void fma(const float* a, int lda, const float* b, int depth) {
    const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
    for (int kk = 0; kk < depth; ++kk) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a[(ty * 8 + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b[kk * NT + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }
  __device__ void store(float* z) const {
    const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[(ty * 8 + i) * LDZ + tx + 32 * j] = c[i][j];
  }
};

// One slice of a product's operands travels device memory -> registers ->
// shared memory: each thread loads its share with 16-byte loads, and
// stores it (the signal split into hi/lo) once the block is done with the
// previous slice, so the loads of slice i + 1 are in flight during the
// products of slice i.

// The signal slice: rows r0 + s .. of ext, lanes lane0 .. lane0 + KC
// (zeros for rows at or past `valid` and lanes at or past `left`), two
// float4 per thread.
__device__ __forceinline__ void load_signal(float4 (&v)[2],
                                            const float* __restrict__ mrows,
                                            const float* __restrict__ brows,
                                            int W, int TR, int r0, int valid,
                                            int s, int lane0, int left) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (KC / 4), c = i % (KC / 4) * 4;
    v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid && c < left) {   // left is a multiple of 16
      const int e = r0 + r + s;    // ext row
      const float* src = e < TR ? mrows + static_cast<size_t>(e) * W
                                : brows + (e - TR) * W;
      v[j] = *reinterpret_cast<const float4*>(src + lane0 + c);
    }
  }
}

template <bool F32>
__device__ __forceinline__ void store_signal(const float4 (&v)[2], bf16* hi,
                                             bf16* lo, float* f) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (KC / 4), c = i % (KC / 4) * 4;
    if constexpr (F32) {
      *reinterpret_cast<float4*>(f + r * KC + c) = v[j];
    } else {
      bf16* h = hi + r * LDA + c;
      bf16* l = lo + r * LDA + c;
      split(v[j].x, h, l);
      split(v[j].y, h + 1, l + 1);
      split(v[j].z, h + 2, l + 2);
      split(v[j].w, h + 3, l + 3);
    }
  }
}

// The matrix slice: rows r0 .. r0 + KC (zeros from `left` on) and columns
// c0 .. c0 + NT of a row-major [*, ld] matrix, bf16 hi/lo (two uint4 of
// each per thread; no lo: zeros) or f32 (four float4 per thread).
template <bool F32>
struct MatrixSlice;

template <>
struct MatrixSlice<false> {
  uint4 h[2], l[2];
  __device__ __forceinline__ void load(const bf16* __restrict__ hi,
                                       const bf16* __restrict__ lo,
                                       const float* __restrict__, int ld,
                                       int r0, int left, int c0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int kk = i / (NT / 8), n = i % (NT / 8) * 8;
      h[j] = l[j] = make_uint4(0, 0, 0, 0);
      if (kk < left) {
        const size_t g = static_cast<size_t>(r0 + kk) * ld + c0 + n;
        h[j] = *reinterpret_cast<const uint4*>(hi + g);
        if (lo != nullptr) l[j] = *reinterpret_cast<const uint4*>(lo + g);
      }
    }
  }
  __device__ __forceinline__ void store(bf16* bh, bf16* bl, float*) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int kk = i / (NT / 8), n = i % (NT / 8) * 8;
      *reinterpret_cast<uint4*>(bh + kk * LDB + n) = h[j];
      *reinterpret_cast<uint4*>(bl + kk * LDB + n) = l[j];
    }
  }
};

template <>
struct MatrixSlice<true> {
  float4 f[4];
  __device__ __forceinline__ void load(const bf16* __restrict__,
                                       const bf16* __restrict__,
                                       const float* __restrict__ m, int ld,
                                       int r0, int left, int c0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int kk = i / (NT / 4), n = i % (NT / 4) * 4;
      f[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kk < left)
        f[j] = *reinterpret_cast<const float4*>(
            m + static_cast<size_t>(r0 + kk) * ld + c0 + n);
    }
  }
  __device__ __forceinline__ void store(bf16*, bf16*, float* bf) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int kk = i / (NT / 4), n = i % (NT / 4) * 4;
      *reinterpret_cast<float4*>(bf + kk * NT + n) = f[j];
    }
  }
};

template <bool DF32, bool MF32>
__global__ void __launch_bounds__(THREADS, 2)
anatomy_kernel(const float* __restrict__ sig, const float* __restrict__ bnd,
               int R, int W, int nblk, int H, Terms terms,
               const bf16* __restrict__ d_hi, const bf16* __restrict__ d_lo,
               const float* __restrict__ d_f32, int NC,
               const bf16* __restrict__ fb_hi, const bf16* __restrict__ fb_lo,
               const float* __restrict__ fb_f32, int dft_passes,
               int mel_passes, int tail, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_hi = reinterpret_cast<bf16*>(smem);             // [TM, LDA]
  bf16* a_lo = a_hi + TM * LDA;
  float* a_f = reinterpret_cast<float*>(smem);            // [TM, KC]
  bf16* b_hi = reinterpret_cast<bf16*>(smem + A_BYTES);   // [KC, LDB]
  bf16* b_lo = b_hi + KC * LDB;
  float* b_f = reinterpret_cast<float*>(smem + A_BYTES);  // [KC, NT]
  float* zc = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES);  // [TM, LDZ]
  bf16* s_hi = reinterpret_cast<bf16*>(smem + A_BYTES + B_BYTES + Z_BYTES);
  bf16* s_lo = s_hi + TM * LDS;                           // [TM, LDS] each

  const int TR = R / nblk;
  const int tiles = (TR + TM - 1) / TM;
  const int blk = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * TM;   // first row of the tile
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const int valid = min(TM, TR - r0);
  const float* mrows = sig + (static_cast<size_t>(b) * R + blk * TR) * W;
  const float* brows =
      bnd + (static_cast<size_t>(b) * nblk + blk) * ROWS_BND * W;
  const bool dftonly = tail == 3;

  Tile<MF32> mel;
  mel.zero();
  for (int c0 = 0; c0 < NC; c0 += NT) {
    // 1. z[:, c0 : c0 + NT] over the phase's terms, KC deep at a time
    Tile<DF32> z;
    z.zero();
    // the slices of every term, in order; slice (t, k0) is fetched while
    // the one before it is multiplied
    const int n_terms = terms.n[p];
    float4 sa[2];
    MatrixSlice<DF32> sb;
    auto fetch = [&](int t, int k0) {
      const int K = terms.k[p][t];
      load_signal(sa, mrows, brows, W, TR, r0, valid, terms.s[p][t],
                  terms.a[p][t] + k0, K - k0);
      sb.load(d_hi, d_lo, d_f32, NC, terms.row[p][t] + k0, K - k0, c0);
    };
    fetch(0, 0);
    for (int t = 0, k0 = 0; t < n_terms;) {
      const int depth = min(KC, terms.k[p][t] - k0);   // a multiple of 16
      __syncthreads();
      store_signal<DF32>(sa, a_hi, a_lo, a_f);
      sb.store(b_hi, b_lo, b_f);
      __syncthreads();
      k0 += KC;
      if (k0 >= terms.k[p][t]) {
        ++t;
        k0 = 0;
      }
      if (t < n_terms) fetch(t, k0);
      if constexpr (DF32) {
        z.fma(a_f, KC, b_f, depth);
      } else {
        z.mma(a_hi, a_lo, LDA, b_hi, b_lo, depth, dft_passes);
      }
    }
    __syncthreads();
    z.store(zc);
    __syncthreads();
    if (dftonly) break;

    // 2. the squared chunk, split for a bf16 mel product, then its share
    // of m = sq @ FB
    for (int i = threadIdx.x; i < TM * NT; i += THREADS) {
      const int r = i / NT, n = i % NT;
      const float v = zc[r * LDZ + n];
      const float sq = __fmul_rn(v, v);
      if constexpr (MF32) {
        zc[r * LDZ + n] = sq;
      } else {
        split(sq, s_hi + r * LDS + n, s_lo + r * LDS + n);
      }
    }
    MatrixSlice<MF32> fs;
    fs.load(fb_hi, fb_lo, fb_f32, NT, c0, KC, 0);
    for (int k0 = 0; k0 < NT; k0 += KC) {
      __syncthreads();
      fs.store(b_hi, b_lo, b_f);
      __syncthreads();
      if (k0 + KC < NT) fs.load(fb_hi, fb_lo, fb_f32, NT, c0 + k0 + KC, KC, 0);
      if constexpr (MF32) {
        mel.fma(zc + k0, LDZ, b_f, KC);
      } else {
        mel.mma(s_hi + k0, s_lo + k0, LDS, b_hi, b_lo, KC, mel_passes);
      }
    }
  }

  // 3. the tail, for the tile's valid rows
  if (!dftonly) {
    __syncthreads();
    mel.store(zc);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < valid * NT; i += THREADS) {
    const int r = i / NT, n = i % NT;
    float v = zc[r * LDZ + n];
    if (tail == 0) {
      v = log10f(fmaxf(__fadd_rn(__fmul_rn(v, v), 1e-10f), 1e-10f));
    } else if (tail == 1) {
      v = log10f(fmaxf(v, 1e-10f));
    }
    const size_t frame = static_cast<size_t>(blk * TR + r0 + r) * H + p;
    out[(static_cast<size_t>(b) * R * H + frame) * NT + n] = v;
  }
}

template <bool DF32, bool MF32>
int launch(const float* sig, const float* bnd, int B, int R, int W, int nblk,
           int H, const Terms& terms, const bf16* d_hi, const bf16* d_lo,
           const float* d_f32, int NC, const bf16* fb_hi, const bf16* fb_lo,
           const float* fb_f32, int dft_passes, int mel_passes, int tail,
           float* out, cudaStream_t stream) {
  auto kernel = anatomy_kernel<DF32, MF32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TR = R / nblk;
  const dim3 grid(nblk * ((TR + TM - 1) / TM), H, B);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      sig, bnd, R, W, nblk, H, terms, d_hi, d_lo, d_f32, NC, fb_hi, fb_lo,
      fb_f32, dft_passes, mel_passes, tail, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool DF32, bool MF32>
int resources(int* smem_bytes, int* blocks_per_sm) {
  auto kernel = anatomy_kernel<DF32, MF32>;
  *smem_bytes = static_cast<int>(SMEM_BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, THREADS, SMEM_BYTES));
}

}  // namespace

// K5a-h: main [B, R, W], bnd [B, nblk, 8, W] -> out [B, R*H, NM = 128].
// table: host int [MAXH][MAXT][4] of (s, a, K, first matrix row); counts:
// host int [MAXH] terms per phase. dft_mode / mel_mode: 0 f32, else the
// number of bf16 passes (1-3). tail: 0 sqlog, 1 log, 2 nolog, 3 dftonly.
extern "C" int tpufeat_anatomy_features(
    int device, const float* sig, const float* bnd, int B, int R, int W,
    int nblk, int H, const int* table, const int* counts, const void* d_hi,
    const void* d_lo, const float* d_f32, int NC, const void* fb_hi,
    const void* fb_lo, const float* fb_f32, int NM, int dft_mode,
    int mel_mode, int tail, float* out, void* stream) {
  if (NM != NT || NC % NT != 0 || H < 1 || H > MAXH || nblk < 1 ||
      R % nblk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Terms terms = {};
  for (int p = 0; p < H; ++p) {
    terms.n[p] = counts[p];
    for (int t = 0; t < counts[p]; ++t) {
      const int* e = table + (p * MAXT + t) * 4;
      terms.s[p][t] = e[0];
      terms.a[p][t] = e[1];
      terms.k[p][t] = e[2];
      terms.row[p][t] = e[3];
    }
  }
  const auto dh = static_cast<const bf16*>(d_hi);
  const auto dl = static_cast<const bf16*>(d_lo);
  const auto fh = static_cast<const bf16*>(fb_hi);
  const auto fl = static_cast<const bf16*>(fb_lo);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool df = dft_mode == 0, mf = mel_mode == 0;
  if (df && mf)
    return launch<true, true>(sig, bnd, B, R, W, nblk, H, terms, dh, dl,
                              d_f32, NC, fh, fl, fb_f32, dft_mode, mel_mode,
                              tail, out, st);
  if (df)
    return launch<true, false>(sig, bnd, B, R, W, nblk, H, terms, dh, dl,
                               d_f32, NC, fh, fl, fb_f32, dft_mode, mel_mode,
                               tail, out, st);
  if (mf)
    return launch<false, true>(sig, bnd, B, R, W, nblk, H, terms, dh, dl,
                               d_f32, NC, fh, fl, fb_f32, dft_mode, mel_mode,
                               tail, out, st);
  return launch<false, false>(sig, bnd, B, R, W, nblk, H, terms, dh, dl,
                              d_f32, NC, fh, fl, fb_f32, dft_mode, mel_mode,
                              tail, out, st);
}

// The kernel's dynamic shared memory per block and how many blocks fit on
// one SM of the current device, for an f32 (1) or bf16 (0) DFT and mel.
extern "C" int tpufeat_anatomy_resources(int dft_f32, int mel_f32,
                                         int* smem_bytes, int* blocks_per_sm) {
  if (dft_f32 && mel_f32) return resources<true, true>(smem_bytes, blocks_per_sm);
  if (dft_f32) return resources<true, false>(smem_bytes, blocks_per_sm);
  if (mel_f32) return resources<false, true>(smem_bytes, blocks_per_sm);
  return resources<false, false>(smem_bytes, blocks_per_sm);
}
