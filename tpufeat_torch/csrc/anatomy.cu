// The phase-kernel anatomy family for Hopper (sm_90a): warpgroup bf16
// tensor-core products (wgmma.mma_async, f32 sums), the matrices fed by
// bulk copies on mbarriers, in a persistent, warp-specialised grid.
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
// A product of P bf16 passes (P = 1, 2, 3 or 6) is the first P terms of
// hi.hi + hi.lo + lo.hi + hi.lo2 + lo.lo + lo2.hi (kernels/signal.py
// PASS_ORDER) over the pieces hi = bf16_rn(x), lo = bf16_rn(x - hi),
// lo2 = bf16_rn(x - hi - lo) of each operand: made here for the signal and
// for z*z (rounded to f32 once), packed on the host for the matrices.
// P = 6 is the TPU's Precision.HIGHEST (XLA's six-pass f32 emulation).
//
// What bounds it on an H100 at the phase scripts' shapes (B = 128, 3072
// frames, NC = 512, NM = 128): tensor operations. bf16x3 is 7.73e11 FLOP,
// 0.782 ms at the published 989 TFLOP/s bf16 dense peak; bf16x6 1.55e12,
// 1.563 ms; every mode moves about 0.46 GB (the signal once, the features
// once), 0.14 ms at 3.35 TB/s.
//
// The design, for that bound:
//   - a work item is TM = 128 rows of one phase of one block of one
//     utterance; a persistent grid (one CTA per SM) walks the items
//     phase-major, so the phase's matrices stay hot in L2 while every CTA
//     works on it;
//   - a CTA is one producer thread (of a third warpgroup, which gives its
//     registers up with setmaxnreg) and two consumer warpgroups of 64 rows
//     each, which share every staged matrix slice;
//   - the producer keeps a ring of matrix slices in flight with bulk copies
//     (cp.async.bulk, completion on a "full" mbarrier; the consumers free a
//     slot on an "empty" one): 64 rows of the depth of a packed DFT block
//     of 64 columns (two blocks at one signal piece), or of an FB block of
//     128, each bf16 piece laid out on the host in the 128-byte-swizzled
//     K-major layout that wgmma reads (kernels/anatomy.py pack_blocks);
//   - each consumer warpgroup stages its own 64 signal rows of a term
//     slice (64 lanes, f32) with cp.async a slice ahead: rows that cross
//     the block's end come from bnd, rows past it and lanes past the term
//     are zeros;
//   - z is built in chunks of 64 columns (m64n64k16; 128 at one signal
//     piece, bf16x1-x2): the signal's A fragments are loaded from the
//     staged slice and split in registers; the first pass (hi.hi) goes
//     into z's accumulator and the others, in PASS_ORDER, into a second
//     one that is added to it (f32, round to nearest) when the chunk is
//     done. The tensor cores' f32 sums
//     lose up to an ulp a product, so one accumulator for all six passes
//     put six times the rounding into z; apart, z's own accumulator takes
//     one product a 16-deep step;
//   - z*z never leaves the registers: the z accumulator's layout is the A
//     fragment layout of the mel product (k = z's columns), so each half's
//     square is split in registers and fed as wgmma's register A operand
//     against FB's packed slice (two m64n64k16 halves of the 128 bands),
//     its passes after the first into a second sum added after each half;
//   - the tail, from the mel accumulators, straight to device memory.
// z and the squared spectrum never reach device memory, no sum is split
// across CTAs and the order of every sum is fixed, so an output row's bits
// depend neither on the CTA that computes it nor on the launch.
// What it leaves (PERF.md): about a quarter of the bound at bf16x3
// and a third at bf16x6. Each item stages its signal again for every
// chunk of z (eight times at NC = 512, four at one signal piece) and
// reads its phase's matrix pieces from L2; a stage takes about 2 us
// whatever its passes, and neither three signal slices in flight nor a
// ring twice as deep moved it; two 64-column blocks a chunk halve the
// stages but fit the registers only at one signal piece.
//
// The entry points have a plain C interface (loaded with ctypes) and
// return the CUDA error code of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAXH = 4;          // phases: kernels/anatomy.py MAX_PHASES
constexpr int MAXT = 4;          // terms per phase: MAX_TERMS
constexpr int ROWS_BND = 8;      // bnd rows per block
constexpr int TM = 128;          // rows per work item
constexpr int NT = 128;          // NM: kernels/anatomy.py COLS
constexpr int NZ = 64;           // columns of a packed DFT block: ZCOLS
constexpr int KS = 64;           // depth of a staged slice: SLICE
constexpr int KSTEP = 16;        // depth of one wgmma
constexpr int D_PIECE = NZ * KS;               // a DFT block's piece
constexpr int D_BYTES = D_PIECE * 2;           // 8 KB
constexpr int FB_PIECE = NT * KS;              // an FB block's piece
constexpr int PIECE_BYTES = FB_PIECE * 2;      // 16 KB: an FB piece
constexpr int CONSUMERS = 2;     // consumer warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int EMPTY_ARRIVALS = CONSUMERS * 4;  // one per consumer warp
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// Shared memory at NA signal pieces: the ring of matrix slices (a stage
// holds the first PIECES pieces of NH packed DFT blocks, or of one FB
// block), then each consumer warpgroup's two signal slices; 1024-byte
// aligned, as the 128-byte swizzle's 8-row atom needs.
constexpr int A_SLICE = 64 * KS;               // floats: 64 rows x 64 lanes
constexpr int A_BYTES = CONSUMERS * 2 * A_SLICE * 4;   // 65,536
template <int NA>
struct Ring {
  static constexpr int PIECES = NA == 3 ? 3 : 2;
  static constexpr int STAGE = PIECES * PIECE_BYTES;
  static constexpr int STAGES = NA == 3 ? 3 : 4;
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(STAGES) * STAGE +
                                 A_BYTES + 2 * STAGES * 8;
};

// Where lane c of row r of a staged signal slice sits: rows of 64 floats,
// their 16-byte chunks permuted by (r % 8) * 2, so that the fragment loads
// of 8 rows hit 32 banks.
__host__ __device__ constexpr int a_index(int r, int c) {
  return r * KS + ((c / 4) ^ ((r % 8) * 2)) * 4 + c % 4;
}

struct Terms {
  int n[MAXH];                   // terms of each phase
  int s[MAXH][MAXT];             // row shift
  int a[MAXH][MAXT];             // lane offset
  int k[MAXH][MAXT];             // depth (a multiple of 16)
  int block[MAXH][MAXT];         // the term's first packed block
};

struct Args {
  const float* sig;              // [B, R, W]
  const float* bnd;              // [B, nblk, 8, W]
  int B, R, W, nblk, H;
  Terms terms;
  const bf16* d;                 // [blocks, d_pieces, 64 * 64]
  int d_pieces;
  const bf16* fb;                // [NC / 64, fb_pieces, 128 * 64]
  int fb_pieces;
  int NC;
  int dft_passes, mel_passes;
  int tail;                      // 0 sqlog, 1 log, 2 nolog, 3 dftonly
  float* out;                    // [B, R * H, 128]
};

// signal / matrix pieces of each pass, in PASS_ORDER
__host__ __device__ constexpr int pass_a(int q) {
  return q == 2 || q == 4 ? 1 : q == 5 ? 2 : 0;
}
__host__ __device__ constexpr int pass_b(int q) {
  return q == 1 || q == 4 ? 1 : q == 3 ? 2 : 0;
}
// pieces each operand needs at P passes
__host__ __device__ constexpr int a_pieces(int p) {
  return p <= 2 ? 1 : p == 3 ? 2 : 3;
}
__host__ __device__ constexpr int b_pieces(int p) {
  return p == 1 ? 1 : p <= 3 ? 2 : 3;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

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
// never completes ends the kernel with an error after 2^32 clocks (2-3 s)
// instead of hanging the card.
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

// wgmma's shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: 8-row groups 1024 bytes apart (the stride byte offset), the
// layout type in bits 62-63. A 16-deep step within the 64-deep rows is the
// start address plus 32 bytes.
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler's reads and writes of an accumulator on their side of
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += a (64 x 16, bf16, registers) . b (16 x 64, bf16,
// shared memory, K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The first NA bf16 pieces of (x0, x1), each as one bf16x2 register with x0
// in the low half: hi = bf16_rn(x), lo = bf16_rn(x - hi), lo2 =
// bf16_rn(x - hi - lo) (kernels/signal.py split_pieces; each difference is
// exact in f32).
template <int NA>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&out)[NA]) {
#pragma unroll
  for (int q = 0; q < NA; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[q] = *reinterpret_cast<const uint32_t*>(&h);
    if (q + 1 < NA) {
      x0 = __fsub_rn(x0, __low2float(h));
      x1 = __fsub_rn(x1, __high2float(h));
    }
  }
}

// The P passes of one 16-deep step, in PASS_ORDER: the first into `d`, the
// others into `dc`; b's pieces are `stride` bytes apart from `b0`.
template <int NA, int N>
__device__ __forceinline__ void step(float (&d)[N], float (&dc)[N],
                                     const uint32_t (&a)[NA][4],
                                     uint32_t b0, int stride, int passes) {
  wgmma_rs(d, a[0], b_desc(b0));
#pragma unroll
  for (int q = 1; q < 6; ++q) {
    if (q < passes)
      wgmma_rs(dc, a[pass_a(q) < NA ? pass_a(q) : 0],
               b_desc(b0 + pass_b(q) * stride));
  }
}

// 16 bytes from global to shared memory (cp.async), or 16 zero bytes
// where `bytes` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// the named barrier of one consumer warpgroup
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// An accumulator's rows `row` and `row + 8` of a work item (those below
// `valid`), through the tail, into the frames (item row r is frame r * H of
// `out`, which points at the item's first frame and this thread's first
// column): N / 4 pairs of columns 2tq + 8j a row.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], float* out,
                                           int row, int valid, int H,
                                           int tail) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= valid) continue;
    float* dst = out + static_cast<size_t>(r) * H * NT;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (tail == 0) {
        v0 = log10f(fmaxf(__fadd_rn(__fmul_rn(v0, v0), 1e-10f), 1e-10f));
        v1 = log10f(fmaxf(__fadd_rn(__fmul_rn(v1, v1), 1e-10f), 1e-10f));
      } else if (tail == 1) {
        v0 = log10f(fmaxf(v0, 1e-10f));
        v1 = log10f(fmaxf(v1, 1e-10f));
      }
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(v0, v1);
    }
  }
}

// One term slice of the signal for a consumer warpgroup's 64 rows of a
// work item: ext rows r0 + i + s (from bnd past the block's TR rows),
// lanes lane0 .. lane0 + width, zeros for rows at or past `valid` and lanes
// at or past `width`; 8 cp.async of 16 bytes a thread, one group.
struct SliceSrc {
  const float* mrows;   // the block's first row
  const float* brows;   // its bnd rows
  int W, TR, r0, valid;
};

__device__ __forceinline__ void load_slice(float* dst, const SliceSrc& src,
                                           int first, int s, int lane0,
                                           int width) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int chunk = t + 128 * m;
    const int r = chunk / 16, c4 = chunk % 16 * 4;
    const int i = first + r;                 // the item's row
    const int e = src.r0 + i + s;            // ext row
    const bool ok = i < src.valid && c4 < width;
    const float* from =
        !ok ? src.mrows
            : (e < src.TR ? src.mrows + static_cast<size_t>(e) * src.W
                          : src.brows + (e - src.TR) * src.W) + lane0 + c4;
    cp_async16(dst + a_index(r, c4), from, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The mel product's half h (mel columns 64h ..) of one chunk: z*z split
// into A fragments in registers, the first pass into `m`, the others into
// a second sum added to `m` (f32, round to nearest) at the end.
template <int NA>
__device__ __forceinline__ void mel_half(float (&m)[32], const float (&z)[32],
                                         uint32_t b0, int passes) {
  float mc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) mc[i] = 0.0f;
  fence_acc(m);
  fence_acc(mc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // register r: rows g / g + 8 of z's columns 16kk + 2tq (r = 0, 1),
    // then of 16kk + 8 + 2tq (r = 2, 3): accumulator pairs 8kk + 2r
    uint32_t fm[NA][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      uint32_t x[NA];
      split_pair<NA>(__fmul_rn(z[i], z[i]), __fmul_rn(z[i + 1], z[i + 1]),
                     x);
#pragma unroll
      for (int q = 0; q < NA; ++q) fm[q][r] = x[q];
    }
    wgmma_fence();
    step<NA>(m, mc, fm, b0 + kk * 32, PIECE_BYTES, passes);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(m);
  fence_acc(mc);
#pragma unroll
  for (int i = 0; i < 32; ++i) m[i] = __fadd_rn(m[i], mc[i]);
}

template <int NA>
__global__ void __launch_bounds__(THREADS, 1)
anatomy_kernel(__grid_constant__ const Args args, int items) {
  using RingT = Ring<NA>;
  // z's chunk: NH blocks of 64 columns, each signal slice staged once for
  // all of them. Two fit the consumers' 232 registers only with one signal
  // piece: beside two pieces, z, its second sum and the mel accumulators
  // spilled and serialized the products (PERF.md)
  constexpr int NH = NA == 1 ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  float* aslices = reinterpret_cast<float*>(
      smem + static_cast<size_t>(RingT::STAGES) * RingT::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(aslices + A_BYTES / 4);
  uint64_t* empty = full + RingT::STAGES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < RingT::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int TR = args.R / args.nblk;
  const int tiles = (TR + TM - 1) / TM;
  const int per_phase = args.B * args.nblk * tiles;
  const bool dftonly = args.tail == 3;
  // dftonly: z's first NM columns, no mel product
  const int chunks = (dftonly ? NT : args.NC) / (NZ * NH);
  const int nblocks = args.NC / NZ;    // DFT blocks per 64-deep slice
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  if (wg == CONSUMERS) {
    // ---- the producer: thread 0 of the last warpgroup, the matrix slices
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp != 0 || lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    const uint32_t d_bytes = b_pieces(args.dft_passes) * D_BYTES;
    const uint32_t fb_bytes =
        dftonly ? 0 : b_pieces(args.mel_passes) * PIECE_BYTES;
    // a stage: `n` blocks `stride` elements apart from `src`, each one's
    // first `bytes` at RingT::PIECES * D_BYTES apart in the slot
    auto put = [&](const bf16* src, size_t stride, int n, uint32_t bytes) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], n * bytes);
      for (int h = 0; h < n; ++h)
        bulk_load(smem + static_cast<size_t>(stage) * RingT::STAGE +
                      h * RingT::PIECES * D_BYTES,
                  src + h * stride, bytes, &full[stage]);
      if (++stage == RingT::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    const size_t d_block = static_cast<size_t>(args.d_pieces) * D_PIECE;
    const size_t fb_block = static_cast<size_t>(args.fb_pieces) * FB_PIECE;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int p = item / per_phase;
      for (int c = 0; c < chunks; ++c) {
        for (int t = 0; t < args.terms.n[p]; ++t) {
          const int ns = (args.terms.k[p][t] + KS - 1) / KS;
          for (int j = 0; j < ns; ++j)
            put(args.d + (args.terms.block[p][t] +
                          static_cast<size_t>(j) * nblocks + c * NH) *
                             d_block,
                d_block, NH, d_bytes);
        }
        for (int h = 0; h < (dftonly ? 0 : NH); ++h)
          put(args.fb + (static_cast<size_t>(c) * NH + h) * fb_block, 0, 1,
              fb_bytes);
      }
    }
  } else {
    // ---- a consumer warpgroup: rows 64 * wg .. of each item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    int stage = 0;
    uint32_t phase = 0;
    const int g = lane / 4, tq = lane % 4;
    const int row = 16 * warp + g;            // of the warpgroup's 64
    float* abuf = aslices + wg * 2 * A_SLICE; // two slices
    auto take = [&]() {
      mbar_wait(&full[stage], phase);
      return smem_addr(smem + static_cast<size_t>(stage) * RingT::STAGE);
    };
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == RingT::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int p = item / per_phase;
      const int rem = item % per_phase;
      const int b = rem / (args.nblk * tiles);
      const int blk = rem / tiles % args.nblk;
      const int r0 = rem % tiles * TM;
      const SliceSrc src = {
          args.sig + (static_cast<size_t>(b) * args.R + blk * TR) * args.W,
          args.bnd + (static_cast<size_t>(b) * args.nblk + blk) * ROWS_BND *
                         args.W,
          args.W, TR, r0, min(TM, TR - r0)};
      const int nt = args.terms.n[p];
      // the item's signal slices in order: (chunk, term, slice), each one
      // loaded while the one before it is multiplied
      const int total = chunks * [&]() {
        int s = 0;
        for (int t = 0; t < nt; ++t) s += (args.terms.k[p][t] + KS - 1) / KS;
        return s;
      }();
      int lt = 0, lj = 0, n = 0;
      auto load_next = [&]() {
        const int K = args.terms.k[p][lt];
        load_slice(abuf + (n & 1) * A_SLICE, src, 64 * wg,
                   args.terms.s[p][lt], args.terms.a[p][lt] + lj * KS,
                   min(KS, K - lj * KS));
        ++n;
        lj += 1;
        if (lj * KS >= K) {
          lj = 0;
          lt = lt + 1 == nt ? 0 : lt + 1;
        }
      };
      wg_sync(wg);   // the last item's slices are read
      load_next();
      int used = 0;
      float mel[2][32];    // mel columns 0-63 and 64-127
#pragma unroll
      for (int i = 0; i < 32; ++i) mel[0][i] = mel[1][i] = 0.0f;
      float* out = args.out +
                   (static_cast<size_t>(b) * args.R + blk * TR + r0) *
                       args.H * NT +
                   p * NT + 2 * tq;
      for (int c = 0; c < chunks; ++c) {
        // 1. z's chunk over the phase's terms, 64 deep a slice
        float z[NH][32], zc[NH][32];
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int i = 0; i < 32; ++i) z[h][i] = zc[h][i] = 0.0f;
        for (int t = 0; t < nt; ++t) {
          const int K = args.terms.k[p][t];
          for (int k0 = 0; k0 < K; k0 += KS) {
            const int steps = min(KS, K - k0) / KSTEP;
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
            wg_sync(wg);   // the slice is in; the one before it is free
            const float* arows = abuf + (used & 1) * A_SLICE;
            ++used;
            if (n < total) load_next();
            const uint32_t b0 = take();
#pragma unroll
            for (int h = 0; h < NH; ++h) {
              fence_acc(z[h]);
              fence_acc(zc[h]);
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              if (kk < steps) {
                // A fragment registers: (row, col), (row + 8, col),
                // (row, col + 8), (row + 8, col + 8), col = 16kk + 2tq
                uint32_t fa[NA][4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const float2 v = *reinterpret_cast<const float2*>(
                      arows + a_index(row + (r & 1) * 8,
                                      kk * KSTEP + 2 * tq + (r >> 1) * 8));
                  uint32_t x[NA];
                  split_pair<NA>(v.x, v.y, x);
#pragma unroll
                  for (int q = 0; q < NA; ++q) fa[q][r] = x[q];
                }
                wgmma_fence();
#pragma unroll
                for (int h = 0; h < NH; ++h)
                  step<NA>(z[h], zc[h], fa,
                           b0 + h * RingT::PIECES * D_BYTES + kk * 32,
                           D_BYTES, args.dft_passes);
              }
            }
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int h = 0; h < NH; ++h) {
              fence_acc(z[h]);
              fence_acc(zc[h]);
            }
            release();
          }
        }
#pragma unroll
        for (int h = 0; h < NH; ++h) {
#pragma unroll
          for (int i = 0; i < 32; ++i) z[h][i] = __fadd_rn(z[h][i], zc[h][i]);
          if (dftonly) {
            store_rows(z[h], out + (c * NH + h) * NZ, row + 64 * wg,
                       src.valid, args.H, 3);
            continue;
          }
          // 2. the share of m = (z*z) @ FB of z's 64 columns, FB's 128
          // columns as two halves of 64 (8 KB apart in each piece)
          const uint32_t b0 = take();
          mel_half<NA>(mel[0], z[h], b0, args.mel_passes);
          mel_half<NA>(mel[1], z[h], b0 + 64 * 128, args.mel_passes);
          release();
        }
      }

      // 3. the tail, for the item's valid rows
      if (!dftonly) {
        store_rows(mel[0], out, row + 64 * wg, src.valid, args.H, args.tail);
        store_rows(mel[1], out + 64, row + 64 * wg, src.valid, args.H,
                   args.tail);
      }
    }
  }
}

// The registers the warp-specialised split needs at launch: setmaxnreg
// moves them between warpgroups of the CTA's own allocation.
constexpr int LAUNCH_REGS =
    (128 * PRODUCER_REGS + CONSUMERS * 128 * CONSUMER_REGS) / THREADS;

template <int NA>
int prepare(cudaFuncAttributes* attr) {
  auto kernel = anatomy_kernel<NA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Ring<NA>::SMEM));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(attr, kernel);
  return static_cast<int>(err);
}

template <int NA>
int launch(const Args& args, cudaStream_t stream) {
  cudaFuncAttributes attr;
  int err = prepare<NA>(&attr);
  if (err) return err;
  // fewer registers at launch than the consumers ask for would stall
  // setmaxnreg: refuse to launch
  if (attr.numRegs < LAUNCH_REGS)
    return static_cast<int>(cudaErrorLaunchOutOfResources);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int TR = args.R / args.nblk;
  const int items = args.H * args.B * args.nblk * ((TR + TM - 1) / TM);
  const int grid = items < sms ? items : sms;
  anatomy_kernel<NA><<<grid, THREADS, Ring<NA>::SMEM, stream>>>(args, items);
  return static_cast<int>(cudaGetLastError());
}

int signal_pieces(int dft_passes, int mel_passes) {
  const int a = a_pieces(dft_passes);
  const int m = mel_passes ? a_pieces(mel_passes) : 1;
  return a > m ? a : m;
}

bool valid_passes(int p) { return p == 1 || p == 2 || p == 3 || p == 6; }

}  // namespace

// K5a-h: main [B, R, W], bnd [B, nblk, 8, W] -> out [B, R*H, NM = 128].
// table: host int [MAXH][MAXT][4] of (s, a, K, first packed block); counts:
// host int [MAXH] terms per phase. d / fb: the packed blocks
// (kernels/anatomy.py pack_blocks) with d_pieces / fb_pieces pieces each.
// dft_passes / mel_passes: 1, 2, 3 or 6 bf16 passes (mel_passes 0 with
// dftonly). tail: 0 sqlog, 1 log, 2 nolog, 3 dftonly.
extern "C" int tpufeat_anatomy_features(
    int device, const float* sig, const float* bnd, int B, int R, int W,
    int nblk, int H, const int* table, const int* counts, const void* d,
    int d_pieces, const void* fb, int fb_pieces, int NC, int NM,
    int dft_passes, int mel_passes, int tail, float* out, void* stream) {
  const bool dftonly = tail == 3;
  if (NM != NT || NC % NT != 0 || H < 1 || H > MAXH || nblk < 1 ||
      R % nblk != 0 || B < 1 || W % 4 != 0 || tail < 0 || tail > 3 ||
      !valid_passes(dft_passes) || b_pieces(dft_passes) > d_pieces ||
      (!dftonly && (!valid_passes(mel_passes) ||
                    b_pieces(mel_passes) > fb_pieces)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args args = {};
  args.sig = sig;
  args.bnd = bnd;
  args.B = B;
  args.R = R;
  args.W = W;
  args.nblk = nblk;
  args.H = H;
  for (int p = 0; p < H; ++p) {
    if (counts[p] < 1 || counts[p] > MAXT)
      return static_cast<int>(cudaErrorInvalidValue);
    args.terms.n[p] = counts[p];
    for (int t = 0; t < counts[p]; ++t) {
      const int* e = table + (p * MAXT + t) * 4;
      if (e[0] < 0 || e[0] > ROWS_BND || e[1] < 0 || e[1] % 4 ||
          e[2] < KSTEP || e[2] % KSTEP || e[1] + e[2] > W)
        return static_cast<int>(cudaErrorInvalidValue);
      args.terms.s[p][t] = e[0];
      args.terms.a[p][t] = e[1];
      args.terms.k[p][t] = e[2];
      args.terms.block[p][t] = e[3];
    }
  }
  args.d = static_cast<const bf16*>(d);
  args.d_pieces = d_pieces;
  args.fb = static_cast<const bf16*>(fb);
  args.fb_pieces = fb_pieces;
  args.NC = NC;
  args.dft_passes = dft_passes;
  args.mel_passes = dftonly ? 0 : mel_passes;
  args.tail = tail;
  args.out = out;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (signal_pieces(dft_passes, args.mel_passes)) {
    case 1: return launch<1>(args, st);
    case 2: return launch<2>(args, st);
    default: return launch<3>(args, st);
  }
}

// The launch of the kernel for these pass counts on the current device:
// dynamic shared memory per block, blocks per SM, registers per thread at
// launch, and local memory per thread (spills; 0 when none).
extern "C" int tpufeat_anatomy_resources(int dft_passes, int mel_passes,
                                         int* smem_bytes, int* blocks_per_sm,
                                         int* regs, int* local_bytes) {
  if (!valid_passes(dft_passes) || (mel_passes && !valid_passes(mel_passes)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  int err = 0;
  const void* kernel = nullptr;
  size_t smem = 0;
  switch (signal_pieces(dft_passes, mel_passes)) {
    case 1:
      err = prepare<1>(&attr);
      kernel = reinterpret_cast<const void*>(anatomy_kernel<1>);
      smem = Ring<1>::SMEM;
      break;
    case 2:
      err = prepare<2>(&attr);
      kernel = reinterpret_cast<const void*>(anatomy_kernel<2>);
      smem = Ring<2>::SMEM;
      break;
    default:
      err = prepare<3>(&attr);
      kernel = reinterpret_cast<const void*>(anatomy_kernel<3>);
      smem = Ring<3>::SMEM;
  }
  if (err) return err;
  *smem_bytes = static_cast<int>(smem);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, THREADS, smem));
}
