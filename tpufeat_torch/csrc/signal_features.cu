// Spectro-feature kernels for Hopper (sm_90a), fp32 FFMA.
//
// Replaces the four TPU kernel bodies of tpufeat/pallas/fused.py:
//   - signal_features -> _signal_kernel (v4 hop-split layout) and
//     _signal_features_phase -> _phase_signal_kernel (v5 phase-packed
//     layout): signal_features_kernel below. Those layouts exist only to fit
//     TPU lanes; here one block reads its overlapping frames straight out of
//     a staged signal span.
//   - dft_mel_log_dct -> _full_kernel (the staged GEMM kernel): the SAME
//     signal_features_kernel and entry point, launched over rows [R, fl] as
//     the buffer [1, R*fl] with hop = fl, and given the combined DFT matrix
//     without the kaldi fold (its frames arrive conditioned). No second copy
//     of the DFT code exists.
//   - mel_log_dct -> _tail_kernel (the tail after an rFFT): mel_log_dct_kernel
//     below, which stages spectrum rows and runs the same mel/log and DCT
//     device code as the signal kernel.
//
// signal_features_kernel: one block computes TF consecutive frames of one
// utterance:
//   1. stage span = buf[b, t0*hop : (t0+TF-1)*hop + fl] in shared memory,
//      zeros past M; frame f is the view span[f*hop : f*hop + fl], and no
//      sum reads a sample outside its own frame;
//   2. z[TF, nc] = frames @ CS (the combined windowed Re/Im DFT matrix, the
//      kaldi conditioning folded in for K1), CS streamed through shared
//      memory in KC-row chunks, each thread holding an FR x CR register tile;
//   3. power: z*z (the folded filterbank turns it into |X|^2 @ fb);
//      magnitude: |X_k| rebuilt in place from the Re/Im columns;
//   4. mel = spec @ fb, then log or log10 floored at log_floor, or no log
//      (mel_log_tile);
//   5. out = mel @ dct (MFCC) or mel (log-mel), for frames < n_frames
//      (store_features).
// Nothing but the signal span, the constants and the features touches
// device memory. The tile and the order of every sum are fixed and do not
// depend on the call's shape, so a frame's bits do not depend on where it
// falls in a call, and nothing is carried from one block to another.
//
// What bounds them on an H100: the DFT product is fp32-FLOP bound (about
// 2*fl*nc FLOP per frame against 4*hop bytes in); the tail kernel is
// load-bound (4*n_bins bytes in per row against 2*n_bins*n_mels FLOP). Both
// keep every intermediate in shared memory, so device memory sees only
// their inputs, the constants (through the read-only cache) and the
// features.
//
// The entry points have a plain C interface (loaded with ctypes) and return
// the CUDA error code of the launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TF = 32;       // frames (rows) per block: kernels/signal.py
                             // TILE_FRAMES
constexpr int THREADS = 256;
constexpr int TX = 64;       // threads across the DFT columns
constexpr int FR = 8;        // frames per thread in the DFT tile
constexpr int CR = 8;        // DFT columns per thread, TX apart
constexpr int CW = TX * CR;  // DFT columns per pass
constexpr int KC = 8;        // CS rows per staged chunk
constexpr int FM = 4;        // frames per thread in the mel product
static_assert((THREADS / TX) * FR == TF, "the DFT tile must cover TF frames");
static_assert(TF % FM == 0, "the mel tile must divide TF");

struct Layout {
  int span;      // floats of the staged signal span, rounded up to 4
  size_t bytes;  // dynamic shared memory of one block
};

Layout signal_layout(int hop, int fl, int nc, int nm) {
  Layout l;
  l.span = ((TF - 1) * hop + fl + 3) / 4 * 4;
  l.bytes = sizeof(float) *
            (static_cast<size_t>(l.span) + static_cast<size_t>(TF) * nc +
             static_cast<size_t>(KC) * CW + static_cast<size_t>(TF) * nm);
  return l;
}

size_t tail_bytes(int nb, int nm) {
  return sizeof(float) * static_cast<size_t>(TF) * (nb + nm);
}

// mel[TF, nm] = log(spec[TF, :spec_rows] @ fb) for the block's TF rows of
// spec (row stride nc), each output a fixed-order sum over spec_rows.
__device__ void mel_log_tile(const float* spec, int nc,
                             const float* __restrict__ fb, int spec_rows,
                             int nm, int log_kind, float log_floor,
                             float* mel) {
  for (int o = threadIdx.x; o < (TF / FM) * nm; o += THREADS) {
    const int g = o / nm, m = o % nm;
    const float* zr = spec + g * FM * nc;
    float acc[FM];
#pragma unroll
    for (int i = 0; i < FM; ++i) acc[i] = 0.0f;
    for (int c = 0; c < spec_rows; ++c) {
      const float w = __ldg(fb + static_cast<size_t>(c) * nm + m);
#pragma unroll
      for (int i = 0; i < FM; ++i) acc[i] = fmaf(zr[i * nc + c], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      float v = acc[i];
      if (log_kind == 1) {
        v = logf(fmaxf(v, log_floor));
      } else if (log_kind == 2) {
        v = log10f(fmaxf(v, log_floor));
      }
      mel[(g * FM + i) * nm + m] = v;
    }
  }
}

// The first `valid` rows of the block's features to orow: mel @ dct (the
// lifter folded in) when dct is given, else the log-mel as it is.
__device__ void store_features(const float* mel, int nm,
                               const float* __restrict__ dct, int d_out,
                               int valid, float* __restrict__ orow) {
  if (dct != nullptr) {
    for (int o = threadIdx.x; o < valid * d_out; o += THREADS) {
      const int f = o / d_out, d = o % d_out;
      const float* mr = mel + f * nm;
      float acc = 0.0f;
      for (int m = 0; m < nm; ++m)
        acc = fmaf(mr[m], __ldg(dct + static_cast<size_t>(m) * d_out + d), acc);
      orow[o] = acc;
    }
  } else {
    for (int o = threadIdx.x; o < valid * nm; o += THREADS) orow[o] = mel[o];
  }
}

// acc += frames[:, k] (x) srow: one DFT row k for the thread's FR x CR tile.
__device__ __forceinline__ void dft_row(const float* frames, int hop, int k,
                                        const float* srow,
                                        float (&acc)[FR][CR]) {
  const int tx = threadIdx.x % TX;
  float a[FR], w[CR];
#pragma unroll
  for (int i = 0; i < FR; ++i) a[i] = frames[i * hop + k];
#pragma unroll
  for (int j = 0; j < CR; ++j) w[j] = srow[j * TX + tx];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < CR; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
}

// One KC-row chunk of z = frames @ CS: stage CS rows k0 .. k0+KC-1 (zeros
// past fl or nc), then accumulate their rows. TAIL is the last chunk when
// fl % KC != 0: it runs only its fl - k0 rows, so a frame's sums never read
// a sample past its end (for K3, the next row, which may hold an Inf or a
// NaN). The full chunks are unrolled and carry no test.
template <bool TAIL>
__device__ __forceinline__ void dft_chunk(const float* __restrict__ cs,
                                          int nc, int fl, int k0, int c0,
                                          const float* frames, int hop,
                                          float* stage, float (&acc)[FR][CR]) {
  __syncthreads();
  for (int i = threadIdx.x; i < KC * CW; i += THREADS) {
    const int k = k0 + i / CW, c = c0 + i % CW;
    stage[i] = (k < fl && c < nc) ? cs[static_cast<size_t>(k) * nc + c]
                                  : 0.0f;
  }
  __syncthreads();
  if (TAIL) {
#pragma unroll 1
    for (int kk = 0; kk < fl - k0; ++kk)
      dft_row(frames, hop, k0 + kk, stage + kk * CW, acc);
  } else {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      dft_row(frames, hop, k0 + kk, stage + kk * CW, acc);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
signal_features_kernel(const float* __restrict__ buf, long long M,
                       int n_frames, int hop, int fl,
                       const float* __restrict__ cs, int nc,
                       const float* __restrict__ fb, int spec_rows, int nm,
                       int magnitude, int nb, int log_kind, float log_floor,
                       const float* __restrict__ dct, int d_out,
                       float* __restrict__ out, int span_len) {
  extern __shared__ float smem[];
  float* span = smem;                  // [span_len]
  float* z = span + span_len;          // [TF, nc]
  float* stage = z + TF * nc;          // [KC, CW]
  float* mel = stage + KC * CW;        // [TF, nm]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;

  // 1. the signal span, zeros past the end of the row
  const float* row = buf + static_cast<size_t>(b) * M;
  const long long s0 = static_cast<long long>(t0) * hop;
  for (int i = tid; i < span_len; i += THREADS) {
    const long long g = s0 + i;
    span[i] = g < M ? row[g] : 0.0f;
  }

  // 2. z = frames @ CS, in KC-row chunks (dft_chunk), the last one guarded
  // where fl % KC != 0
  const int ty = tid / TX, tx = tid % TX;
  const float* frames = span + ty * FR * hop;
  const int k_full = fl - fl % KC;
  for (int c0 = 0; c0 < nc; c0 += CW) {
    float acc[FR][CR];
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < CR; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < k_full; k0 += KC)
      dft_chunk<false>(cs, nc, fl, k0, c0, frames, hop, stage, acc);
    if (k_full < fl)
      dft_chunk<true>(cs, nc, fl, k_full, c0, frames, hop, stage, acc);
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < CR; ++j) {
        const int c = c0 + j * TX + tx;
        if (c < nc) {
          const float v = acc[i][j];
          z[(ty * FR + i) * nc + c] = magnitude ? v : __fmul_rn(v, v);
        }
      }
  }
  __syncthreads();

  // 3. magnitude: |X_k| = sqrt(Re^2 + Im^2) into column k < nb. Column k is
  // written only by its own thread, and the Im columns read (>= nb) are
  // never written, so the rebuild is safe in place.
  if (magnitude) {
    for (int i = tid; i < TF * nb; i += THREADS) {
      const int f = i / nb, k = i % nb;
      float* zr = z + f * nc;
      const float re = zr[k];
      float s = __fmul_rn(re, re);
      if (k >= 1 && k <= nb - 2) {
        const float im = zr[nb - 1 + k];
        s = __fadd_rn(s, __fmul_rn(im, im));
      }
      zr[k] = sqrtf(s);
    }
    __syncthreads();
  }

  // 4. mel = spec @ fb, then the log
  mel_log_tile(z, nc, fb, spec_rows, nm, log_kind, log_floor, mel);
  __syncthreads();

  // 5. the DCT (with the lifter folded in), or the log-mel as it is
  store_features(mel, nm, dct, d_out, min(TF, n_frames - t0),
                 out + (static_cast<size_t>(b) * n_frames + t0) * d_out);
}

// One block: TF spectrum rows -> shared memory -> mel_log_tile ->
// store_features. Rows past R are staged as zeros and never stored.
__global__ void __launch_bounds__(THREADS)
mel_log_dct_kernel(const float* __restrict__ rows, int R, int nb,
                   const float* __restrict__ fb, int nm, int log_kind,
                   float log_floor, const float* __restrict__ dct, int d_out,
                   float* __restrict__ out) {
  extern __shared__ float smem[];
  float* spec = smem;                  // [TF, nb]
  float* mel = spec + TF * nb;         // [TF, nm]

  const long long r0 = static_cast<long long>(blockIdx.x) * TF;
  const int valid = static_cast<int>(min(static_cast<long long>(TF), R - r0));
  const float* src = rows + r0 * nb;
  for (int i = threadIdx.x; i < TF * nb; i += THREADS)
    spec[i] = i < valid * nb ? src[i] : 0.0f;
  __syncthreads();
  mel_log_tile(spec, nb, fb, nb, nm, log_kind, log_floor, mel);
  __syncthreads();
  store_features(mel, nm, dct, d_out, valid, out + r0 * d_out);
}

int launch_signal(int device, const float* buf, int B, long long M,
                  int n_frames, int hop, int fl, const float* cs, int nc,
                  const float* fb, int spec_rows, int nm, int magnitude,
                  int nb, int log_kind, float log_floor, const float* dct,
                  int d_out, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout l = signal_layout(hop, fl, nc, nm);
  err = cudaFuncSetAttribute(signal_features_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(l.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + TF - 1) / TF, B);
  signal_features_kernel<<<grid, THREADS, l.bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      buf, M, n_frames, hop, fl, cs, nc, fb, spec_rows, nm, magnitude, nb,
      log_kind, log_floor, dct, d_out, out, l.span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1/K2: buf [B, M] -> features [B, n_frames, d_out].
// K3: conditioned frames [R, fl] -> features [R, d_out], as the buffer
// [1, R*fl] with n_frames = R and hop = fl.
extern "C" int tpufeat_signal_features(
    int device, const float* buf, int B, long long M, int n_frames, int hop,
    int fl, const float* cs, int nc, const float* fb, int spec_rows, int nm,
    int magnitude, int nb, int log_kind, float log_floor, const float* dct,
    int d_out, float* out, void* stream) {
  return launch_signal(device, buf, B, M, n_frames, hop, fl, cs, nc, fb,
                       spec_rows, nm, magnitude, nb, log_kind, log_floor, dct,
                       d_out, out, stream);
}

// K4: spectrum rows [R, nb] -> features [R, d_out].
extern "C" int tpufeat_mel_log_dct(int device, const float* rows, int R,
                                   int nb, const float* fb, int nm,
                                   int log_kind, float log_floor,
                                   const float* dct, int d_out, float* out,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = tail_bytes(nb, nm);
  err = cudaFuncSetAttribute(mel_log_dct_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + TF - 1) / TF);
  mel_log_dct_kernel<<<grid, THREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, R, nb, fb, nm, log_kind, log_floor, dct, d_out, out);
  return static_cast<int>(cudaGetLastError());
}

// The signal kernel's dynamic shared memory per block and how many blocks
// fit on one SM of the current device, for reports beside ptxas's -v lines.
// K3's launch is the one with hop = fl.
extern "C" int tpufeat_signal_resources(int hop, int fl, int nc, int nm,
                                        int* smem_bytes, int* blocks_per_sm) {
  const Layout l = signal_layout(hop, fl, nc, nm);
  *smem_bytes = static_cast<int>(l.bytes);
  cudaError_t err = cudaFuncSetAttribute(
      signal_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, signal_features_kernel, THREADS, l.bytes));
}

// The same for the tail kernel (K4).
extern "C" int tpufeat_tail_resources(int nb, int nm, int* smem_bytes,
                                      int* blocks_per_sm) {
  const size_t bytes = tail_bytes(nb, nm);
  *smem_bytes = static_cast<int>(bytes);
  cudaError_t err = cudaFuncSetAttribute(
      mel_log_dct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mel_log_dct_kernel, THREADS, bytes));
}

extern "C" const char* tpufeat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
