// Fused signal -> features kernel for Hopper (sm_90a), fp32 FFMA.
//
// Replaces the two TPU bodies of the signal-level kernel in
// tpufeat/pallas/fused.py: signal_features -> _signal_kernel (v4 hop-split
// layout) and _signal_features_phase -> _phase_signal_kernel (v5
// phase-packed layout). Those layouts exist only to fit TPU lanes; here one
// block reads its overlapping frames straight out of a staged signal span.
//
// One block computes TF consecutive frames of one utterance:
//   1. stage span = buf[b, t0*hop : (t0+TF-1)*hop + fl] in shared memory,
//      zeros past M; frame f is the view span[f*hop : f*hop + fl];
//   2. z[TF, nc] = frames @ CS (the combined windowed Re/Im DFT matrix, the
//      kaldi conditioning folded in), CS streamed through shared memory in
//      KC-row chunks, each thread holding an FR x CR register tile of z;
//   3. power: z*z (the folded filterbank turns it into |X|^2 @ fb);
//      magnitude: |X_k| rebuilt in place from the Re/Im columns;
//   4. mel = spec @ fb, then log or log10 floored at log_floor, or no log;
//   5. out = mel @ dct (MFCC) or mel (log-mel), for frames < n_frames.
// Nothing but the signal span, the constants and the features touches
// device memory. The tile and the order of every sum are fixed and do not
// depend on the call's shape, so a frame's bits do not depend on where it
// falls in a call, and nothing is carried from one block to another.
//
// The entry point has a plain C interface (loaded with ctypes) and returns
// the CUDA error code of the launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TF = 32;       // frames per block (kernels/signal.py TILE_FRAMES)
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
  int span;      // floats of the staged signal span (KC of slack, zeroed)
  size_t bytes;  // dynamic shared memory of one block
};

Layout layout(int hop, int fl, int nc, int nm) {
  Layout l;
  l.span = ((TF - 1) * hop + fl + KC + 3) / 4 * 4;
  l.bytes = sizeof(float) *
            (static_cast<size_t>(l.span) + static_cast<size_t>(TF) * nc +
             static_cast<size_t>(KC) * CW + static_cast<size_t>(TF) * nm);
  return l;
}

__global__ void __launch_bounds__(THREADS, 2)
signal_features_kernel(const float* __restrict__ buf, int M, int n_frames,
                       int hop, int fl, const float* __restrict__ cs, int nc,
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

  // 2. z = frames @ CS. Rows k >= fl of a chunk are staged as zeros, so the
  // unrolled chunk adds exact zeros past the frame's end.
  const int ty = tid / TX, tx = tid % TX;
  const float* frames = span + ty * FR * hop;
  for (int c0 = 0; c0 < nc; c0 += CW) {
    float acc[FR][CR];
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < CR; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < fl; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < KC * CW; i += THREADS) {
        const int k = k0 + i / CW, c = c0 + i % CW;
        stage[i] = (k < fl && c < nc) ? cs[static_cast<size_t>(k) * nc + c]
                                      : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float a[FR], w[CR];
#pragma unroll
        for (int i = 0; i < FR; ++i) a[i] = frames[i * hop + k0 + kk];
#pragma unroll
        for (int j = 0; j < CR; ++j) w[j] = stage[kk * CW + j * TX + tx];
#pragma unroll
        for (int i = 0; i < FR; ++i)
#pragma unroll
          for (int j = 0; j < CR; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
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
  for (int o = tid; o < (TF / FM) * nm; o += THREADS) {
    const int g = o / nm, m = o % nm;
    const float* zr = z + g * FM * nc;
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
  __syncthreads();

  // 5. the DCT (with the lifter folded in), or the log-mel as it is
  const int valid = min(TF, n_frames - t0);
  float* orow = out + (static_cast<size_t>(b) * n_frames + t0) * d_out;
  if (dct != nullptr) {
    for (int o = tid; o < valid * d_out; o += THREADS) {
      const int f = o / d_out, d = o % d_out;
      const float* mr = mel + f * nm;
      float acc = 0.0f;
      for (int m = 0; m < nm; ++m)
        acc = fmaf(mr[m], __ldg(dct + static_cast<size_t>(m) * d_out + d), acc);
      orow[o] = acc;
    }
  } else {
    for (int o = tid; o < valid * nm; o += THREADS) orow[o] = mel[o];
  }
}

}  // namespace

extern "C" int tpufeat_signal_features(
    int device, const float* buf, int B, int M, int n_frames, int hop, int fl,
    const float* cs, int nc, const float* fb, int spec_rows, int nm,
    int magnitude, int nb, int log_kind, float log_floor, const float* dct,
    int d_out, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout l = layout(hop, fl, nc, nm);
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

// The launch's dynamic shared memory per block and how many blocks fit on
// one SM of the current device, for reports beside ptxas's -v lines.
extern "C" int tpufeat_signal_resources(int hop, int fl, int nc, int nm,
                                        int* smem_bytes, int* blocks_per_sm) {
  const Layout l = layout(hop, fl, nc, nm);
  *smem_bytes = static_cast<int>(l.bytes);
  cudaError_t err = cudaFuncSetAttribute(
      signal_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, signal_features_kernel, THREADS, l.bytes));
}

extern "C" const char* tpufeat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
