// Folded + factored DR-NMF recurrence, the whole time scan in one launch.
//
// Replaces drnmf_tpu/ops/pallas/drnmf_scan.py::_kernel_factored (entry
// drnmf_scan_pallas_factored).  Per timestep t and batch row, with h the
// carried state (2r wide) and x_t the input frame (F wide):
//
//   rs        = rowsum(h)
//   layer 0:  hid = relu(h*(diag1 - off1) + off1*rs + x_t @ dka_0 + b_0)
//   layer k:  hid = relu(c*rs + hid + (x_t - hid @ dkT_{k-1}) @ dka_k + b_k)
//   h         = mask[b, t] ? hid : h;   out[b, t, :] = h
//
// What bounds it on an H100.  Per row and step the two thin products of
// each layer cost 2*F*2r*(2K-1) flops (9.25 MFLOP at K=5, F=257, 2r=2000);
// the compulsory traffic is x, the output and one read of the weights
// (about 1 FLOP per byte at the flagship shape), so the bound is the f32
// rate of the CUDA cores: about 36 ms for B=256, T=1021 at 67 TFLOP/s.
//
// What this design does about it: it is the simple, right version, not the
// fast one.  Each row's recurrence depends only on its own past, so blocks
// split the batch (ROWS rows each, no synchronisation between blocks) and
// loop over t and k inside the kernel, in place of the TPU's sequential
// grid.  The carry, the layer's hidden state and the residual live in
// shared memory; the weights (dka (K,F,2r) + dkT (K-1,2r,F), 18.5 MB at the
// flagship in f32) stay in global memory and are served from the 50 MB L2.
// ROWS = 2 gives 128 blocks at B = 256, about one per SM; each weight
// element loaded is used for ROWS rows from registers.  The known cost:
// every block re-reads the whole weight stack from L2 at every step, so
// the kernel is bound by L2 bandwidth, far from the f32 FMA bound.  A column
// split with shared-memory-resident weight slices, or TF32/bf16 wgmma, is
// later work.  f32 FMA on CUDA cores; no tensor cores.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 2;          // batch rows per block
constexpr int THREADS = 512;     // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 4;          // hidden columns per thread per pass
constexpr int FT = 3;            // 32-wide feature tiles per pass

// Shared memory, in floats: h, hid (ROWS x N); xs, resid (ROWS x F);
// red (WARPS x ROWS x FT*32); wsum (WARPS x ROWS); rs, msk (ROWS each).
__host__ __device__ inline size_t smem_floats(int F, int N) {
  return (size_t)2 * ROWS * N + (size_t)2 * ROWS * F +
         (size_t)WARPS * ROWS * FT * 32 + WARPS * ROWS + 2 * ROWS;
}

// acc = src (ROWS x F, shared) @ w (F x N, global), then the layer's
// epilogue writes hid.  Threads own columns; each loaded weight element
// serves all ROWS rows.
template <bool FIRST>
__device__ void project(const float* __restrict__ w, const float* src,
                        const float* __restrict__ bias,
                        const float* __restrict__ diag1, float off1,
                        float c_uk, const float* h, float* hid,
                        const float* rs, int F, int N) {
  for (int j0 = 0; j0 < N; j0 += THREADS * COLS) {
    float acc[COLS][ROWS];
    int jj[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      jj[c] = j0 + threadIdx.x + c * THREADS;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;
    }
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      float a[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) a[r] = src[r * F + f];
      const float* wrow = w + (size_t)f * N;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float wv = jj[c] < N ? __ldg(wrow + jj[c]) : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[c][r] = fmaf(a[r], wv, acc[c][r]);
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      int j = jj[c];
      if (j >= N) continue;
      float bj = bias[j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float pre;
        if (FIRST) {
          pre = h[r * N + j] * (diag1[j] - off1) + off1 * rs[r];
        } else {
          pre = c_uk * rs[r] + hid[r * N + j];
        }
        hid[r * N + j] = fmaxf(pre + acc[c][r] + bj, 0.f);
      }
    }
  }
}

// resid = xs - hid (ROWS x N, shared) @ wt (N x F, global).  Lanes own
// features (coalesced reads of a weight row), warps split the contraction,
// and a shared-memory pass sums the warps' partials.
__device__ void back_project(const float* __restrict__ wt, const float* hid,
                             const float* xs, float* resid, float* red,
                             int F, int N) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int fb = 0; fb < F; fb += FT * 32) {
    float acc[FT][ROWS];
#pragma unroll
    for (int q = 0; q < FT; ++q)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[q][r] = 0.f;
#pragma unroll 2
    for (int j = warp; j < N; j += WARPS) {
      float hv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) hv[r] = hid[r * N + j];
      const float* wrow = wt + (size_t)j * F;
#pragma unroll
      for (int q = 0; q < FT; ++q) {
        int f = fb + q * 32 + lane;
        float wv = f < F ? __ldg(wrow + f) : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[q][r] = fmaf(hv[r], wv, acc[q][r]);
      }
    }
#pragma unroll
    for (int q = 0; q < FT; ++q)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        red[(warp * ROWS + r) * FT * 32 + q * 32 + lane] = acc[q][r];
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS * FT * 32; i += THREADS) {
      int r = i / (FT * 32);
      int fi = i - r * FT * 32;
      int f = fb + fi;
      if (f >= F) continue;
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[(w * ROWS + r) * FT * 32 + fi];
      resid[r * F + f] = xs[r * F + f] - s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
drnmf_scan_factored_kernel(const float* __restrict__ x,
                           const unsigned char* __restrict__ mask,
                           const float* __restrict__ h0,
                           const float* __restrict__ diag1,
                           const float* __restrict__ off1_p,
                           const float* __restrict__ c_uk_p,
                           const float* __restrict__ dkt,
                           const float* __restrict__ dka,
                           const float* __restrict__ b,
                           float* __restrict__ out,
                           int B, int T, int F, int N, int K) {
  extern __shared__ float smem[];
  float* h = smem;
  float* hid = h + ROWS * N;
  float* xs = hid + ROWS * N;
  float* resid = xs + ROWS * F;
  float* red = resid + ROWS * F;
  float* wsum = red + WARPS * ROWS * FT * 32;
  float* rs = wsum + WARPS * ROWS;
  float* msk = rs + ROWS;

  const int b0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float off1 = *off1_p;
  const float c_uk = *c_uk_p;

  // rows past the batch run on zeros and are never written out
  for (int i = threadIdx.x; i < ROWS * N; i += THREADS) {
    int r = i / N;
    int row = b0 + r;
    h[i] = row < B ? h0[(size_t)row * N + (i - r * N)] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int i = threadIdx.x; i < ROWS * F; i += THREADS) {
      int r = i / F;
      int row = b0 + r;
      xs[i] = row < B ? x[((size_t)row * T + t) * F + (i - r * F)] : 0.f;
    }
    if (threadIdx.x < ROWS) {
      int row = b0 + threadIdx.x;
      msk[threadIdx.x] = (row < B && mask[(size_t)row * T + t]) ? 1.f : 0.f;
    }
    float part[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part[r] = 0.f;
    for (int j = threadIdx.x; j < N; j += THREADS)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) part[r] += h[r * N + j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      for (int o = 16; o > 0; o >>= 1)
        part[r] += __shfl_down_sync(0xffffffffu, part[r], o);
      if (lane == 0) wsum[warp * ROWS + r] = part[r];
    }
    __syncthreads();
    if (threadIdx.x < ROWS) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += wsum[w * ROWS + threadIdx.x];
      rs[threadIdx.x] = s;
    }
    __syncthreads();

    project<true>(dka, xs, b, diag1, off1, c_uk, h, hid, rs, F, N);
    __syncthreads();
    for (int k = 1; k < K; ++k) {
      back_project(dkt + (size_t)(k - 1) * N * F, hid, xs, resid, red, F, N);
      project<false>(dka + (size_t)k * F * N, resid, b + (size_t)k * N,
                     diag1, off1, c_uk, h, hid, rs, F, N);
      __syncthreads();
    }

    for (int i = threadIdx.x; i < ROWS * N; i += THREADS) {
      int r = i / N;
      int row = b0 + r;
      float v = msk[r] != 0.f ? hid[i] : h[i];
      h[i] = v;
      if (row < B) out[((size_t)row * T + t) * N + (i - r * N)] = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int drnmf_scan_factored(const float* x, const unsigned char* mask,
                                   const float* h0, const float* diag1,
                                   const float* off1, const float* c_uk,
                                   const float* dkt, const float* dka,
                                   const float* b, float* out, int B, int T,
                                   int F, int N, int K, void* stream) {
  const size_t smem = smem_floats(F, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      drnmf_scan_factored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + ROWS - 1) / ROWS);
  drnmf_scan_factored_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, mask, h0, diag1, off1, c_uk, dkt, dka, b, out, B, T, F, N, K);
  return (int)cudaGetLastError();
}

extern "C" const char* drnmf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
