// Reverse delta chain of the folded + factored DR-NMF recurrence (the
// backward of kernel B1), the whole reverse time scan in one cooperative
// launch.
//
// The port's own kernel: the JAX package runs this chain as an XLA scan
// (drnmf_tpu/models/batched_grad.py::_bwd, back_step :99-121); no Pallas
// kernel there has a backward.  Per step t from T-1 down to 0, with gamma
// the gradient that reaches the carry h_t from the later steps, g_t the
// loss's gradient of the step's output, m_t the step mask and h_k the
// forward's layer-k hidden state before the hold (B1's h_all):
//
//   go  = g_t + gamma;   g_h = go*m_t;   gamma' = go*(1 - m_t)
//   for k = K-1 .. 1:
//     d_k = g_h * (h_k > 0)
//     p   = d_k @ dka_k^T                 (a contraction over N = 2r)
//     g_h = d_k - p @ dk_k                (a contraction over F)
//     gamma' += c*rowsum(d_k)
//   d_0 = g_h * (h_0 > 0)
//   gamma' += d_0*(diag1 - off1) + off1*rowsum(d_0)
//
// Outputs: the deltas d_k in h_all's layout (K, N, T*Bp), each step's p
// (K-1, F, T*Bp), which the weight gradients reuse instead of recomputing
// it, and gamma after step 0 (the gradient of h0), (N, Bp).
//
// What bounds it on an H100.  Per row and step 2(K-1) thin products of
// 2*F*N flops (8.2 MFLOP at K=5, F=257, N=2000) against weights (dka^T and
// dk of layers 1..K-1: 16.4 MB in f32) that fit the 50 MB L2; the bytes are
// h_all read once and the deltas written once (640 MB each at B=32, T=500,
// K=5), so at the training batch the bytes bound it (0.42 ms against 1.96
// ms of f32 CUDA-core operations).  As for B1, what sets the pace at a few
// rows is the chain of dependent phases: L2 latency per contraction chunk
// and one grid synchronisation between phases.
//
// What this design does about it.  B1's tile loop and phases, mirrored:
// every product is one tiled f32 product whose output tiles (or, for the
// contraction over 2r, whose (tile, stretch) items) are spread over the
// persistent blocks of ONE cooperative launch, the activations read
// through L2 in the batch-innermost layout B1 writes.  Phases of step t,
// each a grid-stride loop over its items, with a grid sync after each
// (3K - 1 a step):
//
//   Q    gamma of step t+1 finished (go*(1-m) kept by its Q in gb, its d_0
//        and its per-row total tot), then go, g_h and d_{K-1} of step t;
//        one thread per (group of GROUP columns, row), which also writes
//        d_{K-1}'s partial rowsum over its group.
//   BP_k part[s] = d_k[rows s*L..(s+1)*L)^T @ dka_k^T[same rows]: the
//        product over 2r split over S fixed stretches (B1's BP with dka^T
//        in place of dkT).
//   R_k  p = part[0] + part[1] + ... + part[S-1], into p_all.
//   P_k  d_{k-1} = (d_k - p @ dk_k) * (h_{k-1} > 0) over output tiles of
//        (Bp x N) (B1's P with dk in place of dka and this epilogue in
//        place of the relu), and d_{k-1}'s partial rowsums over groups.
//   S    tot = c*(rs(d_{K-1}) + ... + rs(d_1)) + off1*rs(d_0), one warp a
//        row: lane j adds groups j, j+32, ... in order, then a butterfly
//        of shuffles (each lane ends with the same bits).
//
// After step 0 one more elementwise phase writes gamma.  K = 1 runs Q and
// S only and reads neither weight stack.
//
// Invariants (B1's).  Every output element is summed by one thread in a
// fixed order: contraction chunks of KT ascending, then the stretches
// ascending; rowsums add GROUP columns in column order, then the groups in
// a fixed order that depends on G alone.  No float atomics, so a repeat is
// bit-equal; L, the groups and the reductions are fixed by (F, 2r), so a
// row's bits do not depend on the batch or the grid.  Rows past B read a
// zero gradient and a zero mask, so their deltas and gamma stay zero.
// f32 FMA on the CUDA cores; no tensor cores.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing (the caller hands it outputs and scratch), returns the
// CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int KT = 32;        // contraction depth per shared-memory tile
constexpr int MAX_TW = 64;    // widest column tile
constexpr int GROUP = 16;     // columns of one partial rowsum

struct Params {
  const float* g;             // (T, N, Bp): the output's gradient, 0 past B
  const unsigned char* mask;  // (B, T)
  const float* h_all;         // (K, N, T*Bp): the forward's layers
  const float* diag1;         // (N)
  const float* off1;          // (1)
  const float* c_uk;          // (1)
  const float* dkat;          // (K-1, N, F): dka_k^T of layers 1..K-1
  const float* dk;            // (K-1, F, N): Dhat_k of layers 1..K-1
  float* delta;               // (K, N, T*Bp): out
  float* p_all;               // (K-1, F, T*Bp): out
  float* gb;                  // (N, Bp): go*(1-m) of the step last done
  float* part;                // (S, F, Bp): back-projection partials
  float* rsp;                 // (K, G, Bp): the deltas' partial rowsums
  float* tot;                 // (Bp): per-row total of the rowsum terms
  float* gamma;               // (N, Bp): out
  int B, Bp, T, F, N, K;
  int tn, tf;                 // column tiles of P, of BP
  int split, splits, groups;  // L, S, G
};

// A KT x TM slice of activations (len x lda, contraction-major, written by
// this kernel, so read through L2 only) into registers.
template <int TM>
__device__ __forceinline__ void load_a(const float* a, int len, size_t lda,
                                       int k0, int m0,
                                       float (&reg)[TM * KT / THREADS]) {
#pragma unroll
  for (int q = 0; q < TM * KT / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int k = k0 + e / TM;
    reg[q] = k < len ? __ldcg(a + (size_t)k * lda + m0 + e % TM) : 0.f;
  }
}

// A KT x TW slice of weights (len x ncols, read-only) into registers.
template <int TW>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int len,
                                       int ncols, int k0, int n0,
                                       float (&reg)[TW * KT / THREADS]) {
#pragma unroll
  for (int q = 0; q < TW * KT / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int k = k0 + e / TW;
    const int j = n0 + e % TW;
    reg[q] = (k < len && j < ncols) ? __ldg(w + (size_t)k * ncols + j) : 0.f;
  }
}

template <int W>
__device__ __forceinline__ void store_tile(float* s,
                                           const float (&reg)[W * KT / THREADS]) {
#pragma unroll
  for (int q = 0; q < W * KT / THREADS; ++q) s[threadIdx.x + q * THREADS] = reg[q];
}

// R consecutive floats from shared memory (R in {1, 2, 4}; aligned to R).
template <int R>
__device__ __forceinline__ void load_frag(const float* s, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 q = *reinterpret_cast<const float4*>(s);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(s);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = s[0];
  }
}

// acc = a[0:len, m0:m0+TM]^T @ w[0:len, n0:n0+TW], a's rows lda apart.
// Thread (ty, tx) owns rows ty*RM.. and columns tx*CW..; each of its sums
// is one fmaf chain over the contraction in ascending order, whatever the
// tile.  The next chunk is in flight in registers while the current one is
// multiplied.  Ends with a barrier, so the caller may reuse smem.
template <int TM, int TW>
__device__ __forceinline__ void tile_product(const float* a,
                                             const float* __restrict__ w,
                                             int len, size_t lda, int ncols,
                                             int m0, int n0, float* smem,
                                             float (&acc)[TM / 16][TW / 16]) {
  constexpr int RM = TM / 16;
  constexpr int CW = TW / 16;
  float* sa = smem;            // [KT][TM]
  float* sb = smem + KT * TM;  // [KT][TW]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;

  const int chunks = (len + KT - 1) / KT;
  float ra[TM * KT / THREADS], rb[TW * KT / THREADS];
  load_a<TM>(a, len, lda, 0, m0, ra);
  load_w<TW>(w, len, ncols, 0, n0, rb);
  store_tile<TM>(sa, ra);
  store_tile<TW>(sb, rb);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    if (more) {  // in flight during the products
      load_a<TM>(a, len, lda, (c + 1) * KT, m0, ra);
      load_w<TW>(w, len, ncols, (c + 1) * KT, n0, rb);
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float av[RM], wv[CW];
      load_frag<RM>(sa + kk * TM + ty * RM, av);
      load_frag<CW>(sb + kk * TW + tx * CW, wv);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store_tile<TM>(sa, ra);
      store_tile<TW>(sb, rb);
      __syncthreads();
    }
  }
}

// Q: finish gamma of step t+1, start step t: go, g_h and d_{K-1}, one
// thread per (group, row); d_{K-1}'s partial rowsum over the group.
__device__ __forceinline__ void q_phase(const Params& p, int t) {
  const int N = p.N, Bp = p.Bp;
  const size_t tbp = (size_t)p.T * Bp;
  const bool later = t + 1 < p.T;  // a later step's gamma to finish
  const float off1 = __ldg(p.off1);
  const float* d0_later = p.delta + (size_t)(t + 1) * Bp;  // layer 0
  const float* g_t = p.g + (size_t)t * N * Bp;
  const size_t top = (size_t)(p.K - 1) * N * tbp + (size_t)t * Bp;
  float* rsp_top = p.rsp + (size_t)(p.K - 1) * p.groups * Bp;
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < p.groups * Bp;
       e += gridDim.x * THREADS) {
    const int grp = e / Bp;
    const int row = e % Bp;
    const bool valid = row < p.B && p.mask[(size_t)row * p.T + t];
    const float tot = later ? __ldcg(p.tot + row) : 0.f;
    float s = 0.f;
    for (int c = 0; c < GROUP; ++c) {
      const int col = grp * GROUP + c;
      if (col >= N) break;
      const size_t at = (size_t)col * Bp + row;
      const size_t at_all = (size_t)col * tbp + row;
      float gamma = 0.f;
      if (later)
        gamma = __ldcg(p.gb + at) +
                __ldcg(d0_later + at_all) * (__ldg(p.diag1 + col) - off1) +
                tot;
      const float go = __ldg(g_t + at) + gamma;
      p.gb[at] = valid ? 0.f : go;  // go*(1 - m)
      const float d =
          (valid && __ldg(p.h_all + top + at_all) > 0.f) ? go : 0.f;
      p.delta[top + at_all] = d;
      s += d;
    }
    rsp_top[(size_t)grp * Bp + row] = s;
  }
}

// BP_k: part[s] = d_k[s*L:(s+1)*L]^T @ dka_k^T[s*L:(s+1)*L] over work
// items (row tile, F-column tile TF, stretch s).
template <int TM, int TF>
__device__ __forceinline__ void back_project_phase(const Params& p, int t,
                                                   int k, float* smem) {
  constexpr int RM = TM / 16;
  constexpr int CF = TF / 16;
  const int F = p.F, N = p.N, Bp = p.Bp;
  const size_t tbp = (size_t)p.T * Bp;
  const float* d_k = p.delta + (size_t)k * N * tbp + (size_t)t * Bp;
  const float* w = p.dkat + (size_t)(k - 1) * N * F;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int f_tiles = (F + TF - 1) / TF;
  const int items = (Bp / TM) * f_tiles * p.splits;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int s = item % p.splits;
    const int f0 = ((item / p.splits) % f_tiles) * TF;
    const int m0 = (item / (p.splits * f_tiles)) * TM;
    const int k0 = s * p.split;
    const int len = min(p.split, N - k0);
    float acc[RM][CF];
    tile_product<TM, TF>(d_k + (size_t)k0 * tbp, w + (size_t)k0 * F, len,
                         tbp, F, m0, f0, smem, acc);
    float* part = p.part + (size_t)s * F * Bp;
#pragma unroll
    for (int j = 0; j < CF; ++j) {
      const int f = f0 + tx * CF + j;
      if (f >= F) continue;
#pragma unroll
      for (int i = 0; i < RM; ++i)
        part[(size_t)f * Bp + m0 + ty * RM + i] = acc[i][j];
    }
  }
}

// R_k: p = part[0] + ... + part[S-1], elementwise over (F, Bp), into the
// step's columns of p_all.
__device__ __forceinline__ void sum_phase(const Params& p, int t, int k) {
  const size_t n = (size_t)p.F * p.Bp;
  const size_t tbp = (size_t)p.T * p.Bp;
  float* p_t = p.p_all + (size_t)(k - 1) * p.F * tbp + (size_t)t * p.Bp;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * THREADS) {
    float v = __ldcg(p.part + e);
    for (int s = 1; s < p.splits; ++s) v += __ldcg(p.part + s * n + e);
    p_t[(e / p.Bp) * tbp + e % p.Bp] = v;
  }
}

// P_k: d_{k-1} = (d_k - p @ dk_k) * (h_{k-1} > 0) over output tiles
// TM x TN of (Bp x N), and d_{k-1}'s partial rowsums, GROUP columns in
// column order.
template <int TM, int TN>
__device__ __forceinline__ void project_phase(const Params& p, int t, int k,
                                              float* smem) {
  constexpr int RM = TM / 16;
  constexpr int CN = TN / 16;
  const int F = p.F, N = p.N, Bp = p.Bp;
  const size_t tbp = (size_t)p.T * Bp;
  const float* a = p.p_all + (size_t)(k - 1) * F * tbp + (size_t)t * Bp;
  const float* w = p.dk + (size_t)(k - 1) * F * N;
  const size_t step = (size_t)t * Bp;
  const float* d_k = p.delta + (size_t)k * N * tbp + step;
  float* d_out = p.delta + (size_t)(k - 1) * N * tbp + step;
  const float* h_in = p.h_all + (size_t)(k - 1) * N * tbp + step;
  float* rsp = p.rsp + (size_t)(k - 1) * p.groups * Bp;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int col_tiles = (N + TN - 1) / TN;
  const int tiles = (Bp / TM) * col_tiles;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / col_tiles) * TM;
    const int n0 = (tile % col_tiles) * TN;
    float acc[RM][CN];
    tile_product<TM, TN>(a, w, F, tbp, N, m0, n0, smem, acc);

    float* tile_v = smem;  // [TN][TM]: d_{k-1}, for its rowsums
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int cl = tx * CN + j;
      const int col = n0 + cl;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rl = ty * RM + i;
        const size_t at = (size_t)col * tbp + m0 + rl;
        float v = 0.f;
        if (col < N) {
          const float gh = __ldcg(d_k + at) - acc[i][j];
          v = __ldg(h_in + at) > 0.f ? gh : 0.f;
          d_out[at] = v;
        }
        tile_v[cl * TM + rl] = v;  // 0 past N
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TM * (TN / GROUP); e += THREADS) {
      const int rl = e % TM;
      const int g = e / TM;
      if (n0 + g * GROUP >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < GROUP; ++c) s += tile_v[(g * GROUP + c) * TM + rl];
      rsp[(size_t)(n0 / GROUP + g) * Bp + m0 + rl] = s;
    }
    __syncthreads();  // smem is reused by the next tile
  }
}

// S: tot = c*(rs(d_{K-1}) + ... + rs(d_1)) + off1*rs(d_0), one warp a row.
__device__ __forceinline__ void total_phase(const Params& p) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x % 32;
  const float c_uk = __ldg(p.c_uk);
  const float off1 = __ldg(p.off1);
  for (int row = blockIdx.x * WARPS + threadIdx.x / 32; row < p.Bp;
       row += gridDim.x * WARPS) {  // uniform across the warp
    float upper = 0.f, r0 = 0.f;
    for (int k = p.K - 1; k >= 0; --k) {
      const float* rsp = p.rsp + (size_t)k * p.groups * p.Bp + row;
      float s = 0.f;
      for (int g = lane; g < p.groups; g += 32) s += __ldcg(rsp + (size_t)g * p.Bp);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (k > 0) upper += s;
      else r0 = s;
    }
    if (lane == 0) p.tot[row] = c_uk * upper + off1 * r0;
  }
}

// After step 0: gamma = go*(1-m) + d_0*(diag1 - off1) + tot.
__device__ __forceinline__ void gamma_phase(const Params& p) {
  const size_t n = (size_t)p.N * p.Bp;
  const size_t tbp = (size_t)p.T * p.Bp;
  const float off1 = __ldg(p.off1);
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * THREADS) {
    const int col = (int)(e / p.Bp);
    const int row = (int)(e % p.Bp);
    p.gamma[e] = __ldcg(p.gb + e) +
                 __ldcg(p.delta + (size_t)col * tbp + row) *
                     (__ldg(p.diag1 + col) - off1) +
                 __ldcg(p.tot + row);
  }
}

template <int TM>
__device__ __forceinline__ void project(const Params& p, int t, int k,
                                        float* smem) {
  if (p.tn == 16) project_phase<TM, 16>(p, t, k, smem);
  else if (p.tn == 32) project_phase<TM, 32>(p, t, k, smem);
  else project_phase<TM, 64>(p, t, k, smem);
}

template <int TM>
__device__ __forceinline__ void back_project(const Params& p, int t, int k,
                                             float* smem) {
  if (p.tf == 16) back_project_phase<TM, 16>(p, t, k, smem);
  else if (p.tf == 32) back_project_phase<TM, 32>(p, t, k, smem);
  else back_project_phase<TM, 64>(p, t, k, smem);
}

template <int TM>
__global__ void __launch_bounds__(THREADS)
drnmf_scan_factored_bwd_kernel(Params p) {
  __shared__ __align__(16) float smem[KT * (TM + MAX_TW)];
  cg::grid_group grid = cg::this_grid();

  for (int t = p.T - 1; t >= 0; --t) {
    q_phase(p, t);
    grid.sync();
    for (int k = p.K - 1; k >= 1; --k) {
      back_project<TM>(p, t, k, smem);
      grid.sync();
      sum_phase(p, t, k);
      grid.sync();
      project<TM>(p, t, k, smem);
      grid.sync();
    }
    total_phase(p);
    grid.sync();
  }
  gamma_phase(p);
}

using Kernel = void (*)(Params);

Kernel pick(int tm) {
  if (tm == 16) return drnmf_scan_factored_bwd_kernel<16>;
  if (tm == 32) return drnmf_scan_factored_bwd_kernel<32>;
  if (tm == 64) return drnmf_scan_factored_bwd_kernel<64>;
  return nullptr;
}

bool is_tile(int w) { return w == 16 || w == 32 || w == 64; }

}  // namespace

// The number of blocks of the tm-row kernel that the current device keeps
// resident at once, which bounds the grid of a cooperative launch; 0 when
// the device has no cooperative launch or tm is not built; a negative CUDA
// error code on failure.
extern "C" int drnmf_scan_factored_backward_capacity(int tm) {
  Kernel kernel = pick(tm);
  if (kernel == nullptr) return 0;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return -(int)err;
  return coop ? sms * per_sm : 0;
}

extern "C" int drnmf_scan_factored_backward(
    const float* g, const unsigned char* mask, const float* h_all,
    const float* diag1, const float* off1, const float* c_uk,
    const float* dkat, const float* dk, float* delta, float* p_all, float* gb,
    float* part, float* rsp, float* tot, float* gamma, int B, int Bp, int T,
    int F, int N, int K, int tm, int tn, int tf, int split, int splits,
    int groups, int grid, void* stream) {
  Kernel kernel = pick(tm);
  if (kernel == nullptr || !is_tile(tn) || !is_tile(tf) || Bp % tm != 0 ||
      K < 1 || split < 1 || split % KT != 0 ||
      splits != (N + split - 1) / split || groups != (N + GROUP - 1) / GROUP ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  Params p{g,     mask, h_all, diag1, off1, c_uk, dkat,  dk,     delta,
           p_all, gb,   part,  rsp,   tot,  gamma, B,    Bp,     T,
           F,     N,    K,     tn,    tf,   split, splits, groups};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(grid), dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* drnmf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
