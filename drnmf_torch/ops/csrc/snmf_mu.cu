// Sparse-NMF multiplicative-update (MU) passes under the ED objective
// (beta = 2), kernels B4 and B5.
//
// Replaces drnmf_tpu/ops/pallas/snmf_mu.py::_pass1_kernel (B4) and
// ::_pass2_kernel (B5).  With v (m x n), h (r x n), w (m x r), flr = 1e-9:
//
//   B4:  lam  = max(W h, flr)
//        h'   = h * (W^T v) / max(W^T lam + sp, flr)
//        lam' = max(W h', flr)
//        A    = v h'^T,  B = lam' h'^T   (m x r, summed over all n frames)
//        sp_sum = sp * sum(h')
//   B5:  div  = sum((v - max(W h, flr))^2)   (called with W', h')
//
// What bounds them on an H100.  B4 is six products of 2*m*r*n flops each
// (863.5 GFLOP at m=257, r=2000, n=140,000: 12.9 ms at the 67 TFLOP/s f32
// rate of the CUDA cores) against about 2.4 GB of compulsory traffic (v, h
// read, h' written: 0.7 ms at 3.35 TB/s); B5 is one such product (2.15 ms)
// against 1.26 GB.  Both are bound by operations.
//
// What this design does about it: it is the simple, right version.  The TPU
// kernel keeps W (2 MB at r=2000) and the two (m, r) statistics in VMEM
// across a sequential frame grid; on Hopper W does not fit a block's shared
// memory and blocks run in no order.  So one tiled f32 product kernel
// (64 x 64 output tile per block, 16-deep k steps double-buffered through
// registers and shared memory, a 4 x 4 register tile per thread) serves
// every product, with one epilogue per use:
//
//   1. lam  = max(W h, flr) into an (m, n) scratch      (EPI_LAM)
//   2. W^T v and W^T lam in two accumulators of one block; the epilogue
//      writes h' and a per-block partial of sum(h')    (EPI_HUPD)
//   3. lam' = max(W h', flr) into the same scratch      (EPI_LAM)
//   4. v h'^T and lam' h'^T in two accumulators; the frame axis is split
//      into slices with one partial (m, r) pair each    (EPI_STATS)
//   5. the slices and the per-block partials summed in fixed order.
//   B5: W' h' with an epilogue that squares v - max(., flr) and writes one
//       partial per block (EPI_DIV), then the fixed-order sum.
//
// No float atomics: every sum across blocks is per-block partials plus a
// pass in fixed order, so a run is reproducible bit for bit and the
// conv_eps stop does not move between runs.  The ragged edges (any m, r, n)
// are masked in every load and store; no padding, so no divergence bias.
// Offsets are 64-bit.  f32 FMA on the CUDA cores; no tensor cores.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing (the caller passes a workspace of the size that
// snmf_mu_pass{1,2}_workspace returns) and returns the first CUDA error.

#include <cuda_runtime.h>

namespace {

constexpr float FLR = 1e-9f;
constexpr int BM = 64;         // output rows per block
constexpr int BN = 64;         // output columns per block
constexpr int BK = 16;         // contraction depth per step
constexpr int PAD = 4;         // shared-memory row padding (keeps float4)
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int LOADS = BM * BK / THREADS;  // tile elements per thread: 4
constexpr int SUM_THREADS = 1024;
// frame slices for the (m, r) statistics: enough blocks to fill the card
constexpr int MAX_SLICES = 32;
constexpr long long FRAMES_PER_SLICE = 4096;

static_assert(BM == BN, "the loaders assume square tiles");
static_assert(BM * BK == LOADS * THREADS, "each thread loads LOADS elements");

enum Epi { EPI_LAM, EPI_HUPD, EPI_STATS, EPI_DIV };

// C (M x N) = A (M x K) B (K x N) over k in [z*kchunk, (z+1)*kchunk), with
// A and B given by pointer, leading dimension and, as template flags,
// whether they are stored transposed.  a1/b1 are the second operands of
// the two-accumulator epilogues (EPI_STATS: a1 = lam'; EPI_HUPD: b1 = lam).
struct Args {
  const float* a0;
  const float* a1;
  long long lda;
  const float* b0;
  const float* b1;
  long long ldb;
  int M;
  int N;
  long long K;
  long long kchunk;
  float* out0;      // EPI_LAM: lam; EPI_HUPD: h'; EPI_STATS: A slices
  float* out1;      // EPI_STATS: B slices
  long long ldc;
  const float* e;   // EPI_HUPD: h; EPI_DIV: v (leading dimension ldc)
  float sp;         // EPI_HUPD: the scalar sparsity
  float* partial;   // EPI_HUPD, EPI_DIV: one float per block
};

// A tile (rows row0.., depth k0..) into registers; TRANS: stored K x M.
template <bool TRANS>
__device__ __forceinline__ void load_a(const float* __restrict__ a,
                                       long long ld, int M, long long kend,
                                       int row0, long long k0,
                                       float (&reg)[LOADS]) {
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int mi = TRANS ? e % BM : e / BK;  // consecutive threads on the
    const int ki = TRANS ? e / BM : e % BK;  // contiguous axis
    const int i = row0 + mi;
    const long long k = k0 + ki;
    reg[q] = (i < M && k < kend)
                 ? (TRANS ? a[k * ld + i] : a[(long long)i * ld + k])
                 : 0.f;
  }
}

template <bool TRANS>
__device__ __forceinline__ void store_a(float (*s)[BM + PAD],
                                        const float (&reg)[LOADS]) {
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int mi = TRANS ? e % BM : e / BK;
    const int ki = TRANS ? e / BM : e % BK;
    s[ki][mi] = reg[q];
  }
}

// B tile (depth k0.., columns col0..) into registers; TRANS: stored N x K.
template <bool TRANS>
__device__ __forceinline__ void load_b(const float* __restrict__ b,
                                       long long ld, int N, long long kend,
                                       int col0, long long k0,
                                       float (&reg)[LOADS]) {
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int ni = TRANS ? e / BK : e % BN;
    const int ki = TRANS ? e % BK : e / BN;
    const int j = col0 + ni;
    const long long k = k0 + ki;
    reg[q] = (j < N && k < kend)
                 ? (TRANS ? b[(long long)j * ld + k] : b[k * ld + j])
                 : 0.f;
  }
}

template <bool TRANS>
__device__ __forceinline__ void store_b(float (*s)[BN + PAD],
                                        const float (&reg)[LOADS]) {
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int ni = TRANS ? e / BK : e % BN;
    const int ki = TRANS ? e % BK : e / BN;
    s[ki][ni] = reg[q];
  }
}

// Sum of one float per thread in a fixed order; the result is on thread 0.
__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(THREADS) mu_gemm(Args p) {
  constexpr int NA = EPI == EPI_STATS ? 2 : 1;  // A operands
  constexpr int NB = EPI == EPI_HUPD ? 2 : 1;   // B operands
  constexpr int NACC = NA > NB ? NA : NB;
  __shared__ __align__(16) float sa[2][NA][BK][BM + PAD];
  __shared__ __align__(16) float sb[2][NB][BK][BN + PAD];
  __shared__ float red[THREADS / 32];

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long kbeg = (long long)blockIdx.z * p.kchunk;
  const long long kend = min(p.K, kbeg + p.kchunk);
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const float* as[2] = {p.a0, p.a1};
  const float* bs[2] = {p.b0, p.b1};

  float acc[NACC][TM][TN];
#pragma unroll
  for (int c = 0; c < NACC; ++c)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[c][i][j] = 0.f;

  float ra[NA][LOADS], rb[NB][LOADS];
  if (kbeg < kend) {
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      load_a<AT>(as[x], p.lda, p.M, kend, row0, kbeg, ra[x]);
      store_a<AT>(sa[0][x], ra[x]);
    }
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      load_b<BT>(bs[x], p.ldb, p.N, kend, col0, kbeg, rb[x]);
      store_b<BT>(sb[0][x], rb[x]);
    }
  }
  __syncthreads();

  int buf = 0;
  for (long long k0 = kbeg; k0 < kend; k0 += BK) {
    const bool more = k0 + BK < kend;
    if (more) {  // the next tile's loads are in flight during the FMAs
#pragma unroll
      for (int x = 0; x < NA; ++x)
        load_a<AT>(as[x], p.lda, p.M, kend, row0, k0 + BK, ra[x]);
#pragma unroll
      for (int x = 0; x < NB; ++x)
        load_b<BT>(bs[x], p.ldb, p.N, kend, col0, k0 + BK, rb[x]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float4 av[NA], bv[NB];
#pragma unroll
      for (int x = 0; x < NA; ++x)
        av[x] = *reinterpret_cast<const float4*>(&sa[buf][x][kk][ty * TM]);
#pragma unroll
      for (int x = 0; x < NB; ++x)
        bv[x] = *reinterpret_cast<const float4*>(&sb[buf][x][kk][tx * TN]);
#pragma unroll
      for (int c = 0; c < NACC; ++c) {
        const float4 a4 = av[NA == 2 ? c : 0];
        const float4 b4 = bv[NB == 2 ? c : 0];
        const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
        const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[c][i][j] = fmaf(a[i], b[j], acc[c][i][j]);
      }
    }
    if (more) {
#pragma unroll
      for (int x = 0; x < NA; ++x) store_a<AT>(sa[buf ^ 1][x], ra[x]);
#pragma unroll
      for (int x = 0; x < NB; ++x) store_b<BT>(sb[buf ^ 1][x], rb[x]);
    }
    __syncthreads();
    buf ^= 1;
  }

  float local = 0.f;
  const size_t slice = (size_t)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col >= p.N) continue;
      const size_t o = (size_t)row * p.ldc + col;
      if (EPI == EPI_LAM) {
        p.out0[o] = fmaxf(acc[0][i][j], FLR);
      } else if (EPI == EPI_HUPD) {
        // the reference's order: h * numer / max(denom + sp, flr)
        const float hn =
            p.e[o] * acc[0][i][j] / fmaxf(acc[NACC - 1][i][j] + p.sp, FLR);
        p.out0[o] = hn;
        local += hn;
      } else if (EPI == EPI_STATS) {
        p.out0[slice + o] = acc[0][i][j];
        p.out1[slice + o] = acc[NACC - 1][i][j];
      } else {  // EPI_DIV
        const float d = p.e[o] - fmaxf(acc[0][i][j], FLR);
        local = fmaf(d, d, local);
      }
    }
  }
  if (EPI == EPI_HUPD || EPI == EPI_DIV) {
    const float s = block_sum(local, red);
    if (threadIdx.x == 0)
      p.partial[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// out[i] = sum over z of part[z * count + i], z in increasing order.
__global__ void sum_slices(const float* __restrict__ part,
                           float* __restrict__ out, long long count,
                           int slices) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += part[(long long)z * count + i];
  out[i] = s;
}

// *out = scale * sum(part[0:count]) in a fixed order: one block, strided
// sums per thread, then a fixed tree.
__global__ void __launch_bounds__(SUM_THREADS)
    sum_partials(const float* __restrict__ part, long long count, float scale,
                 float* __restrict__ out) {
  __shared__ float s[SUM_THREADS];
  float x = 0.f;
  for (long long i = threadIdx.x; i < count; i += SUM_THREADS) x += part[i];
  s[threadIdx.x] = x;
  __syncthreads();
  for (int o = SUM_THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = scale * s[0];
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Frame slices of the statistics product: (slices, frames per slice).
void stat_slices(long long n, int* slices, long long* kchunk) {
  long long s = cdiv(n, FRAMES_PER_SLICE);
  s = s < 1 ? 1 : (s > MAX_SLICES ? MAX_SLICES : s);
  *kchunk = cdiv(cdiv(n, s), BK) * BK;
  *slices = (int)cdiv(n, *kchunk);
}

template <bool AT, bool BT, int EPI>
cudaError_t launch(const Args& p, int slices, cudaStream_t stream) {
  dim3 grid((unsigned)cdiv(p.N, BN), (unsigned)cdiv(p.M, BM), slices);
  mu_gemm<AT, BT, EPI><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t sum_all(const float* part, long long count, float scale,
                    float* out, cudaStream_t stream) {
  sum_partials<<<1, SUM_THREADS, 0, stream>>>(part, count, scale, out);
  return cudaGetLastError();
}

}  // namespace

#define CHECK(call)                        \
  do {                                     \
    cudaError_t err_ = (call);             \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// Workspace of B4, in floats: lam (m x n), the per-block partials of
// sum(h'), and the per-slice partials of A and B.
extern "C" long long snmf_mu_pass1_workspace(int m, int r, long long n) {
  int slices;
  long long kchunk;
  stat_slices(n, &slices, &kchunk);
  return (long long)m * n + cdiv(r, BM) * cdiv(n, BN) +
         2LL * slices * m * r;
}

extern "C" int snmf_mu_pass1(const float* v, const float* h, const float* w,
                             float sparsity, float* h_new, float* a,
                             float* b, float* sp_sum, float* workspace, int m,
                             int r, long long n, void* stream_p) {
  cudaStream_t stream = (cudaStream_t)stream_p;
  int slices;
  long long kchunk;
  stat_slices(n, &slices, &kchunk);
  float* lam = workspace;
  float* part_h = lam + (size_t)m * n;
  const long long n_part_h = cdiv(r, BM) * cdiv(n, BN);
  float* part_a = part_h + n_part_h;
  float* part_b = part_a + (size_t)slices * m * r;

  Args p = {};
  // 1. lam = max(W h, flr): M = m, N = n, K = r
  p.a0 = w; p.lda = r; p.b0 = h; p.ldb = n;
  p.M = m; p.N = (int)n; p.K = r; p.kchunk = r;
  p.out0 = lam; p.ldc = n;
  CHECK((launch<false, false, EPI_LAM>(p, 1, stream)));

  // 2. h' = h * (W^T v) / max(W^T lam + sp, flr): M = r, N = n, K = m
  p = Args{};
  p.a0 = w; p.lda = r; p.b0 = v; p.b1 = lam; p.ldb = n;
  p.M = r; p.N = (int)n; p.K = m; p.kchunk = m;
  p.out0 = h_new; p.ldc = n; p.e = h; p.sp = sparsity; p.partial = part_h;
  CHECK((launch<true, false, EPI_HUPD>(p, 1, stream)));

  // 3. lam' = max(W h', flr)
  p = Args{};
  p.a0 = w; p.lda = r; p.b0 = h_new; p.ldb = n;
  p.M = m; p.N = (int)n; p.K = r; p.kchunk = r;
  p.out0 = lam; p.ldc = n;
  CHECK((launch<false, false, EPI_LAM>(p, 1, stream)));

  // 4. v h'^T and lam' h'^T per frame slice: M = m, N = r, K = n
  p = Args{};
  p.a0 = v; p.a1 = lam; p.lda = n; p.b0 = h_new; p.ldb = n;
  p.M = m; p.N = r; p.K = n; p.kchunk = kchunk;
  p.out0 = part_a; p.out1 = part_b; p.ldc = r;
  CHECK((launch<false, true, EPI_STATS>(p, slices, stream)));

  // 5. the fixed-order sums
  const long long mr = (long long)m * r;
  const unsigned blocks = (unsigned)cdiv(mr, 256);
  sum_slices<<<blocks, 256, 0, stream>>>(part_a, a, mr, slices);
  CHECK(cudaGetLastError());
  sum_slices<<<blocks, 256, 0, stream>>>(part_b, b, mr, slices);
  CHECK(cudaGetLastError());
  CHECK(sum_all(part_h, n_part_h, sparsity, sp_sum, stream));
  return 0;
}

// Workspace of B5, in floats: one partial per block of W h.
extern "C" long long snmf_mu_pass2_workspace(int m, int r, long long n) {
  return cdiv(m, BM) * cdiv(n, BN);
}

extern "C" int snmf_mu_pass2(const float* v, const float* h, const float* w,
                             float* div, float* workspace, int m, int r,
                             long long n, void* stream_p) {
  cudaStream_t stream = (cudaStream_t)stream_p;
  Args p = {};
  p.a0 = w; p.lda = r; p.b0 = h; p.ldb = n;
  p.M = m; p.N = (int)n; p.K = r; p.kchunk = r;
  p.ldc = n; p.e = v; p.partial = workspace;
  CHECK((launch<false, false, EPI_DIV>(p, 1, stream)));
  CHECK(sum_all(workspace, cdiv(m, BM) * cdiv(n, BN), 1.f, div, stream));
  return 0;
}

extern "C" const char* snmf_mu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
