// Folded + factored DR-NMF recurrence (kernel B1), the whole time scan in
// one cooperative launch.
//
// Replaces drnmf_tpu/ops/pallas/drnmf_scan.py::_kernel_factored (entry
// drnmf_scan_pallas_factored).  Per timestep t and batch row, with h the
// carried state (N = 2r wide) and x_t the input frame (F wide):
//
//   rs        = rowsum(h)
//   layer 0:  hid = relu(h*(diag1 - off1) + off1*rs + x_t @ dka_0 + b_0)
//   layer k:  hid = relu(c*rs + hid + (x_t - hid @ dkT_{k-1}) @ dka_k + b_k)
//   h         = mask[b, t] ? hid : h;   out[b, t, :] = h
//
// What bounds it on an H100.  Per row and step the two thin products of
// each layer cost 2*F*N*(2K-1) flops (9.25 MFLOP at K=5, F=257, N=2000)
// against a weight stack (dka (K,F,N) + dkT (K-1,N,F): 18.5 MB in f32) that
// fits the 50 MB L2, so at a large batch the f32 rate of the CUDA cores
// binds it: 2.42 TFLOP for B=256, T=1021, 36 ms at 67 TFLOP/s.  At a few
// rows the work of a step is a few MFLOP spread over the card, and the
// chain of dependent phases binds it: L2 latency per contraction chunk and
// one grid synchronisation between phases.
//
// What this design does about it.  Every half-layer is one tiled product
// whose output tiles are spread over the persistent blocks of ONE
// cooperative launch (the tile loop of drnmf_scan_dense.cu, kernel B3), so
// each weight element is read from L2 once per row tile per step rather
// than once per block, and no SM's own load path binds the kernel.  The
// activations live in a small global scratch that stays in L2, stored
// batch-innermost (contraction-major) so that a tile loads coalesced.
// Phases of step t, each a grid-stride loop over its work items, with a
// grid sync after each (1 + 3(K-1) a step):
//
//   P_0   hid_0 = relu(h*(diag1-off1) + off1*rs + x_t @ dka_0 + b_0);
//         rs = the rowsums of the carry, from its partial sums rsp.
//   BP_k  part[s] = hid_{k-1}[rows s*L..(s+1)*L) @ dkT_{k-1}[same rows]:
//         the back-projection split over S fixed stretches of length L of
//         its contraction (2r), so that a few rows still fill the card.
//   R_k   resid = x_t - part[0] - part[1] - ... - part[S-1], elementwise.
//   P_k   hid_k = relu(c*rs + hid_{k-1} + resid @ dka_k + b_k).  The last
//         layer holds masked steps from the carry, writes the next carry
//         and the output, and the carry's partial rowsums over fixed groups
//         of GROUP columns into rsp (double-buffered by step).
//
// Invariants.  Every output element is summed by one thread in a fixed
// order: contraction chunks of KT ascending (and within a chunk ascending),
// then the splits ascending, then the epilogue terms; rowsums add GROUP
// columns in column order, then the groups in group order.  No float
// atomics, so a repeat is bit-equal.  L (a multiple of KT) and the column
// groups are fixed by (F, 2r) alone, and no sum depends on the tile a
// value falls in, so a row's bits depend on neither the batch size nor the
// grid: only which rows share a tile varies with B.  Ragged edges are
// masked (zero-filled loads, guarded stores), offsets are 64-bit, rows
// past B run on zeros and are never written out.  f32 FMA on the CUDA
// cores; no tensor cores, no shared-memory-resident weights.
//
// Training (h_all set): the projection's epilogue also writes each layer's
// hidden plane of each step, (K, N, T*Bp) with the batch innermost, so the
// backward kernel (drnmf_scan_factored_bwd.cu) and the weight-gradient
// products read it as it is; the last layer is written before a masked
// step holds the carry.  It is an instantiation of its own (KEEP, with
// its own capacity), so with h_all null the kernel is the one without it.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing (the caller hands it the scratch), returns the CUDA
// error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int KT = 32;        // contraction depth per shared-memory tile
constexpr int MAX_TW = 64;    // widest column tile
constexpr int GROUP = 16;     // columns of one partial rowsum

struct Params {
  const float* xT;            // (T, F, Bp): frames, batch innermost
  const unsigned char* mask;  // (B, T)
  const float* diag1;         // (N)
  const float* off1;          // (1)
  const float* c_uk;          // (1)
  const float* dkt;           // (max(1, K-1), N, F)
  const float* dka;           // (K, F, N)
  const float* b;             // (K, N)
  float* h;                   // (2, N, Bp): carry by step parity, h[0] = h0
  float* hid;                 // (2, N, Bp): hidden state by layer parity
  float* part;                // (S, F, Bp): back-projection partials
  float* resid;               // (F, Bp)
  float* rsp;                 // (2, G, Bp): partial rowsums by step parity
  float* rs;                  // (Bp): rowsums of the step's carry
  float* out;                 // (B, T, N)
  float* h_all;               // (K, N, T*Bp) every layer's hidden, or null
  int B, Bp, T, F, N, K;
  int tn, tf;                 // column tiles of the projects, of BP
  int split, splits, groups;  // L, S, G
};

// A KT x TM slice of activations (len x Bp, contraction-major, written by
// this kernel, so read through L2 only) into registers.
template <int TM>
__device__ __forceinline__ void load_a(const float* a, int len, int Bp,
                                       int k0, int m0,
                                       float (&reg)[TM * KT / THREADS]) {
#pragma unroll
  for (int q = 0; q < TM * KT / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int k = k0 + e / TM;
    reg[q] = k < len ? __ldcg(a + (size_t)k * Bp + m0 + e % TM) : 0.f;
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

// acc = a[0:len, m0:m0+TM]^T @ w[0:len, n0:n0+TW].  Thread (ty, tx) owns
// rows ty*RM.. and columns tx*CW..; each of its sums is one fmaf chain over
// the contraction in ascending order, whatever the tile.  The next chunk
// is in flight in registers while the current one is multiplied.  Ends
// with a barrier, so the caller may reuse smem.
template <int TM, int TW>
__device__ __forceinline__ void tile_product(const float* a,
                                             const float* __restrict__ w,
                                             int len, int Bp, int ncols,
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
  load_a<TM>(a, len, Bp, 0, m0, ra);
  load_w<TW>(w, len, ncols, 0, n0, rb);
  store_tile<TM>(sa, ra);
  store_tile<TW>(sb, rb);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    if (more) {  // in flight during the products
      load_a<TM>(a, len, Bp, (c + 1) * KT, m0, ra);
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

// P_k: layer k's projection and epilogue over output tiles TM x TN of
// (Bp x N).  srs holds the rowsums of the tile's rows.  KEEP: also write
// the layer's plane of this step into h_all.
template <int TM, int TN, bool KEEP>
__device__ __forceinline__ void project_phase(const Params& p, int t, int k,
                                              float* smem, float* srs) {
  constexpr int RM = TM / 16;
  constexpr int CN = TN / 16;
  const int N = p.N, Bp = p.Bp;
  const bool first = k == 0;
  const bool last = k == p.K - 1;
  const size_t plane = (size_t)N * Bp;
  const float* a = first ? p.xT + (size_t)t * p.F * Bp : p.resid;
  const float* w = p.dka + (size_t)k * p.F * N;
  const float* bias = p.b + (size_t)k * N;
  const float* h_cur = p.h + (size_t)(t & 1) * plane;
  float* h_next = p.h + (size_t)((t + 1) & 1) * plane;
  const float* hid_in = p.hid + (size_t)((k + 1) & 1) * plane;  // layer k-1
  float* hid_out = p.hid + (size_t)(k & 1) * plane;
  const float* rsp_cur = p.rsp + (size_t)(t & 1) * p.groups * Bp;
  float* rsp_next = p.rsp + (size_t)((t + 1) & 1) * p.groups * Bp;
  const float off1 = __ldg(p.off1);
  const float c_uk = __ldg(p.c_uk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int col_tiles = (N + TN - 1) / TN;
  const int tiles = (Bp / TM) * col_tiles;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / col_tiles) * TM;
    const int n0 = (tile % col_tiles) * TN;
    float acc[RM][CN];
    tile_product<TM, TN>(a, w, p.F, Bp, N, m0, n0, smem, acc);

    if (threadIdx.x < TM) {
      const int row = m0 + threadIdx.x;
      float s;
      if (first) {  // the groups in group order
        s = 0.f;
#pragma unroll 8
        for (int g = 0; g < p.groups; ++g)
          s += __ldcg(rsp_cur + (size_t)g * Bp + row);
        if (n0 == 0) p.rs[row] = s;  // for the later layers of the step
      } else {
        s = __ldcg(p.rs + row);
      }
      srs[threadIdx.x] = s;
    }
    __syncthreads();

    float* tile_v = smem;  // [TN][TM]: the new carry, for its rowsums
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int cl = tx * CN + j;
      const int col = n0 + cl;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rl = ty * RM + i;
        const int row = m0 + rl;
        const size_t at = (size_t)col * Bp + row;
        float v = 0.f;
        if (col < N) {
          const float pre =
              first ? __ldcg(h_cur + at) * (__ldg(p.diag1 + col) - off1) +
                          off1 * srs[rl]
                    : c_uk * srs[rl] + __ldcg(hid_in + at);
          v = fmaxf(pre + acc[i][j] + __ldg(bias + col), 0.f);
          // the training forward keeps every layer, the last one before
          // a masked step takes the carry back (its backward tests v > 0)
          if constexpr (KEEP)
            p.h_all[((size_t)k * N + col) * ((size_t)p.T * Bp) +
                    (size_t)t * Bp + row] = v;
          if (!last) {
            hid_out[at] = v;
          } else {
            const bool valid = row < p.B && p.mask[(size_t)row * p.T + t];
            if (!valid) v = __ldcg(h_cur + at);  // a masked step holds
            h_next[at] = v;
            if (row < p.B) p.out[((size_t)row * p.T + t) * N + col] = v;
          }
        }
        if (last) tile_v[cl * TM + rl] = v;  // 0 past N
      }
    }
    if (last) {
      __syncthreads();
      // partial rowsums of the new carry, GROUP columns in column order
      for (int e = threadIdx.x; e < TM * (TN / GROUP); e += THREADS) {
        const int rl = e % TM;
        const int g = e / TM;
        if (n0 + g * GROUP >= N) continue;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < GROUP; ++c) s += tile_v[(g * GROUP + c) * TM + rl];
        rsp_next[(size_t)(n0 / GROUP + g) * Bp + m0 + rl] = s;
      }
    }
    __syncthreads();  // smem and srs are reused by the next tile
  }
}

// BP_k: part[s] = hid_{k-1}[s*L:(s+1)*L]^T @ dkT_{k-1}[s*L:(s+1)*L] over
// work items (row tile, F-column tile TF, split s).
template <int TM, int TF>
__device__ __forceinline__ void back_project_phase(const Params& p, int k,
                                                   float* smem) {
  constexpr int RM = TM / 16;
  constexpr int CF = TF / 16;
  const int F = p.F, N = p.N, Bp = p.Bp;
  const float* hid_in = p.hid + (size_t)((k + 1) & 1) * N * Bp;  // layer k-1
  const float* w = p.dkt + (size_t)(k - 1) * N * F;
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
    tile_product<TM, TF>(hid_in + (size_t)k0 * Bp, w + (size_t)k0 * F, len,
                         Bp, F, m0, f0, smem, acc);
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

// R_k: resid = x_t - part[0] - ... - part[S-1], elementwise over (F, Bp).
__device__ __forceinline__ void residual_phase(const Params& p, int t) {
  const size_t n = (size_t)p.F * p.Bp;
  const float* x_t = p.xT + (size_t)t * n;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * THREADS) {
    float v = __ldg(x_t + e);
    for (int s = 0; s < p.splits; ++s) v -= __ldcg(p.part + s * n + e);
    p.resid[e] = v;
  }
}

template <int TM, bool KEEP>
__device__ __forceinline__ void project(const Params& p, int t, int k,
                                        float* smem, float* srs) {
  if (p.tn == 16) project_phase<TM, 16, KEEP>(p, t, k, smem, srs);
  else if (p.tn == 32) project_phase<TM, 32, KEEP>(p, t, k, smem, srs);
  else project_phase<TM, 64, KEEP>(p, t, k, smem, srs);
}

template <int TM>
__device__ __forceinline__ void back_project(const Params& p, int k,
                                             float* smem) {
  if (p.tf == 16) back_project_phase<TM, 16>(p, k, smem);
  else if (p.tf == 32) back_project_phase<TM, 32>(p, k, smem);
  else back_project_phase<TM, 64>(p, k, smem);
}

template <int TM, bool KEEP>
__global__ void __launch_bounds__(THREADS)
drnmf_scan_factored_kernel(Params p) {
  __shared__ __align__(16) float smem[KT * (TM + MAX_TW)];
  __shared__ float srs[TM];
  cg::grid_group grid = cg::this_grid();

  // partial rowsums of h0, GROUP columns in column order, as the last
  // layer's epilogue sums every later carry
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < p.groups * p.Bp;
       e += gridDim.x * THREADS) {
    const int g = e / p.Bp;
    const int row = e % p.Bp;
    float s = 0.f;
    for (int c = 0; c < GROUP; ++c) {
      const int col = g * GROUP + c;
      s += col < p.N ? p.h[(size_t)col * p.Bp + row] : 0.f;
    }
    p.rsp[e] = s;
  }
  grid.sync();

  for (int t = 0; t < p.T; ++t) {
    project<TM, KEEP>(p, t, 0, smem, srs);
    grid.sync();
    for (int k = 1; k < p.K; ++k) {
      back_project<TM>(p, k, smem);
      grid.sync();
      residual_phase(p, t);
      grid.sync();
      project<TM, KEEP>(p, t, k, smem, srs);
      grid.sync();
    }
  }
}

__global__ void __launch_bounds__(THREADS) grid_sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

using Kernel = void (*)(Params);

Kernel pick(int tm, bool keep) {
  if (tm == 16) return keep ? drnmf_scan_factored_kernel<16, true>
                            : drnmf_scan_factored_kernel<16, false>;
  if (tm == 32) return keep ? drnmf_scan_factored_kernel<32, true>
                            : drnmf_scan_factored_kernel<32, false>;
  if (tm == 64) return keep ? drnmf_scan_factored_kernel<64, true>
                            : drnmf_scan_factored_kernel<64, false>;
  return nullptr;
}

bool is_tile(int w) { return w == 16 || w == 32 || w == 64; }

// The number of blocks of the tm-row kernel that the current device keeps
// resident at once, which bounds the grid of a cooperative launch; 0 when
// the device has no cooperative launch or tm is not built; a negative CUDA
// error code on failure.
int capacity(int tm, bool keep) {
  Kernel kernel = pick(tm, keep);
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

}  // namespace

extern "C" int drnmf_scan_factored_capacity(int tm) {
  return capacity(tm, false);
}

// capacity of the kernel that keeps every layer (h_all set)
extern "C" int drnmf_scan_factored_keep_capacity(int tm) {
  return capacity(tm, true);
}

extern "C" int drnmf_scan_factored(
    const float* xT, const unsigned char* mask, const float* diag1,
    const float* off1, const float* c_uk, const float* dkt, const float* dka,
    const float* b, float* h, float* hid, float* part, float* resid,
    float* rsp, float* rs, float* out, float* h_all, int B, int Bp, int T,
    int F, int N, int K, int tm, int tn, int tf, int split, int splits,
    int groups, int grid, void* stream) {
  Kernel kernel = pick(tm, h_all != nullptr);
  if (kernel == nullptr || !is_tile(tn) || !is_tile(tf) || Bp % tm != 0 ||
      K < 1 || split < 1 || split % KT != 0 ||
      splits != (N + split - 1) / split || groups != (N + GROUP - 1) / GROUP ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  Params p{xT,   mask,  diag1, off1, c_uk, dkt, dka, b,     h,      hid,
           part, resid, rsp,   rs,   out,  h_all, B,  Bp,  T,     F,
           N,    K,     tn,    tf,   split, splits, groups};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(grid), dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// n grid syncs of a grid of `grid` blocks of the kernel's width and
// nothing else: what one sync of the scan costs.  A measurement aid.
extern "C" int drnmf_grid_sync_probe(int n, int grid, void* stream) {
  void* args[] = {&n};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)grid_sync_probe_kernel, dim3(grid), dim3(THREADS), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* drnmf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
