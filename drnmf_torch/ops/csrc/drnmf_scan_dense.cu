// Dense DR-NMF recurrence (full (2r, 2r) U and S matrices), the whole time
// scan in one cooperative launch.
//
// Replaces drnmf_tpu/ops/pallas/drnmf_scan.py::_kernel (entry
// drnmf_scan_pallas).  Per timestep t and batch row, with h the carried
// state (N = 2r wide) and x_t the input frame (F wide):
//
//   layer k:  hid_k = relu(h @ U_k + hid_{k-1} @ S_{k-1} + x_t @ W_k + b_k)
//             U_0 = u1, U_{k>0} = uk; the S term only for k > 0
//   h         = mask[b, t] ? hid_{K-1} : h;   out[b, t, :] = h
//
// What bounds it on an H100.  Per row and step 2*N*N*(2K-1) + 2*F*N*K flops
// (77.1 MFLOP at K=5, F=257, N=2000), so B=256, T=1021 is 20.2 TFLOP:
// 301 ms at the 67 TFLOP/s f32 rate of the CUDA cores.  The weights (u1,
// uk, K-1 S matrices, K W matrices: 106 MB at the flagship) fit neither
// shared memory nor the 50 MB L2, so they come from HBM; read once a step
// that is 108 GB, 32 ms at 3.35 TB/s.  Bound by operations at a large
// batch, by the weight reads at a batch of a few rows.
//
// What this design does about it.  The TPU kernel pins the weight stack in
// VMEM and walks a sequential time grid.  Here a split of the batch over
// blocks (as the factored kernel does) would have every block read all
// 106 MB from HBM at every step.  Instead each layer is one tiled product
//   [h | hid_{k-1} | x_t] (B x (2N+F))  @  [U_k ; S_{k-1} ; W_k] ((2N+F) x N)
// whose TM x TN output tiles are spread over the blocks of ONE cooperative
// launch, so a weight element is read once per row tile per step.  The
// activations (h, hid: N x B each, stored contraction-major so a tile loads
// coalesced) live in a small global scratch that stays in L2; the grid
// synchronises after each layer (K grid syncs a step), which orders the
// carry from layer to layer and from step to step.  Blocks are persistent:
// grid = min(tiles, co-resident blocks), each block walking its tiles.
// The tile (TM, TN in {16, 32, 64}) is chosen by the caller from the batch
// so that a small batch still spreads the weight reads over the card.
// Known costs: f32 FMA on the CUDA cores with a 256-thread tile kernel
// (no tensor cores, no TMA), a grid sync per layer, and the activations
// re-read from L2 by every column tile.
//
// Every output element is summed by one thread in a fixed order (U term,
// then S, then W, each over ascending k, then the bias): a repeat is equal
// bit for bit.  Ragged edges are masked; rows are padded to the tile by the
// caller.  Plain C interface (loaded with ctypes); launches on the caller's
// stream, allocates nothing, returns the CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int KT = 32;        // contraction depth per shared-memory tile

struct Params {
  const float* xT;            // (T, F, Bp): frames, batch innermost
  const unsigned char* mask;  // (B, T)
  const float* u1;            // (N, N)
  const float* uk;            // (N, N)
  const float* s;             // (max(1, K-1), N, N)
  const float* w;             // (K, F, N)
  const float* b;             // (K, N)
  float* state;               // (4, N, Bp): h (2 buffers), hid (2 buffers)
  float* out;                 // (B, T, N)
  int B, Bp, T, F, N, K;
};

// One stretch of the contraction: activations a (len x Bp, written by this
// kernel, so read through L2) against weights w (len x N, read-only).
struct Seg {
  const float* a;
  const float* w;
  int len;
};

template <int TM>
__device__ __forceinline__ void load_a(const Seg& sg, int Bp, int k0, int m0,
                                       float (&reg)[TM * KT / THREADS]) {
#pragma unroll
  for (int q = 0; q < TM * KT / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int k = k0 + e / TM;
    reg[q] = k < sg.len ? __ldcg(sg.a + (size_t)k * Bp + m0 + e % TM) : 0.f;
  }
}

template <int TN>
__device__ __forceinline__ void load_w(const Seg& sg, int N, int k0, int n0,
                                       float (&reg)[TN * KT / THREADS]) {
#pragma unroll
  for (int q = 0; q < TN * KT / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int k = k0 + e / TN;
    const int j = n0 + e % TN;
    reg[q] = (k < sg.len && j < N) ? __ldg(sg.w + (size_t)k * N + j) : 0.f;
  }
}

template <int W>
__device__ __forceinline__ void store_tile(float (*s)[W],
                                           const float (&reg)[W * KT / THREADS]) {
#pragma unroll
  for (int q = 0; q < W * KT / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    s[e / W][e % W] = reg[q];
  }
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

template <int TM, int TN>
__global__ void __launch_bounds__(THREADS) drnmf_scan_dense_kernel(Params p) {
  constexpr int RM = TM / 16;  // rows per thread
  constexpr int CN = TN / 16;  // columns per thread
  __shared__ __align__(16) float sa[KT][TM];
  __shared__ __align__(16) float sb[KT][TN];

  cg::grid_group grid = cg::this_grid();
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int N = p.N, Bp = p.Bp;
  const size_t plane = (size_t)N * Bp;
  const int col_tiles = (N + TN - 1) / TN;
  const int tiles = (Bp / TM) * col_tiles;

  for (int t = 0; t < p.T; ++t) {
    const float* h_cur = p.state + (size_t)(t & 1) * plane;
    float* h_next = p.state + (size_t)((t + 1) & 1) * plane;
    const float* x_t = p.xT + (size_t)t * p.F * Bp;

    for (int k = 0; k < p.K; ++k) {
      const bool last = k == p.K - 1;
      float* hid_out = p.state + (size_t)(2 + (k & 1)) * plane;
      // the contraction in the order U, S, W
      Seg seg[3];
      seg[0] = {h_cur, k == 0 ? p.u1 : p.uk, N};
      seg[1] = {p.state + (size_t)(2 + ((k + 1) & 1)) * plane,
                p.s + (size_t)(k > 0 ? k - 1 : 0) * N * N, k > 0 ? N : 0};
      seg[2] = {x_t, p.w + (size_t)k * p.F * N, p.F};
      const int c1 = (seg[0].len + KT - 1) / KT;
      const int c2 = c1 + (seg[1].len + KT - 1) / KT;
      const int chunks = c2 + (seg[2].len + KT - 1) / KT;
      const float* bias = p.b + (size_t)k * N;

      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / col_tiles) * TM;
        const int n0 = (tile % col_tiles) * TN;
        float acc[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

        float ra[TM * KT / THREADS], rb[TN * KT / THREADS];
        auto fetch = [&](int c) {
          const int si = c < c1 ? 0 : (c < c2 ? 1 : 2);
          const int k0 = (c - (si == 0 ? 0 : (si == 1 ? c1 : c2))) * KT;
          load_a<TM>(seg[si], Bp, k0, m0, ra);
          load_w<TN>(seg[si], N, k0, n0, rb);
        };
        fetch(0);
        store_tile<TM>(sa, ra);
        store_tile<TN>(sb, rb);
        __syncthreads();
        for (int c = 0; c < chunks; ++c) {
          const bool more = c + 1 < chunks;
          if (more) fetch(c + 1);  // in flight during the products
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            float a[RM], w[CN];
            load_frag<RM>(&sa[kk][ty * RM], a);
            load_frag<CN>(&sb[kk][tx * CN], w);
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
              for (int j = 0; j < CN; ++j)
                acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
          }
          __syncthreads();
          if (more) {
            store_tile<TM>(sa, ra);
            store_tile<TN>(sb, rb);
            __syncthreads();
          }
        }

#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int col = n0 + tx * CN + j;
          if (col >= N) continue;
          const float bj = __ldg(bias + col);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int row = m0 + ty * RM + i;
            const size_t at = (size_t)col * Bp + row;
            float v = fmaxf(acc[i][j] + bj, 0.f);
            if (!last) {
              hid_out[at] = v;
              continue;
            }
            const bool valid = row < p.B && p.mask[(size_t)row * p.T + t];
            if (!valid) v = __ldcg(h_cur + at);  // a masked step holds
            h_next[at] = v;
            if (row < p.B) p.out[((size_t)row * p.T + t) * N + col] = v;
          }
        }
      }
      grid.sync();  // layer k is complete before anything reads it
    }
  }
}

using Kernel = void (*)(Params);

Kernel pick(int tm, int tn) {
#define DRNMF_PICK(M, Nn) \
  if (tm == M && tn == Nn) return drnmf_scan_dense_kernel<M, Nn>;
  DRNMF_PICK(16, 16) DRNMF_PICK(16, 32) DRNMF_PICK(16, 64)
  DRNMF_PICK(32, 16) DRNMF_PICK(32, 32) DRNMF_PICK(32, 64)
  DRNMF_PICK(64, 16) DRNMF_PICK(64, 32) DRNMF_PICK(64, 64)
#undef DRNMF_PICK
  return nullptr;
}

}  // namespace

// The number of blocks of the (tm, tn) kernel that the current device keeps
// resident at once, which bounds the grid of a cooperative launch; 0 when
// the device has no cooperative launch or the tile is not built; a negative
// CUDA error code on failure.
extern "C" int drnmf_scan_dense_capacity(int tm, int tn) {
  Kernel kernel = pick(tm, tn);
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

extern "C" int drnmf_scan_dense(const float* xT, const unsigned char* mask,
                                const float* u1, const float* uk,
                                const float* s, const float* w,
                                const float* b, float* state, float* out,
                                int B, int Bp, int T, int F, int N, int K,
                                int tm, int tn, int grid, void* stream) {
  Kernel kernel = pick(tm, tn);
  if (kernel == nullptr || Bp % tm != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  Params p{xT, mask, u1, uk, s, w, b, state, out, B, Bp, T, F, N, K};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(grid), dim3(THREADS), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* drnmf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
