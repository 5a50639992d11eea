// Fused PDHG iteration chunks for Hopper (sm_90a): a banded and a dense
// kernel, each running `iters` restarted-PDHG iterations per launch with
// the instance's iterate held on chip, writing x, y, x_sum, y_sum once.
//
// What they replace (dervet_tpu/ops/pallas_chunk.py):
//   banded_chunk_kernel  <- _banded_chunk_kernel (:246), built by
//                           _build_banded_call (:367)
//   dense_chunk_kernel   <- _chunk_kernel (:105), built by _build_call (:182)
//
// The iteration (one application of the PDHG operator T, then the step
// variant), for one instance with per-instance tau = eta/omega and
// sigma = eta*omega:
//   x1 = clip(x - tau (c - K^T y), l, u)
//   y1 = max(y + sigma (q - K (2 x1 - x)), floor)   floor: -inf on the
//                                                    first n_eq rows, else 0
//   vanilla:   (x, y) <- (x1, y1)
//   reflected: (x, y) <- proj(z + alpha (T(z) - z))
//   halpern:   (x, y) <- proj(lam (z + alpha (T(z) - z)) + (1 - lam) anchor),
//              lam = (k + 1) / (k + 2), k counting on from k0
//   x_sum += x, y_sum += y after every iteration.
//
// Design.  The TPU kernels block 128 instances per grid step so the MXU
// sees (128, m) @ (m, n) products.  Here each thread block owns ONE
// instance (B blocks; 1536 at the smoke's monthly fan-out fills the 132
// SMs many times over), 512 threads.  The instance's x, 2x1 - x, x_sum,
// c, l, u (x space) and y, y_sum, q (y space) live in shared memory for
// the whole chunk, so the iterate never leaves the SM between the two
// dependent phases of an iteration (K^T y feeds the x projection, whose
// reflected point feeds K x; a __syncthreads separates them).  Matrix
// data shared by the batch (the band diagonals and the wide-row values W,
// or the dense K) is read through L2 on every iteration.
//   banded: out[i] = sum_b diags[b, i] x[i + d_b];  out[j] = sum_b
//           diags[b, j - d_b] y[j - d_b]; the low-rank wide pair
//           K_wide = P @ W travels as the row index of each P column
//           (wide_rows), so K_wide x adds (W x)_k at row wide_rows[k]
//           and K_wide^T y adds sum_k y[wide_rows[k]] W[k, j].
//   dense:  K^T y with one thread per column (coalesced rows of K), K x
//           with one warp per row and a shuffle reduction.
// Products are plain fp32 FMAs: no TF32, no tensor cores (PDHG does not
// converge on single-pass low-precision products, PERF.md).
//
// What bounds it.  At the monthly window with daily-cycle rows (m=776,
// n=2976, 4 bands, r=31 wide rows) an iteration costs 2*4*776 ~ 6.2k MACs
// of band work and 2*31*2976 ~ 185k MACs of wide-pair work per instance,
// although only 743 of W's 92,256 values are non-zero (0.8%).  So the
// banded kernel, like the TPU kernel it replaces, spends ~30x the band
// work on W's zeros and is bound by operations (fp32 FMA rate, with W
// streamed from L2), not by bytes: each launch moves the instance state
// in and out once, ~100 KB per instance.  Exploiting W's sparsity is
// left for later.  The dense kernel (weekly windows, K 169x672 = 454 KB,
// too large for one block's shared memory) streams K from L2 twice per
// iteration; it is bound by operations as well (2*m*n MACs/iteration).
//
// Interface: plain C, loaded with ctypes.  Every entry takes device
// pointers, sizes and the CUDA stream, launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

enum Variant { kVanilla = 0, kReflected = 1, kHalpern = 2 };

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// projection onto the dual cone: free on equality rows, >= 0 otherwise
__device__ __forceinline__ float yproj(float v, int i, int n_eq) {
  return i < n_eq ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// Primal half of one iteration for column j, given g = (K^T y)[j]:
// writes the reflected point 2 x1 - x and the variant's new x.
template <int V>
__device__ __forceinline__ void primal_update(
    int j, float g, float tau, float alpha, float lam, const float* ax_g,
    float* sx, float* sxb, float* sxs, const float* sc, const float* sl,
    const float* su) {
  const float x = sx[j];
  const float l = sl[j], u = su[j];
  const float x1 = clip(x - tau * (sc[j] - g), l, u);
  sxb[j] = 2.0f * x1 - x;
  float xn;
  if (V == kVanilla) {
    xn = x1;
  } else if (V == kReflected) {
    xn = clip(x + alpha * (x1 - x), l, u);
  } else {
    const float xr = x + alpha * (x1 - x);
    xn = clip(lam * xr + (1.0f - lam) * ax_g[j], l, u);
  }
  sx[j] = xn;
  sxs[j] += xn;
}

// Dual half of one iteration for row i, given kx = (K (2 x1 - x))[i].
template <int V>
__device__ __forceinline__ void dual_update(
    int i, float kx, float sig, float alpha, float lam, int n_eq,
    const float* ay_g, float* sy, float* sys, const float* sq) {
  const float y = sy[i];
  const float y1 = yproj(y + sig * (sq[i] - kx), i, n_eq);
  float yn;
  if (V == kVanilla) {
    yn = y1;
  } else if (V == kReflected) {
    yn = yproj(y + alpha * (y1 - y), i, n_eq);
  } else {
    const float yr = y + alpha * (y1 - y);
    yn = yproj(lam * yr + (1.0f - lam) * ay_g[i], i, n_eq);
  }
  sy[i] = yn;
  sys[i] += yn;
}

// Shared-memory carve-up common to both kernels: x space then y space.
struct Smem {
  float *sx, *sxb, *sxs, *sc, *sl, *su, *sy, *sys, *sq;
};

__device__ __forceinline__ Smem carve(float* base, int m, int n) {
  Smem s;
  s.sx = base;
  s.sxb = s.sx + n;
  s.sxs = s.sxb + n;
  s.sc = s.sxs + n;
  s.sl = s.sc + n;
  s.su = s.sl + n;
  s.sy = s.su + n;
  s.sys = s.sy + m;
  s.sq = s.sys + m;
  return s;
}

__device__ __forceinline__ void load_state(
    const Smem& s, int b, int m, int n, const float* c, const float* q,
    const float* l, const float* u, const float* x, const float* y,
    const float* xs, const float* ys) {
  const size_t ox = (size_t)b * n, oy = (size_t)b * m;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    s.sx[j] = x[ox + j];
    s.sxs[j] = xs[ox + j];
    s.sc[j] = c[ox + j];
    s.sl[j] = l[ox + j];
    s.su[j] = u[ox + j];
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s.sy[i] = y[oy + i];
    s.sys[i] = ys[oy + i];
    s.sq[i] = q[oy + i];
  }
}

__device__ __forceinline__ void store_state(
    const Smem& s, int b, int m, int n, float* xo, float* yo, float* xso,
    float* yso) {
  const size_t ox = (size_t)b * n, oy = (size_t)b * m;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    xo[ox + j] = s.sx[j];
    xso[ox + j] = s.sxs[j];
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    yo[oy + i] = s.sy[i];
    yso[oy + i] = s.sys[i];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) banded_chunk_kernel(
    const float* __restrict__ c, const float* __restrict__ q,
    const float* __restrict__ l, const float* __restrict__ u,
    const float* __restrict__ tau_v, const float* __restrict__ sig_v,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ diags, const int* __restrict__ offsets,
    int nb, const int* __restrict__ wide_rows,
    const float* __restrict__ wide_w, int r,
    const float* __restrict__ k0_v, const float* __restrict__ ax,
    const float* __restrict__ ay, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ xso,
    float* __restrict__ yso, int m, int n, int n_eq, int iters,
    float alpha) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  Smem s = carve(smem, m, n);
  float* swide = s.sq + m;                          // (r) W @ (2 x1 - x)
  int* soff = reinterpret_cast<int*>(swide + r);    // (nb) band offsets
  int* sslot = soff + nb;                           // (m) row -> wide k
  load_state(s, b, m, n, c, q, l, u, x, y, xs, ys);
  for (int t = threadIdx.x; t < nb; t += blockDim.x) soff[t] = offsets[t];
  for (int i = threadIdx.x; i < m; i += blockDim.x) sslot[i] = -1;
  __syncthreads();
  for (int k = threadIdx.x; k < r; k += blockDim.x) sslot[wide_rows[k]] = k;
  const float tau = tau_v[b], sig = sig_v[b];
  const float* ax_g = (V == kHalpern) ? ax + (size_t)b * n : nullptr;
  const float* ay_g = (V == kHalpern) ? ay + (size_t)b * m : nullptr;
  float kf = (V == kHalpern) ? k0_v[b] : 0.0f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float lam = (V == kHalpern) ? (kf + 1.0f) / (kf + 2.0f) : 0.0f;
    // phase 1: g = K^T y, then the primal update
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float g = 0.0f;
      for (int bb = 0; bb < nb; ++bb) {
        const int i = j - soff[bb];
        if (i >= 0 && i < m) g = fmaf(diags[(size_t)bb * m + i], s.sy[i], g);
      }
      if (r) {
        float gw = 0.0f;
        for (int k = 0; k < r; ++k)
          gw = fmaf(s.sy[wide_rows[k]], wide_w[(size_t)k * n + j], gw);
        g += gw;
      }
      primal_update<V>(j, g, tau, alpha, lam, ax_g, s.sx, s.sxb, s.sxs,
                       s.sc, s.sl, s.su);
    }
    __syncthreads();
    // phase 2a: the wide rows' products W @ (2 x1 - x), one warp per row
    for (int k = warp; k < r; k += kWarps) {
      float acc = 0.0f;
      const float* wk = wide_w + (size_t)k * n;
      for (int j = lane; j < n; j += 32) acc = fmaf(wk[j], s.sxb[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) swide[k] = acc;
    }
    if (r) __syncthreads();
    // phase 2b: K (2 x1 - x), then the dual update
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      float kx = 0.0f;
      for (int bb = 0; bb < nb; ++bb) {
        const int j = i + soff[bb];
        if (j >= 0 && j < n) kx = fmaf(diags[(size_t)bb * m + i], s.sxb[j], kx);
      }
      if (r) {
        const int k = sslot[i];
        if (k >= 0) kx += swide[k];
      }
      dual_update<V>(i, kx, sig, alpha, lam, n_eq, ay_g, s.sy, s.sys, s.sq);
    }
    __syncthreads();
    if (V == kHalpern) kf += 1.0f;
  }
  store_state(s, b, m, n, xo, yo, xso, yso);
}

template <int V>
__global__ void __launch_bounds__(kThreads) dense_chunk_kernel(
    const float* __restrict__ c, const float* __restrict__ q,
    const float* __restrict__ l, const float* __restrict__ u,
    const float* __restrict__ tau_v, const float* __restrict__ sig_v,
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ K, const float* __restrict__ k0_v,
    const float* __restrict__ ax, const float* __restrict__ ay,
    float* __restrict__ xo, float* __restrict__ yo,
    float* __restrict__ xso, float* __restrict__ yso, int m, int n,
    int n_eq, int iters, float alpha) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  Smem s = carve(smem, m, n);
  load_state(s, b, m, n, c, q, l, u, x, y, xs, ys);
  const float tau = tau_v[b], sig = sig_v[b];
  const float* ax_g = (V == kHalpern) ? ax + (size_t)b * n : nullptr;
  const float* ay_g = (V == kHalpern) ? ay + (size_t)b * m : nullptr;
  float kf = (V == kHalpern) ? k0_v[b] : 0.0f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float lam = (V == kHalpern) ? (kf + 1.0f) / (kf + 2.0f) : 0.0f;
    // phase 1: g = K^T y (one thread per column), then the primal update
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float g = 0.0f;
      for (int i = 0; i < m; ++i) g = fmaf(K[(size_t)i * n + j], s.sy[i], g);
      primal_update<V>(j, g, tau, alpha, lam, ax_g, s.sx, s.sxb, s.sxs,
                       s.sc, s.sl, s.su);
    }
    __syncthreads();
    // phase 2: K (2 x1 - x) (one warp per row), then the dual update
    for (int i = warp; i < m; i += kWarps) {
      float acc = 0.0f;
      const float* ki = K + (size_t)i * n;
      for (int j = lane; j < n; j += 32) acc = fmaf(ki[j], s.sxb[j], acc);
      acc = warp_sum(acc);
      if (lane == 0)
        dual_update<V>(i, acc, sig, alpha, lam, n_eq, ay_g, s.sy, s.sys, s.sq);
    }
    __syncthreads();
    if (V == kHalpern) kf += 1.0f;
  }
  store_state(s, b, m, n, xo, yo, xso, yso);
}

template <typename KernelT>
cudaError_t prepare(KernelT kernel, size_t smem_bytes) {
  if (smem_bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_bytes);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* fused_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared-memory bytes one block of each kernel needs (the wrapper's
// supports() budget uses the same formula).
size_t banded_chunk_smem_bytes(int m, int n, int nb, int r) {
  return sizeof(float) * (6 * (size_t)n + 3 * (size_t)m + r) +
         sizeof(int) * ((size_t)nb + m);
}

size_t dense_chunk_smem_bytes(int m, int n) {
  return sizeof(float) * (6 * (size_t)n + 3 * (size_t)m);
}

int banded_chunk(const float* c, const float* q, const float* l,
                 const float* u, const float* tau, const float* sig,
                 const float* x, const float* y, const float* xs,
                 const float* ys, const float* diags, const int* offsets,
                 int nb, const int* wide_rows, const float* wide_w, int r,
                 const float* k0, const float* ax, const float* ay,
                 float* xo, float* yo, float* xso, float* yso, int B, int m,
                 int n, int n_eq, int iters, int variant, float alpha,
                 void* stream) {
  const size_t smem = banded_chunk_smem_bytes(m, n, nb, r);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define LAUNCH_BANDED(V)                                                    \
  err = prepare(banded_chunk_kernel<V>, smem);                              \
  if (err != cudaSuccess) return (int)err;                                  \
  banded_chunk_kernel<V><<<B, kThreads, smem, st>>>(                        \
      c, q, l, u, tau, sig, x, y, xs, ys, diags, offsets, nb, wide_rows,   \
      wide_w, r, k0, ax, ay, xo, yo, xso, yso, m, n, n_eq, iters, alpha)
  switch (variant) {
    case kVanilla: LAUNCH_BANDED(kVanilla); break;
    case kReflected: LAUNCH_BANDED(kReflected); break;
    case kHalpern: LAUNCH_BANDED(kHalpern); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_BANDED
  return (int)cudaGetLastError();
}

int dense_chunk(const float* c, const float* q, const float* l,
                const float* u, const float* tau, const float* sig,
                const float* x, const float* y, const float* xs,
                const float* ys, const float* K, const float* k0,
                const float* ax, const float* ay, float* xo, float* yo,
                float* xso, float* yso, int B, int m, int n, int n_eq,
                int iters, int variant, float alpha, void* stream) {
  const size_t smem = dense_chunk_smem_bytes(m, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define LAUNCH_DENSE(V)                                                     \
  err = prepare(dense_chunk_kernel<V>, smem);                               \
  if (err != cudaSuccess) return (int)err;                                  \
  dense_chunk_kernel<V><<<B, kThreads, smem, st>>>(                         \
      c, q, l, u, tau, sig, x, y, xs, ys, K, k0, ax, ay, xo, yo, xso, yso,  \
      m, n, n_eq, iters, alpha)
  switch (variant) {
    case kVanilla: LAUNCH_DENSE(kVanilla); break;
    case kReflected: LAUNCH_DENSE(kReflected); break;
    case kHalpern: LAUNCH_DENSE(kHalpern); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_DENSE
  return (int)cudaGetLastError();
}

}  // extern "C"
