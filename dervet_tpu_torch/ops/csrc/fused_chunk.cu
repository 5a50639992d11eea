// Fused PDHG iteration chunks for Hopper (sm_90a): a banded and a dense
// kernel, each running `iters` restarted-PDHG iterations per launch with
// the instance's iterate held on chip, writing x, y, x_sum, y_sum once.
//
// What they replace (dervet_tpu/ops/pallas_chunk.py):
//   banded_chunk_kernel  <- _banded_chunk_kernel (:246), built by
//                           _build_banded_call (:368)
//   dense_chunk_kernel   <- _chunk_kernel (:105), built by _build_call (:183)
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
// How K is stored.  Both kernels read K only as (a) nb band diagonals,
// K[i, i + d_b] = diags[b, i] (the banded op; none for the dense op),
// and (b) a compact sparse part over r rows with nnz entries, built once
// per operator on the host (dervet_tpu_torch/ops/pdhg.py, CompactK):
//   by row (CSR):    row k's entries indptr[k]..indptr[k+1] of row_cols,
//                    row_vals; row_slot[i] = the compact row of K's row i,
//                    or -1;
//   by column (CSC): column col_lo + c's entries col_ptr[c]..col_ptr[c+1]
//                    of col_rows (K's row), col_vals.
// For the banded op the compact part is the wide-row pair (31 daily-cycle
// rows at the monthly window: 24 entries each, at most 1 per column);
// for the dense op it is all of K (at most 4 entries per row, 2 per
// column at the weekly window).  No zero of K is stored or multiplied,
// except the bands' ends.
//
// Design.  One thread block owns one instance.  In a register
// configuration (T, CPT, RPT), thread t owns columns t + s*T (s < CPT) and
// rows t + s*T (s < RPT), and keeps what only the owner touches in
// registers for the whole chunk: x per column; y, y_sum, q and the row's
// compact slot per row.  Shared memory holds what other threads read --
// 2 x1 - x with a zero halo, y, the band diagonals and both compact
// forms -- plus c, l, u, x_sum and the halpern anchors, which only the
// owner reads but which would cost registers the occupancy needs (with
// x_sum in registers the 768-thread halpern instance spills).
// Everything of K is staged into shared memory once per launch, the
// compact entries as (index, value bits) pairs: one 8-byte load an
// entry, and two base pointers fewer (with four separate arrays the
// 512-thread instances spill 4 bytes).  An
// iteration is two phases separated by __syncthreads:
//   columns: g = K^T y (band b adds diags[b, j - d_b] y[j - d_b] when
//            0 <= j - d_b < m, a predicate and no branch; then the
//            column's CSC entries), the primal update, 2 x1 - x to
//            shared memory;
//   rows:    K (2 x1 - x) (band b reads 2 x1 - x at i + d_b, inside the
//            halo, no test); a row with a compact slot adds its CSR
//            entries itself, reading 2 x1 - x from shared memory (24 at
//            the monthly window), so the wide rows need no third barrier
//            and no cross-thread reduction; the dual update, y to shared
//            memory.
// The register configurations are template parameters so the state
// arrays are registers; the wrapper picks the first that covers the shape
// and fits shared memory (CONFIGS, mirrored in ops/fused_chunk.py).
// The band offsets ride in the kernel's parameters (constant bank, a
// uniform read).
//
// Shapes no register configuration holds (more columns or rows than its
// threads cover, or bands and compact forms too large to stage) run the
// shared-state configuration (CPT = RPT = 0): 1024 threads loop over the
// columns and rows, keep x, x_sum, 2 x1 - x, c, l, u, y, y_sum and q in
// shared memory (the first kernels' layout, 4 (6n + 3m) bytes), and read
// the band diagonals, both compact forms and the halpern anchors through
// L1/L2, with a bounds predicate per band in both phases.  It takes every
// shape the first kernels took.
//
// Tensor cores are not used.  K is shared by the batch, so its products
// could run as (B, m)(m, n) matrix products on wgmma, as the TPU's MXU
// ran them.  But PDHG needs true fp32 products (PERF.md: 0/256 converged
// on single-pass low-precision ones), which leaves 3xTF32 at best, and
// at 0.8% density fp32 FMAs on the ~4.5k non-zeros do less work than any
// dense tensor-core product of W.
//
// What bounds it.  At the monthly window (m=776, n=2976, 4 bands, 743
// wide entries) an instance-iteration needs ~7.7k multiply-adds and
// ~50k element-wise operations; a launch moves the instance state in and
// out once (~100 KB an instance).  So the bound is the fp32 operation
// rate (0.028 ms at B=896, 32 iterations).  What the kernel adds to that
// is instructions (index arithmetic and predicates for every band of
// every column, shared-memory loads) and two barriers per iteration;
// one block's iteration is a dependent chain of them, so the time goes
// with the blocks an SM runs at once and the work each thread does
// serially.  At the monthly shape a block is 512 threads, 6 columns and
// 2 rows a thread, 64 registers and 90 KB of shared memory (105 KB under
// halpern), two blocks per SM.  Measured on an H100 (PERF.md, PR 2): 256 threads with 12
// columns each take 1.6x as long per block, and holding them to 80
// registers for three blocks per SM spills.
//
// Interface: plain C, loaded with ctypes.  Every entry takes device
// pointers, sizes and the CUDA stream, launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kMaxBands = 32;

enum Variant { kVanilla = 0, kReflected = 1, kHalpern = 2 };

struct ChunkArgs {
  const float *c, *q, *l, *u, *tau, *sig, *x, *y, *xs, *ys, *k0, *ax, *ay;
  float *xo, *yo, *xso, *yso;
  const float* diags;     // (nb, m) or null
  const int* row_slot;    // (m,) compact row of K's row i, or -1
  const int* indptr;      // (r + 1,) CSR: row k's entries
  const int* row_cols;    // (nnz,) K's column of each entry, by row
  const float* row_vals;  // (nnz,)
  const int* col_ptr;     // (nc + 1,) CSC: column col_lo + c's entries
  const int* col_rows;    // (nnz,) K's row of each entry, by column
  const float* col_vals;  // (nnz,)
  int off[kMaxBands];     // band offsets d_b
  int nb, hxl, hxr, r, nnz, col_lo, nc, m, n, n_eq, iters;
  float alpha;
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// projection onto the dual cone: free on equality rows, >= 0 otherwise
__device__ __forceinline__ float yproj(float v, bool eq) {
  return eq ? v : fmaxf(v, 0.0f);
}

// the step variant's new x from x, x1 = T(x) and (halpern) the anchor
template <int V>
__device__ __forceinline__ float xstep(float xv, float x1, float lo,
                                       float hi, float alpha, float lam,
                                       float anchor) {
  if constexpr (V == kVanilla) return x1;
  if constexpr (V == kReflected) return clip(xv + alpha * (x1 - xv), lo, hi);
  return clip(lam * (xv + alpha * (x1 - xv)) + (1.0f - lam) * anchor, lo, hi);
}

template <int V>
__device__ __forceinline__ float ystep(float yv, float y1, bool eq,
                                       float alpha, float lam, float anchor) {
  if constexpr (V == kVanilla) return y1;
  if constexpr (V == kReflected) return yproj(yv + alpha * (y1 - yv), eq);
  return yproj(lam * (yv + alpha * (y1 - yv)) + (1.0f - lam) * anchor, eq);
}

// shared 4-byte words one block uses (fused_chunk.smem_bytes mirrors it)
__host__ __device__ __forceinline__ size_t smem_words(const ChunkArgs& a,
                                                      bool halpern,
                                                      bool shared_state) {
  if (shared_state) return 6 * (size_t)a.n + 3 * (size_t)a.m;
  return 5 * (size_t)a.n + a.hxl + a.hxr + a.m + (size_t)a.nb * a.m +
         (a.nc + 1) + (a.r + 1) + 4 * (size_t)a.nnz +
         (halpern ? (size_t)a.n + a.m : 0);
}

// A register configuration: thread tid owns columns tid + s*T (s < CPT)
// and rows tid + s*T (s < RPT).
template <int V, int T, int CPT, int RPT>
__device__ __forceinline__ void chunk_body(const ChunkArgs& a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int m = a.m, n = a.n, nb = a.nb, hxl = a.hxl, nnz = a.nnz;
  const int col_lo = a.col_lo, nc = a.nc;
  // the compact entries as (index, value bits) pairs, one 8-byte load
  // an entry, at the front where they are 8-byte aligned
  int2* scrv = reinterpret_cast<int2*>(smem);  // (nnz) CSC: K's row, value
  int2* srcv = scrv + nnz;             // (nnz) CSR: K's column, value
  float* sc = reinterpret_cast<float*>(srcv + nnz);  // (n) c, l, u, x_sum
  float* sl = sc + n;
  float* su = sl + n;
  float* sxs = su + n;
  float* sxb = sxs + n;                // (hxl + n + hxr) 2 x1 - x
  float* sy = sxb + hxl + n + a.hxr;   // (m) y
  float* sdg = sy + m;                 // (nb, m) band diagonals
  int* scp = reinterpret_cast<int*>(sdg + (size_t)nb * m);  // (nc + 1)
  int* sip = scp + nc + 1;             // (r + 1)
  float* sax = reinterpret_cast<float*>(sip + a.r + 1);  // halpern
  float* say = sax + n;                // anchors (n), then (m)
  const float* xb = sxb + hxl;         // xb[j] = (2 x1 - x)[j]
  const size_t ox = (size_t)b * n, oy = (size_t)b * m;

  float x[CPT];
  float y[RPT], ys[RPT], q[RPT];
  int slot[RPT];
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int j = tid + s * T;
    x[s] = 0.0f;
    if (j < n) {
      x[s] = a.x[ox + j];
      sxs[j] = a.xs[ox + j];
      sc[j] = a.c[ox + j];
      sl[j] = a.l[ox + j];
      su[j] = a.u[ox + j];
      if constexpr (V == kHalpern) sax[j] = a.ax[ox + j];
    }
  }
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = tid + s * T;
    y[s] = ys[s] = q[s] = 0.0f;
    slot[s] = -1;
    if (i < m) {
      y[s] = a.y[oy + i];
      ys[s] = a.ys[oy + i];
      q[s] = a.q[oy + i];
      if constexpr (V == kHalpern) say[i] = a.ay[oy + i];
      slot[s] = a.row_slot[i];
      sy[i] = y[s];
    }
  }
  for (int t = tid; t < hxl; t += T) sxb[t] = 0.0f;
  for (int t = tid; t < a.hxr; t += T) sxb[hxl + n + t] = 0.0f;
  for (int t = tid; t < nb * m; t += T) sdg[t] = a.diags[t];
  for (int t = tid; t <= nc; t += T) scp[t] = a.col_ptr[t];
  for (int t = tid; t <= a.r; t += T) sip[t] = a.indptr[t];
  for (int t = tid; t < nnz; t += T) {
    scrv[t] = make_int2(a.col_rows[t], __float_as_int(a.col_vals[t]));
    srcv[t] = make_int2(a.row_cols[t], __float_as_int(a.row_vals[t]));
  }
  const float tau = a.tau[b], sig = a.sig[b], alpha = a.alpha;
  float kf = (V == kHalpern) ? a.k0[b] : 0.0f;
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    const float lam = (V == kHalpern) ? (kf + 1.0f) / (kf + 2.0f) : 0.0f;
    // columns: g = K^T y, then the primal update
    float g[CPT];
#pragma unroll
    for (int s = 0; s < CPT; ++s) g[s] = 0.0f;
    for (int bb = 0; bb < nb; ++bb) {
      const int d = a.off[bb];
      const float* dg = sdg + (size_t)bb * m;
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        const int i = tid + s * T - d;
        if ((unsigned)i < (unsigned)m) g[s] = fmaf(dg[i], sy[i], g[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int cc = tid + s * T - col_lo;
      if ((unsigned)cc < (unsigned)nc) {
        float gw = 0.0f;
        const int p1 = scp[cc + 1];
        for (int p = scp[cc]; p < p1; ++p) {
          const int2 e = scrv[p];
          gw = fmaf(__int_as_float(e.y), sy[e.x], gw);
        }
        g[s] += gw;
      }
    }
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int j = tid + s * T;
      if (j < n) {
        const float lo = sl[j], hi = su[j], xv = x[s];
        const float x1 = clip(xv - tau * (sc[j] - g[s]), lo, hi);
        sxb[hxl + j] = 2.0f * x1 - xv;
        const float xn = xstep<V>(xv, x1, lo, hi, alpha, lam,
                                  V == kHalpern ? sax[j] : 0.0f);
        x[s] = xn;
        sxs[j] += xn;
      }
    }
    __syncthreads();
    // rows: K (2 x1 - x), then the dual update
    float kx[RPT];
#pragma unroll
    for (int s = 0; s < RPT; ++s) kx[s] = 0.0f;
    for (int bb = 0; bb < nb; ++bb) {
      const int d = a.off[bb];
      const float* dg = sdg + (size_t)bb * m;
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        const int i = tid + s * T;
        if (i < m) kx[s] = fmaf(dg[i], xb[i + d], kx[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = tid + s * T;
      if (i < m) {
        const int k = slot[s];
        if (k >= 0) {
          float w = 0.0f;
          const int p1 = sip[k + 1];
#pragma unroll 4
          for (int p = sip[k]; p < p1; ++p) {
            const int2 e = srcv[p];
            w = fmaf(__int_as_float(e.y), xb[e.x], w);
          }
          kx[s] += w;
        }
        const bool eq = i < a.n_eq;
        const float yv = y[s];
        const float y1 = yproj(yv + sig * (q[s] - kx[s]), eq);
        const float yn = ystep<V>(yv, y1, eq, alpha, lam,
                                  V == kHalpern ? say[i] : 0.0f);
        y[s] = yn;
        ys[s] += yn;
        sy[i] = yn;
      }
    }
    __syncthreads();
    if (V == kHalpern) kf += 1.0f;
  }
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int j = tid + s * T;
    if (j < n) {
      a.xo[ox + j] = x[s];
      a.xso[ox + j] = sxs[j];
    }
  }
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = tid + s * T;
    if (i < m) {
      a.yo[oy + i] = y[s];
      a.yso[oy + i] = ys[s];
    }
  }
}

// The shared-state configuration: any number of columns and rows, the
// state in shared memory, K and the halpern anchors through L1/L2.
template <int V, int T>
__device__ __forceinline__ void chunk_body_shared(const ChunkArgs& a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int m = a.m, n = a.n, nb = a.nb, col_lo = a.col_lo, nc = a.nc;
  float* sc = smem;                    // (n) c, l, u, x, x_sum, 2 x1 - x
  float* sl = sc + n;
  float* su = sl + n;
  float* sx = su + n;
  float* sxs = sx + n;
  float* sxb = sxs + n;
  float* sy = sxb + n;                 // (m) y, y_sum, q
  float* sys = sy + m;
  float* sq = sys + m;
  const size_t ox = (size_t)b * n, oy = (size_t)b * m;
  for (int j = tid; j < n; j += T) {
    sc[j] = a.c[ox + j];
    sl[j] = a.l[ox + j];
    su[j] = a.u[ox + j];
    sx[j] = a.x[ox + j];
    sxs[j] = a.xs[ox + j];
  }
  for (int i = tid; i < m; i += T) {
    sy[i] = a.y[oy + i];
    sys[i] = a.ys[oy + i];
    sq[i] = a.q[oy + i];
  }
  const float tau = a.tau[b], sig = a.sig[b], alpha = a.alpha;
  float kf = (V == kHalpern) ? a.k0[b] : 0.0f;
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    const float lam = (V == kHalpern) ? (kf + 1.0f) / (kf + 2.0f) : 0.0f;
    for (int j = tid; j < n; j += T) {
      float g = 0.0f;
      for (int bb = 0; bb < nb; ++bb) {
        const int i = j - a.off[bb];
        if ((unsigned)i < (unsigned)m)
          g = fmaf(__ldg(a.diags + (size_t)bb * m + i), sy[i], g);
      }
      const int cc = j - col_lo;
      if ((unsigned)cc < (unsigned)nc) {
        float gw = 0.0f;
        const int p1 = __ldg(a.col_ptr + cc + 1);
        for (int p = __ldg(a.col_ptr + cc); p < p1; ++p)
          gw = fmaf(__ldg(a.col_vals + p), sy[__ldg(a.col_rows + p)], gw);
        g += gw;
      }
      const float lo = sl[j], hi = su[j], xv = sx[j];
      const float x1 = clip(xv - tau * (sc[j] - g), lo, hi);
      sxb[j] = 2.0f * x1 - xv;
      const float xn = xstep<V>(xv, x1, lo, hi, alpha, lam,
                                V == kHalpern ? a.ax[ox + j] : 0.0f);
      sx[j] = xn;
      sxs[j] += xn;
    }
    __syncthreads();
    for (int i = tid; i < m; i += T) {
      float kx = 0.0f;
      for (int bb = 0; bb < nb; ++bb) {
        const int j = i + a.off[bb];
        if ((unsigned)j < (unsigned)n)
          kx = fmaf(__ldg(a.diags + (size_t)bb * m + i), sxb[j], kx);
      }
      const int k = __ldg(a.row_slot + i);
      if (k >= 0) {
        float w = 0.0f;
        const int p1 = __ldg(a.indptr + k + 1);
        for (int p = __ldg(a.indptr + k); p < p1; ++p)
          w = fmaf(__ldg(a.row_vals + p), sxb[__ldg(a.row_cols + p)], w);
        kx += w;
      }
      const bool eq = i < a.n_eq;
      const float yv = sy[i];
      const float y1 = yproj(yv + sig * (sq[i] - kx), eq);
      const float yn = ystep<V>(yv, y1, eq, alpha, lam,
                                V == kHalpern ? a.ay[oy + i] : 0.0f);
      sy[i] = yn;
      sys[i] += yn;
    }
    __syncthreads();
    if (V == kHalpern) kf += 1.0f;
  }
  for (int j = tid; j < n; j += T) {
    a.xo[ox + j] = sx[j];
    a.xso[ox + j] = sxs[j];
  }
  for (int i = tid; i < m; i += T) {
    a.yo[oy + i] = sy[i];
    a.yso[oy + i] = sys[i];
  }
}

template <int V, int T, int CPT, int RPT>
__device__ __forceinline__ void body(const ChunkArgs& a) {
  if constexpr (CPT == 0)
    chunk_body_shared<V, T>(a);
  else
    chunk_body<V, T, CPT, RPT>(a);
}

// The arguments stay in the kernel's parameter space (__grid_constant__):
// the band offsets are read there with a loop index, without a copy.
template <int V, int T, int CPT, int RPT, int MINB>
__global__ void __launch_bounds__(T, MINB)
    banded_chunk_kernel(const __grid_constant__ ChunkArgs a) {
  body<V, T, CPT, RPT>(a);
}

template <int V, int T, int CPT, int RPT, int MINB>
__global__ void __launch_bounds__(T, MINB)
    dense_chunk_kernel(const __grid_constant__ ChunkArgs a) {
  body<V, T, CPT, RPT>(a);
}

// A function's attributes are shared by every host thread, and groups of
// other shapes launch the same instance from other threads at once: the
// dynamic shared-memory limit is set once per instance and device, to the
// most a block may opt into, so that no launch lowers it under another's.
template <typename KernelT>
cudaError_t set_attributes_once(KernelT kernel) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({(const void*)kernel, dev})) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes fa;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  // shared memory before L1, so that the blocks the registers allow fit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.insert({(const void*)kernel, dev});
  return err;
}

template <typename KernelT>
cudaError_t launch(KernelT kernel, int threads, int B, size_t smem,
                   cudaStream_t st, const ChunkArgs& a) {
  cudaError_t err = set_attributes_once(kernel);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The thread configurations (threads, columns a thread, rows a thread,
// blocks per SM the launch bounds hold the registers to), in the order
// the wrapper tries them; the last (0 columns and rows a thread) is the
// shared-state one.  ops/fused_chunk.py CONFIGS mirrors this list.
#define FOR_EACH_CONFIG(X) \
  X(128, 2, 1, 2) X(256, 3, 1, 2) X(512, 6, 2, 2) X(768, 8, 3, 1) \
  X(1024, 0, 0, 1)

template <int V>
cudaError_t dispatch(bool banded, int threads, int cpt, int rpt, int minb,
                     int B, size_t smem, cudaStream_t st,
                     const ChunkArgs& a) {
#define TRY_CONFIG(T_, C_, R_, M_)                                          \
  if (threads == T_ && cpt == C_ && rpt == R_ && minb == M_)                \
    return banded                                                           \
        ? launch(banded_chunk_kernel<V, T_, C_, R_, M_>, T_, B, smem, st, a) \
        : launch(dense_chunk_kernel<V, T_, C_, R_, M_>, T_, B, smem, st, a);
  FOR_EACH_CONFIG(TRY_CONFIG)
#undef TRY_CONFIG
  return cudaErrorInvalidValue;
}

int run(bool banded, const float* c, const float* q, const float* l,
        const float* u, const float* tau, const float* sig, const float* x,
        const float* y, const float* xs, const float* ys, const float* k0,
        const float* ax, const float* ay, float* xo, float* yo, float* xso,
        float* yso, const int* row_slot, const int* indptr,
        const int* row_cols, const float* row_vals, const int* col_ptr,
        const int* col_rows, const float* col_vals, int r, int nnz,
        int col_lo, int nc, int B, int m, int n, int n_eq, int iters,
        int variant, float alpha, int threads, int cpt, int rpt, int minb,
        const float* diags, const int* offsets, int nb, void* stream) {
  const bool shared_state = cpt == 0;
  if (nb < 0 || nb > kMaxBands ||
      (!shared_state && ((long long)threads * cpt < n ||
                         (long long)threads * rpt < m)))
    return (int)cudaErrorInvalidValue;
  ChunkArgs a = {c,        q,        l,        u,        tau,      sig,
                 x,        y,        xs,       ys,       k0,       ax,
                 ay,       xo,       yo,       xso,      yso,      diags,
                 row_slot, indptr,   row_cols, row_vals, col_ptr,  col_rows,
                 col_vals};
  int dmin = 0, dmax = 0;
  for (int t = 0; t < nb; ++t) {
    a.off[t] = offsets[t];
    dmin = (t == 0 || offsets[t] < dmin) ? offsets[t] : dmin;
    dmax = (t == 0 || offsets[t] > dmax) ? offsets[t] : dmax;
  }
  a.nb = nb;
  a.hxl = dmin < 0 ? -dmin : 0;
  a.hxr = m + dmax - n > 0 && nb ? m + dmax - n : 0;
  a.r = r;
  a.nnz = nnz;
  a.col_lo = col_lo;
  a.nc = nc;
  a.m = m;
  a.n = n;
  a.n_eq = n_eq;
  a.iters = iters;
  a.alpha = alpha;
  const size_t smem =
      sizeof(float) * smem_words(a, variant == kHalpern, shared_state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case kVanilla:
      err = dispatch<kVanilla>(banded, threads, cpt, rpt, minb, B, smem, st, a);
      break;
    case kReflected:
      err = dispatch<kReflected>(banded, threads, cpt, rpt, minb, B, smem, st,
                                 a);
      break;
    case kHalpern:
      err = dispatch<kHalpern>(banded, threads, cpt, rpt, minb, B, smem, st, a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" {

const char* fused_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int banded_chunk(const float* c, const float* q, const float* l,
                 const float* u, const float* tau, const float* sig,
                 const float* x, const float* y, const float* xs,
                 const float* ys, const float* k0, const float* ax,
                 const float* ay, float* xo, float* yo, float* xso,
                 float* yso, const int* row_slot, const int* indptr,
                 const int* row_cols, const float* row_vals,
                 const int* col_ptr, const int* col_rows,
                 const float* col_vals, int r, int nnz, int col_lo, int nc,
                 int B, int m, int n, int n_eq, int iters, int variant,
                 float alpha, int threads, int cpt, int rpt, int minb,
                 const float* diags, const int* offsets, int nb,
                 void* stream) {
  return run(true, c, q, l, u, tau, sig, x, y, xs, ys, k0, ax, ay, xo, yo,
             xso, yso, row_slot, indptr, row_cols, row_vals, col_ptr,
             col_rows, col_vals, r, nnz, col_lo, nc, B, m, n, n_eq, iters,
             variant, alpha, threads, cpt, rpt, minb, diags, offsets, nb,
             stream);
}

int dense_chunk(const float* c, const float* q, const float* l,
                const float* u, const float* tau, const float* sig,
                const float* x, const float* y, const float* xs,
                const float* ys, const float* k0, const float* ax,
                const float* ay, float* xo, float* yo, float* xso,
                float* yso, const int* row_slot, const int* indptr,
                const int* row_cols, const float* row_vals,
                const int* col_ptr, const int* col_rows,
                const float* col_vals, int r, int nnz, int col_lo, int nc,
                int B, int m, int n, int n_eq, int iters, int variant,
                float alpha, int threads, int cpt, int rpt, int minb,
                void* stream) {
  return run(false, c, q, l, u, tau, sig, x, y, xs, ys, k0, ax, ay, xo, yo,
             xso, yso, row_slot, indptr, row_cols, row_vals, col_ptr,
             col_rows, col_vals, r, nnz, col_lo, nc, B, m, n, n_eq, iters,
             variant, alpha, threads, cpt, rpt, minb, nullptr, nullptr, 0,
             stream);
}

}  // extern "C"
