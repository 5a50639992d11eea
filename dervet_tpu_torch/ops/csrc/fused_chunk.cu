// Fused PDHG iteration chunks for Hopper (sm_90a): a banded and a dense
// kernel, each running `iters` restarted-PDHG iterations per launch with
// the instance's iterate held on chip, writing x, y, x_sum, y_sum once.
// In a check window they run in place, and a block whose instance does
// not advance returns at once; the window's check kernel and status
// kernel (further below) finish it.
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
//              lam = (k + 1) / (k + 2), k counting on from the
//              instance's inner count
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
// forms -- plus c, l, u, x_sum, the halpern anchors, tau and sigma, which
// only the owner reads but which would cost registers the occupancy
// needs (with x_sum, or tau and sigma, in registers the 768-thread
// halpern instance spills).
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
#include <limits.h>
#include <math.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kMaxBands = 32;

enum Variant { kVanilla = 0, kReflected = 1, kHalpern = 2 };

struct ChunkArgs {
  const float *c, *q, *l, *u, *x, *y, *xs, *ys, *ax, *ay;
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
  // The step sizes: tau = eta / omega and sigma = eta * omega per
  // instance, the halpern count inner + k_off (inner null outside
  // halpern).  In a check window (converged set) the block of an instance
  // that does not advance this sub-block (not active under *limit, or
  // sub-block `block` past its n_sub) returns at once and leaves its
  // state as it was; with converged null every instance runs.
  const float *omega, *eta;
  const int *inner, *total, *cadence, *limit;
  const unsigned char *converged, *infeasible;
  int k_off, block, sub, adaptive;
};

// The sub-blocks instance b runs in a check window of cadence-adaptive
// (or fixed) length: pdhg._Solver._n_sub.
__device__ __forceinline__ int n_sub_of(int cadence, int sub, int adaptive) {
  return adaptive ? max(cadence / sub, 1) : 1;
}

// Whether the block of instance b runs this launch (pdhg._Solver.window's
// `active`, and advance's `j < n_sub`).
__device__ __forceinline__ bool instance_goes(const ChunkArgs& a, int b) {
  if (!a.converged) return true;
  return !a.converged[b] && !a.infeasible[b] && a.total[b] < *a.limit &&
         a.block < n_sub_of(a.cadence[b], a.sub, a.adaptive);
}

// tau, sigma and the halpern count of instance b's launch
__device__ __forceinline__ void steps_of(const ChunkArgs& a, int b,
                                         float& tau, float& sig, float& kf) {
  const float w = a.omega[b], e = *a.eta;
  tau = e / w;
  sig = e * w;
  kf = a.inner ? (float)(a.inner[b] + a.k_off) : 0.0f;
}

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
  return 4 + 5 * (size_t)a.n + a.hxl + a.hxr + a.m + (size_t)a.nb * a.m +
         (a.nc + 1) + (a.r + 1) + 4 * (size_t)a.nnz +
         (halpern ? (size_t)a.n + a.m : 0);
}

// A register configuration: thread tid owns columns tid + s*T (s < CPT)
// and rows tid + s*T (s < RPT).
template <int V, int T, int CPT, int RPT>
__device__ __forceinline__ void chunk_body(const ChunkArgs& a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  if (!instance_goes(a, b)) return;
  const int m = a.m, n = a.n, nb = a.nb, hxl = a.hxl, nnz = a.nnz;
  const int col_lo = a.col_lo, nc = a.nc;
  // tau and sigma, which each phase reads from here after its barrier:
  // held in registers across the iterations they spill the 768-thread
  // halpern instances (4 words keep the pairs below 8-byte aligned)
  float* sstep = smem;
  // the compact entries as (index, value bits) pairs, one 8-byte load
  // an entry, near the front where they are 8-byte aligned
  int2* scrv = reinterpret_cast<int2*>(smem + 4);  // (nnz) CSC: K's row, value
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
  float kf;
  {
    float tau, sig;
    steps_of(a, b, tau, sig, kf);
    if (tid == 0) {
      sstep[0] = tau;
      sstep[1] = sig;
    }
  }
  const float alpha = a.alpha;
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
    const float tau = sstep[0];
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
    const float sig = sstep[1];
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
  if (!instance_goes(a, b)) return;
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
  float tau, sig, kf;
  steps_of(a, b, tau, sig, kf);
  const float alpha = a.alpha;
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

template <typename KernelT, typename ArgsT>
cudaError_t launch(KernelT kernel, int threads, int B, size_t smem,
                   cudaStream_t st, const ArgsT& a) {
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

// ---------------------------------------------------------------------------
// The check window's update: one check kernel a window
// ---------------------------------------------------------------------------
//
// What it replaces: no Pallas kernel.  The JAX package leaves this body
// (pdhg._make_solver's restart check inside its chunk while_loop) to
// XLA's fusion.  Its plain version, pdhg._Solver.plain_window after the
// advance and plain_status, is ~150 full-width PyTorch operations a
// window, each reading and writing the whole batch's state; this kernel
// reads it once.  One block owns one instance and does all of it:
//   x_avg, y_avg = x_sum, y_sum / inner; the unscaled KKT terms of the
//   current and the average iterate (K x and K^T y of each, from the
//   bands and the compact forms the chunk kernels read); mu of each and
//   the candidate; convergence; the Farkas certificate of y and the
//   infeasibility streak; the artificial restart; the restart test (KKT,
//   or the fixed-point residual of one more T(x, y)); the primal weight
//   update; the cadence; done_x/done_y and iters_at_conv on first
//   convergence.
// A block whose instance is not active (converged, infeasible, or at the
// chunk's limit) returns at once: its state stays as it was, which is
// the plain version's select.  The state is updated in place, and the
// vectors are written only where they change (x, y on a restart to the
// average; the sums, the restart point on a restart; done_* once).
//
// What bounds it: bytes.  A block reads x, x_sum, x_restart, c, l, u (n
// each) and y, y_sum, y_restart, q (m each) once, dr and dc and K from
// L2, and writes on a restart only; at 745 x 2976 that is ~80 KB an
// instance, ~0.17 ms at B = 7,000 on an H100's 3.35 TB/s.  The block
// stages x, x_avg, y and y_avg (and 2 x1 - x under the fixed-point
// restart) in shared memory, which both products read at the bands'
// offsets, so each is read from device memory once.
//
// Numbers: the vectors are the plain version's elementwise float32
// operations (the same divisions and selects); each reduction (norms,
// objectives, the Farkas sums) is summed in float64 in a fixed order
// (thread-strided partial sums, then a warp and a block tree), so a
// replay and an eager window give the same bits; the scalar decisions
// are float32 as in the plain version.

constexpr int kCheckThreads = 256;
constexpr int kSums = 19;

struct CheckArgs {
  // state, updated in place (pdhg._State)
  float *x, *y, *xs, *ys, *xr, *yr, *done_x, *done_y;
  float *omega, *mu_restart, *mu_prev;
  int *inner, *total, *iters_at_conv, *streak, *restarts, *cadence;
  unsigned char *converged, *infeasible;
  // the instance's unscaled data and norms (pdhg._Context)
  const float *c, *q, *l, *u, *q_norm, *c_norm, *omega_lo, *omega_hi;
  const float *dr, *dc, *eta;
  const int* limit;
  // K, as the chunk kernels read it
  const float* diags;
  const int *row_slot, *indptr, *row_cols;
  const float* row_vals;
  const int *col_ptr, *col_rows;
  const float* col_vals;
  int off[kMaxBands];
  int nb, col_lo, nc, m, n, n_eq;
  // options (pdhg.PDHGOptions, as _Solver resolves them)
  int sub, adaptive, cadence_cap, infeas_checks;
  float eps_abs, eps_rel, eps_infeas, beta_sufficient, beta_necessary,
      fp_beta_sufficient, artificial_frac, theta;
};

// (K v)_i for v in shared memory: the bands, then the compact row
__device__ __forceinline__ float row_dot(const CheckArgs& a, int i,
                                         const float* v) {
  float acc = 0.0f;
  for (int bb = 0; bb < a.nb; ++bb) {
    const int j = i + a.off[bb];
    if ((unsigned)j < (unsigned)a.n)
      acc = fmaf(__ldg(a.diags + (size_t)bb * a.m + i), v[j], acc);
  }
  const int k = __ldg(a.row_slot + i);
  if (k >= 0) {
    float w = 0.0f;
    const int p1 = __ldg(a.indptr + k + 1);
    for (int p = __ldg(a.indptr + k); p < p1; ++p)
      w = fmaf(__ldg(a.row_vals + p), v[__ldg(a.row_cols + p)], w);
    acc += w;
  }
  return acc;
}

// (K^T v)_j and (K^T w)_j for v, w in shared memory
__device__ __forceinline__ void col_dot2(const CheckArgs& a, int j,
                                         const float* v, const float* w,
                                         float& gv, float& gw) {
  gv = gw = 0.0f;
  for (int bb = 0; bb < a.nb; ++bb) {
    const int i = j - a.off[bb];
    if ((unsigned)i < (unsigned)a.m) {
      const float d = __ldg(a.diags + (size_t)bb * a.m + i);
      gv = fmaf(d, v[i], gv);
      gw = fmaf(d, w[i], gw);
    }
  }
  const int cc = j - a.col_lo;
  if ((unsigned)cc < (unsigned)a.nc) {
    float sv = 0.0f, sw = 0.0f;
    const int p1 = __ldg(a.col_ptr + cc + 1);
    for (int p = __ldg(a.col_ptr + cc); p < p1; ++p) {
      const float e = __ldg(a.col_vals + p);
      const int i = __ldg(a.col_rows + p);
      sv = fmaf(e, v[i], sv);
      sw = fmaf(e, w[i], sw);
    }
    gv += sv;
    gw += sw;
  }
}

// the restart score of (primal residual, dual residual, gap, objectives)
__device__ __forceinline__ float mu_of(float pr, float du, float gp, float po,
                                       float dob) {
  const float r = gp / (1.0f + fabsf(po) + fabsf(dob));
  return sqrtf(pr * pr + du * du + r * r);
}

// The partial sums, by index
enum {
  kPrC, kPrA,      // |violation|^2 of the current and the average iterate
  kQyC, kQyA,      // q . (dr y) of each
  kYn,             // |dr y|^2 (the Farkas ray's norm)
  kDyC, kDyA,      // |y - y_restart|^2, |y_avg - y_restart|^2
  kDuC, kDuA,      // |dual residual|^2 of each
  kPoC, kPoA,      // c . (dc x) of each
  kBoxC, kBoxA,    // the bounds' part of the dual objective of each
  kRay, kFbox,     // the Farkas ray's violation and box term (unnormalised)
  kDxC, kDxA,      // |x - x_restart|^2, |x_avg - x_restart|^2
  kFpX, kFpY       // |T(x) - x|^2, |T(y) - y|^2 (fixed-point restart)
};

// tot[first + k] = the block's sum of acc[k] over its threads: a warp
// tree, then the warps in order, a fixed order, so that a replay and an
// eager window give the same bits.  Each pass reduces its own sums as it
// ends, so that no pass holds another's in registers.
template <int N>
__device__ __forceinline__ void block_sums(const double (&acc)[N], int first,
                                           double (*red)[kSums],
                                           double* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    double v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (tid < N) {
    double v = 0.0;
    for (int w = 0; w < kCheckThreads / 32; ++w) v += red[w][tid];
    tot[first + tid] = v;
  }
  __syncthreads();
}

template <bool FP>
__global__ void __launch_bounds__(kCheckThreads)
    check_window_kernel(const __grid_constant__ CheckArgs a) {
  extern __shared__ float smem[];
  __shared__ double red[kCheckThreads / 32][kSums];
  __shared__ double tot[kSums];
  const int tid = threadIdx.x, b = blockIdx.x;
  if (a.converged[b] || a.infeasible[b] || a.total[b] >= *a.limit) return;
  const int m = a.m, n = a.n;
  const size_t ox = (size_t)b * n, oy = (size_t)b * m;
  const int adv = n_sub_of(a.cadence[b], a.sub, a.adaptive) * a.sub;
  const int inner = a.inner[b] + adv, total = a.total[b] + adv;
  const int restarts = a.restarts[b], iters_at_conv = a.iters_at_conv[b];
  const float fin = (float)inner;
  // every scalar of the instance that thread 0 rewrites at the end is
  // read before the first barrier
  const float omega = a.omega[b], eta = *a.eta;
  const float mu_r = a.mu_restart[b], mu_p = a.mu_prev[b];
  const int streak0 = a.streak[b], cadence = a.cadence[b];
  float* sx = smem;                    // (n) x, x_avg
  float* sxa = sx + n;
  float* sy = sxa + n;                 // (m) y, y_avg
  float* sya = sy + m;
  float* sxb = sya + m;                // (n) 2 x1 - x (fixed-point)
  for (int j = tid; j < n; j += kCheckThreads) {
    sx[j] = a.x[ox + j];
    sxa[j] = a.xs[ox + j] / fin;
  }
  for (int i = tid; i < m; i += kCheckThreads) {
    sy[i] = a.y[oy + i];
    sya[i] = a.ys[oy + i] / fin;
  }
  __syncthreads();

  // rows: K x and K x_avg, the primal residuals, q . y
  double racc[kDuC] = {};
  for (int i = tid; i < m; i += kCheckThreads) {
    const float dri = __ldg(a.dr + i), qi = a.q[oy + i];
    const float yri = a.yr[oy + i];
    const bool eq = i < a.n_eq;
    const float rc = qi - row_dot(a, i, sx) / dri;
    const float ra = qi - row_dot(a, i, sxa) / dri;
    const float vc = eq ? fabsf(rc) : fmaxf(rc, 0.0f);
    const float va = eq ? fabsf(ra) : fmaxf(ra, 0.0f);
    racc[kPrC] += (double)vc * vc;
    racc[kPrA] += (double)va * va;
    const float yuc = dri * sy[i], yua = dri * sya[i];
    racc[kQyC] += (double)qi * yuc;
    racc[kQyA] += (double)qi * yua;
    racc[kYn] += (double)yuc * yuc;
    const float dc_ = sy[i] - yri, da_ = sya[i] - yri;
    racc[kDyC] += (double)dc_ * dc_;
    racc[kDyA] += (double)da_ * da_;
  }
  block_sums(racc, 0, red, tot);
  // columns: K^T y and K^T y_avg, the dual residuals, the objectives,
  // the Farkas ray's sums; under the fixed-point restart T(x)
  double cacc[(FP ? kFpY : kFpX) - kDuC] = {};
  const float tau = eta / omega;
  for (int j = tid; j < n; j += kCheckThreads) {
    const float dcj = __ldg(a.dc + j), cj = a.c[ox + j];
    const float lj = a.l[ox + j], uj = a.u[ox + j], xrj = a.xr[ox + j];
    const bool lf = isfinite(lj), uf = isfinite(uj);
    float gc, ga;
    col_dot2(a, j, sy, sya, gc, ga);
    const float xc = sx[j], xa = sxa[j];
    {
      const float kty = gc / dcj;
      const float lam = cj - kty;
      const float lp = fmaxf(lam, 0.0f), ln = fminf(lam, 0.0f);
      const float dres = (lf ? 0.0f : lp) + (uf ? 0.0f : -ln);
      cacc[kDuC - kDuC] += (double)dres * dres;
      cacc[kPoC - kDuC] += (double)cj * (dcj * xc);
      cacc[kBoxC - kDuC] +=
          (double)((lf ? lp * lj : 0.0f) + (uf ? ln * uj : 0.0f));
      const float pos = fmaxf(kty, 0.0f), neg = fminf(kty, 0.0f);
      cacc[kRay - kDuC] += (double)((uf ? 0.0f : pos) - (lf ? 0.0f : neg));
      cacc[kFbox - kDuC] +=
          (double)((uf ? pos * uj : 0.0f) + (lf ? neg * lj : 0.0f));
    }
    {
      const float lam = cj - ga / dcj;
      const float lp = fmaxf(lam, 0.0f), ln = fminf(lam, 0.0f);
      const float dres = (lf ? 0.0f : lp) + (uf ? 0.0f : -ln);
      cacc[kDuA - kDuC] += (double)dres * dres;
      cacc[kPoA - kDuC] += (double)cj * (dcj * xa);
      cacc[kBoxA - kDuC] +=
          (double)((lf ? lp * lj : 0.0f) + (uf ? ln * uj : 0.0f));
    }
    const float ec = xc - xrj, ea = xa - xrj;
    cacc[kDxC - kDuC] += (double)ec * ec;
    cacc[kDxA - kDuC] += (double)ea * ea;
    if constexpr (FP) {
      const float ls = lf ? lj / dcj : lj, us = uf ? uj / dcj : uj;
      const float x1 = fminf(fmaxf(xc - tau * (cj * dcj - gc), ls), us);
      sxb[j] = 2.0f * x1 - xc;
      const float e = x1 - xc;
      cacc[kFpX - kDuC] += (double)e * e;
    }
  }
  block_sums(cacc, kDuC, red, tot);
  if constexpr (FP) {
    // rows again: T(y) from K (2 x1 - x)
    double facc[1] = {};
    const float sig = eta * omega;
    for (int i = tid; i < m; i += kCheckThreads) {
      const float dri = __ldg(a.dr + i), qs = a.q[oy + i] * dri;
      float y1 = sy[i] + sig * (qs - row_dot(a, i, sxb));
      if (i >= a.n_eq) y1 = fmaxf(y1, 0.0f);
      const float e = y1 - sy[i];
      facc[0] += (double)e * e;
    }
    block_sums(facc, kFpY, red, tot);
  }
  // the decisions, the same in every thread
  const float pr_c = (float)sqrt(tot[kPrC]), pr_a = (float)sqrt(tot[kPrA]);
  const float du_c = (float)sqrt(tot[kDuC]), du_a = (float)sqrt(tot[kDuA]);
  const float po_c = (float)tot[kPoC], po_a = (float)tot[kPoA];
  const float do_c = (float)(tot[kQyC] + tot[kBoxC]);
  const float do_a = (float)(tot[kQyA] + tot[kBoxA]);
  const float gp_c = fabsf(po_c - do_c), gp_a = fabsf(po_a - do_a);
  const float mu_c = mu_of(pr_c, du_c, gp_c, po_c, do_c);
  const float mu_a = mu_of(pr_a, du_a, gp_a, po_a, do_a);
  const bool use_avg = mu_a < mu_c;
  const float pr = use_avg ? pr_a : pr_c, du = use_avg ? du_a : du_c;
  const float gp = use_avg ? gp_a : gp_c, po = use_avg ? po_a : po_c;
  const float dob = use_avg ? do_a : do_c;
  const float qn = a.q_norm[b], cn = a.c_norm[b];
  const bool conv_now = pr <= a.eps_abs + a.eps_rel * qn &&
                        du <= a.eps_abs + a.eps_rel * cn &&
                        gp <= a.eps_abs + a.eps_rel * (fabsf(po) + fabsf(dob));
  const double ynorm = sqrt(tot[kYn]);
  const double den = fmax(ynorm, 1e-12);
  const float fk_gap = (float)((tot[kQyC] - tot[kFbox]) / den);
  const float fk_viol = (float)(tot[kRay] / den);
  const float scale_ref = 1.0f + qn;
  const bool cert = fk_gap > a.eps_infeas * scale_ref &&
                    fk_viol <= a.eps_infeas * scale_ref &&
                    (float)ynorm > 1.0f && !conv_now;
  const int streak = cert ? streak0 + 1 : 0;
  const bool artificial = (float)inner >= a.artificial_frac * (float)total;
  float mu_track, dxn, dyn;
  bool do_restart, to_avg;
  if constexpr (FP) {
    mu_track = (float)sqrt(tot[kFpX] + tot[kFpY]);
    do_restart = mu_track <= a.fp_beta_sufficient * mu_r;
    to_avg = false;
    dxn = (float)sqrt(tot[kDxC]);
    dyn = (float)sqrt(tot[kDyC]);
  } else {
    mu_track = fminf(mu_a, mu_c);
    do_restart = mu_track <= a.beta_sufficient * mu_r;
    to_avg = use_avg;
    dxn = (float)sqrt(tot[use_avg ? kDxA : kDxC]);
    dyn = (float)sqrt(tot[use_avg ? kDyA : kDyC]);
  }
  do_restart = do_restart ||
               (mu_track <= a.beta_necessary * mu_r && mu_track > mu_p) ||
               artificial;
  float new_omega = omega;
  if (dxn > 1e-10f && dyn > 1e-10f)
    new_omega = expf(a.theta * logf(dyn / dxn) +
                     (1.0f - a.theta) * logf(omega));
  new_omega = fminf(fmaxf(new_omega, a.omega_lo[b]), a.omega_hi[b]);

  // the writes: the vectors where they change, then the instance's scalars
  if (do_restart) {
    for (int j = tid; j < n; j += kCheckThreads) {
      const float v = to_avg ? sxa[j] : sx[j];
      if (to_avg) a.x[ox + j] = v;
      a.xs[ox + j] = 0.0f;
      a.xr[ox + j] = v;
    }
    for (int i = tid; i < m; i += kCheckThreads) {
      const float v = to_avg ? sya[i] : sy[i];
      if (to_avg) a.y[oy + i] = v;
      a.ys[oy + i] = 0.0f;
      a.yr[oy + i] = v;
    }
  }
  if (conv_now) {
    // first convergence (an active instance was not converged)
    for (int j = tid; j < n; j += kCheckThreads)
      a.done_x[ox + j] = use_avg ? sxa[j] : sx[j];
    for (int i = tid; i < m; i += kCheckThreads)
      a.done_y[oy + i] = use_avg ? sya[i] : sy[i];
  }
  if (tid == 0) {
    a.inner[b] = do_restart ? 0 : inner;
    a.total[b] = total;
    a.omega[b] = do_restart ? new_omega : omega;
    a.mu_restart[b] = do_restart ? mu_track : mu_r;
    a.mu_prev[b] = mu_track;
    a.converged[b] = conv_now;
    a.iters_at_conv[b] = conv_now ? total : iters_at_conv;
    a.streak[b] = streak;
    a.infeasible[b] = streak >= a.infeas_checks;
    a.restarts[b] = restarts + do_restart;
    a.cadence[b] = a.adaptive ? min(cadence * 2, a.cadence_cap) : cadence;
  }
}

// The status the host reads after a window (pdhg._Solver.status): the
// active count, the largest sub-block count among the active, the largest
// total, the unfinished count, the largest cadence, then each instance's
// unfinished flag.  One block; integer reductions, so any order gives the
// same answer.
constexpr int kStatusThreads = 1024;

__global__ void __launch_bounds__(kStatusThreads)
    window_status_kernel(const unsigned char* converged,
                         const unsigned char* infeasible, const int* total,
                         const int* cadence, const int* limit, int B,
                         int sub, int adaptive, int* out) {
  __shared__ int red[kStatusThreads / 32][5];
  const int tid = threadIdx.x, lim = *limit;
  int v[5] = {0, 0, INT_MIN, 0, INT_MIN};
  for (int i = tid; i < B; i += kStatusThreads) {
    const bool unf = !(converged[i] || infeasible[i]);
    const bool act = unf && total[i] < lim;
    v[0] += act;
    v[1] = max(v[1], act ? n_sub_of(cadence[i], sub, adaptive) : 0);
    v[2] = max(v[2], total[i]);
    v[3] += unf;
    v[4] = max(v[4], cadence[i]);
    out[5 + i] = unf;
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      const int w = __shfl_down_sync(0xffffffffu, v[k], o);
      v[k] = (k == 0 || k == 3) ? v[k] + w : max(v[k], w);
    }
    if (lane == 0) red[warp][k] = v[k];
  }
  __syncthreads();
  if (tid < 5) {
    int r = red[0][tid];
    for (int w = 1; w < kStatusThreads / 32; ++w)
      r = (tid == 0 || tid == 3) ? r + red[w][tid] : max(r, red[w][tid]);
    out[tid] = r;
  }
}

int run(bool banded, const float* c, const float* q, const float* l,
        const float* u, const float* x, const float* y, const float* xs,
        const float* ys, const float* ax, const float* ay, float* xo,
        float* yo, float* xso,
        float* yso, const int* row_slot, const int* indptr,
        const int* row_cols, const float* row_vals, const int* col_ptr,
        const int* col_rows, const float* col_vals, int r, int nnz,
        int col_lo, int nc, int B, int m, int n, int n_eq, int iters,
        int variant, float alpha, int threads, int cpt, int rpt, int minb,
        const float* diags, const int* offsets, int nb,
        const void* const* window, const int* window_ints, void* stream) {
  const bool shared_state = cpt == 0;
  if (nb < 0 || nb > kMaxBands || !window || !window[0] || !window[1] ||
      (!shared_state && ((long long)threads * cpt < n ||
                         (long long)threads * rpt < m)))
    return (int)cudaErrorInvalidValue;
  ChunkArgs a = {c,        q,        l,        u,        x,
                 y,        xs,       ys,       ax,       ay,
                 xo,       yo,       xso,      yso,      diags,
                 row_slot, indptr,   row_cols, row_vals, col_ptr,
                 col_rows, col_vals};
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
  // omega, eta, inner (null outside halpern); then total, cadence,
  // limit, converged, infeasible (null: every instance runs); k_off,
  // block, sub, adaptive
  a.omega = static_cast<const float*>(window[0]);
  a.eta = static_cast<const float*>(window[1]);
  a.inner = static_cast<const int*>(window[2]);
  a.total = static_cast<const int*>(window[3]);
  a.cadence = static_cast<const int*>(window[4]);
  a.limit = static_cast<const int*>(window[5]);
  a.converged = static_cast<const unsigned char*>(window[6]);
  a.infeasible = static_cast<const unsigned char*>(window[7]);
  a.k_off = window_ints[0];
  a.block = window_ints[1];
  a.sub = window_ints[2];
  a.adaptive = window_ints[3];
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
                 const float* u, const float* x, const float* y,
                 const float* xs, const float* ys, const float* ax,
                 const float* ay, float* xo, float* yo, float* xso,
                 float* yso, const int* row_slot, const int* indptr,
                 const int* row_cols, const float* row_vals,
                 const int* col_ptr, const int* col_rows,
                 const float* col_vals, int r, int nnz, int col_lo, int nc,
                 int B, int m, int n, int n_eq, int iters, int variant,
                 float alpha, int threads, int cpt, int rpt, int minb,
                 const void* const* window, const int* window_ints,
                 const float* diags, const int* offsets, int nb,
                 void* stream) {
  return run(true, c, q, l, u, x, y, xs, ys, ax, ay, xo, yo, xso, yso,
             row_slot, indptr, row_cols, row_vals, col_ptr, col_rows,
             col_vals, r, nnz, col_lo, nc, B, m, n, n_eq, iters, variant,
             alpha, threads, cpt, rpt, minb, diags, offsets, nb,
             window, window_ints, stream);
}

int dense_chunk(const float* c, const float* q, const float* l,
                const float* u, const float* x, const float* y,
                const float* xs, const float* ys, const float* ax,
                const float* ay, float* xo, float* yo, float* xso,
                float* yso, const int* row_slot, const int* indptr,
                const int* row_cols, const float* row_vals,
                const int* col_ptr, const int* col_rows,
                const float* col_vals, int r, int nnz, int col_lo, int nc,
                int B, int m, int n, int n_eq, int iters, int variant,
                float alpha, int threads, int cpt, int rpt, int minb,
                const void* const* window, const int* window_ints,
                void* stream) {
  return run(false, c, q, l, u, x, y, xs, ys, ax, ay, xo, yo, xso, yso,
             row_slot, indptr, row_cols, row_vals, col_ptr, col_rows,
             col_vals, r, nnz, col_lo, nc, B, m, n, n_eq, iters, variant,
             alpha, threads, cpt, rpt, minb, nullptr, nullptr, 0,
             window, window_ints, stream);
}

// state: the 19 pdhg._State fields in their order; ctx: c, q, l, u,
// q_norm, c_norm, omega_lo, omega_hi, dr, dc, eta, limit; forms: the
// 7 compact-form arrays; ints: n_eq, col_lo, nc, sub, adaptive,
// cadence_cap, infeas_checks, fixed_point; floats: eps_abs, eps_rel,
// eps_infeas, beta_sufficient, beta_necessary, fp_beta_sufficient,
// artificial_frac, theta.
int check_window(void* const* state, const void* const* ctx,
                 const void* const* forms, const float* diags,
                 const int* offsets, int nb, const int* ints,
                 const float* floats, int B, int m, int n, void* stream) {
  if (nb < 0 || nb > kMaxBands) return (int)cudaErrorInvalidValue;
  CheckArgs a = {};
  a.x = static_cast<float*>(state[0]);
  a.y = static_cast<float*>(state[1]);
  a.xs = static_cast<float*>(state[2]);
  a.ys = static_cast<float*>(state[3]);
  a.inner = static_cast<int*>(state[4]);
  a.total = static_cast<int*>(state[5]);
  a.omega = static_cast<float*>(state[6]);
  a.xr = static_cast<float*>(state[7]);
  a.yr = static_cast<float*>(state[8]);
  a.mu_restart = static_cast<float*>(state[9]);
  a.mu_prev = static_cast<float*>(state[10]);
  a.converged = static_cast<unsigned char*>(state[11]);
  a.done_x = static_cast<float*>(state[12]);
  a.done_y = static_cast<float*>(state[13]);
  a.iters_at_conv = static_cast<int*>(state[14]);
  a.streak = static_cast<int*>(state[15]);
  a.infeasible = static_cast<unsigned char*>(state[16]);
  a.restarts = static_cast<int*>(state[17]);
  a.cadence = static_cast<int*>(state[18]);
  a.c = static_cast<const float*>(ctx[0]);
  a.q = static_cast<const float*>(ctx[1]);
  a.l = static_cast<const float*>(ctx[2]);
  a.u = static_cast<const float*>(ctx[3]);
  a.q_norm = static_cast<const float*>(ctx[4]);
  a.c_norm = static_cast<const float*>(ctx[5]);
  a.omega_lo = static_cast<const float*>(ctx[6]);
  a.omega_hi = static_cast<const float*>(ctx[7]);
  a.dr = static_cast<const float*>(ctx[8]);
  a.dc = static_cast<const float*>(ctx[9]);
  a.eta = static_cast<const float*>(ctx[10]);
  a.limit = static_cast<const int*>(ctx[11]);
  a.row_slot = static_cast<const int*>(forms[0]);
  a.indptr = static_cast<const int*>(forms[1]);
  a.row_cols = static_cast<const int*>(forms[2]);
  a.row_vals = static_cast<const float*>(forms[3]);
  a.col_ptr = static_cast<const int*>(forms[4]);
  a.col_rows = static_cast<const int*>(forms[5]);
  a.col_vals = static_cast<const float*>(forms[6]);
  a.diags = diags;
  for (int t = 0; t < nb; ++t) a.off[t] = offsets[t];
  a.nb = nb;
  a.m = m;
  a.n = n;
  a.n_eq = ints[0];
  a.col_lo = ints[1];
  a.nc = ints[2];
  a.sub = ints[3];
  a.adaptive = ints[4];
  a.cadence_cap = ints[5];
  a.infeas_checks = ints[6];
  const bool fp = ints[7] != 0;
  a.eps_abs = floats[0];
  a.eps_rel = floats[1];
  a.eps_infeas = floats[2];
  a.beta_sufficient = floats[3];
  a.beta_necessary = floats[4];
  a.fp_beta_sufficient = floats[5];
  a.artificial_frac = floats[6];
  a.theta = floats[7];
  const size_t smem = sizeof(float) * ((fp ? 3 : 2) * (size_t)n + 2 * m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(fp ? launch(check_window_kernel<true>, kCheckThreads, B, smem,
                           st, a)
                  : launch(check_window_kernel<false>, kCheckThreads, B,
                           smem, st, a));
}

int window_status(const void* converged, const void* infeasible,
                  const int* total, const int* cadence, const int* limit,
                  int B, int sub, int adaptive, int* out, void* stream) {
  window_status_kernel<<<1, kStatusThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(converged),
      static_cast<const unsigned char*>(infeasible), total, cadence, limit, B,
      sub, adaptive, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
