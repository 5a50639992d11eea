"""Fused PDHG iteration chunks: CUDA kernels, their wrappers and plain versions.

Counterpart of ``dervet_tpu/ops/pallas_chunk.py``.  One chunk runs
``iters`` PDHG iterations (vanilla, reflected or halpern step) for a
batch of instances that share one scaled constraint matrix, with the
iterate held on chip, and returns ``(x, y, x_sum, y_sum)``.  Two kernels,
both in ``csrc/fused_chunk.cu``:

* ``banded_chunk`` — K as ``nb`` static diagonals plus the optional
  low-rank wide-row pair (``BandedOp``, every monthly window);
* ``dense_chunk`` — the dense op's K (``DenseOp``, short windows such as
  weekly).

The kernels read K's non-zeros only: the band diagonals, and the wide
pair (banded) or all of K (dense) in the compact forms ``CompactK`` that
``pdhg`` builds once per operator.  ``compact_matvec``/``compact_rmatvec``
apply those forms with the kernels' indexing, so the CPU tests check the
layout.  Each wrapper takes its plain PyTorch version (on the dense
``wide_w``/``Kh``) only for tensors on the CPU (the tests); for CUDA
tensors it launches its kernel or raises — there is no fallback.
``LAUNCHES`` counts kernel launches per kernel, incremented at the
launch and nowhere else.  A launch made while its thread captures a CUDA
graph runs nothing: it is recorded for the graph (:func:`recording`),
and each replay of the graph counts it (:func:`add_launches`).

The kernels are compiled at first use with ``nvcc`` from the package's own
source into ``dervet_tpu_torch/_build/`` (a plain C interface loaded with
ctypes), for ``sm_90a``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

VANILLA = "vanilla"
REFLECTED = "reflected"
HALPERN = "halpern"
VARIANTS = (VANILLA, REFLECTED, HALPERN)
_VARIANT_CODE = {VANILLA: 0, REFLECTED: 1, HALPERN: 2}

KERNEL_BANDED = "banded_chunk"
KERNEL_DENSE = "dense_chunk"
KERNELS = (KERNEL_BANDED, KERNEL_DENSE)

# shared memory one thread block may use on an H100 (227 KB); one block
# holds one instance, so a shape whose shared state exceeds this is
# declined (supports) and runs the plain path
BLOCK_SMEM_BYTES = 232_448
# band offsets travel in the kernel's parameters; the JAX kernel's cap
MAX_BANDS = 32
# The shared-state configuration reads K's compact forms through L2 on
# every iteration; the cap keeps them inside the card's 50 MB L2.  It
# takes every K the first dense kernel took (at most 10 MiB dense: 16
# bytes an entry in the two forms, plus their pointers).
MAX_K_BYTES = 48 * 1024 * 1024
# The kernels' thread configurations, in the order config_for tries
# them: (threads, columns a thread, rows a thread, blocks per SM the
# launch bounds hold the registers to).  Thread t owns columns
# t + s*threads and rows t + s*threads and keeps their state in
# registers.  The last, with no columns or rows a thread, keeps the
# state in shared memory and loops over any number of columns and rows:
# it takes the shapes no register configuration holds (mirrors
# FOR_EACH_CONFIG in the CUDA source).
SHARED_CONFIG = (1024, 0, 0, 1)
CONFIGS = ((128, 2, 1, 2), (256, 3, 1, 2), (512, 6, 2, 2), (768, 8, 3, 1),
           SHARED_CONFIG)
SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_chunk.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {k: 0 for k in KERNELS}
_launch_lock = threading.Lock()
# per thread: the launches recorded into the graph it is capturing
_capture = threading.local()
_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(kernel: str, m: int, n: int, B: int) -> None:
    tally = getattr(_capture, "tally", None)
    if tally is not None and torch.cuda.is_current_stream_capturing():
        key = (kernel, m, n, B)
        tally[key] = tally.get(key, 0) + 1
        return
    with _launch_lock:
        LAUNCHES[kernel] += 1


@contextlib.contextmanager
def recording():
    """A block in which this thread captures a CUDA graph: the launches
    it makes on the capturing stream go into the yielded ``{(kernel, m,
    n, batch): count}`` instead of ``LAUNCHES`` (nothing runs until a
    replay)."""
    _capture.tally = tally = {}
    try:
        yield tally
    finally:
        _capture.tally = None


def add_launches(counts: dict) -> None:
    """Count the launches one replay of a captured graph makes
    (``counts`` as :func:`recording` gave them)."""
    with _launch_lock:
        for (kernel, *_), n in counts.items():
            LAUNCHES[kernel] += n


# ---------------------------------------------------------------------------
# Shape budget
# ---------------------------------------------------------------------------

def config_for(m: int, n: int, offsets=(), part=None,
               variant: str = VANILLA) -> Optional[tuple[int, int, int, int]]:
    """The first of ``CONFIGS`` that takes the shape: a register
    configuration whose threads cover n columns and m rows, or the
    shared-state one, with the block's shared memory (:func:`smem_bytes`)
    within ``BLOCK_SMEM_BYTES``; the shared-state one also needs K's
    compact forms within ``MAX_K_BYTES``.  None if none takes it."""
    for cfg in CONFIGS:
        threads, cpt, rpt, _ = cfg
        shared = cfg == SHARED_CONFIG
        if shared and part is not None and compact_bytes(part) > MAX_K_BYTES:
            continue
        if (shared or (n <= threads * cpt and m <= threads * rpt)) and \
                smem_bytes(m, n, offsets, part, variant, shared) \
                <= BLOCK_SMEM_BYTES:
            return cfg
    return None


def halo(offsets, m: int, n: int) -> tuple[int, int]:
    """Zeros around 2x1-x in shared memory so that row i reads entry
    ``i + d`` of every band without a bounds test: (left, right)."""
    if not offsets:
        return 0, 0
    return max(0, -min(offsets)), max(0, m + max(offsets) - n)


def smem_bytes(m: int, n: int, offsets=(), part=None,
               variant: str = VANILLA, shared: bool = False) -> int:
    """One block's shared memory (mirrors ``smem_words`` in the CUDA
    source).  Register configurations: c, l, u, x_sum and 2x1-x with its
    halo (x space); y and the band diagonals (y space); both compact
    forms of ``part``; under halpern the restart anchors.  The rest of
    the state lives in registers.  ``shared``, the shared-state
    configuration: x, x_sum, 2x1-x, c, l, u and y, y_sum, q; it reads K
    and the halpern anchors through L1/L2."""
    if shared:
        return 4 * (6 * n + 3 * m)
    hl, hr = halo(offsets, m, n)
    words = 5 * n + hl + hr + m + len(offsets) * m
    if part is not None:
        words += sum(t.numel() for t in _tensors(part)) - part.row_slot.numel()
    if variant == HALPERN:
        words += n + m
    return 4 * words


def compact_bytes(part) -> int:
    """Bytes of the compact forms in device memory (values and
    indices)."""
    return 4 * sum(t.numel() for t in _tensors(part))


def _tensors(part) -> tuple:
    return (part.row_slot, part.indptr, part.row_cols, part.row_vals,
            part.col_ptr, part.col_rows, part.col_vals)


def _shape(op) -> tuple[int, int, tuple]:
    from .pdhg import BandedOp
    if isinstance(op, BandedOp):
        return op.m, op.n, op.offsets
    m, n = op.Kh.shape
    return m, n, ()


def supports(op, variant: str = VANILLA) -> bool:
    """Whether a chunk kernel takes ``op`` under ``variant``: a banded op
    without an ELL residual and at most ``MAX_BANDS`` bands, or a dense
    op; with a thread configuration that takes its shape
    (:func:`config_for`).  All three variants are native."""
    from .pdhg import BandedOp, DenseOp
    if variant not in VARIANTS or not isinstance(op, (BandedOp, DenseOp)):
        return False
    if isinstance(op, BandedOp) and (op.ell is not None
                                     or len(op.offsets) > MAX_BANDS):
        return False
    m, n, offsets = _shape(op)
    return config_for(m, n, offsets, op.compact, variant) is not None


def kernel_for(op) -> str:
    from .pdhg import BandedOp
    return KERNEL_BANDED if isinstance(op, BandedOp) else KERNEL_DENSE


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors; and the reference on the card)
# ---------------------------------------------------------------------------

def banded_matvec(diags, offsets, wide_rows, wide_w, x, n: int):
    """K @ x for (B, n) x: ``out[i] = sum_b diags[b, i] x[i + d_b]`` plus
    the wide rows' ``(W x)_k`` added at row ``wide_rows[k]``."""
    m = diags.shape[1]
    lo, hi = min(offsets), max(offsets)
    left, right = max(0, -lo), max(0, hi + m - n)
    xp = torch.nn.functional.pad(x, (left, right))
    out = torch.zeros(x.shape[0], m, dtype=x.dtype, device=x.device)
    for b, d in enumerate(offsets):
        out = out + diags[b] * xp[:, left + d:left + d + m]
    if wide_w is not None:
        out = out.index_add(1, wide_rows, x @ wide_w.T)
    return out


def banded_rmatvec(diags, offsets, wide_rows, wide_w, y, n: int):
    """K.T @ y for (B, m) y: ``out[j] = sum_b diags[b, j-d_b] y[j-d_b]``
    plus ``sum_k y[wide_rows[k]] W[k, j]``."""
    m = diags.shape[1]
    lo, hi = min(offsets), max(offsets)
    left, right = max(0, hi), max(0, n - m - lo)
    V = torch.nn.functional.pad(diags[None] * y[:, None, :], (left, right))
    out = torch.zeros(y.shape[0], n, dtype=y.dtype, device=y.device)
    for b, d in enumerate(offsets):
        out = out + V[:, b, left - d:left - d + n]
    if wide_w is not None:
        out = out + y[:, wide_rows] @ wide_w
    return out


def _segment_sum(ptr, prod):
    """(B, len(ptr) - 1): the sums of ``prod``'s entries
    ``ptr[k]:ptr[k + 1]``, as a kernel thread sums its row or column."""
    k = ptr.shape[0] - 1
    seg = torch.repeat_interleave(torch.arange(k, device=prod.device),
                                  (ptr[1:] - ptr[:-1]).long())
    out = torch.zeros(prod.shape[0], k, dtype=prod.dtype, device=prod.device)
    return out.index_add(1, seg, prod)


def compact_matvec(diags, offsets, part, x):
    """K @ x for (B, n) x from the bands and the compact forms, indexed
    as the kernels index them: each band through a zero halo around x;
    each row whose ``row_slot`` k >= 0 adding its CSR entries
    ``indptr[k]:indptr[k+1]``.  ``diags`` (nb, m) or None."""
    m = part.row_slot.shape[0]
    hl, hr = halo(offsets, m, x.shape[1])
    xh = torch.nn.functional.pad(x, (hl, hr))
    out = torch.zeros(x.shape[0], m, dtype=x.dtype, device=x.device)
    for b, d in enumerate(offsets):
        out = out + diags[b] * xh[:, hl + d:hl + d + m]
    wide = _segment_sum(part.indptr,
                        part.row_vals * x[:, part.row_cols.long()])
    has = part.row_slot >= 0
    out[:, has] = out[:, has] + wide[:, part.row_slot[has].long()]
    return out


def compact_rmatvec(diags, offsets, part, y, n: int):
    """K.T @ y for (B, m) y, indexed as the kernels index it: column j
    takes band b where ``0 <= j - d_b < m``, then, for j in the column
    span, its CSC entries ``col_ptr[j - col_lo]:col_ptr[j - col_lo + 1]``."""
    m = y.shape[1]
    out = torch.zeros(y.shape[0], n, dtype=y.dtype, device=y.device)
    j = torch.arange(n, device=y.device)
    for b, d in enumerate(offsets):
        i = j - d
        ok = (i >= 0) & (i < m)
        ic = i.clamp(0, m - 1)
        out = out + torch.where(ok, diags[b, ic] * y[:, ic], 0.0)
    nc = part.col_ptr.shape[0] - 1
    out[:, part.col_lo:part.col_lo + nc] += _segment_sum(
        part.col_ptr, part.col_vals * y[:, part.col_rows.long()])
    return out


def floor_of(m: int, n_eq: int, dtype, device):
    """(m,) projection floor: -inf on the n_eq equality rows, 0 on the
    inequality rows."""
    fl = torch.zeros(m, dtype=dtype, device=device)
    fl[:n_eq] = -torch.inf
    return fl


def plain_chunk(matvec, rmatvec, c, q, l, u, tau, sig, floor, x, y, xs, ys,
                iters: int, variant: str = VANILLA, alpha: float = 1.0,
                k0=None, ax=None, ay=None):
    """``iters`` PDHG iterations with any K (``matvec``/``rmatvec`` on
    (B, ·) tensors).  ``tau``/``sig``/``k0`` are (B,) tensors."""
    tau, sig = tau[:, None], sig[:, None]
    kf = k0[:, None].clone() if variant == HALPERN else None
    for _ in range(iters):
        x1 = torch.clamp(x - tau * (c - rmatvec(y)), l, u)
        y1 = torch.maximum(y + sig * (q - matvec(2.0 * x1 - x)), floor)
        if variant == VANILLA:
            x, y = x1, y1
        elif variant == REFLECTED:
            x = torch.clamp(x + alpha * (x1 - x), l, u)
            y = torch.maximum(y + alpha * (y1 - y), floor)
        else:
            lam = (kf + 1.0) / (kf + 2.0)
            xr = x + alpha * (x1 - x)
            yr = y + alpha * (y1 - y)
            x = torch.clamp(lam * xr + (1.0 - lam) * ax, l, u)
            y = torch.maximum(lam * yr + (1.0 - lam) * ay, floor)
            kf = kf + 1.0
        xs = xs + x
        ys = ys + y
    return x, y, xs, ys


def banded_chunk_plain(c, q, l, u, tau, sig, x, y, xs, ys, diags, offsets,
                       wide_rows, wide_w, n_eq: int, iters: int,
                       variant: str = VANILLA, alpha: float = 1.0,
                       k0=None, ax=None, ay=None):
    """Plain version of the banded kernel (same arguments; ``offsets``
    also as the op's tuple, which reads nothing back from a tensor)."""
    offs = (offsets if isinstance(offsets, tuple)
            else tuple(int(v) for v in offsets.tolist()))
    n = x.shape[1]
    return plain_chunk(
        lambda v: banded_matvec(diags, offs, wide_rows, wide_w, v, n),
        lambda v: banded_rmatvec(diags, offs, wide_rows, wide_w, v, n),
        c, q, l, u, tau, sig, floor_of(diags.shape[1], n_eq, x.dtype,
                                       x.device),
        x, y, xs, ys, iters, variant, alpha, k0, ax, ay)


def dense_chunk_plain(c, q, l, u, tau, sig, x, y, xs, ys, K, n_eq: int,
                      iters: int, variant: str = VANILLA, alpha: float = 1.0,
                      k0=None, ax=None, ay=None):
    """Plain version of the dense kernel (same arguments)."""
    return plain_chunk(
        lambda v: v @ K.T, lambda v: v @ K,
        c, q, l, u, tau, sig, floor_of(K.shape[0], n_eq, x.dtype, x.device),
        x, y, xs, ys, iters, variant, alpha, k0, ax, ay)


# ---------------------------------------------------------------------------
# Build + bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def library_path() -> Path:
    """The built library, keyed by the source's hash so an edited source
    rebuilds instead of loading a stale binary."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfused_chunk-{digest}.so"


def build() -> Path:
    """Compile ``csrc/fused_chunk.cu`` (once per source hash); returns
    the library path.  ``BUILD_LOG`` keeps ptxas's register, stack and
    spill report (kept beside the library, so a process that finds the
    library built still has it).  A failed build raises with nvcc's
    output."""
    global BUILD_LOG
    so = library_path()
    log = so.with_suffix(".ptxas.txt")
    if so.exists():
        if log.exists():
            BUILD_LOG = log.read_text()
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
    BUILD_LOG = proc.stdout + proc.stderr
    log.write_text(BUILD_LOG)
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # state (13 in, 4 out), compact forms (7), their sizes and
            # the shape (9), the step variant, the thread configuration
            common = [P] * 17 + [P] * 7 + [I] * 9 + [I, F] + [I] * 4
            lib.banded_chunk.argtypes = (
                common + [P, ctypes.POINTER(I), I] + [P])
            lib.banded_chunk.restype = I
            lib.dense_chunk.argtypes = common + [P]
            lib.dense_chunk.restype = I
            lib.fused_chunk_error_string.argtypes = [I]
            lib.fused_chunk_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


_FORMS = ("row_slot", "indptr", "row_cols", "row_vals", "col_ptr",
          "col_rows", "col_vals")
_INT_KEYS = ("row_slot", "indptr", "row_cols", "col_ptr", "col_rows")


def _check(name: str, device, tensors: dict, shapes: dict) -> None:
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        want = torch.int32 if key in _INT_KEYS else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in shapes and tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")


def _raise_on(lib, name: str, err: int) -> None:
    if err:
        msg = lib.fused_chunk_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def _launch(kernel: str, state: dict, part, B: int, m: int, n: int,
            n_eq: int, iters: int, variant: str, alpha: float,
            diags=None, offsets=()):
    """Check the arguments of either kernel and launch it on the current
    stream; returns (x, y, x_sum, y_sum)."""
    x = state["x"]
    cfg = None
    if variant in VARIANTS and len(offsets) <= MAX_BANDS:
        cfg = config_for(m, n, offsets, part, variant)
    if cfg is None:
        raise ValueError(f"{kernel} does not take m={m} n={n} "
                         f"nb={len(offsets)} variant={variant!r}")
    r = part.indptr.shape[0] - 1
    nc = part.col_ptr.shape[0] - 1
    nnz = part.nnz
    shapes = {"c": (B, n), "l": (B, n), "u": (B, n), "x": (B, n),
              "xs": (B, n), "q": (B, m), "y": (B, m), "ys": (B, m),
              "tau": (B,), "sig": (B,), "diags": (len(offsets), m),
              "row_slot": (m,), "indptr": (r + 1,), "row_cols": (nnz,),
              "row_vals": (nnz,), "col_ptr": (nc + 1,), "col_rows": (nnz,),
              "col_vals": (nnz,)}
    if variant == HALPERN:
        shapes.update({"k0": (B,), "ax": (B, n), "ay": (B, m)})
    else:
        state = {**state, "k0": None, "ax": None, "ay": None}
    forms = dict(zip(_FORMS, _tensors(part)))
    _check(kernel, x.device, {**state, "diags": diags, **forms}, shapes)
    lib = _load()
    out = [torch.empty_like(x), torch.empty_like(state["y"]),
           torch.empty_like(x), torch.empty_like(state["y"])]
    args = [_ptr(state[k]) for k in ("c", "q", "l", "u", "tau", "sig", "x",
                                     "y", "xs", "ys", "k0", "ax", "ay")]
    args += [_ptr(t) for t in out] + [_ptr(t) for t in forms.values()]
    args += [r, nnz, part.col_lo, nc, B, m, n, int(n_eq), int(iters),
             _VARIANT_CODE[variant], float(alpha), *cfg]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kernel == KERNEL_BANDED:
            offs = (ctypes.c_int * max(1, len(offsets)))(*offsets)
            err = lib.banded_chunk(*args, _ptr(diags), offs, len(offsets),
                                   stream)
        else:
            err = lib.dense_chunk(*args, stream)
    _raise_on(lib, kernel, err)
    _count_launch(kernel, m, n, B)
    return tuple(out)


def banded_chunk(c, q, l, u, tau, sig, x, y, xs, ys, op, n_eq: int,
                 iters: int, variant: str = VANILLA, alpha: float = 1.0,
                 k0=None, ax=None, ay=None):
    """``iters`` iterations of the banded chunk for the ``BandedOp``
    ``op``: per-instance (B, ·) f32 state; ``tau``, ``sig``, ``k0`` (B,).
    CPU tensors run the plain version (with the dense wide pair); CUDA
    tensors launch the kernel, which reads the band diagonals and the
    wide pair's compact forms (``op.compact``)."""
    if x.device.type == "cpu":
        return banded_chunk_plain(c, q, l, u, tau, sig, x, y, xs, ys,
                                  op.diags, op.offsets, op.wide_rows,
                                  op.wide_w, n_eq, iters, variant, alpha,
                                  k0, ax, ay)
    if x.device.type != "cuda":
        raise ValueError(f"banded_chunk: unsupported device {x.device}")
    return _launch(KERNEL_BANDED, dict(c=c, q=q, l=l, u=u, tau=tau, sig=sig,
                                       x=x, y=y, xs=xs, ys=ys, k0=k0, ax=ax,
                                       ay=ay),
                   op.compact, x.shape[0], op.m, op.n, n_eq, iters, variant,
                   alpha, op.diags, op.offsets)


def dense_chunk(c, q, l, u, tau, sig, x, y, xs, ys, op, n_eq: int,
                iters: int, variant: str = VANILLA, alpha: float = 1.0,
                k0=None, ax=None, ay=None):
    """``iters`` iterations of the dense chunk for the ``DenseOp`` ``op``.
    CPU tensors run the plain version (with the dense ``Kh``); CUDA
    tensors launch the kernel, which reads K's compact forms
    (``op.compact``)."""
    if x.device.type == "cpu":
        return dense_chunk_plain(c, q, l, u, tau, sig, x, y, xs, ys, op.Kh,
                                 n_eq, iters, variant, alpha, k0, ax, ay)
    if x.device.type != "cuda":
        raise ValueError(f"dense_chunk: unsupported device {x.device}")
    m, n = op.Kh.shape
    return _launch(KERNEL_DENSE, dict(c=c, q=q, l=l, u=u, tau=tau, sig=sig,
                                      x=x, y=y, xs=xs, ys=ys, k0=k0, ax=ax,
                                      ay=ay),
                   op.compact, x.shape[0], m, n, n_eq, iters, variant, alpha)


def batched_chunk(op, c, q, l, u, omega, eta, x, y, xs, ys, n_eq: int,
                  iters: int, variant: str = VANILLA, alpha: float = 1.0,
                  k=None, ax=None, ay=None):
    """Run ``iters`` iterations for the whole batch through the kernel
    that takes ``op`` (see :func:`supports`).  Data args are (B, ·);
    ``omega`` (B,), ``eta`` a scalar tensor.  Computes tau = eta/omega
    and sigma = eta*omega per instance; halpern takes the inner count
    ``k`` (B,) and the restart anchors ``ax``/``ay``, which only move
    between chunks.  The caller advances ``k`` by ``iters``."""
    from .pdhg import BandedOp
    tau = (eta / omega).to(torch.float32).contiguous()
    sig = (eta * omega).to(torch.float32).contiguous()
    k0 = k.to(torch.float32).contiguous() if variant == HALPERN else None
    if variant != HALPERN:
        ax = ay = None
    run = banded_chunk if isinstance(op, BandedOp) else dense_chunk
    return run(c, q, l, u, tau, sig, x, y, xs, ys, op, n_eq, iters, variant,
               alpha, k0, ax, ay)


def matrix_work(op, needed: bool = False) -> tuple[int, int]:
    """(bytes, multiply-adds) of K for one launch's bound: the bytes of K
    read once, and the multiply-adds of one K x plus one K^T y.  With
    ``needed``, as the function needs them: K's non-zeros, each read
    once (4 bytes) and used once in each product.  Otherwise as the
    kernel stores and multiplies K: the band diagonals, padded to m
    entries each, and the compact forms' entries, each used once in
    each product; the compact forms' values and indices.  Reads tensors
    back: not for the solve path."""
    from .pdhg import BandedOp
    part = op.compact
    diags = op.diags if isinstance(op, BandedOp) else None
    if needed:
        nnz = part.nnz
        if diags is not None:
            nnz += int((diags != 0).sum())
        return 4 * nnz, 2 * nnz
    band = 0 if diags is None else diags.numel()
    return 4 * band + compact_bytes(part), 2 * (band + part.nnz)


def chunk_cost(B: int, m: int, n: int, iters: int, k_bytes: int,
               k_macs: int, variant: str = VANILLA) -> tuple[int, int]:
    """(bytes, fp32 operations) one launch needs at least: every input
    read once and every output written once, K's ``k_bytes``, and the
    iteration's arithmetic with ``k_macs`` multiply-adds of K per
    iteration (:func:`matrix_work`).  The elementwise count per
    iteration is 9 operations per x entry and 6 per y entry (projection,
    step, reflected point, running sum) plus 5 each for a reflected and
    9 each for a halpern relaxation."""
    halp = variant == HALPERN
    per_inst = 4 * (5 * n + 3 * m + 2) + 4 * (2 * n + 2 * m)
    if halp:
        per_inst += 4 * (n + m + 1)
    elem = 9 * n + 6 * m
    if variant == REFLECTED:
        elem += 5 * (n + m)
    elif halp:
        elem += 9 * (n + m)
    ops = B * iters * (2 * k_macs + elem)
    return B * per_inst + k_bytes, ops
