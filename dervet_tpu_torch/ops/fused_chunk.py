"""Fused PDHG iteration chunks: CUDA kernels, their wrappers and plain versions.

Counterpart of ``dervet_tpu/ops/pallas_chunk.py``.  One chunk runs
``iters`` PDHG iterations (vanilla, reflected or halpern step) for a
batch of instances that share one scaled constraint matrix, with the
iterate held on chip, and returns ``(x, y, x_sum, y_sum)``.  Two kernels,
both in ``csrc/fused_chunk.cu``:

* ``banded_chunk`` — K as ``nb`` static diagonals plus the optional
  low-rank wide-row pair (``BandedOp``, every monthly window);
* ``dense_chunk`` — dense K (``DenseOp``, short windows such as weekly).

Each wrapper takes its plain PyTorch version only for tensors on the CPU
(the tests); for CUDA tensors it launches its kernel or raises — there is
no fallback.  ``LAUNCHES`` counts kernel launches per kernel, incremented
at the launch and nowhere else.

The kernels are compiled at first use with ``nvcc`` from the package's own
source into ``dervet_tpu_torch/_build/`` (a plain C interface loaded with
ctypes), for ``sm_90a``.
"""
from __future__ import annotations

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
# holds one instance's state, so a shape whose state exceeds this is
# declined (supports) and runs the plain path
BLOCK_SMEM_BYTES = 232_448
# the dense kernel streams K from L2 on every iteration; cap it well
# inside the 50 MB L2 so K stays resident beside the blocks' traffic
MAX_K_BYTES = 10 * 1024 * 1024
# the banded kernel keeps the band offsets on chip; the JAX kernel's cap
MAX_BANDS = 32

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_chunk.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {k: 0 for k in KERNELS}
_launch_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(kernel: str) -> None:
    with _launch_lock:
        LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# Shape budget
# ---------------------------------------------------------------------------

def banded_smem_bytes(m: int, n: int, nb: int, r: int) -> int:
    """One block's shared memory: x, 2x1-x, x_sum, c, l, u (x space);
    y, y_sum, q (y space); the wide products; the offsets; the row->wide
    slot map (mirrors ``banded_chunk_smem_bytes`` in the CUDA source)."""
    return 4 * (6 * n + 3 * m + r) + 4 * (nb + m)


def dense_smem_bytes(m: int, n: int) -> int:
    return 4 * (6 * n + 3 * m)


def supports(op, variant: str = VANILLA) -> bool:
    """Whether a chunk kernel takes ``op`` under ``variant``: a banded op
    without an ELL residual and at most ``MAX_BANDS`` bands, or a dense
    op with K at most ``MAX_K_BYTES``; and one instance's on-chip state
    within one block's shared memory.  All three variants are native
    (halpern's anchors are read through L2, so they cost no shared
    memory)."""
    from .pdhg import BandedOp, DenseOp
    if variant not in VARIANTS:
        return False
    if isinstance(op, BandedOp):
        if op.ell is not None or len(op.offsets) > MAX_BANDS:
            return False
        r = 0 if op.wide_w is None else int(op.wide_w.shape[0])
        return banded_smem_bytes(op.m, op.n, len(op.offsets), r) \
            <= BLOCK_SMEM_BYTES
    if isinstance(op, DenseOp):
        m, n = op.Kh.shape
        return m * n * 4 <= MAX_K_BYTES \
            and dense_smem_bytes(m, n) <= BLOCK_SMEM_BYTES
    return False


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
    """Plain version of the banded kernel (same arguments)."""
    offs = tuple(int(v) for v in offsets.tolist())
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
    the library path.  ``BUILD_LOG`` keeps ptxas's register and
    shared-memory report.  A failed build raises with nvcc's output."""
    global BUILD_LOG
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
    BUILD_LOG = proc.stdout + proc.stderr
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.banded_chunk.argtypes = (
                [P] * 12 + [I, P, P, I, P, P, P, P, P, P, P]
                + [I] * 6 + [F, P])
            lib.banded_chunk.restype = I
            lib.dense_chunk.argtypes = [P] * 18 + [I] * 6 + [F, P]
            lib.dense_chunk.restype = I
            lib.fused_chunk_error_string.argtypes = [I]
            lib.fused_chunk_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name: str, device, tensors: dict, shapes: dict) -> None:
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        want = torch.int32 if key in ("offsets", "wide_rows") \
            else torch.float32
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


def _state_shapes(B, m, n, variant):
    s = {"c": (B, n), "l": (B, n), "u": (B, n), "x": (B, n), "xs": (B, n),
         "q": (B, m), "y": (B, m), "ys": (B, m), "tau": (B,), "sig": (B,)}
    if variant == HALPERN:
        s.update({"k0": (B,), "ax": (B, n), "ay": (B, m)})
    return s


def banded_chunk(c, q, l, u, tau, sig, x, y, xs, ys, diags, offsets,
                 wide_rows, wide_w, n_eq: int, iters: int,
                 variant: str = VANILLA, alpha: float = 1.0,
                 k0=None, ax=None, ay=None):
    """``iters`` iterations of the banded chunk.  ``diags`` (nb, m) f32,
    ``offsets`` (nb,) int32, ``wide_rows`` (r,) int32 and ``wide_w``
    (r, n) f32 or both None; per-instance (B, ·) f32 state; ``tau``,
    ``sig``, ``k0`` (B,).  CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    if x.device.type == "cpu":
        return banded_chunk_plain(c, q, l, u, tau, sig, x, y, xs, ys, diags,
                                  offsets, wide_rows, wide_w, n_eq, iters,
                                  variant, alpha, k0, ax, ay)
    if x.device.type != "cuda":
        raise ValueError(f"banded_chunk: unsupported device {x.device}")
    B, n = x.shape
    nb, m = diags.shape
    r = 0 if wide_w is None else int(wide_w.shape[0])
    if variant not in VARIANTS or nb > MAX_BANDS \
            or banded_smem_bytes(m, n, nb, r) > BLOCK_SMEM_BYTES:
        raise ValueError(f"banded_chunk does not take m={m} n={n} nb={nb} "
                         f"r={r} variant={variant!r}")
    shapes = _state_shapes(B, m, n, variant)
    shapes.update({"offsets": (nb,), "wide_rows": (r,), "wide_w": (r, n)})
    _check("banded_chunk", x.device,
           dict(c=c, q=q, l=l, u=u, tau=tau, sig=sig, x=x, y=y, xs=xs,
                ys=ys, diags=diags, offsets=offsets, wide_rows=wide_rows,
                wide_w=wide_w, k0=k0, ax=ax, ay=ay), shapes)
    lib = _load()
    xo, xso = torch.empty_like(x), torch.empty_like(xs)
    yo, yso = torch.empty_like(y), torch.empty_like(ys)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.banded_chunk(
            *(_ptr(t) for t in (c, q, l, u, tau, sig, x, y, xs, ys, diags,
                                offsets)), nb,
            _ptr(wide_rows), _ptr(wide_w), r,
            *(_ptr(t) for t in (k0, ax, ay, xo, yo, xso, yso)),
            B, m, n, int(n_eq), int(iters), _VARIANT_CODE[variant],
            float(alpha), stream)
    _raise_on(lib, "banded_chunk", err)
    _count_launch(KERNEL_BANDED)
    return xo, yo, xso, yso


def dense_chunk(c, q, l, u, tau, sig, x, y, xs, ys, K, n_eq: int,
                iters: int, variant: str = VANILLA, alpha: float = 1.0,
                k0=None, ax=None, ay=None):
    """``iters`` iterations of the dense chunk (``K`` (m, n) f32).  CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return dense_chunk_plain(c, q, l, u, tau, sig, x, y, xs, ys, K,
                                 n_eq, iters, variant, alpha, k0, ax, ay)
    if x.device.type != "cuda":
        raise ValueError(f"dense_chunk: unsupported device {x.device}")
    B, n = x.shape
    m = K.shape[0]
    if variant not in VARIANTS or m * n * 4 > MAX_K_BYTES \
            or dense_smem_bytes(m, n) > BLOCK_SMEM_BYTES:
        raise ValueError(f"dense_chunk does not take m={m} n={n} "
                         f"variant={variant!r}")
    shapes = _state_shapes(B, m, n, variant)
    shapes["K"] = (m, n)
    _check("dense_chunk", x.device,
           dict(c=c, q=q, l=l, u=u, tau=tau, sig=sig, x=x, y=y, xs=xs,
                ys=ys, K=K, k0=k0, ax=ax, ay=ay), shapes)
    lib = _load()
    xo, xso = torch.empty_like(x), torch.empty_like(xs)
    yo, yso = torch.empty_like(y), torch.empty_like(ys)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dense_chunk(
            *(_ptr(t) for t in (c, q, l, u, tau, sig, x, y, xs, ys, K, k0,
                                ax, ay, xo, yo, xso, yso)),
            B, m, n, int(n_eq), int(iters), _VARIANT_CODE[variant],
            float(alpha), stream)
    _raise_on(lib, "dense_chunk", err)
    _count_launch(KERNEL_DENSE)
    return xo, yo, xso, yso


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
    if isinstance(op, BandedOp):
        return banded_chunk(c, q, l, u, tau, sig, x, y, xs, ys, op.diags,
                            op.offsets_t, op.wide_rows, op.wide_w, n_eq,
                            iters, variant, alpha, k0, ax, ay)
    return dense_chunk(c, q, l, u, tau, sig, x, y, xs, ys, op.Kh, n_eq,
                       iters, variant, alpha, k0, ax, ay)


def chunk_cost(kernel: str, B: int, m: int, n: int, iters: int,
               nb: int = 0, r: int = 0, variant: str = VANILLA,
               nnz: Optional[int] = None) -> tuple[int, int]:
    """(bytes, fp32 operations) one launch needs at least: every input
    read once and every output written once, and the iteration's
    arithmetic.  Without ``nnz`` the matrix is counted as the kernel
    stores and multiplies it (band diagonals and the dense W, or the
    dense K, zeros and all).  With ``nnz``, the non-zeros of the scaled
    K, it is counted as the function needs it: each non-zero read once
    and used in one multiply-add of K x and one of K^T y.  The
    elementwise count per iteration is 9 operations per x entry and 6
    per y entry (projection, step, reflected point, running sum) plus 5
    each for a reflected and 9 each for a halpern relaxation."""
    halp = variant == HALPERN
    per_inst = 4 * (5 * n + 3 * m + 2) + 4 * (2 * n + 2 * m)
    if halp:
        per_inst += 4 * (n + m + 1)
    if nnz is not None:
        shared = 4 * nnz
        macs = 2 * nnz
    elif kernel == KERNEL_BANDED:
        shared = 4 * (nb * m + nb + r * n + r)
        macs = 2 * nb * m + 2 * r * n
    else:
        shared = 4 * m * n
        macs = 2 * m * n
    elem = 9 * n + 6 * m
    if variant == REFLECTED:
        elem += 5 * (n + m)
    elif halp:
        elem += 9 * (n + m)
    ops = B * iters * (2 * macs + elem)
    return B * per_inst + shared, ops
