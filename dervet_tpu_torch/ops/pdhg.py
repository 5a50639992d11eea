"""Batched restarted PDHG (PDLP-family) LP solver in PyTorch.

Counterpart of ``dervet_tpu/ops/pdhg.py``.  Solves the canonical-form LP

    min c@x   s.t.  (K@x - q)[:n_eq] == 0,  (K@x - q)[n_eq:] >= 0,  l<=x<=u

for a batch of instances sharing ``K`` (only ``c, q, l, u`` vary).  Every
tensor carries a leading batch dimension (B, ·) where the JAX package
used ``vmap``.  Every solve is driven as a batch (B >= 1), so a single
window also rides the chunk kernel.

The compiled chunk program.  The JAX package runs each host chunk as one
jitted ``while_loop`` whose body is the check window.  Here the check
window is one function of device tensors that reads nothing back
(:meth:`_Solver.window`), and a :class:`_WindowRunner` (one a solver and
batch width) holds the window's inputs, context and state in static
buffers.  On a CUDA device each window is the replay of a
``torch.cuda.CUDAGraph`` captured once for its number of sub-blocks; on
the CPU the same function runs eagerly on the buffers, the plain
version the tests hold the graphs against.  The host makes one status
read after each window (and one as a chunk starts), which ends the
chunk exactly when no instance is active.  The row-sharded solve
(``parallel/timeshard.py``) keeps the eager window loop,
:meth:`_Solver.run_chunk`.

The iteration chunk (``sub`` PDHG iterations between restart checks)
runs in the hand-written CUDA kernels of :mod:`.fused_chunk` when the op
is banded or dense and fits one block's shared memory; an op the kernels
do not take (an ELL residual, a footprint over budget) runs the plain
PyTorch chunk, and the ledger records ``unsupported_shape``.

Per-instance masking: under ``vmap`` the JAX ``while_loop`` freezes each
instance once ITS OWN condition fails (converged, infeasible, or the
chunk's iteration limit).  The window reproduces that by applying its
update only where the instance is still active, so finished instances
do not drift and iteration counts match.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import NamedTuple, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from . import fused_chunk
from .lp import LP

# Solver version tag: bump on any numerics change that can alter a
# certified answer.  Stamped into run_health and the solve ledger.
SOLVER_VERSION = "pdhg-torch-1.0"

# status codes (PDHGResult.status)
STATUS_CONVERGED = 0
STATUS_ITER_LIMIT = 1
STATUS_PRIMAL_INFEASIBLE = 2
STATUS_INACCURATE = 3

STATUS_MESSAGES = {
    STATUS_CONVERGED: "converged",
    STATUS_ITER_LIMIT: "iteration limit reached before convergence",
    STATUS_PRIMAL_INFEASIBLE: "primal infeasibility certified by the "
                              "dual ray",
    STATUS_INACCURATE: "solved to reduced accuracy (KKT within the "
                       "inaccurate-factor tolerance at the iteration "
                       "limit)",
}


def status_message(code) -> str:
    """Human-readable message for a PDHGResult.status code."""
    return STATUS_MESSAGES.get(int(code),
                               f"unrecognized solver status {int(code)}")


# ---------------------------------------------------------------------------
# Step variants and restart schemes (see the JAX package's module notes)
# ---------------------------------------------------------------------------

VARIANT_VANILLA = fused_chunk.VANILLA
VARIANT_REFLECTED = fused_chunk.REFLECTED
VARIANT_HALPERN = fused_chunk.HALPERN
PDHG_VARIANTS = fused_chunk.VARIANTS
# operator kill switch: 'vanilla' restores the classic PDLP iteration
# without touching caller options; read when a solver is built
PDHG_VARIANT_ENV = "DERVET_TPU_PDHG_VARIANT"

_variant_env_warned = False


def resolved_variant(opts: "PDHGOptions") -> str:
    """The step variant a solver built from ``opts`` runs:
    ``PDHG_VARIANT_ENV`` overrides ``opts.variant``; an unrecognized env
    value warns once and is ignored, an unrecognized option raises."""
    global _variant_env_warned
    env = os.environ.get(PDHG_VARIANT_ENV, "").strip().lower()
    if env:
        if env in PDHG_VARIANTS:
            return env
        if not _variant_env_warned:
            _variant_env_warned = True
            from ..utils.errors import TellUser
            TellUser.warning(
                f"{PDHG_VARIANT_ENV}={env!r} is not one of "
                f"{PDHG_VARIANTS}; ignoring the override")
    v = str(opts.variant).strip().lower()
    if v not in PDHG_VARIANTS:
        raise ValueError(
            f"PDHGOptions.variant {opts.variant!r} is not one of "
            f"{PDHG_VARIANTS}")
    return v


RESTART_KKT = "kkt"
RESTART_FIXED_POINT = "fixed_point"
RESTART_AUTO = "auto"
RESTART_SCHEMES = (RESTART_KKT, RESTART_FIXED_POINT, RESTART_AUTO)


def resolved_restart_scheme(opts: "PDHGOptions") -> str:
    """The concrete restart criterion (``auto``: fixed_point for halpern,
    kkt otherwise, per the resolved variant)."""
    s = str(opts.restart_scheme).strip().lower()
    if s not in RESTART_SCHEMES:
        raise ValueError(
            f"PDHGOptions.restart_scheme {opts.restart_scheme!r} is not "
            f"one of {RESTART_SCHEMES}")
    if s == RESTART_AUTO:
        return (RESTART_FIXED_POINT
                if resolved_variant(opts) == VARIANT_HALPERN
                else RESTART_KKT)
    return s


# ---------------------------------------------------------------------------
# Preconditioning (host-side, numpy — once per problem structure)
# ---------------------------------------------------------------------------

def _segment_max(vals: np.ndarray, ptr: np.ndarray, out_len: int) -> np.ndarray:
    """Max of ``vals`` over contiguous segments ``[ptr[i], ptr[i+1])``,
    0.0 for empty segments (reduceat over the non-empty starts only)."""
    out = np.zeros(out_len)
    if not len(vals):
        return out
    nonempty = np.nonzero(ptr[:-1] < ptr[1:])[0]
    if len(nonempty):
        out[nonempty] = np.maximum.reduceat(vals, ptr[:-1][nonempty])
    return out


def ruiz_scaling(K, iters: int = 10):
    """Iterated l-inf Ruiz equilibration.  Returns (d_r, d_c) with
    K_hat = diag(d_r) @ K @ diag(d_c) approximately balanced."""
    csr = K.tocsr()
    m, n = csr.shape
    absd_row = np.abs(csr.data).astype(np.float64)
    row_ptr = csr.indptr
    col_of = csr.indices
    perm = np.argsort(col_of, kind="stable")
    col_ptr = np.concatenate(
        ([0], np.cumsum(np.bincount(col_of, minlength=n))))
    row_of = np.repeat(np.arange(m), np.diff(row_ptr))
    d_r = np.ones(m)
    d_c = np.ones(n)
    for _ in range(iters):
        row_max = _segment_max(absd_row, row_ptr, m)
        col_max = _segment_max(absd_row[perm], col_ptr, n)
        r = 1.0 / np.sqrt(np.maximum(row_max, 1e-12))
        c = 1.0 / np.sqrt(np.maximum(col_max, 1e-12))
        r[row_max == 0] = 1.0
        c[col_max == 0] = 1.0
        absd_row *= r[row_of]
        absd_row *= c[col_of]
        d_r *= r
        d_c *= c
    return d_r, d_c


# ---------------------------------------------------------------------------
# Matvec operators (dense | ELL | banded), batched over a leading axis
# ---------------------------------------------------------------------------

# residual rows admitted to BandedOp's low-rank wide-row pair instead of an
# ELL residual (a year of daily-cycle rows, 366, fits)
WIDE_MAX_ROWS = 384
WIDE_MAX_BYTES = 8 * 1024 * 1024


class CompactK(NamedTuple):
    """Some rows of K (``r`` compact rows, ``nnz`` non-zeros) in the two
    forms the chunk kernels read; ``fused_chunk.compact_matvec``/
    ``compact_rmatvec`` apply them with the kernels' indexing.  The
    banded op's wide rows, or every row of the dense op.

    By row (CSR, for K x): compact row k holds entries
    ``indptr[k]:indptr[k + 1]`` of ``row_cols``/``row_vals``, and
    ``row_slot`` maps K's row i to its compact row.  By column (CSC, for
    K^T y), over the ``nc`` columns from ``col_lo`` on (the span of the
    columns that have entries): column ``col_lo + c`` holds entries
    ``col_ptr[c]:col_ptr[c + 1]`` of ``col_rows`` (K's row) and
    ``col_vals``."""
    row_slot: torch.Tensor    # (m,) int32: compact row k of K's row i, or -1
    indptr: torch.Tensor      # (r + 1,) int32
    row_cols: torch.Tensor    # (nnz,) int32
    row_vals: torch.Tensor    # (nnz,)
    col_ptr: torch.Tensor     # (nc + 1,) int32
    col_rows: torch.Tensor    # (nnz,) int32
    col_vals: torch.Tensor    # (nnz,)
    col_lo: int
    nnz: int


def compact_k(rows, M, m: int, device, dtype=torch.float32) -> CompactK:
    """The compact forms of the (r, n) matrix ``M`` (numpy or scipy) whose
    row k is row ``rows[k]`` of the (m, n) K.  Values are cast to
    ``dtype`` first, so they equal the dense tensor's entries exactly."""
    rows = np.asarray(rows, np.int64)
    S = sp.csr_matrix(M)
    S.data = S.data.astype(torch.empty(0, dtype=dtype).numpy().dtype)
    S.eliminate_zeros()
    S.sort_indices()
    C = S.tocsc()
    C.sort_indices()
    used = np.flatnonzero(np.diff(C.indptr))
    lo, hi = (int(used[0]), int(used[-1]) + 1) if S.nnz else (0, 0)
    row_slot = np.full(m, -1, np.int32)
    row_slot[rows] = np.arange(S.shape[0])

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    def val(a):
        return torch.tensor(a, dtype=dtype, device=device)
    return CompactK(
        row_slot=i32(row_slot), indptr=i32(S.indptr),
        row_cols=i32(S.indices), row_vals=val(S.data),
        col_ptr=i32(C.indptr[lo:hi + 1]), col_rows=i32(rows[C.indices]),
        col_vals=val(C.data), col_lo=lo, nnz=S.nnz)


class DenseOp:
    """Dense K (``Kh``, (m, n)) and, for the dense chunk kernel, the same
    K in compact form (``compact``: every row a compact row)."""

    def __init__(self, Kh, compact: Optional[CompactK] = None):
        self.Kh = Kh
        self._compact = compact

    @property
    def compact(self) -> CompactK:
        # an op built by hand (the tests) builds its forms at first use
        if self._compact is None:
            m = self.Kh.shape[0]
            self._compact = compact_k(np.arange(m), self.Kh.cpu().numpy(),
                                      m, self.Kh.device, self.Kh.dtype)
        return self._compact


class EllOp(NamedTuple):
    data: torch.Tensor        # (m, k)  row-padded values
    cols: torch.Tensor        # (m, k)  int64 column ids (pad -> 0, data 0)
    data_t: torch.Tensor      # (n, kt) transpose table
    cols_t: torch.Tensor      # (n, kt)
    dense_idx: torch.Tensor   # (kd,) int64 near-dense column ids
    dense_blk: torch.Tensor   # (m, kd)


class BandedOp:
    """Diagonal-band decomposition of a dispatch constraint matrix:
    ``K[i, i + d_b] = diags[b, i]`` for the static ``offsets`` d_b, plus
    an optional low-rank wide-row pair ``K_wide = P @ W``.  The JAX
    package keeps P as an (m, r) 0/1 selector; here it travels as the
    row index of each of its columns (``wide_rows``, (r,) int32) — the
    same function, since each column of P holds one 1.  Residual entries
    that fit neither ride an ELL op.  ``compact`` carries the wide pair
    in the compact forms the banded chunk kernel reads (no compact rows
    without a wide pair)."""

    def __init__(self, diags, offsets, m, n, ell=None, wide_rows=None,
                 wide_w=None, compact: Optional[CompactK] = None):
        self.diags = diags            # (nb, m)
        self.offsets = tuple(int(d) for d in offsets)
        self.offsets_t = torch.tensor(self.offsets, dtype=torch.int32,
                                      device=diags.device)
        self.m = m
        self.n = n
        self.ell = ell
        self.wide_rows = wide_rows    # (r,) int32 or None
        self.wide_w = wide_w          # (r, n) or None
        self._compact = compact

    @property
    def compact(self) -> CompactK:
        # an op built by hand (the tests) builds its forms at first use
        if self._compact is None:
            host = (None, None) if self.wide_w is None else (
                self.wide_rows.cpu().numpy(), self.wide_w.cpu().numpy())
            self._compact = _wide_compact(*host, self.m, self.n,
                                          self.diags.device, self.diags.dtype)
        return self._compact


def _wide_compact(rows, W, m: int, n: int, device, dtype) -> CompactK:
    """The compact forms of a banded op's wide pair (none without one)."""
    if W is None:
        rows, W = np.zeros(0, np.int64), np.zeros((0, n))
    return compact_k(rows, W, m, device, dtype)


MatOp = Union[DenseOp, EllOp, BandedOp]


def _csr_to_ell(K) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> ELLPACK (data, cols) with rows padded to the max row nnz."""
    K = K.tocsr()
    m = K.shape[0]
    counts = np.diff(K.indptr)
    k = max(int(counts.max()) if m else 0, 1)
    data = np.zeros((m, k), np.float64)
    cols = np.zeros((m, k), np.int64)
    rows = np.repeat(np.arange(m), counts)
    pos = np.arange(K.nnz) - np.repeat(K.indptr[:-1], counts)
    data[rows, pos] = K.data
    cols[rows, pos] = K.indices
    return data, cols


def _ell_leaves(K_csr, dense_cols, blk) -> dict:
    d, c = _csr_to_ell(K_csr)
    dt, ct = _csr_to_ell(K_csr.T.tocsr())
    return dict(data=d, cols=c, data_t=dt, cols_t=ct,
                dense_idx=np.asarray(dense_cols, np.int64), dense_blk=blk)


def _build_op(kind: str, leaves: dict, device, dtype=torch.float32) -> MatOp:
    """The op of ``kind`` ('dense' | 'ell' | 'banded') from numpy leaves."""
    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a, dt=torch.int64):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    if kind == "dense":
        Kh = np.asarray(leaves["Kh"])
        return DenseOp(Kh=f(Kh), compact=compact_k(
            np.arange(Kh.shape[0]), Kh, Kh.shape[0], device, dtype))
    if kind == "ell":
        return EllOp(data=f(leaves["data"]), cols=i(leaves["cols"]),
                     data_t=f(leaves["data_t"]), cols_t=i(leaves["cols_t"]),
                     dense_idx=i(leaves["dense_idx"]),
                     dense_blk=f(leaves["dense_blk"]))
    if kind != "banded":
        raise ValueError(f"unknown op kind {kind!r}")
    diags = np.asarray(leaves["diags"])
    m = int(leaves.get("m", diags.shape[1]))
    wide_w = leaves.get("wide_w")
    rows = leaves.get("wide_rows")
    if rows is None and leaves.get("wide_p") is not None:
        P = np.asarray(leaves["wide_p"])
        # each column of the 0/1 selector holds exactly one 1
        rows = np.argmax(P, axis=0)
    n = int(leaves["n"])
    ell = leaves.get("ell")
    compact = _wide_compact(rows, wide_w, m, n, device, dtype)
    return BandedOp(
        diags=f(diags), offsets=leaves["offsets"], m=m, n=n,
        ell=_build_op("ell", ell, device, dtype) if ell is not None else None,
        wide_rows=None if wide_w is None else i(rows, torch.int32),
        wide_w=None if wide_w is None else f(wide_w), compact=compact)


def op_to(op: MatOp, device) -> MatOp:
    """``op`` with every tensor (K's compact forms included) copied to
    ``device``."""
    def t(a):
        return a.to(device) if isinstance(a, torch.Tensor) else a

    def ck(c):
        return None if c is None else CompactK(*(t(a) for a in c))
    if isinstance(op, DenseOp):
        return DenseOp(t(op.Kh), compact=ck(op._compact))
    if isinstance(op, EllOp):
        return EllOp(*(t(a) for a in op))
    return BandedOp(t(op.diags), op.offsets, op.m, op.n,
                    ell=None if op.ell is None else op_to(op.ell, device),
                    wide_rows=t(op.wide_rows), wide_w=t(op.wide_w),
                    compact=ck(op._compact))


def op_from_numpy(kind: str, leaves: dict, device=None):
    """``(op, dr, dc, eta)`` on ``device`` from numpy leaves: ``Kh`` for
    'dense'; ``diags``, ``offsets``, ``m``, ``n`` and optionally
    ``wide_p`` (or ``wide_rows``) and ``wide_w`` for 'banded'; plus the
    preconditioner ``dr``, ``dc`` and the step size ``eta`` — e.g. a JAX
    solver's op and scalings, to run both packages from one operator."""
    device = resolve_device(device)
    op = _build_op(kind, leaves, device)

    def f(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)
    return op, f(leaves["dr"]), f(leaves["dc"]), f(leaves["eta"])


def make_op(K_scaled, dense_bytes_limit: int = 32 * 1024 * 1024,
            dtype="float32", dense_col_factor: int = 16,
            max_bands: int = 48, device="cpu") -> MatOp:
    """Pick banded vs dense vs ELL for the (Ruiz-scaled) constraint matrix,
    exactly as the JAX package's ``make_op``: bands carrying at least
    ``max(256, m // 64)`` entries are extracted; banded is preferred even
    when dense fits if the decomposition is complete (no ELL residual, no
    dense-column block; wide rows allowed)."""
    m, n = K_scaled.shape
    dense_fits = m * n * np.dtype(dtype).itemsize <= dense_bytes_limit
    csc = K_scaled.tocsc()
    col_nnz = np.diff(csc.indptr)
    mean_nnz = max(col_nnz.mean(), 1.0)
    dense_cols = np.nonzero(col_nnz > dense_col_factor * mean_nnz)[0]
    if len(dense_cols):
        blk = np.asarray(csc[:, dense_cols].todense())
        sparse_part = K_scaled.tocsr(copy=True)
        sparse_part.data[np.isin(sparse_part.indices, dense_cols)] = 0.0
        sparse_part.eliminate_zeros()
    else:
        blk = np.zeros((m, 0))
        sparse_part = K_scaled.tocsr()

    coo = sparse_part.tocoo()
    offs = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq, counts = np.unique(offs, return_counts=True)
    band_min = max(256, m // 64)
    cand = uniq[counts >= band_min]
    if len(cand) > max_bands:
        order = np.argsort(counts[np.isin(uniq, cand)])[::-1]
        cand = cand[order[:max_bands]]
    on_band = np.isin(offs, cand)
    n_on_band = int(on_band.sum())
    coverage = n_on_band / max(len(offs), 1)
    resid_rows = np.unique(coo.row[~on_band]) if len(offs) else \
        np.empty(0, np.int64)
    r_wide = len(resid_rows)
    wide_ok = (not len(dense_cols) and 0 < r_wide <= WIDE_MAX_ROWS
               and r_wide * (n + m) * 8 <= WIDE_MAX_BYTES)
    banded_complete = (len(cand) > 0 and not len(dense_cols)
                       and (n_on_band == len(offs) or wide_ok))
    if (dense_fits and not banded_complete) \
            or len(cand) == 0 or coverage < 0.5:
        if dense_fits:
            return _build_op("dense", {"Kh": K_scaled.todense()}, device)
        return _build_op("ell", _ell_leaves(sparse_part, dense_cols, blk),
                         device)
    offsets = tuple(int(v) for v in cand)
    diags = np.zeros((len(offsets), m), np.float64)
    rows_b = coo.row[on_band]
    cand_sorted = np.argsort(cand)
    pos = cand_sorted[np.searchsorted(cand[cand_sorted], offs[on_band])]
    diags[pos, rows_b] = coo.data[on_band]
    resid_nnz = int((~on_band).sum())
    leaves = {"diags": diags, "offsets": offsets, "m": m, "n": n}
    if resid_nnz and wide_ok:
        ww = np.zeros((r_wide, n))
        row_pos = np.searchsorted(resid_rows, coo.row[~on_band])
        ww[row_pos, coo.col[~on_band]] = coo.data[~on_band]
        leaves.update(wide_rows=resid_rows, wide_w=ww)
    elif resid_nnz or len(dense_cols):
        resid = sp.coo_matrix(
            (coo.data[~on_band], (coo.row[~on_band], coo.col[~on_band])),
            shape=(m, n)).tocsr()
        leaves["ell"] = _ell_leaves(resid, dense_cols, blk)
    return _build_op("banded", leaves, device)


def op_matvec(op: MatOp, x: torch.Tensor) -> torch.Tensor:
    """K @ x for a (B, n) batch -> (B, m) (scaled space)."""
    if isinstance(op, DenseOp):
        return x @ op.Kh.T
    if isinstance(op, BandedOp):
        out = fused_chunk.banded_matvec(op.diags, op.offsets, op.wide_rows,
                                        op.wide_w, x, op.n)
        if op.ell is not None:
            out = out + op_matvec(op.ell, x)
        return out
    out = (op.data * x[:, op.cols]).sum(-1)
    if op.dense_blk.shape[1]:
        out = out + x[:, op.dense_idx] @ op.dense_blk.T
    return out


def op_rmatvec(op: MatOp, y: torch.Tensor) -> torch.Tensor:
    """K.T @ y for a (B, m) batch -> (B, n) (scaled space)."""
    if isinstance(op, DenseOp):
        return y @ op.Kh
    if isinstance(op, BandedOp):
        out = fused_chunk.banded_rmatvec(op.diags, op.offsets, op.wide_rows,
                                         op.wide_w, y, op.n)
        if op.ell is not None:
            out = out + op_rmatvec(op.ell, y)
        return out
    out = (op.data_t * y[:, op.cols_t]).sum(-1)
    if op.dense_blk.shape[1]:
        out = out.index_add(1, op.dense_idx, y @ op.dense_blk)
    return out


# ---------------------------------------------------------------------------
# Options / results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PDHGOptions:
    """The JAX package's options with identical defaults (see its field
    notes).  Dropped: ``pallas_chunk`` (the chunk kernels run whenever
    ``fused_chunk.supports`` takes the op; there is no switch that sends
    card tensors down the plain path), ``precision`` (every product here
    is true fp32, see ``device.py``) and ``chunk_iters`` (it sized the JAX
    single-instance driver; every solve here is batched and uses
    ``compact_chunk_iters``).  ``dtype`` is a numpy dtype name."""
    eps_abs: float = 1e-6
    eps_rel: float = 1e-4
    max_iters: int = 400_000
    check_every: int = 128
    check_every_min: int = 32
    variant: str = VARIANT_REFLECTED
    reflection_coeff: float = 1.8
    restart_scheme: str = RESTART_AUTO
    fp_beta_sufficient: float = 0.5
    halpern_coeff: Optional[float] = 2.0
    beta_sufficient: float = 0.2
    beta_necessary: float = 0.8
    artificial_restart_frac: float = 0.36
    primal_weight_smoothing: float = 0.5
    power_iters: int = 40
    ruiz_iters: int = 10
    step_size_safety: float = 0.99
    infeas_checks: int = 4
    eps_infeas: float = 1e-6
    inaccurate_factor: float = 10.0
    dense_bytes_limit: int = 32 * 1024 * 1024
    cpu_rescue_after: Optional[int] = 65536
    cpu_rescue_max: int = 64
    compact_chunk_iters: int = 4096
    dtype: str = "float32"

    @classmethod
    def screening(cls, base: Optional["PDHGOptions"] = None,
                  max_iters: int = 4096) -> "PDHGOptions":
        """The BOOST-style low-fidelity screening tier (PAPERS.md:
        arxiv 2501.10842): loose tolerances + a short, hard iteration
        budget.  Used by the design screen and the Monte-Carlo sample
        mass — a screening solution ranks candidates but is NEVER
        certified; callers must mark results degraded and route
        anything decision-grade back through the full tier.  The relaxed
        ``inaccurate_factor`` accepts whatever the budget reached — a
        screening solve exits with its best iterate and an honest
        residual instead of climbing the escalation ladder."""
        base = base if base is not None else cls()
        return dataclasses.replace(
            base, eps_rel=1e-2, eps_abs=1e-3,
            max_iters=int(max_iters),
            inaccurate_factor=1e6,
            # screening batches are throwaway: never bill CPU rescues
            cpu_rescue_after=None)


class PDHGResult(NamedTuple):
    x: torch.Tensor          # (B, n) unscaled primal solution
    y: torch.Tensor          # (B, m) unscaled dual solution
    obj: torch.Tensor        # (B,)   primal objective c@x
    converged: torch.Tensor  # (B,)   bool
    iters: torch.Tensor      # (B,)   iterations used
    prim_res: torch.Tensor   # (B,)   final primal residual
    gap: torch.Tensor        # (B,)   final |primal-dual| gap
    status: torch.Tensor     # (B,)   int32 STATUS_* code
    restarts: torch.Tensor   # (B,)   int32 adaptive restarts taken


@dataclasses.dataclass
class SolveStats:
    """Per-``solve()`` device-traffic accounting (the solve-ledger raw
    material).  ``readbacks`` counts every status read of the solve: one
    after each check window and one as each chunk starts, so windows
    plus chunks; ``sync_wait_s`` is the time blocked in them, which
    includes waiting for the enqueued device work.  ``check_windows``
    counts check windows; on a CUDA device each is a ``graph_replays``
    of one of the ``graph_captures`` graphs, whose captures took
    ``capture_s`` of host time (a thread's first for the solver after
    one eager warm-up window of one sub-block on the capture stream).
    ``kernel_launches`` counts the chunk-kernel launches of this solve,
    replayed ones and the warm-ups' ``warmup_launches`` included."""
    dispatches: int = 0
    chunks: int = 0
    compile_events: int = 0      # first execution of a (program, shape)
    h2d_transfers: int = 0
    h2d_bytes: int = 0
    h2d_s: float = 0.0
    readbacks: int = 0
    sync_wait_s: float = 0.0
    result_fetch_s: float = 0.0
    result_bytes: int = 0
    cpu_rescued: int = 0
    compact_events: int = 0
    bucket_occupancy: list = dataclasses.field(default_factory=list)
    cadence_final: int = 0
    restart_scheme: str = ""
    kernel_launches: int = 0
    check_windows: int = 0
    graph_captures: int = 0
    graph_replays: int = 0
    capture_s: float = 0.0
    warmup_launches: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("h2d_s", "sync_wait_s", "result_fetch_s", "capture_s"):
            d[k] = round(d[k], 4)
        d["bucket_occupancy"] = [list(b) for b in d["bucket_occupancy"]]
        return d


def compaction_bucket(n_active: int) -> int:
    """The active-set compaction grid {8, 32, 128, 512, ...}: the
    smallest bucket that holds ``n_active`` instances."""
    b = 8
    while b < n_active:
        b <<= 2
    return b


def compaction_buckets(B: int) -> tuple:
    """Every bucket a solve of ``B`` instances can compact its active set
    to: the grid's buckets of at most half the batch."""
    out, b = [], 8
    while b <= B // 2:
        out.append(b)
        b <<= 2
    return tuple(out)


def to_host(t) -> np.ndarray:
    """A tensor (any device) or array as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def fetch_result_host(res: PDHGResult,
                      stats: Optional[SolveStats] = None,
                      want_y: bool = False) -> tuple:
    """``(x, obj, converged, iters, prim_res, gap, status, restarts)`` as
    numpy (``y`` appended when ``want_y``), after one device sync."""
    t0 = time.perf_counter()
    fields = (res.x, res.obj, res.converged, res.iters,
              res.prim_res, res.gap, res.status, res.restarts)
    if want_y:
        fields = fields + (res.y,)
    host = tuple(to_host(a) for a in fields)
    if stats is not None:
        stats.result_fetch_s += time.perf_counter() - t0
        stats.result_bytes += sum(a.nbytes for a in host)
    return host


_INT_FIELDS = ("inner", "total", "iters_at_conv", "infeas_streak",
               "restarts", "cadence")
_BOOL_FIELDS = ("converged", "infeasible")


@dataclasses.dataclass
class _State:
    """Batched solver state; every field has the batch as its first axis."""
    x: torch.Tensor
    y: torch.Tensor
    x_sum: torch.Tensor
    y_sum: torch.Tensor
    inner: torch.Tensor        # iters since restart (int32)
    total: torch.Tensor        # total iters (int32)
    omega: torch.Tensor        # primal weight
    x_restart: torch.Tensor    # iterate at last restart
    y_restart: torch.Tensor
    mu_restart: torch.Tensor   # restart score at last restart
    mu_prev: torch.Tensor      # restart score at previous check
    converged: torch.Tensor
    done_x: torch.Tensor       # frozen solution once converged
    done_y: torch.Tensor
    iters_at_conv: torch.Tensor
    infeas_streak: torch.Tensor
    infeasible: torch.Tensor
    restarts: torch.Tensor
    cadence: torch.Tensor      # current check cadence (adaptive schedule)

    _fields = ("x", "y", "x_sum", "y_sum", "inner", "total", "omega",
               "x_restart", "y_restart", "mu_restart", "mu_prev",
               "converged", "done_x", "done_y", "iters_at_conv",
               "infeas_streak", "infeasible", "restarts", "cadence")

    def _replace(self, **kw) -> "_State":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "_State":
        return _State(**{f: fn(getattr(self, f)) for f in self._fields})


def state_from_numpy(fields: dict, device=None) -> _State:
    """A batched ``_State`` from numpy arrays keyed by field name — e.g.
    a JAX solver's state leaves, to run both packages from one state."""
    device = resolve_device(device)

    def conv(name, a):
        dt = (torch.int32 if name in _INT_FIELDS else
              torch.bool if name in _BOOL_FIELDS else torch.float32)
        return torch.tensor(np.asarray(a), dtype=dt, device=device)
    return _State(**{f: conv(f, fields[f]) for f in _State._fields})


def _where(mask, new: _State, old: _State,
           out: Optional[_State] = None) -> _State:
    """Field-wise select on the batch axis: ``new`` where ``mask``; into
    ``out``'s tensors when given (they may be ``old``'s own)."""
    res = {}
    for f in _State._fields:
        a, b = getattr(new, f), getattr(old, f)
        res[f] = torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b,
                             out=None if out is None else getattr(out, f))
    return _State(**res)


def _index(s: _State, idx) -> _State:
    return s.map(lambda a: a[idx])


def _scatter(full: _State, sub: _State, idx) -> _State:
    """Write the sub-batch rows back into the full batch at ``idx``;
    repeated positions (bucket padding) carry identical rows."""
    out = {}
    for f in _State._fields:
        a = getattr(full, f).clone()
        a[idx] = getattr(sub, f)
        out[f] = a
    return _State(**out)


# ---------------------------------------------------------------------------
# Core solver on the scaled problem (batched)
# ---------------------------------------------------------------------------

def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


class LocalRows:
    """The row-space (m-dimension) reductions of :class:`_Solver`, as an
    unsharded solve computes them: ``grad`` takes K^T y, ``sum`` a sum
    over rows, ``norm`` a 2-norm over rows.  Every m-dimension reduction
    of the solve goes through one of the three.  A solve whose rows are
    split over ranks (``parallel/timeshard.py``) passes a subclass that
    completes each partial result across the ranks — the counterpart of
    the JAX package's ``_psum_if``/``_rnorm`` under ``axis=``."""

    def grad(self, g):
        return g

    def sum(self, v):
        return v.sum(-1)

    def norm(self, v):
        return _norm(v)


LOCAL_ROWS = LocalRows()


def _kkt_terms(op, x, y, c, q, l, u, eq_mask, dr, dc, rows=LOCAL_ROWS):
    """Residuals/objectives of the UNSCALED problem given scaled iterates
    (x_unscaled = dc * x, y_unscaled = dr * y); each (B,).  ``rows``
    takes the row-space reductions (:class:`LocalRows`)."""
    xu = dc * x
    yu = dr * y
    Kx = op_matvec(op, x) / dr
    KTy = rows.grad(op_rmatvec(op, y)) / dc
    r = q - Kx
    viol = torch.where(eq_mask, r.abs(), r.clamp_min(0.0))
    prim_res = rows.norm(viol)
    lam = c - KTy
    lam_pos = lam.clamp_min(0.0)
    lam_neg = lam.clamp_max(0.0)
    l_fin = torch.isfinite(l)
    u_fin = torch.isfinite(u)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dres_vec = torch.where(l_fin, zero, lam_pos) \
        + torch.where(u_fin, zero, -lam_neg)
    dual_res = _norm(dres_vec)
    pobj = (c * xu).sum(-1)
    dobj = rows.sum(q * yu) + (torch.where(l_fin, lam_pos * l, zero)
                               + torch.where(u_fin, lam_neg * u, zero)
                               ).sum(-1)
    gap = (pobj - dobj).abs()
    return prim_res, dual_res, gap, pobj, dobj


def _converged(prim_res, dual_res, gap, pobj, dobj, q_norm, c_norm,
               eps_abs, eps_rel):
    ok_p = prim_res <= eps_abs + eps_rel * q_norm
    ok_d = dual_res <= eps_abs + eps_rel * c_norm
    ok_g = gap <= eps_abs + eps_rel * (pobj.abs() + dobj.abs())
    return ok_p & ok_d & ok_g


def _farkas_gap(op, y, q, l, u, dr, dc, rows=LOCAL_ROWS):
    """Primal-infeasibility certificate quality of the dual direction
    ``y``: (gap, ray_violation, ||y_unscaled||), each (B,)."""
    yu = dr * y
    ynorm = rows.norm(yu)
    den = ynorm.clamp_min(1e-12)[:, None]
    yhat = yu / den
    KTy = rows.grad(op_rmatvec(op, y)) / dc / den
    pos = KTy.clamp_min(0.0)
    neg = KTy.clamp_max(0.0)
    l_fin = torch.isfinite(l)
    u_fin = torch.isfinite(u)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    ray_viol = (torch.where(u_fin, zero, pos)
                - torch.where(l_fin, zero, neg)).sum(-1)
    box_max = (torch.where(u_fin, pos * u, zero)
               + torch.where(l_fin, neg * l, zero)).sum(-1)
    gap = rows.sum(q * yhat) - box_max
    return gap, ray_viol, ynorm


class _Context(NamedTuple):
    eq_mask: torch.Tensor
    c_s: torch.Tensor
    q_s: torch.Tensor
    l_s: torch.Tensor
    u_s: torch.Tensor
    q_norm: torch.Tensor
    c_norm: torch.Tensor
    c_us: torch.Tensor
    q_us: torch.Tensor
    l_us: torch.Tensor
    u_us: torch.Tensor
    omega0: torch.Tensor
    omega_lo: torch.Tensor
    omega_hi: torch.Tensor


class _Solver:
    """The scaled-space solve pieces (``init_state``, ``run_chunk``,
    ``finalize``) for one (m, n, n_eq) structure and option set — the
    counterpart of the JAX package's ``_make_solver`` closure, batched.
    ``use_kernel`` routes the iteration chunks through the CUDA kernels
    (``fused_chunk.batched_chunk``); otherwise the plain chunk runs.

    ``rows`` (a :class:`LocalRows`) takes every row-space reduction.  Left
    unset, the solve is the unsharded one.  Set, ``m`` and ``n_eq`` are
    this rank's row block's (its equality rows come first, as in the whole
    LP) and the chunks run the plain version, whose K^T y goes through
    ``rows.grad``: the kernels keep K^T y inside the block."""

    def __init__(self, opts: "PDHGOptions", m: int, n: int, n_eq: int,
                 use_kernel: bool = True, rows: Optional[LocalRows] = None):
        self.opts = opts
        self.m, self.n, self.n_eq = m, n, n_eq
        self.variant = resolved_variant(opts)
        self.fp_scheme = resolved_restart_scheme(opts) == RESTART_FIXED_POINT
        alpha = float(opts.reflection_coeff)
        if self.variant == VARIANT_HALPERN and self.fp_scheme \
                and opts.halpern_coeff is not None:
            alpha = float(opts.halpern_coeff)
        self.alpha = alpha
        ce = int(opts.check_every)
        ce_min = int(opts.check_every_min)
        self.adaptive = 0 < ce_min < ce
        self.ce = ce
        self.sub = ce_min if self.adaptive else ce
        self.cadence_cap = (ce // self.sub) * self.sub
        self.use_kernel = use_kernel and rows is None
        self.rows = rows if rows is not None else LOCAL_ROWS
        self.launches = 0
        # threads that ran the warm-up before a graph capture of this
        # solver (_WindowRunner._capture)
        self.warm_threads: set = set()

    # -- pieces ---------------------------------------------------------
    def _context(self, c, q, l, u, dr, dc) -> _Context:
        eq_mask = torch.arange(self.m, device=c.device) < self.n_eq
        c_s = c * dc
        q_s = q * dr
        l_s = torch.where(torch.isfinite(l), l / dc, l)
        u_s = torch.where(torch.isfinite(u), u / dc, u)
        c2 = _norm(c_s)
        q2 = self.rows.norm(q_s)
        one = torch.ones((), dtype=c.dtype, device=c.device)
        omega0 = torch.where((c2 > 0) & (q2 > 0), c2 / q2.clamp_min(1e-12),
                             one)
        return _Context(eq_mask, c_s, q_s, l_s, u_s, self.rows.norm(q),
                        _norm(c), c, q, l, u, omega0, omega0 / 50.0,
                        omega0 * 50.0)

    def pdhg_step(self, op, t: _Context, omega, eta, x, y):
        """One application of the PDHG operator T (the vanilla update)."""
        tau = (eta / omega)[:, None]
        sigma = (eta * omega)[:, None]
        grad = self.rows.grad(op_rmatvec(op, y))
        x1 = torch.clamp(x - tau * (t.c_s - grad), t.l_s, t.u_s)
        y1 = y + sigma * (t.q_s - op_matvec(op, 2.0 * x1 - x))
        y1 = torch.where(t.eq_mask, y1, y1.clamp_min(0.0))
        return x1, y1

    def _chunk(self, op, t: _Context, omega, eta, x, y, xs, ys, k, ax, ay):
        """``sub`` iterations for the whole batch."""
        if self.use_kernel:
            out = fused_chunk.batched_chunk(
                op, t.c_s, t.q_s, t.l_s, t.u_s, omega, eta, x, y, xs, ys,
                self.n_eq, self.sub, variant=self.variant, alpha=self.alpha,
                k=k, ax=ax, ay=ay)
            # a launch under capture runs at the graph's replays, which
            # count it (_WindowRunner.step)
            if x.device.type == "cuda" \
                    and not torch.cuda.is_current_stream_capturing():
                self.launches += 1
            return out
        floor = fused_chunk.floor_of(self.m, self.n_eq, x.dtype, x.device)
        halp = self.variant == VARIANT_HALPERN
        return fused_chunk.plain_chunk(
            lambda v: op_matvec(op, v),
            lambda v: self.rows.grad(op_rmatvec(op, v)),
            t.c_s, t.q_s, t.l_s, t.u_s, (eta / omega), (eta * omega), floor,
            x, y, xs, ys, self.sub, self.variant, self.alpha,
            k.to(x.dtype) if halp else None, ax, ay)

    def advance(self, op, t: _Context, s: _State, eta, n_sub, n_max: int,
                uniform: bool):
        """Run up to ``n_max`` sub-blocks of ``sub`` iterations; instance
        i advances ``n_sub[i]`` of them (the rest of its rows are held),
        as the vmapped fori_loop with a batched trip count does.  The
        halpern anchor is the restart point and its inner count starts
        at ``s.inner`` — both fixed across the blocks of one window."""
        x, y, xs, ys, k = s.x, s.y, s.x_sum, s.y_sum, s.inner
        ax, ay = s.x_restart, s.y_restart
        for j in range(n_max):
            xo, yo, xso, yso = self._chunk(op, t, s.omega, eta, x, y, xs, ys,
                                           k, ax, ay)
            if uniform:
                x, y, xs, ys, k = xo, yo, xso, yso, k + self.sub
            else:
                go = j < n_sub
                g2 = go[:, None]
                x, y = torch.where(g2, xo, x), torch.where(g2, yo, y)
                xs, ys = torch.where(g2, xso, xs), torch.where(g2, yso, ys)
                k = torch.where(go, k + self.sub, k)
        return x, y, xs, ys

    def init_state(self, op, c, q, l, u, dr, dc, x0=None, y0=None) -> _State:
        """Initial batched state; ``x0``/``y0`` (UNSCALED warm-start seeds)
        are mapped into the scaled space, clipped into the box, the dual
        projected onto its cone, and become the restart anchors."""
        t = self._context(c, q, l, u, dr, dc)
        B, dev, dt = c.shape[0], c.device, c.dtype
        if x0 is None:
            x0 = torch.zeros(B, self.n, dtype=dt, device=dev)
        else:
            x0 = x0.to(dt) / dc
        x0 = torch.clamp(x0, t.l_s, t.u_s)
        if y0 is None:
            y0 = torch.zeros(B, self.m, dtype=dt, device=dev)
        else:
            y0 = y0.to(dt) / dr
            y0 = torch.where(t.eq_mask, y0, y0.clamp_min(0.0))
        big = torch.full((B,), torch.finfo(dt).max / 2, dtype=dt, device=dev)

        def iz(v=0):
            return torch.full((B,), v, dtype=torch.int32, device=dev)
        bfalse = torch.zeros(B, dtype=torch.bool, device=dev)
        return _State(
            x=x0, y=y0, x_sum=torch.zeros_like(x0),
            y_sum=torch.zeros_like(y0), inner=iz(), total=iz(),
            omega=t.omega0.clone(), x_restart=x0, y_restart=y0,
            mu_restart=big, mu_prev=big.clone(), converged=bfalse,
            done_x=x0, done_y=y0, iters_at_conv=iz(self.opts.max_iters),
            infeas_streak=iz(), infeasible=bfalse.clone(), restarts=iz(),
            cadence=iz(self.sub if self.adaptive else self.ce))

    def _n_sub(self, s: _State):
        if self.adaptive:
            return (s.cadence // self.sub).clamp_min(1)
        return torch.ones_like(s.cadence)

    def window(self, op, t: _Context, s: _State, eta, dr, dc, limit,
               n_max: int, out: Optional[_State] = None) -> _State:
        """One check window as a function of device tensors that reads
        nothing back (the body of the JAX package's chunk ``while_loop``):
        the instances active under ``limit`` (a device int32 scalar)
        advance a static ``n_max`` sub-blocks, each instance its own
        ``n_sub`` of them, then take the restart, primal-weight and
        convergence update; the others keep their state.  ``out``: write
        the new state into these tensors (``s``'s own steps in place)."""
        active = ~s.converged & ~s.infeasible & (s.total < limit)
        return _where(active, self._body(op, t, s, eta, dr, dc,
                                         self._n_sub(s), n_max, False), s,
                      out)

    def status(self, s: _State, limit) -> torch.Tensor:
        """What the host reads after each window, as one int32 device
        tensor: the instances active under ``limit``, the largest
        sub-block count among them, the largest total, the unfinished
        (neither converged nor infeasible) count, the largest cadence,
        then the (B,) unfinished mask (:class:`_StatusRead`)."""
        unfinished = ~(s.converged | s.infeasible)
        active = unfinished & (s.total < limit)
        head = torch.stack([
            active.sum(dtype=torch.int32),
            torch.where(active, self._n_sub(s), 0).max(),
            s.total.max(), unfinished.sum(dtype=torch.int32),
            s.cadence.max()])
        return torch.cat([head, unfinished.to(torch.int32)])

    def run_chunk(self, op, c, q, l, u, dr, dc, eta, state: _State,
                  limit: int) -> _State:
        """The eager window loop: advance every instance until it
        converges, certifies infeasibility, or reaches ``limit`` total
        iterations; each check window's update lands only on the
        instances still active.  Functional (a new state each window,
        the uniform sub-block form where every active instance runs
        ``n_max``); the row-sharded solve runs it, and the tests hold the
        graph runner against it."""
        t = self._context(c, q, l, u, dr, dc)
        s = state
        while True:
            active = ~s.converged & ~s.infeasible & (s.total < limit)
            n_sub = self._n_sub(s)
            ns_act = torch.where(active, n_sub, torch.zeros_like(n_sub))
            ns_min = torch.where(active, n_sub, torch.full_like(n_sub, 1 << 30))
            n_act, n_max, n_min = (int(v) for v in torch.stack(
                [active.sum(dtype=torch.int32), ns_act.max(),
                 ns_min.min()]).tolist())
            if n_act == 0:
                return s
            s = _where(active, self._body(op, t, s, eta, dr, dc, n_sub,
                                          n_max, n_max == n_min), s)

    def _mu(self, op, t: _Context, x, y, dr, dc):
        pr, du, gp, po, do = _kkt_terms(op, x, y, t.c_us, t.q_us, t.l_us,
                                        t.u_us, t.eq_mask, dr, dc, self.rows)
        denom = 1.0 + po.abs() + do.abs()
        mu = torch.sqrt(pr * pr + du * du + (gp / denom) ** 2)
        return mu, (pr, du, gp, po, do)

    def _body(self, op, t: _Context, s: _State, eta, dr, dc, n_sub, n_max,
              uniform):
        o = self.opts
        adv = (n_sub * self.sub) if self.adaptive \
            else torch.full_like(n_sub, self.ce)
        x, y, x_sum, y_sum = self.advance(op, t, s, eta, n_sub, n_max,
                                          uniform)
        inner = s.inner + adv
        total = s.total + adv
        fin = inner.to(x.dtype)[:, None]
        x_avg = x_sum / fin
        y_avg = y_sum / fin
        mu_cur, cur_terms = self._mu(op, t, x, y, dr, dc)
        mu_avg, avg_terms = self._mu(op, t, x_avg, y_avg, dr, dc)
        use_avg = mu_avg < mu_cur
        ua2 = use_avg[:, None]
        x_cand = torch.where(ua2, x_avg, x)
        y_cand = torch.where(ua2, y_avg, y)
        mu_cand = torch.minimum(mu_avg, mu_cur)
        pr, du, gp, po, do = (torch.where(use_avg, a, b)
                              for a, b in zip(avg_terms, cur_terms))
        conv_now = _converged(pr, du, gp, po, do, t.q_norm, t.c_norm,
                              o.eps_abs, o.eps_rel)
        fk_gap, fk_viol, ynorm = _farkas_gap(op, y, t.q_us, t.l_us, t.u_us,
                                             dr, dc, self.rows)
        scale_ref = 1.0 + t.q_norm
        cert = ((fk_gap > o.eps_infeas * scale_ref)
                & (fk_viol <= o.eps_infeas * scale_ref)
                & (ynorm > 1.0) & ~conv_now)
        streak = torch.where(cert, s.infeas_streak + 1,
                             torch.zeros_like(s.infeas_streak))
        infeasible = streak >= o.infeas_checks
        artificial = (inner.to(x.dtype)
                      >= o.artificial_restart_frac * total.to(x.dtype))
        if self.fp_scheme:
            # Halpern-native criterion: the fixed-point residual of the
            # current iterate; restart TO the current iterate
            xT, yT = self.pdhg_step(op, t, s.omega, eta, x, y)
            fp_res = torch.sqrt(((xT - x) ** 2).sum(-1)
                                + self.rows.sum((yT - y) ** 2))
            do_restart = ((fp_res <= o.fp_beta_sufficient * s.mu_restart)
                          | ((fp_res <= o.beta_necessary * s.mu_restart)
                             & (fp_res > s.mu_prev))
                          | artificial)
            restart_x, restart_y, mu_track = x, y, fp_res
        else:
            do_restart = ((mu_cand <= o.beta_sufficient * s.mu_restart)
                          | ((mu_cand <= o.beta_necessary * s.mu_restart)
                             & (mu_cand > s.mu_prev))
                          | artificial)
            restart_x, restart_y, mu_track = x_cand, y_cand, mu_cand
        dx = _norm(restart_x - s.x_restart)
        dy = self.rows.norm(restart_y - s.y_restart)
        theta = o.primal_weight_smoothing
        new_omega = torch.where(
            (dx > 1e-10) & (dy > 1e-10),
            torch.exp(theta * torch.log(dy / dx)
                      + (1 - theta) * torch.log(s.omega)),
            s.omega)
        new_omega = torch.clamp(new_omega, t.omega_lo, t.omega_hi)
        dr2 = do_restart[:, None]
        newly = conv_now & ~s.converged
        nw2 = newly[:, None]
        return _State(
            x=torch.where(dr2, restart_x, x),
            y=torch.where(dr2, restart_y, y),
            x_sum=torch.where(dr2, torch.zeros_like(x_sum), x_sum),
            y_sum=torch.where(dr2, torch.zeros_like(y_sum), y_sum),
            inner=torch.where(do_restart, torch.zeros_like(inner), inner),
            total=total,
            omega=torch.where(do_restart, new_omega, s.omega),
            x_restart=torch.where(dr2, restart_x, s.x_restart),
            y_restart=torch.where(dr2, restart_y, s.y_restart),
            mu_restart=torch.where(do_restart, mu_track, s.mu_restart),
            mu_prev=mu_track,
            converged=s.converged | conv_now,
            done_x=torch.where(nw2, x_cand, s.done_x),
            done_y=torch.where(nw2, y_cand, s.done_y),
            iters_at_conv=torch.where(newly, total, s.iters_at_conv),
            infeas_streak=streak,
            infeasible=infeasible,
            restarts=s.restarts + do_restart.to(torch.int32),
            cadence=(torch.clamp_max(s.cadence * 2, self.cadence_cap)
                     if self.adaptive else s.cadence))

    def finalize(self, op, c, q, l, u, dr, dc, final: _State) -> PDHGResult:
        t = self._context(c, q, l, u, dr, dc)
        cv = final.converged[:, None]
        x_out = torch.where(cv, final.done_x, final.x)
        y_out = torch.where(cv, final.done_y, final.y)
        pr, du, gp, po, do = _kkt_terms(op, x_out, y_out, t.c_us, t.q_us,
                                        t.l_us, t.u_us, t.eq_mask, dr, dc,
                                        self.rows)
        f = self.opts.inaccurate_factor
        near = _converged(pr, du, gp, po, do, t.q_norm, t.c_norm,
                          self.opts.eps_abs * f, self.opts.eps_rel * f)

        def code(v):
            return torch.full_like(final.total, v)
        status = torch.where(
            final.converged, code(STATUS_CONVERGED),
            torch.where(final.infeasible, code(STATUS_PRIMAL_INFEASIBLE),
                        torch.where(near, code(STATUS_INACCURATE),
                                    code(STATUS_ITER_LIMIT))))
        return PDHGResult(
            x=x_out * dc, y=y_out * dr, obj=po, converged=final.converged,
            iters=torch.where(final.converged, final.iters_at_conv,
                              final.total),
            prim_res=pr, gap=gp, status=status, restarts=final.restarts)


# ---------------------------------------------------------------------------
# The compiled chunk program: check windows over static buffers
# ---------------------------------------------------------------------------

class _StatusRead(NamedTuple):
    """One host read of :meth:`_Solver.status`."""
    n_act: int
    n_max: int
    total: int
    n_unfinished: int
    cadence: int
    unfinished: np.ndarray     # (B,) bool


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    launches: dict       # {(kernel, m, n, batch): launches a replay makes}


# the counters of a solve that the window loop keeps, summed over every
# solve of the process in DRIVER_COUNTS (chip_smoke.py reads them by
# phase); the split batch, the solve ledger and its request slices carry
# the same fields
DRIVER_FIELDS = ("chunks", "check_windows", "graph_replays",
                  "graph_captures", "capture_s", "readbacks", "sync_wait_s",
                  "warmup_launches")
DRIVER_COUNTS = {k: 0 for k in DRIVER_FIELDS}
_driver_lock = threading.Lock()


_capture_streams: dict = {}
_capture_lock = threading.Lock()


def _capture_stream(device) -> "torch.cuda.Stream":
    """The stream graph captures on ``device`` run on (one a device,
    under ``_capture_lock``), drawn once from PyTorch's high-priority
    stream pool, which nothing else of the package draws from, so no
    other thread's work lands on it.  One stream, not one a thread:
    each (cuBLAS handle, stream) pair a capture's warm-up meets keeps a
    workspace (32 MiB on an H100) for the life of the process."""
    st = _capture_streams.get(device)
    if st is None:
        st = _capture_streams[device] = torch.cuda.Stream(device=device,
                                                          priority=-1)
    return st


def _into(buf, new: torch.Tensor) -> torch.Tensor:
    """``new`` copied into the buffer ``buf`` (a new one when None)."""
    if buf is None:
        return torch.empty(new.shape, dtype=new.dtype,
                           device=new.device).copy_(new)
    if buf is not new:
        buf.copy_(new)
    return buf


class _WindowRunner:
    """The compiled chunk program of one solver at one batch width: the
    check window's inputs (``c, q, l, u, dr, dc, eta``), its context, the
    chunk's iteration ``limit``, every state field and the status in
    static buffers, stepped in place.  With a graph ``pool`` (CUDA) each
    window replays the ``torch.cuda.CUDAGraph`` captured at the first
    window of its ``n_max`` (at most log2(cadence cap / sub) + 1 graphs);
    without one the window function runs eagerly on the buffers.  Each
    window ends by writing the new state and status into the buffers, so
    replays chain.  The buffers are allocated at the first ``load``."""

    def __init__(self, sv: _Solver, op, dr, dc, eta, pool=None):
        self.sv, self.op, self.pool = sv, op, pool
        self.dr, self.dc, self.eta = (a.clone() for a in (dr, dc, eta))
        self.limit = torch.zeros((), dtype=torch.int32, device=dr.device)
        self.inputs = (None,) * 4
        self.ctx = self.state = self.status = None
        self.graphs: dict = {}
        # recorded where the last driver's reads of the buffers were
        # enqueued (release); the next load waits on it
        self.free = None

    def load(self, c, q, l, u, state: _State, limit: int) -> None:
        """Copy a chunk's inputs and state into the buffers, rebuild the
        context there, set the limit and compute the first status."""
        sv = self.sv
        if self.free is not None:
            torch.cuda.current_stream(self.limit.device).wait_event(self.free)
        self.inputs = tuple(map(_into, self.inputs, (c, q, l, u)))
        ctx = sv._context(*self.inputs, self.dr, self.dc)
        # the first context becomes the buffers (its unscaled c, q, l, u
        # are the input buffers themselves)
        self.ctx = ctx if self.ctx is None else _Context(*map(_into,
                                                              self.ctx, ctx))
        self.state = _State(**{
            f: _into(None if self.state is None else getattr(self.state, f),
                     getattr(state, f)) for f in _State._fields})
        self.limit.fill_(limit)
        st = sv.status(self.state, self.limit)
        self.status = st if self.status is None else _into(self.status, st)

    def release(self) -> None:
        if self.pool is not None:
            self.free = torch.cuda.Event()
            self.free.record(torch.cuda.current_stream(self.limit.device))

    def _window(self, n_max: int) -> None:
        sv = self.sv
        sv.window(self.op, self.ctx, self.state, self.eta, self.dr, self.dc,
                  self.limit, n_max, out=self.state)
        self.status.copy_(sv.status(self.state, self.limit))

    def read(self, stats: SolveStats) -> _StatusRead:
        t0 = time.perf_counter()
        v = self.status.cpu().numpy()
        out = _StatusRead(*(int(a) for a in v[:5]), v[5:] != 0)
        stats.readbacks += 1
        stats.sync_wait_s += time.perf_counter() - t0
        return out

    def step(self, n_max: int, stats: SolveStats) -> None:
        """One check window of ``n_max`` sub-blocks on the buffers."""
        stats.check_windows += 1
        if self.pool is None:
            self._window(n_max)
            return
        g = self.graphs.get(n_max)
        if g is None:
            g = self.graphs[n_max] = self._capture(n_max, stats)
        g.graph.replay()
        stats.graph_replays += 1
        if g.launches:
            fused_chunk.add_launches(g.launches)
            self.sv.launches += sum(g.launches.values())

    def _capture(self, n_max: int, stats: SolveStats) -> _Graph:
        """Capture the window of ``n_max`` sub-blocks on the device's
        capture stream, in the solver's pool; one capture at a time.
        Before this thread's first capture for the solver, one eager
        window of one sub-block runs on that stream, its result dropped:
        it loads the kernel library, sets the solver's kernel's shared
        memory and gives this thread's cuBLAS handle a workspace on the
        stream, none of which may happen under capture (and none of
        which depends on the batch width).  The capture is thread-local,
        since other threads launch work on the card meanwhile; a failure
        raises.  ``capture_s`` is host time, the wait for the lock
        included."""
        t0 = time.perf_counter()
        dev = self.status.device
        cur = torch.cuda.current_stream(dev)
        launches0 = self.sv.launches
        with _capture_lock:
            side = _capture_stream(dev)
            side.wait_stream(cur)
            with torch.cuda.device(dev), torch.cuda.stream(side):
                if threading.get_ident() not in self.sv.warm_threads:
                    self.sv.window(self.op, self.ctx, self.state, self.eta,
                                   self.dr, self.dc, self.limit, 1)
                    self.sv.warm_threads.add(threading.get_ident())
                graph = torch.cuda.CUDAGraph()
                with fused_chunk.recording() as tally:
                    graph.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        self._window(n_max)
                    finally:
                        graph.capture_end()
            cur.wait_stream(side)
        stats.warmup_launches += self.sv.launches - launches0
        stats.graph_captures += 1
        stats.capture_s += time.perf_counter() - t0
        return _Graph(graph, dict(tally))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

KERNEL_BANDED = fused_chunk.KERNEL_BANDED
KERNEL_DENSE = fused_chunk.KERNEL_DENSE
KERNEL_PLAIN = "torch_plain"

# Machine-stable reasons a group ran the plain chunk (the ledger's
# per-group record and its aggregation key on exactly these values)
FALLBACK_BACKEND = "backend"
FALLBACK_UNSUPPORTED_SHAPE = "unsupported_shape"
KERNEL_FALLBACK_REASONS = (FALLBACK_BACKEND, FALLBACK_UNSUPPORTED_SHAPE)


def step_size(Kh_sp, opts: PDHGOptions) -> np.float32:
    """The PDHG step ``safety / ||Kh||_2`` of the scaled operator, the
    norm from a power iteration on the host (scipy, float64) with the
    JAX package's seed and count."""
    v = np.random.default_rng(0).standard_normal(Kh_sp.shape[1])
    v /= np.linalg.norm(v)
    sigma_sq = 1e-24
    for _ in range(opts.power_iters):
        w = Kh_sp.T @ (Kh_sp @ v)
        sigma_sq = float(np.linalg.norm(w))
        v = w / max(sigma_sq, 1e-30)
    sigma_max = float(np.sqrt(sigma_sq))
    return np.float32(opts.step_size_safety / max(sigma_max, 1e-12))


def kernel_selection(solver: "CompiledLPSolver"
                     ) -> tuple[str, Optional[str], Optional[str]]:
    """``(kernel, reason, detail)`` for the chunks this solver runs:
    the kernel that takes its op, or ``torch_plain`` with a reason from
    ``KERNEL_FALLBACK_REASONS``.  On a CPU device the wrapper runs the
    kernel's plain version, recorded as the ``backend`` reason."""
    v = solver.variant
    if not fused_chunk.supports(solver.op, v):
        return (KERNEL_PLAIN, FALLBACK_UNSUPPORTED_SHAPE,
                f"op shape unsupported by the chunk kernels under "
                f"variant {v!r}")
    if solver.device.type != "cuda":
        return (KERNEL_PLAIN, FALLBACK_BACKEND,
                f"device {solver.device} runs the kernel's plain version")
    return fused_chunk.kernel_for(solver.op), None, None


class CompiledLPSolver:
    """Preconditions an LP structure once, then solves batches of instances
    on ``device`` (``None`` -> ``cuda:0``; pass ``"cpu"`` explicitly).

    ``K`` is fixed; ``c, q, l, u`` may carry a leading batch dimension.
    Every solve runs batched: 1-D inputs solve as a batch of one and come
    back 1-D.

    The check windows run on a :class:`_WindowRunner` a batch width, kept
    across solves with their graphs (one graph pool a solver; its solves
    never overlap).  On a CUDA device each window replays a CUDA graph;
    on the CPU it runs eagerly.  The eager window loop on the card is
    :meth:`_Solver.run_chunk`, which the checks hold the graphs
    against."""

    def __init__(self, lp: LP, opts: Optional[PDHGOptions] = None,
                 device=None):
        _t = time.perf_counter
        phases: dict[str, float] = {}
        t0 = _t()
        self.opts = opts or PDHGOptions()
        self.lp = lp
        self.device = resolve_device(device)
        d_r, d_c = ruiz_scaling(lp.K, self.opts.ruiz_iters)
        phases["ruiz_s"] = _t() - t0
        t0 = _t()
        Kh_sp = lp.K.multiply(d_r[:, None]).multiply(d_c[None, :]).tocsr()
        self.op = make_op(Kh_sp, self.opts.dense_bytes_limit, self.opts.dtype,
                          device=self.device)
        phases["op_build_s"] = _t() - t0
        t0 = _t()
        eta = step_size(Kh_sp, self.opts)
        phases["power_iter_s"] = _t() - t0
        t0 = _t()
        dt = getattr(torch, np.dtype(self.opts.dtype).name)
        self.dr = torch.as_tensor(d_r, dtype=dt, device=self.device)
        self.dc = torch.as_tensor(d_c, dtype=dt, device=self.device)
        self.eta = torch.as_tensor(eta, dtype=dt, device=self.device)
        self._make_solver()
        phases["transfer_s"] = _t() - t0
        self.precondition_breakdown = {k: round(v, 4)
                                       for k, v in phases.items()}
        self._solve_lock = threading.Lock()
        self.last_stats: Optional[SolveStats] = None
        self._exec_shapes: set = set()

    def _make_solver(self) -> None:
        # the variant/scheme captured at build time: a live env flip only
        # reaches rebuilt solvers, and observables report what this one runs
        self.variant = resolved_variant(self.opts)
        self.restart_scheme = resolved_restart_scheme(self.opts)
        self._solver = _Solver(
            self.opts, self.lp.m, self.lp.n, self.lp.n_eq,
            use_kernel=fused_chunk.supports(self.op, self.variant))
        self._runners: dict = {}
        self._graph_pool = None
        self._shard_clones: dict = {}

    def _note_exec(self, program: str, shape, stats) -> None:
        key = (program, tuple(shape))
        if key not in self._exec_shapes:
            self._exec_shapes.add(key)
            if stats is not None:
                stats.compile_events += 1

    def with_options(self, opts: PDHGOptions) -> "CompiledLPSolver":
        """Clone sharing this solver's preconditioning under different
        runtime options (the escalation ladder's boosted retry)."""
        for field in ("dtype", "dense_bytes_limit", "ruiz_iters",
                      "power_iters", "step_size_safety"):
            if getattr(opts, field) != getattr(self.opts, field):
                raise ValueError(
                    f"with_options cannot change {field!r} — it is baked "
                    "into the preconditioned operator; build a fresh "
                    "CompiledLPSolver instead")
        clone = object.__new__(CompiledLPSolver)
        clone.opts = opts
        clone.lp = self.lp
        clone.device = self.device
        clone.op, clone.dr, clone.dc, clone.eta = (self.op, self.dr,
                                                   self.dc, self.eta)
        clone.precondition_breakdown = dict(self.precondition_breakdown)
        clone._make_solver()
        clone._solve_lock = threading.Lock()
        clone.last_stats = None
        clone._exec_shapes = set()
        return clone

    def to_device(self, device) -> "CompiledLPSolver":
        """This solver on ``device``, sharing its preconditioning (no Ruiz
        pass, no power iteration): on another device the op, ``dr``,
        ``dc`` and ``eta`` are copied there; on the same device the clone
        shares them.  Either way it has its own solve lock, so two
        threads can solve on the pair at once."""
        device = resolve_device(device)
        clone = self.with_options(self.opts)
        if device != self.device:
            clone.device = device
            clone.op = op_to(self.op, device)
            clone.dr, clone.dc, clone.eta = (a.to(device) for a in
                                             (self.dr, self.dc, self.eta))
        return clone

    def shard(self, i: int, device) -> "CompiledLPSolver":
        """The clone on ``device`` that solves shard ``i`` of a split
        batch (``parallel.mesh``), kept across calls with its graphs."""
        device = resolve_device(device)
        key = (i, device)
        clone = self._shard_clones.get(key)
        if clone is None:
            clone = self._shard_clones[key] = self.to_device(device)
        return clone

    def _to_device(self, arrs, stats: Optional[SolveStats]):
        """Host arrays -> device tensors (pinned, non-blocking on the
        GPU); tensors already on the device pass through."""
        dt = getattr(torch, np.dtype(self.opts.dtype).name)
        out = []
        t0 = time.perf_counter()
        for a in arrs:
            if isinstance(a, torch.Tensor):
                out.append(a.to(self.device, dt))
                continue
            h = torch.from_numpy(np.ascontiguousarray(
                a, np.dtype(self.opts.dtype)))
            if self.device.type == "cuda":
                h = h.pin_memory()
            out.append(h.to(self.device, non_blocking=True))
            if stats is not None:
                stats.h2d_transfers += 1
                stats.h2d_bytes += h.numel() * h.element_size()
        if stats is not None:
            stats.h2d_s += time.perf_counter() - t0
        return out

    def solve(self, c=None, q=None, l=None, u=None,
              stats: Optional[SolveStats] = None,
              x0=None, y0=None) -> PDHGResult:
        lp = self.lp
        # per-instance bounds that WIDEN the build-time box while q
        # defaults would break the builder's presolve rhs clamp
        if q is None and (l is not None or u is not None):
            tol = 1e-9
            if l is not None and not np.all(to_host(l) >= lp.l - tol):
                raise ValueError(
                    "per-instance lower bounds extend below the build-time "
                    "box while q defaults — the presolve rhs clamp is no "
                    "longer exact; rebuild the LP with the wider box or "
                    "pass q explicitly")
            if u is not None and not np.all(to_host(u) <= lp.u + tol):
                raise ValueError(
                    "per-instance upper bounds extend above the build-time "
                    "box while q defaults — the presolve rhs clamp is no "
                    "longer exact; rebuild the LP with the wider box or "
                    "pass q explicitly")
        stats = stats if stats is not None else SolveStats()
        arrs = [lp.c if c is None else c, lp.q if q is None else q,
                lp.l if l is None else l, lp.u if u is None else u]
        if x0 is None and y0 is not None:
            raise ValueError("warm start needs x0 when y0 is given")
        if x0 is not None and y0 is None:
            y0 = np.zeros(np.shape(x0)[:-1] + (lp.m,))
        seeded = x0 is not None
        if seeded:
            arrs += [x0, y0]
        arrs = self._to_device(arrs, stats)
        if any(a.dim() not in (1, 2) for a in arrs):
            raise ValueError("solve() inputs must be 1-D (shared) or 2-D "
                             "(batched)")
        sizes = {a.shape[0] for a in arrs if a.dim() == 2}
        if len(sizes) > 1:
            raise ValueError(
                f"inconsistent batch sizes in solve(): {sorted(sizes)}")
        single = not sizes
        B = 1 if single else sizes.pop()
        widths = (lp.n, lp.m, lp.n, lp.n, lp.n, lp.m)
        arrs = [a.expand(B, w) if a.dim() == 1 else a
                for a, w in zip(arrs, widths)]
        c, q, l, u = arrs[:4]
        x0, y0 = arrs[4:] if seeded else (None, None)
        res = self._drive(c, q, l, u, stats, x0, y0)
        if single:
            res = PDHGResult(*(f[0] for f in res))
        return res

    def _drive(self, c, q, l, u, stats, x0=None, y0=None) -> PDHGResult:
        """Host-chunked batched driver with ACTIVE-SET COMPACTION between
        chunks: once most of the batch is done, the survivors gather into
        a 4x-step bucket ({8, 32, 128, ...}) and only those iterate on;
        results scatter back before finalizing on the full batch."""
        with self._solve_lock:
            self.last_stats = stats
            sv = self._solver
            stats.restart_scheme = self.restart_scheme
            launches0 = sv.launches
            args = (self.op, c, q, l, u, self.dr, self.dc)
            self._note_exec("init_seeded" if x0 is not None else "init",
                            c.shape, stats)
            state = sv.init_state(*args, x0=x0, y0=y0)
            stats.dispatches += 1
            B = c.shape[0]
            max_iters = self.opts.max_iters
            idx = np.arange(B)
            cur = (c, q, l, u)
            cur_state = state
            full_state = state
            total = 0
            rescue_after = self.opts.cpu_rescue_after
            while True:
                limit = min(total + self.opts.compact_chunk_iters, max_iters)
                self._note_exec("chunk", cur[0].shape, stats)
                cur_state, st = self.run_chunk(cur, cur_state, limit, stats)
                total, n_active = st.total, st.n_unfinished
                stats.dispatches += 2
                stats.cadence_final = st.cadence
                if n_active == 0 or total >= max_iters:
                    break
                if rescue_after is not None and total >= rescue_after:
                    n_distinct = np.unique(idx[st.unfinished]).size
                    if n_distinct <= min(self.opts.cpu_rescue_max,
                                         max(1, B // 8)):
                        break     # hand the straggler minority to the CPU
                bucket = compaction_bucket(n_active)
                if bucket <= len(idx) // 2:
                    sel = np.nonzero(st.unfinished)[0]
                    pad = np.resize(sel, bucket)  # pad by repeating survivors
                    stats.compact_events += 1
                    stats.dispatches += 1
                    stats.bucket_occupancy.append(
                        (int(bucket), int(np.unique(idx[sel]).size)))
                    dev_idx = torch.as_tensor(idx, device=self.device)
                    dev_pad = torch.as_tensor(pad, device=self.device)
                    full_state = _scatter(full_state, cur_state, dev_idx)
                    cur = tuple(a[dev_pad] for a in cur)
                    cur_state = _index(cur_state, dev_pad)
                    idx = idx[pad]
            full_state = _scatter(full_state, cur_state,
                                  torch.as_tensor(idx, device=self.device))
            full_state = self._cpu_rescue(full_state, c, q, l, u, total,
                                          stats)
            self._note_exec("fin", c.shape, stats)
            stats.dispatches += 1
            stats.kernel_launches += sv.launches - launches0
            out = sv.finalize(*args, full_state)
            self.release_buffers()
            return out

    def run_chunk(self, cur, state: _State, limit: int,
                  stats: SolveStats) -> tuple[_State, _StatusRead]:
        """One host chunk of the batch ``cur`` (``c, q, l, u``) from
        ``state``: check windows on the width's runner until no instance
        is active under ``limit``, with one status read as the chunk
        starts and one after each window.  Returns the runner's state
        buffers (valid until its next chunk) and the last read."""
        before = {k: getattr(stats, k) for k in DRIVER_FIELDS}
        runner = self._runner(cur[0].shape[0])
        runner.load(*cur, state, limit)
        st = runner.read(stats)
        while st.n_act:
            runner.step(st.n_max, stats)
            st = runner.read(stats)
        stats.chunks += 1
        with _driver_lock:
            for k, v in before.items():
                DRIVER_COUNTS[k] += getattr(stats, k) - v
        return runner.state, st

    def _runner(self, B: int) -> _WindowRunner:
        r = self._runners.get(B)
        if r is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            r = self._runners[B] = _WindowRunner(
                self._solver, self.op, self.dr, self.dc, self.eta,
                self._graph_pool)
        return r

    def release_buffers(self) -> None:
        """Order every runner's next chunk after the work this thread has
        enqueued so far, which may still read a runner's state buffers
        (``run_chunk`` returns them): called by a driver, under the solve
        lock, once it has enqueued its last read of them.  Another
        thread's solve, on another stream, then loads the buffers only
        after those reads."""
        for r in self._runners.values():
            r.release()

    def _cpu_rescue(self, state: _State, c, q, l, u, total: int,
                    stats: Optional[SolveStats] = None) -> _State:
        """Solve still-unconverged instances exactly on the CPU (HiGHS)
        and mark them converged with the exact primal."""
        if (self.opts.cpu_rescue_after is None
                or total < self.opts.cpu_rescue_after):
            return state
        act = ~(to_host(state.converged) | to_host(state.infeasible))
        sel = np.nonzero(act)[0]
        if sel.size == 0 or sel.size > min(self.opts.cpu_rescue_max,
                                           max(1, state.x.shape[0] // 8)):
            return state
        from . import cpu_ref
        ch, qh, lh, uh = (to_host(a) for a in (c, q, l, u))
        dc = to_host(self.dc).astype(np.float64)
        ok_idx, xs = [], []
        for i in sel:
            r = cpu_ref.solve_lp_cpu(self.lp, c=ch[i], q=qh[i],
                                     l=lh[i], u=uh[i])
            if r.status != 0 or not np.isfinite(r.obj):
                continue
            ok_idx.append(int(i))
            xs.append(r.x / dc)
        if not ok_idx:
            return state
        if stats is not None:
            stats.cpu_rescued += len(ok_idx)
        from ..utils.errors import TellUser
        TellUser.info(f"{len(ok_idx)} straggler instance(s) rescued on "
                      "the exact CPU solver")
        ii = torch.as_tensor(ok_idx, device=self.device)
        X = torch.as_tensor(np.stack(xs), dtype=state.x.dtype,
                            device=self.device)
        s = state.map(lambda a: a.clone())
        s.x[ii] = X
        s.done_x[ii] = X
        s.done_y[ii] = s.y[ii]
        s.converged[ii] = True
        s.iters_at_conv[ii] = s.total[ii]
        return s


def solve_lp(lp: LP, opts: Optional[PDHGOptions] = None,
             device=None) -> PDHGResult:
    """Solve one LP on ``device`` (``None`` -> ``cuda:0``; pass ``"cpu"``
    explicitly)."""
    return CompiledLPSolver(lp, opts, device=device).solve()


def diagnose_infeasibility(lp: LP, y) -> str:
    """Rank constraint row groups by their dual-ray weight (the rows
    driving the Farkas certificate are the conflicting requirements)."""
    y = np.abs(to_host(y))
    if y.ndim > 1:
        y = y.max(axis=0)
    total = y.sum() or 1.0
    weights = []
    for name, ranges in lp.row_groups.items():
        w = sum(float(y[a:b].sum()) for a, b in ranges)
        weights.append((w / total, name))
    weights.sort(reverse=True)
    top = [f"{name} ({w:.0%})" for w, name in weights[:4] if w > 0.01]
    if not top:
        top = ["no dominant group (dual mass is spread thinly)"]
    return ("problem is primal infeasible; conflicting constraint groups by "
            "dual-ray weight: " + ", ".join(top))
