"""The work a PDHG solve needs, and the card's published peaks: the
yardstick of ``pdhg_roofline.sweep``.

A frozen copy of the port's arithmetic (``ops/fused_chunk.py``:
``chunk_cost`` and ``matrix_work(needed=True)``; ``chip_smoke.py``'s
peaks), taken from the LP alone so that it reads the same work whatever
implements the solve: a new kernel, a fused window or another launch
split.  Only what the inputs need is counted:

* operations: for each instance, its iterations x (one K x and one K^T y,
  2 operations a non-zero each, plus the reflected step's elementwise
  work: 14 a column and 11 a row);
* bytes: c, l, u and q of each instance read once, K's non-zeros read
  once (4 bytes each), x and y of each instance written once, in float32.
"""
import numpy as np

# NVIDIA H100 SXM data sheet, dense, outside the tensor cores; 700 W
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def solve_work(iters, m: int, n: int, nnz: int) -> tuple:
    """(operations, bytes) of one batched solve whose instances ran
    ``iters`` iterations each."""
    iters = np.asarray(iters, np.float64)
    per_iter = 2 * 2 * nnz + 14 * n + 11 * m
    ops = float(iters.sum() * per_iter)
    nbytes = float(len(iters) * 4 * (4 * n + 2 * m) + 4 * nnz)
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FP32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
