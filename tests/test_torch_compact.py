"""The compact forms of K that the chunk kernels read, checked on the CPU.

The CUDA kernels read K only as band diagonals plus a compact sparse part
(``pdhg.CompactK``: CSR by row, CSC by column), built once per operator.
``fused_chunk.compact_matvec``/``compact_rmatvec`` apply those forms with
the kernels' indexing (the zero halo, the slot map, the column span), so
the layout is held here against the operator's own products, where no
card is needed.  Tolerance: per instance, max |compact - op| <= 1e-6
max |op| + 1e-7 (float32 sums of the same products in another order).

Also: the ICE + CHP window that ``benchlib`` assembles for the port is
the JAX package's multi-DER window, entry for entry; at the monthly
daily-cycle shape the wide pair has at most one entry per column and
24 per row; the forms are built once per operator; and ``supports``
takes every shape the first kernels took (state in shared memory, K
read dense), the larger ones in the shared-state configuration.
"""
import re

import numpy as np
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu.scenario.scenario import MicrogridScenario as JaxScenario
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.ops import fused_chunk
from dervet_tpu_torch.ops import lp as port_lp
from dervet_tpu_torch.ops import pdhg
from dervet_tpu_torch.scenario.scenario import MicrogridScenario

from test_torch_cuda import LPS, assert_close_rows

torch.set_num_threads(2)


BENCH_LPS = {"ice_chp": benchlib.multi_der_window_lp,
             "da_fr": benchlib.fr_window_lp,
             "dense_block": benchlib.dense_block_lp}


def port_op(kind):
    lp = (BENCH_LPS[kind]() if kind in BENCH_LPS
          else LPS[kind](port_lp.LPBuilder))
    return lp, pdhg.CompiledLPSolver(lp, device="cpu").op


def bands(op):
    if isinstance(op, pdhg.BandedOp):
        return op.diags, op.offsets
    return None, ()


def monthly_daily_cycle_lps():
    scen = MicrogridScenario(benchlib.synthetic_case(daily_cycle_limit=1))
    scen.prepare_dispatch("cpu")
    out = {}
    for ctx in scen.windows:
        if ctx.T not in out:
            out[ctx.T] = scen.build_window_lp(ctx, scen._annuity_scalar,
                                              scen._requirements)
    return out


@pytest.mark.parametrize("kind", ["banded", "banded_wide", "dense",
                                  "ice_chp", "da_fr"])
def test_compact_forms_apply_like_the_op(kind):
    lp, op = port_op(kind)
    expect = pdhg.DenseOp if kind.startswith("dense") else pdhg.BandedOp
    assert isinstance(op, expect) and fused_chunk.supports(op, "reflected")
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((3, lp.n)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal((3, lp.m)), dtype=torch.float32)
    diags, offs = bands(op)
    kx = fused_chunk.compact_matvec(diags, offs, op.compact, x)
    kty = fused_chunk.compact_rmatvec(diags, offs, op.compact, y, lp.n)
    assert_close_rows(kx.numpy(), pdhg.op_matvec(op, x).numpy(), "Kx",
                      rtol=1e-6, atol=1e-7)
    assert_close_rows(kty.numpy(), pdhg.op_rmatvec(op, y).numpy(), "KTy",
                      rtol=1e-6, atol=1e-7)


def test_compact_forms_apply_like_k_at_full_density():
    """On the dense block (600 non-zeros a row, 200 a column) the float32
    sums run long, so the forms are held against K in float64 within the
    rounding bound of a float32 sum of N terms: gamma_N sum |terms|,
    gamma_N = N u / (1 - N u), u = 2^-24."""
    lp, op = port_op("dense_block")
    K = op.Kh.double()
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((3, lp.n)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal((3, lp.m)), dtype=torch.float32)

    def gamma(N):
        u = 2.0 ** -24
        return N * u / (1 - N * u)
    kx = fused_chunk.compact_matvec(None, (), op.compact, x).double()
    err = (kx - x.double() @ K.T).abs()
    assert (err <= gamma(lp.n) * (x.double().abs() @ K.abs().T)).all()
    kty = fused_chunk.compact_rmatvec(None, (), op.compact, y, lp.n).double()
    err = (kty - y.double() @ K).abs()
    assert (err <= gamma(lp.m) * (y.double().abs() @ K.abs())).all()


def test_compact_forms_hold_only_nonzeros():
    """Every stored value is a non-zero of K at the place each form says;
    together each form's entries are all of the wide pair (banded) or of
    K (dense); rows ascend within a column and columns within a row; the
    column span starts and ends at a column with entries."""
    for kind in ("banded_wide", "dense", "dense_block"):
        lp, op = port_op(kind)
        part = op.compact
        M = (op.Kh if kind.startswith("dense") else torch.zeros(lp.m, lp.n)
             .index_copy(0, op.wide_rows.long(), op.wide_w)).numpy()
        assert part.nnz == (M != 0).sum()
        # by column
        cp, cr, cv = (t.numpy() for t in (part.col_ptr, part.col_rows,
                                          part.col_vals))
        nc = cp.shape[0] - 1
        per_col = np.diff(cp)
        assert cp[0] == 0 and cp[-1] == part.nnz and (per_col >= 0).all()
        assert per_col[0] > 0 and per_col[-1] > 0
        assert not M[:, :part.col_lo].any()
        assert not M[:, part.col_lo + nc:].any()
        j = part.col_lo + np.repeat(np.arange(nc), per_col)
        got = np.zeros_like(M)
        got[cr, j] = cv
        np.testing.assert_array_equal(got, M)
        assert all((np.diff(cr[cp[c]:cp[c + 1]]) > 0).all()
                   for c in range(nc))
        # by row
        ip, rc, rv = (t.numpy() for t in (part.indptr, part.row_cols,
                                          part.row_vals))
        slot = part.row_slot.numpy()
        got = np.zeros_like(M)
        for i in np.nonzero(slot >= 0)[0]:
            seg = slice(ip[slot[i]], ip[slot[i] + 1])
            assert (np.diff(rc[seg]) > 0).all()
            got[i, rc[seg]] = rv[seg]
        np.testing.assert_array_equal(got, M)
        assert ip[-1] == part.nnz


def test_monthly_daily_cycle_layout():
    """At each monthly shape the main path runs, the wide pair has at
    most one entry per column and 24 per wide row (one day of
    discharge), and the kernel's configuration covers it."""
    for T, lp in monthly_daily_cycle_lps().items():
        op = pdhg.CompiledLPSolver(lp, device="cpu").op
        part = op.compact
        r = op.wide_w.shape[0]
        assert part.indptr.shape[0] == r + 1 and r == -(-T // 24)
        assert int(torch.diff(part.col_ptr).max()) == 1
        per_row = np.diff(part.indptr.numpy())
        assert per_row.max() == 24 and per_row.min() >= 23
        assert int((part.row_slot >= 0).sum()) == r
        assert part.nnz == int((op.wide_w != 0).sum())
        for v in fused_chunk.VARIANTS:
            assert fused_chunk.config_for(lp.m, lp.n, op.offsets, part,
                                          v) == (512, 6, 2, 2)


def took_first(op) -> bool:
    """Whether the first chunk kernels took ``op``: their shared state,
    4 (6n + 3m + r) + 4 (nb + m) bytes for a banded op with r wide rows
    and 4 (6n + 3m) for a dense op, within one block's shared memory,
    and a dense K of at most 10 MiB (they read W and K dense through
    L2)."""
    limit = fused_chunk.BLOCK_SMEM_BYTES
    if isinstance(op, pdhg.BandedOp):
        r = 0 if op.wide_w is None else op.wide_w.shape[0]
        return (op.ell is None and len(op.offsets) <= fused_chunk.MAX_BANDS
                and 4 * (6 * op.n + 3 * op.m + r)
                + 4 * (len(op.offsets) + op.m) <= limit)
    m, n = op.Kh.shape
    return 4 * m * n <= 10 * 2 ** 20 and 4 * (6 * n + 3 * m) <= limit


ENVELOPE = {
    # four bands at 3000 x 6000: more rows than 768 threads x 3 cover
    "banded_3000x6000": lambda: pdhg.BandedOp(
        diags=torch.ones(4, 3000), offsets=(-1, 0, 1, 3000), m=3000,
        n=6000),
    # every entry of K non-zero: the compact forms exceed shared memory
    "dense_200x600": lambda: pdhg.DenseOp(Kh=torch.ones(200, 600)),
    # the monthly DA + FR window: ten bands too large to stage
    "da_fr_month": lambda: port_op("da_fr")[1],
}


@pytest.mark.parametrize("name", sorted(ENVELOPE))
def test_supports_keeps_the_first_envelope(name):
    """Shapes the first kernels took and no register configuration
    holds run the shared-state configuration, under every variant."""
    op = ENVELOPE[name]()
    assert took_first(op)
    m, n, offsets = fused_chunk._shape(op)
    for v in fused_chunk.VARIANTS:
        assert fused_chunk.supports(op, v)
        assert fused_chunk.config_for(m, n, offsets, op.compact,
                                      v) == fused_chunk.SHARED_CONFIG


def test_supports_takes_every_banded_shape_the_first_kernels_took():
    """Over a grid of banded shapes (rows, columns, bands, wide rows),
    ``supports`` takes each one the first kernels took."""
    took = 0
    for m in (50, 500, 2000, 4000, 8000):
        for n in (100, 1000, 3000, 6000, 9000):
            for nb in (1, 4, 10, 32):
                for r in (0, 31):
                    wide = {} if not r else dict(
                        wide_rows=torch.arange(r, dtype=torch.int32),
                        wide_w=torch.zeros(r, n))
                    op = pdhg.BandedOp(diags=torch.zeros(nb, m),
                                       offsets=range(nb), m=m, n=n, **wide)
                    if took_first(op):
                        took += 1
                        assert all(fused_chunk.supports(op, v)
                                   for v in fused_chunk.VARIANTS), (m, n, nb)
    assert took > 50


def test_forms_built_once(monkeypatch):
    """``_build_op`` builds the compact forms with the op; chunks do not
    rebuild them.  An op built by hand builds them at first use, once."""
    calls = []
    real = pdhg.compact_k

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    lp = LPS["banded_wide"](port_lp.LPBuilder)
    monkeypatch.setattr(pdhg, "compact_k", counting)
    solver = pdhg.CompiledLPSolver(lp, device="cpu")
    assert len(calls) == 1
    op = solver.op
    part = op.compact
    B = 2
    rng = np.random.default_rng(0)

    def chunk(op, m, n):
        f = torch.tensor(rng.random((B, n)), dtype=torch.float32)
        g = torch.tensor(rng.random((B, m)), dtype=torch.float32)
        return fused_chunk.batched_chunk(
            op, f, g, -f - 1, f + 1, torch.ones(B), torch.tensor(0.1), f, g,
            f, g, 0, 4, "reflected", 1.8)

    for _ in range(2):
        assert fused_chunk.supports(op, "reflected")
        chunk(op, lp.m, lp.n)
    assert len(calls) == 1 and op.compact is part
    hand = pdhg.DenseOp(Kh=torch.tensor(rng.standard_normal((6, 10)),
                                        dtype=torch.float32))
    assert len(calls) == 1
    for _ in range(2):
        assert fused_chunk.supports(hand, "halpern")
        chunk(hand, 6, 10)
    assert len(calls) == 2


def test_multi_der_window_is_the_jax_one():
    """``benchlib.multi_der_window_lp`` reproduces the JAX package's ICE +
    CHP monthly window: K, q, l, u and c entry for entry."""
    scen = JaxScenario(jax_benchlib.synthetic_case(multi_der=True))
    scen.prepare_dispatch("cpu")
    ctx = scen.windows[0]
    ref = scen.build_window_lp(ctx, scen._annuity_scalar, scen._requirements)
    lp = benchlib.multi_der_window_lp()
    assert (lp.m, lp.n, lp.n_eq) == (ref.m, ref.n, ref.n_eq) == (2233, 5952,
                                                                 1489)
    assert (lp.K != ref.K).nnz == 0
    for name in ("q", "l", "u", "c"):
        np.testing.assert_array_equal(getattr(lp, name), getattr(ref, name))


def test_configs_mirror_the_cuda_source():
    """``CONFIGS`` lists the thread configurations the CUDA source builds,
    in its order, and ``config_for`` takes the first that covers a shape."""
    src = fused_chunk.SOURCE.read_text()
    block = re.search(r"#define FOR_EACH_CONFIG\(X\)((?:.*\\\n)*.*)",
                      src).group(1)
    built = tuple(tuple(int(v) for v in t.split(","))
                  for t in re.findall(r"X\(([\d, ]+)\)", block))
    assert built == fused_chunk.CONFIGS
    assert fused_chunk.CONFIGS[-1] == fused_chunk.SHARED_CONFIG
    for threads, cpt, rpt, minb in fused_chunk.CONFIGS:
        assert threads % 32 == 0 and threads <= 1024
        assert 1 <= minb and threads * minb <= 2048
        if (cpt, rpt) == (0, 0):
            continue
        first = fused_chunk.config_for(threads * rpt, threads * cpt)
        assert first[0] * first[1] >= threads * cpt
    assert fused_chunk.config_for(169, 672) == (256, 3, 1, 2)
    assert fused_chunk.config_for(25, 96) == (128, 2, 1, 2)
    assert fused_chunk.config_for(776, 2976) == (512, 6, 2, 2)
    assert fused_chunk.config_for(2305, 100) == fused_chunk.SHARED_CONFIG
    assert fused_chunk.config_for(3000, 12000) is None


def test_halo_covers_every_band_read():
    """Row i reads 2x1-x at i + d for every band d: the halo makes every
    such index land inside the shared array."""
    for offs, m, n in (((-1, 0, 743, 1487), 776, 2976),
                       ((-1, 0, 743, 1487, 2975, 3719, 4463), 2233, 5952),
                       ((0, 5), 10, 8), ((), 3, 4)):
        hl, hr = fused_chunk.halo(offs, m, n)
        for d in offs:
            assert -hl <= d and m - 1 + d < n + hr
        assert fused_chunk.smem_bytes(m, n, offs) == 4 * (
            4 + 5 * n + hl + hr + m + len(offs) * m)


def test_shared_budget_at_the_path_shapes():
    """Two 512-thread blocks of the monthly daily-cycle window fit one
    SM's shared memory under every variant (the registers allow two),
    and the ICE + CHP window fits one block under every variant."""
    lp, op = port_op("ice_chp")
    for v in fused_chunk.VARIANTS:
        assert fused_chunk.smem_bytes(lp.m, lp.n, op.offsets, op.compact,
                                      v) <= fused_chunk.BLOCK_SMEM_BYTES
    lp = monthly_daily_cycle_lps()[744]
    op = pdhg.CompiledLPSolver(lp, device="cpu").op
    assert fused_chunk.config_for(lp.m, lp.n) == (512, 6, 2, 2)
    per_sm = 233_472                     # an SM's shared memory
    for v in fused_chunk.VARIANTS:
        words = fused_chunk.smem_bytes(lp.m, lp.n, op.offsets, op.compact,
                                       v)
        assert 2 * (words + 1024) <= per_sm
    ref = fused_chunk.smem_bytes(lp.m, lp.n, op.offsets, op.compact,
                                 "reflected")
    # both forms of the 743 wide entries, the CSR pointers of 31 rows and
    # the CSC pointers of the 743-column span
    nc = op.compact.col_ptr.shape[0] - 1
    assert nc == 743
    assert ref - fused_chunk.smem_bytes(lp.m, lp.n, op.offsets) == 4 * (
        4 * 743 + 32 + nc + 1)
