"""Device resolution and the port's numeric settings.

Every entry point (``DERVET.solve``, ``run_dispatch``, ``CompiledLPSolver``)
takes ``device=None`` and resolves it here: the first GPU, or an error
when none is visible.  The CPU runs only when the caller asks for it by
name (``device="cpu"``), as the tests do — a silent CPU fallback would
turn a broken GPU install into a run that is hundreds of times slower
and still reports success.
"""
from __future__ import annotations

import torch

# PDHG does not converge on single-pass low-precision matrix products:
# 0 of 256 instances converged when the JAX package's TPU matmuls ran at
# bf16 DEFAULT precision (the JAX package runs every product at HIGHEST
# for this reason; PERF.md, "TPU-era record").  TF32 keeps the same
# 10-bit mantissa, so every float32 product here runs in true fp32.
# The chunk kernels themselves are plain fp32 FMAs (no tensor cores).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises when no GPU is visible); anything
    else is taken as given (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU explicitly")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def _warmup_lp():
    """A tiny battery-shaped LP (SOE recursion + box + prices — the same
    block structure every dispatch window emits) for the warm-up solve.
    T=8 keeps it milliseconds on any device; ``make_op`` keeps it dense,
    so the warm-up launches the dense chunk kernel."""
    import numpy as np

    from .ops.lp import LPBuilder
    T = 8
    b = LPBuilder()
    ch = b.var("ch", T, 0.0, 10.0)
    dis = b.var("dis", T, 0.0, 10.0)
    ene = b.var("ene", T, 0.0, 40.0)
    D = np.eye(T) - np.eye(T, k=-1)
    rhs = np.zeros(T)
    rhs[0] = 20.0
    b.add_rows("soe", [(ene, D), (ch, -0.85), (dis, 1.0)], "eq", rhs)
    price = np.linspace(0.01, 0.08, T)
    b.add_cost(ch, price)
    b.add_cost(dis, -price)
    return b.build()


def warmup_device(device=None, solve: bool = True) -> dict:
    """Pay device initialization up front (serving layer): the CUDA
    context, the chunk kernels' nvcc build (``fused_chunk.build``) and
    the first launch would otherwise land inside the FIRST request's
    latency.  A :class:`~dervet_tpu_torch.service.server.ScenarioService`
    calls this at ``start()`` so admission begins on a warm card; the
    backend-loss recovery calls it with ``solve=False`` as its re-init
    probe.

    ``device`` resolves as everywhere (``None`` -> ``cuda:0``, raising
    without a GPU; ``"cpu"`` only by name).  ``solve`` runs one tiny
    bucket-shaped (batch 8, the smallest bucket) PDHG solve through
    ``CompiledLPSolver`` on the device.  Errors propagate.

    Returns the inventory for the service's metrics surface:
    ``{"n_devices", "platform", "device_kind", "warmup_s"}``."""
    import time

    import numpy as np
    t0 = time.perf_counter()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(8, device=dev).add_(1.0)
        torch.cuda.synchronize(dev)
        info = {"n_devices": torch.cuda.device_count(), "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(dev)}
    else:
        info = {"n_devices": 1, "platform": dev.type,
                "device_kind": dev.type}
    if solve:
        from .ops import fused_chunk
        from .ops.pdhg import CompiledLPSolver
        if dev.type == "cuda":
            fused_chunk.build()
        lp = _warmup_lp()
        solver = CompiledLPSolver(lp, device=dev)
        C = np.broadcast_to(lp.c, (8, lp.n))      # bucket-shaped batch
        solver.solve(c=np.ascontiguousarray(C))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    info["warmup_s"] = round(time.perf_counter() - t0, 4)
    return info
