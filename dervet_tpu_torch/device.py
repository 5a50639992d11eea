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
