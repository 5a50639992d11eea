"""dervet_tpu_torch — the PyTorch/CUDA port of ``dervet_tpu``.

The same DER valuation pipeline (window LPs, batched restarted PDHG,
float64 certification, CBA proforma) with the solver on an NVIDIA GPU:
plain tensor code is PyTorch, and the PDHG iteration chunk runs in
hand-written CUDA kernels (``ops/csrc/fused_chunk.cu``).  Entry points run
on ``cuda:0`` unless the caller passes ``device="cpu"``
(:func:`device.resolve_device`).  Nothing here imports JAX.
"""

__version__ = "0.1.0"
