"""Multi-device dispatch: the elastic structure-group scheduler
(``elastic.py``), scenario-axis sharding of one batched solve
(``mesh.py``) and the row-sharded solve of one long LP over
``torch.distributed`` ranks (``timeshard.py``).

The JAX package's ``parallel/compat.py`` only bridges jax versions of
``shard_map``; it has no counterpart here.
"""
from .mesh import scenario_devices, solve_batch_sharded  # noqa: F401
