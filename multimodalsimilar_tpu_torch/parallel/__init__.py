"""Multi-GPU layouts of the port (counterpart of
multimodalsimilar_tpu/parallel): the ``(data, model)`` mesh and its
process groups (``mesh.py``) and the launcher the tests and
``chip_smoke.py`` use in place of ``torchrun`` (``spawn.py``). Tensor,
sequence and pipeline parallelism (the JAX package's ``tp.py``,
``sp.py``, ``pp.py``) are not ported yet (ROADMAP A17 part 2)."""

from multimodalsimilar_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                       Mesh, MeshRules,
                                                       create_mesh,
                                                       init_distributed,
                                                       shard_batch)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "MeshRules", "create_mesh",
           "init_distributed", "shard_batch"]
