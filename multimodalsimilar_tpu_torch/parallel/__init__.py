"""Multi-GPU layouts of the port (counterpart of
multimodalsimilar_tpu/parallel): the ``(data, model)`` mesh, its process
groups and its collectives (``mesh.py``), tensor, sequence and pipeline
parallelism of the BERT tower (``tp.py``, ``sp.py``, ``pp.py``) and the
launcher the tests and ``chip_smoke.py`` use in place of ``torchrun``
(``spawn.py``)."""

from multimodalsimilar_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                       Mesh, MeshRules,
                                                       create_mesh,
                                                       init_distributed,
                                                       shard_batch)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "MeshRules", "create_mesh",
           "init_distributed", "shard_batch"]
