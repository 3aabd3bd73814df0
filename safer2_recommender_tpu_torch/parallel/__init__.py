"""Data-parallel runtime over ``torch.distributed`` (the counterpart of
``safer2_recommender_tpu/parallel``): ``parallel/mesh.py`` holds the mesh,
the process groups and the collectives, ``parallel/audit.py`` counts
them."""

from safer2_recommender_tpu_torch.parallel.mesh import (Mesh, get_mesh,
                                                        init_distributed,
                                                        num_shards, spawn)

__all__ = ["Mesh", "get_mesh", "init_distributed", "num_shards", "spawn"]
