"""Launchers of the port (the reference's ``launch/``): ``train``,
``serve`` and the mesh (``launch/mesh.py``)."""

from repro_torch.launch.mesh import (Mesh, make_debug_mesh, make_mesh,
                                     make_production_mesh, shard_params,
                                     shardings_for, tree_expand_pod)

__all__ = ["Mesh", "make_debug_mesh", "make_mesh", "make_production_mesh",
           "shard_params", "shardings_for", "tree_expand_pod"]
