"""Launchers of the port (the reference's ``launch/``): ``train``,
``serve``, the mesh (``launch/mesh.py``) and the compile-time tools:
the dry run (``dryrun``), its counter (``hlo_analysis``), the roofline
(``roofline``) and the tables (``report``), run as modules."""

from repro_torch.launch.mesh import (Mesh, make_debug_mesh, make_mesh,
                                     make_production_mesh, shard_params,
                                     shardings_for, tree_expand_pod)

__all__ = ["Mesh", "make_debug_mesh", "make_mesh", "make_production_mesh",
           "shard_params", "shardings_for", "tree_expand_pod"]
