"""Row-split distributed training on ``torch.distributed`` (port of the
row-split half of ``xgboost_tpu/parallel/``; the reference's
``dsplit=row`` with ``histred.Allreduce``).

One process per rank, each holding one device and one contiguous block
of the padded rows, the block the JAX package's mesh gives device r:

- :mod:`.mesh`: :class:`~.mesh.DataMesh` (rank, world, device, process
  group, backend), ``set_mesh`` / ``get_mesh`` / ``data_parallel_mesh``;
- :mod:`.launch`: ``init_worker`` (the ``XGBTPU_COORD`` /
  ``XGBTPU_NUM_WORKER`` / ``XGBTPU_WORKER_ID`` rendezvous) and the local
  launcher ``python -m xgboost_tpu_torch.parallel.launch -n N cmd ...``;
- :mod:`.dp`: the ``hist_reduce`` seam of tree growth and refresh,
  ``grow_tree_dp``, ``shard_rows``, ``pad_rows``;
- :mod:`.sketch_device`: the device sketch (local summaries, an
  ``all_gather`` and a pairwise fold in rank order);
- :mod:`.sharded`: :class:`~.sharded.ShardedDMatrix`, per-rank split
  loading of libsvm text.

Column split, the launcher's fault tolerance (keepalive, watchdog,
degrade, coordinator standby, grow-back), the scheduler submitters, the
communication cost model and ranking on sharded rows are ROADMAP.md
section 1 item 13b.
"""

from xgboost_tpu_torch.parallel.mesh import (DataMesh, data_parallel_mesh,
                                             get_mesh, mesh_available,
                                             set_mesh)

__all__ = ["DataMesh", "data_parallel_mesh", "get_mesh", "mesh_available",
           "set_mesh"]
