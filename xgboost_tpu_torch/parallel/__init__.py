"""Row-split distributed training on ``torch.distributed`` (port of the
row-split half of ``xgboost_tpu/parallel/``; the reference's
``dsplit=row`` with ``histred.Allreduce``).

One process per rank, each holding one device and one contiguous block
of the padded rows, the block the JAX package's mesh gives device r:

- :mod:`.mesh`: :class:`~.mesh.DataMesh` (rank, world, device, process
  group, backend), ``set_mesh`` / ``get_mesh`` / ``data_parallel_mesh``;
- :mod:`.launch`: ``init_worker`` (the ``XGBTPU_COORD`` /
  ``XGBTPU_NUM_WORKER`` / ``XGBTPU_WORKER_ID`` rendezvous, or a
  scheduler's variables) and the gang launcher ``python -m
  xgboost_tpu_torch.parallel.launch -n N cmd ...``: keepalive restarts,
  the stall watchdog, degrade and grow-back, coordinator state and a
  standby;
- :mod:`.mock` and :mod:`.gang`: the workers' side, the ``mock=``
  coordinates and heartbeats, partition fencing, host loss;
- :mod:`.submit`: the mpirun, qsub and srun submitters;
- :mod:`.commcost`: the histogram reduce's bytes and a round's
  projected time;
- :mod:`.colsplit`: column split (``dsplit=col``);
- :mod:`.dp`: the ``hist_reduce`` seam of tree growth and refresh,
  ``grow_tree_dp``, ``shard_rows``, ``pad_rows``;
- :mod:`.sketch_device`: the device sketch (local summaries, an
  ``all_gather`` and a pairwise fold in rank order);
- :mod:`.sharded`: :class:`~.sharded.ShardedDMatrix`, per-rank split
  loading of libsvm text.

"""

from xgboost_tpu_torch.parallel.mesh import (DataMesh, data_parallel_mesh,
                                             get_mesh, mesh_available,
                                             set_mesh)

__all__ = ["DataMesh", "data_parallel_mesh", "get_mesh", "mesh_available",
           "set_mesh"]
