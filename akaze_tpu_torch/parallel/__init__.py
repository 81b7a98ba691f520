"""The multi-device tiers of the port (``akaze_tpu/parallel``).

A ``Mesh`` names a grid of devices; a sharded value is a list with one
tensor per local shard, and ``collectives`` joins the shards (in a fixed
order, so that runs repeat bit for bit).  Several shards may share one
device: ``make_mesh(8, devices=["cpu"] * 8)`` on the CPU,
``make_mesh(4, devices=["cuda:0"] * 4)`` on one card, ``make_mesh(4)``
over four cards.  An axis may span processes joined by
``initialize_distributed`` (``torchrun``'s environment).

* ``spatial``: one image's rows sharded over the mesh (the tier for
  images too large for one device), K1 and K2 per shard;
* ``sharded_match``: queries sharded, the train set gathered, K4 per
  shard;
* ``data_parallel``: image pairs sharded, the pair program per shard;
* ``sharded_pgo``, ``sharded_ba``: edges, observations or landmark blocks
  sharded, the solvers' sums reduced over the mesh;
* ``distributed``: process bootstrap, (host, chip) meshes.
"""

from .mesh import Mesh, axis_size, make_mesh, normalize_axes
from .collectives import all_gather, extend_rows, pmax, psum, replicate, shard
from .data_parallel import (batched_detect_and_compute, dp_pipeline_step,
                            dp_pipeline_step_multihost, gather_shards,
                            make_dp_step)
from .sharded_match import compact_train, sharded_match
from .sharded_ba import (LandmarkPartition, gather_points,
                         landmark_sharded_bundle_adjust, pad_observations,
                         partition_landmarks, scatter_points,
                         sharded_bundle_adjust)
from .sharded_pgo import pad_edges, sharded_optimize_pose_graph
from .distributed import (CHIP_AXIS, HIER_AXES, HOST_AXIS, hier_psum,
                          initialize_distributed, make_host_chip_mesh,
                          process_local_batch)
from .spatial import (spatial_detect_and_compute, spatial_exchange_bytes,
                      spatial_launches, spatial_route, spatial_scale_space,
                      spatial_supported)
from .dryrun import dryrun_multichip

__all__ = ["Mesh", "make_mesh", "normalize_axes", "axis_size",
           "psum", "pmax", "all_gather", "extend_rows", "shard", "replicate",
           "batched_detect_and_compute", "dp_pipeline_step",
           "make_dp_step", "dp_pipeline_step_multihost", "gather_shards",
           "sharded_match", "compact_train", "sharded_bundle_adjust",
           "pad_observations", "partition_landmarks", "gather_points",
           "scatter_points", "landmark_sharded_bundle_adjust",
           "LandmarkPartition", "sharded_optimize_pose_graph", "pad_edges",
           "initialize_distributed", "make_host_chip_mesh", "hier_psum",
           "process_local_batch", "HOST_AXIS", "CHIP_AXIS", "HIER_AXES",
           "spatial_scale_space", "spatial_supported",
           "spatial_detect_and_compute", "spatial_route", "spatial_launches",
           "spatial_exchange_bytes", "dryrun_multichip"]
