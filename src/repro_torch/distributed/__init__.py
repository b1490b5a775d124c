"""Tensor-parallel serving layout of the port: which axis of each deployed
leaf and decode-state buffer shards over the ranks, and the shard /
gather moves between full logical arrays and one rank's slices."""
from .sharding import (gather_serving, serving_param_specs,
                       serving_state_specs, shard_serving)

__all__ = ["gather_serving", "serving_param_specs", "serving_state_specs",
           "shard_serving"]
