"""Multi-device pieces of the port: the tensor-parallel serving layout
(which axis of each deployed leaf and decode-state buffer shards over the
ranks, and the shard / gather moves between full logical arrays and one
rank's slices) and the compressed data-parallel gradient mean."""
from .compression import compressed_grad_mean
from .sharding import (gather_serving, serving_param_specs,
                       serving_state_specs, shard_serving)

__all__ = ["compressed_grad_mean", "gather_serving", "serving_param_specs",
           "serving_state_specs", "shard_serving"]
