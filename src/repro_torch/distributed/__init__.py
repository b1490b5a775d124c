"""Multi-device pieces of the port: the tensor-parallel serving layout
(which axis of each deployed leaf and decode-state buffer shards over the
ranks, and the shard / gather moves between full logical arrays and one
rank's slices), the training shard rules (JAX's) and the moves of a
sharded training step's trees, its differentiable collectives
(``collectives``) and the compressed data-parallel gradient mean."""
from .compression import compressed_grad_mean
from .sharding import (FusedAxis, TrainAxis, TrainSpec, batch_spec, gather_serving,
                       gather_training, param_specs, safe_batch_spec,
                       serving_param_specs, serving_state_specs,
                       set_mesh_axis_sizes, shard_serving, shard_training,
                       spec_for, state_specs, training_specs)

__all__ = ["FusedAxis", "TrainAxis", "TrainSpec", "batch_spec", "compressed_grad_mean",
           "gather_serving", "gather_training", "param_specs",
           "safe_batch_spec", "serving_param_specs", "serving_state_specs",
           "set_mesh_axis_sizes", "shard_serving", "shard_training",
           "spec_for", "state_specs", "training_specs"]
