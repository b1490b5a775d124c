"""Deployment: execution plans and serving artifacts.

* ``ExecutionPlan`` — the resolved, validated execution recipe.
* ``DeployedModel`` — packed int4/int8 weights + scales bound to their plan,
  saved and loaded in the format the JAX package shares.
"""
from .artifact import DeployedModel, deploy, params_from_numpy
from .plan import MODES, ExecutionPlan

__all__ = ["DeployedModel", "ExecutionPlan", "MODES", "deploy",
           "params_from_numpy"]
