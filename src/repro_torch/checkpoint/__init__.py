"""Checkpoints and artifact persistence in the format shared with the JAX
package."""
from .manager import CheckpointManager  # noqa: F401
