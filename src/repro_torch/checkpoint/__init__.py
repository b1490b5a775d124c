"""Artifact persistence in the format shared with the JAX package."""
