"""Models of the port: the BERT encoder on the shared layer primitives."""
