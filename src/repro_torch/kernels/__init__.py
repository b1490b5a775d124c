"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the dispatch layer (``ops``). Importing this package builds nothing: the
CUDA library is compiled at the first launch (``build.library``)."""
