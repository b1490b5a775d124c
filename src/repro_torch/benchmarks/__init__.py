"""Measured benchmarks of the port on the card: the paper's Table 2
(``table2_speedup``), the serving latency sweep (``serve_latency``) and the
SLO-goodput load benchmark (``serve_load``), with the timing and bound
helpers they share (``timing``). Each runs as ``python -m
repro_torch.benchmarks.<name>``, on the card unless ``--device cpu`` is
passed."""
