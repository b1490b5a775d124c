"""Benchmark runner of the port: one section per paper table, the serving
latency and the roofline aggregation (the JAX package's
``benchmarks/run.py``).

``python -m repro_torch.benchmarks.run``           full pass on the card
``python -m repro_torch.benchmarks.run --quick``   reduced grids
``--only table1,table2,table3,serve,roofline`` scopes it; ``--device cpu``
runs the sections that need a device on the CPU (the roofline needs none:
it reads the dry run's JSON, ``--dryrun-dir``). Prints each section's CSV
under a ``# ==== name ====`` header and exits non-zero if any raised.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

SECTIONS = ("table1", "table2", "table3", "serve", "roofline")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--only", default="",
                   help="comma list: " + ",".join(SECTIONS))
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--dryrun-dir", default=None,
                   help="the dry run's JSON (default experiments/dryrun_torch)")
    args = p.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only and not only <= set(SECTIONS):
        p.error(f"--only: unknown sections {sorted(only - set(SECTIONS))}")

    from . import (roofline, serve_latency, table1_glue, table2_speedup,
                   table3_ablation)
    dev, q = args.device, args.quick
    sections = [
        ("table1", lambda: table1_glue.main(quick=q, device=dev)),
        ("table2", lambda: table2_speedup.main(["--device", dev] + (["--quick"] if q else []))),
        ("table3", lambda: table3_ablation.main(quick=q, device=dev)),
        ("serve", lambda: serve_latency.main(quick=q, device=dev)),
        ("roofline", lambda: roofline.main(args.dryrun_dir or roofline.DEFAULT_DIR)),
    ]
    failures = 0
    for name, fn in sections:
        if only and name not in only:
            continue
        print(f"# ==== {name} ====", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            failures += 1
            traceback.print_exc()
        print(f"# {name} took {time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
