#!/usr/bin/env python
"""CPU run of bench.soak_band for loop-closure accuracy iteration.

`import bench` is side-effect-free (the device check runs in main() only),
so this just forces the CPU backend and calls the band — same circuit,
same knobs, no accelerator needed.
Usage: python tools/soak_cpu_probe.py [n_scans]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import importlib.util

spec = importlib.util.spec_from_file_location(
    "bench", os.path.join(sys.path[0], "bench.py"))
bench = importlib.util.module_from_spec(spec)
sys.modules["bench"] = bench
spec.loader.exec_module(bench)

if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 192
    print(json.dumps(bench.soak_band(n)))
