"""Time the synchronous serving path of a port tree on one NVIDIA GPU.

    python3 examples/serve_timing_torch.py [--src DIR] [--passes N]

Builds rooms-M (seed 0, cell 2.0) compressed to 20% of its label memory,
packs it width-bucketed on the card, serves 2000 uniform queries (seed 33)
through a ``CudaEngine`` behind ``PathServer(batch_size=256)`` and prints
the card's name and power limit, then one JSON line with us/query of each
timed pass (each ends in ``torch.cuda.synchronize()``), after ``warmup``
and one untimed pass.  ``--src`` names the ``src`` directory whose
``repro_torch`` is imported (default: this checkout's), so two trees can be
timed in turns on one card; the script uses only entry points that every
slice of the port has.  Exits non-zero without a card.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--passes", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import (build_ehl, build_visgraph,
                                  compress_to_fraction, make_map,
                                  pack_bucketed, uniform_queries)
    from repro_torch.serving import CudaEngine, PathServer

    scene = make_map("rooms-M", seed=0)
    graph = build_visgraph(scene)
    index = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(index, 0.2)
    qs = uniform_queries(scene, graph, 2000, seed=33)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    srv = PathServer(CudaEngine(pack_bucketed(index, device="cuda")),
                     batch_size=256)
    srv.warmup(paths=True)
    srv.query(s, t)
    us = []
    for _ in range(args.passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.query(s, t)
        torch.cuda.synchronize()
        us.append(1e6 * (time.perf_counter() - t0) / len(s))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(json.dumps({"src": args.src, "queries": len(s),
                      "us_per_query": us,
                      "median": float(np.median(us))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
