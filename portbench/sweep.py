"""Find the knee of an open-loop cell: its traffic at several rates.

    python3 portbench/sweep.py --workload <cell> --rates 400,600,800 \\
        --seconds 5 --seed 1

Sets the cell up once, then runs its open-loop traffic for ``--seconds``
at each rate (requests/s) in turn and prints one line a rate: requests,
shed, never answered, p50/p95/max latency from the due time, the
generator's lateness, and the backlog's growth (median latency of the
last fifth of the requests over that of the first fifth).  The knee is the
highest rate with no shed request, no growing backlog and a p95 within the
cell's ``latency_limit_ms``.  Needs a CUDA device.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from portbench import harness, traffic
    from portbench.scene import Map

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    wl = cell.workload
    m = Map(cell.config["map"])
    served = harness.Served(cell, m, "cuda", trace=False)
    served.srv.warmup()
    served.srv.start_async(**wl["batcher"])
    harness.open_loop(served, wl, traffic.open_schedule(
        wl, m, harness.OPEN_WARMUP_S, traffic.rng(args.seed, 1)),
        harness.OPEN_WARMUP_S, False, "cuda")
    harness.settle()
    print(f"cell {cell.name}: limit {wl['latency_limit_ms']} ms, "
          f"{args.seconds} s a rate, {torch.cuda.get_device_name()}")
    print("rate_per_s requests shed missing p50_ms p95_ms max_ms "
          "late_p95_ms growth pairs_per_s")
    for j, rate in enumerate(float(r) for r in args.rates.split(",")):
        reqs = traffic.open_schedule(wl, m, args.seconds,
                                     traffic.rng(args.seed, 10 + j), rate)
        w = harness.open_loop(served, wl, reqs, args.seconds, False, "cuda")
        lat = 1e3 * w.latency
        k = max(1, reqs.n // 5)
        growth = float(np.median(lat[-k:]) / np.median(lat[:k]))
        pairs = sum(reqs.size(i) for i in w.answers) / args.seconds
        print(f"{rate:.0f} {reqs.n} {w.shed} {w.missing} "
              f"{np.percentile(lat, 50):.4f} {np.percentile(lat, 95):.4f} "
              f"{lat.max():.4f} {1e3 * np.percentile(w.lateness, 95):.4f} "
              f"{growth:.4f} {pairs:.1f}", flush=True)
        served.srv.drain()
    served.srv.stop_async()
    return 0


if __name__ == "__main__":
    sys.exit(main())
