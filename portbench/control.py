"""The readings a cell's limits are set from: its control, the sound
program, and the program with a fault planted, each held to the same
comparison as a run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--what control|sound|no-rescue] [--seconds 4]

``control`` is the configuration's ``control``: either the reference
computed one precision step below the configuration's (``"kind":
"reference"``), answering as many pairs as a run compares
(``check_pairs``; for a paths cell also ``check_paths`` polylines), or the
program's own lower-precision path switched on (``"kind": "program"``: the
slabs in ``layout``) and run as a run is, at the cell's load for
``--seconds``.  ``sound`` runs the program as the configuration states it;
``no-rescue`` runs it with the exact-argmin rescue left out (the ambiguous
rows keep their quantized winners).  Every program run sets up in this one
process, so its readings cost no process start.  One JSON line a seed:
each number beside its limit and whether the run came out correct (a
control or a fault must not).  ``--device cpu`` runs on the CPU.
"""

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def control_checks(cell, seed: int, seconds: float, device) -> list:
    """[(name, value, limit)] of the reference control on one seed's
    traffic."""
    import numpy as np

    from portbench import traffic
    from portbench.reference import Reference
    from portbench.reference.compare import compare
    from portbench.scene import Map

    cfg, wl = cell.config, cell.workload
    m = Map(cfg["map"])
    reqs = traffic.make(wl, m, seconds, traffic.rng(seed, traffic.TRAFFIC))
    n = int(np.searchsorted(reqs.lo, wl["check_pairs"]))
    n = max(1, min(n, reqs.n))
    s, t = reqs.s[:reqs.lo[n]], reqs.t[:reqs.lo[n]]
    low = Reference(m.rects, cfg["control"]["precision"], device)
    ref = Reference(m.rects, "f64", device)
    paths = None
    if wl["entry"] == "query_paths":
        k = min(reqs.size(0) and int(np.searchsorted(
            reqs.lo, wl["check_paths"])), reqs.n)
        k = max(1, k)
        ps, pt = reqs.s[:reqs.lo[k]], reqs.t[:reqs.lo[k]]
        paths = [((ps, pt), low.solve(ps, pt, want_paths=True)[1])]
    return compare(cfg, ref, s, t, low.solve(s, t), paths=paths,
                   missing=0 if wl["loop"] == "open" else None)


def program_control(cell):
    """``cell`` serving from the slabs its configuration's control names,
    held to the configuration's own guarantee and limits."""
    cfg = copy.deepcopy(cell.config)
    cfg["layout"] = cfg["control"]["layout"]
    return dataclasses.replace(cell, config=cfg)


def _no_rescue(self, res, amb, s, t, bucket):
    return tuple(r.cpu().numpy() for r in res[:5])


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted while the block runs."""
    if fault is None:
        yield
        return
    from repro_torch.serving.query_engine import DeviceEngine
    if fault != "no-rescue":
        raise ValueError(f"unknown fault {fault!r} (no-rescue)")
    orig = DeviceEngine._rescue
    DeviceEngine._rescue = _no_rescue
    try:
        yield
    finally:
        DeviceEngine._rescue = orig


def program_checks(cell, seed: int, seconds: float, device,
                   fault: str | None = None) -> tuple:
    """(checks, result line) of one run of ``cell`` in this process."""
    from portbench import harness
    with planted(fault):
        result, checks = harness.run(cell, seed, seconds, False,
                                     time.perf_counter(), device=device)
    gc.unfreeze()                   # the run froze its set-up heap
    gc.collect()
    return checks, result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="control",
                   choices=("control", "sound", "no-rescue"))
    p.add_argument("--seconds", type=float, default=4.0,
                   help="window of a program run; the reference control "
                        "draws the traffic of run_seconds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    ctl = cell.config["control"]
    if args.what == "control" and ctl["kind"] == "program":
        run_cell, fault = program_control(cell), None
    elif args.what == "control":
        run_cell, fault = None, None
    else:
        run_cell = cell
        fault = None if args.what == "sound" else args.what
    run_s = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    for seed in (int(x) for x in args.seeds.split(",")):
        extra = {}
        if run_cell is None:
            checks = control_checks(cell, seed, run_s, args.device)
        else:
            checks, res = program_checks(run_cell, seed, args.seconds,
                                         args.device, fault)
            extra = {"attempted": res["attempted"],
                     "failed": res["failed"]}
        ok = all(v <= lim for _, v, lim in checks)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "what": args.what,
                          "control": ctl if args.what == "control" else None,
                          "correct": ok, **extra,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
