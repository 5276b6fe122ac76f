"""One run of one cell: set-up, the measured window, the check, the result.

``run.py`` parses the command line and calls :func:`main`.  Everything a
cell needs is found by name under the benchmark's folder:

* ``BENCHMARK.json`` (at the root) names the cell's configuration, traffic
  and metrics;
* ``configs/<config>.json``: the map, the index (cell size, budget, slab
  layout), the serving batch and engine, the guarantee and its limits;
  optionally the deployment's hot spots (``clusters``, which its cluster
  traffic draws from) and a ``workload_aware`` block (the index merged
  under the scores of a history drawn from those hot spots);
* ``workloads/<cell>.json``: the traffic (``portbench.traffic``) and the
  entry the window drives;
* ``metrics/<metric>.py``: one per-layer metric, a ``read(ctx)`` that
  returns its value or None.

A run with ``--trace 0`` serves as a user deploys the port (head-sampled
telemetry, no profiler) and reports the end-to-end metrics; ``--trace 1``
samples every request, opens ``torch.profiler`` over a steady sub-window
and reports the per-layer metrics and the breakdown.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import pickle
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import traffic, yardstick
from portbench.reference import Reference
from portbench.reference.compare import compare
from portbench.scene import Map

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds of open-loop traffic that warm the batcher before the window
OPEN_WARMUP_S = 0.5
#: the profiled end of a traced window: its last third, at most this long
PROFILE_S = 2.0
#: seconds past the window's close that late answers are waited for
LATE_S = 60.0
#: the weight of a region's score in a workload-aware merge (the paper's
#: Eq. 5 sets alpha = 0.2)
ALPHA = 0.2
#: the sources of the sampler that draws a workload-aware index's history
SAMPLER = (Path(traffic.__file__), Path(__file__).with_name("scene.py"))


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    workload: dict
    end_to_end: list
    per_layer: list
    data: Path
    chips: int


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    data = root / bench["paths"][0]
    wl = json.loads((data / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {wl[key]!r} in its "
                             f"workload file, {entry[key]!r} in "
                             "BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    if "clusters" in cfg:           # the hot spots are the deployment's
        if "clusters" in wl:
            raise ValueError(f"cell {name}: hot spots belong in its "
                             "configuration, not in its workload file")
        wl["clusters"] = cfg["clusters"]
    return Cell(name, entry["config"], cfg, wl,
                [m for m in bench["end_to_end"] if _in_cell(m, name)],
                [m for m in bench["per_layer"] if _in_cell(m, name)], data,
                entry["chips"])


def load_metric(data: Path, name: str):
    """The reader module of per-layer metric ``name``."""
    path = data / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.NAME != name:
        raise ValueError(f"{path} reads {mod.NAME!r}, not {name!r}")
    return mod


# ------------------------------------------------------------------ set-up
def _key(parts: list, sources: tuple = ()) -> str:
    """Hash of ``parts``, every source of ``repro_torch.core`` and then
    ``sources``, so that a change to the builders builds anew."""
    import repro_torch.core as core

    h = hashlib.sha256(json.dumps(parts, sort_keys=True).encode())
    for src in sorted(Path(core.__file__).parent.glob("*.py")) + list(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def index_key(cfg: dict) -> str:
    """The cache key of a configuration's host index: what it is made from
    (the map, the cell size, the budget and, where the configuration has
    one, the ``workload_aware`` block with the hot spots its history is
    drawn from), so configurations that differ only in how they serve
    share one build.  With the block, the key also takes the sources of
    the sampler that draws the history (:data:`SAMPLER`), so a change to
    the sampler merges anew.  A configuration without the block hashes as
    before the block existed."""
    parts = [cfg["map"], cfg["cell_size"], cfg["budget"]]
    if "workload_aware" not in cfg:
        return _key(parts)
    parts.append({"workload_aware": cfg["workload_aware"],
                  "clusters": cfg["clusters"]})
    return _key(parts, SAMPLER)


def _load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(obj, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def base_index(cfg: dict, m: Map, cache: Path):
    """The map's uncompressed ``EHLIndex`` (``build_ehl``), one per map and
    cell size: a copy loaded from the cache, or built and cached (then the
    caller may merge the built one itself: the cache holds the copy)."""
    from repro_torch.core.geometry import Scene
    from repro_torch.core.grid import build_ehl
    from repro_torch.core.visgraph import build_visgraph

    path = cache / f"base-{_key([cfg['map'], cfg['cell_size']])}.pkl"
    if path.exists():
        return _load(path)
    scene = Scene.build(m.polygons(), m.width, m.height)
    index = build_ehl(scene, cfg["cell_size"], graph=build_visgraph(scene))
    _dump(index, path)
    return index


def history_scores(cfg: dict, m: Map, index) -> np.ndarray:
    """The port's workload-aware scores s(c) = 1 + w_c of the configuration's
    history: ``history_pairs`` pairs that the benchmark's own sampler draws
    from ``history_seed``, every one in the hot spots (the paper's history
    is pure Cluster-k; its Mixed-y deviation is of the served traffic)."""
    from repro_torch.core.workload import QuerySet, workload_scores

    wa = cfg["workload_aware"]
    spec = {"distribution": "cluster", "clusters": cfg["clusters"],
            "adherence": 1.0}
    s, t = traffic.endpoints(spec, m, wa["history_pairs"],
                             traffic.rng(wa["history_seed"], traffic.HISTORY))
    return workload_scores(index, QuerySet("history", s, t))


def host_index(cell: Cell, m: Map):
    """The configuration's host ``EHLIndex``: loaded from the cache in the
    benchmark's folder, or merged from the map's uncompressed index
    (:func:`base_index`) to the configuration's budget, under its history's
    scores, with the paper's Eq. 5 weight :data:`ALPHA`, where it has a
    ``workload_aware`` block, and cached.  Returns (index, built)."""
    from repro_torch.core.compression import compress_to_fraction

    cfg = cell.config
    cache = cell.data / ".cache"
    path = cache / f"ehl-{index_key(cfg)}.pkl"
    if path.exists():
        return _load(path), False
    index = base_index(cfg, m, cache)
    kw = {}
    if "workload_aware" in cfg:
        kw = {"cell_scores": history_scores(cfg, m, index), "alpha": ALPHA}
    compress_to_fraction(index, cfg["budget"], **kw)
    _dump(index, path)
    return index, True


class Served:
    """The system under test, set up for one cell."""

    def __init__(self, cell: Cell, m: Map, device, trace: bool):
        from repro_torch import obs
        from repro_torch.core.packed import pack_bucketed, slab_layout
        from repro_torch.serving.engine import PathServer
        from repro_torch.serving.query_engine import make_engine

        cfg = cell.config
        t0 = time.perf_counter()
        self.host, self.built = host_index(cell, m)
        t1 = time.perf_counter()
        art = pack_bucketed(self.host, layout=slab_layout(cfg["layout"]),
                            device=device)
        self.device_bytes = art.device_bytes()
        self.index_s = time.perf_counter() - t0
        self.host_s = t1 - t0
        tel = (obs.Telemetry(sample_rate=1.0, span_capacity=1 << 21)
               if trace else obs.Telemetry())
        self.srv = PathServer(make_engine(art, backend=cfg["engine"]),
                              batch_size=cfg["batch"], telemetry=tel)
        self.registry = tel.registry
        self.spans = tel.spans


# ------------------------------------------------------------- the window
class Window:
    """What a window served.  Requests are numbered in the order they were
    sent: ``order[i]`` is the traffic's request that ``i`` stood for (a
    closed loop reuses its pool when it runs out), ``answers[i]`` is
    ``(order[i], distances)``, ``paths[i]`` its polylines where kept, and
    ``latency[i]`` its seconds.  A traced window is cut: the spans and
    counters are read over the part before ``cut`` (``traces``, ``reg0`` to
    ``reg1``), the profiler runs over the rest (``prof``), so neither reads
    the other's cost."""

    def __init__(self, n: int = 0):
        self.latency = np.zeros(n)
        self.done = np.zeros(n)         # seconds from the start, closed loop
        self.order: list = []
        self.answers: dict = {}
        self.paths: dict = {}
        self.shed = 0
        self.missing = 0
        self.lateness = None
        self.seconds = 0.0
        self.prof = None                    # (profiler, wall seconds)
        self.prof_requests: list = []       # traffic requests under it
        self.reg0: dict = {}
        self.reg1: dict = {}
        self.traces: list = []


class Tracer:
    """The traced window's cut: at ``cut`` (a perf_counter stamp, polled
    between requests) it reads the spans and the registry, then starts
    ``torch.profiler``; :meth:`close` stops it."""

    def __init__(self, served: "Served | None", cut: float):
        self.served, self.cut = served, cut
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.active = False

    def poll(self, w: Window, now: float) -> None:
        if self.served is None or self.prof is not None or now < self.cut:
            return
        w.traces = self.served.spans.traces()
        w.reg1 = _registry_values(self.served.registry)
        self.prof = profiler()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def close(self, w: Window) -> None:
        if self.served is not None and self.prof is None:
            w.traces = self.served.spans.traces()     # never cut
            w.reg1 = _registry_values(self.served.registry)
        if not self.active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.active = False
        w.prof = (self.prof, self.t1 - self.t0)


def profiler():
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CPU] + ([act.CUDA] if torch.cuda.is_available()
                                else []), acc_events=True)


def _tracer(served, trace: bool, t_start: float, seconds: float) -> Tracer:
    cut = t_start + max(2 * seconds / 3, seconds - PROFILE_S)
    return Tracer(served if trace else None, cut)


def _registry_values(reg) -> dict:
    from repro_torch.obs.metrics import Histogram

    out = {}
    for m in reg.metrics():
        key = (m.name, m.labels)
        out[key] = (m.sum, m.count) if isinstance(m, Histogram) \
            else (m.value, 0)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def closed_loop(served: "Served", wl: dict, reqs, seconds: float,
                trace: bool, keep_every: int, device, warm: bool = False
                ) -> Window:
    """One client, each request sent when the previous one returned, until
    ``seconds`` have passed (``warm``: every request of ``reqs`` once).
    The polylines of every ``keep_every``-th request are kept."""
    srv = served.srv
    paths = wl["entry"] == "query_paths"
    w = Window()
    lat, done = [], []
    t_start = time.perf_counter()
    tr = _tracer(served, trace and not warm, t_start, seconds)
    i = 0
    while True:
        now = time.perf_counter()
        if (warm and i == reqs.n) or (not warm and now - t_start >= seconds):
            break
        tr.poll(w, now)
        k = i % reqs.n
        s, t = reqs.pairs(k)
        a = time.perf_counter()
        if paths:
            d, p = srv.query_paths(s, t, host_index=served.host)
        else:
            d = srv.query(s, t)
        b = time.perf_counter()
        lat.append(b - a)
        done.append(b - t_start)
        if tr.active:
            w.prof_requests.append(k)
        w.order.append(k)
        w.answers[i] = (k, d)
        if paths and i % keep_every == 0:
            w.paths[i] = p
        i += 1
    _sync(device)
    w.seconds = time.perf_counter() - t_start
    tr.close(w)
    w.latency = np.array(lat)
    w.done = np.array(done)
    return w


def _wait_until(due: float) -> float:
    while True:
        now = time.perf_counter()
        left = due - now
        if left <= 0:
            return now
        time.sleep(left - 1e-4 if left > 2e-4 else 0)


def open_loop(served: "Served", wl: dict, reqs, seconds: float, trace: bool,
              device) -> Window:
    """Requests submitted to the batcher as they fall due; each timed from
    its due time to its ticket's answer (a shed or unanswered request until
    the harness stops waiting, :data:`LATE_S` past the window's close).
    Answered tickets are let go as they finish, as a client does: a window
    that held every ticket would grow the heap that each full collection
    of the garbage collector scans."""
    from repro_torch.serving.batcher import QueueFull

    srv = served.srv
    w = Window(reqs.n)
    pending: collections.deque = collections.deque()
    shed = []
    late = np.zeros(reqs.n)
    t_start = time.perf_counter() + 0.01
    tr = _tracer(served, trace, t_start, seconds)
    for i in range(reqs.n):
        due = t_start + reqs.due[i]
        tr.poll(w, _wait_until(due))
        s, t = reqs.pairs(i)
        late[i] = time.perf_counter() - due
        try:
            pending.append((i, srv.submit(s, t)))
        except QueueFull:
            shed.append(i)
        if tr.active:
            w.prof_requests.append(i)
        while pending and pending[0][1].done:
            _answered(w, reqs, t_start, *pending.popleft())
    _wait_until(t_start + seconds)
    tr.close(w)
    give_up = t_start + seconds + LATE_S
    for i, tk in pending:
        if not tk.wait(timeout=max(0.0, give_up - time.perf_counter())):
            w.missing += 1
            w.latency[i] = give_up - (t_start + reqs.due[i])
        else:
            _answered(w, reqs, t_start, i, tk)
    for i in shed:
        w.latency[i] = give_up - (t_start + reqs.due[i])
    w.shed = len(shed)
    _sync(device)
    w.seconds = seconds
    w.lateness = late
    w.order = list(range(reqs.n))
    return w


def _answered(w: Window, reqs, t_start: float, i: int, tk) -> None:
    w.latency[i] = tk.completed_at - (t_start + reqs.due[i])
    w.answers[i] = (i, tk.result())


class GcWatch:
    """The garbage collector's pauses while a window runs, by generation."""

    def __init__(self):
        self.pauses = {0: [], 1: [], 2: []}
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(
                time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def summary(self) -> str:
        return "; ".join(
            f"gen{g} {len(v)} collections, max {1e3 * max(v, default=0):.3f}"
            f" ms, sum {1e3 * sum(v):.3f} ms" for g, v in self.pauses.items())


# --------------------------------------------------------------- metrics
class Context:
    """What a per-layer reader may read about the traced window: the
    set-up's timings, the spans and registry before the cut, the device
    trace after it (None where no profiler ran) and the yardstick's least
    seconds of the profiled requests' kernel work."""

    def __init__(self, served: Served, window: Window, dtrace, bounds: dict):
        self.setup_index_s = served.index_s
        self.index_device_bytes = served.device_bytes
        self.traces = window.traces
        self.device_trace = dtrace
        self.bounds = bounds
        self._reg0, self._reg1 = window.reg0, window.reg1

    def delta(self, name: str, **labels) -> float:
        """Change over the window of a registry family (a counter's value,
        a histogram's sum), summed over the series whose labels hold
        ``labels``."""
        want = set(labels.items())
        return sum(v[0] - self._reg0.get((n, lbl), (0.0, 0))[0]
                   for (n, lbl), v in self._reg1.items()
                   if n == name and want <= set(lbl))


def _p(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def halves(w: Window, reqs) -> str:
    """Queries/s and p95 ms of each half of the window (closed loop: by
    the time a request returned; open loop: by its due time), to tell noise
    within a run from noise between runs."""
    half = w.seconds / 2
    if reqs.due is not None:
        first = reqs.due[:len(w.latency)] < half
    else:
        first = w.done < half
    sizes = np.array([reqs.size(k) for k in w.order], np.float64)
    out = []
    for part in (first, ~first):
        if not part.any():
            return "empty half"
        out.append(f"{sizes[part].sum() / half:.1f} queries/s p95 "
                   f"{1e3 * _p(w.latency[part], 95):.4f} ms")
    return "; ".join(out)


def end_to_end(cell: Cell, w: Window, answered: int, setup_s: float,
               peak: int) -> dict:
    vals = {"qps": ("queries/s", answered / w.seconds),
            "p95_ms": ("ms", 1e3 * _p(w.latency, 95)),
            "peak_mem_mib": ("MiB", peak / 2 ** 20),
            "setup_s": ("s", setup_s)}
    out = {}
    for m in cell.end_to_end:
        unit, v = vals[m["name"]]
        out[m["name"]] = {"value": v, "unit": unit}
    return out


# ------------------------------------------------------------------- run
def device_record(device, count: int, peak: int) -> dict:
    dev = torch.device(device)
    rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "count": count, "memory_peak_bytes": int(peak)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "--id=0"],
                             capture_output=True, text=True, timeout=20)
        rec["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return rec


def sample(keys: list, size, g: np.random.Generator, pairs: int) -> list:
    """Keys drawn from the seed until they hold ``pairs`` pairs."""
    keys = sorted(keys)             # in request order, however they came
    g.shuffle(keys)
    out, n = [], 0
    for k in keys:
        if n >= pairs:
            break
        out.append(k)
        n += size(k)
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda") -> tuple[dict, list]:
    """One run; returns (result line, [(check, value, limit)])."""
    cfg, wl = cell.config, cell.workload
    m = Map(cfg["map"])
    reqs = traffic.make(wl, m, seconds, traffic.rng(seed, traffic.TRAFFIC))
    warm_g = traffic.rng(seed, traffic.WARMUP)
    keep_every = int(wl.get("keep_every", 1))
    served = Served(cell, m, device, trace)
    print(f"setup: index {'built' if served.built else 'cached'}, host "
          f"{served.host_s:.3f} s, index+pack {served.index_s:.3f} s, "
          f"device bytes {served.device_bytes}", flush=True)
    srv = served.srv
    srv.warmup(paths=wl["entry"] == "query_paths")
    if wl["loop"] == "open":
        srv.start_async(**wl["batcher"])
        open_loop(served, wl, traffic.open_schedule(
            wl, m, OPEN_WARMUP_S, warm_g), OPEN_WARMUP_S, False, device)
    else:
        warm = traffic.Requests(*_head(traffic.closed(wl, m, 0, warm_g), 2))
        closed_loop(served, wl, warm, 0, False, 1, device, warm=True)
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    settle()
    if trace:           # the profiler's first start is slow: not in the window
        with profiler():
            torch.zeros(1, device=device).add_(1)
            _sync(device)
    served.spans.clear()
    reg0 = _registry_values(served.registry) if trace else {}
    setup_s = time.perf_counter() - t0
    print(f"setup_s {setup_s:.3f}", flush=True)
    ru0 = resource.getrusage(resource.RUSAGE_SELF)

    with GcWatch() as gcw:
        if wl["loop"] == "open":
            w = open_loop(served, wl, reqs, seconds, trace, device)
        else:
            w = closed_loop(served, wl, reqs, seconds, trace, keep_every,
                            device)
    print(f"garbage collector in the window: {gcw.summary()}", flush=True)
    if wl["loop"] == "open":
        srv.stop_async()
        print(f"open loop: {reqs.n} requests at {wl['rate_per_s']} /s, "
              f"shed {w.shed}, missing {w.missing}; generator late mean "
              f"{1e3 * w.lateness.mean():.4f} ms, p95 "
              f"{1e3 * _p(w.lateness, 95):.4f} ms, max "
              f"{1e3 * w.lateness.max():.4f} ms", flush=True)
    else:
        cycled = len(w.order) > reqs.n
        print(f"closed loop: {len(w.order)} requests in {w.seconds:.3f} s"
              f"{' (pool of ' + str(reqs.n) + ' reused)' if cycled else ''}",
              flush=True)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    print(f"halves: {halves(w, reqs)}", flush=True)
    print(f"window host: user {ru1.ru_utime - ru0.ru_utime:.3f} s, sys "
          f"{ru1.ru_stime - ru0.ru_stime:.3f} s of {w.seconds:.3f} s",
          flush=True)
    w.reg0 = reg0
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    result_metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        result_metrics, breakdown, dev_extra = per_layer(
            cell, served, w, reqs, m, device)
    del served, srv
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the check: the reference on a sample of the window's answers
    g = traffic.rng(seed, traffic.SAMPLE)
    size = lambda i: reqs.size(w.answers[i][0])   # noqa: E731
    idx = sample(w.answers, size, g, wl["check_pairs"])
    pick = lambda sel, j: np.concatenate(         # noqa: E731
        [np.zeros((0, 2), np.float32)]
        + [reqs.pairs(w.answers[i][0])[j] for i in sel])
    paths = None
    if wl["entry"] == "query_paths":
        paths = [(reqs.pairs(w.answers[i][0]), w.paths[i]) for i in
                 sample(w.paths, size, g, wl["check_paths"])]
    ref = Reference(m.rects, "f64", device)
    checks = compare(cfg, ref, pick(idx, 0), pick(idx, 1),
                     np.concatenate([np.zeros(0, np.float32)]
                                    + [w.answers[i][1] for i in idx]),
                     paths=paths,
                     missing=w.missing if wl["loop"] == "open" else None)
    correct = all(v <= lim for _, v, lim in checks)
    answered = sum(reqs.size(w.answers[i][0]) for i in w.answers)
    n_req = len(w.order)
    e2e = end_to_end(cell, w, answered, setup_s, peak)
    result = {"correct": bool(correct), "attempted": n_req,
              "failed": int(w.shed + w.missing),
              "metrics": result_metrics if trace else e2e,
              "device": {**device_record(device, cell.chips, peak),
                         **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": _finite(v), "limit": lim}
                        for n, v, lim in checks}
    return result, checks


def settle() -> None:
    """End set-up as a long-running Python server does: collect, then
    freeze what set-up left (torch, the index, the server) out of the
    collector's sight, so that a full collection scans only what serving
    makes (without it one takes ~90 ms over the ~170k set-up objects)."""
    gc.collect()
    gc.freeze()


def _head(reqs, n: int) -> tuple:
    lo = reqs.lo[:n + 1]
    return reqs.s[:lo[-1]], reqs.t[:lo[-1]], lo


def _finite(v: float) -> float:
    return float(v) if math.isfinite(v) else 1e300


def per_layer(cell: Cell, served: Served, w: Window, reqs, m: Map, device):
    dtrace, bounds, dev = None, {}, {}
    if w.prof is not None:
        prof, wall = w.prof
        dtrace = yardstick.DeviceTrace(prof, wall)
        dev = {"busy_s": dtrace.busy_s, "window_s": wall}
        if w.prof_requests:
            s = np.concatenate([reqs.pairs(k)[0] for k in w.prof_requests])
            t = np.concatenate([reqs.pairs(k)[1] for k in w.prof_requests])
            bounds = yardstick.bound_seconds(
                yardstick.RegionTable(served.host), m.rects,
                cell.config["layout"], s, t, device)
    ctx = Context(served, w, dtrace, bounds)
    out = {}
    for spec in cell.per_layer:
        v = load_metric(cell.data, spec["name"]).read(ctx)
        if v is not None:
            out[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    breakdown = None
    if dtrace is not None:
        breakdown = {"device_ops": dtrace.top_ops(10),
                     "idle_gaps": dtrace.idle_gaps}
    return out, breakdown, dev


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def main(args, t0: float) -> int:
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, checks = run(cell, args.seed, float(args.seconds),
                         bool(args.trace), t0, device="cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
