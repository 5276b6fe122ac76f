"""End-to-end serving driver of the PyTorch/CUDA port: an EHL* index
answering batched ESPP queries on an NVIDIA GPU (or on the CPU, through
the kernels' plain twins).

Builds the index under a memory budget, packs it for the device
(width-bucketed by default, one global slab with ``--layout slab``), then
serves a stream of queries through a ``torch`` (plain twins) or ``cuda``
(Hopper kernels) engine and reports throughput and per-bucket routing
stats — the paper's online phase as a service:

    python examples/pathfind_serve_torch.py --paths 64 --serve-async
    PYTHONPATH=src python examples/pathfind_serve_torch.py --device cpu \\
        --map rooms-S --queries 64 --batch 16 --paths 8 --serve-async

``--clusters K`` compresses workload-aware: the Eq. 5 scores come from a
2000-query Cluster-K history (``workload_scores``, alpha 0.2).

``--adaptive`` instead runs the closed-loop demo (DESIGN.md §8): serve a
clustered workload, shift it mid-run, and watch the index manager capture
the live distribution, recompress under the device-byte budget and
hot-swap the artifact with zero downtime:

    PYTHONPATH=src python examples/pathfind_serve_torch.py --device cpu \\
        --adaptive --map rooms-S --queries 250 --budget 0.4 --rounds 6

Self-checks (exit non-zero on failure): a second pass answers bit for bit
as the first; ``--paths N`` unwinds N paths from the batched argmin and
requires ``|len(path) - d| <= 1e-4 * max(1, d)``; ``--quantize`` requires
the device-byte drop, distances within 2*qerr of the f32 engine and argmin
winners equal to it bit for bit; ``--serve-async`` serves a burst and a
trickle through the continuous batcher and requires answers equal to the
synchronous path's bit for bit, at least one full-batch flush and one
deadline flush; ``--adaptive`` requires at least ``--min-swaps`` swaps, no
failed probe validation, probe answers equal across every swap boundary
(within the quantization bounds with ``--quantize``) and every artifact
within the budget, and with ``--serve-async`` ends with the async check on
the final generation.  ``--backend cuda`` (and the default ``--device
cuda``) exits non-zero without a card.

``--metrics`` exports the telemetry (DESIGN.md §12) on exit —
``telemetry.prom``, ``telemetry.json`` and ``events.jsonl`` under
``--metrics-dir`` — with the profile capture (DESIGN.md §13) installed
before the first warmup, and self-checks the export: the Prometheus text
round-trips, ``serve_queries_total`` is above 0, ``entry_cold_total`` is
present (and on the card ``kernel_cost_ops_total``), every shard's
``shard_slots_total`` with ``--shards``, and swap events, ``builds_total``
and ``build_stage_ms`` with ``--adaptive``:

    PYTHONPATH=src python examples/pathfind_serve_torch.py --device cpu \
        --map rooms-S --queries 64 --batch 16 --paths 8 --serve-async \
        --metrics --metrics-dir build/telemetry

``--shards N`` serves through the region-sharded engine (DESIGN.md §9):
the bucketed slabs are planned onto N shards, one per card where the
machine has N cards (``launch.mesh.make_serving_mesh``), else round-robin
onto the cards there are (all on ``cuda:0`` on a one-card machine; on the
CPU with ``--device cpu``); batches route by (shard, shard, width), and
the answers must equal the single-device engine's bit for bit and every
shard must stay within ``--shard-tol`` times its fair share of the bytes:

    python examples/pathfind_serve_torch.py --shards 4 --serve-async
    PYTHONPATH=src python examples/pathfind_serve_torch.py --device cpu \
        --shards 4 --map rooms-S --queries 96 --batch 32 --budget 0.3

``--shards`` combines with ``--adaptive``: each swap republishes every
shard under one generation.
"""

import argparse
import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.core import (build_ehl, build_visgraph,  # noqa: E402
                              bucketed_device_bytes, cluster_queries,
                              compress_to_fraction, make_map, pack_bucketed,
                              pack_index, path_length, plan_buckets,
                              slab_device_bytes, slab_layout, uniform_queries,
                              workload_scores)
from repro_torch.core.packed import (LAYOUT_F32, empty_results,  # noqa
                                     resolve_device)
from repro_torch.indexing import IndexManager  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.serving import (PathServer, expected_join_cost,  # noqa
                                 make_engine)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--map", default="rooms-M")
    ap.add_argument("--budget", type=float, default=0.2)
    ap.add_argument("--clusters", type=int, default=0,
                    help="workload-aware compression from a Cluster-K "
                         "history (0: uniform scores)")
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--layout", choices=("bucketed", "slab"),
                    default="bucketed",
                    help="device layout: width-bucketed slabs or the single "
                         "global-Lmax slab")
    ap.add_argument("--backend", choices=("cuda", "torch", "host"),
                    default="cuda",
                    help="query engine: Hopper kernels (twins on CPU "
                         "tensors), the plain twins, or the float64 oracle")
    ap.add_argument("--device", default="cuda",
                    help="where the slabs live: cuda (needs a card) or cpu")
    ap.add_argument("--quantize", choices=("off", "bf16", "f16"),
                    default="off",
                    help="serve quantized label slabs (DESIGN.md §11) and "
                         "check them against the f32 engine")
    ap.add_argument("--quantize-min-drop", type=float, default=1.8,
                    help="[quantize] required f32/quantized device-byte "
                         "ratio")
    ap.add_argument("--paths", type=int, default=0,
                    help="also unwind N paths from the batched argmin and "
                         "check their lengths")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve through N region shards (DESIGN.md §9), "
                         "one per card or round-robin onto the cards there "
                         "are")
    ap.add_argument("--shard-tol", type=float, default=1.15,
                    help="[shards] per-shard byte cap as a multiple of "
                         "total/num_shards")
    ap.add_argument("--serve-async", action="store_true",
                    help="also serve through the continuous batcher and "
                         "check it bit for bit against the synchronous path")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive serving demo: live workload capture -> "
                         "budgeted recompression -> zero-downtime hot swap "
                         "(repro_torch.indexing); shifts the workload "
                         "mid-run")
    ap.add_argument("--rounds", type=int, default=8,
                    help="[adaptive] serving rounds (the workload shifts "
                         "at the midpoint)")
    ap.add_argument("--min-swaps", type=int, default=1,
                    help="[adaptive] exit non-zero unless at least this "
                         "many hot swaps were published")
    ap.add_argument("--async-swap", action="store_true",
                    help="[adaptive] build/validate/swap on a background "
                         "thread instead of between rounds")
    ap.add_argument("--metrics", action="store_true",
                    help="export telemetry.prom, telemetry.json and "
                         "events.jsonl under --metrics-dir on exit and "
                         "self-check the export")
    ap.add_argument("--metrics-dir", default=str(ROOT / "build" / "telemetry"),
                    help="[metrics] output directory")
    args = ap.parse_args(argv)
    if not args.metrics:
        return run(args)
    # the cold-entry and kernel-cost attribution rides along with the
    # export; installed before the first warmup, so the warmup's cold keys
    # are attributed, and uninstalled on the way out
    obs.enable_profile()
    try:
        return run(args)
    finally:
        obs.disable_profile()


def run(args) -> int:
    backend = args.backend
    if backend != "host":
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if backend == "host" and (args.quantize != "off" or args.adaptive):
        print("error: --quantize and --adaptive need a device backend "
              "(torch | cuda)", file=sys.stderr)
        return 2
    if args.shards > 1 and (backend == "host" or args.layout == "slab"):
        print("error: --shards needs a device backend (torch | cuda) and "
              "the bucketed layout", file=sys.stderr)
        return 2
    if args.adaptive:
        return run_adaptive(args, backend)
    if args.shards > 1:
        return run_sharded(args, backend)

    scene = make_map(args.map, seed=0)
    graph = build_visgraph(scene)
    index = build_ehl(scene, cell_size=2.0, graph=graph)
    full_mb = index.label_memory() / 1e6
    scores, alpha = None, 0.0
    if args.clusters > 0:
        hist = cluster_queries(scene, graph, args.clusters, 2000, seed=9,
                               require_path=False)
        scores, alpha = workload_scores(index, hist), 0.2
    stats = compress_to_fraction(index, args.budget, cell_scores=scores,
                                 alpha=alpha)
    print(f"index: {full_mb:.1f} MB -> {stats.final_bytes / 1e6:.1f} MB "
          f"({args.budget:.0%} budget, workload-aware={args.clusters > 0})")

    # only the layout that serves is materialized on the device; the other
    # side of the comparison is the analytic estimate
    slab = args.layout == "slab"
    dev = args.device
    art = None
    if backend != "host":
        art = pack_index(index, device=dev) if slab \
            else pack_bucketed(index, device=dev)
    slab_bytes = art.device_bytes() if slab and art is not None \
        else slab_device_bytes(index)
    bucket_bytes = art.device_bytes() if not slab and art is not None \
        else bucketed_device_bytes(index)
    counts, widths, region_bucket = plan_buckets(index)
    print(f"slab layout:     {len(index.regions)} regions, "
          f"{slab_bytes / 1e6:.3f} MB on device")
    print(f"bucketed layout: widths={widths}, "
          f"{bucket_bytes / 1e6:.3f} MB on device "
          f"({slab_bytes / max(1, bucket_bytes):.2f}x smaller)")
    counts = np.asarray(counts)
    for k, w in enumerate(widths):
        m = region_bucket == k
        used, total = counts[m].sum(), max(1, m.sum()) * w
        print(f"  bucket {k}: width={w:5d} regions={int(m.sum()):5d} "
              f"waste={1 - used / total:.1%}")

    engine = make_engine(index if art is None else art, backend=backend,
                         device=dev)
    eng32, qerr = None, 0.0
    if args.quantize != "off":
        lay = slab_layout(args.quantize)
        artq = pack_index(index, layout=lay, device=dev) if slab \
            else pack_bucketed(index, layout=lay, device=dev)
        drop = art.device_bytes() / artq.device_bytes()
        qerr = float(artq.qerr)
        qs_ = artq.quant_stats()
        print(f"quantized[{args.quantize}]: "
              f"{artq.device_bytes() / 1e6:.3f} MB on device "
              f"({drop:.2f}x smaller), qerr={qerr:.2e}, "
              f"id_fallback={qs_['id_fallback']} "
              f"vid_fallback={qs_['vid_fallback']} "
              f"dist_fallback={qs_['dist_fallback']}")
        eng32 = engine                  # the f32 engine the gate holds to
        engine = make_engine(artq, backend=backend, device=dev)
        if drop < args.quantize_min_drop:
            print(f"QUANTIZED SMOKE FAILED:\n  byte drop {drop:.2f}x < "
                  f"required {args.quantize_min_drop:.2f}x")
            return 1

    qs = uniform_queries(scene, graph, args.queries, seed=33,
                         require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    srv = PathServer(engine, batch_size=args.batch)
    srv.warmup(paths=args.paths > 0)
    d = srv.query(s, t)
    print(f"served {srv.stats.queries} queries in {srv.stats.seconds:.3f}s "
          f"-> {srv.stats.us_per_query:.1f} us/query "
          f"({srv.stats.qps:,.0f} qps); {int(np.isfinite(d).sum())} "
          f"reachable [layout={args.layout}, backend={backend}, "
          f"device={dev if backend != 'host' else 'host'}]")
    for k, b in sorted(srv.stats.per_bucket.items()):
        print(f"  bucket {k}: width={b.width:5d} queries={b.queries:5d} "
              f"batches={b.batches:3d} occupancy={b.occupancy:.1%} "
              f"{b.us_per_query:.1f} us/query")
    if not np.array_equal(d, srv.query(s, t)):
        print("SMOKE FAILED: a second pass answered differently")
        return 1

    if eng32 is not None:
        failures = check_quantized(engine, eng32, s, t, qerr)
        if failures:
            print("QUANTIZED SMOKE FAILED:\n  " + "\n  ".join(failures))
            return 1
        print("quantized smoke OK: argmin/covis bitwise vs f32, "
              "distances within the 2*qerr bound")

    if args.serve_async:
        failures = check_async(srv, s, t, backend)
        if failures:
            print("ASYNC SMOKE FAILED:\n  " + "\n  ".join(failures))
            return 1

    if args.paths > 0:
        n = min(args.paths, len(s))
        dp, paths = srv.query_paths(s[:n], t[:n], host_index=index)
        err = max((abs(path_length(p) - float(di)) / max(1.0, float(di))
                   for di, p in zip(dp, paths) if np.isfinite(di)),
                  default=0.0)
        print(f"extracted {n} paths via batched argmin ({backend}); "
              f"max |len(path) - d| / max(1, d) = {err:.2e}")
        if err > 1e-4 + 2 * qerr:
            print("PATHS SMOKE FAILED: path lengths disagree with d")
            return 1
    print(f"served in all: {srv.stats.queries} queries")
    if args.metrics:
        failures = dump_metrics(args, srv.telemetry, server=srv,
                                on_card=backend == "cuda"
                                and resolve_device(dev).type == "cuda")
        if failures:
            print("METRICS SMOKE FAILED:\n  " + "\n  ".join(failures))
            return 1
    return 0


def serving_mesh_or_none(num_shards: int, device):
    """One card per shard when the machine has them, else None (the shards
    round-robin onto the devices of ``device``'s type)."""
    if resolve_device(device).type != "cuda":
        return None
    try:
        return make_serving_mesh(num_shards)
    except ValueError as e:
        print(f"note: {e}")
        return None


def run_sharded(args, backend: str) -> int:
    """Sharded serving smoke: answers must equal the single-device engine's
    bit for bit (distances and, with ``--paths``, the argmin path) and
    every shard must stay within the per-shard byte cap."""
    from repro_torch.sharding import ShardedQueryEngine, ShardPlanner

    dev = args.device
    scene = make_map(args.map, seed=0)
    graph = build_visgraph(scene)
    index = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(index, args.budget)
    mesh = serving_mesh_or_none(args.shards, dev)
    lay = None if args.quantize == "off" else slab_layout(args.quantize)
    planner = ShardPlanner(args.shards, tol=args.shard_tol)
    plan = planner.plan(index)
    devices = list(mesh) if mesh is not None else dev
    sharded = planner.build(index, plan, device=devices)
    eng = ShardedQueryEngine(sharded, mesh=mesh, backend=backend)
    bx = pack_bucketed(index, device=sharded.devices[0])
    single = make_engine(bx, backend=backend)
    eng_q, qerr = None, 0.0
    if lay is not None:
        sharded_q = ShardPlanner(args.shards, tol=args.shard_tol,
                                 layout=lay).build(index, plan,
                                                   device=devices)
        eng_q = ShardedQueryEngine(sharded_q, mesh=mesh, backend=backend)
        qerr = max(float(b.qerr) for b in sharded_q.shards)

    per = sharded.per_shard_bytes()
    print(f"sharded: {args.shards} shards on "
          f"{sorted({str(d) for d in sharded.devices})}, plan moves="
          f"{plan.moves}; bytes: total={sharded.device_bytes() / 1e6:.3f} "
          f"MB (single-device {bx.device_bytes() / 1e6:.3f} MB), "
          f"imbalance={sharded.imbalance():.3f}")

    qs = uniform_queries(scene, graph, args.queries, seed=33,
                         require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    srv1 = PathServer(single, batch_size=args.batch)
    srv1.warmup(paths=args.paths > 0)
    ref = srv1.query(s, t)
    srv2 = PathServer(eng, batch_size=args.batch)
    srv2.warmup(paths=args.paths > 0)
    out = srv2.query(s, t)
    print(f"  single-device: {srv1.stats.us_per_query:.1f} us/query; "
          f"sharded: {srv2.stats.us_per_query:.1f} us/query "
          f"({srv2.stats.qps:,.0f} qps)")
    for st in srv2.stats.per_shard:
        print(f"  shard {st.shard}: [{st.device}] regions={st.regions} "
              f"bytes={st.device_bytes / 1e6:.3f}MB occ={st.occupancy:.0%} "
              f"batches={st.batches} slots={st.slots} "
              f"gathers_out={st.gathers_out} "
              f"covis_assists={st.covis_assists} "
              f"{st.us_per_slot:.1f} us/slot")

    failures = []
    if not np.array_equal(ref, out):
        failures.append(f"{int((ref != out).sum())} answers differ from the "
                        "single-device engine")
    cap = args.shard_tol * sharded.device_bytes() / args.shards
    if max(per) > cap:
        failures.append(f"max shard {max(per)}B over the per-shard cap "
                        f"{cap:.0f}B")
    if args.paths > 0:
        n = min(args.paths, len(s))
        a = srv1._dispatch(s[:n], t[:n], want_argmin=True)
        b = srv2._dispatch(s[:n], t[:n], want_argmin=True)
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            failures.append("argmin outputs differ from the single-device "
                            "engine")
        dp, paths = srv2.query_paths(s[:n], t[:n], host_index=index)
        err = max((abs(path_length(p) - float(di)) / max(1.0, float(di))
                   for di, p in zip(dp, paths) if np.isfinite(di)),
                  default=0.0)
        print(f"extracted {n} paths via the sharded argmin; max "
              f"|len(path) - d| / max(1, d) = {err:.2e}")
        if err > 1e-4:
            failures.append("path lengths disagree with d")
    if eng_q is not None:
        drop = sharded.device_bytes() / sharded_q.device_bytes()
        print(f"  quantized[{args.quantize}]: "
              f"{sharded_q.device_bytes() / 1e6:.3f} MB total "
              f"({drop:.2f}x smaller), qerr={qerr:.2e}")
        if drop < args.quantize_min_drop:
            failures.append(f"quantized byte drop {drop:.2f}x < required "
                            f"{args.quantize_min_drop:.2f}x")
        failures += check_quantized(eng_q, eng, s, t, qerr)
    if args.serve_async:
        failures += check_async(srv2, s, t, "sharded")
    if args.metrics:
        failures += dump_metrics(args, srv2.telemetry, server=srv2,
                                 expect_shards=args.shards,
                                 on_card=backend == "cuda"
                                 and resolve_device(dev).type == "cuda")
    if failures:
        print("SHARDED SMOKE FAILED:\n  " + "\n  ".join(failures))
        return 1
    print(f"sharded smoke OK: {len(s)} answers bitwise-identical to the "
          f"single-device engine, per-shard bytes within "
          f"{args.shard_tol:.2f}x of fair share")
    return 0


def run_adaptive(args, backend: str) -> int:
    """Closed-loop demo: the served workload shifts mid-run and the index
    manager recompresses and hot-swaps to follow it, holding the device-byte
    budget throughout.  Returns non-zero unless at least ``--min-swaps``
    swaps happened with probe answers stable across every swap boundary."""
    dev = args.device
    scene = make_map(args.map, seed=0)
    graph = build_visgraph(scene)
    index = build_ehl(scene, cell_size=2.0, graph=graph)
    lay = None if args.quantize == "off" else slab_layout(args.quantize)
    budget = int(bucketed_device_bytes(index) * args.budget)
    shard_kw = {}
    if args.shards > 1:
        from repro_torch.sharding import sharded_overhead_bytes

        budget += sharded_overhead_bytes(
            index, args.shards, layout=lay if lay is not None else LAYOUT_F32)
        shard_kw = dict(num_shards=args.shards, shard_tol=args.shard_tol,
                        mesh=serving_mesh_or_none(args.shards, dev))
    # validate_tol=0: a candidate goes live only if its probe answers equal
    # the live artifact's bit for bit (quantized layouts widen it by the two
    # generations' quantization bounds), the criterion checked below
    # one Telemetry across the manager and the server, so swap and drift
    # events and the serving series land in one export
    tel = obs.Telemetry()
    mgr = IndexManager(index, budget, backend=backend, device=dev,
                       batch_size=args.batch,
                       min_queries=max(64, args.queries // 4),
                       replan_threshold=0.10, min_dwell=1, probe_n=64,
                       seed=17, validate_tol=0.0, layout=lay, telemetry=tel,
                       **shard_kw)
    k = max(2, args.clusters)
    phases = [cluster_queries(scene, graph, k, args.queries, seed=seed,
                              require_path=False) for seed in (101, 202)]
    s2 = phases[1].s.astype(np.float32)
    t2 = phases[1].t.astype(np.float32)
    # the uniform-score generation's join cost, taken now so that no
    # reference to generation 0 outlives its swap
    jc_uni = expected_join_cost(mgr.engine.current, s2, t2)
    srv = PathServer(mgr.engine, batch_size=args.batch,
                     recorder=mgr.recorder, telemetry=tel)
    srv.warmup()
    print(f"adaptive: budget={budget / 1e6:.3f} MB (x{args.budget:.2f} of "
          f"the uncompressed artifact), initial device="
          f"{mgr.device_bytes() / 1e6:.3f} MB, backend={backend}, "
          f"device={dev}")

    half = max(1, args.rounds // 2)
    failures = []
    lat = {0: [], 1: []}
    for rnd in range(args.rounds):
        phase = 0 if rnd < half else 1
        qs = phases[phase]
        srv.stats.seconds = 0.0
        srv.stats.queries = 0
        srv.query(qs.s.astype(np.float32), qs.t.astype(np.float32))
        lat[phase].append(srv.stats.us_per_query)

        probe_pre = mgr.probe_answers()
        qe_pre = mgr._qerr_of(mgr.engine.artifact)
        if args.async_swap:
            gen = mgr.generation
            mgr.maybe_adapt(block=False)
            mgr.join()
            swapped = mgr.generation > gen
        else:
            swapped = mgr.maybe_adapt()
        if swapped:
            probe_post = mgr.probe_answers()
            both_inf = ~np.isfinite(probe_pre) & ~np.isfinite(probe_post)
            diff = np.abs(np.where(both_inf, 0.0, probe_post - probe_pre))
            tol = 2.0 * (qe_pre + mgr._qerr_of(mgr.engine.artifact))
            if not np.all(diff <= tol):
                failures.append(f"round {rnd}: probe answers changed "
                                "across the swap boundary")
            if mgr.device_bytes() > budget:
                failures.append(f"round {rnd}: swapped-in artifact "
                                f"{mgr.device_bytes()}B over budget")
        rec = mgr.history[-1] if swapped else None
        print(f"round {rnd} phase {phase}: "
              f"{srv.stats.us_per_query:8.1f} us/query  "
              f"device={mgr.device_bytes() / 1e6:6.3f} MB  "
              f"gen={mgr.generation}"
              + (f"  SWAP[{rec.kind}] drift={rec.drift:.3f} "
                 f"build={rec.build_s:.2f}s pack={rec.pack_s:.2f}s "
                 f"validate={rec.validate_s:.2f}s "
                 f"probe_err={rec.probe_max_err:.1e}" if swapped else ""))

    jc_adapt = expected_join_cost(mgr.engine.current, s2, t2)
    p50 = {ph: float(np.median(v)) for ph, v in lat.items() if v}
    print(f"phase p50 latency: {p50} us/query")
    print(f"post-swap join cost on the shifted workload: adapted="
          f"{jc_adapt:.0f} vs uniform-score={jc_uni:.0f} (mean dispatch "
          f"width^2; {'better' if jc_adapt <= jc_uni else 'WORSE'})")
    print(f"lifecycle: {mgr.stats()}")
    print(f"serve stats: gen={srv.stats.generation} swaps={srv.stats.swaps} "
          f"stale_batches={srv.stats.stale_batches}")
    if mgr.swaps < args.min_swaps:
        failures.append(f"only {mgr.swaps} swaps, need >= {args.min_swaps}")
    if mgr.validation_failures:
        failures.append(f"{mgr.validation_failures} probe validations "
                        "failed (swap aborted)")
    if args.serve_async:
        failures += check_async(srv, s2, t2, "adaptive")
    if args.metrics:
        failures += dump_metrics(
            args, tel, server=srv, expect_swaps=args.min_swaps,
            expect_shards=args.shards if args.shards > 1 else 0,
            on_card=backend == "cuda" and resolve_device(dev).type == "cuda")
    if failures:
        print("ADAPTIVE SMOKE FAILED:\n  " + "\n  ".join(failures))
        return 1
    print(f"adaptive smoke OK: {mgr.swaps} hot swap(s), answers stable, "
          f"budget held")
    return 0


def dump_metrics(args, telemetry, *, server=None, expect_shards: int = 0,
                 expect_swaps: int = 0, on_card: bool = False) -> list:
    """Export telemetry.prom, telemetry.json and events.jsonl and
    self-check the export (DESIGN.md §12).  Returns failure strings:

    * the Prometheus text must round-trip through ``parse_prometheus``:
      every counter and gauge parses back to its registry value;
    * ``serve_queries_total`` must be present with a nonzero sum, and the
      ``server``'s own row must equal the queries it served;
    * the cold-entry series ``entry_cold_total`` must be present, and on
      the card (``on_card``) the kernel cost series
      ``kernel_cost_ops_total`` of the installed profile capture;
    * sharded runs must export ``shard_slots_total`` for every shard id;
    * adaptive runs must have logged >= ``expect_swaps`` swap events and
      exported ``builds_total`` and the build stage spans
      (``build_stage_ms``).
    """
    out = os.path.abspath(args.metrics_dir)
    os.makedirs(out, exist_ok=True)
    text = obs.prometheus_text(telemetry.registry)
    with open(os.path.join(out, "telemetry.prom"), "w") as f:
        f.write(text)
    with open(os.path.join(out, "telemetry.json"), "w") as f:
        f.write(obs.json_snapshot(telemetry.registry))
    n_events = telemetry.events.dump_jsonl(os.path.join(out, "events.jsonl"))

    failures = []
    try:
        parsed = obs.parse_prometheus(text)
    except ValueError as e:
        return [f"metrics: exported Prometheus text does not parse: {e}"]
    lost = [m.name for m in telemetry.registry.metrics()
            if not isinstance(m, obs.Histogram)
            and parsed.get(m.name, {}).get(tuple(m.labels)) != m.value]
    if lost:
        failures.append(f"metrics: {len(lost)} series do not round-trip "
                        f"through the Prometheus text, e.g. {lost[0]}")
    served = sum(parsed.get("serve_queries_total", {}).values())
    if served <= 0:
        failures.append("metrics: no serve_queries_total series exported")
    if server is not None:
        row = [v for k, v in parsed.get("serve_queries_total", {}).items()
               if dict(k).get("srv") == server.stats.labels["srv"]]
        if row != [server.stats.queries]:
            failures.append(f"metrics: the server's serve_queries_total "
                            f"{row} != the {server.stats.queries} queries "
                            "it served")
    cold = sum(parsed.get("entry_cold_total", {}).values())
    if "entry_cold_total" not in parsed:
        failures.append("metrics: no entry_cold_total series exported")
    if on_card and sum(parsed.get("kernel_cost_ops_total", {}).values()) \
            <= 0:
        failures.append("metrics: no kernel_cost_ops_total series (the "
                        "profile capture saw no kernel launch)")
    if expect_shards > 0:
        shards = {dict(k).get("shard")
                  for k in parsed.get("shard_slots_total", {})}
        missing = {str(i) for i in range(expect_shards)} - shards
        if missing:
            failures.append("metrics: per-shard series missing for "
                            f"shard(s) {sorted(missing)}")
    if expect_swaps > 0:
        swaps = telemetry.events.counts().get("swap", 0)
        if swaps < expect_swaps:
            failures.append(f"metrics: {swaps} swap events in the log, "
                            f"expected >= {expect_swaps}")
        builds = sum(parsed.get("builds_total", {}).values())
        if builds < expect_swaps:
            failures.append(f"metrics: {builds:.0f} builds_total, "
                            f"expected >= {expect_swaps}")
        if sum(parsed.get("build_stage_ms_count", {}).values()) <= 0:
            failures.append("metrics: no build_stage_ms stage spans "
                            "exported for the adaptive build pipeline")
    print(f"metrics: exported {len(parsed)} series ({served:.0f} queries "
          f"served, {cold:.0f} cold entry keys), {n_events} events -> {out}")
    return failures


def engine_argmin(engine, s, t) -> list:
    """Full-batch argmin through any bucket-routed engine (exact shapes)."""
    keys = engine.buckets_of(s, t)
    outs = empty_results(len(s), True)
    for k in np.unique(keys):
        m = keys == k
        res = engine.batch_argmin(s[m], t[m], bucket=int(k))
        for o, r in zip(outs, res):
            o[m] = np.asarray(r)[:int(m.sum())]
    return outs


def check_quantized(eng_q, eng_32, s, t, qerr: float) -> list:
    """The quantized serving gate: distances within 2*qerr of the f32
    engine, argmin winners (covis verdicts and via/hub ids, i.e. the
    unwound paths) equal to it bit for bit.  Returns failure strings."""
    d32, cv32, vs32, hb32, vt32 = engine_argmin(eng_32, s, t)
    dq, cvq, vsq, hbq, vtq = engine_argmin(eng_q, s, t)
    failures = []
    fin = np.isfinite(d32)
    if not np.array_equal(fin, np.isfinite(dq)):
        failures.append("reachability differs from the f32 engine")
    bound = 2.0 * qerr + 1e-4 * np.abs(np.where(fin, d32, 0.0))
    err = np.abs(np.where(fin, dq - d32, 0.0))
    if not np.all(err <= bound + 1e-6):
        failures.append(f"distance error {err.max():.3e} over the "
                        f"2*qerr bound {2 * qerr:.3e}")
    if not np.array_equal(cv32, cvq):
        failures.append("covis verdicts differ from the f32 engine")
    m = ~cv32 & fin                     # rows whose path runs via hubs
    for name, a, b in (("via_s", vs32, vsq), ("hub", hb32, hbq),
                       ("via_t", vt32, vtq)):
        if not np.array_equal(a[m], b[m]):
            failures.append(f"argmin {name} ids differ from the f32 engine")
    return failures


def check_async(srv, s, t, label: str) -> list:
    """Continuous-batching smoke: serve through the coalescing loop and
    compare bit for bit against the synchronous path.

    A *burst* (one submit of more than a batch of queries sharing the
    hottest dispatch key) forces a full flush; a *trickle* (a sub-batch
    submit and no flush) can only ship at its deadline.  Returns failure
    strings (empty = pass).
    """
    bs = srv.batch_size
    with srv.engine.pin() as eng:
        keys = eng.buckets_of(s, t)
    vals, counts = np.unique(keys, return_counts=True)
    hot = np.nonzero(keys == int(vals[np.argmax(counts)]))[0]
    reps = -(-(bs + 1) // len(hot))     # ceil: tile past one full batch
    sb = np.tile(s[hot], (reps, 1))[:bs + len(hot)]
    tb = np.tile(t[hot], (reps, 1))[:bs + len(hot)]
    ref_burst = srv.query(sb, tb)
    ref_trickle = srv.query(s[:8], t[:8])

    srv.start_async(max_wait_ms=2.0)
    got_burst = srv.submit(sb, tb).result(timeout=120)
    got_trickle = srv.submit(s[:8], t[:8]).result(timeout=120)
    srv.stop_async()

    st = srv.stats
    failures = []
    if not np.array_equal(ref_burst, got_burst):
        failures.append(f"{label}: burst answers differ from sync path")
    if not np.array_equal(ref_trickle, got_trickle):
        failures.append(f"{label}: trickle answers differ from sync path")
    if st.full_flushes < 1:
        failures.append(f"{label}: no full-batch flush observed")
    if st.deadline_flushes < 1:
        failures.append(f"{label}: no deadline flush observed")
    bad_occ = {k: b.occupancy for k, b in st.per_bucket.items()
               if b.occupancy > 1.0}
    if bad_occ:
        failures.append(f"{label}: per-bucket occupancy above 1.0: "
                        f"{bad_occ}")
    print(f"async serve [{label}]: submitted={st.submitted} "
          f"flushes full={st.full_flushes} deadline={st.deadline_flushes} "
          f"forced={st.forced_flushes} pipeline_peak={st.pipeline_peak} "
          f"queue_peak={st.queue_depth_peak} "
          f"identical={'yes' if not failures else 'NO'}")
    return failures


if __name__ == "__main__":
    sys.exit(main())
