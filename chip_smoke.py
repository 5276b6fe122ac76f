#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the Hopper kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch twin (``torch.equal``) at every
shape the main path gives it, then drives the main path: rooms-M (seed 0,
cell 2.0) compressed to 20% of its label memory, packed into width buckets
on the card, served by a ``CudaEngine`` behind ``PathServer(batch_size=256)``
for 2000 uniform queries (seed 33) plus ``query_paths`` on 64 of them.  The
answers are checked against the twin engine on the card (bit for bit) and
the float64 host oracle (1e-4).  Prints the card, the build time, per-kernel
times beside the twins' and the bound, one JSON line of kernel records and,
last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
exit code is non-zero and the last line is never printed.  Needs one CUDA
device; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores.  bound_ms = max(bytes / HBM, ops / F32).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations of ref.blocked_pairs per (segment, edge) pair: five
# banded signs at 14 each (6 operand subs/muls, the difference, |t1|+|t2|
# and the band product, two compares and a negation) plus the projection
# test (dx, dy, tb, l2, tau, l2 - tau and two compares: 14).
SEGVIS_OPS_PER_PAIR = 5 * 14 + 14
# row join per (i, j) pair: hub compare, select, min
ROWMIN_OPS_PER_PAIR = 3
# the main path (the defaults of the reference's serving example)
MAP, MAP_SEED, CELL, BUDGET = "rooms-M", 0, 2.0, 0.2
BATCH, QUERIES, QUERY_SEED, PATHS, ORACLE = 256, 2000, 33, 64, 256


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         check=True, capture_output=True, text=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the stream, between two CUDA
    events around ``reps`` calls: device time plus any gaps the host leaves."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiler():
    import torch

    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[act.CPU, act.CUDA])


def device_times(prof) -> dict:
    """{kernel name: (calls, device microseconds)} of the device-side
    events (kernels, copies) of a ``torch.profiler`` trace."""
    import torch

    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key] = (e.count, us)
    return out


def device_ms(fn, reps: int) -> dict:
    """:func:`device_times` of ``reps`` calls of ``fn`` (after one warm
    call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with profiler() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_times(prof)


def max_abs_err(got, want) -> float:
    """Largest |got - want|, with equal infinities counting as 0."""
    import torch

    got, want = got.float(), want.float()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if bool(same.all()):
        return 0.0
    return float((got - want)[~same].abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def segvis_inputs(rng, bx, n: int, vertices: np.ndarray, dev):
    """Main-path-like segments: free query points to graph vertices (every
    via segment ends exactly on an obstacle corner)."""
    import torch

    p = rng.uniform(0, [bx.width, bx.height], (n, 2)).astype(np.float32)
    q = vertices[rng.integers(0, len(vertices), n)].astype(np.float32)
    return (torch.from_numpy(p).to(dev), torch.from_numpy(q).to(dev),
            bx.edges_a, bx.edges_b, bx.edges_c)


def segvis_case_table(rng, dev):
    """Random segments against random edges, with exact contacts: endpoints
    on edge endpoints, collinear slides, degenerate segments and edges."""
    import torch

    cases = []
    for n, e in ((1, 1), (7, 64), (300, 700), (1000, 128)):
        p, q, a, b, c = (rng.uniform(0, 10, (k, 2)).astype(np.float32)
                         for k in (n, n, e, e, e))
        m = min(n, e)
        q[:m // 3] = a[:m // 3]                     # ends on an edge vertex
        p[m // 3:m // 2] = b[m // 3:m // 2]         # starts on a vertex
        q[m // 2:2 * m // 3] = p[m // 2:2 * m // 3]  # degenerate segment
        b[:e // 4] = a[:e // 4]                     # degenerate edges
        mid = (a[e // 4:e // 2] + b[e // 4:e // 2]) / 2
        k = min(len(mid), n - 2 * m // 3)
        q[2 * m // 3:2 * m // 3 + k] = mid[:k]       # ends on an open edge
        cases.append(tuple(torch.from_numpy(x).to(dev)
                           for x in (p, q, a, b, c)))
    return cases


def rowmin_inputs(rng, B: int, L: int, dev, hubs: int = 96):
    """Hub-sorted rows with ties, pads (HUB_PAD, +inf) and invisible vias."""
    import torch

    from repro_torch.core.packed import HUB_PAD

    hs = np.sort(rng.integers(0, hubs, (B, L)), axis=1).astype(np.int32)
    ht = np.sort(rng.integers(0, hubs, (B, L)), axis=1).astype(np.int32)
    vs = rng.integers(0, 400, (B, L)).astype(np.float32) / 4   # many ties
    vt = rng.uniform(0, 100, (B, L)).astype(np.float32)
    vs[rng.random((B, L)) < 0.2] = np.inf
    vt[rng.random((B, L)) < 0.2] = np.inf
    for h, v in ((hs, vs), (ht, vt)):               # padded tails
        for r in range(B):
            k = rng.integers(L // 2, L + 1)
            h[r, k:] = HUB_PAD
            v[r, k:] = np.inf
    return tuple(torch.from_numpy(x).to(dev) for x in (hs, vs, ht, vt))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (build_ehl, build_visgraph,
                                  compress_to_fraction, make_map,
                                  pack_bucketed, path_length,
                                  uniform_queries)
    from repro_torch.core.query import query as host_query
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.label_join import label_join_rowmin
    from repro_torch.kernels.segvis import segvis
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. card and build -------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    print(f"build: {seconds:.3f} s ({', '.join(build.KERNEL_SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2. host index of the main path's map ----------------------------------
    t0 = time.perf_counter()
    scene = make_map(MAP, seed=MAP_SEED)
    graph = build_visgraph(scene)
    index = build_ehl(scene, cell_size=CELL, graph=graph)
    t1 = time.perf_counter()
    compress_to_fraction(index, BUDGET)
    bx = pack_bucketed(index, device=dev)
    t2 = time.perf_counter()
    print(f"index: {MAP} build {t1 - t0:.2f} s, compress+pack "
          f"{t2 - t1:.2f} s; {len(index.regions)} regions, "
          f"widths {bx.widths}, E = {bx.num_edges} "
          f"({scene.edges.shape[0]} real), {bx.device_bytes()} device bytes")
    B = BATCH
    E = bx.num_edges

    # -- 3. kernels against their twins at the main path's shapes -------------
    rng = np.random.default_rng(0)
    verts = np.asarray(graph.nodes)
    seg_shapes = [B] + [B * w for w in bx.widths]
    seg_args = {n: segvis_inputs(rng, bx, n, verts, dev) for n in seg_shapes}
    seg_err = 0.0
    for n, args in seg_args.items():
        got, want = segvis(*args), ref.segvis_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"segvis != twin at N={n}, E={E}")
        seg_err = max(seg_err, max_abs_err(got, want))
    for args in segvis_case_table(rng, dev):
        got, want = segvis(*args), ref.segvis_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"segvis != twin on case N={args[0].shape[0]}, "
                f"E={args[2].shape[0]}")
    print(f"check: segvis == twin at N in {seg_shapes}, E = {E}, and on "
          f"4 random contact cases")
    join_args = {L: rowmin_inputs(rng, B, L, dev) for L in bx.widths}
    join_err = 0.0
    for L, args in join_args.items():
        got, want = label_join_rowmin(*args), ref.label_join_rowmin_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"rowmin != twin at B={B}, L={L}")
        join_err = max(join_err, max_abs_err(got, want))
    print(f"check: label_join_rowmin == twin at B = {B}, L in {bx.widths}")

    # -- 4. main path: CudaEngine behind PathServer ----------------------------
    qs = uniform_queries(scene, graph, QUERIES, seed=QUERY_SEED)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    srv = PathServer(CudaEngine(bx), batch_size=B)
    segvis.launches = label_join_rowmin.launches = 0
    ref.segvis_ref.calls = ref.label_join_rowmin_ref.calls = 0
    srv.warmup(paths=True)
    counts = [("warmup", segvis.launches, label_join_rowmin.launches)]
    d_first = srv.query(s, t)
    counts.append(("pass 1", segvis.launches, label_join_rowmin.launches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = srv.query(s, t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.append(("pass 2", segvis.launches, label_join_rowmin.launches))
    dp, paths = srv.query_paths(s[:PATHS], t[:PATHS], host_index=index)
    torch.cuda.synchronize()
    counts.append(("paths", segvis.launches, label_join_rowmin.launches))
    launches = {"segvis": segvis.launches,
                "label_join_rowmin": label_join_rowmin.launches}
    twin_calls = (ref.segvis_ref.calls, ref.label_join_rowmin_ref.calls)
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(twin_calls == (0, 0),
            f"CudaEngine serving ran a twin: {twin_calls}")
    prev = (0, 0)
    for phase, nseg, njoin in counts:
        print(f"launches: {phase}: segvis {nseg - prev[0]}, "
              f"label_join_rowmin {njoin - prev[1]}")
        prev = (nseg, njoin)
    print(f"serve: {len(s)} queries, batch {B}, second pass "
          f"{1e6 * wall / len(s):.3f} us/query, {len(s) / wall:.1f} qps "
          f"(wall {wall:.4f} s)")
    for k, st in sorted(srv.stats.per_bucket.items()):
        print(f"  bucket {k}: width {st.width}, batches {st.batches}, "
              f"queries {st.queries}, occupancy {st.occupancy:.3f}")

    # -- 5. answers: twins on the card, float64 oracle, path lengths ----------
    require(np.array_equal(d, d_first), "two passes disagree")
    twin_srv = PathServer(TorchEngine(bx), batch_size=B)
    require(np.array_equal(d, twin_srv.query(s, t)),
            "CudaEngine d != TorchEngine d")
    # the served argmin path (what query_paths unwinds), all queries
    got = srv._dispatch(s, t, want_argmin=True)
    want = twin_srv._dispatch(s, t, want_argmin=True)
    for name, a, b in zip(("d", "covis", "via_s", "hub", "via_t"), got, want):
        require(np.array_equal(a, b),
                f"CudaEngine vs TorchEngine argmin output {name}")
    require(np.array_equal(got[0], d), "argmin d != served d")
    n_or = ORACLE
    truth = np.array([host_query(index, si, ti, want_path=False)[0]
                      for si, ti in zip(qs.s[:n_or], qs.t[:n_or])])
    require(np.array_equal(np.isfinite(d[:n_or]), np.isfinite(truth)),
            "reachability differs from the float64 oracle")
    fin = np.isfinite(truth)
    oracle_err = float(np.max(np.abs(d[:n_or][fin] - truth[fin])
                              / np.maximum(1.0, truth[fin]), initial=0.0))
    require(np.allclose(d[:n_or][fin], truth[fin], rtol=1e-4, atol=1e-4),
            f"distance vs float64 oracle: max rel err {oracle_err}")
    path_err = max((abs(path_length(p) - x) / max(1.0, x)
                    for p, x in zip(paths, dp) if np.isfinite(x)),
                   default=0.0)
    require(path_err <= 1e-4, f"max |path_length - d| / max(1, d) = {path_err}")
    require(np.array_equal(dp, d[:PATHS]), "query_paths d != query d")
    print(f"check: CudaEngine == TorchEngine on all 5 outputs ({len(s)} "
          f"queries); vs float64 oracle on {n_or}: reachability equal, "
          f"max rel err {oracle_err:.3e}; paths: max |len - d| / max(1, d) "
          f"{path_err:.3e}; reachable {int(np.isfinite(d).sum())}/{len(d)}")

    # -- 6. where the serving time goes (device kernels vs wall) -------------
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        srv.query(s, t)
        torch.cuda.synchronize()
        reps.append(1e6 * (time.perf_counter() - t0) / len(s))
    print(f"spread: 5 more passes, us/query min {min(reps):.3f} median "
          f"{float(np.median(reps)):.3f} max {max(reps):.3f}")
    with profiler() as prof:
        t0 = time.perf_counter()
        srv.query(s, t)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    kern = device_times(prof)
    busy = sum(us for _, us in kern.values()) / 1e3
    print(f"profile: one {len(s)}-query pass under the profiler: wall "
          f"{1e3 * wall_p:.3f} ms, device kernels {busy:.3f} ms, idle share "
          f"{1 - busy / (1e3 * wall_p):.4f}")
    for name, (count, us) in sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 1e3:9.4f} ms  {count:5d}x  {name[:90]}")

    # -- 7. kernel times beside the twins' and the bound ----------------------
    def bound(nbytes: float, ops: float) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        return 1e3 * max(tb, to), ("bytes" if tb > to else "operations")

    def times(kernel_fn, twin_fn, kernel_name):
        """(kernel device ms, its wrapper's stream ms, twin device ms)."""
        kern = device_ms(kernel_fn, 50)
        ms = sum(us for name, (_, us) in kern.items()
                 if name.startswith(kernel_name)) / 50 / 1e3
        require(ms > 0, f"the profiler saw no {kernel_name}")
        plain = sum(us for _, us in device_ms(twin_fn, 5).values()) / 5 / 1e3
        return ms, cuda_ms(kernel_fn, 50), plain

    seg_rows, join_rows = [], []
    for n, args in seg_args.items():
        ms, wrap, plain = times(lambda: segvis(*args),
                                lambda: ref.segvis_ref(*args), "segvis_kernel")
        nbytes = 2 * n * 8 + 3 * E * 8 + n      # p, q, edges in; flags out
        b_ms, by = bound(nbytes, SEGVIS_OPS_PER_PAIR * n * E)
        seg_rows.append((n, ms, plain, b_ms, by))
        print(f"time: segvis N={n} E={E}: kernel {ms:.5f} ms (wrapper "
              f"{wrap:.5f} ms), twin {plain:.5f} ms, bound {b_ms:.5f} ms "
              f"({by})")
    for L, args in join_args.items():
        ms, wrap, plain = times(lambda: label_join_rowmin(*args),
                                lambda: ref.label_join_rowmin_ref(*args),
                                "label_join_rowmin_kernel")
        nbytes = 4 * B * L * 4 + B * L * 4       # 4 planes in, 1 out
        b_ms, by = bound(nbytes, ROWMIN_OPS_PER_PAIR * B * L * L)
        join_rows.append((L, ms, plain, b_ms, by))
        print(f"time: label_join_rowmin B={B} L={L}: kernel {ms:.5f} ms "
              f"(wrapper {wrap:.5f} ms), twin {plain:.5f} ms, bound "
              f"{b_ms:.5f} ms ({by})")

    def record(name, source, replaces, rows, err, shape):
        _, ms, plain, b_ms, by = rows[-1]       # the widest main-path shape
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                "shape": shape}

    print(card)                 # as nvidia-smi printed it
    print(json.dumps({"kernels": [
        record("segvis", "src/repro_torch/kernels/csrc/segvis.cu",
               "src/repro/kernels/segvis.py:50", seg_rows, seg_err,
               f"N={seg_rows[-1][0]},E={E}"),
        record("label_join_rowmin",
               "src/repro_torch/kernels/csrc/label_join.cu",
               "src/repro/kernels/label_join.py:33", join_rows, join_err,
               f"B={B},L={join_rows[-1][0]}"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
