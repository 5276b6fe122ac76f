"""Quickstart on the PyTorch port: build EHL* on a synthetic map, compress
to a budget, query on the card.

    python examples/quickstart_torch.py                 # NVIDIA GPU
    python examples/quickstart_torch.py --device cpu    # the plain twins

The twin of ``examples/quickstart.py``: the same scene, budget and queries.
The batched step runs the Hopper kernels (``use_kernels=True``); on CPU
tensors the kernel wrappers run their plain PyTorch twins.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import (astar, build_ehl, build_visgraph,  # noqa: E402
                              compress_to_fraction, make_map, pack_index,
                              query, query_batch, resolve_device,
                              uniform_queries)


def main(device="cuda") -> dict:
    """Run the quickstart on ``device``; returns what it built and answered
    (``scene``, ``graph``, ``index``, ``label_memory`` before compression,
    ``stats``, ``queries``, the host ``(d, path)`` pairs of the first three
    queries, the packed index and the batched distances ``d``)."""
    dev = resolve_device(device)        # raises for CUDA without a card

    # 1. a scene: polygonal obstacles on a 60x60 map
    scene = make_map("rooms-S", seed=1)
    print(f"scene: {len(scene.polygons)} obstacles, "
          f"{int(scene.convex_mask.sum())} convex vertices")

    # 2. offline: visibility graph -> hub labels -> EHL grid index
    graph = build_visgraph(scene)
    index = build_ehl(scene, cell_size=2.0, graph=graph)
    memory = index.label_memory()
    print(f"EHL: {index.nx}x{index.ny} cells, {memory / 1e6:.2f} MB of "
          f"labels")

    # 3. EHL*: compress to 25% of the EHL memory (Algorithm 1)
    stats = compress_to_fraction(index, 0.25)
    print(f"EHL*-25: {stats.final_bytes / 1e6:.2f} MB after {stats.merges} "
          f"merges, {stats.regions} regions (budget "
          f"{'met' if stats.final_bytes <= stats.budget else 'MISSED'})")

    # 4. query: single pair, with optimal path
    qs = uniform_queries(scene, graph, 5, seed=7)
    host = []
    for s, t in zip(qs.s[:3], qs.t[:3]):
        d, path = query(index, s, t)
        dref, _ = astar(graph, s, t)
        host.append((d, path))
        print(f"  d({np.round(s, 1)} -> {np.round(t, 1)}) = {d:.3f} "
              f"(A* says {dref:.3f}), path via {len(path)} points")

    # 5. the batched engine on the packed index, through the kernels
    pk = pack_index(index, device=dev)
    d = query_batch(pk, qs.s.astype(np.float32), qs.t.astype(np.float32),
                    use_kernels=True).cpu().numpy()
    print(f"batched distances ({dev.type}):", np.round(d, 3))
    return {"scene": scene, "graph": graph, "index": index,
            "label_memory": memory, "stats": stats, "queries": qs,
            "host": host, "packed": pk, "d": d}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
