"""Checkpointing: manifest + per-host npz shards (the port of
``repro.checkpoint.store``, with its on-disk format).

Layout::

    <dir>/step_000042/
        manifest.json       # leaves' shapes and dtypes, step, hosts
        host_000.npz        # this host's leaves, keyed by /-joined path

Failure semantics: writes go to a temporary directory, then are renamed
into place atomically, so a crash mid-save never corrupts the latest
complete checkpoint; ``latest_step`` scans complete manifests only.

bfloat16 leaves are stored as the reference's files hold them: their bits
as 2-byte void (``|V2``) arrays, ``"bfloat16"`` in the manifest.  A leaf
whose manifest says ``bfloat16`` is read back by viewing those bits as
``torch.bfloat16``, so the reference's bf16 checkpoints restore here with
their bits.  One device; the mesh and resharding of the reference's
``restore`` come with the distributed slice.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.packed import resolve_device
from repro_torch.tree import flatten, unflatten

_BF16_BITS = np.dtype("V2")


# ---------------------------------------------------------------------------
# EHL index blobs — the offline phase as a cacheable artifact
# ---------------------------------------------------------------------------

def save_ehl_index(path: str, index) -> str:
    """Serialize an ``EHLIndex``'s merge state (mapper + regions) to one npz.

    The geometry (scene/visgraph/hub labels) is NOT stored: it is cheap to
    key on and expensive to serialize; :func:`load_ehl_index` reattaches
    it.  What IS stored is what the offline phase (``build_ehl`` +
    ``compress``) computes: the cell->region mapper and each region's
    cells / label keys / hub ids / score.  Writes are atomic (tmp +
    ``os.replace``), as checkpoints are.
    """
    live = sorted(index.regions)
    cells, keys, hubs, scores = [], [], [], []
    cells_off, keys_off, hubs_off = [0], [0], [0]
    for rid in live:
        r = index.regions[rid]
        cells.append(np.asarray(r.cells, dtype=np.int64))
        keys.append(np.asarray(r.keys, dtype=np.int64))
        hubs.append(np.asarray(r.hubs, dtype=np.int64))
        scores.append(r.score)
        cells_off.append(cells_off[-1] + len(r.cells))
        keys_off.append(keys_off[-1] + r.keys.size)
        hubs_off.append(hubs_off[-1] + r.hubs.size)
    payload = dict(
        cell_size=np.float64(index.cell_size),
        nx=np.int64(index.nx), ny=np.int64(index.ny),
        mapper=np.asarray(index.mapper, dtype=np.int64),
        rids=np.asarray(live, dtype=np.int64),
        scores=np.asarray(scores, dtype=np.float64),
        cells=np.concatenate(cells) if cells else np.zeros(0, np.int64),
        keys=np.concatenate(keys) if keys else np.zeros(0, np.int64),
        hubs=np.concatenate(hubs) if hubs else np.zeros(0, np.int64),
        cells_off=np.asarray(cells_off, dtype=np.int64),
        keys_off=np.asarray(keys_off, dtype=np.int64),
        hubs_off=np.asarray(hubs_off, dtype=np.int64))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_ehl_index(path: str, scene, graph, hl):
    """Reconstruct an ``EHLIndex`` from :func:`save_ehl_index` + geometry.

    The caller supplies the scene / visibility graph / hub labels the blob
    was built from (its cache key must guarantee this).
    """
    from repro_torch.core.grid import EHLIndex, Region

    z = np.load(path)
    regions = {}
    rids = z["rids"]
    co, ko, ho = z["cells_off"], z["keys_off"], z["hubs_off"]
    for i, rid in enumerate(rids):
        regions[int(rid)] = Region(
            rid=int(rid),
            cells=list(z["cells"][co[i]:co[i + 1]]),
            keys=z["keys"][ko[i]:ko[i + 1]],
            hubs=z["hubs"][ho[i]:ho[i + 1]],
            score=float(z["scores"][i]))
    return EHLIndex(scene=scene, graph=graph, hl=hl,
                    cell_size=float(z["cell_size"]),
                    nx=int(z["nx"]), ny=int(z["ny"]),
                    mapper=z["mapper"].copy(), regions=regions)


# ---------------------------------------------------------------------------
# training state
# ---------------------------------------------------------------------------

def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, manifest dtype) of one leaf."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, dev) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr)).to(dev)


def save(ckpt_dir: str, step: int, tree, *, host_id: int = 0,
         n_hosts: int = 1) -> str:
    """Save a tree of tensors. Returns the final path."""
    flat = flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:06d}")
    tmp = final + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)

    shard_payload = {}
    meta = {}
    for name, leaf in flat.items():
        arr, dtype = _to_numpy(leaf)
        shard_payload[name] = arr
        meta[name] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(os.path.join(tmp, f"host_{host_id:03d}.npz"), **shard_payload)
    if host_id == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "n_hosts": n_hosts, "leaves": meta},
                      f, indent=1)
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp0") and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like, *, device="cuda"):
    """Restore into the structure of ``tree_like``, every leaf on
    ``device`` in the dtype the manifest records."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "host_000.npz"))

    out = {}
    for name in flatten(tree_like):
        arr = data[name]
        want = manifest["leaves"][name]
        if list(arr.shape) != want["shape"]:
            raise ValueError(f"checkpoint leaf {name}: shape {arr.shape}, "
                             f"manifest {want}")
        out[name] = _from_numpy(arr, want["dtype"], dev)
    return unflatten(out)
