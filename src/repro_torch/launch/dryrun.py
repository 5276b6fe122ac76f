"""Fake-rank dry run: build and run every (arch x shape x mesh) cell's real
step on a production mesh without the hardware (the port of
``repro.launch.dryrun``).

The reference lowers and compiles each step for 512 placeholder XLA
devices.  The port's counterpart runs the step itself, on a process group
of the ``fake`` backend at 256 ranks (``pod``, 16x16) or 512 (``multipod``,
2x16x16), under ``FakeTensorMode``: every tensor has a shape, a dtype and a
device but no storage, and every collective returns at once.  One default
group per process, so each mesh kind runs in a process of its own
(``--mesh both`` starts one child per kind).

Per cell the real step is built from ``sharding.param_shardings`` /
``cache_specs`` / ``configs.input_specs`` (train: ``loss_and_grads`` +
``adamw.apply_updates``; prefill: ``transformer.prefill``; decode:
``decode_step`` against a cache of ``seq_len`` positions) and four things
are recorded for rank 0:

* per-rank parameter and optimizer bytes (the DTensors' local shards),
* ``peak_live_bytes``: the high-water of rank 0's live local storage
  while the step runs (parameters, optimizer state, cache and batch
  included),
* ``flops_per_rank``: rank 0's local ops counted with
  ``FlopCounterMode``'s per-op formulas (its ``flop_registry``),
* collectives by kind: ``CommDebugMode``'s counts, and the bytes of each
  collective's larger operand (a gather's output, a reduce's input).

Skips come from ``shape_applicable``, as in the reference.  ``--layers N``
cuts the depth (recorded in the JSON as ``n_layers``).  Records go to
``build/dryrun_torch/`` as JSON.

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --device cpu --arch tinyllama-1.1b \\
        --shape train_4k --layers 2          # a CPU-only machine
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun_torch")

WORLD = {"pod": 256, "multipod": 512}

#: collective kinds by op name (functional and in-place c10d spellings)
_KINDS = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "send-recv", "recv_": "send-recv",
}


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


class _ShapePropagation(threading.local):
    depth = 0


_PROP = _ShapePropagation()


@contextlib.contextmanager
def tally_local_ops_only():
    """While DTensor's sharding propagator runs an op on global-shape fake
    tensors to learn its output's metadata (under the dry run's own
    ``FakeTensorMode``), the modes below must not count it: the flag is
    up for the duration of ``ShardingPropagator._propagate_tensor_meta_
    non_cached``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def flagged(self, *args, **kwargs):
        _PROP.depth += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROP.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = flagged
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _on_dtensors(types) -> bool:
    """True for an op on DTensors: a mode returns NotImplemented there, so
    DTensor desugars it into local ops and collectives, which the mode then
    sees (as ``CommDebugMode`` does)."""
    from torch.distributed.tensor import DTensor

    return any(t is DTensor for t in types)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CollectiveBytes(TorchDispatchMode):
    """Count and bytes of every collective the step issues, by kind: the
    bytes of its larger operand (a gather's output, a reduce's input)."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}
        self.bytes: dict = {}
        self.reduce_ops: dict = {}      # all-reduces by their reduce op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        if _PROP.depth:                 # the propagator's metadata run
            return func(*args, **(kwargs or {}))
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns in ("_c10d_functional", "c10d") and name in _KINDS:
            kind = _KINDS[name]
            sizes = [_nbytes(t) for t in _tensors((args, out))]
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) + max(sizes or [0])
            if name == "all_reduce" and len(args) > 1:
                op = str(args[1]).lower()
                self.reduce_ops[op] = self.reduce_ops.get(op, 0) + 1
        return out


class RankFlops(TorchDispatchMode):
    """FLOPs of this rank's local ops, by ``FlopCounterMode``'s per-op
    formulas."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        if _PROP.depth:                 # the propagator's metadata run
            return func(*args, **(kwargs or {}))
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        return out


class LiveBytes(TorchDispatchMode):
    """High-water of live local storage: each storage an op makes counts
    from the op until its last tensor is freed; :meth:`track` adds what
    existed before (parameters, state, inputs)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: dict = {}       # storage key -> live tensors on it

    def _add(self, t) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._drop, key, st.nbytes())

    def _drop(self, key, nbytes: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= nbytes

    def track(self, tree) -> None:
        from repro_torch.tree import leaves

        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        if _PROP.depth:                 # the propagator's metadata run
            return func(*args, **(kwargs or {}))
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._add(t)
        return out


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor leaf."""
    from repro_torch.tree import leaves

    return sum(_nbytes(_local(t)) for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _fake(tree, dev):
    """Storage-less tensors of the (meta) tree's shapes on ``dev``."""
    from repro_torch.tree import tree_map

    def empty(m):
        if not isinstance(m, torch.Tensor):
            return m
        return torch.empty(m.shape, dtype=m.dtype, device=dev)

    return tree_map(empty, tree) if isinstance(tree, dict) else empty(tree)


def _batch(t, mesh):
    """A batch input as a DTensor: batch over the data axes where the
    global batch divides them, replicated otherwise (B=1 decode)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import batch_spec, placements
    from repro_torch.launch.mesh import axis_size, data_axes

    n = 1
    for a in data_axes(mesh):
        n *= axis_size(mesh, a)
    spec = batch_spec(mesh) if t.shape[0] % n == 0 else ()
    return distribute_tensor(t, mesh, placements(spec, mesh))


def build_step(cfg, shape, mesh, dev):
    """(fn, state tree) of one cell: ``fn()`` runs the step on the fake
    DTensors in the state."""
    from repro_torch.configs import input_specs
    from repro_torch.distributed.sharding import (cache_specs, distribute,
                                                  param_shardings,
                                                  placements)
    from repro_torch.launch.mesh import axis_size
    from repro_torch.launch.train import loss_and_grads, on_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    dtype = torch.bfloat16
    specs = {k: _batch(_fake(v, dev), mesh)
             for k, v in input_specs(cfg, shape).items()}
    pmeta = T.init_params(cfg, dtype=dtype, device="meta")

    if shape.kind == "train":
        params = distribute(_fake(pmeta, dev), mesh,
                            param_shardings(pmeta, mesh))
        ocfg = adamw.AdamWConfig(moment_dtype=torch.bfloat16)
        opt = adamw.init_state(params, ocfg)

        def fn():
            with on_mesh(mesh):
                loss, grads = loss_and_grads(cfg, params, specs["tokens"],
                                             enc_frames=specs.get(
                                                 "enc_frames"))
                return adamw.apply_updates(params, grads, opt, ocfg)
        return fn, {"params": params, "opt": opt, "inputs": specs}

    if shape.kind == "prefill":
        params = distribute(_fake(pmeta, dev), mesh,
                            param_shardings(pmeta, mesh))

        @torch.no_grad()
        def fn():
            with on_mesh(mesh):
                return T.prefill(cfg, params, specs["tokens"],
                                 enc_frames=specs.get("enc_frames"))
        return fn, {"params": params, "inputs": specs}

    # decode: TP-only parameters while a TP shard fits (an FSDP'd weight is
    # all-gathered on every token step); past ~8 GB a rank, FSDP stays on
    tp_bytes = cfg.param_count() * 2 / axis_size(mesh, "model")
    params = distribute(_fake(pmeta, dev), mesh,
                        param_shardings(pmeta, mesh, fsdp=tp_bytes > 8e9))
    B, S = shape.global_batch, shape.seq_len
    enc_out = None
    if cfg.encdec:
        enc_out = torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=dtype,
                              device="meta")
    cmeta = T.init_cache(cfg, B, S, dtype=dtype, enc_out=enc_out,
                         params=pmeta, device="meta")
    cspec = cache_specs(cmeta, mesh)
    cache = distribute(_fake(cmeta, dev), mesh,
                       tree_map(lambda s: placements(s, mesh), cspec))

    @torch.no_grad()
    def fn():
        with on_mesh(mesh):
            return T.decode_step(cfg, params, cache, specs["tokens"])
    return fn, {"params": params, "cache": cache, "inputs": specs}


def run_cell(arch: str, shape, mesh_kind: str, out_dir: str, dev,
             layers: int | None = None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import shape_applicable

    cfg = get_config(arch)
    if layers:
        n = min(layers, cfg.n_layers)
        # a MoE config keeps at least one MoE layer
        dense = min(cfg.n_dense_layers, n - 1) if cfg.moe else \
            cfg.n_dense_layers
        cfg = dataclasses.replace(cfg, n_layers=n, n_dense_layers=dense)
    runs, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
           "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch, "n_layers": cfg.n_layers,
           "device_type": dev.type}
    if not runs:
        rec.update(status="skipped", reason=reason)
        return _write(rec, out_dir)

    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod",
                                device=dev)
    t0 = time.perf_counter()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, state = build_step(cfg, shape, mesh, dev)
            t_build = time.perf_counter() - t0
            live, coll, flops = LiveBytes(), CollectiveBytes(), RankFlops()
            with tally_local_ops_only(), CommDebugMode() as comm, flops, \
                    coll, live:
                live.track(state)
                fn()
            t_step = time.perf_counter() - t0 - t_build
        rec.update(
            status="ok", ranks=mesh.size(),
            mesh_shape=dict(zip(mesh.mesh_dim_names, mesh.shape)),
            build_s=t_build, step_s=t_step,
            param_bytes_per_rank=local_bytes(state["params"]),
            opt_bytes_per_rank=local_bytes(state.get("opt", {})),
            cache_bytes_per_rank=local_bytes(state.get("cache", {})),
            peak_live_bytes=live.peak,
            flops_per_rank=flops.flops,
            collectives={"counts": coll.counts, "bytes": coll.bytes,
                         "all_reduce_ops": coll.reduce_ops,
                         "comm_debug_counts": {
                             str(k): v for k, v in
                             comm.get_comm_counts().items()}},
            model_params=cfg.param_count(),
            model_params_active=cfg.active_param_count())
    except Exception as e:   # noqa: BLE001 — record, don't die mid-matrix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-3000:])
    rec["seconds"] = time.perf_counter() - t0
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__"
                        f"{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def init_fake_group(world: int) -> None:
    """The process's default group: the ``fake`` backend at ``world``
    ranks, this process rank 0."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg."
            "FakeStore (the fake process-group backend), which this torch "
            f"({torch.__version__}) lacks") from e
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: this "
                           "one already has a default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _summary(rec: dict) -> str:
    msg = rec["status"]
    if rec["status"] == "ok":
        c = rec["collectives"]
        msg += (f" {rec['seconds']:.1f}s params/rank="
                f"{rec['param_bytes_per_rank']} opt/rank="
                f"{rec['opt_bytes_per_rank']} cache/rank="
                f"{rec['cache_bytes_per_rank']} peak_live="
                f"{rec['peak_live_bytes']} flops/rank="
                f"{rec['flops_per_rank']:.4g} "
                f"collectives={json.dumps(c['counts'], sort_keys=True)} "
                f"bytes={json.dumps(c['bytes'], sort_keys=True)}")
    elif rec["status"] == "error":
        msg += " " + rec["error"][:300]
    else:
        msg += " " + rec.get("reason", "")
    return msg


def main(argv=None):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.core.packed import resolve_device
    from repro_torch.models.config import LM_SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--out", default=os.path.abspath(ART_DIR))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.mesh == "both":
        # one default group per process: a child per mesh kind
        rc = 0
        for kind in ("pod", "multipod"):
            child = [a for a in (argv if argv is not None else sys.argv[1:])]
            child = [a for i, a in enumerate(child)
                     if a != "--mesh" and (i == 0 or child[i - 1] != "--mesh")]
            rc |= subprocess.run([sys.executable, "-m",
                                  "repro_torch.launch.dryrun", *child,
                                  "--mesh", kind]).returncode
        return rc

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = (LM_SHAPES if (args.all or args.shape is None)
              else [s for s in LM_SHAPES if s.name == args.shape])
    if not shapes:
        raise ValueError(f"unknown shape {args.shape!r}")
    init_fake_group(WORLD[args.mesh])
    results = []
    for arch in archs:
        for shape in shapes:
            print(f"[dryrun] {arch} {shape.name} {args.mesh} ...",
                  flush=True)
            rec = run_cell(arch, shape, args.mesh, args.out, dev,
                           layers=args.layers)
            results.append(rec)
            print(f"[dryrun] {arch} {shape.name} {args.mesh}: "
                  f"{_summary(rec)}", flush=True)
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n{len(results)} cells: {len(results) - len(bad)} ok/skipped, "
          f"{len(bad)} errors")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
