"""The fake-rank dry run (``repro_torch.launch.dryrun``) on the CPU.

Each cell runs in a child interpreter of its own (one default process
group per process): tinyllama-1.1b ``train_4k`` and nemotron-4-340b
``decode_32k`` on the 256-rank pod mesh, tinyllama ``decode_32k`` on the
512-rank multipod mesh, each cut to 2 layers (``--layers 2``; the widths
are the published ones).  Checked exactly: the per-rank parameter bytes
equal the sum over leaves of the local shard sizes that ``param_specs``
implies; the optimizer holds two bf16 moments per parameter plus the
int32 step; the collectives are counted (nemotron's K=8 KV heads on the
16-way model axis take the flash-decode branch: one all-reduce MAX per
layer, its only MAX).  ``long_500k`` is skipped
for a full-attention config, as the reference skips it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = (("tinyllama-1.1b", "train_4k", "pod"),
         ("nemotron-4-340b", "decode_32k", "pod"),
         ("tinyllama-1.1b", "decode_32k", "multipod"))
LAYERS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--arch", arch, "--shape", shape, "--mesh", mesh,
         "--layers", str(LAYERS), "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape, mesh in CELLS]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, so[-2000:] + se[-3000:]
    return {c: json.load(open(out / f"{c[0]}__{c[1]}__{c[2]}.json"))
            for c in CELLS}


def implied_bytes(cfg, mesh_shape: dict, fsdp: bool) -> int:
    """Sum over parameter leaves of the local shard a spec implies."""
    import types

    from repro_torch.distributed.sharding import param_specs
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten

    mesh = types.SimpleNamespace(shape=mesh_shape,
                                 axis_names=tuple(mesh_shape))
    pm = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    specs = flatten(param_specs(pm, mesh, fsdp=fsdp))
    total = 0
    for k, t in flatten(pm).items():
        n = 1
        for dim, ax in zip(t.shape, specs[k] + (None,) * t.ndim):
            axes = () if ax is None else (ax if isinstance(ax, tuple)
                                          else (ax,))
            n *= dim // int(np.prod([mesh_shape[a] for a in axes]))
        total += n * t.element_size()
    return total


def _cfg(arch):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=LAYERS)


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_dry_run_cell(records, cell):
    rec = records[cell]
    arch, shape, mesh = cell
    assert rec["status"] == "ok", rec.get("error")
    assert rec["ranks"] == (256 if mesh == "pod" else 512)
    assert rec["n_layers"] == LAYERS
    cfg = _cfg(arch)
    fsdp = True
    if shape.startswith("decode"):
        fsdp = cfg.param_count() * 2 / 16 > 8e9
    assert rec["param_bytes_per_rank"] == implied_bytes(
        cfg, rec["mesh_shape"], fsdp)
    if shape.startswith("train"):
        # two bf16 moments per parameter + the int32 step
        assert rec["opt_bytes_per_rank"] == 2 * rec["param_bytes_per_rank"] \
            + 4
    assert rec["flops_per_rank"] > 0 and rec["peak_live_bytes"] > 0
    assert sum(rec["collectives"]["counts"].values()) > 0
    assert rec["collectives"]["counts"] == _comm_debug(
        rec["collectives"]["comm_debug_counts"])


def _comm_debug(counts: dict) -> dict:
    """CommDebugMode's counts by the dry run's kinds."""
    kinds = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
    out = {}
    for op, n in counts.items():
        name = op.split(".")[-1]
        out[kinds.get(name, name)] = out.get(kinds.get(name, name), 0) + n
    return out


def test_flash_decode_branch_in_the_dry_run(records):
    rec = records[("nemotron-4-340b", "decode_32k", "pod")]
    # K=8 on a 16-way model axis: the sequence-sharded decode, one MAX and
    # two SUM all-reduces per layer (tensor parallelism adds SUMs of its own)
    ops = rec["collectives"]["all_reduce_ops"]
    assert ops["max"] == LAYERS and ops["sum"] >= 2 * LAYERS
    assert rec["cache_bytes_per_rank"] > 0


def test_long_context_skipped_for_full_attention(tmp_path):
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import LM_SHAPES

    shape = next(s for s in LM_SHAPES if s.name == "long_500k")
    rec = run_cell("tinyllama-1.1b", shape, "pod", str(tmp_path),
                   torch.device("cpu"))
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
    assert (tmp_path / "tinyllama-1.1b__long_500k__pod.json").exists()
