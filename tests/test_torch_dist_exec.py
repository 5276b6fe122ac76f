"""The port's multi-rank execution on the CPU: 8 gloo ranks against the
port's one-device functions and the reference's 8-device runs.

One ``torch.multiprocessing`` spawn of 8 ranks (a ``file://`` rendezvous
in the test's tmp dir, so parallel workers never race for a port) runs
every multi-rank check and returns its results; one child interpreter with
``--xla_force_host_platform_device_count=8`` runs the reference on the
same numpy inputs, as ``tests/test_distributed_exec.py`` does.  The meshes
are the reference tests':

* ``moe_block_ep`` (deepseek-v3 reduced) on (2, 4) data x model;
* ``decode_attention_dist`` on (2, 4), three (pos, window, softcap) cases;
* ``pipeline_forward`` (tinyllama reduced, n_micro 4) on (2, 4) pod x
  data;
* a sharded train step (tinyllama reduced, float32) on (4, 2) data x
  model, 6 steps.

Tolerances, stated before comparing.  Against the port's one-device
functions, the reference tests' own: MoE forward < 1e-4 and gradient
< 1e-5, flash-decode < 1e-5 (and the written caches bit-equal), pipeline
forward < 1e-5 and gradient < 1e-6, all max |difference|; the train
step's first loss and gradients within rtol 1e-4 and atol 1e-5 times the
larger of 1 and the leaf's largest magnitude (the step tolerance of
``tests/test_torch_train_integration.py``), and the loss falls.  Against
the reference's distributed outputs, the LM parity tests' cross-framework
float32 tolerances: forwards within rtol 1e-5 and atol
1e-5 times that scale, gradients within rtol 1e-4 and atol 1e-5 times it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_dist_ranks import WORLD, spawn  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 300
FLASH_CASES = [(17, 0, 0.0), (9, 5, 30.0), (31, 0, 50.0)]
# moe_block's capacity: every one of the 4 x 16 tokens' top-2 picks fits
# (the reference test's 1 << 20 drops none either, at a [E, 1M, d] buffer)
MOE_CAP = 4 * 16 * 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scaled_close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def make_inputs() -> dict:
    """Every input of the checks, from one numpy seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten

    rng = np.random.default_rng(0)
    cfg = get_config("deepseek-v3-671b").reduced()
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    sff = ff * cfg.n_shared
    out = {"moe/x": rng.standard_normal((4, 16, d)),
           "moe/p/router": rng.standard_normal((d, E)) * 0.02,
           "moe/p/wg": rng.standard_normal((E, d, ff)) * d ** -0.5,
           "moe/p/wu": rng.standard_normal((E, d, ff)) * d ** -0.5,
           "moe/p/wd": rng.standard_normal((E, ff, d)) * ff ** -0.5,
           "moe/p/shared/wg": rng.standard_normal((d, sff)) * d ** -0.5,
           "moe/p/shared/wu": rng.standard_normal((d, sff)) * d ** -0.5,
           "moe/p/shared/wd": rng.standard_normal((sff, d)) * sff ** -0.5}
    B, Smax, K, H, hd = 4, 32, 3, 6, 16
    for name, shape in (("q", (B, 1, H, hd)), ("kc", (B, Smax, K, hd)),
                        ("vc", (B, Smax, K, hd)), ("kn", (B, 1, K, hd)),
                        ("vn", (B, 1, K, hd))):
        out[f"flash/{name}"] = rng.standard_normal(shape)
    tcfg = get_config("tinyllama-1.1b").reduced()
    params = T.init_params(tcfg, 0, dtype=torch.float32, device="cpu")
    for k, v in flatten(params).items():
        out[f"tiny/{k}"] = v.numpy()
    out["tiny/tokens"] = rng.integers(0, tcfg.vocab, (8, 32))
    for s in range(6):
        out[f"train/tokens{s}"] = rng.integers(0, tcfg.vocab, (8, 64))
    return {k: (v.astype(np.float32) if v.dtype.kind == "f"
                else v.astype(np.int64)) for k, v in out.items()}


def sub(data: dict, prefix: str) -> dict:
    from repro_torch.tree import unflatten

    n = len(prefix)
    return unflatten({k[n:]: torch.from_numpy(np.array(v))
                      for k, v in data.items() if k.startswith(prefix)})


# ----------------------------------------------------------------- ranks

def _grads(fn, tree):
    from repro_torch.tree import flatten, unflatten

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flatten(tree).items()}
    loss = fn(unflatten(leaves))
    g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    # a leaf the function never reads (the unembedding of a forward that
    # stops at the hidden state) has a zero gradient, as jax.grad's
    return {k: (torch.zeros_like(v) if t is None else t).numpy()
            for (k, v), t in zip(leaves.items(), g)}


def _rank_checks(rank: int, data: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, global_batch_arrays
    from repro_torch.distributed import hints
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.flash_decode import (
        decode_attention_dist, seq_sharded_decode_applicable)
    from repro_torch.distributed.moe_ep import moe_block_ep
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import (distribute,
                                                  param_shardings,
                                                  undistribute)
    from repro_torch.launch.train import build_train_step, loss_and_grads
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten

    res = {}
    cap = MOE_CAP
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = get_config("deepseek-v3-671b").reduced()
    p, x = sub(data, "moe/p/"), torch.from_numpy(data["moe/x"])
    with hints.mesh_hints(mesh):
        res["moe/out"] = moe_block_ep(cfg, p, x, cap).numpy()
        g = _grads(lambda q: (moe_block_ep(cfg, q, x, cap) ** 2).mean(), p)
    res.update({f"moe/grad/{k}": v for k, v in g.items()})

    f = {k: torch.from_numpy(data[f"flash/{k}"])
         for k in ("q", "kc", "vc", "kn", "vn")}
    res["flash/applicable"] = np.array(seq_sharded_decode_applicable(
        mesh, 4, 32, 3))
    for i, (pos, w, cap_) in enumerate(FLASH_CASES):
        with hints.mesh_hints(mesh):
            o, kc, vc = decode_attention_dist(
                f["q"], f["kc"], f["vc"], f["kn"], f["vn"], pos, window=w,
                softcap=cap_)
        res[f"flash/{i}/out"] = o.numpy()
        res[f"flash/{i}/k"] = kc.numpy()
        res[f"flash/{i}/v"] = vc.numpy()

    pmesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    tcfg = get_config("tinyllama-1.1b").reduced()
    params = sub(data, "tiny/")
    toks = params.pop("tokens")
    with hints.mesh_hints(pmesh):
        res["pp/out"] = pipeline_forward(tcfg, params, toks,
                                         n_micro=4).detach().numpy()
        g = _grads(lambda q: (pipeline_forward(tcfg, q, toks, n_micro=4)
                              ** 2).mean(), params)
    res.update({f"pp/grad/{k}": v for k, v in g.items()})

    tmesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    dp = distribute(params, tmesh, param_shardings(params, tmesh))
    batches = [torch.from_numpy(data[f"train/tokens{s}"]) for s in range(6)]
    from repro_torch.distributed.sharding import batch_spec, placements
    from torch.distributed.tensor import distribute_tensor

    dbatch = [distribute_tensor(b, tmesh, placements(batch_spec(tmesh),
                                                     tmesh))
              for b in batches]
    from repro_torch.launch.train import on_mesh

    with on_mesh(tmesh):
        loss, grads = loss_and_grads(tcfg, dp, dbatch[0])
    res["train/loss0"] = np.array(loss.full_tensor().item())
    res.update({f"train/grad/{k}": v.numpy() for k, v in
                flatten(undistribute(grads)).items()})
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=30)
    step = build_train_step(tcfg, ocfg, mesh=tmesh)
    opt = adamw.init_state(dp, ocfg)
    losses = []
    for b in dbatch:
        dp, opt, m = step(dp, opt, b)
        losses.append(m["loss"].full_tensor().item())
    res["train/losses"] = np.array(losses)

    # the batch a launcher gets: rows r % host_batch of the host batch
    dcfg = DataConfig(vocab=tcfg.vocab, seq_len=16, global_batch=8)
    gb = global_batch_arrays(dcfg, 3, tmesh, batch_spec(tmesh))
    res["data/local"] = gb.to_local().numpy()
    res["data/full"] = gb.full_tensor().numpy()
    return res


def _rank_main(rank: int, init: str, npz: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=WORLD)
    try:
        data = dict(np.load(npz))
        res = _rank_checks(rank, data)
        np.savez(f"{out}{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- reference

REF_CODE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.models import layers as ll
from repro.models import transformer as T
from repro.distributed import hints
from repro.distributed.compat import make_mesh
from repro.distributed.moe_ep import moe_block_ep
from repro.distributed.flash_decode import decode_attention_dist
from repro.distributed.pipeline import pipeline_forward
from repro.distributed.sharding import param_shardings, batch_spec

data = dict(np.load(sys.argv[1]))
out = {}

def tree(prefix):
    t = {}
    for k, v in data.items():
        if k.startswith(prefix):
            *ps, last = k[len(prefix):].split("/")
            node = t
            for q in ps:
                node = node.setdefault(q, {})
            node[last] = jnp.asarray(v)
    return t

def flat(t, prefix=""):
    o = {}
    for k in sorted(t):
        if isinstance(t[k], dict):
            o.update(flat(t[k], prefix + k + "/"))
        else:
            o[prefix + k] = np.asarray(t[k])
    return o

mesh = make_mesh((2, 4), ("data", "model"))
cfg = get_config("deepseek-v3-671b").reduced()
p, x, cap = tree("moe/p/"), jnp.asarray(data["moe/x"]), %(cap)d
with hints.mesh_hints(mesh), mesh:
    out["moe/out"] = np.asarray(jax.jit(
        lambda p, x: moe_block_ep(cfg, p, x, cap))(p, x))
    g = jax.jit(jax.grad(lambda p: (moe_block_ep(cfg, p, x, cap) ** 2)
                         .mean()))(p)
out.update({"moe/grad/" + k: v for k, v in flat(g).items()})

f = {k: jnp.asarray(data["flash/" + k]) for k in ("q", "kc", "vc", "kn", "vn")}
for i, (pos, w, c) in enumerate(%(cases)r):
    with hints.mesh_hints(mesh), mesh:
        o, kd, vd = jax.jit(lambda *a: decode_attention_dist(
            *a, pos, window=w, softcap=c))(f["q"], f["kc"], f["vc"],
                                           f["kn"], f["vn"])
    out["flash/%%d/out" %% i] = np.asarray(o)

pm = make_mesh((2, 4), ("pod", "data"))
tc = get_config("tinyllama-1.1b").reduced()
params = tree("tiny/")
toks = params.pop("tokens")
with hints.mesh_hints(pm), pm:
    out["pp/out"] = np.asarray(jax.jit(lambda p, t: pipeline_forward(
        tc, p, t, n_micro=4))(params, toks))
with hints.mesh_hints(pm), pm:
    g = jax.jit(jax.grad(lambda p: (pipeline_forward(tc, p, toks, n_micro=4)
                                    .astype(jnp.float32) ** 2).mean()))(
        params)
out.update({"pp/grad/" + k: v for k, v in flat(g).items()})

tm = make_mesh((4, 2), ("data", "model"))
with hints.mesh_hints(tm), tm:
    psh = param_shardings(params, tm)
    dp = jax.device_put(params, psh)
    tok = jax.device_put(jnp.asarray(data["train/tokens0"]),
                         NamedSharding(tm, batch_spec(tm)))
    l, g = jax.jit(jax.value_and_grad(lambda p, b: T.loss_fn(tc, p, b)))(
        dp, tok)
out["train/loss0"] = np.asarray(l)
out.update({"train/grad/" + k: v for k, v in flat(g).items()})
np.savez(sys.argv[2], **out)
""" % {"cases": FLASH_CASES, "cap": MOE_CAP}


def reference(npz: str, out: str) -> subprocess.Popen:
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", REF_CODE, npz, out],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# ----------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, rank 0's results, every rank's results, the reference's)
    of one spawn and one reference run."""
    d = tmp_path_factory.mktemp("dist_exec")
    data = make_inputs()
    npz = str(d / "inputs.npz")
    np.savez(npz, **data)
    ref = reference(npz, str(d / "ref.npz"))
    try:
        spawn(_rank_main, (str(d / "rdzv"), npz, str(d / "rank")), TIMEOUT)
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return data, ranks[0], ranks, dict(np.load(d / "ref.npz"))


def _one_device_grads(fn, tree):
    return _grads(fn, tree)


def test_moe_block_ep_matches_moe_block(runs):
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ll

    data, got, _, ref = runs
    cfg = get_config("deepseek-v3-671b").reduced()
    p, x, cap = sub(data, "moe/p/"), torch.from_numpy(data["moe/x"]), MOE_CAP
    plain = ll.moe_block(cfg, p, x, cap).numpy()
    assert float(np.abs(got["moe/out"] - plain).max()) < 1e-4
    g1 = _grads(lambda q: (ll.moe_block(cfg, q, x, cap) ** 2).mean(), p)
    assert max(float(np.abs(got[f"moe/grad/{k}"] - v).max())
               for k, v in g1.items()) < 1e-5
    scaled_close(got["moe/out"], ref["moe/out"], 1e-5, 1e-5)
    for k in g1:
        scaled_close(got[f"moe/grad/{k}"], ref[f"moe/grad/{k}"], 1e-4, 1e-5)


def test_flash_decode_matches_plain(runs):
    from repro_torch.models import layers as ll

    data, got, _, ref = runs
    assert bool(got["flash/applicable"])
    f = {k: torch.from_numpy(data[f"flash/{k}"])
         for k in ("q", "kc", "vc", "kn", "vn")}
    for i, (pos, w, cap) in enumerate(FLASH_CASES):
        kr, vr = f["kc"].clone(), f["vc"].clone()
        kr[:, pos], vr[:, pos] = f["kn"][:, 0], f["vn"][:, 0]
        want = ll.decode_attention(f["q"], kr, vr, pos + 1, window=w,
                                   softcap=cap).numpy()
        assert float(np.abs(got[f"flash/{i}/out"] - want).max()) < 1e-5
        np.testing.assert_array_equal(got[f"flash/{i}/k"], kr.numpy())
        np.testing.assert_array_equal(got[f"flash/{i}/v"], vr.numpy())
        scaled_close(got[f"flash/{i}/out"], ref[f"flash/{i}/out"], 1e-5,
                     1e-5)


def test_pipeline_forward_matches_forward(runs):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    data, got, _, ref = runs
    cfg = get_config("tinyllama-1.1b").reduced()
    params = sub(data, "tiny/")
    toks = params.pop("tokens")
    plain = T.forward_hidden(cfg, params, toks).numpy()
    assert float(np.abs(got["pp/out"] - plain).max()) < 1e-5
    g1 = _grads(lambda q: (T.forward_hidden(cfg, q, toks) ** 2).mean(),
                params)
    assert max(float(np.abs(got[f"pp/grad/{k}"] - v).max())
               for k, v in g1.items()) < 1e-6
    scaled_close(got["pp/out"], ref["pp/out"], 1e-5, 1e-5)
    for k in g1:
        scaled_close(got[f"pp/grad/{k}"], ref[f"pp/grad/{k}"], 1e-4, 1e-5)


def test_sharded_train_step(runs):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import loss_and_grads

    data, got, ranks, ref = runs
    cfg = get_config("tinyllama-1.1b").reduced()
    params = sub(data, "tiny/")
    params.pop("tokens")
    loss, grads = loss_and_grads(cfg, params,
                                 torch.from_numpy(data["train/tokens0"]))
    scaled_close(got["train/loss0"], loss.numpy(), 1e-4, 1e-5)
    from repro_torch.tree import flatten

    for k, g in flatten(grads).items():
        scaled_close(got[f"train/grad/{k}"], g.numpy(), 1e-4, 1e-5)
        scaled_close(got[f"train/grad/{k}"], ref[f"train/grad/{k}"], 1e-4,
                     1e-5)
    scaled_close(got["train/loss0"], ref["train/loss0"], 1e-4, 1e-5)
    losses = got["train/losses"]
    assert losses[-1] < losses[0], losses
    for r in ranks[1:]:            # every rank reads the same loss
        np.testing.assert_array_equal(r["train/losses"], losses)


def test_global_batch_arrays_row_map(runs):
    from repro_torch.data.pipeline import DataConfig, synthetic_batch

    _, got, ranks, _ = runs
    host = synthetic_batch(DataConfig(vocab=256, seq_len=16,
                                      global_batch=8), 3)
    np.testing.assert_array_equal(got["data/full"], host)
    # (4, 2) data x model: data rank r holds rows 2r, 2r+1 on both of its
    # model ranks
    for rank, r in enumerate(ranks):
        i = rank // 2
        np.testing.assert_array_equal(r["data/local"], host[2 * i:2 * i + 2])
