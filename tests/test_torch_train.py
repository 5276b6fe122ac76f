"""The port's training substrate against the reference's, on the CPU: the
twins of ``tests/test_substrate.py`` (AdamW, clipping, the schedule, int8
error feedback, checkpoints, the data pipeline, ``StepGuard``,
``plan_remesh``, stragglers) run on ``repro_torch``, plus parity with the
reference on the same inputs.

Tolerances, stated before comparing:

* ``schedule``: rtol 2.4e-7 (one float32 ulp; both compute in float32,
  their ``cos`` may round differently) at every step of a 30-step run;
* ``apply_updates``, 3 steps on tinyllama's reduced parameters and
  gradients drawn with numpy: parameters and float32 moments within rtol
  1e-6 and atol 1e-7 times the larger of 1 and the reference leaf's
  largest magnitude (float32 element ops in the same order; the global
  norm sums its squares in another order inside each leaf); bf16 moments
  bit-equal when the clip does not engage (with it, the norm's other sum
  order flips the bf16 rounding of a few elements: measured 1 ulp on 16
  elements after one step, 2 ulps after two);
* ``compress_psum_tree`` on one rank equals ``compress_psum_ref`` bit for
  bit (the same float32 operations);
* checkpoints and the EHL index cache round-trip exactly, across the two
  packages too.

The multi-rank all-reduce of the compression comes with the distributed
slice; here a process group of one rank (gloo) is the identity.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as ref_store  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (CorpusReader, DataConfig,  # noqa: E402
                                       host_batch_size, synthetic_batch)
from repro_torch.distributed import fault  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compression import (compress_psum_ref,  # noqa: E402
                                           compress_psum_tree,
                                           init_residuals, quantize_psum)
from repro_torch.tree import flatten  # noqa: E402
from test_torch_lm_model import scaled_close, widened  # noqa: E402

ULP = 2.4e-7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_np(x):
    """A tensor or jax array as float32/int numpy (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def jflat(tree) -> dict:
    """{"/"-joined path: leaf} of a reference pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


# ---------------------------------------------------------------- optimizer

def _quad_params():
    return {"w": torch.tensor([2.0, -3.0]), "b": torch.tensor([1.0])}


def _quad_grads(p):
    return {"w": 2 * p["w"], "b": 2 * p["b"]}


def _quad_loss(p):
    return float((p["w"] ** 2).sum() + (p["b"] ** 2).sum())


def test_adamw_converges_on_quadratic():
    params = _quad_params()
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                            total_steps=400, min_lr_frac=1.0)
    state = adamw.init_state(params, cfg)
    for _ in range(300):
        params, state, _ = adamw.apply_updates(params, _quad_grads(params),
                                               state, cfg)
    assert _quad_loss(params) < 1e-3
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 300


def test_adamw_bf16_moments_track_fp32():
    base = adamw.AdamWConfig(lr=0.01, weight_decay=0.0, warmup_steps=0)
    half = adamw.AdamWConfig(lr=0.01, weight_decay=0.0, warmup_steps=0,
                             moment_dtype=torch.bfloat16)
    p32 = p16 = _quad_params()
    s32, s16 = adamw.init_state(p32, base), adamw.init_state(p16, half)
    for _ in range(50):
        p32, s32, _ = adamw.apply_updates(p32, _quad_grads(p32), s32, base)
        p16, s16, _ = adamw.apply_updates(p16, _quad_grads(p16), s16, half)
    assert s16["m"]["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(p16["w"].numpy(), p32["w"].numpy(), atol=0.05)


def test_apply_updates_leaves_its_inputs():
    params = _quad_params()
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0)
    state = adamw.init_state(params, cfg)
    grads = _quad_grads(params)
    keep = {k: v.clone() for k, v in params.items()}
    new, new_state, m = adamw.apply_updates(params, grads, state, cfg)
    for k in keep:
        assert torch.equal(params[k], keep[k])
        assert not torch.equal(new[k], keep[k])
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert float(state["m"]["w"].abs().sum()) == 0
    assert set(m) == {"lr", "grad_norm"}


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.sqrt((clipped["a"] ** 2).sum())) == \
        pytest.approx(1.0, rel=1e-5)


def test_clip_matches_reference():
    """Two leaves (sorted-key order: ``a`` before ``z``), bf16 and f32."""
    rng = np.random.default_rng(4)
    g = {"z": rng.standard_normal((3, 5)).astype(np.float32) * 3,
         "a": rng.standard_normal((7,)).astype(np.float32)}
    want, wnorm = ref_adamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    got, norm = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    scaled_close(norm, np.asarray(wnorm), ULP, 0)
    for k in g:
        scaled_close(got[k], np.asarray(want[k]), 1e-6, 1e-7)


def test_lr_schedule_warmup_and_cosine():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                            min_lr_frac=0.1)
    assert float(adamw.schedule(cfg, 0)) == pytest.approx(0.0)
    assert float(adamw.schedule(cfg, 10)) == pytest.approx(1.0)
    assert float(adamw.schedule(cfg, 110)) == pytest.approx(0.1, abs=1e-6)
    assert adamw.schedule(cfg, torch.tensor(3, dtype=torch.int32)).dtype \
        == torch.float32


def test_schedule_matches_reference_at_every_step():
    """The launcher's schedule (warmup 5) over a 30-step run, past its end
    too, against the reference's int32 steps."""
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=30)
    cfg, rcfg = adamw.AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
    got = np.array([float(adamw.schedule(
        cfg, torch.tensor(s, dtype=torch.int32))) for s in range(34)],
        np.float32)
    want = np.array([float(ref_adamw.schedule(rcfg, jnp.int32(s)))
                     for s in range(34)], np.float32)
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moments):
    """Three AdamW steps on tinyllama's reduced float32 parameters and
    numpy gradients.  The float32 case clips every step; the bf16 case
    does not clip (``clip_norm`` 1e9), so no norm summed in another order
    feeds the bf16 rounding of the moments."""
    rc = ref_get_config("tinyllama-1.1b").reduced()
    tree = widened(RT.init_params(rc, jax.random.PRNGKey(0),
                                  dtype=jnp.float32))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5,
              clip_norm=1.0 if moments == "float32" else 1e9)
    rcfg = ref_adamw.AdamWConfig(**kw, moment_dtype=getattr(jnp, moments))
    cfg = adamw.AdamWConfig(**kw, moment_dtype=getattr(torch, moments))
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_adamw.init_state(rp, rcfg)
    p = T.params_from_numpy(tree, device="cpu")
    s = adamw.init_state(p, cfg)
    rng = np.random.default_rng(9)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.02
                                    / (i + 1)).astype(np.float32), tree)
        rp, rs, rm = ref_adamw.apply_updates(
            rp, jax.tree.map(jnp.asarray, g), rs, rcfg)
        p, s, m = adamw.apply_updates(
            p, T.params_from_numpy(g, device="cpu"), s, cfg)
        assert int(s["step"]) == int(rs["step"]) == i + 1
        assert float(m["grad_norm"]) > 1.0         # the f32 case clips
        scaled_close(m["lr"], np.asarray(rm["lr"]), ULP, 0)
        scaled_close(m["grad_norm"], np.asarray(rm["grad_norm"]), 1e-6, 0)
        want = jflat({"p": rp, "m": rs["m"], "v": rs["v"]})
        got = flatten({"p": p, "m": s["m"], "v": s["v"]})
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            if path[0] != "p" and moments == "bfloat16":
                assert leaf.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    leaf.view(torch.int16).numpy(),
                    np.asarray(want[path]).view(np.int16), err_msg=path)
            else:
                scaled_close(leaf, as_np(want[path]), 1e-6, 1e-7)


# ---------------------------------------------------------------- compression

def test_int8_error_feedback_psum():
    rng = np.random.default_rng(0)
    shards = [rng.normal(size=(64,)).astype(np.float32) for _ in range(4)]
    res = [np.zeros(64, np.float32) for _ in range(4)]
    true_mean = sum(shards) / 4
    mean, res = compress_psum_ref(shards, res)
    scale = max(np.abs(s).max() for s in shards) / 127
    assert np.abs(mean - true_mean).max() < scale * 1.01
    acc = np.zeros(64)
    for _ in range(30):
        mean, res = compress_psum_ref(shards, res)
        acc += mean
    np.testing.assert_allclose(acc / 30, true_mean, atol=1e-3)


def test_compress_psum_tree_one_rank_matches_ref():
    """Three rounds of error feedback on one rank (no group): the mean and
    the residuals equal the host oracle's bit for bit."""
    rng = np.random.default_rng(2)
    g = {"b": rng.normal(size=(5,)).astype(np.float32),
         "w": {"x": rng.normal(size=(4, 3)).astype(np.float32) * 7}}
    grads = {"b": torch.from_numpy(g["b"]),
             "w": {"x": torch.from_numpy(g["w"]["x"])}}
    res = init_residuals(grads)
    ref_res = {k: np.zeros(v.shape, np.float32)
               for k, v in flatten(grads).items()}
    for _ in range(3):
        mean, res = compress_psum_tree(grads, res)
        for k, gk in flatten(grads).items():
            want, (r,) = compress_psum_ref([gk.numpy()], [ref_res[k]])
            ref_res[k] = r
            np.testing.assert_array_equal(flatten(mean)[k].numpy(),
                                          want.astype(np.float32))
            np.testing.assert_array_equal(flatten(res)[k].numpy(), r)


def test_quantize_psum_over_a_group_of_one(tmp_path):
    """A gloo process group of one rank: the reduce is the identity, the
    error stays within one quantization step."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        g = torch.arange(8, dtype=torch.float32)
        out, res = quantize_psum(g, torch.zeros(8), group=dist.group.WORLD)
        alone, res_alone = quantize_psum(g, torch.zeros(8))
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, alone) and torch.equal(res, res_alone)
    assert float((out - g).abs().max()) <= 7.0 / 127 * 1.01
    assert torch.equal(out + res, g)


# ---------------------------------------------------------------- checkpoint

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.int32),
                       "h": torch.tensor([1.5, -2.25, 3e-3],
                                         dtype=torch.bfloat16)},
            "step": torch.tensor(3, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    store.save(str(tmp_path), 7, tree)
    assert store.latest_step(str(tmp_path)) == 7
    out = store.restore(str(tmp_path), 7, tree, device="cpu")
    for k, v in flatten(tree).items():
        got = flatten(out)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    man = json.loads((tmp_path / "step_000007" / "manifest.json").read_text())
    assert man["leaves"]["nested/h"] == {"shape": [3], "dtype": "bfloat16"}
    assert man["leaves"]["nested/b"]["dtype"] == "int32"
    raw = np.load(tmp_path / "step_000007" / "host_000.npz")
    assert raw["nested/h"].dtype == np.dtype("V2")


def test_checkpoint_latest_and_atomicity(tmp_path):
    tree = {"x": torch.zeros(2)}
    store.save(str(tmp_path), 1, tree)
    store.save(str(tmp_path), 5, tree)
    os.makedirs(tmp_path / "step_000009.tmp0", exist_ok=True)  # crashed save
    assert store.latest_step(str(tmp_path)) == 5
    assert store.latest_step(str(tmp_path / "none")) is None
    # a save over an existing step replaces it whole
    store.save(str(tmp_path), 5, {"x": torch.ones(2)})
    out = store.restore(str(tmp_path), 5, tree, device="cpu")
    assert torch.equal(out["x"], torch.ones(2))
    assert sorted(os.listdir(tmp_path)) == [
        "step_000001", "step_000005", "step_000009.tmp0"]


def test_restore_refuses_a_leaf_unlike_its_manifest(tmp_path):
    store.save(str(tmp_path), 0, {"x": torch.zeros(2)})
    man = tmp_path / "step_000000" / "manifest.json"
    meta = json.loads(man.read_text())
    meta["leaves"]["x"]["shape"] = [3]
    man.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="manifest"):
        store.restore(str(tmp_path), 0, {"x": None}, device="cpu")


def test_restore_default_device_raises_without_cuda(tmp_path, monkeypatch):
    store.save(str(tmp_path), 0, {"x": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        store.restore(str(tmp_path), 0, {"x": None})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, dtype):
    """The reference's optimizer-state checkpoint of tinyllama reduced
    (params in ``dtype``, float32 moments, an int32 step) restores into
    the port with every bit."""
    rc = ref_get_config("tinyllama-1.1b").reduced()
    rp = RT.init_params(rc, jax.random.PRNGKey(1), dtype=getattr(jnp, dtype))
    rs = ref_adamw.init_state(rp, ref_adamw.AdamWConfig())
    rs = dict(rs, step=jnp.int32(4))
    ref_store.save(str(tmp_path), 4, {"p": rp, "o": rs})
    like = {"p": T.init_params(
        get_config("tinyllama-1.1b").reduced(), 0,
        dtype=getattr(torch, dtype), device="meta"),
        "o": {"step": None, "m": None, "v": None}}
    like["o"]["m"] = like["o"]["v"] = like["p"]
    out = store.restore(str(tmp_path), store.latest_step(str(tmp_path)),
                        like, device="cpu")
    want = jflat({"p": rp, "o": rs})
    got = flatten(out)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        if dtype == "bfloat16" and k.startswith("p/"):
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert str(got[k].dtype) == f"torch.{w.dtype}", k
            np.testing.assert_array_equal(got[k].numpy(), w)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """A port f32 checkpoint (params, moments, int32 step) restores into
    the reference exactly."""
    cfg = get_config("tinyllama-1.1b").reduced()
    p = T.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    s = adamw.init_state(p, adamw.AdamWConfig())
    store.save(str(tmp_path), 2, {"p": p, "o": s})
    rc = ref_get_config("tinyllama-1.1b").reduced()
    rp = RT.init_params(rc, jax.random.PRNGKey(0), dtype=jnp.float32)
    like = {"p": rp, "o": ref_adamw.init_state(rp, ref_adamw.AdamWConfig())}
    out = ref_store.restore(str(tmp_path), ref_store.latest_step(
        str(tmp_path)), like)
    got = jflat(out)
    want = flatten({"p": p, "o": s})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.numpy().dtype, k
        np.testing.assert_array_equal(g, w.numpy())


@pytest.fixture(scope="module")
def merged_index(request):
    """rooms-S seed 1 at cell 2.0, merged to 30% of its label memory."""
    from repro.core.compression import compress_to_fraction
    from repro.core.grid import build_ehl

    scene, graph, hl = (request.getfixturevalue(n)
                        for n in ("scene_s", "graph_s", "hl_s"))
    idx = build_ehl(scene, cell_size=2.0, graph=graph, hl=hl)
    compress_to_fraction(idx, 0.3)
    return idx


def _same_index(a, b):
    assert (a.cell_size, a.nx, a.ny) == (b.cell_size, b.nx, b.ny)
    np.testing.assert_array_equal(a.mapper, b.mapper)
    assert sorted(a.regions) == sorted(b.regions)
    for rid, r in a.regions.items():
        o = b.regions[rid]
        assert [int(c) for c in r.cells] == [int(c) for c in o.cells]
        np.testing.assert_array_equal(r.keys, o.keys)
        np.testing.assert_array_equal(r.hubs, o.hubs)
        assert r.score == o.score


def test_ehl_index_cache_across_packages(tmp_path, merged_index):
    """The reference's blob loads into the port's ``EHLIndex`` and the
    port's into the reference's: the same mapper and regions."""
    from repro_torch.core.grid import EHLIndex

    idx = merged_index
    assert len(idx.regions) < idx.nx * idx.ny       # regions were merged
    ref_path = ref_store.save_ehl_index(str(tmp_path / "ref.npz"), idx)
    port = store.load_ehl_index(ref_path, idx.scene, idx.graph, idx.hl)
    assert isinstance(port, EHLIndex)
    _same_index(idx, port)
    port_path = store.save_ehl_index(str(tmp_path / "sub" / "port.npz"), port)
    assert not os.path.exists(port_path + ".tmp")
    back = ref_store.load_ehl_index(port_path, idx.scene, idx.graph, idx.hl)
    _same_index(idx, back)
    a, b = np.load(ref_path), np.load(port_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- data

def test_data_determinism_and_shard_disjointness():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8)
    a = synthetic_batch(cfg, 3)
    np.testing.assert_array_equal(a, synthetic_batch(cfg, 3))   # resumable
    assert a.dtype == np.int32 and a.shape == (8, 16)
    assert not np.array_equal(a, synthetic_batch(cfg, 4))       # steps differ
    h0 = DataConfig(vocab=1000, seq_len=16, global_batch=8, n_hosts=2,
                    host_id=0)
    h1 = DataConfig(vocab=1000, seq_len=16, global_batch=8, n_hosts=2,
                    host_id=1)
    assert host_batch_size(h0) == 4
    assert not np.array_equal(synthetic_batch(h0, 3), synthetic_batch(h1, 3))
    seeded = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=1)
    assert not np.array_equal(a, synthetic_batch(seeded, 3))


def test_host_batch_must_split_over_the_hosts():
    with pytest.raises(ValueError, match="does not split"):
        synthetic_batch(DataConfig(vocab=10, seq_len=4, global_batch=7,
                                   n_hosts=2), 0)


def test_tokens_in_vocab_range():
    cfg = DataConfig(vocab=77, seq_len=32, global_batch=4)
    t = synthetic_batch(cfg, 0)
    assert t.min() >= 0 and t.max() < 77
    # the recipe: a ramp plus noise in [0, 17) on a base token per row
    d = np.diff(t.astype(np.int64), axis=1) % 77    # 1 + noise step
    assert bool(np.all((d <= 17) | (d >= 77 - 15)))


def test_corpus_reader(tmp_path):
    """Windows of a file the test writes: whole windows, host shards
    disjoint, tokens mod vocab, deterministic in step, and the same
    windows as the reference's reader."""
    tokens = np.arange(10 * 8, dtype=np.int32) * 3
    path = tmp_path / "corpus.bin"
    tokens.tofile(path)
    kw = dict(vocab=50, seq_len=8, global_batch=4, n_hosts=2)
    r0 = CorpusReader(str(path), DataConfig(**kw, host_id=0))
    r1 = CorpusReader(str(path), DataConfig(**kw, host_id=1))
    b0, b1 = r0.batch(5), r1.batch(5)
    assert b0.shape == (2, 8) and b0.dtype == np.int32
    assert b0.max() < 50
    windows = tokens.reshape(10, 8) % 50
    picked = [int(np.flatnonzero((windows == row).all(axis=1))[0])
              for row in np.concatenate([b0, b1])]
    assert len(set(picked)) == 4                    # disjoint windows
    np.testing.assert_array_equal(b0, r0.batch(5))
    ref = ref_pipeline.CorpusReader(
        str(path), ref_pipeline.DataConfig(**kw, host_id=1))
    np.testing.assert_array_equal(b1, ref.batch(5))


# ---------------------------------------------------------------- fault

def test_step_guard_restores_and_replays(tmp_path):
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        if calls["n"] == 1:
            raise fault.SimulatedFault("boom")
        return state + 1

    guard = fault.StepGuard(str(tmp_path), save_every=1)
    out = guard.run(step_fn, 10, step=3, restore_fn=lambda: 10)
    assert out == 11
    assert guard.events and guard.events[0].kind == "device"


def test_step_guard_bounds_retries_then_resizes(tmp_path):
    def always(state, step):
        raise fault.SimulatedFault("lost")

    guard = fault.StepGuard(str(tmp_path), save_every=1, max_retries=2)
    with pytest.raises(fault.SimulatedFault):
        guard.run(always, 0, step=1, restore_fn=lambda: 0)
    assert [e.step for e in guard.events] == [1, 1, 1]
    resized = fault.StepGuard(str(tmp_path), 1, max_retries=1,
                              on_resize=lambda s: s + 100)
    out = resized.run(lambda s, k: s if s >= 100 else always(s, k), 0, 2,
                      restore_fn=lambda: 0)
    assert out == 100 and len(resized.events) == 2
    # only a simulated device loss is guarded
    with pytest.raises(ZeroDivisionError):
        guard.run(lambda s, k: 1 / 0, 0, 3, restore_fn=lambda: 0)


def test_plan_remesh():
    assert fault.plan_remesh(512, 16) == (32, 16)
    assert fault.plan_remesh(256, 16) == (16, 16)
    assert fault.plan_remesh(240, 16) == (15, 16)
    with pytest.raises(ValueError):
        fault.plan_remesh(8, 16)


def test_straggler_policy():
    p = fault.StragglerPolicy(threshold=2.0)
    assert p.stragglers() == []
    for _ in range(6):
        for h in range(4):
            p.record(h, 1.0 if h != 2 else 5.0)
    assert p.stragglers() == [2]
    small = fault.StragglerPolicy(window=3)
    for s in range(5):
        small.record(0, float(s))
    assert small._durations[0] == [2.0, 3.0, 4.0]


# ---------------------------------------------------------------- launcher

def test_main_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_main_trains_on_one_device_only(mesh, tmp_path):
    with pytest.raises(NotImplementedError, match="10c"):
        train.main(["--reduced", "--mesh", mesh, "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
