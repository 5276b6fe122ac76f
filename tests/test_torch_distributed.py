"""The port's sharding rules, hints, input stand-ins, mesh builders and the
batch-sharded ``PathServer`` on the CPU, against the reference where it
has a counterpart.

* Specs: for each of the ten configs, full and ``reduced()``, over a
  stand-in mesh with a ``shape`` mapping (16x16 and 2x16x16), the port's
  ``param_specs`` (from meta tensors), ``cache_specs`` and ``batch_spec``
  equal the reference's ``tuple(PartitionSpec)`` leaf by leaf (shapes from
  ``jax.eval_shape``).  Exact: the rules are a table.
* ``input_specs`` gives the reference's shapes and dtypes for every cell;
  ``hint`` is the identity off-mesh and on plain tensors.
* ``PathServer(mesh=(cpu, cpu), batch_sharding="rows")`` equals the
  unsharded server bit for bit on rooms-S (distances and argmin ids), and
  ``start_async`` raises with it.
* One spawn of 8 gloo ranks (``torch_dist_ranks.substrate_rank_main``):
  ``restore(shardings=)`` onto another mesh
  than the save-time one gives the saved values bit for bit;
  ``quantize_psum`` over the 8-rank group equals ``compress_psum_ref`` of
  the 8 ranks' gradients within one float32 ulp of the scale (the int32
  sum is exact, the dequantize the same float32 operations); and the
  launcher (``launch.train.main --mesh host --grad-compress``, 8 ranks,
  a fault injected) recovers and its loss falls.
"""

import os
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import input_specs as ref_input_specs  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, input_specs  # noqa: E402
from repro_torch.distributed import hints  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import LM_SHAPES  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

from torch_dist_ranks import WORLD, spawn, substrate_rank_main  # noqa: E402

POD = types.SimpleNamespace(shape={"data": 16, "model": 16},
                            axis_names=("data", "model"))
MULTIPOD = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                                 axis_names=("pod", "data", "model"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_flat(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in flat}


def ref_trees(rc, B, S):
    """(param shapes, cache shapes) of the reference, from eval_shape."""
    dt = jnp.bfloat16
    ps = jax.eval_shape(lambda k: RT.init_params(rc, k, dtype=dt),
                        jax.random.PRNGKey(0))
    if rc.encdec:
        e = jax.ShapeDtypeStruct((B, rc.enc_seq, rc.d_model), dt)
        cs = jax.eval_shape(lambda p, e: RT.init_cache(
            rc, B, S, dtype=dt, enc_out=e, params=p), ps, e)
    else:
        cs = jax.eval_shape(lambda: RT.init_cache(rc, B, S, dtype=dt))
    return ps, cs


def port_trees(cfg, B, S):
    pm = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
    e = (torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16,
                     device="meta") if cfg.encdec else None)
    cm = T.init_cache(cfg, B, S, dtype=torch.bfloat16, enc_out=e, params=pm,
                      device="meta")
    return pm, cm


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    for reduce in (False, True):
        rc, cfg = ref_get_config(arch), get_config(arch)
        if reduce:
            rc, cfg = rc.reduced(), cfg.reduced()
        sizes = ((4, 64), (1, 64)) if reduce else ((128, 32768),
                                                   (1, 524288))
        for B, S in sizes:
            rp, rcache = ref_trees(rc, B, S)
            pm, cm = port_trees(cfg, B, S)
            for mesh in (POD, MULTIPOD):
                for fsdp in (True, False):
                    want = ref_flat(RS.param_specs(rp, mesh, fsdp=fsdp))
                    got = flatten(SH.param_specs(pm, mesh, fsdp=fsdp))
                    assert got == want, (arch, reduce, mesh.shape, fsdp)
                want = ref_flat(RS.cache_specs(rcache, mesh))
                got = flatten(SH.cache_specs(cm, mesh))
                assert got == want, (arch, reduce, B, S, mesh.shape)
    for mesh in (POD, MULTIPOD):
        for seq in (False, True):
            assert SH.batch_spec(mesh, seq) == tuple(RS.batch_spec(mesh,
                                                                   seq))


def test_placements_one_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    # a tuple of axes shards one tensor dim over several mesh dims
    assert SH.placements((("pod", "data"), None), MULTIPOD) == (
        Shard(0), Shard(0), Replicate())
    assert SH.placements((None, "data", "model"), POD) == (Shard(1),
                                                           Shard(2))
    assert SH.placements((), MULTIPOD) == (Replicate(),) * 3
    # the spec is per tensor dim, the placements per mesh dim
    assert SH.placements(("model", "data"), POD) == (Shard(1), Shard(0))


def test_input_specs_match_reference():
    for arch in ARCH_IDS:
        rc, cfg = ref_get_config(arch), get_config(arch)
        for shape in LM_SHAPES:
            want = ref_input_specs(rc, shape)
            got = input_specs(cfg, shape)
            assert sorted(got) == sorted(want), (arch, shape.name)
            for k, w in want.items():
                assert tuple(got[k].shape) == tuple(w.shape)
                assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
                assert got[k].device.type == "meta"


def test_hint_is_identity_off_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert hints.current_mesh() is None
    assert hints.hint(x, ("pod", "data"), "model") is x
    with hints.mesh_hints(POD):
        assert hints.current_mesh() is POD
        assert hints.hint(x, ("pod", "data"), "model") is x   # plain
        assert hints.replicated(x) is x
        assert hints.splittable(x, -1, 3) is x
        assert hints.fsdp_gather({"w": x})["w"] is x
    assert hints.current_mesh() is None
    # the spec a hint asks for: absent axes dropped, non-dividing ones too
    assert hints.live_spec((32, 6, 64), (("pod", "data"), None, "model"),
                           POD) == (("data",), None, "model")
    assert hints.live_spec((8, 6), ("data", "model"), POD) == (None, None)


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import data_axes, make_production_mesh

    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            make_production_mesh(multi_pod=multi, device="cpu")
    assert data_axes(POD) == ("data",)
    assert data_axes(MULTIPOD) == ("pod", "data")


def test_loss_and_grads_zero_for_unused_leaves():
    """A block with no MLP (d_ff 0, as mamba2's published config) never
    reads its ``ln2``: the port's ``loss_and_grads`` gives it a zero
    gradient, as the reference's ``jax.grad`` does (it raised before), and
    the other leaves within rtol 1e-4 and atol 1e-5 times max(1, |leaf|)
    of the reference's (tests/test_torch_lm_grad.py's tolerance)."""
    import dataclasses

    from repro.models import transformer as ref_T
    from repro_torch.launch.train import loss_and_grads

    arch = "tinyllama-1.1b"
    rc = dataclasses.replace(ref_get_config(arch).reduced(), d_ff=0)
    cfg = dataclasses.replace(get_config(arch).reduced(), d_ff=0)
    tree = jax.tree.map(np.asarray, ref_T.init_params(
        rc, jax.random.PRNGKey(0), dtype=jnp.float32))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    want = jax.jit(jax.grad(lambda p: ref_T.loss_fn(
        rc, p, jnp.asarray(toks))))(jax.tree.map(jnp.asarray, tree))
    _, got = loss_and_grads(cfg, T.params_from_numpy(tree, device="cpu"),
                            torch.from_numpy(toks))
    got = flatten(got)
    assert not torch.any(got["blocks/ln2"])
    for k, w in ref_flat(want).items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(
                                       np.abs(w).max())), err_msg=k)


# ------------------------------------------------------ batch-sharded EHL

@pytest.fixture(scope="module")
def rooms_s():
    from repro_torch.core import packed
    from repro_torch.core.compression import compress_to_fraction
    from repro_torch.core.grid import build_ehl
    from repro_torch.core.maps import make_map
    from repro_torch.core.visgraph import build_visgraph
    from repro_torch.core.workload import uniform_queries

    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    qs = uniform_queries(scene, graph, 200, seed=5)
    return (idx, packed.pack_bucketed(idx, device="cpu"),
            qs.s.astype(np.float32), qs.t.astype(np.float32))


def test_batch_sharded_server_equals_unsharded(rooms_s):
    from repro_torch.serving import PathServer
    from repro_torch.serving.engine import BATCH_ROWS

    idx, bx, s, t = rooms_s
    plain = PathServer(bx, batch_size=32, backend="cuda", device="cpu")
    split = PathServer(bx, batch_size=32, backend="cuda", device="cpu",
                       mesh=("cpu", "cpu"), batch_sharding=BATCH_ROWS)
    split.warmup(paths=True)
    np.testing.assert_array_equal(split.query(s, t), plain.query(s, t))
    d1, p1 = plain.query_paths(s, t, host_index=idx)
    d2, p2 = split.query_paths(s, t, host_index=idx)
    np.testing.assert_array_equal(d2, d1)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(p1, p2))
    assert split.stats.batches == plain.stats.batches
    with pytest.raises(ValueError, match="synchronous-dispatch"):
        split.start_async()
    with pytest.raises(ValueError, match="one layout"):
        PathServer(bx, batch_size=32, device="cpu", mesh=("cpu",),
                   batch_sharding="cols")
    with pytest.raises(ValueError, match="row blocks"):
        PathServer(bx, batch_size=30, device="cpu", mesh=("cpu",) * 4,
                   batch_sharding=BATCH_ROWS)


def test_replicated_artifact_is_a_copy(rooms_s):
    from repro_torch.serving.query_engine import replicate_artifact

    _, bx, _, _ = rooms_s
    rep = replicate_artifact(bx, "cpu")
    assert rep is not bx and rep.widths == bx.widths
    for a, b in zip(rep.hub_ids, bx.hub_ids):
        assert torch.equal(a, b)
    assert torch.equal(rep.mapper, bx.mapper)


# ------------------------------------------------------------ multi-rank

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    spawn(substrate_rank_main, (str(work / "rdzv"), str(work)), 300)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]


def test_restore_onto_another_mesh(ranks):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    h = rng.standard_normal((8, 16)).astype(np.float32)
    h16 = torch.from_numpy(h).to(torch.bfloat16).view(torch.int16).numpy()
    for res in ranks:
        for shape in ((2, 4), (8, 1)):
            np.testing.assert_array_equal(res[f"restore/{shape}/w"], w)
            np.testing.assert_array_equal(res[f"restore/{shape}/b"],
                                          np.arange(8))
            np.testing.assert_array_equal(res[f"restore/{shape}/h"], h16)
            assert bool(res[f"replicated/{shape}"])


def test_multi_rank_grad_compress_matches_oracle(ranks):
    from repro_torch.optim.compression import compress_psum_ref

    gs = [np.random.default_rng(100 + r).standard_normal((64, 33)).astype(
        np.float32) for r in range(WORLD)]
    rs = [np.random.default_rng(200 + r).standard_normal((64, 33)).astype(
        np.float32) * 1e-3 for r in range(WORLD)]
    mean, new_res = compress_psum_ref(gs, rs)
    ulp = np.spacing(np.float32(np.abs(mean).max()))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["psum/mean"], mean, rtol=0, atol=ulp)
        np.testing.assert_allclose(res["psum/res"], new_res[r], rtol=0,
                                   atol=np.spacing(np.float32(1.0)) * 4)
    # every rank holds the same mean
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["psum/mean"], ranks[0]["psum/mean"])


def test_launcher_on_eight_ranks(ranks):
    losses = ranks[0]["train/losses"]
    assert len(losses) == 6 and bool(ranks[0]["train/restored"])
    assert losses[-1] < losses[0], losses
