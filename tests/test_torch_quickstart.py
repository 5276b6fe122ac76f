"""``examples/quickstart_torch.py`` on the CPU beside the reference
quickstart's steps on the same seeds (rooms-S seed 1, cell 2.0, EHL*-25,
five uniform queries of seed 7): the same scene, label memory and
compression outcome, the same host answers, and batched distances (the
kernels' twins on CPU tensors) within rtol 1e-6 of the reference's
``query_batch``."""

import importlib.util
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "quickstart_torch.py"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_run():
    spec = importlib.util.spec_from_file_location("quickstart_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(device="cpu")


@pytest.fixture(scope="module")
def ref_run():
    """The reference quickstart's steps (``examples/quickstart.py``)."""
    import jax.numpy as jnp

    from repro.core import (build_ehl, build_visgraph, compress_to_fraction,
                            make_map, pack_index, query, query_batch,
                            uniform_queries)

    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    index = build_ehl(scene, cell_size=2.0, graph=graph)
    memory = index.label_memory()
    stats = compress_to_fraction(index, 0.25)
    qs = uniform_queries(scene, graph, 5, seed=7)
    host = [query(index, s, t) for s, t in zip(qs.s[:3], qs.t[:3])]
    d = query_batch(pack_index(index), jnp.asarray(qs.s), jnp.asarray(qs.t))
    return {"scene": scene, "label_memory": memory, "stats": stats,
            "queries": qs, "host": host, "d": np.asarray(d)}


def test_quickstart_builds_what_the_reference_builds(port_run, ref_run):
    got, want = port_run, ref_run
    assert len(got["scene"].polygons) == len(want["scene"].polygons)
    assert int(got["scene"].convex_mask.sum()) == \
        int(want["scene"].convex_mask.sum())
    assert got["label_memory"] == want["label_memory"]
    for field in ("final_bytes", "merges", "regions"):
        assert getattr(got["stats"], field) == getattr(want["stats"], field)
    np.testing.assert_array_equal(got["queries"].s, want["queries"].s)
    np.testing.assert_array_equal(got["queries"].t, want["queries"].t)
    np.testing.assert_allclose([d for d, _ in got["host"]],
                               [d for d, _ in want["host"]], rtol=1e-9)
    assert [len(p) for _, p in got["host"]] == \
        [len(p) for _, p in want["host"]]


def test_quickstart_batched_distances_match_reference(port_run, ref_run):
    d = port_run["d"]
    assert d.dtype == np.float32 and d.shape == (5,)
    np.testing.assert_allclose(d, ref_run["d"], rtol=1e-6)
    np.testing.assert_allclose(d[:3], [h for h, _ in port_run["host"]],
                               rtol=1e-4)
