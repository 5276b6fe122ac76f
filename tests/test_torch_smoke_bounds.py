"""The bound counters and main-path operands of ``chip_smoke.py``, on the CPU.

``chip_smoke.py`` states each kernel's bound from what the run's inputs
need: ``pairs_needed`` counts the (segment, edge) pairs up to each
segment's first blocking edge, ``slots_needed`` the same over gathered
tiles, ``join_bytes`` the sorted join's bytes.  These tests hold the
counters against brute-force loops, and the main-path operand builder
against the serving path's own shapes, so the printed bounds stay honest.
The script imports torch lazily, so it loads here without a card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compression import compress_to_fraction
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.packed import HUB_PAD, pack_bucketed
from repro_torch.core.visgraph import build_visgraph
from repro_torch.core.workload import uniform_queries
from repro_torch.kernels import ref
from repro_torch.kernels.segvis import SMS, block_threads, launch_shape
from repro_torch.serving import TorchEngine


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


def _brute_needed(p, q, a, b, c) -> int:
    """Pairs evaluated by a loop that skips degenerate edges (a == b) and
    stops at the first blocking edge."""
    total = 0
    for i in range(len(p)):
        for k in range(len(a)):
            if (a[k] == b[k]).all():
                continue
            total += 1
            if ref.blocked_pairs(*(torch.tensor(x) for x in (
                    p[i, 0], p[i, 1], q[i, 0], q[i, 1], a[k, 0], a[k, 1],
                    b[k, 0], b[k, 1], c[k, 0], c[k, 1]))):
                break
    return total


@pytest.mark.parametrize("n,e,chunk", [(40, 12, 8192), (37, 9, 5), (1, 1, 1)])
def test_pairs_needed_matches_a_stopping_loop(n, e, chunk):
    rng = np.random.default_rng(n + e)
    p, q, a, b, c = (rng.uniform(0, 10, (k, 2)).astype(np.float32)
                     for k in (n, n, e, e, e))
    q[: n // 4] = a[0]                            # contacts on a vertex
    b[1::3] = a[1::3]                             # degenerate edges
    args = [torch.from_numpy(x) for x in (p, q, a, b, c)]
    want = _brute_needed(p, q, a, b, c)
    assert cs.pairs_needed(args, chunk=chunk) == want
    assert want <= n * e


def test_degenerate_edges_never_block_the_twin():
    """What lets the dense kernel skip a == b edges: the twin never blocks
    on one, contacts included."""
    rng = np.random.default_rng(5)
    p, q = (rng.integers(0, 4, (400, 2)).astype(np.float32) for _ in "pq")
    a, c = (rng.integers(0, 4, (60, 2)).astype(np.float32) for _ in "ac")
    a[:3] = p[:3]                                 # on a segment's endpoint
    a[3:6] = (p[3:6] + q[3:6]) / 2                # on a segment's interior
    args = [torch.from_numpy(x) for x in (p, q, a, a.copy(), c)]
    assert ref.segvis_ref(*args).all()
    assert cs.pairs_needed(args) == 0


def test_slots_needed_matches_pairs_needed_per_segment():
    """Tiles that repeat the dense edge list need as many slots as pairs."""
    rng = np.random.default_rng(3)
    n, e = 30, 10
    p, q, a, b, c = (rng.uniform(0, 10, (k, 2)).astype(np.float32)
                     for k in (n, n, e, e, e))
    planes = [torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(x[None, :, i], (n, e)))) for x in (a, b, c)
        for i in (0, 1)]
    dense = [torch.from_numpy(x) for x in (p, q, a, b, c)]
    assert cs.slots_needed(dense[:2] + planes) == cs.pairs_needed(dense)


def test_needed_counts_first_true_or_all():
    blk = torch.tensor([[False, True, True], [False, False, False],
                        [True, False, False]])
    assert cs.needed(blk) == 2 + 3 + 1


@pytest.mark.parametrize("B,L", [(256, 512), (1, 1), (3, 1500)])
def test_join_counts(B, L):
    assert cs.join_bytes(B, L) == 20 * B * L
    assert cs.join_dense_ops(B, L) == 3 * B * L * L


@pytest.mark.parametrize("B,L", [(256, 512), (1, 1), (3, 1500)])
def test_join_bytes_with_narrow_distances(B, L):
    # hubs 4 + 4, distances 2 + 2, output 4 bytes a label
    assert cs.join_bytes(B, L, 2) == 16 * B * L
    assert cs.join_bytes(B, L, 4) == cs.join_bytes(B, L)


def test_within_qerr_holds_the_quantized_bound():
    b = np.array([10.0, 20.0, np.inf], np.float32)
    assert cs.within_qerr(b + np.float32(0.5), b, 0.25)
    assert not cs.within_qerr(b + np.float32(0.51), b, 0.25)
    assert not cs.within_qerr(np.array([10.0, np.inf, np.inf], np.float32),
                              b, 1.0)
    assert cs.within_qerr(b, b, 0.0)


def test_segvis_ops_per_pair_counts_the_hoisted_predicate():
    # 6 endpoint differences, 8 products, 4 signs x (3 ops + 2 compares)
    assert cs.SEGVIS_OPS_PER_PAIR == 34
    assert cs.TILE_OPS_PER_SLOT == 36
    assert 33e12 < cs.F32_UNFUSED_ISSUE_PER_S < 34e12


@pytest.mark.parametrize("n", [1, 256, 4096, 32768, 65536, 131072, 300000])
def test_launch_shape_fills_the_card(n):
    """A power-of-two group in 1..32, whole warps, and at least one block
    per SM wherever N*G allows it."""
    g, threads = launch_shape(n)
    assert g in (1, 2, 4, 8, 16, 32) and threads % 32 == 0
    assert g == (32 if n <= 256 else 1) or 256 < n < SMS * 64
    assert 32 <= threads <= 256 and threads == block_threads(n, g)
    blocks = -(-n * g // threads)
    assert blocks >= SMS or threads == 32
    if n >= 256:
        assert blocks >= SMS


def test_main_path_operands_have_the_serving_shapes():
    """For every bucket: fold segments N = B*W per side, co-visibility
    N = B, and hub-sorted masked rows [B, W] for the join."""
    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    bx = pack_bucketed(idx, edge_grid=False, device="cpu")
    qs = uniform_queries(scene, graph, 200, seed=4)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    B = 16
    ops = cs.main_path_operands(bx, TorchEngine(bx), s, t, B)
    assert sorted(ops) == sorted(bx.widths)
    for w, (fold_s, fold_t, covis, join) in ops.items():
        for fold in (fold_s, fold_t):
            assert tuple(fold[0].shape) == tuple(fold[1].shape) == (B * w, 2)
            assert all(x.is_contiguous() for x in fold)
        assert tuple(covis[0].shape) == (B, 2)
        hub_s, vd_s, hub_t, vd_t = join
        for hub, vd in ((hub_s, vd_s), (hub_t, vd_t)):
            assert tuple(hub.shape) == tuple(vd.shape) == (B, w)
            assert hub.dtype == torch.int32 and vd.dtype == torch.float32
            assert (hub[:, 1:] >= hub[:, :-1]).all()
            assert not torch.isnan(vd).any()
            assert (vd[hub == int(HUB_PAD)] == float("inf")).all()
        # the serving path's answers on the same batch come from these rows
        rowmin = ref.label_join_rowmin_ref(*join)
        assert rowmin.shape == (B, w)
