"""The LM port's serving decode (``init_cache``/``decode_step``) against the
reference's on the CPU.

For the six decode representatives of the reference's own test (plain GQA,
MLA's absorbed decode with MoE and a dense lead-in, local/global windows
with softcaps, the SSD state, the hybrid's parallel heads, the enc-dec
cross-attention cache), the reference's weights are carried across and the
same tokens stepped one at a time through both.  Every step's logits and
the whole cache after it must agree at float32, rtol 1e-4 and atol 1e-5
times the larger of 1 and the reference tensor's largest magnitude (as the
forward parity in ``test_torch_lm_model.py``).  The port's decode must
also equal its own forward at the reference test's rtol 2e-3 and atol
2e-4, a step must leave its input cache as it was, and the reference's
mid-sequence cache, carried across (``cache_from_numpy``), must continue
the sequence with the reference's next logits.

The cache clamp: a step at ``pos >= max_len`` overwrites the last slot, as
the reference's clamped ``dynamic_update_slice`` does; two steps past
``max_len`` give the reference's logits and caches (GQA, MLA, hybrid).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

from test_torch_lm_model import flat, perturbed, scaled_close  # noqa: E402

DECODE_ARCHS = ["tinyllama-1.1b", "deepseek-v3-671b", "gemma2-27b",
                "mamba2-780m", "hymba-1.5b", "whisper-large-v3"]
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cache_np(cache):
    return jax.tree.map(np.asarray, cache)


def reference_decode(arch, steps, max_len, seed=0):
    """The reference's per-step logits and caches (numpy) over ``steps``
    tokens into a cache of ``max_len`` positions (jitted step)."""
    rc = ref_get_config(arch).reduced()
    params = RT.init_params(rc, jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = jax.tree.map(lambda a, b: jnp.asarray(b, a.dtype), params,
                          perturbed(jax.tree.map(np.asarray, params), 23))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rc.vocab, (B, steps)).astype(np.int32)
    enc = (rng.standard_normal((B, rc.enc_seq, rc.d_model))
           .astype(np.float32) if rc.encdec else None)
    enc_out = RT.encode(rc, params, enc) if rc.encdec else None
    cache = RT.init_cache(rc, B, max_len, dtype=jnp.float32, enc_out=enc_out,
                          params=params)
    step = jax.jit(lambda p, c, t: RT.decode_step(rc, p, c, t))
    caches, logits = [cache_np(cache)], []
    for i in range(steps):
        lg, cache = step(params, cache, toks[:, i:i + 1])
        logits.append(np.asarray(lg))
        caches.append(cache_np(cache))
    return dict(params=jax.tree.map(np.asarray, params), toks=toks, enc=enc,
                logits=logits, caches=caches)


def assert_cache_close(got, want, what):
    assert got["step"] == int(want["step"]), what
    g = flat({k: v for k, v in got.items() if k != "step"})
    w = flat({k: v for k, v in want.items() if k != "step"})
    assert sorted(g) == sorted(w), what
    for path in w:
        assert g[path].dtype == torch.float32, (what, path)
        scaled_close(g[path], w[path], 1e-4, 1e-5)


def run_port(arch, ref, max_len):
    cfg = get_config(arch).reduced()
    params = T.params_from_numpy(ref["params"], device="cpu")
    enc_out = (T.encode(cfg, params, torch.from_numpy(ref["enc"]))
               if cfg.encdec else None)
    cache = T.init_cache(cfg, B, max_len, dtype=torch.float32,
                         enc_out=enc_out, params=params, device="cpu")
    assert_cache_close(cache, ref["caches"][0], f"{arch} init_cache")
    toks = torch.from_numpy(ref["toks"])
    outs = []
    for i in range(toks.shape[1]):
        before = T.tree_map(lambda a: a.clone() if isinstance(
            a, torch.Tensor) else a, cache)
        lg, new = T.decode_step(cfg, params, cache, toks[:, i:i + 1])
        for path, a in flat(before).items():
            if isinstance(a, torch.Tensor):
                assert torch.equal(flat(cache)[path], a), \
                    f"{arch} step {i} wrote its input cache at {path}"
        scaled_close(lg, ref["logits"][i], 1e-4, 1e-5)
        assert_cache_close(new, ref["caches"][i + 1], f"{arch} step {i}")
        outs.append(lg)
        cache = new
    return cfg, params, torch.cat(outs, dim=1)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference_step_by_step(arch):
    S = 16
    ref = reference_decode(arch, S, S)
    cfg, params, dec = run_port(arch, ref, S)
    # the reference's own mid-sequence cache, carried across, continues it
    mid = T.cache_from_numpy(ref["caches"][S // 2], device="cpu")
    assert mid["step"] == S // 2
    lg, _ = T.decode_step(cfg, params, mid,
                          torch.from_numpy(ref["toks"][:, S // 2:S // 2 + 1]))
    scaled_close(lg, ref["logits"][S // 2], 1e-4, 1e-5)
    enc = None if ref["enc"] is None else torch.from_numpy(ref["enc"])
    full = T.forward(cfg, params, torch.from_numpy(ref["toks"]),
                     enc_frames=enc)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b",
                                  "hymba-1.5b"])
def test_step_past_max_len_clamps_like_the_reference(arch):
    """max_len 4, six steps: steps 4 and 5 write slot 3 (the reference's
    ``dynamic_update_slice`` clamps its start), and the answers and caches
    still equal the reference's."""
    ref = reference_decode(arch, 6, 4, seed=1)
    run_port(arch, ref, 4)
    assert T._slot(4, 4) == T._slot(5, 4) == 3
    # the clamp is visible in the reference's own cache: slot 3 changed
    # on the step past max_len
    last = flat(ref["caches"][-1]["main"])
    prev = flat(ref["caches"][-2]["main"])
    key = "attn.k" if "attn.k" in last else "attn.c"
    assert not np.array_equal(last[key][:, :, 3], prev[key][:, :, 3])
    assert np.array_equal(last[key][:, :, :3], prev[key][:, :, :3])
