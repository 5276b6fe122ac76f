"""The LM port's model (``repro_torch.models.transformer``) against the
reference's (``repro.models.transformer``) on the CPU.

* Init trees: for all ten architectures at their published widths, the
  port's ``init_params`` on the ``meta`` device has the reference's key
  paths, shapes and dtypes (``jax.eval_shape``) and parameter count.
* Init statistics: at reduced size every ``dense_init`` leaf has the
  reference's scale (std within 5%), norms and biases are zero, ``D`` one.
* Forward and prefill: reduced size, the reference's weights carried
  across (``params_from_numpy``), every zero-initialised leaf first set to
  small random values so each norm and bias is exercised.  float32: rtol
  1e-4 and atol 1e-5 times the larger of 1 and the reference logits'
  largest magnitude (the SSM families' logits reach ~50, and the
  reference's own jitted and eager forwards differ by 5e-5 on reduced
  mamba2).  bf16: the reference's bf16 weights (widened to float32 on the
  JAX side, an exact round trip) in both; rtol 0 and atol 3e-2 times that
  scale, the median error under 5e-3 times it (measured: at most 2.4e-2
  and 2.7e-3, on mamba2).  The two round to bf16 at the same points, but
  their float32 sums differ in order, and a flipped rounding of a bf16
  activation moves it by 2^-8 relative.
* ``TransformerLM``: ``state_dict()`` keys are the reference's pytree paths
  and its forward is the function's.

The reference is jitted, its outputs held as numpy in module-scoped
caches.  Decode, the cache clamp and ``LMServer`` are in
``test_torch_lm_decode.py`` and ``test_torch_lm_server.py``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import ARCH_IDS, all_cells, get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ZERO_LEAVES = {"ln1", "ln2", "lnx", "final_norm", "norm", "q_norm",
               "kv_norm", "q_scale", "k_scale", "conv_b", "A_log", "dt_bias"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def scaled_close(got, want, rtol, atol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def widened(tree):
    """A reference pytree as numpy, bf16 widened to float32 (exact)."""
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


def perturbed(tree, seed):
    """Zero-initialised leaves (norms, biases, SSD gates) set to small
    random values, so the parity tests see every one of them."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturbed(v, seed + 1)
        elif k in ZERO_LEAVES:
            out[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def test_registry_matches_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_get_config(arch))
        assert get_config(arch).param_count() == \
            ref_get_config(arch).param_count()
    assert len(list(all_cells())) == 40
    with pytest.raises(KeyError):
        get_config("gpt-5")


# ---------------------------------------------------------------------------
# init trees at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_tree_matches_reference_at_full_width(arch):
    rc, pc = ref_get_config(arch), get_config(arch)
    want = flat(jax.eval_shape(
        lambda k: RT.init_params(rc, k, dtype=jnp.bfloat16),
        jax.random.PRNGKey(0)))
    got = flat(T.init_params(pc, 0, dtype=torch.bfloat16, device="meta"))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype) == f"torch.{np.dtype(leaf.dtype)}", path
    assert sum(t.numel() for t in got.values()) == \
        sum(int(np.prod(s.shape)) for s in want.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_statistics(arch):
    """dense_init's scale (fan_in ** -0.5 unless the reference names one)
    within 5% on every leaf of at least 4096 values; zeros and ones where
    the reference puts them."""
    cfg = get_config(arch).reduced()
    tree = flat(T.init_params(cfg, 1, dtype=torch.float32, device="cpu"))
    for path, t in tree.items():
        leaf = path.split(".")[-1]
        if leaf in ZERO_LEAVES:
            assert bool((t == 0).all()), path
            continue
        if leaf == "D":
            assert bool((t == 1).all()), path
            continue
        scale = {"embed": 1.0, "router": 0.02,
                 "conv_w": cfg.ssm.conv_width ** -0.5 if cfg.ssm else None
                 }.get(leaf) or t.shape[-2] ** -0.5
        if t.numel() >= 4096:
            assert abs(float(t.std()) / scale - 1) < 0.05, (path, scale)
            assert abs(float(t.mean())) < 0.05 * scale, path


def test_init_is_seeded():
    cfg = get_config("tinyllama-1.1b").reduced()
    a = T.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    b = T.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    c = T.init_params(cfg, 4, dtype=torch.float32, device="cpu")
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["blocks"]["attn"]["wq"], c["blocks"]["attn"]["wq"])


# ---------------------------------------------------------------------------
# forward and prefill, weights carried across
# ---------------------------------------------------------------------------

B, S = 2, 32


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
           .astype(np.float32) if cfg.encdec else None)
    return toks, enc


def reference_case(arch, dtype):
    """Reference params (perturbed), inputs and jitted outputs as numpy."""
    rc = ref_get_config(arch).reduced()
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    params = RT.init_params(rc, jax.random.PRNGKey(0), dtype=jdt)
    params = jax.tree.map(lambda a, b: jnp.asarray(b, a.dtype), params,
                          perturbed(widened(params), 11))
    toks, enc = inputs(rc)
    enc_j = None if enc is None else jnp.asarray(enc, jdt)
    logits, hidden = jax.jit(lambda p, t, e: RT.forward(
        rc, p, t, enc_frames=e, return_hidden=True))(params, toks, enc_j)
    out = dict(params=widened(params), toks=toks,
               enc=None if enc is None else np.asarray(enc_j.astype(
                   jnp.float32)),
               logits=np.asarray(logits),
               hidden=np.asarray(hidden.astype(jnp.float32)))
    if dtype == "f32":
        out["prefill"] = np.asarray(jax.jit(lambda p, t, e: RT.prefill(
            rc, p, t, enc_frames=e))(params, toks, enc_j))
    return out


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(arch, dtype="f32"):
        if (arch, dtype) not in cache:
            cache[(arch, dtype)] = reference_case(arch, dtype)
        return cache[(arch, dtype)]
    return get


def port_inputs(ref, dtype=torch.float32):
    toks = torch.from_numpy(ref["toks"])
    enc = (None if ref["enc"] is None
           else torch.from_numpy(ref["enc"].copy()).to(dtype))
    return toks, enc


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch, reference):
    ref = reference(arch)
    cfg = get_config(arch).reduced()
    params = T.params_from_numpy(ref["params"], device="cpu")
    toks, enc = port_inputs(ref)
    logits, hidden = T.forward(cfg, params, toks, enc_frames=enc,
                               return_hidden=True)
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, cfg.vocab)
    scaled_close(logits, ref["logits"], 1e-4, 1e-5)
    scaled_close(hidden, ref["hidden"], 1e-4, 1e-5)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_reference(arch, reference):
    ref = reference(arch)
    cfg = get_config(arch).reduced()
    params = T.params_from_numpy(ref["params"], device="cpu")
    toks, enc = port_inputs(ref)
    got = T.prefill(cfg, params, toks, enc_frames=enc)
    assert got.shape == (B, 1, cfg.vocab)
    scaled_close(got, ref["prefill"], 1e-4, 1e-5)
    scaled_close(got, ref["logits"][:, -1:], 1e-4, 1e-5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b",
                                  "gemma2-27b", "mamba2-780m", "hymba-1.5b",
                                  "whisper-large-v3"])
def test_bf16_forward_matches_reference(arch, reference):
    ref = reference(arch, "bf16")
    cfg = get_config(arch).reduced()
    params = T.params_from_numpy(ref["params"], device="cpu",
                                 dtype=torch.bfloat16)
    assert params["embed"].dtype == torch.bfloat16
    if "moe" in params["blocks"]:
        assert params["blocks"]["moe"]["router"].dtype == torch.float32
    if "ssm" in params["blocks"]:
        assert params["blocks"]["ssm"]["A_log"].dtype == torch.float32
    toks, enc = port_inputs(ref, torch.bfloat16)
    got = T.forward(cfg, params, toks, enc_frames=enc)
    assert got.dtype == torch.float32
    scaled_close(got, ref["logits"], 0.0, 3e-2)
    err = np.abs(got.numpy() - ref["logits"])
    assert np.median(err) < 5e-3 * max(1.0, np.abs(ref["logits"]).max())


def test_embed_scale_rounds_the_scale_to_the_dtype_first():
    """gemma: x * sqrt(d_model) with the scale rounded to bf16 first."""
    cfg = get_config("gemma2-27b").reduced()
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    want = jnp.asarray(x.float().numpy(), jnp.bfloat16) * \
        jnp.asarray(cfg.d_model ** 0.5, jnp.bfloat16)
    got = T._scale_embed(cfg, x)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_windows_follow_the_layer_pattern():
    cfg = get_config("gemma2-27b").reduced()
    rc = ref_get_config("gemma2-27b").reduced()
    assert T._windows(cfg, 4) == np.asarray(RT._windows(rc, 4)).tolist()
    ds = get_config("deepseek-v3-671b").reduced()
    assert T._windows(ds, 1, 1) == np.asarray(
        RT._windows(ref_get_config("deepseek-v3-671b").reduced(), 1, 1)
    ).tolist()
    for n in (1, 7, 100, 4096):
        assert T._capacity(ds, n) == RT._capacity(
            ref_get_config("deepseek-v3-671b").reduced(), n)


def test_transformer_lm_module(reference):
    arch = "deepseek-v3-671b"
    ref = reference(arch)
    cfg = get_config(arch).reduced()
    model = T.TransformerLM(cfg, T.params_from_numpy(ref["params"], "cpu"),
                            device="cpu")
    assert sorted(model.state_dict()) == sorted(flat(ref["params"]))
    assert not any(p.requires_grad for p in model.parameters())
    toks, _ = port_inputs(ref)
    scaled_close(model(toks), ref["logits"], 1e-4, 1e-5)
    scaled_close(T.prefill(cfg, model.params, toks), ref["prefill"], 1e-4,
                 1e-5)
    fresh = T.TransformerLM(cfg, key=5, dtype=torch.float32, device="cpu")
    assert sorted(fresh.state_dict()) == sorted(model.state_dict())
