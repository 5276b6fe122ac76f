"""The LM port's training loss (``repro_torch.models.transformer.loss_fn``)
and its gradients against the reference's ``jax.value_and_grad`` on the
CPU, for the dense attention families; ``test_torch_lm_grad_mixers.py``
holds the MoE, MLA, SSD, hybrid and enc-dec families and the MTP head.

Setup, as the forward parity tests (``test_torch_lm_model.py``): reduced
configs, float32, the reference's weights carried across with every
zero-initialised leaf set to small random values, and a carried (B = 2,
S = 32) token batch (seed 0).  The reference's ``value_and_grad`` is
jitted.

Tolerances, stated before comparing: the loss and every gradient leaf
within rtol 1e-4 and atol 1e-5 times the larger of 1 and the reference
leaf's largest magnitude (``scaled_close``), as the forward tests hold
logits.  mamba2 alone takes atol 5e-5 times that scale: its loss sits at
~30 at random init, and its three-operand SSD einsums contract in another
order in torch than in XLA; its float32 gradients differ from the
reference's by up to 2.2 times the 1e-5 budget.

Measured, max |port - reference| over a leaf divided by that leaf's scale
(CPU, torch 2.13): tinyllama 4.8e-08, nemotron 7.1e-08, qwen2-vl 5.2e-08,
gemma2 9.7e-08, gemma3 2.0e-07, deepseek 6.3e-08, llama4 4.1e-08, hymba
4.5e-06, mamba2 7.0e-05 (on ``conv_b``, inside rtol 1e-4 of those
elements), whisper 5.2e-07; the losses agree to 7.6e-06
(gemma3, 62.2).

Also: the remat policies ``full``, ``dots`` and ``none`` give bit-equal
gradients on the CPU; remat runs only while grad is enabled; the chunked
CE at a chunk that does not divide S equals the unchunked CE and the
reference's.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.train import loss_and_grads  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,  # noqa: E402
                                     init_state)
from repro_torch.tree import flatten, unflatten  # noqa: E402
from test_torch_lm_model import perturbed, scaled_close, widened  # noqa: E402

DENSE_ARCHS = ("tinyllama-1.1b", "nemotron-4-340b", "qwen2-vl-72b",
               "gemma2-27b", "gemma3-12b")
RTOL, ATOL = 1e-4, 1e-5
# mamba2's SSD gradients: see the module docstring
ATOL_BY_ARCH = {"mamba2-780m": 5e-5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_tree(arch: str, seed: int = 3):
    """The reference's reduced float32 parameters as numpy, zero leaves
    perturbed."""
    rc = ref_get_config(arch).reduced()
    tree = RT.init_params(rc, jax.random.PRNGKey(0), dtype=jnp.float32)
    return perturbed(widened(tree), seed)


def batch(cfg, B: int = 2, S: int = 32, seed: int = 0):
    """(tokens int32 [B, S], encoder frames or None) as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
           .astype(np.float32) if cfg.encdec else None)
    return toks, enc


@functools.lru_cache(maxsize=None)
def reference_case(arch: str):
    """(numpy params, tokens, encoder frames, the reference's loss, its
    {"/"-joined path: numpy gradient}) of one reduced family, from the
    reference's jitted ``value_and_grad`` of ``loss_fn`` (kept for the
    module's other tests)."""
    rc = ref_get_config(arch).reduced()
    tree = reference_tree(arch)
    toks, enc = batch(rc)
    fn = jax.jit(jax.value_and_grad(
        lambda p, t, e: RT.loss_fn(rc, p, t, enc_frames=e)))
    loss, grads = fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                     None if enc is None else jnp.asarray(enc))
    flat, _ = jtu.tree_flatten_with_path(grads)
    return tree, toks, enc, float(loss), {
        "/".join(str(k.key) for k in path): np.asarray(g) for path, g in flat}


def port_loss_and_grads(cfg, params, toks, enc=None):
    """The port's loss and {path: gradient} over every leaf of ``params``
    (``launch.train.loss_and_grads``)."""
    loss, grads = loss_and_grads(cfg, params, toks, enc)
    return loss, flatten(grads)


def check_against_reference(arch: str) -> None:
    """The port's loss and gradients == the reference's at the stated
    tolerance."""
    cfg = get_config(arch).reduced()
    tree, toks, enc, want_loss, want = reference_case(arch)
    loss, got = port_loss_and_grads(
        cfg, T.params_from_numpy(tree, device="cpu"),
        torch.from_numpy(toks), None if enc is None else torch.from_numpy(enc))
    atol = ATOL_BY_ARCH.get(arch, ATOL)
    scaled_close(loss, np.float32(want_loss), RTOL, atol)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        scaled_close(g, want[path], RTOL, atol)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_against_reference(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_policies_give_bit_equal_grads(arch):
    """``full``, ``dots`` and ``none`` compute the same float32 ops; on the
    CPU the recomputed ones round the same way, so every gradient is
    bit-equal."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, 5, dtype=torch.float32, device="cpu")
    toks, enc = batch(cfg, S=16)
    toks = torch.from_numpy(toks)
    enc = None if enc is None else torch.from_numpy(enc)
    runs = {m: port_loss_and_grads(dataclasses.replace(cfg, remat=m),
                                   params, toks, enc)
            for m in ("full", "dots", "none")}
    loss, grads = runs["none"]
    for m in ("full", "dots"):
        assert torch.equal(runs[m][0], loss), m
        for path, g in grads.items():
            assert torch.equal(runs[m][1][path], g), (m, path)


def test_remat_only_while_grad_is_enabled(monkeypatch):
    """Serving (grad off) never enters a checkpoint; the loss under grad
    checkpoints every block of ``blocks`` and every CE chunk."""
    cfg = get_config("tinyllama-1.1b").reduced()
    params = T.init_params(cfg, 5, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(batch(cfg, S=16)[0])
    real = T.checkpoint
    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counting)
    with torch.no_grad():
        T.forward(cfg, params, toks)
        T.loss_fn(cfg, params, toks)
    assert calls == []
    port_loss_and_grads(cfg, params, toks)
    chunks = -(-(toks.shape[1] - 1) // cfg.ce_chunk)
    assert len(calls) == cfg.n_layers + chunks
    calls.clear()
    port_loss_and_grads(dataclasses.replace(cfg, remat="none"), params, toks)
    assert len(calls) == chunks


@pytest.mark.parametrize("chunk", [5, 8])
def test_chunked_ce_at_an_uneven_chunk(chunk):
    """S = 37 in chunks of 5 or 8 (padded, mask 0 on the pad) equals the
    unchunked CE and the reference's ``_chunked_ce`` at the same chunk,
    loss and gradient; half the mask is 0 (rtol 1e-6, atol 1e-6 times the
    scale: only the float32 sum order differs)."""
    arch = "gemma2-27b"          # tied embeddings and a logit softcap
    cfg = dataclasses.replace(get_config(arch).reduced(), ce_chunk=chunk)
    rc = dataclasses.replace(ref_get_config(arch).reduced(), ce_chunk=chunk)
    tree = reference_tree(arch)
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    mask = (rng.random((2, 37)) < 0.5).astype(np.float32)

    def port(c):
        h = torch.from_numpy(hidden).requires_grad_(True)
        loss = T._chunked_ce(c, T.params_from_numpy(tree, device="cpu"), h,
                             torch.from_numpy(tgt), torch.from_numpy(mask))
        return loss, torch.autograd.grad(loss, h)[0]

    loss, gh = port(cfg)
    whole, gwhole = port(dataclasses.replace(cfg, ce_chunk=64))
    want, gwant = jax.value_and_grad(
        lambda h: RT._chunked_ce(rc, jax.tree.map(jnp.asarray, tree), h,
                                 jnp.asarray(tgt), jnp.asarray(mask)))(
        jnp.asarray(hidden))
    scaled_close(loss.detach(), np.float32(float(whole.detach())), 1e-6, 1e-6)
    scaled_close(gh, gwhole.numpy(), 1e-6, 1e-6)
    scaled_close(loss.detach(), np.float32(float(want)), 1e-6, 1e-6)
    scaled_close(gh, np.asarray(gwant), 1e-6, 1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    """The reference's per-family smoke test (``test_models_smoke.py``):
    the loss and gradients are finite and not all zero, and one AdamW step
    (lr 1e-3, no warmup) does not raise the loss by 1 or more."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    toks, enc = batch(cfg)
    toks = torch.from_numpy(toks)
    enc = None if enc is None else torch.from_numpy(enc)
    loss, grads = port_loss_and_grads(cfg, params, toks, enc)
    assert bool(torch.isfinite(loss))
    gn = sum(float(g.abs().sum()) for g in grads.values())
    assert np.isfinite(gn) and gn > 0
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    new, _, _ = apply_updates(params, unflatten(grads),
                              init_state(params, ocfg), ocfg)
    with torch.no_grad():
        loss2 = T.loss_fn(cfg, new, toks, enc_frames=enc)
    assert bool(torch.isfinite(loss2))
    assert float(loss2) < float(loss) + 1.0
