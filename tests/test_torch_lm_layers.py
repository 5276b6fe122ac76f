"""The LM port's layers (``repro_torch.models.layers`` and ``.ssm``) against
the reference's (``repro.models.layers`` and ``.ssm``) on the CPU.

The same float32 inputs, made from a seed with numpy, go through both.
Tolerance: rtol 1e-5 and atol 1e-6 times the larger of 1 and the
reference output's largest magnitude.  A float32 sum of many products
(attention's ``p·v``, the SSD's intra-chunk form) carries rounding relative
to its terms, not to itself, so an output element near 0 in a tensor whose
terms reach 10 is only known to ~1e-6 x 10; the reference's own jitted and
eager runs differ by that much on the SSD.  Covered: rmsnorm, rope and
M-RoPE, the blocked flash attention (causal, windowed, softcapped, GQA,
S not a multiple of either chunk), decode attention with a window, every
MLP activation (gelu is the tanh approximation), the GQA and MLA
projections, the MoE block with capacity drops, ties and the sigmoid
router, and the Mamba-2 SSD pieces.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def tree_t(tree):
    return {k: tree_t(v) if isinstance(v, dict) else T(v)
            for k, v in tree.items()}


def layer0(tree):
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


def reduced(arch):
    """The reference's and the port's reduced config (equal dataclasses)."""
    rc, pc = ref_get_config(arch).reduced(), get_config(arch).reduced()
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    return rc, pc


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, w = rand(rng, 2, 5, 16, scale=3.0), rand(rng, 16, scale=0.5)
    close(L.rmsnorm(T(x), T(w), 1e-6), RL.rmsnorm(x, w, 1e-6))


@pytest.mark.parametrize("hd,theta", [(16, 10000.0), (64, 1e6)])
def test_rope(hd, theta):
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, 4000, (2, 7))
    cos, sin = L.rope_angles(T(pos), hd, theta)
    rcos, rsin = RL.rope_angles(jnp.asarray(pos), hd, theta)
    close(cos, rcos)
    close(sin, rsin)
    x = rand(rng, 2, 7, 3, hd)
    close(L.apply_rope(T(x), cos, sin),
          RL.apply_rope(x, np.asarray(rcos), np.asarray(rsin)))


def test_mrope_three_streams():
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 7, 4, 16)
    pos3 = rng.integers(0, 300, (3, 2, 7))        # three distinct streams
    sec = L.mrope_sections(16)
    assert sec == (2, 3, 3)
    close(L.apply_mrope(T(x), T(pos3), 1e6, sec),
          RL.apply_mrope(x, jnp.asarray(pos3), 1e6, sec))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (B, Sq, Skv, H, K, hd, vd, causal, window, softcap, qc, kc)
    "causal_gqa": (2, 37, 37, 4, 2, 16, 16, True, 0, 0.0, 16, 8),
    "windowed": (2, 37, 37, 4, 2, 16, 16, True, 5, 0.0, 16, 8),
    "softcapped": (1, 21, 21, 4, 4, 16, 16, True, 0, 2.0, 8, 16),
    "window_softcap_mqa": (2, 19, 19, 4, 1, 8, 8, True, 3, 5.0, 7, 5),
    "noncausal_cross": (2, 11, 23, 4, 2, 16, 16, False, 0, 0.0, 4, 7),
    "mla_vd": (2, 13, 13, 4, 4, 24, 16, True, 0, 0.0, 512, 1024),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention(case):
    B, Sq, Skv, H, K, hd, vd, causal, window, cap, qc, kc = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k = rand(rng, B, Sq, H, hd, scale=2.0), rand(rng, B, Skv, K, hd)
    v = rand(rng, B, Skv, K, vd)
    got = L.flash_attention(T(q), T(k), T(v), causal=causal, window=window,
                            softcap=cap, q_chunk=qc, kv_chunk=kc)
    want = RL.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap, q_chunk=qc, kv_chunk=kc)
    close(got, want)


def test_flash_attention_gqa_reads_kv_head_h_div_rep():
    """Query head h attends with kv head h // rep (``jnp.repeat``'s
    order), not h % K (``Tensor.repeat``'s)."""
    rng = np.random.default_rng(3)
    q, k, v = rand(rng, 1, 6, 4, 8), rand(rng, 1, 6, 2, 8), rand(rng, 1, 6, 2, 8)
    got = L.flash_attention(T(q), T(k), T(v))
    for h in range(4):
        one = L.flash_attention(T(q[:, :, h:h + 1]), T(k[:, :, h // 2:h // 2 + 1]),
                                T(v[:, :, h // 2:h // 2 + 1]))
        close(got[:, :, h:h + 1], one.numpy())


@pytest.mark.parametrize("window,cap,cur", [(0, 0.0, 9), (4, 0.0, 9),
                                            (3, 5.0, 12), (0, 0.0, 1)])
def test_decode_attention(window, cap, cur):
    rng = np.random.default_rng(window + cur)
    B, Smax, H, K, hd = 2, 12, 4, 2, 16
    q = rand(rng, B, 1, H, hd, scale=2.0)
    kc, vc = rand(rng, B, Smax, K, hd), rand(rng, B, Smax, K, hd)
    got = L.decode_attention(T(q), T(kc), T(vc), cur, window=window,
                             softcap=cap)
    want = RL.decode_attention(q, kc, vc, cur, window=window, softcap=cap)
    close(got, want)


# ---------------------------------------------------------------------------
# projections, MLPs, MoE
# ---------------------------------------------------------------------------

def _ref_params(init_fn, rc, *a, **kw):
    return tree_np(init_fn(rc, jax.random.PRNGKey(7), *a, **kw))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-12b",
                                  "qwen2-vl-72b"])
def test_gqa_qkv(arch):
    """Plain rope, qk-norm (gemma3) and M-RoPE (qwen2-vl)."""
    rc, pc = reduced(arch)
    p = layer0(_ref_params(RL.init_gqa, rc, 1, jnp.float32))
    rng = np.random.default_rng(4)
    if "q_scale" in p:
        p["q_scale"], p["k_scale"] = rand(rng, pc.head_dim), rand(rng, pc.head_dim)
    x = rand(rng, 2, 9, pc.d_model)
    pos = np.broadcast_to(np.arange(9) + 3, (2, 9)).copy()
    got = L.gqa_qkv(pc, tree_t(p), T(x), T(pos))
    want = RL.gqa_qkv(rc, p, x, jnp.asarray(pos))
    for g, w in zip(got, want):
        close(g, w)


def test_mla_qkv():
    rc, pc = reduced("deepseek-v3-671b")
    p = layer0(_ref_params(RL.init_mla, rc, 1, jnp.float32))
    rng = np.random.default_rng(5)
    p["q_norm"] = rand(rng, *p["q_norm"].shape, scale=0.3)
    p["kv_norm"] = rand(rng, *p["kv_norm"].shape, scale=0.3)
    x = rand(rng, 2, 9, pc.d_model)
    pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
    got = L.mla_qkv(pc, tree_t(p), T(x), T(pos))
    want = RL.mla_qkv(rc, p, x, jnp.asarray(pos))
    for g, w in zip(got, want):
        close(g, w)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    close(L.gelu(T(x)), jax.nn.gelu(x))
    # the erf form differs by more than the tolerance somewhere
    erf = torch.nn.functional.gelu(T(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(x))).max() > 1e-4


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "gelu", "relu2"])
def test_mlp(act):
    rc, pc = reduced("tinyllama-1.1b")
    rc, pc = dataclasses.replace(rc, act=act), dataclasses.replace(pc, act=act)
    p = layer0(_ref_params(RL.init_mlp, rc, 1, jnp.float32))
    x = rand(np.random.default_rng(6), 2, 5, pc.d_model, scale=2.0)
    close(L.mlp(pc, tree_t(p), T(x)), RL.mlp(rc, p, x))


MOE_CASES = {
    # name: (arch, capacity, zero router, some expert overflows)
    "softmax_drops": ("llama4-scout-17b-a16e", 8, False, True),
    "sigmoid_shared_drops": ("deepseek-v3-671b", 8, False, True),
    "sigmoid_all_kept": ("deepseek-v3-671b", 64, False, False),
    "ties": ("deepseek-v3-671b", 8, True, True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block(case):
    """Top-k routing, token-major slot assignment and the capacity drop;
    with a zero router every expert ties and top-k takes the lowest
    indices first."""
    arch, cap, zero_router, overflows = MOE_CASES[case]
    rc, pc = reduced(arch)
    p = layer0(_ref_params(RL.init_moe, rc, 1, jnp.float32))
    rng = np.random.default_rng(8)
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    else:
        p["router"] = rand(rng, *p["router"].shape, scale=0.5)
    x = rand(rng, 2, 16, pc.d_model)
    got = L.moe_block(pc, tree_t(p), T(x), cap)
    want = RL.moe_block(rc, p, x, cap)
    close(got, want)
    # drops happen where the case says so: 32 tokens x top-k over 4 experts
    flat = (T(x).reshape(-1, pc.d_model) @ T(p["router"]))
    probs = torch.sigmoid(flat) if pc.router == "sigmoid" else flat.softmax(-1)
    counts = torch.bincount(L.top_k(probs, pc.topk)[1].reshape(-1),
                            minlength=pc.n_experts)
    assert bool((counts > cap).any()) == overflows


def test_top_k_ties_take_lower_index_first():
    x = torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.1]])
    v, i = L.top_k(x, 3)
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert i.tolist() == np.asarray(ri).tolist() == [[1, 3, 0]]
    close(v, rv)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm_case():
    rc, pc = reduced("mamba2-780m")
    p = layer0(_ref_params(RS.init_ssm, rc, 1, jnp.float32))
    rng = np.random.default_rng(9)
    # non-trivial gates and norm so every term of the recurrence matters
    H = pc.ssm.n_heads
    p["A_log"] = rand(rng, H, scale=0.5)
    p["dt_bias"] = rand(rng, H, scale=0.5)
    p["D"] = rand(rng, H)
    p["conv_b"] = rand(rng, *p["conv_b"].shape, scale=0.1)
    p["norm"] = rand(rng, *p["norm"].shape, scale=0.2)
    return rc, pc, p, rng


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(ssm_case, with_state):
    rc, pc, p, rng = ssm_case
    C = p["conv_w"].shape[1]
    x = rand(rng, 2, 5 if not with_state else 1, C)
    st = rand(rng, 2, pc.ssm.conv_width - 1, C) if with_state else None
    got, gs = S._causal_conv(T(x), T(p["conv_w"]), T(p["conv_b"]),
                             state=None if st is None else T(st))
    want, ws = RS._causal_conv(x, p["conv_w"], p["conv_b"], state=st)
    close(got, want)
    close(gs, ws)


def _ssd_inputs(pc, rng, Bsz, Sq):
    s = pc.ssm
    x = rand(rng, Bsz, Sq, s.n_heads, s.head_dim)
    Bm, Cm = rand(rng, Bsz, Sq, s.state_dim), rand(rng, Bsz, Sq, s.state_dim)
    dt = np.log1p(np.exp(rand(rng, Bsz, Sq, s.n_heads)))
    log_dA = -np.exp(rand(rng, s.n_heads, scale=0.5)) * dt
    return x, Bm, Cm, dt.astype(np.float32), log_dA.astype(np.float32)


@pytest.mark.parametrize("Sq,init", [(40, False), (16, False), (23, True)])
def test_ssd_chunked(ssm_case, Sq, init):
    """S a multiple of the chunk (16) and not; with a carried state."""
    rc, pc, p, rng = ssm_case
    args = _ssd_inputs(pc, rng, 2, Sq)
    s = pc.ssm
    st = rand(rng, 2, s.n_heads, s.state_dim, s.head_dim) if init else None
    gy, gs = S.ssd_chunked(pc, *map(T, args),
                           init_state=None if st is None else T(st))
    wy, ws = RS.ssd_chunked(rc, *args, init_state=st)
    close(gy, wy)
    close(gs, ws)


def test_ssd_sequential(ssm_case):
    rc, pc, p, rng = ssm_case
    args = _ssd_inputs(pc, rng, 2, 21)
    gy, gs = S.ssd_sequential(pc, *map(T, args))
    wy, ws = RS.ssd_sequential(rc, *args)
    close(gy, wy)
    close(gs, ws)
    cy, cs = S.ssd_chunked(pc, *map(T, args))     # the chunked form's oracle
    close(cy, gy.numpy(), rtol=1e-4)
    close(cs, gs.numpy(), rtol=1e-4)


def test_ssm_forward_and_decode_step(ssm_case):
    rc, pc, p, rng = ssm_case
    x = rand(rng, 2, 19, pc.d_model)
    gy, (gc, gs) = S.ssm_forward(pc, tree_t(p), T(x))
    wy, (wc, ws) = RS.ssm_forward(rc, p, x)
    close(gy, wy)
    close(gc, wc)
    close(gs, ws)
    x1 = rand(rng, 2, 1, pc.d_model)
    got = S.ssm_decode_step(pc, tree_t(p), T(x1), gc, gs)
    want = RS.ssm_decode_step(rc, p, x1, np.asarray(wc), np.asarray(ws))
    for g, w in zip(got, want):
        close(g, w)


def test_softplus_is_logaddexp():
    x = np.concatenate([np.linspace(-90, 90, 721), [0.0, 1e-8, -1e-8]])
    x = x.astype(np.float32)
    close(S.softplus(T(x)), jax.nn.softplus(x))
