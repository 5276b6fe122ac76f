"""The LM port's training loss and gradients against the reference's
``jax.value_and_grad`` on the CPU for the MoE (deepseek, llama4), MLA
(deepseek), SSD (mamba2), hybrid (hymba) and enc-dec (whisper) families,
and DeepSeek's MTP head; the dense attention families, the remat policies
and the chunked CE are in ``test_torch_lm_grad.py``, whose setup and
stated tolerances these tests share (rtol 1e-4, atol 1e-5 times the larger
of 1 and the reference leaf's largest magnitude; mamba2 atol 5e-5 times
it; the measured maxima are in its docstring).

The MTP head: ``mtp_logits`` on the reference's pre-norm hidden state
equals the reference's, and the MTP term of the loss (the loss less the
loss at ``mtp_weight=0``) equals the reference's, at the same tolerance;
its gradients (``mtp_proj``, ``mtp_block``) are among deepseek's leaves
above.
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
from test_torch_lm_grad import (ATOL, RTOL,  # noqa: E402
                                check_against_reference, reference_case)
from test_torch_lm_model import scaled_close  # noqa: E402

MIXER_ARCHS = ("deepseek-v3-671b", "llama4-scout-17b-a16e", "mamba2-780m",
               "hymba-1.5b", "whisper-large-v3")
MTP_ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (see
    ``test_torch_lm_grad.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_against_reference(arch)


def test_mtp_logits_match_reference():
    cfg, rc = get_config(MTP_ARCH).reduced(), ref_get_config(MTP_ARCH).reduced()
    assert cfg.mtp and rc.mtp
    tree, toks, _, _, _ = reference_case(MTP_ARCH)

    def head(p, t):
        _, hidden = RT.forward(rc, p, t, return_hidden=True)
        return hidden, RT.mtp_logits(rc, p, hidden, t)

    hidden, want = jax.jit(head)(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(toks))
    with torch.no_grad():
        got = T.mtp_logits(cfg, T.params_from_numpy(tree, device="cpu"),
                           torch.from_numpy(np.asarray(hidden)),
                           torch.from_numpy(toks))
    assert got.shape == (*toks.shape[:1], toks.shape[1] - 1, cfg.vocab)
    scaled_close(got, np.asarray(want), RTOL, ATOL)


def test_mtp_loss_term_matches_reference():
    """The MTP term (0.3 times the CE of the t+2 targets): the loss less
    the loss at ``mtp_weight=0``."""
    cfg, rc = get_config(MTP_ARCH).reduced(), ref_get_config(MTP_ARCH).reduced()
    tree, toks, _, loss, _ = reference_case(MTP_ARCH)
    base = jax.jit(lambda p, t: RT.loss_fn(rc, p, t, mtp_weight=0.0))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
    want = loss - float(base)
    params = T.params_from_numpy(tree, device="cpu")
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        got = T.loss_fn(cfg, params, tt) - T.loss_fn(cfg, params, tt,
                                                     mtp_weight=0.0)
    assert want > 0
    scaled_close(got, np.float32(want), RTOL, ATOL)
