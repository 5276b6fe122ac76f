"""The port's ``LMServer`` against the reference's on the CPU, and the LM
entry points' device default.

* On reduced tinyllama with the reference's weights carried across, the
  port's ``LMServer.generate`` gives the reference ``LMServer``'s greedy
  tokens, after a prompt stepped into the cache and after the reference
  test's own sequence (whose stepped prompt is discarded).
* Its stats count as the reference's: ``queries += B * n_new`` per call,
  ``seconds`` grown; they are registry-backed ``ServeStats``.
* ``init_params``, ``init_cache``, ``params_from_numpy``,
  ``TransformerLM`` and ``LMServer`` default to the card and raise "CUDA is
  not available" without one.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving.engine import LMServer as RefLMServer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import LMServer, ServeStats  # noqa: E402

ARCH = "tinyllama-1.1b"


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
def ref_params():
    rc = ref_get_config(ARCH).reduced()
    return rc, RT.init_params(rc, jax.random.PRNGKey(0), dtype=jnp.float32)


def servers(ref_params, B, max_len):
    rc, rp = ref_params
    cfg = get_config(ARCH).reduced()
    ref = RefLMServer(rc, rp, RT.init_cache(rc, B, max_len,
                                            dtype=jnp.float32))
    params = T.params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    port = LMServer(cfg, params, T.init_cache(cfg, B, max_len,
                                              dtype=torch.float32,
                                              device="cpu"), device="cpu")
    return ref, port


def test_generate_matches_reference_after_a_stepped_prompt(ref_params):
    B, P, n_new = 3, 7, 9
    ref, port = servers(ref_params, B, P + n_new)
    prompt = np.random.default_rng(4).integers(
        0, ref.cfg.vocab, (B, P)).astype(np.int32)
    for i in range(P - 1):                  # prefill by stepping the prompt
        ref.cache = ref._step(ref.params, ref.cache,
                              jnp.asarray(prompt[:, i:i + 1]))[1]
        port.cache = port._step(port.params, port.cache,
                                torch.from_numpy(prompt[:, i:i + 1]))[1]
    assert port.cache["step"] == int(ref.cache["step"]) == P - 1
    want = ref.generate(prompt, n_new)
    got = port.generate(prompt, n_new)
    assert got.dtype == np.int32 and got.shape == (B, n_new)
    np.testing.assert_array_equal(got, want)
    assert port.cache["step"] == P - 1 + n_new


def test_generate_matches_the_reference_tests_sequence(ref_params):
    """The reference's own test steps the prompt and drops the new cache
    (its step is pure); the port's step is pure too, so the same calls give
    the same tokens."""
    B = 2
    ref, port = servers(ref_params, B, 8 + 16)
    prompt = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.int32)
    for i in range(prompt.shape[1] - 1):
        ref._step(ref.params, ref.cache, jnp.asarray(prompt[:, i:i + 1]))
        port._step(port.params, port.cache,
                   torch.from_numpy(prompt[:, i:i + 1]))
    assert port.cache["step"] == 0
    out = port.generate(prompt, n_new=5)
    np.testing.assert_array_equal(out, ref.generate(prompt, n_new=5))
    assert (out >= 0).all() and (out < port.cfg.vocab).all()


def test_stats_count_as_the_reference(ref_params):
    ref, port = servers(ref_params, 2, 16)
    assert isinstance(port.stats, ServeStats)
    prompt = np.zeros((2, 1), np.int32)
    for n in (3, 4):
        ref.generate(prompt, n)
        port.generate(prompt, n)
        assert port.stats.queries == ref.stats.queries
    assert port.stats.queries == 2 * 7
    assert port.stats.seconds > 0
    assert port.stats.qps > 0
    labels = port.stats.labels
    assert obs.REGISTRY.counter("serve_queries_total",
                                **labels).value == 14


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                   "params_from_numpy", "TransformerLM",
                                   "LMServer"])
def test_entry_point_defaults_to_the_card(no_cuda, entry):
    cfg = get_config(ARCH).reduced()
    calls = {
        "init_params": lambda: T.init_params(cfg),
        "init_cache": lambda: T.init_cache(cfg, 1, 4),
        "params_from_numpy": lambda: T.params_from_numpy(
            {"embed": np.zeros((4, 2), np.float32)}),
        "TransformerLM": lambda: T.TransformerLM(cfg),
        "LMServer": lambda: LMServer(cfg, {}, {"step": 0}),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
