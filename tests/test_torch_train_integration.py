"""The port's training launcher end to end on the CPU (in process): the
reference's ``tests/test_train_integration.py`` cases through
``repro_torch.launch.train.main`` with ``--device cpu --reduced --batch 4
--seq 64`` (loss falls, the injected fault is recovered, ``--resume``
resumes), plus ``--grad-compress`` on one rank, bf16 parameters through a
checkpoint, the example, and one ``build_train_step`` step against the
reference's.

The step's tolerances, stated before comparing (one step of tinyllama
reduced on the reference's float32 weights and its ``synthetic_batch``):
the loss, the gradient norm and the new moments within rtol 1e-4 and atol
1e-5 times the larger of 1 and the reference leaf's largest magnitude (the
gradient tolerance of ``test_torch_lm_grad.py``); the new parameters
within rtol 1e-6 and atol 1e-6 times that scale, except where the
reference's first moment is under 1e-6 in magnitude.  The first AdamW step
moves each element by lr * m / (|m| + 0.1 eps): where m is near eps a
gradient off by its float32 noise moves the update by a fraction of lr,
so those elements are held within 2 lr.  Measured: two such elements (of
all the leaves), with first moments 1.4e-09 and 7.6e-09, off by 1.37e-05
and 1.6e-06; every other element within 1e-6.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from test_torch_lm_model import scaled_close, widened  # noqa: E402
from test_torch_train import jflat  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(tmp, extra, capsys):
    """(final loss, printed log) of one in-process run of the launcher."""
    loss = train.main(["--device", "cpu", "--arch", "tinyllama-1.1b",
                       "--reduced", "--batch", "4", "--seq", "64",
                       "--lr", "3e-3", "--ckpt-dir", str(tmp)] + extra)
    return loss, capsys.readouterr().out


def _losses(log):
    return [float(line.split("loss=")[1].split()[0])
            for line in log.splitlines() if line.startswith("step")]


def test_loss_decreases_and_fault_recovery(tmp_path, capsys):
    loss, log = _train(tmp_path, ["--steps", "16", "--ckpt-every", "4",
                                  "--fault-inject", "6"], capsys)
    assert "  [guard] restored step 4" in log
    losses = _losses(log)
    assert len(losses) == 16
    assert losses[-1] < losses[0] and f"{loss:.4f}" == f"{losses[-1]:.4f}"
    assert store.latest_step(str(tmp_path)) == 15


def test_resume_from_checkpoint(tmp_path, capsys):
    _train(tmp_path, ["--steps", "8", "--ckpt-every", "4"], capsys)
    _, log = _train(tmp_path, ["--steps", "12", "--resume"], capsys)
    assert "resumed from step 7" in log
    assert [int(line.split()[1]) for line in log.splitlines()
            if line.startswith("step")] == list(range(7, 12))


def test_grad_compress_on_one_rank(tmp_path, capsys):
    """The int8 error-feedback path trains, and its residuals ride in the
    optimizer state through the checkpoint."""
    _, log = _train(tmp_path, ["--steps", "10", "--ckpt-every", "5",
                               "--grad-compress"], capsys)
    losses = _losses(log)
    assert len(losses) == 10 and losses[-1] < losses[0]
    man = (tmp_path / "step_000009" / "manifest.json").read_text()
    assert '"o/residuals/embed"' in man


def test_bf16_params_train_and_resume(tmp_path, capsys):
    """``--dtype bfloat16``: the loss falls, and a resumed run restores the
    bf16 checkpoint (the reference cannot restore its own)."""
    _, log = _train(tmp_path, ["--steps", "8", "--ckpt-every", "4",
                               "--dtype", "bfloat16"], capsys)
    losses = _losses(log)
    assert losses[-1] < losses[0]
    _, log = _train(tmp_path, ["--steps", "10", "--resume", "--dtype",
                               "bfloat16"], capsys)
    assert "resumed from step 7" in log
    st = store.restore(str(tmp_path), 9, {"p": {"embed": None}},
                       device="cpu")
    assert st["p"]["embed"].dtype == torch.bfloat16


def test_example_runs_on_the_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", REPO / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    loss = mod.main(["--device", "cpu", "--steps", "12", "--ckpt-dir",
                     str(tmp_path)])
    out = capsys.readouterr().out
    assert f"final loss: {loss:.4f}" in out
    losses = _losses(out)
    assert len(losses) == 12 and losses[-1] < losses[0]


def test_train_step_matches_reference():
    """One step of the port's ``build_train_step`` == the reference's
    jitted ``build_train_step`` step (tolerances in the module
    docstring)."""
    arch = "tinyllama-1.1b"
    rc, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=16)
    rcfg, ocfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    tree = widened(RT.init_params(rc, jax.random.PRNGKey(0),
                                  dtype=jnp.float32))
    toks = np.array(ref_pipeline.synthetic_batch(ref_pipeline.DataConfig(
        vocab=rc.vocab, seq_len=64, global_batch=4), 0))

    rp = jax.tree.map(jnp.asarray, tree)
    rstep = jax.jit(ref_train.build_train_step(rc, rcfg, None))
    rp, rs, rm = rstep(rp, ref_adamw.init_state(rp, rcfg), jnp.asarray(toks))

    p = T.params_from_numpy(tree, device="cpu")
    step = train.build_train_step(cfg, ocfg)
    p, s, m = step(p, adamw.init_state(p, ocfg), torch.from_numpy(toks))

    for k in ("loss", "grad_norm", "lr"):
        scaled_close(m[k], np.asarray(rm[k]), 1e-4, 1e-5)
    assert int(s["step"]) == int(rs["step"]) == 1
    want, got = jflat({"m": rs["m"], "v": rs["v"]}), flatten(
        {"m": s["m"], "v": s["v"]})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scaled_close(got[k], np.asarray(w), 1e-4, 1e-5)
    want, got = jflat(rp), flatten(p)
    assert sorted(got) == sorted(want)
    lr = float(rm["lr"])
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        flat_m = np.abs(np.asarray(jflat(rs["m"])[k])) < 1e-6
        np.testing.assert_allclose(g[~flat_m], w[~flat_m], rtol=1e-6,
                                   atol=1e-6 * max(1.0, float(
                                       np.abs(w).max())), err_msg=k)
        assert float(np.abs(g[flat_m] - w[flat_m]).max(initial=0)) \
            <= 2 * lr, k
