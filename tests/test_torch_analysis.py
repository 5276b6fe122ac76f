"""The port's invariant pass (``repro_torch.analysis``) on the CPU.

Held against the reference's ``repro.analysis`` on the same inputs: the
call graph over the real ``src/repro`` tree (functions, callees and the
hot-path reachable set, precise and not), and the reference's own fixture
sources for every rule whose meaning is unchanged (monotonic-time,
lock-order, layering core->serving, hot-path-sync on host constructs,
suppressions, the CLI), with ``repro/`` renamed ``repro_torch/``: equal
findings at equal (rule, path, line, col).

Then what the port's rules add: each torch construct ``hot-path-sync``
flags is reported directly and through a callee, ignored in a cold
function and silenced by a marker, and the non-flags stay silent;
``entry-registry`` (``torch.compile``, taxonomy drift both ways, a
``TRACES.see`` naming another entry, warmup reachability); the layering
rules (torch at ``obs`` module scope, ``jax``/``repro`` anywhere).  Last,
the full pass over ``src/repro_torch`` has zero findings, and every marker
of the reference's serving path has a counterpart marker in the port.
"""

import ast
import json
import os
import re
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro import analysis as ref_analysis
from repro.analysis.cli import main as ref_cli
from repro_torch import analysis as port_analysis
from repro_torch.analysis.cli import main as port_cli

from test_analysis import _AB_BA, _FIXTURE_LOCKS, _HOT_BAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(text: str) -> str:
    """A reference fixture's path or source with ``repro`` renamed."""
    return re.sub(r"\brepro([./])", r"repro_torch\1", text)


def _project(analysis, root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return analysis.load_project([str(root)], root=str(root))


def _findings(analysis, root, files, rule):
    return analysis.run(_project(analysis, root, files), select=[rule])


def _port_findings(tmp_path, files, rule):
    return _findings(port_analysis, tmp_path, files, rule)


# ------------------------------------------------------ framework parity
@pytest.fixture(scope="module")
def call_graphs():
    """{precise: (reference graph, port graph)} over the real src/repro."""
    out = {}
    for precise in (True, False):
        out[precise] = tuple(
            a.CallGraph(a.load_project([os.path.join(REPO, "src", "repro")],
                                       root=REPO), precise=precise)
            for a in (ref_analysis, port_analysis))
    return out


@pytest.mark.parametrize("precise", [True, False])
def test_call_graph_equals_reference(call_graphs, precise):
    ref, port = call_graphs[precise]
    assert ref.funcs and set(port.funcs) == set(ref.funcs)
    for q, fi in ref.funcs.items():
        assert port.callees(port.funcs[q]) == ref.callees(fi), q
    seeds = [q for q, fi in ref.funcs.items()
             if fi.name in ("stage", "dispatch", "dispatch_staged",
                            "join_staged") and fi.cls is not None
             and fi.module.name.startswith(("repro.serving",
                                            "repro.sharding"))]
    assert seeds
    want = ref.reachable([ref.funcs[q] for q in seeds])
    got = port.reachable([port.funcs[q] for q in seeds])
    assert set(got) == set(want) and len(want) > len(seeds)


# -------------------------------------------------------- fixture parity
def _ref_fixture(name):
    """(rule, files) of a reference fixture, as ``tests/test_analysis.py``
    writes it."""
    locks = {"src/repro/obs/locks.py": _FIXTURE_LOCKS}
    with_locks = lambda body: {**locks, "src/repro/indexing/swap.py": body}
    return {
        "wall-clock": ("monotonic-time", {"src/repro/serving/t.py":
                       "import time\ndef f():\n    return time.time()\n"}),
        "bare-time": ("monotonic-time", {"src/repro/serving/t.py":
                      "from time import time\ndef f():\n    return time()\n"}),
        "timing-allowed": ("monotonic-time", {"src/repro/obs/timing.py":
                           "import time\ndef wall():\n"
                           "    return time.time()\n"}),
        "trailing-marker": ("monotonic-time", {"src/repro/serving/t.py":
                            "import time\nt = time.time()  "
                            "# repolint: disable=monotonic-time -- meta\n"}),
        "file-marker": ("monotonic-time", {"src/repro/serving/t.py":
                        "# repolint: disable-file=monotonic-time -- fixture\n"
                        "import time\ndef f():\n    return time.time()\n"
                        "def g():\n    return time.time()\n"}),
        "previous-line-marker": ("monotonic-time", {"src/repro/serving/t.py":
                                 "import time\ndef f():\n"
                                 "    # repolint: disable=monotonic-time "
                                 "-- why\n    return time.time()\n"}),
        "marker-per-rule": ("monotonic-time", {"src/repro/serving/t.py":
                            "import time\nt = time.time()  # repolint: "
                            "disable=jit-registry -- wrong rule\n"}),
        "ab-ba": ("lock-order", with_locks(_AB_BA)),
        "clean-nesting": ("lock-order", with_locks(
            "from repro.obs.locks import make_lock\nclass S:\n"
            "    def __init__(self):\n        self._a = make_lock('a')\n"
            "        self._b = make_lock('b')\n    def good(self):\n"
            "        with self._a:\n            with self._b:\n"
            "                return 1\n")),
        "cross-function": ("lock-order", with_locks(
            "from repro.obs.locks import make_lock\nclass S:\n"
            "    def __init__(self):\n        self._a = make_lock('a')\n"
            "        self._b = make_lock('b')\n    def outer(self):\n"
            "        with self._b:\n            return self.inner()\n"
            "    def inner(self):\n        with self._a:\n"
            "            return 1\n")),
        "raw-lock": ("lock-order", with_locks(
            "import threading\nclass S:\n    def __init__(self):\n"
            "        self._lock = threading.Lock()\n")),
        "unranked-name": ("lock-order", with_locks(
            "from repro.obs.locks import make_lock\nclass S:\n"
            "    def __init__(self):\n        self._x = make_lock('zz')\n")),
        "condition-alias": ("lock-order", with_locks(
            "import threading\nfrom repro.obs.locks import make_lock\n"
            "class S:\n    def __init__(self):\n"
            "        self._a = make_lock('a')\n"
            "        self._cond = threading.Condition(self._a)\n"
            "        self._b = make_lock('b')\n    def f(self):\n"
            "        with self._b:\n            with self._cond:\n"
            "                return 1\n")),
        "core-imports-serving": ("layering", {"src/repro/core/x.py":
                                 "def f():\n"
                                 "    from repro.serving import engine\n"}),
        "hot-host-constructs": ("hot-path-sync",
                                {"src/repro/serving/e.py": _HOT_BAD}),
        "hot-cold-function": ("hot-path-sync", {"src/repro/serving/e.py":
                              "import numpy as np\nclass Engine:\n"
                              "    def build(self, s):\n"
                              "        return np.asarray(s)\n"}),
        "hot-marker": ("hot-path-sync", {"src/repro/serving/e.py":
                       "import numpy as np\nclass Engine:\n"
                       "    def stage(self, s):\n"
                       "        # repolint: disable=hot-path-sync -- host\n"
                       "        return np.asarray(s)\n"}),
    }[name]


_PARITY = ["wall-clock", "bare-time", "timing-allowed", "trailing-marker",
           "file-marker", "previous-line-marker", "marker-per-rule", "ab-ba",
           "clean-nesting", "cross-function", "raw-lock", "unranked-name",
           "condition-alias", "core-imports-serving", "hot-host-constructs",
           "hot-cold-function", "hot-marker"]
# the fixtures the reference's own tests expect findings from
_FLAGGED = {"wall-clock", "bare-time", "marker-per-rule", "ab-ba",
            "cross-function", "raw-lock", "unranked-name", "condition-alias",
            "core-imports-serving", "hot-host-constructs"}


@pytest.mark.parametrize("name", _PARITY)
def test_fixture_findings_equal_reference(tmp_path, name):
    rule, files = _ref_fixture(name)
    want = _findings(ref_analysis, tmp_path / "ref", files, rule)
    got = _findings(port_analysis, tmp_path / "port",
                    {_to_port(p): _to_port(s) for p, s in files.items()},
                    rule)
    assert bool(want) == (name in _FLAGGED)
    assert [(f.rule, f.path, f.line, f.col) for f in got] == \
        [(f.rule, _to_port(f.path), f.line, f.col) for f in want]


def test_cli_exit_codes_and_json_equal_reference(tmp_path, capsys):
    bad = tmp_path / "p1"
    for pkg in ("repro", "repro_torch"):
        (bad / "src" / pkg / "serving").mkdir(parents=True)
        (bad / "src" / pkg / "serving" / "t.py").write_text(
            "import time\nt = time.time()\n")
    good = tmp_path / "p2"
    (good / "src").mkdir(parents=True)
    (good / "src" / "ok.py").write_text("x = 1\n")
    payloads = []
    for cli, pkg in ((ref_cli, "repro"), (port_cli, "repro_torch")):
        assert cli(["--root", str(bad), "--format", "json",
                    str(bad / "src" / pkg)]) == 1
        payloads.append(json.loads(capsys.readouterr().out))
        assert cli(["--root", str(good), str(good / "src")]) == 0
        assert cli(["--select", "nope", "--root", str(good),
                    str(good / "src")]) == 2
        assert cli([str(tmp_path / "empty-nothing")]) == 2
        capsys.readouterr()
    want, got = payloads
    assert got["count"] == want["count"] == 1
    assert [(f["rule"], f["path"], f["line"], f["col"])
            for f in got["findings"]] == \
        [(f["rule"], _to_port(f["path"]), f["line"], f["col"])
         for f in want["findings"]]
    assert port_cli(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    for rule in ("entry-registry", "hot-path-sync", "layering",
                 "monotonic-time", "lock-order"):
        assert f"{rule}:" in listing
    assert "jit-registry" not in listing


# --------------------------------------------------------- hot-path-sync
_HOT = """\
import jax
import numpy as np
import torch


class Engine:
    def stage(self, x, dev, ev):
        return {expr}{mark}

    def dispatch_staged(self, x, dev, ev):
        return self._finish(x, dev, ev)

    def _finish(self, x, dev, ev):
        return {expr}{mark}

    def build(self, x, dev, ev):
        return {expr}
"""
_HOT_PATH = "src/repro_torch/serving/e.py"

FLAGGED = {
    "item": "x.item()",
    "cpu": "x.cpu()",
    "tolist": "x.tolist()",
    "to-cpu": "x.to('cpu')",
    "to-device-cpu": "x.to(device='cpu')",
    "to-torch-device-cpu": "x.to(torch.device('cpu'))",
    "cuda-synchronize": "torch.cuda.synchronize()",
    "event-synchronize": "ev.synchronize()",
    "nonzero": "x.nonzero()",
    "torch-nonzero": "torch.nonzero(x)",
    "tensor-device": "torch.tensor(x, device=dev)",
    "as-tensor-device": "torch.as_tensor(x, device=dev)",
    "from-numpy-to": "torch.from_numpy(x).to(dev)",
    "np-asarray": "np.asarray(x)",
    "float": "float(x)",
    "block-until-ready": "jax.block_until_ready(x)",
}
NOT_FLAGGED = {
    "numpy": "x.numpy()",
    "int-key": "int(x)",
    "bool": "bool(x)",
    "np-nonzero": "np.nonzero(x)",
    "float-constant": "float('inf')",
    "to-device": "x.to(dev)",
    "from-numpy-non-blocking": "torch.from_numpy(x).to(dev, "
                               "non_blocking=True)",
    "tensor-host": "torch.tensor(x)",
    "full-device": "torch.full((), 1.0, device=dev)",
}


@pytest.mark.parametrize("expr", FLAGGED.values(), ids=FLAGGED.keys())
def test_hot_path_flags_torch_construct(tmp_path, expr):
    """Reported directly in ``stage`` (line 8) and through the callee
    ``_finish`` (line 14), never in the cold ``build`` (line 17)."""
    out = _port_findings(tmp_path, {_HOT_PATH: _HOT.format(
        expr=expr, mark="")}, "hot-path-sync")
    assert sorted({f.line for f in out}) == [8, 14], out
    via = [f for f in out if f.line == 14]
    assert "reached from" in via[0].message and "_finish" in via[0].message


@pytest.mark.parametrize("expr", FLAGGED.values(), ids=FLAGGED.keys())
def test_hot_path_marker_silences_torch_construct(tmp_path, expr):
    mark = "  # repolint: disable=hot-path-sync -- fixture"
    assert not _port_findings(tmp_path, {_HOT_PATH: _HOT.format(
        expr=expr, mark=mark)}, "hot-path-sync")


@pytest.mark.parametrize("expr", NOT_FLAGGED.values(),
                         ids=NOT_FLAGGED.keys())
def test_hot_path_ignores_non_sync(tmp_path, expr):
    assert not _port_findings(tmp_path, {_HOT_PATH: _HOT.format(
        expr=expr, mark="")}, "hot-path-sync")


def test_hot_path_flags_a_from_numpy_local(tmp_path):
    src = ("import torch\nclass Engine:\n    def stage(self, x, dev):\n"
           "        h, g = torch.from_numpy(x), torch.from_numpy(x)\n"
           "        a = h.to(dev)\n"
           "        return a, g.to(dev, non_blocking=True)\n")
    out = _port_findings(tmp_path, {_HOT_PATH: src}, "hot-path-sync")
    assert [f.line for f in out] == [5]


def test_hot_path_scope_is_serving_and_sharding(tmp_path):
    """A seed named ``stage`` outside the scope seeds nothing; the sharding
    package is in it."""
    fs = {"src/repro_torch/core/e.py": _HOT.format(expr="x.cpu()", mark=""),
          "src/repro_torch/sharding/e.py": _HOT.format(expr="x.cpu()",
                                                       mark="")}
    out = _port_findings(tmp_path, fs, "hot-path-sync")
    assert {f.path for f in out} == {"src/repro_torch/sharding/e.py"}


# -------------------------------------------------------- entry-registry
def _packed(entries, body):
    return ("TRACES = None\n"
            f"SERVING_ENTRIES = {tuple(entries)!r}\n"
            "def _serving_entry(entry):\n"
            "    def deco(fn):\n        return fn\n    return deco\n" + body)


_ENTRY_A = ("@_serving_entry('a')\n"
            "def entry_a(x):\n    TRACES.see('a', x)\n    return x\n")
_WARMUP = ("from repro_torch.core.packed import entry_a\n"
           "class Engine:\n    def warmup(self):\n"
           "        return entry_a(0)\n")
_PACKED_PATH = "src/repro_torch/core/packed.py"
_ENGINE_PATH = "src/repro_torch/serving/engine.py"


def test_entry_registry_clean(tmp_path):
    fs = {_PACKED_PATH: _packed(["a"], _ENTRY_A), _ENGINE_PATH: _WARMUP}
    assert not _port_findings(tmp_path, fs, "entry-registry")


def test_entry_registry_taxonomy_drift_both_directions(tmp_path):
    body = _ENTRY_A + ("@_serving_entry('b')\n"
                       "def entry_b(x):\n    TRACES.see('b', x)\n")
    fs = {_PACKED_PATH: _packed(["a", "c"], body), _ENGINE_PATH: _WARMUP}
    msgs = [f.message for f in _port_findings(tmp_path, fs,
                                              "entry-registry")]
    assert any("'b' is not listed" in m for m in msgs), msgs
    assert any("lists 'c'" in m for m in msgs), msgs


@pytest.mark.parametrize("see,line,what", [
    ("TRACES.see('other', x)", 9, "names 'other'"),
    ("TRACES.see(name, x)", 9, "non-literal"),
    ("pass", 8, "never reports"),
], ids=["other-entry", "non-literal", "missing"])
def test_entry_registry_traces_see_names_its_entry(tmp_path, see, line,
                                                   what):
    body = f"@_serving_entry('a')\ndef entry_a(x, name='a'):\n    {see}\n"
    fs = {_PACKED_PATH: _packed(["a"], body), _ENGINE_PATH: _WARMUP}
    out = _port_findings(tmp_path, fs, "entry-registry")
    assert [(f.line, what in f.message) for f in out] == [(line, True)]


def test_entry_registry_warmup_reachability_and_marker(tmp_path):
    fs = {_PACKED_PATH: _packed(["a"], _ENTRY_A),
          _ENGINE_PATH: "class Engine:\n    def warmup(self):\n"
                        "        return 0\n"}
    out = _port_findings(tmp_path / "bare", fs, "entry-registry")
    assert len(out) == 1 and "not reachable" in out[0].message
    fs[_PACKED_PATH] = _packed(["a"], _ENTRY_A.replace(
        "@_serving_entry('a')", "@_serving_entry('a')  # repolint: "
        "disable=entry-registry -- library-only"))
    assert not _port_findings(tmp_path / "marked", fs, "entry-registry")


@pytest.mark.parametrize("src,line", [
    ("import torch\nf = torch.compile(lambda x: x)\n", 2),
    ("import torch\n@torch.jit.script\ndef f(x):\n    return x\n", 2),
    ("import torch\ng = torch.jit.trace\n", 2),
    ("from torch import compile\n", 1),
    ("from torch.jit import script\n", 1),
], ids=["compile", "jit-script", "jit-trace", "from-torch-compile",
        "from-torch-jit-script"])
def test_entry_registry_flags_torch_compilers(tmp_path, src, line):
    out = _port_findings(tmp_path, {"src/repro_torch/serving/j.py": src},
                         "entry-registry")
    assert [f.line for f in out] == [line]
    assert "compiles outside the serving entry taxonomy" in out[0].message


# -------------------------------------------------------------- layering
@pytest.mark.parametrize("path,src,flagged", [
    ("obs/x.py", "import torch\n", True),
    ("obs/x.py", "from torch.nn import functional\n", True),
    ("obs/x.py", "def f():\n    import torch\n    return torch\n", False),
    ("serving/x.py", "import torch\n", False),
    ("serving/x.py", "def f():\n    import jax\n", True),
    ("core/x.py", "import jax.numpy as jnp\n", True),
    ("core/x.py", "import jaxlib\n", True),
    ("kernels/x.py", "import ml_dtypes\n", True),
    ("serving/x.py", "from repro.core import pack_index\n", True),
    ("serving/x.py", "import repro\n", True),
    ("serving/x.py", "from repro_torch.core import pack_index\n", False),
    ("core/x.py", "def f():\n    from repro_torch.sharding import x\n",
     True),
    ("core/x.py", "from ..indexing import swap\n", True),
    ("core/x.py", "from .packed import pack_index\n", False),
], ids=["obs-torch", "obs-torch-submodule", "obs-lazy-torch",
        "serving-torch", "lazy-jax", "jax-numpy", "jaxlib", "ml_dtypes",
        "from-repro", "import-repro", "repro_torch-is-not-repro",
        "core-sharding", "core-relative-indexing", "core-relative-core"])
def test_layering_port_rules(tmp_path, path, src, flagged):
    out = _port_findings(tmp_path, {f"src/repro_torch/{path}": src},
                         "layering")
    assert bool(out) == flagged, out


def test_layering_benchmarks_use_port_exports(tmp_path):
    pkg = {"src/repro_torch/core/__init__.py": "from .packed import pack\n",
           "src/repro_torch/core/packed.py": "def pack():\n    return 1\n"}
    for src, flagged in (("from repro_torch.core.packed import pack\n", True),
                         ("from repro_torch.core import pack\n", False),
                         ("from repro_torch.core import _hidden\n", True)):
        root = tmp_path / str(len(list(tmp_path.iterdir())))
        out = _port_findings(root, {**pkg, "benchmarks/b.py": src},
                             "layering")
        assert bool(out) == flagged, (src, out)


# -------------------------------------------------------------- the tree
def test_full_port_tree_has_zero_findings(capsys):
    """The gate: ``python -m repro_torch.analysis src/repro_torch``."""
    project = port_analysis.load_project(
        [os.path.join(REPO, "src", "repro_torch")], root=REPO)
    assert len(project.modules) > 50
    out = port_analysis.run(project)
    assert out == [], "\n".join(f.render() for f in out)
    assert port_cli(["--root", REPO,
                     os.path.join(REPO, "src", "repro_torch")]) == 0
    assert capsys.readouterr().out.strip().endswith("0 finding(s)")


def test_port_lock_ranks_cover_every_made_lock():
    from repro_torch.obs.locks import LOCK_RANKS

    project = port_analysis.load_project(
        [os.path.join(REPO, "src", "repro_torch")], root=REPO)
    names = {node.args[0].value for mod in project.modules
             for node in ast.walk(mod.tree)
             if isinstance(node, ast.Call) and getattr(
                 node.func, "id", getattr(node.func, "attr", "")) ==
             "make_lock" and node.args and
             isinstance(node.args[0], ast.Constant)}
    assert names and names <= set(LOCK_RANKS)


# ------------------------------------------------------ the marker map
#: reference function -> (port function, port rule) that must carry the
#: counterpart marker: where the port moved a sync, its new home
COUNTERPARTS = {
    "repro.core.packed:gather_labels_at_width":
        ("repro_torch.core.packed:gather_labels_at_width", "entry-registry"),
    "repro.core.packed:join_gathered":
        ("repro_torch.core.packed:join_gathered", "entry-registry"),
    "repro.serving.query_engine:DeviceEngine.batch_argmin":
        ("repro_torch.serving.query_engine:DeviceEngine.batch_argmin",
         "hot-path-sync"),
    # the port's host routing locates cells with one core helper
    "repro.serving.shard_router:ShardRouter._cells":
        ("repro_torch.core.packed:locate_cells", "hot-path-sync"),
    "repro.serving.shard_router:ShardRouter.stage":
        ("repro_torch.serving.shard_router:ShardRouter.stage",
         "hot-path-sync"),
    "repro.serving.shard_router:ShardRouter.rescue":
        ("repro_torch.serving.shard_router:ShardRouter.rescue",
         "hot-path-sync"),
    # the reference's _finish_argmin and _run epilogues are the port's
    # _answer; its engine-side input normalization is the router's stage
    "repro.sharding.engine:ShardedQueryEngine._finish_argmin":
        ("repro_torch.sharding.engine:ShardedQueryEngine._answer",
         "hot-path-sync"),
    "repro.sharding.engine:ShardedQueryEngine._run":
        ("repro_torch.sharding.engine:ShardedQueryEngine._answer",
         "hot-path-sync"),
    "repro.sharding.engine:ShardedQueryEngine.stage":
        ("repro_torch.serving.shard_router:ShardRouter.stage",
         "hot-path-sync"),
}

#: markers of the port with no reference counterpart (each needs review)
PORT_ONLY = {
    # the synchronous batch() epilogue (the reference returns a device
    # array there)
    ("repro_torch.serving.query_engine:DeviceEngine.batch",
     "hot-path-sync"),
    # host-input normalization into the pinned slot
    ("repro_torch.serving.query_engine:DeviceEngine.stage",
     "hot-path-sync"),
    # the waits on a free pinned slot's copy event
    ("repro_torch.serving.query_engine:DeviceEngine._slot",
     "hot-path-sync"),
    ("repro_torch.serving.shard_router:ShardRouter._slot",
     "hot-path-sync"),
    # the rescue trigger the sync and staged paths share, the device
    # calls' copies (the rescue's from pageable memory), and the rescue's
    # calls into core that read the residual and splice
    ("repro_torch.serving.query_engine:DeviceEngine._rescue_flagged",
     "hot-path-sync"),
    ("repro_torch.serving.query_engine:DeviceEngine._call",
     "hot-path-sync"),
    ("repro_torch.serving.query_engine:DeviceEngine._rescue",
     "hot-path-sync"),
    ("repro_torch.sharding.engine:ShardedQueryEngine.dispatch_staged",
     "hot-path-sync"),
    ("repro_torch.sharding.engine:ShardedQueryEngine._rescue",
     "hot-path-sync"),
    # unpinned staging (the synchronous path and CPU tensors)
    ("repro_torch.serving.shard_router:_copy_unpinned", "hot-path-sync"),
}
_MAPPED_RULES = {"hot-path-sync": "hot-path-sync",
                 "jit-registry": "entry-registry"}


def _markers(analysis, pkg: str) -> set:
    """{(function qname, rule)} of every single-site marker in ``pkg``."""
    project = analysis.load_project([os.path.join(REPO, "src", pkg)],
                                    root=REPO)
    cg = analysis.CallGraph(project)
    out = set()
    for fi in cg.funcs.values():
        first = min([fi.node.lineno] + [d.lineno
                                        for d in fi.node.decorator_list])
        for line in range(first, fi.node.end_lineno + 1):
            out.update((fi.qname, rule)
                       for rule in fi.module.suppressions.get(line, ()))
    return out


def test_every_reference_marker_has_a_port_counterpart():
    ref = {(q, r) for q, r in _markers(ref_analysis, "repro")
           if (r == "hot-path-sync" and q.startswith(("repro.serving.",
                                                      "repro.sharding.")))
           or (r == "jit-registry" and q.startswith("repro.core.packed:"))}
    assert {q for q, _ in ref} == set(COUNTERPARTS)
    port = _markers(port_analysis, "repro_torch")
    for q, rule in ref:
        assert COUNTERPARTS[q] in port and \
            COUNTERPARTS[q][1] == _MAPPED_RULES[rule], q
    assert port - set(COUNTERPARTS.values()) == PORT_ONLY


def test_every_port_marker_carries_a_justification():
    for root, _, files in os.walk(os.path.join(REPO, "src", "repro_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name), encoding="utf-8") as fh:
                for n, line in enumerate(fh, 1):
                    m = re.search(r"#\s*repolint:\s*disable(-file)?=(.*)",
                                  line)
                    if m and "analysis" not in root:
                        why = m.group(2).partition("--")[2].strip()
                        assert len(why) > 10, f"{name}:{n}"


# ------------------------------------------------ the dynamic complement
def _fake_module(name: str, src: str, filename: str) -> dict:
    g = {"__name__": name}
    exec(compile(src, filename, "exec"), g)
    return g


def _sync_at(line: int, module="repro_torch.serving.query_engine"):
    """A caller in ``module`` (compiled as its real file) whose call into a
    ``core`` helper that raises the sync warning sits at ``line``."""
    from repro_torch.analysis.syncs import SYNC_MESSAGE

    helper = _fake_module(
        "repro_torch.core.fake",
        f"import warnings\ndef sync():\n    warnings.warn({SYNC_MESSAGE!r})\n",
        os.path.join(REPO, "src", "repro_torch", "core", "fake.py"))
    path = os.path.join(REPO, "src", *module.split(".")) + ".py"
    caller = _fake_module(module, "\n" * (line - 2) +
                          "def call():\n    return sync()\n", path)
    caller["sync"] = helper["sync"]
    return caller["call"]


def _first_marked_line(rel: str) -> int:
    with open(os.path.join(REPO, rel), encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    return next(i + 2 for i, text in enumerate(lines)
                if text.strip().startswith(
                    "# repolint: disable=hot-path-sync"))


def test_sync_sites_attribute_to_the_hot_path_and_its_markers():
    """A sync raised in a helper outside the rule's scope is attributed to
    the innermost frame of ``repro_torch.serving``/``.sharding`` (the
    innermost port frame rides along), and counts as marked exactly when
    that line or the one above carries a ``hot-path-sync`` marker."""
    from repro_torch.analysis import syncs

    marked = _first_marked_line("src/repro_torch/serving/query_engine.py")
    project = syncs.port_project()
    for line, want_marked in ((marked, True), (marked - 3, False)):
        out, sites = syncs.record_syncs(_sync_at(line))
        assert out is None and len(sites) == 1
        site = sites[0]
        assert (site.module, site.line) == \
            ("repro_torch.serving.query_engine", line)
        assert site.inner == "repro_torch/core/fake.py:3"
        assert site.render() == \
            f"repro_torch/serving/query_engine.py:{line} (in " \
            f"repro_torch/core/fake.py:3)"
        assert (syncs.unmarked(sites, project) == []) == want_marked


def test_sync_sites_outside_the_scope_are_unmarked():
    from repro_torch.analysis import syncs

    out, sites = syncs.record_syncs(
        lambda: warnings.warn(syncs.SYNC_MESSAGE) or 7)
    assert out == 7 and [s.module for s in sites] == [""]
    assert syncs.unmarked(sites) == sites
    assert sites[0].render().startswith("outside the hot path's packages")


def test_record_syncs_passes_other_warnings_on():
    from repro_torch.analysis import syncs

    with pytest.warns(UserWarning, match="not a sync"):
        _, sites = syncs.record_syncs(warnings.warn, "not a sync")
    assert sites == []
