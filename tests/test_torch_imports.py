"""The port never imports JAX: importing every module of
safer2_recommender_tpu_torch in a fresh interpreter leaves ``jax`` and
``safer2_recommender_tpu`` out of ``sys.modules``, and no source of the
port reaches into the JAX package's files."""

import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import safer2_recommender_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "safer2_recommender_tpu"
             or m.startswith("safer2_recommender_tpu."))
print(len(names), bad, ",".join(names))
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    count, bad, names = res.stdout.strip().split(" ", 2)
    assert int(count) >= 25        # every module was reached
    assert bad == "[]", bad
    for mod in ("ops.woodbury", "ops.bdot", "data.synth", "probes.bdot",
                "probes.epoch_profile", "models.ials", "models.ialspp",
                "models.erm_mf", "models.cvar_mf", "models.safer2pp",
                "serving", "checkpoint", "parallel.mesh", "parallel.audit",
                "probes.scale", "probes.eval_scale", "probes.serving_scale",
                "probes.multichip", "dryrun"):
        assert f"safer2_recommender_tpu_torch.{mod}" in names.split(","), mod


def test_package_root_exports_the_jax_names():
    # every name the JAX package's root exports (its six models, Server,
    # ...) is exported by the port's root under the same name; the JAX
    # list is read from its source, so this test imports no JAX
    with open(os.path.join(REPO, "safer2_recommender_tpu",
                           "__init__.py")) as f:
        tree = ast.parse(f.read())
    jax_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and getattr(node.targets[0], "id", None) == "__all__")
    import safer2_recommender_tpu_torch as port
    assert {"IALS", "IALSpp", "ERMMF", "CVaRMF", "SAFER2", "SAFER2pp",
            "Server"} <= set(jax_all)
    missing = [n for n in jax_all if n not in port.__all__
               or not hasattr(port, n)]
    assert missing == []
    from safer2_recommender_tpu_torch.checkpoint import CheckpointManager
    from safer2_recommender_tpu_torch.models import MODEL_REGISTRY
    from safer2_recommender_tpu_torch.serving import Server
    assert port.Server is Server
    assert port.CheckpointManager is CheckpointManager
    assert {getattr(port, c.__name__) for c in MODEL_REGISTRY.values()} == \
        set(MODEL_REGISTRY.values())


_JAX_PKG = re.compile(r"safer2_recommender_tpu(?!_torch)")


def _docstring_nodes(tree):
    """The docstring constants of a module and its classes/functions."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                yield first.value


def _python_references(path):
    """Import statements and string constants in ``path`` that name the
    JAX package, outside docstrings and outside the value of a
    ``"replaces"`` key (chip_smoke's record of which TPU kernel a kernel
    ports); comments are not in the syntax tree at all."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    allowed = {id(n) for n in _docstring_nodes(tree)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    allowed.update(id(n) for n in ast.walk(v))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _JAX_PKG.match(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if _JAX_PKG.match(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in allowed and _JAX_PKG.search(node.value)):
            bad.append(f"line {node.lineno}: {node.value!r}")
    return bad


def _native_references(path):
    """Mentions of the JAX package in a C/C++/CUDA source once its
    comments are stripped (an #include or a string literal)."""
    with open(path) as f:
        text = f.read()
    code = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    code = re.sub(r"//[^\n]*", " ", code)
    return [m.group(0) for m in _JAX_PKG.finditer(code)]


def test_port_reads_no_file_of_the_jax_package():
    # the port keeps its own copy of what it needs (csrc/csv_reader.cc):
    # no source of it, and not chip_smoke.py, builds, opens or joins a
    # path inside safer2_recommender_tpu/ or imports from it; comments
    # and docstrings that name a counterpart are allowed
    pkg = os.path.join(REPO, "safer2_recommender_tpu_torch")
    py = [os.path.join(REPO, "chip_smoke.py")]
    native = []
    for root, _, files in os.walk(pkg):
        for name in files:
            full = os.path.join(root, name)
            if name.endswith(".py"):
                py.append(full)
            elif os.path.basename(root) == "csrc":
                native.append(full)
    assert len(py) >= 25 and len(native) >= 3
    for mod in ("ials", "ialspp", "erm_mf", "cvar_mf", "safer2pp"):
        assert os.path.join(pkg, "models", mod + ".py") in py, mod
    bad = {p: _python_references(p) for p in py}
    bad.update({p: _native_references(p) for p in native})
    bad = {os.path.relpath(p, REPO): b for p, b in bad.items() if b}
    assert bad == {}, bad

    from safer2_recommender_tpu_torch import native as port_native
    assert port_native.CSV_READER_SRC.startswith(pkg + os.sep)
    assert os.path.isfile(port_native.CSV_READER_SRC)


def test_reference_scan_catches_a_borrowed_path(tmp_path):
    # the scan above is not vacuous: a joined path into the JAX package
    # and an #include of its source are both caught, a docstring is not
    src = tmp_path / "m.py"
    src.write_text('"""Counterpart of safer2_recommender_tpu/native."""\n'
                   'import os\n'
                   'P = os.path.join("x", "safer2_recommender_tpu", "n.cc")\n')
    assert _python_references(str(src)) == [
        "line 3: 'safer2_recommender_tpu'"]
    cu = tmp_path / "k.cu"
    cu.write_text('// safer2_recommender_tpu/ops is the reference\n'
                  '#include "../../safer2_recommender_tpu/native/x.h"\n')
    assert _native_references(str(cu)) == ["safer2_recommender_tpu"]


def test_chip_smoke_imports_no_jax():
    # chip_smoke.py loads the port only inside main(); importing it and
    # the port's CLI must not pull JAX in either
    probe = ("import sys, chip_smoke; "
             "import safer2_recommender_tpu_torch.cli; "
             "print([m for m in sys.modules if m.split('.')[0] == 'jax'])")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
