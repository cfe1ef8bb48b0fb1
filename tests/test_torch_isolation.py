"""The port stands alone: no module of ``bigdl_tpu_torch`` and none of
``chip_smoke.py``, ``recurrence_ab.py``, ``recurrence_plans.py`` and
``pool_s1_split.py`` imports JAX or the JAX package (the machine with the card has no JAX).
Top-level names are matched exactly, since ``bigdl_tpu_torch`` starts
with ``bigdl_tpu``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "bigdl_tpu"}

_PROBE = """
import importlib, pkgutil, sys
import bigdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                 "bigdl_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print(len(names), bad)
""" % (FORBIDDEN,)


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20          # every module was walked
    assert bad == "[]"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_no_source_names_jax_or_the_jax_package():
    files = sorted((ROOT / "bigdl_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "recurrence_ab.py",
              ROOT / "recurrence_plans.py", ROOT / "pool_s1_split.py"]
    assert len(files) > 20
    hits = [f"{p.relative_to(ROOT)}:{line} imports {root}"
            for p in files for root, line in _imported_roots(p)
            if root in FORBIDDEN]
    assert hits == []


def test_walk_covers_the_training_slice():
    """The import probe above reaches the training slice's modules."""
    import pkgutil

    import bigdl_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                   "bigdl_tpu_torch.")}
    assert {f"bigdl_tpu_torch.{n}" for n in (
        "ops.sgd", "ops.maxpool", "nn.conv", "nn.pooling", "nn.criterion",
        "models.lenet", "dataset.dataset", "dataset.image", "dataset.mnist",
        "optim.local_optimizer", "optim.optimizer", "optim.optim_method",
        "utils.table")} <= names


def test_walk_covers_the_inception_slice():
    """The import probe reaches the conv-net slice's modules too."""
    import pkgutil

    import bigdl_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                   "bigdl_tpu_torch.")}
    assert {f"bigdl_tpu_torch.{n}" for n in (
        "ops.lrn", "ops.maxpool_s1", "ops._build", "nn.normalization",
        "nn.containers", "nn.shape_ops", "nn.init", "models.inception",
        "dataset.transformer")} <= names


def test_walk_covers_the_recurrence_slice():
    """The import probe reaches the text-classifier slice's modules."""
    import pkgutil

    import bigdl_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                   "bigdl_tpu_torch.")}
    assert {f"bigdl_tpu_torch.{n}" for n in (
        "ops.bilstm", "nn.recurrent", "nn.reductions",
        "models.textclassifier", "dataset.news20")} <= names


def test_walk_covers_the_rnn_and_gru_slice():
    """The import probe reaches the SimpleRNN and GRU slice's modules."""
    import pkgutil

    import bigdl_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                   "bigdl_tpu_torch.")}
    assert {f"bigdl_tpu_torch.{n}" for n in (
        "ops.rnn", "ops.gru", "ops._recurrence", "models.rnn",
        "dataset.text")} <= names


def test_walk_covers_the_int8_kv_and_lstm_scan_slice():
    """The import probe reaches the int8-KV serving and lstm_scan
    slice's modules."""
    import pkgutil

    import bigdl_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                   "bigdl_tpu_torch.")}
    assert {f"bigdl_tpu_torch.{n}" for n in (
        "quant", "quant.kv", "ops.lstm_scan", "ops.paged_attention",
        "utils.random", "nn.dropout")} <= names
