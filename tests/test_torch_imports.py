"""The port stands alone: importing it (every submodule) and chip_smoke.py
brings in neither JAX nor the JAX package, and its entry points refuse to
run on the CPU unless asked to."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")

# modules each slice must bring, beside those the walk below finds
SLICE_MODULES = [
    "mxnet_tpu_torch.ops.flash_attention", "mxnet_tpu_torch.serve.engine",
    "mxnet_tpu_torch.models.transformer",
    # slice 2: training
    "mxnet_tpu_torch.autograd", "mxnet_tpu_torch.optimizer",
    "mxnet_tpu_torch.ops.optimizer_ops", "mxnet_tpu_torch.opt.kernels",
    "mxnet_tpu_torch.gluon.loss", "mxnet_tpu_torch.gluon.parameter",
    "mxnet_tpu_torch.gluon.trainer", "mxnet_tpu_torch.telemetry",
    # slice 9: ResNet-50 through Gluon
    "mxnet_tpu_torch.ops.nn", "mxnet_tpu_torch.random",
    "mxnet_tpu_torch.initializer", "mxnet_tpu_torch.lr_scheduler",
    "mxnet_tpu_torch.gluon.block", "mxnet_tpu_torch.gluon.nn.conv_layers",
    "mxnet_tpu_torch.gluon.model_zoo", "mxnet_tpu_torch.gluon.model_zoo.vision",
    # slice 10: the optimizers, amp, checkpoints
    "mxnet_tpu_torch.amp", "mxnet_tpu_torch.ndarray",
    "mxnet_tpu_torch.ndarray.serialization", "mxnet_tpu_torch.config"]

_PROBE = r"""
import importlib, pkgutil, sys
import mxnet_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                              "mxnet_tpu_torch.")]
for name in mods + %r:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "mxnet_tpu"
             or m.startswith("mxnet_tpu."))
print(len(mods), bad)
""" % (SLICE_MODULES,)


def test_import_brings_in_no_jax_nor_mxnet_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.split(" ", 1)
    assert int(n_mods) >= 30
    assert bad.strip() == "[]"


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_statement_names_jax_or_mxnet_tpu(path):
    """Also the imports inside functions, which the probe above only
    sees where they run."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), \
                f"{path}:{node.lineno} imports {name}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    from mxnet_tpu_torch import MXNetError, resolve_device
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.nn import BatchNorm, Conv2D, Dense, Dropout
    from mxnet_tpu_torch.models import BERTModel, TransformerLM
    from mxnet_tpu_torch.ndarray import load_frombuffer
    from mxnet_tpu_torch.random import generator
    from mxnet_tpu_torch.serve import ServingEngine
    for make in (lambda: ServingEngine(lambda x: x),
                 lambda: BERTModel(num_layers=1),
                 lambda: BERTModel(num_layers=1, dtype=torch.float16),
                 lambda: Dropout(0.1),
                 lambda: TransformerLM(100, num_layers=1),
                 lambda: resnet50_v1(),
                 lambda: Conv2D(8, 3, in_channels=3),
                 lambda: BatchNorm(in_channels=8),
                 lambda: Dense(4, 8),
                 lambda: generator(),
                 lambda: load_frombuffer(b""),
                 lambda: resolve_device(None)):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
