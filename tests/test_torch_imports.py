"""The port stands alone: importing it (every submodule) and chip_smoke.py
brings in neither JAX nor the JAX package, and its entry points refuse to
run on the CPU unless asked to."""
import ast
import os
import subprocess
import sys

import numpy as np
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
    "mxnet_tpu_torch.ndarray.serialization", "mxnet_tpu_torch.config",
    # slice 11: the mx.nd surface
    "mxnet_tpu_torch.context", "mxnet_tpu_torch.ops.registry",
    "mxnet_tpu_torch.ndarray.ndarray", "mxnet_tpu_torch.ops.tensor",
    "mxnet_tpu_torch.ops.random_ops", "mxnet_tpu_torch.ops.extra_ops",
    "mxnet_tpu_torch.ops.fused", "mxnet_tpu_torch.ops.aliases",
    "mxnet_tpu_torch.ops.deferred", "mxnet_tpu_torch.metric",
    # slice 12: the symbolic stack
    "mxnet_tpu_torch.name", "mxnet_tpu_torch.attribute",
    "mxnet_tpu_torch.symbol", "mxnet_tpu_torch.symbol.symbol",
    "mxnet_tpu_torch.symbol.control_flow", "mxnet_tpu_torch.ops.control_flow",
    "mxnet_tpu_torch.executor", "mxnet_tpu_torch.executor_manager",
    "mxnet_tpu_torch.io", "mxnet_tpu_torch.io.io", "mxnet_tpu_torch.model",
    "mxnet_tpu_torch.callback", "mxnet_tpu_torch.module",
    "mxnet_tpu_torch.module.base_module", "mxnet_tpu_torch.module.module",
    "mxnet_tpu_torch.module.executor_group",
    "mxnet_tpu_torch.module.bucketing_module",
    "mxnet_tpu_torch.module.sequential_module",
    # slice 13: sparse storage
    "mxnet_tpu_torch.ndarray.sparse", "mxnet_tpu_torch.ndarray.sparse_ops",
    # slice 14: autoregressive LM serving
    "mxnet_tpu_torch.opt.verify", "mxnet_tpu_torch.parallel.pipeline_lm",
    "mxnet_tpu_torch.parallel.paged_attention", "mxnet_tpu_torch.serve2",
    "mxnet_tpu_torch.serve2.kvcache", "mxnet_tpu_torch.serve2.prefix",
    "mxnet_tpu_torch.serve2.decode", "mxnet_tpu_torch.serve2.scheduler",
    "mxnet_tpu_torch.serve2.router", "mxnet_tpu_torch.resil",
    "mxnet_tpu_torch.resil.policy", "mxnet_tpu_torch.serve.endpoint",
    "mxnet_tpu_torch.passes", "mxnet_tpu_torch.passes.servelint",
    # slice 15: the fused training step
    "mxnet_tpu_torch.step", "mxnet_tpu_torch.step.stepfn",
    "mxnet_tpu_torch.step.buckets", "mxnet_tpu_torch.step.cache",
    "mxnet_tpu_torch.engine", "mxnet_tpu_torch.passes.steplint",
    # slice 16: parameters, layers, losses, gluon.data, the zoo families
    "mxnet_tpu_torch.gluon.nn.basic_layers", "mxnet_tpu_torch.gluon.utils",
    "mxnet_tpu_torch.gluon.data", "mxnet_tpu_torch.gluon.data.dataset",
    "mxnet_tpu_torch.gluon.data.sampler",
    "mxnet_tpu_torch.gluon.data.dataloader",
    "mxnet_tpu_torch.gluon.data.vision",
    "mxnet_tpu_torch.gluon.data.vision.transforms",
    "mxnet_tpu_torch.gluon.data.vision.datasets",
    # slice 17: recurrent networks and the rest of gluon.contrib
    "mxnet_tpu_torch.ops.rnn", "mxnet_tpu_torch.ops.ctc",
    "mxnet_tpu_torch.gluon.rnn", "mxnet_tpu_torch.gluon.rnn.rnn_layer",
    "mxnet_tpu_torch.gluon.rnn.rnn_cell", "mxnet_tpu_torch.gluon.contrib",
    "mxnet_tpu_torch.gluon.contrib.nn",
    "mxnet_tpu_torch.gluon.contrib.nn.basic_layers",
    "mxnet_tpu_torch.gluon.contrib.rnn",
    "mxnet_tpu_torch.gluon.contrib.rnn.rnn_cell",
    "mxnet_tpu_torch.gluon.contrib.rnn.conv_rnn_cell",
    "mxnet_tpu_torch.gluon.contrib.cnn",
    "mxnet_tpu_torch.gluon.contrib.cnn.conv_layers",
    "mxnet_tpu_torch.gluon.contrib.data",
    "mxnet_tpu_torch.gluon.contrib.data.sampler",
    "mxnet_tpu_torch.gluon.contrib.estimator",
    "mxnet_tpu_torch.gluon.contrib.estimator.estimator",
    "mxnet_tpu_torch.gluon.contrib.estimator.event_handler",
    "mxnet_tpu_torch.rnn", "mxnet_tpu_torch.rnn.rnn_cell",
    "mxnet_tpu_torch.rnn.rnn", "mxnet_tpu_torch.rnn.io",
    # slice 18: the image input pipeline and image serving
    "mxnet_tpu_torch.recordio", "mxnet_tpu_torch.native",
    "mxnet_tpu_torch.image", "mxnet_tpu_torch.ops.image_ops"]

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
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError, nd, resolve_device
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.nn import BatchNorm, Conv2D, Dense, Dropout
    from mxnet_tpu_torch.models import BERTModel, TransformerLM
    from mxnet_tpu_torch.ndarray import load_frombuffer
    from mxnet_tpu_torch.random import generator
    from mxnet_tpu_torch.convert import pipeline_lm_from_mxnet_tpu
    from mxnet_tpu_torch.parallel.pipeline_lm import init_pipeline_lm
    from mxnet_tpu_torch.serve import ServingEngine
    from mxnet_tpu_torch.serve2 import DecodeEngine, PagedLM
    lm = dict(vocab=8, d_model=4, n_layers=1, n_heads=1, d_head=4, d_ff=8,
              n_experts=1)
    tree = init_pipeline_lm(0, device="cpu", **lm)
    for make in (lambda: ServingEngine(lambda x: x),
                 lambda: init_pipeline_lm(0, **lm),
                 lambda: pipeline_lm_from_mxnet_tpu(tree),
                 lambda: PagedLM(tree, page_size=4, num_pages=4,
                                 max_pages_per_seq=2),
                 lambda: DecodeEngine(tree, num_pages=8,
                                      prefill_buckets=[8]),
                 lambda: BERTModel(num_layers=1),
                 lambda: BERTModel(num_layers=1, dtype=torch.float16),
                 lambda: Dropout(0.1, device="cuda"),
                 lambda: TransformerLM(100, num_layers=1),
                 lambda: resnet50_v1(device="cuda"),
                 lambda: resnet50_v1().initialize(),
                 lambda: Conv2D(8, 3, in_channels=3).initialize(),
                 lambda: Conv2D(8, 3).initialize(),
                 lambda: BatchNorm(in_channels=8).initialize(),
                 lambda: Dense(4, in_units=8).initialize(),
                 lambda: Dense(4).collect_params().initialize(),
                 lambda: generator(),
                 lambda: load_frombuffer(b""),
                 lambda: resolve_device(None),
                 lambda: mx.gpu(0), lambda: mx.current_context(),
                 lambda: nd.array([1.0]), lambda: nd.zeros((2,)),
                 lambda: nd.random.uniform(shape=(2,)),
                 lambda: mx.mod.Module(mx.sym.var("x")),
                 lambda: mx.sym.var("x").simple_bind(x=(2,)),
                 lambda: mx.io.NDArrayIter(np.zeros((2, 2)))):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_initialize_takes_the_current_context_and_raises_without_cuda():
    """A model built without a device is made where ``initialize`` says:
    its ``ctx``, else the current context, which is ``gpu(0)`` (raising
    here) outside a ``with mx.cpu():`` scope; a deferred parameter keeps
    that device for its first forward."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    net = get_model("mobilenetv2_0.25", classes=4)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        net.initialize()
    with mx.cpu():
        net.initialize()
    dense = nn.Dense(3)
    dense.initialize(ctx=mx.cpu())
    out = dense(torch.ones(2, 5))
    assert out.shape == (2, 3) and dense.weight.device.type == "cpu"


NATIVE = os.path.join(PKG, "native")


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(NATIVE) if f.endswith((".cc", ".h"))))
def test_native_sources_include_nothing_of_the_jax_package(name):
    with open(os.path.join(NATIVE, name)) as f:
        includes = [line for line in f if line.startswith("#include")]
    assert includes and not any("mxnet_tpu" in line for line in includes)


def test_record_pipeline_entry_points_raise_without_cuda(tmp_path):
    """The record iterators (the native pipeline's and the Python one's),
    ``ImageRecordDataset`` under a thread-pool ``DataLoader`` and a
    ``ServingEngine`` over an image net default to the card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError, image, recordio
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    from mxnet_tpu_torch.serve import ServingEngine
    img = np.random.RandomState(0).randint(0, 255, (9, 9, 3)).astype("uint8")
    paths = {}
    for fmt in (".jpg", ".png"):
        path = str(tmp_path / f"a{fmt[1:]}.rec")
        w = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
        label = np.array([2, 5, 1, 0.1, 0.1, 0.6, 0.6], "float32")
        w.write_idx(0, recordio.pack_img(recordio.IRHeader(0, label, 0, 0),
                                         img, img_fmt=fmt))
        w.close()
        paths[fmt] = path
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(2, 3), nn.BatchNorm(), nn.Dense(3))
        net.initialize(ctx=mx.cpu())
    kw = dict(data_shape=(3, 8, 8), batch_size=1)
    for make in (
            lambda: mx.io.ImageRecordIter(path_imgrec=paths[".jpg"], **kw),
            lambda: mx.io.ImageRecordIter(path_imgrec=paths[".png"], **kw),
            lambda: mx.io.ImageDetRecordIter(path_imgrec=paths[".jpg"],
                                             **kw),
            lambda: image.ImageIter(path_imgrec=paths[".jpg"], **kw),
            lambda: image.imdecode(recordio.unpack(
                recordio.MXRecordIO(paths[".jpg"], "r").read())[1]),
            lambda: next(iter(DataLoader(ImageRecordDataset(paths[".jpg"]),
                                         batch_size=1, num_workers=2,
                                         thread_pool=True))),
            lambda: ServingEngine(net, input_specs=[(3, 8, 8)])):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            make()
