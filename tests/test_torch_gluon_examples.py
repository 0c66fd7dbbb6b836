"""The Gluon scripts under ``examples/`` run in the port.

Each script's source is loaded with ``mxnet_tpu`` rebound to
``mxnet_tpu_torch`` (``examples/`` is not edited) and its ``main`` runs
its own model and loop for one or two steps on its own synthetic data
under ``with mx.cpu():``. Every loss a backward starts from
(``NDArray.backward`` and ``autograd.backward``) is recorded: there must
be at least one and all must be finite.

All twenty-two run: none needs a module the port leaves out. Seven of
them are recurrent: ``bi_lstm_sort``, ``named_entity_recognition`` and
``multivariate_time_series`` take ``gluon.rnn``'s LSTM and GRU layers,
``rnn/word_lm.py`` a tied LSTM language model (its ``params=`` sharing),
``ctc`` and ``speech_recognition`` an LSTM under ``CTCLoss`` and
``captcha`` a convolutional net under ``nd.CTCLoss``. The other Gluon
scripts are driven elsewhere or wait for the slices ROADMAP names.

``stochastic_depth/sd_resnet.py`` skips residual blocks at random, so a
step's backward does not reach every parameter. The JAX package's
Trainer updates such a parameter from its old gradient buffer; the port
keeps the reference's check, which raises for a gradient that no
backward wrote since the last step unless ``ignore_stale_grad``, so that
script runs with ``Trainer.step(..., ignore_stale_grad=True)``.
"""
import math
import os
import re
import types

import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.ndarray import ndarray as nd_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")

# script -> its arguments for a run of one or two steps
SCRIPTS = {
    "gan/dcgan.py": ["--steps", "2", "--batch-size", "8"],
    "dsd/dsd_train.py": ["--phase-steps", "1", "--batch-size", "8"],
    "reinforcement_learning/reinforce.py": ["--episodes", "2",
                                            "--batch-size", "8"],
    "vae_gan/vae_gan.py": ["--steps", "2", "--batch", "8"],
    "adversary/fgsm.py": ["--steps", "2", "--batch-size", "8"],
    "recommenders/matrix_fact.py": ["--steps", "2", "--batch-size", "16"],
    "deep_embedded_clustering/dec.py": ["--n", "48", "--pretrain-steps",
                                        "2", "--dec-steps", "2"],
    "stochastic_depth/sd_resnet.py": ["--steps", "2", "--batch-size", "4"],
    "nce_loss/nce_lm.py": ["--steps", "2", "--batch-size", "8"],
    "autoencoder/train_ae.py": ["--steps", "2", "--batch-size", "8"],
    "capsnet/capsnet.py": ["--steps", "2", "--batch-size", "4"],
    "cnn_text_classification/text_cnn.py": ["--steps", "2",
                                            "--batch-size", "4"],
    "fcn_xs/fcn_seg.py": ["--steps", "2", "--batch-size", "2"],
    "neural_style/neural_style.py": ["--steps", "2", "--size", "16"],
    "multi_task/multitask.py": ["--steps", "2", "--batch-size", "8"],
    "bi_lstm_sort/sort_lstm.py": ["--steps", "2", "--batch-size", "8"],
    "captcha/cnn_ctc.py": ["--steps", "2", "--batch", "4"],
    "ctc/ctc_train.py": ["--steps", "2", "--batch-size", "4"],
    "multivariate_time_series/lstnet.py": ["--steps", "2",
                                           "--batch-size", "8"],
    "named_entity_recognition/ner.py": ["--steps", "2", "--batch-size", "8"],
    # two steps: 22 rows of the built-in corpus in bptt windows of 8
    "rnn/word_lm.py": ["--epochs", "1", "--batch-size", "64", "--bptt", "8",
                       "--embed-size", "8", "--hidden", "8"],
    "speech_recognition/lstm_ctc.py": ["--steps", "2", "--batch", "4"],
}

# scripts whose steps leave some parameters without a gradient
SKIPS_BLOCKS = {"stochastic_depth/sd_resnet.py"}


def load_ported(rel):
    """The script at ``examples/<rel>`` as a module, its imports of
    ``mxnet_tpu`` rebound to ``mxnet_tpu_torch``."""
    path = os.path.join(EXAMPLES, rel)
    with open(path) as f:
        src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", f.read())
    mod = types.ModuleType("ported_" + rel.replace("/", "_")[:-3])
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


@pytest.fixture
def losses(monkeypatch):
    """Every value a backward starts from, as floats."""
    seen = []
    nd_backward, ag_backward = nd_mod.NDArray.backward, autograd.backward

    def note(heads):
        for h in heads if isinstance(heads, (list, tuple)) else [heads]:
            seen.append(float(getattr(h, "_data", h).detach().sum()))

    def nd_wrapped(self, *args, **kwargs):
        note(self)
        return nd_backward(self, *args, **kwargs)

    def ag_wrapped(heads, *args, **kwargs):
        note(heads)
        return ag_backward(heads, *args, **kwargs)

    monkeypatch.setattr(nd_mod.NDArray, "backward", nd_wrapped)
    monkeypatch.setattr(autograd, "backward", ag_wrapped)
    return seen


@pytest.mark.parametrize("rel", sorted(SCRIPTS))
def test_example_trains_in_the_port(rel, losses, monkeypatch):
    if rel in SKIPS_BLOCKS:
        step = mx.gluon.Trainer.step
        monkeypatch.setattr(mx.gluon.Trainer, "step", lambda self, b, **kw:
                            step(self, b, ignore_stale_grad=True))
    mod = load_ported(rel)
    with mx.cpu():
        mod.main(SCRIPTS[rel])
    assert losses, f"{rel}: no backward ran"
    assert all(math.isfinite(v) for v in losses), losses
