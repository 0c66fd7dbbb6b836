"""The port's metrics against the JAX package's, on the CPU.

Each metric takes two updates of numpy-seeded labels and predictions in
both packages (the port's as NDArrays, and again as tensors);
``get()`` and ``get_global()`` agree within rtol 1e-6 (the counts
exactly; the port reduces in fp32 or fp64 on the device where the
reference reduces in numpy on the host).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import metric as jmetric
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import metric, nd

RTOL = 1e-6


def _data(kind, seed):
    rs = np.random.RandomState(seed)
    if kind == "class":
        pred = rs.rand(16, 5).astype("float32")
        pred /= pred.sum(1, keepdims=True)
        return rs.randint(0, 5, 16).astype("float32"), pred
    if kind == "binary":
        return (rs.randint(0, 2, 16).astype("float32"),
                rs.rand(16, 2).astype("float32"))
    if kind == "regress":
        return (rs.randn(8, 3).astype("float32"),
                rs.randn(8, 3).astype("float32"))
    if kind == "seq":
        pred = rs.rand(2, 6, 5).astype("float32")
        pred /= pred.sum(-1, keepdims=True)
        return rs.randint(0, 5, (2, 6)).astype("float32"), pred
    raise ValueError(kind)


CASES = [
    ("acc", "class", {}), ("accuracy", "class", {"axis": 1}),
    ("top_k_accuracy", "class", {"top_k": 3}), ("f1", "binary", {}),
    ("mcc", "binary", {}), ("mae", "regress", {}), ("mse", "regress", {}),
    ("rmse", "regress", {}), ("ce", "class", {}), ("nll_loss", "class", {}),
    ("perplexity", "seq", {}), ("perplexity", "seq", {"ignore_label": 2}),
    ("pearsonr", "regress", {}), ("pcc", "class", {}), ("loss", "regress", {}),
]


def _run(pkg, wrap, name, kind, kwargs):
    m = pkg.create(name, **kwargs)
    for seed in (1, 2):
        label, pred = _data(kind, seed)
        m.update([wrap(label)], [wrap(pred)])
    return m.get(), m.get_global()


@pytest.mark.parametrize("name,kind,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
@pytest.mark.parametrize("as_nd", [True, False], ids=["ndarray", "tensor"])
def test_metric_matches_the_jax_package(name, kind, kwargs, as_nd):
    jres = _run(jmetric, jnd.array, name, kind, kwargs)
    with mx.cpu():
        tres = _run(metric, nd.array if as_nd else torch.from_numpy, name,
                    kind, kwargs)
    for (jn, jv), (tn, tv) in zip(jres, tres):
        assert jn == tn
        assert tv == pytest.approx(jv, rel=RTOL, nan_ok=True)


def test_accuracy_counts_on_the_device_and_takes_labels_of_rank_pred():
    with mx.cpu():
        acc = metric.Accuracy()
        acc.update(nd.array([0, 1, 2]), nd.array([[0.9, 0.1, 0.0],
                                                  [0.2, 0.7, 0.1],
                                                  [0.5, 0.4, 0.1]]))
        acc.update([nd.array([1, 1])], [nd.array([1, 0])])
    assert acc.sum_metric == 3 and acc.num_inst == 5
    assert acc.get() == ("accuracy", 0.6)
    acc.reset_local()
    assert acc.get()[1] != acc.get()[1]     # nan
    assert acc.get_global() == ("accuracy", 0.6)


def test_composite_custom_and_create():
    def sq_err(label, pred):
        assert isinstance(label, np.ndarray)
        return float(((label - pred) ** 2).sum()), label.size

    with mx.cpu():
        comp = metric.create(["acc", metric.MAE(), sq_err])
        label, pred = nd.array([1.0, 0.0]), nd.array([1.0, 1.0])
        comp.update([label], [pred])
        names, values = comp.get()
        custom = metric.np(lambda lab, p: float(np.abs(lab - p).max()))
        custom.update([label], [pred])
    assert names == ["accuracy", "mae", "sq_err"]
    assert values == pytest.approx([0.5, 0.5, 0.5])
    assert custom.get()[1] == 1.0
    assert isinstance(comp.get_metric(1), metric.MAE)
    assert dict(metric.Loss().get_name_value()).keys() == {"loss"}
    with pytest.raises(mx.MXNetError, match="not registered"):
        metric.create("no-such-metric")
    with pytest.raises(ValueError, match="does not match"):
        metric.Accuracy().update([label, label], [pred])


def test_update_dict_selects_outputs_and_labels_by_name():
    with mx.cpu():
        m = metric.Accuracy(output_names=["out"], label_names=["y"])
        m.update_dict({"y": nd.array([1.0]), "z": nd.array([0.0])},
                      {"out": nd.array([[0.1, 0.9]]),
                       "other": nd.array([[0.9, 0.1]])})
    assert m.get()[1] == 1.0
