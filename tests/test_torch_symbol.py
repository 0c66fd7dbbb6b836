"""The port's Symbol against the JAX package's on the CPU: the graphs of
``examples/image_classification/train_mnist.py`` (LeNet and the MLP),
``bench.py``'s ``conv_net`` and ``lm_block`` (rebuilt here as bench.py
builds them), and a narrow ``lm_block`` whose attention is one
``_fused_attention`` node.

- each graph built in a fresh ``NameManager`` writes the same JSON in
  both packages, node for node, and each package's JSON loads in the
  other and writes itself back unchanged;
- ``list_arguments``/``list_auxiliary_states``/``list_outputs``,
  ``infer_shape``/``infer_shape_partial`` and ``infer_type`` agree (the
  port infers shapes on meta tensors, with the rules of
  ``SHAPE_RULES`` for the ops that cannot run there);
- contradictory shapes raise in both;
- names (``NameManager``/``Prefix``), ``AttrScope``, composition and
  arithmetic, ``get_internals``/``get_children``, ``Group`` and
  ``__getitem__`` as in ``tests/test_symbol_module.py``.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import sym as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym
from mxnet_tpu_torch.symbol.symbol import SHAPE_RULES

BATCH = 4


def mlp(S):
    data = S.var("data")
    h = S.flatten(data)
    h = S.Activation(S.FullyConnected(h, num_hidden=32, name="fc1"),
                     act_type="relu")
    h = S.Activation(S.FullyConnected(h, num_hidden=16, name="fc2"),
                     act_type="relu")
    h = S.FullyConnected(h, num_hidden=10, name="fc3")
    return S.SoftmaxOutput(h, name="softmax"), {"data": (BATCH, 1, 28, 28)}


def lenet(S):
    data = S.var("data")
    c1 = S.Convolution(data, kernel=(5, 5), num_filter=20)
    a1 = S.Activation(c1, act_type="tanh")
    p1 = S.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = S.Convolution(p1, kernel=(5, 5), num_filter=50)
    a2 = S.Activation(c2, act_type="tanh")
    p2 = S.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = S.flatten(p2)
    h = S.Activation(S.FullyConnected(f, num_hidden=500), act_type="tanh")
    h = S.FullyConnected(h, num_hidden=10)
    return S.SoftmaxOutput(h, name="softmax"), {"data": (BATCH, 1, 28, 28)}


def conv_net(S):
    n = S.var("data")
    for i, nf in enumerate((32, 64, 64)):
        n = S.Convolution(n, kernel=(3, 3), num_filter=nf, pad=(1, 1),
                          name=f"c{i}")
        n = S.BatchNorm(n, name=f"bn{i}")
        n = S.Activation(n, act_type="relu", name=f"r{i}")
        if i < 2:
            n = S.Pooling(n, kernel=(2, 2), stride=(2, 2), pool_type="max",
                          name=f"p{i}")
    n = S.Pooling(n, global_pool=True, pool_type="avg", name="gap")
    n = S.Flatten(n)
    n = S.FullyConnected(n, num_hidden=64, name="fc1")
    n = S.Activation(n, act_type="relu", name="fca")
    return (S.FullyConnected(n, num_hidden=10, name="fc2"),
            {"data": (BATCH, 3, 56, 56)})


def lm_block(S, T=64, C=128, H=4, fused=False):
    D = C // H
    x = S.var("data")
    proj = {}
    for nm in ("q", "k", "v"):
        p = S.FullyConnected(x, num_hidden=C, flatten=False, no_bias=True,
                             name=nm)
        p = S.reshape(p, shape=(BATCH, T, H, D))
        proj[nm] = S.transpose(p, axes=(0, 2, 1, 3))
    if fused:
        att = S._fused_attention(proj["q"], proj["k"], proj["v"],
                                 scale=1.0 / D ** 0.5, name="att")
    else:
        scores = S.batch_dot(proj["q"], proj["k"],
                             transpose_b=True) * (1.0 / D ** 0.5)
        att = S.batch_dot(S.softmax(scores, axis=-1), proj["v"], name="att")
    att = S.transpose(att, axes=(0, 2, 1, 3))
    att = S.reshape(att, shape=(BATCH, T, C))
    h = S.broadcast_add(x, S.FullyConnected(att, num_hidden=C,
                                            flatten=False, name="o"))
    f = S.FullyConnected(h, num_hidden=4 * C, flatten=False, name="ff1")
    f = S.Activation(f, act_type="relu", name="ffr")
    f = S.FullyConnected(f, num_hidden=C, flatten=False, name="ff2")
    return S.broadcast_add(h, f, name="out"), {"data": (BATCH, T, C)}


def lm_block_fused(S):
    return lm_block(S, T=16, C=32, H=2, fused=True)


GRAPHS = {"mlp": mlp, "lenet": lenet, "conv_net": conv_net,
          "lm_block": lm_block, "lm_block_fused": lm_block_fused}


def _build(pkg, make):
    S = jsym if pkg is jmx else sym
    with pkg.name.NameManager():
        return make(S)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    make = GRAPHS[request.param]
    (j, shapes), (t, _) = _build(jmx, make), _build(mx, make)
    return j, t, shapes


def test_json_is_node_for_node_the_jax_packages(pair):
    j, t, _ = pair
    assert json.loads(t.tojson()) == json.loads(j.tojson())


def test_json_crosses_both_ways(pair):
    j, t, _ = pair
    t_from_j = sym.load_json(j.tojson())
    j_from_t = jsym.load_json(t.tojson())
    assert json.loads(t_from_j.tojson()) == json.loads(j.tojson())
    assert json.loads(j_from_t.tojson()) == json.loads(t.tojson())
    assert t_from_j.list_arguments() == j.list_arguments()


def test_lists_agree(pair):
    j, t, _ = pair
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_inputs() == j.list_inputs()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()


def test_infer_shape_agrees(pair):
    j, t, shapes = pair
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    assert t.infer_shape_partial() == j.infer_shape_partial()


def test_infer_type_agrees(pair):
    j, t, _ = pair
    assert t.infer_type(data="float32") == j.infer_type(data="float32")
    assert t.infer_type(data="float16") == j.infer_type(data="float16")


def test_infer_type_adopts_carrier_dtype():
    for S in (jsym, sym):
        fc = S.FullyConnected(S.var("data"), num_hidden=3, name="fc")
        args, outs, _ = fc.infer_type(data="float64")
        assert [str(a) for a in args] == ["float64"] * 3
        assert str(outs[0]) == "float64"


@pytest.mark.parametrize("shapes", [
    {"data": (2, 3), "fc_weight": (4, 5)},
    {"data": (2, 3, 4, 4), "c_weight": (8, 5, 3, 3)},
])
def test_contradictory_shapes_raise_in_both(shapes):
    for pkg, S in ((jmx, jsym), (mx, sym)):
        if "c_weight" in shapes:
            net = S.Convolution(S.var("data"), kernel=(3, 3), num_filter=8,
                                name="c")
        else:
            net = S.FullyConnected(S.var("data"), num_hidden=4, name="fc")
        with pytest.raises(pkg.base.MXNetError, match="shape inference"):
            net.infer_shape(**shapes)


def test_shape_rules_name_the_ops_that_cannot_run_on_meta_tensors():
    """Embedding's index input, the kernel wrapper behind
    _fused_attention, the control-flow nodes and the library calls of RNN
    and CTCLoss have rules of their own; each gives what the JAX package
    infers, and a contradiction raises. The JAX package leaves an RNN's
    parameter vector and states unknown; the port infers them from the
    data's shape (what ``mx.rnn.FusedRNNCell`` needs to bind)."""
    assert set(SHAPE_RULES) == {"_fused_attention", "Embedding",
                                "_contrib_SparseEmbedding", "_foreach",
                                "_while_loop", "_cond", "RNN", "CTCLoss"}
    for pkg, S in ((jmx, jsym), (mx, sym)):
        emb = S.Embedding(S.var("data"), input_dim=11, output_dim=6,
                          name="emb")
        q, k, v = S.var("q"), S.var("k"), S.var("v")
        att = S._fused_attention(q, k, v, scale=0.5, name="att")
        assert emb.infer_shape(data=(3, 5)) == (
            [(3, 5), (11, 6)], [(3, 5, 6)], [])
        assert att.infer_shape(q=(2, 3, 7, 8), k=(2, 3, 9, 8),
                               v=(2, 3, 9, 4))[1] == [(2, 3, 7, 4)]
        with pytest.raises(pkg.base.MXNetError):
            att.infer_shape(q=(2, 3, 7, 8), k=(2, 3, 9, 6), v=(2, 3, 9, 4))
        ctc = S.CTCLoss(S.var("x"), S.var("y"), name="ctc")
        assert ctc.infer_shape(x=(7, 3, 5), y=(3, 2)) == (
            [(7, 3, 5), (3, 2)], [(3,)], [])
    rnn = sym.RNN(data=sym.var("data"), parameters=sym.var("p"),
                  state=sym.var("h"), state_cell=sym.var("c"), state_size=4,
                  num_layers=2, mode="lstm", bidirectional=True,
                  state_outputs=True, name="rnn")
    assert rnn.infer_shape(data=(5, 3, 6)) == (
        [(5, 3, 6), (832,), (4, 3, 4), (4, 3, 4)],
        [(5, 3, 8), (4, 3, 4), (4, 3, 4)], [])


def test_names_prefix_and_attr_scope():
    with mx.name.Prefix("enc_"):
        a = sym.FullyConnected(sym.var("x"), num_hidden=4)
        b = sym.FullyConnected(sym.var("x"), num_hidden=4)
    assert a.name == "enc_fullyconnected0"
    assert b.name == "enc_fullyconnected1"
    with mx.name.NameManager():
        c = sym.relu(sym.var("x"))
    assert c.name == "relu0"
    with mx.AttrScope(ctx_group="dev1", stage="0"):
        a = sym.relu(sym.var("x"))
        with mx.AttrScope(ctx_group="dev2"):
            b = sym.relu(sym.var("y"))
            v = sym.var("w", lr_mult=2.0)
    assert a.attr("ctx_group") == "dev1" and a.attr("stage") == "0"
    assert b.attr("ctx_group") == "dev2" and b.attr("stage") == "0"
    assert v.attr("ctx_group") == "dev2" and v.attr("__lr_mult__") == 2.0
    assert sym.relu(sym.var("z")).attr("ctx_group") is None
    with mx.AttrScope(ctx_group="dev1"):
        d = sym.relu(sym.var("q"), attr={"ctx_group": "dev9"})
    assert d.attr("ctx_group") == "dev9"


def test_arithmetic_group_getitem_and_children_agree():
    def build(S):
        a, b = S.var("a"), S.var("b")
        c = (a + b) * 2.0 - a / b
        d = 1.0 - (-c) ** 2.0
        e = (a > b) + (a <= 1.0) + (a == b) + (a != 3.0)
        g = S.Group([c, d, e, S.sum(c, axis=1)])
        return g, c
    with jmx.name.NameManager():
        jg, jc = build(jsym)
    with mx.name.NameManager():
        tg, tc = build(sym)
    assert json.loads(tg.tojson()) == json.loads(jg.tojson())
    assert tg.list_outputs() == jg.list_outputs()
    assert tg[1].list_outputs() == jg[1].list_outputs()
    assert tg[1:3].list_outputs() == jg[1:3].list_outputs()
    name = jg.list_outputs()[0]
    assert tg[name].name == jg[name].name
    assert tc.get_children().list_outputs() == \
        jc.get_children().list_outputs()
    a = np.arange(1, 7, dtype="float32").reshape(2, 3)
    b = a[::-1].copy() + 0.5
    want = [o.asnumpy() for o in jg.eval(a=jmx.nd.array(a),
                                         b=jmx.nd.array(b))]
    got = [o.asnumpy() for o in tg.eval(ctx=mx.cpu(), a=mx.nd.array(
        a, ctx=mx.cpu()), b=mx.nd.array(b, ctx=mx.cpu()))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


def test_save_and_load_files_cross(tmp_path):
    (j, _), (t, _) = _build(jmx, lenet), _build(mx, lenet)
    j.save(str(tmp_path / "j.json"))
    t.save(str(tmp_path / "t.json"))
    assert json.loads(sym.load(str(tmp_path / "j.json")).tojson()) == \
        json.loads(j.tojson())
    assert json.loads(jsym.load(str(tmp_path / "t.json")).tojson()) == \
        json.loads(t.tojson())


def test_late_registered_op_and_contrib_names():
    from mxnet_tpu_torch.ops.registry import register_op

    @register_op("_test_symbol_late_op")
    def _late(data, k=1.0):
        return data * k

    out = sym._test_symbol_late_op(sym.var("x"), k=3.0)
    assert out.list_arguments() == ["x"]
    assert sym.contrib.foreach is not None
    assert sym.contrib.div_sqrt_dim is sym._contrib_div_sqrt_dim
