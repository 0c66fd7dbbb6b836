"""The port's ``mx.rnn`` against the JAX package's, on the CPU.

- the symbolic cells (``RNNCell``, ``LSTMCell``, ``GRUCell``, a
  ``SequentialRNNCell`` stack with a ``DropoutCell``, ``ResidualCell``,
  ``ZoneoutCell`` at rate 0 and ``BidirectionalCell``), each unrolled
  over an embedding into a graph: the same argument names, and from the
  same numpy-seeded arguments the same outputs within 1e-5 (max abs);
- ``FusedRNNCell``, one ``RNN`` node over a flat ``<prefix>parameters``
  vector in the port, a stack of unfused cells in the JAX package: the
  same outputs once ``convert.params_from_mxnet_tpu`` packs the JAX
  package's unfused arrays into the vector; ``unfuse()`` gives the
  port's cell the JAX package's names and outputs, bidirectional too
  (which the JAX package's fused cell cannot unroll: ROADMAP, faults of
  the JAX package); ``save_rnn_checkpoint`` then ``load_rnn_checkpoint``
  is bit-equal;
- ``encode_sentences`` and ``BucketSentenceIter`` (time-major and
  batch-major, shuffled from a seed): the same vocabulary and batches;
- ``BucketingModule`` over ``BucketSentenceIter``'s buckets with an
  ``mx.rnn`` LSTM: one executor per bucket, every parameter and gradient
  one storage across the buckets, and two updates equal to the JAX
  package's within rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import sym as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym
from mxnet_tpu_torch.convert import params_from_mxnet_tpu

OUT_TOL = 1e-5
CPU = mx.cpu()
V, E, H, T, N = 12, 5, 6, 4, 3


def _graph(pkg, cell, length=T, width=H):
    S = jsym if pkg is jmx else sym
    data = S.var("data")
    emb = S.Embedding(data, input_dim=V, output_dim=E, name="embed")
    cell.reset()
    out, _ = cell.unroll(length, inputs=emb, merge_outputs=True)
    return S.FullyConnected(S.Reshape(out, shape=(-1, width)),
                            num_hidden=V, name="pred")


def _args(s, seed=0):
    shapes, _, _ = s.infer_shape(data=(N, T))
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(s.list_arguments(), shapes):
        if name == "data":
            out[name] = rs.randint(0, V, shape).astype("float32")
        else:
            out[name] = (rs.randn(*shape) * 0.3).astype("float32")
    return out


def _forward(pkg, s, args):
    ctx = jmx.cpu() if pkg is jmx else CPU
    nd = pkg.nd
    ex = s.bind(ctx, {k: nd.array(v, ctx=ctx) for k, v in args.items()})
    return ex.forward()[0].asnumpy()


CELLS = {
    "rnn": lambda R: R.RNNCell(H, prefix="rnn_"),
    "lstm": lambda R: R.LSTMCell(H, prefix="lstm_"),
    "gru": lambda R: R.GRUCell(H, prefix="gru_"),
    "sequential": lambda R: _seq(R),
    "residual": lambda R: R.ResidualCell(R.GRUCell(E, prefix="res_")),
    "zoneout": lambda R: R.ZoneoutCell(R.LSTMCell(H, prefix="zo_")),
    "bidirectional": lambda R: R.BidirectionalCell(
        R.LSTMCell(H, prefix="bl_"), R.GRUCell(H, prefix="br_")),
}


def _seq(R):
    cell = R.SequentialRNNCell()
    cell.add(R.LSTMCell(H, prefix="l0_"))
    cell.add(R.DropoutCell(0.5, prefix="d0_"))
    cell.add(R.GRUCell(H, prefix="l1_"))
    return cell


@pytest.mark.parametrize("name", sorted(CELLS))
def test_symbolic_cells_match_jax(name):
    width = {"residual": E, "bidirectional": 2 * H}.get(name, H)
    js = _graph(jmx, CELLS[name](jmx.rnn), width=width)
    ts = _graph(mx, CELLS[name](mx.rnn), width=width)
    assert sorted(ts.list_arguments()) == sorted(js.list_arguments())
    args = _args(js)
    want = _forward(jmx, js, args)
    with CPU:
        got = _forward(mx, ts, {k: v.numpy() for k, v in
                                params_from_mxnet_tpu(args, ts).items()})
    assert got.shape == want.shape == (N * T, V)
    assert float(np.max(np.abs(got - want))) <= OUT_TOL


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_fused_cell_matches_jax_and_round_trips(mode, tmp_path):
    jcell = jmx.rnn.FusedRNNCell(H, num_layers=2, mode=mode)
    tcell = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode)
    js, ts = _graph(jmx, jcell), _graph(mx, tcell)
    assert f"{mode}_parameters" in ts.list_arguments()
    args = _args(js)
    want = _forward(jmx, js, args)
    with CPU:
        targs = params_from_mxnet_tpu(args, ts, cells=[tcell])
        got = _forward(mx, ts, {k: v.numpy() for k, v in targs.items()})
        # the unfused stack: the JAX package's names, the same outputs
        us = _graph(mx, tcell.unfuse())
        assert sorted(us.list_arguments()) == sorted(js.list_arguments())
        nd_args = {k: mx.nd.array(v.numpy(), ctx=CPU)
                   for k, v in targs.items()}
        unpacked = tcell.unpack_weights(nd_args)
        assert sorted(unpacked) == sorted(args)
        got_unfused = _forward(mx, us, {k: v.asnumpy()
                                        for k, v in unpacked.items()})
        packed = tcell.pack_weights(unpacked)
        assert np.array_equal(packed[f"{mode}_parameters"].asnumpy(),
                              nd_args[f"{mode}_parameters"].asnumpy())
        prefix = str(tmp_path / "fused")
        mx.rnn.save_rnn_checkpoint(tcell, prefix, 1, ts, nd_args, {})
        _, loaded, _ = mx.rnn.load_rnn_checkpoint(tcell, prefix, 1)
    assert float(np.max(np.abs(got - want))) <= OUT_TOL
    assert float(np.max(np.abs(got_unfused - want))) <= OUT_TOL
    assert sorted(loaded) == sorted(nd_args)
    for k, v in nd_args.items():
        assert np.array_equal(loaded[k].asnumpy(), v.asnumpy())
    # both ways: the fused node against its unfused stack (the JAX
    # package's fused cell cannot unroll a bidirectional stack)
    bcell = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                bidirectional=True, prefix="bi_")
    bs = _graph(mx, bcell, width=2 * H)
    with CPU:
        bargs = {k: mx.nd.array(v, ctx=CPU) for k, v in _args(bs).items()}
        fused = _forward(mx, bs, {k: v.asnumpy() for k, v in bargs.items()})
        unfused = _forward(mx, _graph(mx, bcell.unfuse(), width=2 * H),
                           {k: v.asnumpy() for k, v in
                            bcell.unpack_weights(bargs).items()})
    assert float(np.max(np.abs(fused - unfused))) <= OUT_TOL


def _sentences(seed=0, n=90):
    rs = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(V - 1)]
    return [[words[j] for j in rs.randint(0, V - 1, rs.randint(2, 9))]
            for _ in range(n)]


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_batches_equal(layout):
    jenc, jvocab = jmx.rnn.encode_sentences(_sentences(), invalid_label=0,
                                            start_label=1)
    tenc, tvocab = mx.rnn.encode_sentences(_sentences(), invalid_label=0,
                                           start_label=1)
    assert tenc == jenc and tvocab == jvocab
    kw = dict(batch_size=N, buckets=[4, 6, 8], invalid_label=0,
              layout=layout, seed=3)
    jit, tit = (pkg.rnn.BucketSentenceIter(tenc, **kw) for pkg in (jmx, mx))
    assert tit.default_bucket_key == jit.default_bucket_key == 8
    assert tit.provide_data == jit.provide_data
    for _ in range(2):
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) > 0
        for a, b in zip(tb, jb):
            assert a.bucket_key == b.bucket_key
            assert np.array_equal(a.data[0].asnumpy(), b.data[0].asnumpy())
            assert np.array_equal(a.label[0].asnumpy(),
                                  b.label[0].asnumpy())
            assert a.provide_data == b.provide_data
        jit.reset()
        tit.reset()


def _bucketing(pkg, init):
    enc, _ = pkg.rnn.encode_sentences(_sentences(1), invalid_label=0,
                                      start_label=1)
    it = pkg.rnn.BucketSentenceIter(enc, batch_size=N, buckets=[4, 8],
                                    invalid_label=0, seed=0)
    S = jsym if pkg is jmx else sym
    cell = pkg.rnn.SequentialRNNCell()
    cell.add(pkg.rnn.LSTMCell(H, prefix="l0_"))

    def sym_gen(seq_len):
        data, label = S.var("data"), S.var("softmax_label")
        emb = S.Embedding(data, input_dim=V, output_dim=E, name="embed")
        cell.reset()
        out, _ = cell.unroll(seq_len, inputs=emb, merge_outputs=True)
        pred = S.FullyConnected(S.Reshape(out, shape=(-1, H)),
                                num_hidden=V, name="pred")
        return (S.SoftmaxOutput(pred, S.Reshape(label, shape=(-1,)),
                                name="softmax", use_ignore=True,
                                ignore_label=0),
                ("data",), ("softmax_label",))

    kw = {} if pkg is jmx else {"context": CPU}
    mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=8, **kw)
    mod.bind(it.provide_data, it.provide_label)
    ctx = jmx.cpu() if pkg is jmx else CPU
    mod.set_params({k: pkg.nd.array(v, ctx=ctx) for k, v in init.items()},
                   {})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "wd": 1e-5})
    batches = [b for b in it][:3]
    keys = {b.bucket_key for b in batches}
    assert len(keys) == 2, keys
    metric = pkg.metric.Perplexity(ignore_label=0)
    for b in batches:
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        mod.update_metric(metric, b.label)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, \
        metric.get()[1]


def test_bucketing_module_shares_storage_and_matches_jax():
    rs = np.random.RandomState(4)
    init = {"embed_weight": rs.randn(V, E), "l0_i2h_weight": rs.randn(
        4 * H, E), "l0_i2h_bias": rs.randn(4 * H), "l0_h2h_weight":
        rs.randn(4 * H, H), "l0_h2h_bias": rs.randn(4 * H),
        "pred_weight": rs.randn(V, H), "pred_bias": rs.randn(V)}
    init = {k: (v * 0.3).astype("float32") for k, v in init.items()}
    _, want, jppl = _bucketing(jmx, init)
    with CPU:
        mod, got, tppl = _bucketing(mx, init)
    assert sorted(mod._buckets) == [4, 8]
    execs = [m._exec_group.execs[0] for m in mod._buckets.values()]
    for name in init:
        assert len({id(e.arg_dict[name]) for e in execs}) == 1
        assert len({e.arg_dict[name]._data.data_ptr() for e in execs}) == 1
        assert len({id(e.grad_dict[name]) for e in execs}) == 1
    for name in init:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6)
    assert np.isfinite(tppl) and tppl == pytest.approx(jppl, rel=1e-5)


def test_bucketing_module_binds_buckets_only_after_init():
    """As upstream's, a bucket other than the default one is bound only
    once the parameters are initialized; parameters set while another
    bucket is current are every bucket's."""
    rs = np.random.RandomState(5)
    init = {"embed_weight": rs.randn(V, E), "l0_i2h_weight": rs.randn(
        4 * H, E), "l0_i2h_bias": rs.randn(4 * H), "l0_h2h_weight":
        rs.randn(4 * H, H), "l0_h2h_bias": rs.randn(4 * H),
        "pred_weight": rs.randn(V, H), "pred_bias": rs.randn(V)}
    cell = mx.rnn.LSTMCell(H, prefix="l0_")

    def sym_gen(seq_len):
        data = sym.var("data")
        emb = sym.Embedding(data, input_dim=V, output_dim=E, name="embed")
        cell.reset()
        out, _ = cell.unroll(seq_len, inputs=emb, merge_outputs=True)
        return (sym.FullyConnected(sym.Reshape(out, shape=(-1, H)),
                                   num_hidden=V, name="pred"),
                ("data",), None)

    with CPU:
        mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                     context=CPU)
        mod.bind([("data", (N, 8))], None, for_training=False)
        mod.switch_bucket(8, [("data", (N, 8))])
        with pytest.raises(AssertionError):
            mod.switch_bucket(4, [("data", (N, 4))])
        assert sorted(mod._buckets) == [8]
        mod.init_params()
        mod.switch_bucket(4, [("data", (N, 4))])
        mod.set_params({k: mx.nd.array(v.astype("float32"), ctx=CPU)
                        for k, v in init.items()}, {})
        for m in mod._buckets.values():
            args = m._exec_group.execs[0].arg_dict
            for k, v in init.items():
                np.testing.assert_array_equal(args[k].asnumpy(),
                                              v.astype("float32"))
