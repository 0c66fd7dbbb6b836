"""Checkpoint and resume: MXNet's ``.params`` format across the two
packages, ``save_parameters``/``load_parameters`` on a narrow BERT, and a
resumed training run against an uninterrupted one.

Every comparison here is bit for bit: a file stores the bytes of each
tensor, and a resumed run from the same weights, optimizer states,
batches and dropout generators computes the same operations as the run
it resumes.
"""
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jax_tf
from mxnet_tpu_torch import MXNetError, amp, autograd
from mxnet_tpu_torch.convert import mxnet_tpu_shapes
from mxnet_tpu_torch.ndarray import serialization
from mxnet_tpu_torch.gluon import Trainer, collect_params
from mxnet_tpu_torch.gluon import loss as torch_loss
from mxnet_tpu_torch.gluon.nn import Dropout
from mxnet_tpu_torch.models import BERTModel

from test_torch_resnet_train import keep_zeros

V, C, L, H, FFN, T, B = 50, 32, 2, 4, 64, 16, 2


def _arrays(wide=False):
    """Arrays of every dtype the JAX package holds (without x64 it holds
    no 64-bit type; ``wide`` adds those for its format-level reader)."""
    rng = np.random.RandomState(0)
    out = {
        "w16": rng.randn(3, 5).astype("float16"),
        "w32": rng.randn(7).astype("float32"),
        "i32": rng.randint(-9, 9, (4, 1)).astype("int32"),
        "i8": rng.randint(-9, 9, 5).astype("int8"),
        "u8": rng.randint(0, 255, 6).astype("uint8"),
        "scalar": np.array(2.5, "float32"),
        "layers.0.attn.qkv.weight": rng.randn(2, 3, 4).astype("float32")}
    if wide:
        out.update(w64=rng.randn(2, 2).astype("float64"),
                   i64=rng.randint(-9, 9, 3).astype("int64"))
    return out


def test_64_bit_types_cross_at_the_format_level(tmp_path):
    """float64 and int64 through the JAX package's own reader and writer
    of the format (its arrays would truncate them without x64)."""
    from mxnet_tpu.ndarray import serialization as jax_ser
    arrays = _arrays(wide=True)
    path = str(tmp_path / "wide.params")
    serialization.save(path, {k: torch.from_numpy(v) for k, v in arrays.items()})
    with open(path, "rb") as f:
        entries, names = jax_ser.load_buffer(f.read())
    for name, (_, shape, dt, data, _) in zip(names, entries):
        assert dt == arrays[name].dtype and tuple(shape) == \
            arrays[name].shape
        assert data.tobytes() == arrays[name].tobytes()
    buf = jax_ser.save_bytes(
        [types.SimpleNamespace(stype="default", ndim=v.ndim, shape=v.shape,
                               asnumpy=lambda v=v: v)
         for v in arrays.values()], list(arrays))
    back = serialization.load_frombuffer(buf, device="cpu")
    for name, v in arrays.items():
        assert back[name].numpy().tobytes() == v.tobytes()
        assert str(back[name].dtype) == f"torch.{v.dtype}"


@pytest.mark.parametrize("named", [True, False])
def test_port_file_loads_in_jax_bit_for_bit(tmp_path, named):
    arrays = _arrays()
    path = str(tmp_path / "port.params")
    data = {k: torch.from_numpy(v) for k, v in arrays.items()}
    serialization.save(path, data if named else list(data.values()))
    loaded = mx.nd.load(path)
    if named:
        assert sorted(loaded) == sorted(arrays)
        pairs = [(loaded[k], arrays[k]) for k in arrays]
    else:
        pairs = list(zip(loaded, arrays.values()))
    for got, want in pairs:
        got = got.asnumpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("named", [True, False])
def test_jax_file_loads_in_the_port_bit_for_bit(tmp_path, named):
    arrays = _arrays()
    path = str(tmp_path / "jax.params")
    data = {k: mx.nd.array(v, dtype=str(v.dtype)) for k, v in arrays.items()}
    mx.nd.save(path, data if named else list(data.values()))
    loaded = serialization.load(path, device="cpu")
    if named:
        assert sorted(loaded) == sorted(arrays)
        pairs = [(loaded[k], arrays[k]) for k in arrays]
    else:
        pairs = list(zip(loaded, arrays.values()))
    for got, want in pairs:
        assert str(got.dtype) == f"torch.{want.dtype}"
        assert tuple(got.shape) == want.shape
        assert got.numpy().tobytes() == want.tobytes()


def test_bfloat16_and_refusals(tmp_path):
    path = str(tmp_path / "bf16.params")
    t = torch.randn(9).bfloat16()
    serialization.save(path, {"b": t})
    assert torch.equal(serialization.load(path, device="cpu")["b"], t)
    assert mx.nd.load(path)["b"].asnumpy().tobytes() == \
        t.view(torch.int16).numpy().tobytes()
    # a torch sparse tensor is neither a dense tensor nor a sparse NDArray
    # (row_sparse and csr NDArrays are saved since the sparse slice)
    with pytest.raises(MXNetError, match="sparse NDArray"):
        serialization.save(path, [torch.zeros(3, 3).to_sparse()])
    with pytest.raises(MXNetError, match="format"):
        serialization.load_frombuffer(b"\0" * 16, device="cpu")


def _jax_bert():
    net = jax_tf.BERTModel(vocab_size=V, units=C, num_layers=L, num_heads=H,
                           hidden_size=FFN, max_len=32, dropout=0.0)
    net.initialize(keep_zeros)   # every value is set below
    # the deferred dims from the port's model of the same configuration,
    # as test_torch_train.py takes them: an eager JAX forward would
    # compile every op of the net to learn them
    shapes = mxnet_tpu_shapes(_port_bert())
    rng = np.random.RandomState(3)
    params = net._collect_params_with_prefix()
    for n, p in params.items():
        p.shape = shapes[n]
        p._finish_deferred_init()
    for p in params.values():
        p.set_data(mx.nd.array(rng.randn(*p.shape).astype("float32") * 0.1))
    return net, params


def _port_bert(dtype=torch.float32, dropout=0.0):
    torch.manual_seed(5)
    return BERTModel(vocab_size=V, units=C, num_layers=L, num_heads=H,
                     hidden_size=FFN, max_len=32, dropout=dropout,
                     device="cpu", dtype=dtype)


def test_save_and_load_parameters_across_packages(tmp_path):
    """A narrow BERT's parameters, saved by one package, load in the
    other under the same names, bit for bit, both ways."""
    jnet, jparams = _jax_bert()
    path = str(tmp_path / "jax_bert.params")
    jnet.save_parameters(path)
    model = _port_bert()
    model.load_parameters(path)
    params = collect_params(model)
    assert sorted(params) == sorted(jparams)
    for n, p in params.items():
        assert p.detach().numpy().tobytes() == \
            jparams[n].data().asnumpy().tobytes(), n
    # and back: perturb the port's, save, load into the JAX model
    with torch.no_grad():
        for p in params.values():
            p.mul_(-0.5)
    path2 = str(tmp_path / "port_bert.params")
    model.save_parameters(path2)
    jnet.load_parameters(path2)
    for n, p in params.items():
        assert p.detach().numpy().tobytes() == \
            jparams[n].data().asnumpy().tobytes(), n


def test_load_parameters_options(tmp_path):
    model = _port_bert()
    path = str(tmp_path / "m.params")
    model.save_parameters(path)
    names = list(collect_params(model))
    data = serialization.load(path, device="cpu")
    partial = str(tmp_path / "partial.params")
    serialization.save(partial, {k: v for k, v in data.items() if k != names[0]})
    with pytest.raises(MXNetError, match="missing"):
        _port_bert().load_parameters(partial)
    _port_bert().load_parameters(partial, allow_missing=True)
    extra = str(tmp_path / "extra.params")
    serialization.save(extra, dict(data, unknown=torch.zeros(2)))
    with pytest.raises(MXNetError, match="not present"):
        _port_bert().load_parameters(extra)
    _port_bert().load_parameters(extra, ignore_extra=True)
    # fp32 values into an fp16 model: cast to the model's dtype, unless
    # the file's dtype is asked for
    m16 = _port_bert(torch.float16)
    m16.load_parameters(path)
    p16 = collect_params(m16)
    assert all(p.dtype == torch.float16 for p in p16.values())
    assert torch.equal(p16[names[1]], data[names[1]].half())
    m16.load_parameters(path, cast_dtype=True, dtype_source="saved")
    assert all(p.dtype == torch.float32
               for p in collect_params(m16).values())


def _batches():
    rng = np.random.RandomState(7)
    return [(torch.from_numpy(rng.randint(0, V, (B, T))),
             torch.from_numpy(rng.randint(0, V, (B, T)).astype("float32")))
            for _ in range(4)]


def _adamw_trainer(model):
    trainer = Trainer(collect_params(model), "adamw", {
        "learning_rate": 1e-3, "beta1": 0.9, "beta2": 0.999,
        "epsilon": 1e-6, "wd": 0.01, "multi_precision": True})
    amp.init_trainer(trainer)
    return trainer


def _train(model, trainer, batches, updates):
    """Steps over ``batches`` (in turn) until ``updates`` were applied,
    each skipped where a gradient overflowed."""
    loss_fn = torch_loss.SoftmaxCrossEntropyLoss()
    scaler = trainer._amp_loss_scaler
    params = collect_params(model)
    applied = attempt = 0
    while applied < updates:
        tok, lab = batches[attempt % len(batches)]
        attempt += 1
        with autograd.record():
            loss = loss_fn(model(tok).reshape(-1, V), lab.reshape(-1))
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        autograd.backward(scaled)
        overflow = scaler.has_overflow(params.values())
        scaler.update_scale(overflow)
        if not overflow:
            trainer.step(B * T)
            applied += 1
    return attempt - updates


def _drops(model):
    return [m for m in model.modules() if isinstance(m, Dropout)]


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """fp16 BERT with dropout 0.1, AdamW (multi-precision) under dynamic
    loss scaling from 2**16 (several first steps overflow and are
    skipped): two updates, ``save_parameters`` + ``save_states``, a fresh
    model and trainer loaded from them, two more updates; weights, fp32
    masters, AdamW's states and the update counts equal the run that made
    four updates without stopping. What neither file holds, as in the
    reference, is carried by hand: the dropout generators' states and the
    loss scaler's."""
    batches = _batches()
    model = _port_bert(torch.float16, dropout=0.1)
    for i, d in enumerate(_drops(model)):
        d.manual_seed(100 + i)
    trainer = _adamw_trainer(model)
    skipped = _train(model, trainer, batches[:2], 2)
    assert skipped > 0
    pfile, sfile = str(tmp_path / "ck.params"), str(tmp_path / "ck.states")
    model.save_parameters(pfile)
    trainer.save_states(sfile)
    gen_states = [d._gen.get_state() for d in _drops(model)]
    scaler = dict(vars(trainer._amp_loss_scaler))
    _train(model, trainer, batches[2:], 2)

    fresh = _port_bert(torch.float16, dropout=0.1)
    fresh.load_parameters(pfile)
    for d, st in zip(_drops(fresh), gen_states):
        d._gen.set_state(st)
    resumed = _adamw_trainer(fresh)
    resumed.load_states(sfile)
    vars(resumed._amp_loss_scaler).update(scaler)
    assert os.path.getsize(pfile) > 0
    _train(fresh, resumed, batches[2:], 2)

    a, b = collect_params(model), collect_params(fresh)
    saved = serialization.load(pfile, device="cpu")
    assert any(not torch.equal(a[n], saved[n]) for n in a)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    sa, sb = trainer._updaters[0].states, resumed._updaters[0].states
    assert sorted(sa) == sorted(sb)
    for i in sa:
        (w32a, (ma, va)), (w32b, (mb, vb)) = sa[i], sb[i]
        assert torch.equal(w32a, w32b) and torch.equal(ma, mb) \
            and torch.equal(va, vb)
    assert resumed.optimizer._index_update_count == \
        trainer.optimizer._index_update_count
    assert isinstance(resumed.optimizer, type(trainer.optimizer))
