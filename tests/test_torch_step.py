"""The port's fused training step (``mxnet_tpu_torch.step``) on the CPU.

On the CPU the step runs eagerly, under the cache keys, miss counting and
write-back that its CUDA graphs run under on the card
(``tests/test_torch_cuda.py`` holds the captured step). Held here:

- the fused step against the port's own eager ``record`` -> ``backward``
  -> ``Trainer.step`` loop, bit for bit, over 3 steps with dropout on, for
  the six optimizer cases of ``tests/test_step.py`` (a 2-layer, 64-unit
  BERT; an MLP with BatchNorm, whose running statistics are held too);
- the fused step against the JAX package's ``StepFunction`` on the same
  weights (carried by ``convert.params_from_mxnet_tpu``) and batch,
  dropout 0, within ``JAX_REL_TOL`` per parameter (derived below);
- the cache contract: no miss after step 2, none for an lr or schedule
  change, one recorded ``fused_step`` miss for a ``fused_signature``
  change, a cast, a ``grad_req`` flip and new parameter storage;
- the refusals, with the JAX package's error class; ``GradientBuckets``
  and ``OptimizerFusionAudit`` against the JAX package's;
  ``engine.eager_sync``'s flags and the op dispatch's wait under them;
  ``Trainer.save_states`` after fused steps
  byte-equal to the file written after eager steps.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jax_gluon
from mxnet_tpu.models import transformer as jax_tf
from mxnet_tpu.step import GradientBuckets as JaxBuckets
from mxnet_tpu.step import StepFunction as JaxStepFunction
from mxnet_tpu_torch import MXNetError, autograd, config, engine, nd
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.convert import (mxnet_tpu_shapes, params_from_mxnet_tpu,
                                     params_to_mxnet_tpu)
from mxnet_tpu_torch.gluon import Trainer, collect_params
from mxnet_tpu_torch.gluon import loss as torch_loss
from mxnet_tpu_torch.gluon.nn import BatchNorm, Dense, Dropout, HybridSequential
from mxnet_tpu_torch.models import BERTModel
from mxnet_tpu_torch.step import GradientBuckets, StepFunction
from mxnet_tpu_torch.telemetry import recompile

from test_torch_resnet_train import keep_zeros

V, C, L, H, FFN, T, B = 100, 64, 2, 4, 128, 16, 2
STEPS = 3
# the six optimizer cases of tests/test_step.py
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.05}),
    ("adam", {"learning_rate": 0.01, "wd": 0.001}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
]
# Port against JAX after 3 fp32 SGD-momentum steps from the same weights
# and batch: both compute the same function in fp32, XLA:CPU and ATen
# summing in other orders. A gradient's relative rounding difference is
# a few fp32 ulps times sqrt(terms): ~1e-6 for sums of ~100 products. Each
# step moves a weight by lr * |m| ~ 1e-3 of its ~0.05 scale, so after 3
# steps (the momentum carrying the first steps' differences forward) the
# weights differ by ~3 x 1e-6 x 1e-3 relative: ~1e-8 expected,
# 1e-5 leaves a thousandfold margin and still rejects a skipped or doubled
# update (whose distance is the update itself, ~1e-2 of the weight).
JAX_REL_TOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The narrow models here gain nothing from torch's intra-op threads,
    and under several test workers those threads oversubscribe the
    cores; the count is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (B, T)).astype("int64"),
            rng.randint(0, V, (B, T)).astype("int64"))


def _bert(dropout=0.1):
    torch.manual_seed(0)
    model = BERTModel(vocab_size=V, units=C, num_layers=L, num_heads=H,
                      hidden_size=FFN, max_len=T, dropout=dropout,
                      device="cpu")
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for i, d in enumerate(drops):
        d.manual_seed(i)
    return model


def _bn_mlp():
    torch.manual_seed(0)
    net = HybridSequential(Dense(32, activation="relu", in_units=10, device="cpu"),
                           BatchNorm(in_channels=32, device="cpu"),
                           Dropout(0.2, device="cpu"),
                           Dense(4, in_units=32, device="cpu"))
    for i, d in enumerate(m for m in net.modules() if isinstance(m, Dropout)):
        d.manual_seed(100 + i)
    return net


def _mlp_batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (8, 10)).astype("float32"),
            rng.uniform(-1, 1, (8, 4)).astype("float32"))


MODELS = {
    "bert": (_bert, _batch, torch_loss.SoftmaxCrossEntropyLoss),
    "bn_mlp": (_bn_mlp, _mlp_batch, torch_loss.L2Loss),
}


def _run(which, opt, kwargs, fused, steps=STEPS, on_step=None):
    build, batch, loss_cls = MODELS[which]
    model = build()
    trainer = Trainer(collect_params(model), opt, dict(kwargs))
    loss_fn = loss_cls()
    x, y = (torch.from_numpy(a) for a in batch())
    step = trainer.fuse_step(model, loss_fn) if fused else None
    losses = []
    for i in range(steps):
        if fused:
            loss = step.step(x, y)
        else:
            with autograd.record():
                loss = loss_fn(model(x), y)
            autograd.backward(loss)
            trainer.step(x.shape[0])
        losses.append(loss.detach().clone())
        if on_step is not None:
            on_step(i, model, trainer, step)
    return model, trainer, losses, step


def _states(trainer):
    out = []
    for i in sorted(trainer._updaters[0].states):
        s = trainer._updaters[0].states[i]
        out.extend(s if isinstance(s, (tuple, list)) else [s])
    return [t for t in out if t is not None]


@pytest.mark.parametrize("which", ["bert", "bn_mlp"])
@pytest.mark.parametrize("opt,kwargs", OPTIMIZERS)
def test_fused_step_is_bit_equal_to_the_eager_loop(which, opt, kwargs):
    ma, ta, la, _ = _run(which, opt, kwargs, fused=False)
    mb, tb, lb, fused = _run(which, opt, kwargs, fused=True)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    pa, pb = collect_params(ma), collect_params(mb)
    assert list(pa) == list(pb)
    for n in pa:   # BatchNorm's running statistics among them
        assert torch.equal(pa[n], pb[n]), n
    sa, sb = _states(ta), _states(tb)
    assert len(sa) == len(sb) and (len(sa) > 0) == (
        opt != "sgd" or "momentum" in kwargs)
    for a, b in zip(sa, sb):
        assert torch.equal(a, b)
    assert ta._optimizer._index_update_count == \
        tb._optimizer._index_update_count
    assert fused.cache_info()["programs"] == 1


def test_device_scalars_are_bit_equal_to_python_floats():
    """``fused_apply`` takes lr/wd (and Adam's corrected lr) as Python
    floats or as 0-d tensors of the weight's dtype, with the same bits."""
    from mxnet_tpu_torch import optimizer as opt_mod
    rng = np.random.RandomState(3)
    w, g = (torch.from_numpy(rng.randn(5, 7).astype("float32"))
            for _ in range(2))
    for name, kw in OPTIMIZERS:
        opt = opt_mod.create(name, **kw)
        state = opt.create_state(0, w)
        lr, wd = opt.fused_hyper(0)
        a = opt.fused_apply([0], [w], [g], [state], [lr], [wd])
        b = opt.fused_apply([0], [w], [g], [state],
                            [torch.tensor(lr, dtype=torch.float32)],
                            [torch.tensor(wd, dtype=torch.float32)])
        assert torch.equal(a[0][0], b[0][0]), name
        for x, y in zip(_flat(a[1]), _flat(b[1])):
            assert torch.equal(x, y), name


def _flat(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [t for s in tree for t in _flat(s)]
    return [tree]


# -- against the JAX package's StepFunction ------------------------------------

def _jax_bert(named):
    net = jax_tf.BERTModel(vocab_size=V, units=C, num_layers=L, num_heads=H,
                           hidden_size=FFN, max_len=T, dropout=0.0)
    net.initialize(keep_zeros)
    params = net._collect_params_with_prefix()
    shapes = mxnet_tpu_shapes(BERTModel(
        vocab_size=V, units=C, num_layers=L, num_heads=H, hidden_size=FFN,
        max_len=T, dropout=0.0, device="cpu"))
    for n, p in params.items():
        p.shape = shapes[n]
        p._finish_deferred_init()
        p.set_data(mx.nd.array(named[n]))
    return net, params


def test_fused_step_agrees_with_the_jax_step_function():
    rng = np.random.RandomState(1)
    port = _bert(dropout=0.0)
    named = {n: (rng.randn(*a.shape) * 0.05).astype("float32")
             + (1.0 if n.endswith("gamma") else 0.0)
             for n, a in sorted(params_to_mxnet_tpu(port).items())}
    port.load_state_dict(params_from_mxnet_tpu(named, port))
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    tokens, labels = _batch()

    net, jparams = _jax_bert(named)
    jtrainer = jax_gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    jfused = jtrainer.fuse_step(net, jax_gluon.loss.SoftmaxCrossEntropyLoss())
    assert isinstance(jfused, JaxStepFunction)
    x = mx.nd.array(tokens.astype("int32"), dtype="int32")
    y = mx.nd.array(labels.astype("float32"))
    jlosses = [jfused.step(x, y).asnumpy() for _ in range(STEPS)]

    trainer = Trainer(collect_params(port), "sgd", dict(opt))
    fused = trainer.fuse_step(port, torch_loss.SoftmaxCrossEntropyLoss())
    tx, ty = torch.from_numpy(tokens), torch.from_numpy(labels)
    losses = [fused.step(tx, ty).numpy() for _ in range(STEPS)]
    for got, want in zip(losses, jlosses):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    got = params_to_mxnet_tpu(port)
    moved = 0.0
    for n, p in jparams.items():
        want = p.data().asnumpy()
        rel = np.linalg.norm(got[n] - want) / np.linalg.norm(want)
        assert rel <= JAX_REL_TOL, (n, rel)
        moved = max(moved, np.linalg.norm(want - named[n])
                    / np.linalg.norm(want))
    assert moved > 100 * JAX_REL_TOL   # the steps moved the weights


# -- the cache contract ----------------------------------------------------------

def _counter(name):
    from mxnet_tpu_torch.telemetry import metrics
    return metrics.counter(name).value()


def _fused_records(name):
    return [r for r in recompile.recompile_report()
            if r["entry"] == f"StepFunction:{name}"]


def test_no_miss_after_step_two_nor_for_an_lr_change():
    model = _bn_mlp()
    trainer = Trainer(collect_params(model), "sgd",
                      {"learning_rate": 0.05, "momentum": 0.9})
    fused = trainer.fuse_step(model, torch_loss.L2Loss(), name="steady")
    x, y = (torch.from_numpy(a) for a in _mlp_batch())
    fused.step(x, y)
    fused.step(x, y)
    misses = _counter("fused_step_cache_misses_total")
    hits = _counter("fused_step_cache_hits_total")
    fused.step(x, y)
    trainer.set_learning_rate(0.01)
    fused.step(x, y)
    assert _counter("fused_step_cache_misses_total") == misses
    assert _counter("fused_step_cache_hits_total") == hits + 2
    assert fused.cache_info()["programs"] == 1
    # a new batch shape is one new program, recorded as a shape change
    x2, y2 = (torch.from_numpy(a[:4]) for a in _mlp_batch())
    fused.step(x2, y2)
    fused.step(x2, y2)
    assert _counter("fused_step_cache_misses_total") == misses + 1
    recs = _fused_records("steady")
    assert [r["reason"] for r in recs] == ["first-compile", "shape-change"]
    assert all(r["kind"] == "fused_step" for r in recs)


def test_an_lr_schedule_never_rekeys_and_matches_eager():
    from mxnet_tpu_torch.lr_scheduler import FactorScheduler

    def opt():
        return {"learning_rate": 0.05, "momentum": 0.9,
                "lr_scheduler": FactorScheduler(step=1, factor=0.5)}

    def lr_change(i, model, trainer, step):
        if i == 1:
            trainer._optimizer.momentum = 0.5  # a fused_signature change

    a = _run("bn_mlp", "sgd", opt(), False, steps=4, on_step=lr_change)
    misses = _counter("fused_step_cache_misses_total")
    b = _run("bn_mlp", "sgd", opt(), True, steps=4, on_step=lr_change)
    # the first capture and the momentum change; the schedule adds none
    assert _counter("fused_step_cache_misses_total") == misses + 2
    for pa, pb in zip(a[0].parameters(), b[0].parameters()):
        assert torch.equal(pa, pb)
    reasons = [r["reason"] for r in _fused_records(b[3]._name)][-1:]
    assert reasons == ["key-change"]


def test_cast_and_new_storage_rekey():
    model = _bn_mlp()
    trainer = Trainer(collect_params(model), "sgd", {"learning_rate": 0.05})
    fused = trainer.fuse_step(model, torch_loss.L2Loss(), name="storage")
    x, y = (torch.from_numpy(a) for a in _mlp_batch())
    fused.step(x, y)
    fused.step(x, y)
    misses = _counter("fused_step_cache_misses_total")
    # load_parameters-style rebinding of one parameter's storage
    w = model[0].weight
    w.data = w.data.clone()
    fused.step(x, y)
    assert _counter("fused_step_cache_misses_total") == misses + 1
    # a cast: new dtype and new storage
    model.cast("float64")
    fused.step(x.double(), y.double())
    assert _counter("fused_step_cache_misses_total") == misses + 2
    assert model[0].weight.dtype == torch.float64
    reasons = [r["reason"] for r in _fused_records("storage")]
    assert reasons == ["first-compile", "key-change", "dtype-change"]


def test_load_states_rekeys_and_save_states_sees_the_update(tmp_path):
    """The file ``save_states`` writes after fused steps holds what the
    eager loop's holds, bit for bit. (Its bytes differ between any two
    runs, eager ones too: the port's pickle names each tensor storage by
    its address, so the loaded contents are compared.)"""
    def save_after(fused):
        out = tmp_path / f"{'fused' if fused else 'eager'}.states"
        _, trainer, _, _ = _run("bert", "adam", OPTIMIZERS[2][1], fused)
        trainer.save_states(str(out))
        return pickle.loads(out.read_bytes())

    (eager_states, eager_opt), (states, opt) = save_after(False), \
        save_after(True)
    assert list(states) == list(eager_states)
    for i in states:
        for a, b in zip(_flat(states[i]), _flat(eager_states[i])):
            assert torch.equal(a, b), i
    assert {k: repr(v) for k, v in vars(opt).items()} == \
        {k: repr(v) for k, v in vars(eager_opt).items()}

    model = _bn_mlp()
    trainer = Trainer(collect_params(model), "adam", {"learning_rate": 0.01})
    fused = trainer.fuse_step(model, torch_loss.L2Loss(), name="states")
    x, y = (torch.from_numpy(a) for a in _mlp_batch())
    fused.step(x, y)
    path = tmp_path / "mlp.states"
    trainer.save_states(str(path))
    misses = _counter("fused_step_cache_misses_total")
    trainer.load_states(str(path))
    fused.step(x, y)
    assert _counter("fused_step_cache_misses_total") == misses + 1


def test_grad_req_flip_rederives_the_trainable_set():
    model = _bn_mlp()
    trainer = Trainer(collect_params(model), "sgd", {"learning_rate": 0.05})
    fused = trainer.fuse_step(model, torch_loss.L2Loss(), name="freeze")
    x, y = (torch.from_numpy(a) for a in _mlp_batch())
    fused.step(x, y)
    frozen = model[0].weight
    before = frozen.detach().clone()
    misses = _counter("fused_step_cache_misses_total")
    frozen.requires_grad_(False)   # grad_req "null"
    fused.step(x, y)
    assert torch.equal(frozen, before)
    assert "0.weight" not in fused._trainable
    frozen.requires_grad_(True)
    fused.step(x, y)
    assert not torch.equal(frozen, before)
    assert _counter("fused_step_cache_misses_total") == misses + 2


def test_grad_req_add_warns():
    model = _bn_mlp()
    model[3].bias.grad_req = "add"
    fused = StepFunction(model, torch_loss.L2Loss(), optimizer="sgd")
    x, y = (torch.from_numpy(a) for a in _mlp_batch())
    with pytest.warns(UserWarning, match="grad_req='add'"):
        fused.step(x, y)


# -- refusals ------------------------------------------------------------------

def _jax_net():
    from mxnet_tpu.gluon import nn as jnn
    net = jnn.HybridSequential()
    with net.name_scope():
        net.add(jnn.Dense(4, in_units=10, flatten=False))
    net.initialize(keep_zeros)   # never stepped: no values drawn
    return net


def _port_net():
    torch.manual_seed(0)
    return HybridSequential(Dense(4, flatten=False, in_units=10, device="cpu"))


def _refusals(pkg_net, Step, TrainerCls, loss_cls, kv):
    """Each refusal of the step's construction, as (case, error)."""
    out = {}

    def attempt(case, fn):
        try:
            fn()
        except Exception as e:  # the class is what is compared
            out[case] = e
        else:
            out[case] = None

    net = pkg_net()
    attempt("no_fused_apply",
            lambda: Step(net, loss_cls(), optimizer="adagrad"))
    attempt("multi_precision", lambda: Step(
        net, loss_cls(), optimizer="sgd",
        optimizer_params={"multi_precision": True}))
    tr = TrainerCls(net.collect_params(), "sgd", {"learning_rate": 0.1})
    attempt("trainer_and_optimizer", lambda: Step(
        net, loss_cls(), trainer=tr, optimizer="adam"))
    # the JAX package refuses at the step, the port at the Trainer
    attempt("update_on_kvstore", lambda: Step(net, loss_cls(), trainer=(
        TrainerCls(net.collect_params(), "sgd", {"learning_rate": 0.1},
                   **kv))))
    return out


def test_refusals_raise_the_jax_package_s_error_class():
    jax_errs = _refusals(_jax_net, JaxStepFunction, jax_gluon.Trainer,
                         jax_gluon.loss.L2Loss,
                         {"kvstore": mx.kv.create("local"),
                          "update_on_kvstore": True})
    port_errs = _refusals(_port_net, StepFunction, Trainer,
                          torch_loss.L2Loss, {"update_on_kvstore": True})
    assert sorted(jax_errs) == sorted(port_errs)
    for case in jax_errs:
        assert jax_errs[case] is not None and port_errs[case] is not None, \
            case
        assert type(jax_errs[case]).__name__ == "MXNetError"
        assert isinstance(port_errs[case], MXNetError), case
    assert "fused_apply" in str(port_errs["no_fused_apply"])
    assert "update_on_kvstore" in str(port_errs["update_on_kvstore"])


def test_other_refusals():
    net = _port_net()
    # a distributed or elastic kvstore never reaches the step: the
    # Trainer refuses it, naming the distribution slice
    for kv in ("dist_sync", "dist_elastic"):
        with pytest.raises(NotImplementedError, match="item 6"):
            Trainer(collect_params(net), "sgd", {"learning_rate": 0.1},
                    kvstore=kv)
    tr = Trainer(collect_params(net), "sgd", {"learning_rate": 0.1},
                 update_on_kvstore=False)
    with pytest.raises(MXNetError, match="item 6"):
        tr.fuse_step(net, torch_loss.L2Loss(), shard_plan=object())
    # weight tying: one parameter under two names
    shared = HybridSequential(Dense(10, in_units=10, device="cpu"),
                              Dense(10, in_units=10, device="cpu"))
    shared[1].weight = shared[0].weight
    fused = StepFunction(shared, torch_loss.L2Loss(), optimizer="sgd")
    with pytest.raises(MXNetError, match="shared"):
        fused.step(torch.zeros(2, 10), torch.zeros(2, 10))
    fused = StepFunction(net, torch_loss.L2Loss(), optimizer="sgd")
    for call, item in ((lambda: fused.attach_recorder(None), 7),
                       (lambda: fused.guard_probe, 7),
                       (lambda: fused.set_monitor_callback(print), 8),
                       (lambda: fused.cost_analysis(None), 8)):
        with pytest.raises(MXNetError, match=f"item {item}"):
            call()


# -- buckets, steplint, engine ---------------------------------------------------

def test_gradient_buckets_match_the_jax_package():
    items = [(0, (3, 4), "float32", 48), (1, (100,), "float32", 400),
             (2, (2,), "bfloat16", 4), (3, (10, 10), "float32", 400),
             (4, (1000,), "float32", 4000), (5, (7,), "bfloat16", 14),
             (6, (1,), "float32", 4)]
    for cap in (0, 450, 1000, 5000):
        jb, tb = JaxBuckets(items, cap_bytes=cap), \
            GradientBuckets(items, cap_bytes=cap)
        assert jb.layout_key() == tb.layout_key(), cap
    config.set_flag("MXNET_GRAD_BUCKET_BYTES", 450)
    try:
        assert GradientBuckets(items).layout_key() == \
            JaxBuckets(items, cap_bytes=450).layout_key()
    finally:
        config.unset_flag("MXNET_GRAD_BUCKET_BYTES")
    tb = GradientBuckets(items, cap_bytes=450)
    grads = {i: torch.arange(int(np.prod(s)), dtype=torch.float32
                             if d == "float32" else torch.bfloat16
                             ).reshape(s) * (i + 1)
             for i, s, d, _ in items}
    for b in tb.buckets:
        back = tb.unflatten(b, tb.flatten(b, grads))
        for i, seg in back.items():
            assert torch.equal(seg, grads[i])


def test_steplint_findings_match_the_jax_package():
    from mxnet_tpu.optimizer import Optimizer as JaxOptimizer
    from mxnet_tpu.passes.steplint import OptimizerFusionAudit as JaxAudit
    from mxnet_tpu_torch.optimizer import Optimizer
    from mxnet_tpu_torch.passes.steplint import OptimizerFusionAudit

    def classes(base):
        class NoFused(base):
            def update(self, index, weight, grad, state):
                pass

        class Fused(base):
            def update(self, index, weight, grad, state):
                pass

            def fused_apply(self, indices, weights, grads, states, lrs,
                            wds):
                return list(weights), list(states)
        return {"nofused": NoFused, "fusedok": Fused}

    def rows(findings):
        return sorted((f.check, f.obj, f.severity) for f in findings)

    assert rows(OptimizerFusionAudit().run(classes(Optimizer))) == \
        rows(JaxAudit().run(classes(JaxOptimizer))) == \
        [("no-fused-apply", "NoFused", "warn")]
    builtin = rows(OptimizerFusionAudit().run())
    assert builtin == rows(JaxAudit().run())
    assert all(sev == "info" for _, _, sev in builtin)


def test_eager_sync_follows_its_flag(monkeypatch):
    """The flags, and the op dispatch's wait after every op under them
    (the wait itself, ``torch.cuda.synchronize``, counted: this host has
    no device to wait for)."""
    waits = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: waits.append(1))
    x = nd.ones((2, 3), ctx=cpu())

    def ops():
        waits.clear()
        nd.relu(x * 2 + 1)
        return len(waits)

    assert not engine.eager_sync() and ops() == 0
    config.set_flag("MXNET_EAGER_SYNC", True)
    try:
        assert engine.eager_sync() and ops() == 3
    finally:
        config.unset_flag("MXNET_EAGER_SYNC")
    assert not engine.eager_sync() and ops() == 0
    engine.set_engine_type("NaiveEngine")
    try:
        assert engine.is_sync() and engine.eager_sync() and ops() == 3
    finally:
        engine.set_engine_type("ThreadedEnginePerDevice")
    assert not engine.is_sync() and ops() == 0
    with engine.bulk(30):
        assert engine.set_bulk_size(30) == 30
    engine.wait_for_all()
