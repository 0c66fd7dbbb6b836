"""The port's fused step in symbol mode on the CPU.

A narrow symbol graph (FullyConnected -> BatchNorm -> relu -> Dropout ->
FullyConnected, the squared error per sample, as ``tests/test_step.py::
test_symbol_mode_trains`` builds, with a BatchNorm added for its aux
states) stepped by ``StepFunction(sym, arg_dict=..., aux_dict=...)``:

- against the JAX package's symbol-mode ``StepFunction`` from the same
  numpy-seeded arrays, dropout 0, over 3 steps: per-sample losses, every
  argument and the BatchNorm moving statistics within ``REL_TOL``
  relative L2 (fp32, the same function summed in other orders by XLA:CPU
  and ATen: a few ulps of ~1e-7 relative per step, carried 3 steps; 1e-5
  leaves a hundredfold margin and still rejects a missed or doubled
  update, which moves a weight by ~1e-2 of itself here);
- against the port's own ``Executor.forward`` / ``backward`` and the
  list-form ``Updater`` with the same optimizer, dropout 0.3 drawn from
  the same generator state, bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import sym as jsym
from mxnet_tpu.step import StepFunction as JaxStepFunction
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as opt_mod
from mxnet_tpu_torch import sym as tsym
from mxnet_tpu_torch.step import StepFunction

N, FEAT, HIDDEN, STEPS = 8, 10, 16, 3
REL_TOL = 1e-5
OPTIMIZERS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
              ("adam", {"learning_rate": 0.01})]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The narrow models here gain nothing from torch's intra-op threads,
    and under several test workers those threads oversubscribe the
    cores; the count is put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _graph(S, p):
    data, label = S.Variable("data"), S.Variable("label")
    # no bias before the BatchNorm (its exact gradient would be zero, and
    # Adam would move it by rounding noise); gamma trained
    h = S.FullyConnected(data, num_hidden=HIDDEN, no_bias=True, name="fc1")
    h = S.BatchNorm(h, fix_gamma=False, name="bn")
    h = S.Activation(h, act_type="relu", name="relu")
    h = S.Dropout(h, p=p, name="drop")
    out = S.FullyConnected(h, num_hidden=1, name="fc2")
    return S.sum(S.square(out - label), axis=1) / 2.0


def _values():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (N, FEAT)).astype("float32")
    y = rng.uniform(-1, 1, (N, 1)).astype("float32")
    args = {"fc1_weight": rng.randn(HIDDEN, FEAT) * 0.3,
            "bn_gamma": 1.0 + rng.randn(HIDDEN) * 0.1,
            "bn_beta": rng.randn(HIDDEN) * 0.1,
            "fc2_weight": rng.randn(1, HIDDEN) * 0.3,
            "fc2_bias": np.zeros(1)}
    auxs = {"bn_moving_mean": np.zeros(HIDDEN),
            "bn_moving_var": np.ones(HIDDEN)}
    cast = lambda d: {k: v.astype("float32") for k, v in d.items()}  # noqa
    return x, y, cast(args), cast(auxs)


def _port_arrays(args, auxs):
    ctx = tmx.cpu()
    return ({k: tmx.nd.array(v, ctx=ctx) for k, v in args.items()},
            {k: tmx.nd.array(v, ctx=ctx) for k, v in auxs.items()})


@pytest.mark.parametrize("opt,kwargs", OPTIMIZERS)
def test_symbol_mode_matches_the_jax_symbol_mode(opt, kwargs):
    x, y, args, auxs = _values()
    jargs = {k: jmx.nd.array(v) for k, v in args.items()}
    jauxs = {k: jmx.nd.array(v) for k, v in auxs.items()}
    jstep = JaxStepFunction(_graph(jsym, 0.0), arg_dict=jargs,
                            aux_dict=jauxs, input_names=("data", "label"),
                            optimizer=opt, optimizer_params=dict(kwargs))
    jl = [jstep.step(jmx.nd.array(x), jmx.nd.array(y)).asnumpy()
          for _ in range(STEPS)]

    targs, tauxs = _port_arrays(args, auxs)
    step = StepFunction(_graph(tsym, 0.0), arg_dict=targs, aux_dict=tauxs,
                        input_names=("data", "label"), optimizer=opt,
                        optimizer_params=dict(kwargs))
    tl = [step.step(tmx.nd.array(x, ctx=tmx.cpu()),
                    tmx.nd.array(y, ctx=tmx.cpu())).asnumpy()
          for _ in range(STEPS)]
    for got, want in zip(tl, jl):
        np.testing.assert_allclose(got, want, rtol=REL_TOL, atol=1e-7)
    assert tl[-1].mean() < tl[0].mean()
    tvals = dict(targs, **tauxs)
    for name, want in list(jargs.items()) + list(jauxs.items()):
        got = tvals[name].asnumpy()
        want = want.asnumpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= REL_TOL, (name, rel)
    # the steps moved every argument and the moving statistics
    for name, v in list(args.items()) + list(auxs.items()):
        assert not np.array_equal(tvals[name].asnumpy(), v), name
    assert step.cache_info()["programs"] == 1


@pytest.mark.parametrize("opt,kwargs", OPTIMIZERS)
def test_symbol_mode_is_bit_equal_to_the_executor_loop(opt, kwargs):
    x, y, args, auxs = _values()
    graph = _graph(tsym, 0.3)
    ctx = tmx.cpu()
    xs, ys = tmx.nd.array(x, ctx=ctx), tmx.nd.array(y, ctx=ctx)

    # the eager Executor and the list-form Updater
    tmx.random.seed(0)
    eargs, eauxs = _port_arrays(args, auxs)
    names = sorted(eargs)
    ex = graph.bind(ctx, args=dict(eargs, data=xs, label=ys),
                    args_grad={n: tmx.nd.zeros(a.shape, ctx)
                               for n, a in eargs.items()},
                    grad_req="write", aux_states=eauxs)
    optimizer = opt_mod.create(opt, **kwargs)
    optimizer.rescale_grad = 1.0 / N
    updater = opt_mod.get_updater(optimizer)
    eager = []
    for _ in range(STEPS):
        ex.forward(is_train=True)
        ex.backward()
        updater(list(range(len(names))), [ex.grad_dict[n] for n in names],
                [eargs[n] for n in names])
        eager.append(ex.outputs[0]._data.clone())

    tmx.random.seed(0)
    fargs, fauxs = _port_arrays(args, auxs)
    step = StepFunction(graph, arg_dict=fargs, aux_dict=fauxs,
                        input_names=("data", "label"), optimizer=opt,
                        optimizer_params=dict(kwargs))
    fused = [step.step(xs, ys)._data for _ in range(STEPS)]
    for a, b in zip(eager, fused):
        assert torch.equal(a, b)
    for n in names:
        assert torch.equal(eargs[n]._data, fargs[n]._data), n
    for n in eauxs:
        assert torch.equal(ex.aux_dict[n]._data, fauxs[n]._data), n
    for i in range(len(names)):
        a, b = updater.states[i], step._updater.states[i]
        for s, t in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert (s is None and t is None) or torch.equal(s, t), i
