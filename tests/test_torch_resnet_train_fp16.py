"""The port's fp16 multi-precision ResNet training against the JAX
package's, on the CPU.

The narrow ResNetV1 of ``test_torch_resnet_train.py`` (its helpers, with
their weights, batch and schedule) cast to fp16 with BatchNorm in fp32,
two ``Trainer.step``s of multi-precision SGD with a static loss scale of
8, in both packages from the same weights; the JAX side as there (each
forward and backward one program, which rounds each fp16 op as the
eager run does: the distances below came out equal to six digits).

Elementwise agreement of the updates is not a property of fp16 here: the
gradient that reaches each convolution through the BatchNorm after it is
a small residual of its upstream gradient (the normalization projects out
the mean and the normalized direction), so fp16's roundings of that
gradient, taken at different places by the two packages (the JAX package
rounds every step of the fp16 softmax, ATen one), leave each run's update
~20-40% (relative L2) from the fp32 one, and 43% apart from each other.
So each fp16 run is held to the port's fp32 run of the same steps
(equal to the JAX package's within rtol 2e-4 / atol 2e-5,
``test_torch_resnet_train.py``), and the port must come at least as close
to it as the JAX package does: the update of the fp32 master weights, the
momentum, the running statistics and the second step's losses. The first
step's losses, from the same weights, agree with the JAX package's within
1e-2 (fp16 logits rounded at other places), as in
``tests/test_torch_train.py``; the fp16 weights equal their masters cast
to fp16, and BatchNorm stays fp32 throughout.
"""
import numpy as np
import pytest

from test_torch_resnet_train import STATS, _jax_train, _port_train

LOSS_TOL16 = 1e-2


@pytest.fixture(scope="module")
def runs():
    jax16 = _jax_train("float16")
    return {"jax16": jax16,
            "port16": _port_train(jax16["named"], "float16"),
            "port32": _port_train(jax16["named"], "float32")}


def _rel_l2(got, want, base, names):
    """||(got - base) - (want - base)|| / ||want - base|| over ``names``."""
    d = u = 0.0
    for n in names:
        d += float(((got[n] - want[n]).astype(np.float64) ** 2).sum())
        u += float(((want[n] - base[n]).astype(np.float64) ** 2).sum())
    return (d / u) ** 0.5


def test_first_step_losses_match_jax(runs):
    np.testing.assert_allclose(runs["port16"]["losses"][0],
                               runs["jax16"]["losses"][0], atol=LOSS_TOL16)


def test_masters_and_fp16_weights(runs):
    """27 fp16 parameters (17 convolution weights, 8 biases, the
    classifier's 2) have fp32 masters, as in the JAX package; each fp16
    weight is its master cast; BatchNorm parameters are fp32."""
    got, want = runs["port16"], runs["jax16"]
    assert sorted(got["masters"]) == sorted(want["masters"])
    assert len(got["masters"]) == 27
    for n, m in got["masters"].items():
        assert m.dtype == np.float32
        np.testing.assert_array_equal(got["weights"][n],
                                      m.astype(np.float16), err_msg=n)
    for n, w in got["weights"].items():
        if n not in got["masters"]:
            assert w.dtype == want["weights"][n].dtype == np.float32, n


@pytest.mark.parametrize("what", ["masters", "moms", "stats", "losses"])
def test_update_is_as_close_to_fp32_as_jax(runs, what):
    ref, init = runs["port32"], runs["jax16"]["named"]
    got, jax16 = runs["port16"], runs["jax16"]
    if what == "losses":
        e_port = np.linalg.norm(got["losses"][1] - ref["losses"][1])
        e_jax = np.linalg.norm(jax16["losses"][1] - ref["losses"][1])
    else:
        if what == "masters":
            names = sorted(got["masters"])
            g, j = got["masters"], jax16["masters"]
            r = ref["weights"]
        elif what == "moms":
            names = sorted(got["masters"])
            g, j, r = got["moms"], jax16["moms"], ref["moms"]
            init = {n: np.zeros_like(r[n]) for n in names}
        else:
            names = sorted(n for n in ref["weights"] if n.endswith(STATS))
            g, j, r = got["weights"], jax16["weights"], ref["weights"]
        e_port = _rel_l2(g, r, init, names)
        e_jax = _rel_l2(j, r, init, names)
    assert e_port <= e_jax, (what, e_port, e_jax)
