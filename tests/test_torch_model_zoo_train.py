"""Every new zoo family's logits and one SGD update in the port against
the JAX package's, on the CPU, in fp64.

Each family's smallest variant (``vgg11``, ``alexnet``, ``squeezenet1.1``,
``mobilenet0.25``, ``mobilenetv2_0.25``) at an input its pools allow, and
two members of the DenseNet and Inception v3 families cut in depth at
their published widths (``DenseNet(64, 32, [1, 1, 1, 1])``: densenet121's
stem, growth and transitions with one layer per dense block; Inception
v3's stem with one each of its A, B, C, D and E blocks, then a global
pool and the Dense), as a full densenet121's or inceptionv3's backward
compiles for about a minute on the JAX side (their full-width fp32
logits are in ``test_torch_model_zoo.py``, and so is the Inception
member's step, to split the two files' time). Dropout's rate is set to 0
on both sides, as the two draw different masks.

From the same numpy-seeded weights and batch of 4, one training step:
the port through its public loop (the Trainer made before the first
forward, ``record`` -> ``backward`` -> ``Trainer.step``: SGD, momentum
0.9, weight decay 1e-4, rate 0.1), the JAX package's forward and
backward as one compiled program (``functional_call`` under
``jax.value_and_grad``, with ``jax_enable_x64`` on for the test and
restored after it), and its first SGD step with momentum from a zero
state, ``w - lr * (g / batch + wd * w)``, applied to its gradients. The
training-mode logits, the loss, every parameter's update and the running
statistics the forward writes agree within rtol 1e-9 / atol 1e-9.

Why fp64: these deep nets' fp32 gradients are ill-conditioned (a ReLU's
mask flips where a pre-activation lies within an fp32 rounding of 0):
against an fp64 run, the JAX package's own fp32 gradients of
mobilenetv2_0.25 at 224 x 224 are up to 9.5% off (0.2 to 6% for the
port's), so an fp32 comparison at 1e-4 would measure rounding, not the
port. In fp64 the two packages agree to about 1e-12.
"""
import pytest

from test_torch_model_zoo import FAMILIES, family_step_matches


@pytest.mark.parametrize("name", sorted(set(FAMILIES)
                                  - {"inception3_one_block_each"}))
def test_family_logits_and_sgd_update_match_the_jax_package(name):
    family_step_matches(name)
