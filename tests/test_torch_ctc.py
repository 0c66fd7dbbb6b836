"""The port's CTC loss against the JAX package's, on the CPU.

The op (``nd.CTCLoss`` and its three other names) and Gluon's
``CTCLoss`` on the same numpy-seeded activations: the blank first and
last, with and without data and label lengths, labels padded with 0 and
with -1, repeated labels, an empty label and a row no alignment fits.
The losses within 1e-5 (relative) and the gradients with respect to the
activations within 1e-4 relative L2 of ``jax.grad`` of the JAX op. The
row no alignment fits has the JAX package's loss, 1e30, and a gradient
of exactly 0 in the port (the JAX package's there is an artefact of its
-1e30 sentinel, so that row is weighted 0 when the gradients are held
together); frames past a row's data length get a gradient of exactly 0.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import ctc as jctc

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.ops import ctc as tctc

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
T, B, C = 8, 4, 5

# case -> (labels, data lengths or None, label lengths or None, blank)
CASES = {
    "blank_first_pad0": ([[1, 2, 3], [4, 1, 0], [2, 0, 0], [3, 3, 0]],
                         None, None, "first"),
    "blank_first_pad_minus1": ([[1, 2, 3], [4, 1, -1], [2, -1, -1],
                                [1, 4, 2]], None, None, "first"),
    "blank_last_pad_minus1": ([[0, 1, 2], [3, 1, -1], [2, -1, -1],
                               [1, 3, 2]], None, None, "last"),
    "data_lengths": ([[1, 2, 3], [4, 1, 0], [2, 0, 0], [3, 3, 0]],
                     [8, 5, 3, 6], None, "first"),
    "both_lengths": ([[1, 2, 3], [4, 1, 2], [2, 1, 4], [3, 3, 1]],
                     [8, 5, 3, 6], [3, 2, 1, 2], "first"),
    "label_lengths": ([[1, 2, 3], [4, 1, 2], [2, 1, 4], [3, 3, 1]],
                      None, [3, 2, 1, 2], "first"),
    "repeats": ([[1, 1, 2], [2, 2, 2], [3, 3, 0], [4, 4, 4]],
                None, None, "first"),
    "empty": ([[0, 0, 0], [1, 0, 0], [-1, -1, -1], [2, 3, 0]],
              [8, 8, 4, 8], None, "first"),
    "impossible": ([[1, 2, 3], [1, 1, 1], [2, 2, 0], [4, 0, 0]],
                   [2, 4, 8, 8], None, "first"),
}


def _inputs(case):
    labels, dl, ll, blank = CASES[case]
    rs = np.random.RandomState(5)
    data = rs.randn(T, B, C).astype("float32") * 2
    lengths = [np.asarray(v, "float32") for v in (dl, ll) if v is not None]
    kw = dict(use_data_lengths=dl is not None,
              use_label_lengths=ll is not None, blank_label=blank)
    return data, np.asarray(labels, "float32"), lengths, kw


def _impossible_rows(case):
    if case != "impossible":
        return np.zeros(B, bool)
    # 3 labels in 2 frames; 1,1,1 in 4 (needs 5); the rest fit
    return np.array([True, True, False, False])


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_op_matches_jax(case):
    data, labels, lengths, kw = _inputs(case)
    bad = _impossible_rows(case)
    weight = np.where(bad, 0.0, 1.0 + np.arange(B)).astype("float32")

    def jloss(d):
        return jctc.ctc_loss(d, jnp.asarray(labels),
                             *map(jnp.asarray, lengths), **kw)

    jl = np.asarray(jloss(jnp.asarray(data)))
    jg = np.asarray(jax.grad(lambda d: jnp.sum(
        jloss(d) * jnp.asarray(weight)))(jnp.asarray(data)))

    td = torch.tensor(data, requires_grad=True)
    tl = tctc.ctc_loss(td, torch.from_numpy(labels),
                       *map(torch.from_numpy, lengths), **kw)
    (tl * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=LOSS_RTOL)
    assert np.linalg.norm(td.grad.numpy() - jg) <= \
        GRAD_TOL * np.linalg.norm(jg)
    if bad.any():
        assert np.all(jl[bad] == np.float32(tctc.IMPOSSIBLE_LOSS))
        td.grad = None
        tctc.ctc_loss(td, torch.from_numpy(labels),
                      *map(torch.from_numpy, lengths), **kw).sum().backward()
        assert not td.grad[:, torch.from_numpy(bad)].any()
        assert td.grad[:, torch.from_numpy(~bad)].abs().sum() > 0
    if kw["use_data_lengths"]:
        for b, n in enumerate(lengths[0].astype(int)):
            assert not td.grad[n:, b].any()
            assert bad[b] or td.grad[:n, b].abs().sum() > 0

    # nd.CTCLoss and its other names, through the registry
    with mx.cpu():
        args = [nd.array(data), nd.array(labels)] + \
            [nd.array(v) for v in lengths]
        for name in ("CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                     "_contrib_ctc_loss"):
            got = getattr(nd, name)(*args, **kw).asnumpy()
            assert np.array_equal(got, tl.detach().numpy())


@pytest.mark.parametrize("layout,lengths", [("NTC", True), ("TNC", False)])
def test_gluon_ctc_loss_matches_jax(layout, lengths):
    data, labels, _, _ = _inputs("both_lengths")
    pred = data if layout == "TNC" else data.transpose(1, 0, 2)
    pl = np.asarray([8, 5, 3, 6], "float32")
    ll = np.asarray([3, 2, 1, 2], "float32")
    sw = np.asarray([[1.0], [0.5], [2.0], [1.0]], "float32")
    extra = [pl, ll] if lengths else [None, None]
    jl = jgluon.loss.CTCLoss(layout=layout)(
        *[None if a is None else jnd.array(a)
          for a in [pred, labels] + extra + [sw[:, 0]]])
    with mx.cpu():
        x = nd.array(pred)
        x.attach_grad()
        with autograd.record():
            tl = gluon.loss.CTCLoss(layout=layout)(
                x, *[None if a is None else nd.array(a)
                     for a in [labels] + extra + [sw[:, 0]]])
        tl.backward()
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), rtol=LOSS_RTOL)
    assert tl.shape == (B,)
    if lengths:
        t_axis = layout.find("T")
        g = np.moveaxis(x.grad.asnumpy(), t_axis, 0)
        assert not g[5:, 1].any() and not g[3:, 2].any()
    # label_layout "TN" takes the labels time first
    with mx.cpu():
        rest = [None if a is None else nd.array(a) for a in extra]
        tn = gluon.loss.CTCLoss(layout=layout, label_layout="TN")(
            nd.array(pred), nd.array(labels.T), *rest)
        nt = gluon.loss.CTCLoss(layout=layout)(
            nd.array(pred), nd.array(labels), *rest)
    assert np.array_equal(tn.asnumpy(), nt.asnumpy())
