"""The port's record iterators, record datasets, thread-pool DataLoader and
image ops against the JAX package's, on the CPU.

- ``ImageRecordIter`` on the native pipeline (``backend == "native"``,
  codec libjpeg): bit-equal batches and the same pads as the JAX
  package's for one file, seed and set of arguments, the labels those
  written; ``ImageDetRecordIter`` the same boxes and pixels;
  ``LibSVMIter`` the same batches;
- ``RecordFileDataset`` and ``ImageRecordDataset`` the same samples;
- ``DataLoader(thread_pool=True)`` over an ``ImageRecordDataset`` with
  transforms: the same batches in the same order as the JAX package's
  thread pool and as the port's own worker processes, on the current
  context;
- every ``_image_*`` and ``_cv*`` op and alias on
  ``tests/test_op_sweep.py``'s cases where it has them (else on cases of
  this file), rtol 1e-5 / atol 1e-6: the random ones held to the JAX
  package's shapes and dtypes, to outputs their draw allows, and to
  reproducibility under ``mx.random.seed`` (the port draws from torch's
  generator, not JAX's threefry);
- ``MXDataIter`` raises the JAX package's error class.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf

import test_op_sweep as sweep
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf
from mxnet_tpu_torch.ops.registry import _OPS

from test_torch_native_io import smooth_image, write_image_records
from test_torch_image import _det_label


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("imgdata") / "imgs.rec")
    labels = write_image_records(path, 10, seed=8, sides=(20, 40))
    return path, labels


def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(shuffle=True, rand_crop=True, rand_mirror=True, resize=24,
         mean_r=123.68, mean_g=116.779, mean_b=103.939, std_r=58.393,
         std_g=57.12, std_b=57.375, seed=3, preprocess_threads=3)],
    ids=["plain", "augmented"])
def test_image_record_iter_is_bit_equal_to_the_jax_package(rec, kw):
    path, labels = rec
    args = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=4,
                **kw)
    want = _batches(jmx.io.ImageRecordIter(**args))
    with mx.cpu():
        it = mx.io.ImageRecordIter(**args)
    assert (it.backend, it.codec) == ("native", "libjpeg")
    assert it.ctx == mx.cpu()
    got = _batches(it)
    assert [g[2] for g in got] == [w[2] for w in want] == [0, 0, 2]
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    if not kw:  # unshuffled: the labels in the file's order
        seen = np.concatenate([g[1] for g in got])[:len(labels)]
        np.testing.assert_array_equal(seen, np.asarray(labels, "float32"))
    it.reset()
    assert len(_batches(it)) == 3 and it.decode_failures == 0


def test_image_det_record_iter_matches(tmp_path):
    from mxnet_tpu_torch import recordio as trio
    path = str(tmp_path / "det.rec")
    rs = np.random.RandomState(6)
    w = trio.MXIndexedRecordIO(str(tmp_path / "det.idx"), path, "w")
    for i in range(5):
        w.write_idx(i, trio.pack_img(
            trio.IRHeader(0, _det_label(rs, 1 + i % 3), i, 0),
            smooth_image(rs, 28, 33), quality=90))
    w.close()
    args = dict(path_imgrec=path, data_shape=(3, 12, 12), batch_size=2,
                rand_mirror=True, shuffle=True, seed=2, mean_r=10.0)
    want = _batches(jmx.io.ImageDetRecordIter(**args))
    with mx.cpu():
        got = _batches(mx.io.ImageDetRecordIter(**args))
    assert len(got) == len(want) == 3
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g[0], wt[0])
        np.testing.assert_array_equal(g[1], wt[1])
        assert g[2] == wt[2]


def test_libsvm_iter_matches(tmp_path):
    path = tmp_path / "a.libsvm"
    path.write_text("1 0:0.5 3:1.5\n0 2:2.0\n\n1 1:-1.0 3:0.25\n")
    kw = dict(data_libsvm=str(path), data_shape=(4,), batch_size=2)
    want = _batches(jmx.io.LibSVMIter(**kw))
    with mx.cpu():
        got = _batches(mx.io.LibSVMIter(**kw))
    for g, wt in zip(got, want):
        for a, b in zip(g, wt):
            np.testing.assert_array_equal(a, b)


def test_record_datasets_match(rec):
    path, labels = rec
    raw_t, raw_j = tdata.RecordFileDataset(path), jdata.RecordFileDataset(path)
    assert len(raw_t) == len(raw_j) == 10
    assert [raw_t[i] for i in range(10)] == [raw_j[i] for i in range(10)]
    with mx.cpu():
        imgs = tdata.vision.ImageRecordDataset(path)
        for i in (0, 7):
            got, want = imgs[i], jdata.vision.ImageRecordDataset(path)[i]
            np.testing.assert_array_equal(got[0].asnumpy(),
                                          want[0].asnumpy())
            assert got[1] == want[1] == labels[i]
        gray = tdata.vision.ImageRecordDataset(path, flag=0)[3][0]
        assert gray.ndim == 2 and gray.context == mx.cpu()


def _loader(data_mod, tf_mod, path, **kw):
    tf = tf_mod.Compose([tf_mod.Resize(20), tf_mod.CenterCrop(16),
                         tf_mod.ToTensor(),
                         tf_mod.Normalize((0.485, 0.456, 0.406),
                                          (0.229, 0.224, 0.225))])
    ds = data_mod.vision.ImageRecordDataset(path).transform_first(tf)
    return data_mod.DataLoader(ds, batch_size=3, shuffle=True,
                               last_batch="keep", **kw)


def _epoch(loader, seed=1):
    np.random.seed(seed)
    return [[b.asnumpy() for b in batch] for batch in loader]


def test_thread_pool_loader_matches_the_jax_package_and_processes(rec):
    path, _ = rec
    state = np.random.get_state()
    try:
        want = _epoch(_loader(jdata, jtf, path, num_workers=3,
                              thread_pool=True))
        with mx.cpu():
            threads = _loader(tdata, ttf, path, num_workers=3,
                              thread_pool=True)
            got = _epoch(threads)
            again = _epoch(threads)
            procs = _epoch(_loader(tdata, ttf, path, num_workers=2))
            first = next(iter(threads))
    finally:
        np.random.set_state(state)
    assert len(got) == len(want) == 4 and got[-1][0].shape[0] == 1
    for g, p, a, wt in zip(got, procs, again, want):
        np.testing.assert_array_equal(g[1], wt[1])
        # a resized uint8 image within 1 count, then / 255 / 0.224
        np.testing.assert_allclose(g[0], wt[0], atol=1.0 / 255 / 0.224)
        for x, y in zip(g, p):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(g, a):
            np.testing.assert_array_equal(x, y)
    assert first[0].context == mx.cpu()


# -- the image ops ---------------------------------------------------------------

def _canonical(pred):
    return sorted({i.name for i in _OPS.values()
                   if not i.stub and pred(i.name)})


IMAGE_OPS = _canonical(lambda n: n.startswith(("_image_", "_cv")))
DETERMINISTIC = [n for n in IMAGE_OPS if "random" not in n
                 and n not in ("_cvimdecode", "_cvimread")]
RANDOM = [n for n in IMAGE_OPS if "random" in n]
ALIASES = sorted(n for n, i in _OPS.items() if i.name in DETERMINISTIC
                 and n != i.name)
# cases of this file where the sweep's own leave the op's work untested
EXTRA_CASES = {
    "_image_resize": lambda: ([sweep.T(5, 7, 3)], {"size": (4, 3)}),
    "_image_crop": lambda: ([sweep.T(2, 5, 6, 3)],
                            {"x": 1, "y": 2, "width": 3, "height": 2}),
    "_image_normalize": lambda: ([sweep.T(3, 4, 5)],
                                 {"mean": (0.1, 0.2, 0.3),
                                  "std": (0.5, 0.6, 0.7)}),
    "_image_to_tensor": lambda: ([sweep.T(2, 4, 5, 3)], {}),
}
BORDERS = [dict(top=1, bot=2, left=3, right=1, type=t) for t in range(5)] \
    + [dict(top=2, bot=0, left=1, right=2, type=0, value=4.0),
       dict(top=1, bot=1, left=0, right=2, type=0, values=(1.0, 2.0, 3.0))]


def _case(name, seed=7):
    saved = sweep.rs
    sweep.rs = np.random.RandomState(seed)
    try:
        if name in sweep.CASES:
            return sweep.CASES[name]()
        return [sweep.T(2, 3, 4)], {}
    finally:
        sweep.rs = saved


def _run(name, args, params):
    want = getattr(jmx.nd, name)(*args, **params).asnumpy()
    with mx.cpu():
        got = getattr(nd, name)(*[nd.array(a.asnumpy(), dtype=a.dtype)
                                  for a in args], **params).asnumpy()
    return got, want


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", DETERMINISTIC + ALIASES)
def test_image_op_matches_the_jax_package(name):
    canonical = _OPS[name].name
    cases = [_case(canonical)]
    if canonical in EXTRA_CASES:
        saved, sweep.rs = sweep.rs, np.random.RandomState(3)
        cases.append(EXTRA_CASES[canonical]())
        sweep.rs = saved
    if canonical == "_cvcopyMakeBorder":
        image = _case("_cvimresize")[0]
        cases += [(image, p) for p in BORDERS]
    for args, params in cases:
        _same(*_run(name, args, params))


def test_image_decode_ops_match(tmp_path):
    import cv2
    img = smooth_image(np.random.RandomState(0), 13, 17)
    buf = cv2.imencode(".jpg", img)[1]
    (tmp_path / "a.jpg").write_bytes(buf.tobytes())
    for name in ("_cvimdecode", "_npi_cvimdecode"):
        for flag in (0, 1):
            _same(*_run(name, [jmx.nd.array(buf, dtype="uint8")],
                        {"flag": flag}))
    for name in ("_cvimread", "_npi_cvimread"):
        want = getattr(jmx.nd, name)(filename=str(tmp_path / "a.jpg"))
        with mx.cpu():
            got = getattr(nd, name)(filename=str(tmp_path / "a.jpg"))
        _same(got.asnumpy(), want.asnumpy())


def _allowed(name, x, out):
    """Whether ``out`` is an output the random op ``name`` can give on
    ``x`` (HWC float32) for some draw of its factor(s)."""
    x = x.astype(np.float64)
    out = out.astype(np.float64)
    if "flip" in name:
        axis = 1 if "left_right" in name else 0
        return np.array_equal(out, x) or np.array_equal(out, np.flip(x, axis))
    if name == "_image_random_brightness":
        f = out.sum() / x.sum()
        return 0.5 <= f <= 1.5 and np.allclose(out, x * f, rtol=1e-5)
    if name in ("_image_random_contrast", "_image_random_saturation",
                "_image_random_hue"):
        pull = {"_image_random_contrast": x.mean(),
                "_image_random_saturation": (x * [0.299, 0.587, 0.114]).sum(
                    -1, keepdims=True),
                "_image_random_hue": x.mean(-1, keepdims=True)}[name]
        f = ((out - pull) * (x - pull)).sum() / ((x - pull) ** 2).sum()
        lo, hi = (0.8, 1.2) if name.endswith("hue") else (0.5, 1.5)
        return lo <= f <= hi and np.allclose(out, x * f + pull * (1 - f),
                                             rtol=1e-5, atol=1e-5)
    if name == "_image_random_lighting":
        shift = out - x
        return np.allclose(shift, shift[0, 0], atol=1e-5) and \
            np.abs(shift[0, 0]).max() < 0.05 * 6 * 55.46
    return np.isfinite(out).all()  # color jitter: four draws composed


@pytest.mark.parametrize("name", RANDOM)
def test_random_image_op_draws_an_allowed_output_reproducibly(name):
    args, params = _case(name)
    x = args[0].asnumpy()
    want = getattr(jmx.nd, name)(*args, **params).asnumpy()
    outs = []
    with mx.cpu():
        for seed in (0, 0, 1, 2, 3, 4, 5):
            mx.random.seed(seed)
            outs.append(getattr(nd, name)(nd.array(x), **params).asnumpy())
        alias = name.replace("_image_", "_npx__image_")
        alias = alias if alias in _OPS else None
        if alias is not None:
            mx.random.seed(0)
            outs.append(getattr(nd, alias)(nd.array(x), **params).asnumpy())
    for out in outs:
        assert out.shape == want.shape and out.dtype == want.dtype
        assert _allowed(name, x, out)
    np.testing.assert_array_equal(outs[0], outs[1])
    if alias is not None:
        np.testing.assert_array_equal(outs[0], outs[-1])
    if "flip" in name:  # over six seeds both outcomes show
        assert any(np.array_equal(o, x) for o in outs)
        assert not all(np.array_equal(o, x) for o in outs)


def test_mxdataiter_raises_the_jax_package_error_class():
    with pytest.raises(jmx.MXNetError) as want:
        jmx.io.MXDataIter()
    with pytest.raises(mx.MXNetError, match=str(want.value)):
        mx.io.MXDataIter()
    assert not issubclass(type(want.value), NotImplementedError)
    assert isinstance(torch.zeros(1), torch.Tensor)
