"""Model zoo: the vision families of the JAX package's zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision.py``: ResNet v1 and v2
(18 to 152 layers; He et al. 2015, arXiv:1512.03385, and its v2,
arXiv:1603.05027), VGG 11/13/16/19 with and without BatchNorm, AlexNet,
SqueezeNet 1.0/1.1, DenseNet 121/161/169/201, MobileNet v1 and v2 (four
width multipliers each) and Inception v3, as the Gluon model zoo builds
them and by the names :func:`get_model` takes. Attribute paths, blocks,
name scopes and prefixes are the JAX package's
(``features.4.0.body.0.weight``; ``mobilenetv20_features_conv0_weight``),
so ``convert.py`` carries every parameter one to one, ``collect_params``
keys equal the JAX package's and an exported graph is its graph. As in
the Gluon zoo, ``BottleneckV1``'s two 1x1 convolutions carry biases.

Every family but ResNet is built as users build it, without input sizes:
its layers resolve their shapes at the first forward, on the device
``initialize(ctx=...)`` chose and in the dtype a ``cast`` before it set.
ResNet keeps the port's explicit sizes (the stem's ``in_channels=3``, a
keyword of the port's) and takes ``device=`` (default None: the
parameters are made by ``initialize``; a device makes them at
construction) and ``dtype=``. No pretrained
weights: models start from their initializers or from weights carried
in. Each block computes on tensors, or through its ``hybrid_forward``,
which is also what ``export`` traces.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from .. import nn
from ..block import HybridBlock

__all__ = ["BasicBlockV1", "BottleneckV1", "BasicBlockV2", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_resnet", "get_model", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2", "VGG", "get_vgg", "vgg11", "vgg13", "vgg16",
           "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
           "AlexNet", "alexnet", "SqueezeNet", "squeezenet1_0",
           "squeezenet1_1", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "MobileNet", "MobileNetV2",
           "LinearBottleneck", "get_mobilenet", "mobilenet1_0",
           "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25", "Inception3", "inception_v3"]


def _conv3x3(channels, stride, in_channels, **dd):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, **dd)


class BasicBlockV1(HybridBlock):
    """Two 3x3 convolutions with BatchNorm; ReLU after the residual
    add."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        dd = dict(device=device, dtype=dtype)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, **dd),
                      nn.BatchNorm(in_channels=channels, **dd),
                      nn.Activation("relu"),
                      _conv3x3(channels, 1, channels, **dd),
                      nn.BatchNorm(in_channels=channels, **dd))
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(
                nn.Conv2D(channels, kernel_size=1, strides=stride,
                          use_bias=False, in_channels=in_channels, **dd),
                nn.BatchNorm(in_channels=channels, **dd))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + self.body(x))

    def _trace(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 (stride ``stride``) -> 3x3 -> 1x1 with BatchNorm, the 1x1s with
    biases; ReLU after the residual add."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        dd = dict(device=device, dtype=dtype)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                in_channels=in_channels, **dd),
                      nn.BatchNorm(in_channels=mid, **dd),
                      nn.Activation("relu"),
                      _conv3x3(mid, 1, mid, **dd),
                      nn.BatchNorm(in_channels=mid, **dd),
                      nn.Activation("relu"),
                      nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=mid, **dd),
                      nn.BatchNorm(in_channels=channels, **dd))
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(
                nn.Conv2D(channels, kernel_size=1, strides=stride,
                          use_bias=False, in_channels=in_channels, **dd),
                nn.BatchNorm(in_channels=channels, **dd))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)

    def _trace(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """Pre-activation: BN -> ReLU -> 3x3 -> BN -> ReLU -> 3x3, plus the
    residual (downsampled from the first activation)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        dd = dict(device=device, dtype=dtype)
        self.bn1 = nn.BatchNorm(in_channels=in_channels, **dd)
        self.conv1 = _conv3x3(channels, stride, in_channels, **dd)
        self.bn2 = nn.BatchNorm(in_channels=channels, **dd)
        self.conv2 = _conv3x3(channels, 1, channels, **dd)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, **dd) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(torch.relu(self.bn2(x)))
        return x + residual

    def _trace(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = F.Activation(self.bn2(self.conv1(x)), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck: BN -> ReLU -> 1x1 -> BN -> ReLU -> 3x3
    (stride ``stride``) -> BN -> ReLU -> 1x1, no biases."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        dd = dict(device=device, dtype=dtype)
        mid = channels // 4
        self.bn1 = nn.BatchNorm(in_channels=in_channels, **dd)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                               in_channels=in_channels, **dd)
        self.bn2 = nn.BatchNorm(in_channels=mid, **dd)
        self.conv2 = _conv3x3(mid, stride, mid, **dd)
        self.bn3 = nn.BatchNorm(in_channels=mid, **dd)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, in_channels=mid, **dd)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, **dd) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(torch.relu(self.bn2(x)))
        x = self.conv3(torch.relu(self.bn3(x)))
        return x + residual

    def _trace(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = F.Activation(self.bn2(self.conv1(x)), act_type="relu")
        x = F.Activation(self.bn3(self.conv2(x)), act_type="relu")
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, stage_index, in_channels,
                dd):
    layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with layer.name_scope():
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix="", **dd))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            prefix="", **dd))
    return layer


class _ResNet(HybridBlock):
    def forward(self, x):
        return self.output(self.features(x))

    def _trace(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    """``features`` (stem, four stages of ``block``, global average pool)
    then ``output``, a Dense over the flattened features; ``thumbnail``
    swaps the 7x7 stem and max pool for one 3x3 convolution (small
    images)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, device=None,
                 dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} stages need {len(layers) + 1} "
                             f"channel counts, got {len(channels)}")
        dd = dict(device=device, dtype=dtype)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, in_channels,
                                           **dd))
            else:
                self.features.add(
                    nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                              in_channels=in_channels, **dd),
                    nn.BatchNorm(in_channels=channels[0], **dd),
                    nn.Activation("relu"), nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, channels[i], dd))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1], **dd)


class ResNetV2(_ResNet):
    """Pre-activation ResNet: a BatchNorm without scale and shift on the
    input, the stem, four stages of ``block``, BN -> ReLU -> global average
    pool -> flatten, then ``output``."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, device=None,
                 dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} stages need {len(layers) + 1} "
                             f"channel counts, got {len(channels)}")
        dd = dict(device=device, dtype=dtype)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           in_channels=in_channels, **dd))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, in_channels,
                                           **dd))
            else:
                self.features.add(
                    nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                              in_channels=in_channels, **dd),
                    nn.BatchNorm(in_channels=channels[0], **dd),
                    nn.Activation("relu"), nn.MaxPool2D(3, 2, 1))
            c = channels[0]
            for i, num_layer in enumerate(layers):
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, c, dd))
                c = channels[i + 1]
            self.features.add(nn.BatchNorm(in_channels=c, **dd),
                              nn.Activation("relu"), nn.GlobalAvgPool2D(),
                              nn.Flatten())
            self.output = nn.Dense(classes, in_units=c, **dd)


resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3],
                     [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3],
                     [64, 256, 512, 1024, 2048])}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet v``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101,
    152); ``kwargs`` go to the network (``classes``, ``thumbnail``,
    ``in_channels``, ``device``, ``dtype``, ``prefix``)."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"no ResNet of {num_layers} layers (known: "
                         f"{sorted(resnet_spec)})")
    if version not in (1, 2):
        raise MXNetError(f"ResNet version {version}: 1 or 2")
    if pretrained:
        raise MXNetError("pretrained weights are not available; carry "
                         "weights in with convert.params_from_mxnet_tpu")
    block_type, layers, channels = resnet_spec[num_layers]
    return resnet_net_versions[version - 1](
        resnet_block_versions[version - 1][block_type], layers, channels,
        **kwargs)


def resnet18_v1(**kw):
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    return get_resnet(1, 152, **kw)


def resnet18_v2(**kw):
    return get_resnet(2, 18, **kw)


def resnet34_v2(**kw):
    return get_resnet(2, 34, **kw)


def resnet50_v2(**kw):
    return get_resnet(2, 50, **kw)


def resnet101_v2(**kw):
    return get_resnet(2, 101, **kw)


def resnet152_v2(**kw):
    return get_resnet(2, 152, **kw)




def _no_pretrained(pretrained):
    if pretrained:
        raise MXNetError("pretrained weights are not available; carry "
                         "weights in with convert.params_from_mxnet_tpu")


# -- VGG (Simonyan and Zisserman 2014) ----------------------------------------


class VGG(HybridBlock):
    """3x3 convolution stages (with BatchNorm where ``batch_norm``), each
    closed by a 2x2 max pool, then two 4096-wide Dense layers with dropout
    and ``output``."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if len(layers) != len(filters):
            raise MXNetError("VGG: one filter count per stage")
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, **kwargs):
    """VGG of ``num_layers`` (11, 13, 16, 19)."""
    _no_pretrained(pretrained)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kw):
    return get_vgg(11, **kw)


def vgg13(**kw):
    return get_vgg(13, **kw)


def vgg16(**kw):
    return get_vgg(16, **kw)


def vgg19(**kw):
    return get_vgg(19, **kw)


def vgg11_bn(**kw):
    return get_vgg(11, batch_norm=True, **kw)


def vgg13_bn(**kw):
    return get_vgg(13, batch_norm=True, **kw)


def vgg16_bn(**kw):
    return get_vgg(16, batch_norm=True, **kw)


def vgg19_bn(**kw):
    return get_vgg(19, batch_norm=True, **kw)


# -- AlexNet (Krizhevsky et al. 2012) -----------------------------------------


class AlexNet(HybridBlock):
    """Five convolutions with three max pools, two 4096-wide Dense layers
    with dropout, then ``output``."""

    def __init__(self, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                        padding=2, activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


# -- SqueezeNet (Iandola et al. 2016) -----------------------------------------


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    out.add(_FireConcat(expand1x1_channels, expand3x3_channels))
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireConcat(HybridBlock):
    """A fire module's 1x1 and 3x3 expansions, concatenated."""

    def __init__(self, c1, c3, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.p1 = _make_fire_conv(c1, 1)
        self.p3 = _make_fire_conv(c3, 3, 1)

    def hybrid_forward(self, F, x):
        return F.Concat(self.p1(x), self.p3(x), dim=1)


class SqueezeNet(HybridBlock):
    """SqueezeNet ``version`` "1.0" or "1.1": a stem, fire modules between
    max pools, dropout, then a 1x1 convolution to ``classes`` averaged
    over the image."""

    def __init__(self, version, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if version not in ("1.0", "1.1"):
            raise MXNetError(f"SqueezeNet version {version!r}: 1.0 or 1.1")
        pool = dict(pool_size=3, strides=2, ceil_mode=True)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(**pool))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(**pool))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(**pool))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(**pool))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(**pool))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(**pool))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)


# -- DenseNet (Huang et al. 2016) ---------------------------------------------


class _DenseLayerConcat(HybridBlock):
    """BN-ReLU-1x1-BN-ReLU-3x3 (with dropout where given), concatenated
    to its input."""

    def __init__(self, growth_rate, bn_size, dropout, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.Concat(x, self.body(x), dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout, stage_index):
    out = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayerConcat(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    """A stem, dense blocks of ``block_config`` layers (each adding
    ``growth_rate`` channels) joined by halving transitions, then a 7x7
    average pool and ``output``."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1))
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2))
                    num_features //= 2
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _densenet(num_layers, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kw):
    return _densenet(121, **kw)


def densenet161(**kw):
    return _densenet(161, **kw)


def densenet169(**kw):
    return _densenet(169, **kw)


def densenet201(**kw):
    return _densenet(201, **kw)


# -- MobileNet v1 (Howard et al. 2017) and v2 (Sandler et al. 2018) -----------


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm(scale=True))
    if active:
        out.add(_RELU6() if relu6 else nn.Activation("relu"))


class _RELU6(HybridBlock):
    """``min(max(x, 0), 6)``."""

    def hybrid_forward(self, F, x):
        return F.clip(x, 0, 6)


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """MobileNet v2's inverted residual: a 1x1 expansion by ``t``, a 3x3
    depthwise convolution of stride ``stride``, a linear 1x1 projection,
    and the shortcut where the shapes allow."""

    def __init__(self, in_channels, channels, t, stride, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True)
            _add_conv(self.out, channels, active=False, relu6=True)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    """MobileNet v1 at width ``multiplier``: depthwise-separable
    convolutions, a global average pool and ``output``."""

    def __init__(self, multiplier=1.0, classes=1000, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), kernel=3,
                      stride=2, pad=1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                           + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6
                        + [1024] * 2]
            strides = [1, 2] * 3 + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dwc, c, s)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """MobileNet v2 at width ``multiplier``: 17 linear bottlenecks with
    ReLU6, a 1x1 convolution to 1280 channels, a global average pool and a
    1x1 convolution to ``classes``."""

    def __init__(self, multiplier=1.0, classes=1000, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3
                                     + [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4
                                  + [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(LinearBottleneck(
                        in_channels=in_c, channels=c, t=t, stride=s))
                last_channels = int(1280 * multiplier) \
                    if multiplier > 1.0 else 1280
                _add_conv(self.features, last_channels, relu6=True)
                self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                          prefix="pred_"),
                                nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, **kwargs):
    """MobileNet v1 at width ``multiplier``."""
    _no_pretrained(pretrained)
    return MobileNet(multiplier, **kwargs)


def mobilenet1_0(**kw):
    return get_mobilenet(1.0, **kw)


def mobilenet0_75(**kw):
    return get_mobilenet(0.75, **kw)


def mobilenet0_5(**kw):
    return get_mobilenet(0.5, **kw)


def mobilenet0_25(**kw):
    return get_mobilenet(0.25, **kw)


def _mobilenet_v2(multiplier, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(multiplier, **kwargs)


def mobilenet_v2_1_0(**kw):
    return _mobilenet_v2(1.0, **kw)


def mobilenet_v2_0_75(**kw):
    return _mobilenet_v2(0.75, **kw)


def mobilenet_v2_0_5(**kw):
    return _mobilenet_v2(0.5, **kw)


def mobilenet_v2_0_25(**kw):
    return _mobilenet_v2(0.25, **kw)


# -- Inception v3 (Szegedy et al. 2015; a 3x299x299 input) --------------------


class _HybridConcurrent(nn.HybridSequential):
    """The children on one input, their outputs concatenated along
    ``axis`` (the JAX package's ``contrib.nn.HybridConcurrent``)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self], dim=self.axis)

    def _trace(self, F, x):
        return F.concat(*[block(x) for block in self], dim=self.axis)


def _inc_conv(channels, kernel, stride=1, pad=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel, strides=stride, padding=pad,
                      use_bias=False),
            nn.BatchNorm(epsilon=0.001),
            nn.Activation("relu"))
    return out


def _inc_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for channels, kernel, stride, pad in conv_settings:
        out.add(_inc_conv(channels, kernel, stride, pad))
    return out


def _inc_A(pool_features):
    out = _HybridConcurrent(axis=1, prefix="")
    out.add(_inc_branch(None, (64, 1, 1, 0)),
            _inc_branch(None, (48, 1, 1, 0), (64, 5, 1, 2)),
            _inc_branch(None, (64, 1, 1, 0), (96, 3, 1, 1),
                        (96, 3, 1, 1)),
            _inc_branch("avg", (pool_features, 1, 1, 0)))
    return out


def _inc_B():
    out = _HybridConcurrent(axis=1, prefix="")
    out.add(_inc_branch(None, (384, 3, 2, 0)),
            _inc_branch(None, (64, 1, 1, 0), (96, 3, 1, 1),
                        (96, 3, 2, 0)),
            _inc_branch("max"))
    return out


def _inc_C(channels_7x7):
    c = channels_7x7
    out = _HybridConcurrent(axis=1, prefix="")
    out.add(_inc_branch(None, (192, 1, 1, 0)),
            _inc_branch(None, (c, 1, 1, 0), (c, (1, 7), 1, (0, 3)),
                        (192, (7, 1), 1, (3, 0))),
            _inc_branch(None, (c, 1, 1, 0), (c, (7, 1), 1, (3, 0)),
                        (c, (1, 7), 1, (0, 3)), (c, (7, 1), 1, (3, 0)),
                        (192, (1, 7), 1, (0, 3))),
            _inc_branch("avg", (192, 1, 1, 0)))
    return out


def _inc_D():
    out = _HybridConcurrent(axis=1, prefix="")
    out.add(_inc_branch(None, (192, 1, 1, 0), (320, 3, 2, 0)),
            _inc_branch(None, (192, 1, 1, 0), (192, (1, 7), 1, (0, 3)),
                        (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)),
            _inc_branch("max"))
    return out


class _IncESplit(HybridBlock):
    """The E block's forked 1x3 / 3x1 pair, concatenated."""

    def __init__(self, pre_settings, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.pre = nn.HybridSequential(prefix="")
        for channels, kernel, stride, pad in pre_settings:
            self.pre.add(_inc_conv(channels, kernel, stride, pad))
        self.a = _inc_conv(384, (1, 3), 1, (0, 1))
        self.b = _inc_conv(384, (3, 1), 1, (1, 0))

    def hybrid_forward(self, F, x):
        h = self.pre(x)
        return F.Concat(self.a(h), self.b(h), dim=1)


def _inc_E():
    out = _HybridConcurrent(axis=1, prefix="")
    out.add(_inc_branch(None, (320, 1, 1, 0)),
            _IncESplit([(384, 1, 1, 0)]),
            _IncESplit([(448, 1, 1, 0), (384, 3, 1, 1)]),
            _inc_branch("avg", (192, 1, 1, 0)))
    return out


class Inception3(HybridBlock):
    """Inception v3 over 3x299x299 images: a convolutional stem, the
    A/B/C/D/E mixed blocks, an 8x8 average pool, dropout and ``output``."""

    def __init__(self, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_inc_conv(32, 3, 2),
                              _inc_conv(32, 3),
                              _inc_conv(64, 3, pad=1),
                              nn.MaxPool2D(pool_size=3, strides=2),
                              _inc_conv(80, 1),
                              _inc_conv(192, 3),
                              nn.MaxPool2D(pool_size=3, strides=2),
                              _inc_A(32), _inc_A(64), _inc_A(64),
                              _inc_B(),
                              _inc_C(128), _inc_C(160), _inc_C(160),
                              _inc_C(192),
                              _inc_D(),
                              _inc_E(), _inc_E(),
                              nn.AvgPool2D(pool_size=8),
                              nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, classes=1000, **kwargs):
    _no_pretrained(pretrained)
    return Inception3(classes=classes, **kwargs)


_models = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for v in (1, 2) for n in (18, 34, 50, 101, 152)}
_models.update({
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn, "alexnet": alexnet,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25, "inceptionv3": inception_v3})


def get_model(name, **kwargs):
    """A model of the zoo by name (``"resnet50_v1"``, ``"inceptionv3"``,
    ``"mobilenetv2_1.0"``, ...)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
