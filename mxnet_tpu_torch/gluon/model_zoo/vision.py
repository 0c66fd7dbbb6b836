"""Model zoo: the ResNet family (v1 and v2, 18 to 152 layers).

Counterpart of the ResNet part of ``mxnet_tpu/gluon/model_zoo/vision.py``
(He et al. 2015, arXiv:1512.03385, and its v2, arXiv:1603.05027, as the
Gluon model zoo builds them). Attribute paths are the JAX package's
(``features.4.0.body.0.weight``, ``features.4.0.downsample.1.running_var``,
``output.bias``, ...), so ``convert.py`` carries every parameter one to
one: 299 of them in ``resnet50_v1``. As in the Gluon zoo, ``BottleneckV1``'s
two 1x1 convolutions carry biases (torchvision's ResNet has none there).
Shapes are given up front: each layer is told its input channels, and the
stem its image channels (``in_channels=3``, a keyword of the port's). Every
constructor takes ``device=`` (default ``"cuda"``) and ``dtype=``. No
pretrained weights: models start from their initializers or from weights
carried in. Blocks are made in the JAX package's name scopes and take its
``prefix=``, so that a parameter's name (:meth:`Block.param_name`,
``resnetv10_stage1_conv0_weight``) and an exported graph are the JAX
package's; each block's ``_trace`` writes its ``hybrid_forward``. VGG,
AlexNet, SqueezeNet, DenseNet, MobileNet and Inception
are not ported yet (:func:`get_model` says so).
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...context import resolve_device
from .. import nn
from ..block import HybridBlock

__all__ = ["BasicBlockV1", "BottleneckV1", "BasicBlockV2", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_resnet", "get_model", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2"]


def _conv3x3(channels, stride, in_channels, **dd):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, **dd)


class BasicBlockV1(HybridBlock):
    """Two 3x3 convolutions with BatchNorm; ReLU after the residual
    add."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device="cuda", dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        dd = dict(device=resolve_device(device), dtype=dtype)
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
                 device="cuda", dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        dd = dict(device=resolve_device(device), dtype=dtype)
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
                 device="cuda", dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        dd = dict(device=resolve_device(device), dtype=dtype)
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
                 device="cuda", dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        dd = dict(device=resolve_device(device), dtype=dtype)
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
                 thumbnail=False, in_channels=3, device="cuda",
                 dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} stages need {len(layers) + 1} "
                             f"channel counts, got {len(channels)}")
        dd = dict(device=resolve_device(device), dtype=dtype)
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
                 thumbnail=False, in_channels=3, device="cuda",
                 dtype=torch.float32, prefix=None):
        super().__init__(prefix=prefix)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"{len(layers)} stages need {len(layers) + 1} "
                             f"channel counts, got {len(channels)}")
        dd = dict(device=resolve_device(device), dtype=dtype)
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


_models = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for v in (1, 2) for n in (18, 34, 50, 101, 152)}

# the JAX package's other families, by the names its get_model takes
_NOT_PORTED = (
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
    "vgg19_bn", "alexnet", "squeezenet1.0", "squeezenet1.1", "densenet121",
    "densenet161", "densenet169", "densenet201", "mobilenet1.0",
    "mobilenet0.75", "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
    "mobilenetv2_0.75", "mobilenetv2_0.5", "mobilenetv2_0.25",
    "inceptionv3")


def get_model(name, **kwargs):
    """A model of the zoo by name (``"resnet50_v1"``, ...)."""
    name = name.lower()
    if name in _models:
        return _models[name](**kwargs)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r}: only the ResNet family of the vision zoo is "
            "ported; the other families wait in ROADMAP Queue A item 2")
    raise ValueError(f"Model {name} is not supported. Available: "
                     f"{sorted(_models)}")
