"""The ResNet family (counterpart of paddle_tpu/vision/models/resnet.py).

``BasicBlock`` (ResNet-18/34) and ``BottleneckBlock`` (ResNet-50 and
deeper; ``groups`` and ``base_width`` make ResNeXt and wide ResNet) over
the port's ``Conv2D``, ``BatchNorm2D``, ``ReLU``, ``MaxPool2D``,
``AdaptiveAvgPool2D`` and ``Linear``.  The state-dict keys are the JAX
model's, buffers included (``layer1.0.downsample.0.weight``,
``bn1._mean``), so ``convert.load_jax_state_dict`` carries its weights
and running statistics across with no transpose.

Built in f32 on ``device`` (``None``: the CUDA card, which raises without
one; the tests pass ``device="cpu"``); ``generator`` draws the random
initial weights (KaimingUniform convolutions, a Xavier-normal head), in
construction order.  ``pretrained=True`` raises, as in the JAX package:
no weights are downloaded.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch._core.device import resolve_device
from paddle_tpu_torch.nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D,
                                 ReLU, Sequential)

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
           "wide_resnet101_2"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64,
                 dilation=1, norm_layer=None, *, device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = {"device": device, "generator": generator}
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1, bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False, **kw)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64,
                 dilation=1, norm_layer=None, *, device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = {"device": device, "generator": generator}
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation, groups=groups,
                            dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = Conv2D(width, planes * self.expansion, 1, bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


_LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
           152: [3, 8, 36, 3]}


class ResNet(nn.Module):
    """``ResNet(block, depth)``: the 7x7 stem, a 3x3 max pool, four stages
    and, with ``with_pool``, a global average pool, then a ``num_classes``
    head when ``num_classes > 0`` (else the features come out)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True, groups=1,
                 *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        layers = _LAYERS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        kw = {"device": device, "generator": generator}
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3, bias_attr=False, **kw)
        self.bn1 = BatchNorm2D(self.inplanes, device=device)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], **kw)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2, **kw)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2, **kw)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2, **kw)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride=1, *, device, generator):
        kw = {"device": device, "generator": generator}
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                       bias_attr=False, **kw),
                BatchNorm2D(planes * block.expansion, device=device))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, self.dilation, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **kw))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)  # the JAX package's flatten is a reshape
            x = self.fc(x)
        return x


def _resnet(block, depth, width=64, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights unavailable offline")
    return ResNet(block, depth, width=width, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained=pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained=pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained=pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained=pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained=pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=128, pretrained=pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=128, pretrained=pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=4, groups=32, pretrained=pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=4, groups=64, pretrained=pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=4, groups=32, pretrained=pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=4, groups=64, pretrained=pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, width=4, groups=32, pretrained=pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, width=4, groups=64, pretrained=pretrained, **kwargs)
