"""ResNet family on the port's layer API.

Counterpart of ``singa_tpu/models/resnet.py``: the same blocks, widths and
state names (``ResNet.block.<i>.conv1.W``), so weights carry across from
the JAX package. ResNet-50 at 224 px is the flagship model. The
``layout=`` knob keeps both trunks: ``"NHWC"`` transposes once at the stem
and runs the trunk on logical channels-last tensors. ``stem=
"space_to_depth"`` is not ported yet (ROADMAP).
"""

from .. import autograd, layer, model
from ..ops.layout import use_layout


def conv3x3(planes, stride=1):
    return layer.Conv2d(planes, 3, stride=stride, padding=1, bias=False)


class BasicBlock(layer.Layer):
    expansion = 1

    def __init__(self, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = conv3x3(planes, stride)
        self.bn1 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.conv2 = conv3x3(planes)
        self.bn2 = layer.BatchNorm2d()
        self.add = layer.Add()
        self.relu2 = layer.ReLU()
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu2(self.add(out, residual))


class Bottleneck(layer.Layer):
    expansion = 4

    def __init__(self, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = layer.Conv2d(planes, 1, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.conv2 = layer.Conv2d(planes, 3, stride=stride, padding=1,
                                  bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.relu2 = layer.ReLU()
        self.conv3 = layer.Conv2d(planes * self.expansion, 1, bias=False)
        self.bn3 = layer.BatchNorm2d()
        self.add = layer.Add()
        self.relu3 = layer.ReLU()
        self.downsample = downsample

    def forward(self, x):
        residual = x
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.relu2(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu3(self.add(out, residual))


class Downsample(layer.Layer):
    """1x1 strided conv + BN on the shortcut path."""

    def __init__(self, planes, stride):
        super().__init__()
        self.conv = layer.Conv2d(planes, 1, stride=stride, bias=False)
        self.bn = layer.BatchNorm2d()

    def forward(self, x):
        return self.bn(self.conv(x))


class ResNet(model.Model):

    def __init__(self, block, layers, num_classes=10, num_channels=3,
                 layout="NCHW", stem="conv7"):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dimension = 4
        self.layout = str(layout).upper()
        if stem == "space_to_depth":
            raise NotImplementedError(
                "stem='space_to_depth' is not ported yet (ROADMAP: left "
                "out of the serving slice); use stem='conv7'")
        if stem != "conv7":
            raise ValueError(f"stem must be 'conv7' or 'space_to_depth', "
                             f"got {stem!r}")
        self.inplanes = 64
        self.conv1 = layer.Conv2d(64, 7, stride=2, padding=3, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.relu = layer.ReLU()
        self.maxpool = layer.MaxPool2d(kernel_size=3, stride=2, padding=1)
        self.layer1, l1 = self._make_layer(block, 64, layers[0])
        self.layer2, l2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3, l3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4, l4 = self._make_layer(block, 512, layers[3], stride=2)
        self.avgpool = layer.AvgPool2d(7, stride=1)
        self.flatten = layer.Flatten()
        self.fc = layer.Linear(num_classes)
        self.register_layers(*l1, *l2, *l3, *l4)

    def _make_layer(self, block, planes, num_blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Downsample(planes * block.expansion, stride)
        blocks = [block(planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, num_blocks):
            blocks.append(block(planes))

        def forward(x):
            for b in blocks:
                x = b(x)
            return x

        return forward, blocks

    def forward(self, x):
        if self.layout == "NHWC":
            x = autograd.transpose(x, (0, 2, 3, 1))
            with use_layout("NHWC"):
                return self._trunk(x)
        return self._trunk(x)

    def _trunk(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.flatten(self.avgpool(x))
        return self.fc(x)

    def _sublayers(self):
        subs = super()._sublayers()
        for i, b in enumerate(getattr(self, "_registered", [])):
            b.name = b.name if b.name != type(b).__name__ \
                else f"block{self.sep}{i}"
            subs.append((b.name, b))
        return subs


def resnet18(**kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(**kw):
    return ResNet(Bottleneck, [3, 4, 6, 3], **kw)


def resnet101(**kw):
    return ResNet(Bottleneck, [3, 4, 23, 3], **kw)


def resnet152(**kw):
    return ResNet(Bottleneck, [3, 8, 36, 3], **kw)


def create_model(pretrained=False, depth=50, **kwargs):
    zoo = {18: resnet18, 34: resnet34, 50: resnet50, 101: resnet101,
           152: resnet152}
    return zoo[depth](**kwargs)


__all__ = ["ResNet", "BasicBlock", "Bottleneck", "Downsample", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "create_model"]
