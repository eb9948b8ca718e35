"""Layer API: deferred shape-inferring initialization + hierarchical
state names.

Counterpart of the CNN and LM subset of ``singa_tpu/layer.py``: ``Layer``,
``Conv2d``, ``SeparableConv2d`` (``:404``), ``BatchNorm2d`` (training
and inference), ``ReLU``, ``MaxPool2d``, ``AvgPool2d``, ``Add``,
``Flatten``, ``Dropout`` (``:790``), ``Linear``,
``Embedding`` (``:257``), ``LayerNorm`` (``:501``) and the losses
``SoftMaxCrossEntropy`` and ``CrossEntropy``, with the same constructor
arguments
and the same state names (``"conv1.W"``, ``"bn1.running_var"``, registered
blocks as ``block.<i>``, ``sep = "."``), so a ``save_states`` archive of
the JAX package loads here unchanged. Layers hold
:class:`~.tensor.Tensor`s; ``initialize`` runs on the first call with the
input's shapes and draws weights from the input device's generator.
"""

from __future__ import annotations

import math

import torch

from . import autograd, initializer
from .autograd_base import CTX, register_param
from .tensor import Tensor
from .ops.conv import ConvHandle
from .ops.batchnorm import BatchNormHandle
from .ops.pooling import PoolingHandle


class Layer:
    """Base layer."""

    sep = "."

    def __init__(self):
        self.name = self.__class__.__name__
        self._initialized = False
        self._parent = None

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if isinstance(value, Layer):
            value.name = name
            value._parent = self
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                if isinstance(v, Layer):
                    v.name = f"{name}{self.sep}{i}"
                    v._parent = self
        object.__setattr__(self, name, value)

    def _sublayers(self):
        out = []
        for k, v in vars(self).items():
            if k.startswith("_") or k == "name":
                continue
            if isinstance(v, Layer):
                out.append((v.name, v))
            elif isinstance(v, (list, tuple)):
                out.extend((s.name, s) for s in v if isinstance(s, Layer))
        return out

    def initialize(self, *input):  # noqa: A002
        pass

    def forward(self, *input):  # noqa: A002
        raise NotImplementedError

    def ensure_initialized(self, *args, **kwargs):
        """Run the deferred, shape-inferring init if still pending.
        Parameters are made outside inference mode, so a first call
        inside the serving engine's ``inference_mode`` still leaves
        ordinary tensors that ``load_states`` can refill in place."""
        if self._initialized:
            return
        prev = CTX.training
        CTX.training = False
        try:
            with torch.inference_mode(False), torch.no_grad():
                self.initialize(*args, **kwargs)
        finally:
            CTX.training = prev
        self._initialized = True

    def __call__(self, *args, **kwargs):
        """Initialise on the first call, then ``forward``. Outside
        training nothing is recorded for backward (``no_grad``), as the
        JAX package records its tape only in training."""
        self.ensure_initialized(*args, **kwargs)
        if CTX.training:
            return self.forward(*args, **kwargs)
        with torch.no_grad():
            return self.forward(*args, **kwargs)

    @property
    def training(self):
        return CTX.training

    def _own_params(self):
        return {}

    def _own_states(self):
        return dict(self._own_params())

    def _own(self, which):
        try:
            return which()
        except AttributeError:
            return {}

    def get_params(self):
        """The trainable subset of :meth:`get_states` (no BN running
        statistics), by the same names."""
        params = {f"{self.name}{self.sep}{k}": v
                  for k, v in self._own(self._own_params).items()}
        for _, sub in self._sublayers():
            for k, v in sub.get_params().items():
                params[f"{self.name}{self.sep}{k}"] = v
        return params

    def get_states(self):
        states = {f"{self.name}{self.sep}{k}": v
                  for k, v in self._own(self._own_states).items()}
        for _, sub in self._sublayers():
            for k, v in sub.get_states().items():
                states[f"{self.name}{self.sep}{k}"] = v
        return states

    def set_states(self, states):
        for k, v in self._own(self._own_states).items():
            full = f"{self.name}{self.sep}{k}"
            if full in states:
                v.copy_from(states[full])
        for _, sub in self._sublayers():
            sub.set_states({k[len(self.name) + 1:]: v
                            for k, v in states.items()
                            if k.startswith(self.name + self.sep)})

    def register_layers(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = layers[0]
        self._registered = list(layers)


def _param(shape, device, init="zeros", dtype=torch.float32):
    """A new parameter: a torch leaf that requires grad. Under a
    precision policy it takes the master dtype, not a 16-bit
    activation's."""
    from .mixed_precision import param_dtype as _policy_param_dtype
    dtype = _policy_param_dtype(dtype)
    t = Tensor(shape=shape, device=device, dtype=dtype,
               requires_grad=True, stores_grad=True)
    if init == "ones":
        t.data.fill_(1.0)
    register_param(t)
    return t


class Linear(Layer):
    """y = xW + b, W of shape (in_features, out_features)."""

    def __init__(self, out_features, *args, bias=True):
        super().__init__()
        self.out_features = out_features
        if len(args) > 0 and not isinstance(args[0], bool):
            self.out_features = args[0]
            if len(args) > 1:
                bias = args[1]
        elif len(args) > 0:
            bias = args[0]
        self.bias = bias

    def initialize(self, x):
        self.in_features = x.shape[-1]
        dev = x.device
        self.W = _param((self.in_features, self.out_features), dev,
                        dtype=x.dtype)
        std = math.sqrt(2.0 / (self.in_features + self.out_features))
        initializer.gaussian(self.W, 0.0, std)
        if self.bias:
            self.b = _param((self.out_features,), dev, dtype=x.dtype)

    def forward(self, x):
        y = autograd.matmul(x, self.W)
        if self.bias:
            y = autograd.add_bias(y, self.b, axis=0)
        return y

    def _own_params(self):
        p = {"W": self.W}
        if self.bias:
            p["b"] = self.b
        return p


class Embedding(Layer):
    """Token embedding lookup: ``W`` of shape (input_dim, output_dim),
    N(0, 0.02) by default, U(-0.05, 0.05) otherwise."""

    def __init__(self, input_dim, output_dim, initializer="gaussian"):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.initializer = initializer

    def initialize(self, x):
        self.W = _param((self.input_dim, self.output_dim), x.device)
        if self.initializer == "gaussian":
            self.W.gaussian(0.0, 0.02)
        else:
            self.W.uniform(-0.05, 0.05)

    def forward(self, x):
        return autograd.embedding(x, self.W)

    def _own_params(self):
        return {"W": self.W}


class LayerNorm(Layer):
    """Layer normalisation over the trailing dim; f32 ``scale`` (ones)
    and ``bias`` (zeros)."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def initialize(self, x):
        d = (x.shape[-1],)
        self.scale = _param(d, x.device, init="ones")
        self.bias = _param(d, x.device)

    def forward(self, x):
        return autograd.layernorm(x, self.scale, self.bias, self.eps)

    def _own_params(self):
        return {"scale": self.scale, "bias": self.bias}


class Conv2d(Layer):
    """2-D convolution, OIHW weights."""

    def __init__(self, nb_kernels, kernel_size, *args, stride=1, padding=0,
                 dilation=1, group=1, bias=True, pad_mode="NOTSET",
                 activation="NOTSET", space_to_depth=False):
        super().__init__()
        if len(args) > 0:
            nb_kernels = kernel_size
            kernel_size = args[0]
        if len(args) > 1:
            stride = args[1]
        if len(args) > 2:
            padding = args[2]
        self.nb_kernels = nb_kernels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.group = group
        self.bias = bias
        self.pad_mode = pad_mode
        self.activation = activation
        self.space_to_depth = space_to_depth

    def initialize(self, x):
        from .ops.layout import channel_axis
        self.in_channels = x.shape[channel_axis(len(x.shape))]
        dev = x.device
        ks = self.kernel_size if isinstance(self.kernel_size, (tuple, list)) \
            else (self.kernel_size, self.kernel_size)
        w_shape = (self.nb_kernels, self.in_channels // self.group, *ks)
        pad_mode = {"SAME_UPPER": "SAME", "SAME_LOWER": "SAME_LOWER",
                    "VALID": "VALID"}.get(self.pad_mode)
        self.handle = ConvHandle(x, ks, self.stride, self.padding,
                                 self.in_channels, self.nb_kernels,
                                 self.bias, self.group, pad_mode,
                                 dilation=self.dilation,
                                 space_to_depth=self.space_to_depth)
        self.W = _param(w_shape, dev, dtype=x.dtype)
        std = math.sqrt(
            2.0 / (w_shape[1] * ks[0] * ks[1]
                   + self.nb_kernels / self.group))
        initializer.gaussian(self.W, 0.0, std)
        if self.bias:
            self.b = _param((self.nb_kernels,), dev, dtype=x.dtype)

    def forward(self, x):
        from .ops.conv import conv2d
        y = conv2d(self.handle, x, self.W, self.b if self.bias else None)
        if self.activation == "RELU":
            y = autograd.relu(y)
        return y

    def _own_params(self):
        p = {"W": self.W}
        if self.bias:
            p["b"] = self.b
        return p


class SeparableConv2d(Layer):
    """Depthwise conv (``group`` = input channels) then a 1x1 pointwise
    conv. The two convs are named ``<name>.depthwise`` and
    ``<name>.pointwise`` at the first call, and the layer's states are
    theirs under those names, as in the JAX package."""

    def __init__(self, nb_kernels, kernel_size, *args, stride=1, padding=0,
                 bias=False):
        super().__init__()
        # legacy form SeparableConv2d(in_ch, nb_kernels, k[, stride[, pad]])
        if len(args) > 0:
            nb_kernels = kernel_size
            kernel_size = args[0]
        if len(args) > 1:
            stride = args[1]
        if len(args) > 2:
            padding = args[2]
        self.depthwise = None
        self.pointwise = None
        self.nb_kernels = nb_kernels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.bias = bias

    def initialize(self, x):
        from .ops.layout import channel_axis
        in_channels = x.shape[channel_axis(len(x.shape))]
        self.depthwise = Conv2d(in_channels, self.kernel_size,
                                stride=self.stride, padding=self.padding,
                                group=in_channels, bias=self.bias)
        self.pointwise = Conv2d(self.nb_kernels, 1, bias=self.bias)
        self.depthwise.name = f"{self.name}{self.sep}depthwise"
        self.pointwise.name = f"{self.name}{self.sep}pointwise"

    def forward(self, x):
        return self.pointwise(self.depthwise(x))

    def _convs(self):
        return [c for c in (self.depthwise, self.pointwise) if c is not None]

    def get_params(self):
        out = {}
        for sub in self._convs():
            out.update(sub.get_params())
        return out

    def get_states(self):
        return self.get_params()

    def set_states(self, states):
        for sub in self._convs():
            sub.set_states(states)


class BatchNorm2d(Layer):
    """BN over the channel axis: batch statistics and a running-stat
    update in training, the running statistics in inference."""

    def __init__(self, *args, momentum=0.9, eps=1e-5, freeze_stats=False):
        super().__init__()
        if len(args) == 1 and isinstance(args[0], float):
            momentum = args[0]
        elif len(args) > 1:
            momentum = args[1]
        self.momentum = momentum
        self.eps = eps
        self.freeze_stats = freeze_stats

    def initialize(self, x):
        from .ops.layout import channel_axis
        self.channels = x.shape[channel_axis(len(x.shape))]
        dev = x.device
        c = (self.channels,)
        self.scale = _param(c, dev, init="ones")
        self.bias = _param(c, dev)
        self.running_mean = Tensor(shape=c, device=dev)
        self.running_var = Tensor(shape=c, device=dev)
        self.running_var.data.fill_(1.0)
        self.handle = BatchNormHandle(self.momentum, x, self.eps)

    def forward(self, x):
        from .ops.batchnorm import batchnorm_2d
        return batchnorm_2d(self.handle, x, self.scale, self.bias,
                            self.running_mean, self.running_var,
                            freeze_stats=self.freeze_stats)

    def _own_params(self):
        return {"scale": self.scale, "bias": self.bias}

    def _own_states(self):
        return {"scale": self.scale, "bias": self.bias,
                "running_mean": self.running_mean,
                "running_var": self.running_var}


class Pooling2d(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, is_max=True):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding
        self.is_max = is_max

    def initialize(self, x):
        self.handle = PoolingHandle(x, self.kernel_size, self.stride,
                                    self.padding, self.is_max)

    def forward(self, x):
        from .ops.pooling import pooling_2d
        return pooling_2d(self.handle, x)


class MaxPool2d(Pooling2d):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__(kernel_size, stride, padding, True)


class AvgPool2d(Pooling2d):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__(kernel_size, stride, padding, False)


class ReLU(Layer):
    def forward(self, x):
        return autograd.relu(x)


class Add(Layer):
    def forward(self, a, b):
        return autograd.add(a, b)


class Dropout(Layer):
    """:func:`~.autograd.dropout` at ``ratio``: the identity outside
    training."""

    def __init__(self, ratio=0.5):
        super().__init__()
        self.ratio = ratio

    def forward(self, x):
        return autograd.dropout(x, self.ratio)


class Flatten(Layer):
    def __init__(self, axis=1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return autograd.flatten(x, self.axis)


class SoftMaxCrossEntropy(Layer):
    def forward(self, x, t):
        return autograd.softmax_cross_entropy(x, t)


class CrossEntropy(Layer):
    def forward(self, x, t):
        return autograd.cross_entropy(x, t)
