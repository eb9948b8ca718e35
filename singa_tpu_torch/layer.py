"""Layer API: deferred shape-inferring initialization + hierarchical
state names.

Counterpart of ``singa_tpu/layer.py``: ``Layer``, ``Linear``, ``Gemm``
(``:220``), ``Embedding`` (``:257``), ``Conv2d``, ``ConvTranspose2d``
(``:353``), ``SeparableConv2d`` (``:404``), ``BatchNorm2d`` (training and
inference), ``LayerNorm`` (``:501``), ``MaxPool2d``, ``AvgPool2d``,
``MaxPool1d``/``AvgPool1d`` (``:551-563``), ``ReLU``, ``Sigmoid``,
``Tanh``, ``SoftMax``, ``Add``, ``Flatten``, ``Dropout`` (``:790``),
``LRN`` (``:778``), ``Cat`` (``:859``), ``Reshape`` (``:868``), the
losses ``SoftMaxCrossEntropy``, ``CrossEntropy``, ``MeanSquareError``
(``:763``) and ``BinaryCrossEntropy`` (``:773``), and ``FusedCEHead``
(``:799``, over ``ops/losses.fused_softmax_cross_entropy``), with the
same constructor arguments and the same state names (``"conv1.W"``,
``"bn1.running_var"``, registered blocks as ``block.<i>``, ``sep =
"."``), so a ``save_states`` archive of the JAX package loads here
unchanged. Layers hold
:class:`~.tensor.Tensor`s; ``initialize`` runs on the first call with the
input's shapes and draws weights from the input device's generator.

Not ported here (ROADMAP.md): the recurrent layers ``RNN``, ``LSTM`` and
``CudnnRNN`` (slice E, with ``ops/rnn.py`` and ``char_rnn``) and
``FusedCEHeadStage`` (slice E, with the pipeline) raise when made.
"""

from __future__ import annotations

import math

import torch

from . import autograd
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

    def set_params(self, params):
        for k, v in self._own(self._own_params).items():
            full = f"{self.name}{self.sep}{k}"
            if full in params:
                v.copy_from(params[full])
        for _, sub in self._sublayers():
            sub.set_params({k[len(self.name) + 1:]: v
                            for k, v in params.items()
                            if k.startswith(self.name + self.sep)})

    def set_states(self, states):
        for k, v in self._own(self._own_states).items():
            full = f"{self.name}{self.sep}{k}"
            if full in states:
                v.copy_from(states[full])
        for _, sub in self._sublayers():
            sub.set_states({k[len(self.name) + 1:]: v
                            for k, v in states.items()
                            if k.startswith(self.name + self.sep)})

    def device_check(self, *tensors):
        devs = [t.device for t in tensors if isinstance(t, Tensor)]
        return devs[0] if devs else None

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
        self.W.gaussian(0.0, std)
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


class Gemm(Layer):
    """ONNX Gemm: ``alpha * x' @ W' + beta * b`` (``'`` a transpose when
    asked), W ``(nb_kernels, features)`` with ``transB`` (the default),
    else ``(features, nb_kernels)``; b ``(1, nb_kernels)`` unless
    ``bias_shape`` says otherwise."""

    def __init__(self, nb_kernels, alpha=1.0, beta=1.0, transA=False,
                 transB=True, bias=True, bias_shape=None):
        super().__init__()
        self.nb_kernels = nb_kernels
        self.alpha, self.beta = alpha, beta
        self.transA, self.transB = int(transA), int(transB)
        self.bias = bias
        self.bias_shape = bias_shape

    def initialize(self, x):
        dev = x.device
        feat = x.shape[0] if self.transA else x.shape[-1]
        w_shape = (self.nb_kernels, feat) if self.transB \
            else (feat, self.nb_kernels)
        self.W = _param(w_shape, dev)
        self.W.gaussian(0.0, math.sqrt(2.0 / (feat + self.nb_kernels)))
        if self.bias:
            self.b = _param(self.bias_shape or (1, self.nb_kernels), dev)

    def forward(self, x):
        return autograd.gemm(x, self.W, self.b if self.bias else None,
                             self.alpha, self.beta, self.transA,
                             self.transB)

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
        self.W.gaussian(0.0, std)
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


class ConvTranspose2d(Layer):
    """2-D transposed convolution, weights ``(C_in, C_out / group, kH,
    kW)``."""

    def __init__(self, nb_kernels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, group=1, bias=True):
        super().__init__()
        self.nb_kernels = nb_kernels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.group = group
        self.bias = bias

    def initialize(self, x):
        from .ops.conv import ConvTransposeHandle
        from .ops.layout import channel_axis
        self.in_channels = x.shape[channel_axis(len(x.shape))]
        dev = x.device
        ks = self.kernel_size if isinstance(self.kernel_size, (tuple, list)) \
            else (self.kernel_size, self.kernel_size)
        w_shape = (self.in_channels, self.nb_kernels // self.group, *ks)
        self.W = _param(w_shape, dev, dtype=x.dtype)
        std = math.sqrt(
            2.0 / ((self.in_channels // self.group) * ks[0] * ks[1]
                   + self.nb_kernels / self.group))
        self.W.gaussian(0.0, std)
        if self.bias:
            self.b = _param((self.nb_kernels,), dev, dtype=x.dtype)
        self.handle = ConvTransposeHandle(
            x, ks, self.stride, self.padding, self.in_channels,
            self.nb_kernels, self.bias, self.group,
            dilation=self.dilation, output_padding=self.output_padding)

    def forward(self, x):
        from .ops.conv import conv_transpose2d
        return conv_transpose2d(self.handle, x, self.W,
                                self.b if self.bias else None)

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

    def set_params(self, params):
        for sub in self._convs():
            sub.set_params(params)

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


class MaxPool1d(Pooling2d):
    """Max over windows of the last axis of an ``(N, C, 1, L)`` input."""

    def __init__(self, kernel_size, stride=None, padding=0):
        if stride is None:
            stride = kernel_size
        super().__init__((1, kernel_size), (1, stride), (0, padding), True)


class AvgPool1d(Pooling2d):
    """Mean over windows of the last axis of an ``(N, C, 1, L)``
    input."""

    def __init__(self, kernel_size, stride=None, padding=0):
        if stride is None:
            stride = kernel_size
        super().__init__((1, kernel_size), (1, stride), (0, padding), False)


class ReLU(Layer):
    def forward(self, x):
        return autograd.relu(x)


class Sigmoid(Layer):
    def forward(self, x):
        return autograd.sigmoid(x)


class Tanh(Layer):
    def forward(self, x):
        return autograd.tanh(x)


class SoftMax(Layer):
    def __init__(self, axis=1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return autograd.softmax(x, self.axis)


class LRN(Layer):
    """Across-channel local response normalisation
    (:func:`~.autograd.lrn`)."""

    def __init__(self, size=5, alpha=1e-4, beta=0.75, k=1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return autograd.lrn(x, self.size, self.alpha, self.beta, self.k)


class Cat(Layer):
    """Concatenate a list of Tensors along ``axis``."""

    def __init__(self, axis=0):
        super().__init__()
        self.axis = axis

    def forward(self, xs):
        return autograd.cat(xs, self.axis)


class Reshape(Layer):
    def __init__(self, shape=None):
        super().__init__()
        self.shape = shape

    def forward(self, x, shape=None):
        return autograd.reshape(x, shape if shape is not None
                                else self.shape)


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


class MeanSquareError(Layer):
    def forward(self, x, t):
        return autograd.mse_loss(x, t)


class BinaryCrossEntropy(Layer):
    def forward(self, x, t):
        return autograd.binary_cross_entropy(x, t)


class FusedCEHead(Layer):
    """The LM classifier head fused with softmax cross entropy: ``loss =
    head(hidden, target_ids)``; the (tokens, vocab) logits are never made
    whole, the loss and gradients are computed in vocab chunks
    (``ops/losses.fused_softmax_cross_entropy``). ``W`` ``(D, vocab)``
    N(0, 0.02), ``b`` zeros."""

    def __init__(self, vocab_size, chunk=8192):
        super().__init__()
        self.vocab_size = vocab_size
        self.chunk = chunk

    def initialize(self, h, ids):
        self.W = _param((h.shape[-1], self.vocab_size), h.device)
        self.W.gaussian(0.0, 0.02)
        self.b = _param((self.vocab_size,), h.device)

    def forward(self, h, ids):
        from .ops.losses import fused_softmax_cross_entropy
        return fused_softmax_cross_entropy(h, self.W, self.b, ids,
                                           self.chunk)

    def _own_params(self):
        return {"W": self.W, "b": self.b}


def _not_ported(what, where):
    class NotPorted(Layer):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"layer.{what} is not ported yet (ROADMAP.md: {where})")
    NotPorted.__name__ = NotPorted.__qualname__ = what
    return NotPorted


RNN = _not_ported("RNN", "slice E, with ops/rnn.py and char_rnn")
LSTM = _not_ported("LSTM", "slice E, with ops/rnn.py and char_rnn")
CudnnRNN = _not_ported("CudnnRNN", "slice E, with ops/rnn.py and char_rnn")
FusedCEHeadStage = _not_ported("FusedCEHeadStage",
                               "slice E, with parallel/pipeline.py")
