"""``singa_tpu_torch.utils`` and ``singa_tpu_torch.channel`` against the
JAX package's modules: the padding helpers, ``handle_odd_pad_fwd``,
``same_pad_shape_check``, ``post_order_recursive``, ``update_progress``'s
output, ``force_completion``'s value, ``force_unicode``, and the lines a
channel writes to its file."""

import itertools
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (bounds torch's CPU threads)

from singa_tpu import channel as jchannel
from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu import utils as jutils
from singa_tpu.ops.conv import ConvHandle as JConvHandle
from singa_tpu.ops.pooling import PoolingHandle as JPoolingHandle

from singa_tpu_torch import channel as tchannel
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch import utils as tutils
from singa_tpu_torch.ops.conv import ConvHandle as TConvHandle
from singa_tpu_torch.ops.pooling import PoolingHandle as TPoolingHandle

SPATIAL = [(7, 7), (8, 5), (1, 13), (32, 31)]
KERNELS = [(3, 3), (1, 1), (2, 5), (4, 4)]
STRIDES = [(1, 1), (2, 2), (3, 1), (2, 3)]


@pytest.mark.parametrize("mode", ["SAME_UPPER", "SAME_LOWER", "VALID"])
def test_padding_and_output_shapes(mode):
    for sp, k, s in itertools.product(SPATIAL, KERNELS, STRIDES):
        assert tutils.get_output_shape(mode, sp, k, s) == \
            jutils.get_output_shape(mode, sp, k, s)
        if mode != "VALID":
            assert tutils.get_padding_shape(mode, sp, k, s) == \
                jutils.get_padding_shape(mode, sp, k, s)
    with pytest.raises(ValueError, match="unsupported auto_pad"):
        tutils.get_output_shape("NOTSET", (4, 4), (3, 3), (1, 1))


def test_conv_same_pads_come_from_utils():
    """``ConvHandle.pads`` under SAME takes :func:`utils.same_pads`, with
    the dilation; at dilation 1 they are ``get_padding_shape``'s."""
    x = np.zeros((1, 3, 9, 10), np.float32)
    for mode, upper in (("SAME", "SAME_UPPER"),
                        ("SAME_LOWER", "SAME_LOWER")):
        h = TConvHandle(x, (4, 3), (2, 3), 0, 3, 4, pad_mode=mode)
        assert [tuple(p) for p in h.pads(9, 10)] == \
            jutils.get_padding_shape(upper, (9, 10), (4, 3), (2, 3))
        hd = TConvHandle(x, 3, 1, 0, 3, 4, pad_mode=mode, dilation=2)
        assert hd.pads(9, 10) == ((2, 2), (2, 2))


@pytest.mark.parametrize("is_pool", [False, True])
def test_handle_odd_pad_fwd(is_pool):
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    pads = (1, 0, 2, 1)
    want = np.asarray(jutils.handle_odd_pad_fwd(x, pads, is_pool))
    got = tutils.handle_odd_pad_fwd(x, pads, is_pool)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tutils.handle_odd_pad_fwd(torch.from_numpy(x), pads, is_pool)
        .numpy(), want)
    jt = jtensor.Tensor(data=x, device=jdevice.create_cpu_device())
    tt = ttensor.Tensor(data=x, device=tdevice.create_cpu_device())
    np.testing.assert_array_equal(
        tutils.handle_odd_pad_fwd(tt, pads, is_pool).to_numpy(),
        jutils.handle_odd_pad_fwd(jt, pads, is_pool).numpy())


def test_same_pad_shape_check():
    x = np.zeros((1, 3, 9, 10), np.float32)
    cases = [(3, 2, ((1, 1), (0, 1)), "SAME_UPPER"),
             (3, 2, ((1, 1), (1, 0)), "SAME_LOWER"),
             (3, 2, 1, "SAME_UPPER"), (1, 1, 0, "SAME_LOWER"),
             ((2, 4), (1, 3), ((0, 1), (1, 1)), "SAME_UPPER")]
    seen = set()
    for k, s, p, mode in cases:
        for jh, th in ((JConvHandle(x, k, s, p, 3, 4),
                        TConvHandle(x, k, s, p, 3, 4)),
                       (JPoolingHandle(x, k, s, p),
                        TPoolingHandle(x, k, s, p))):
            got = tutils.same_pad_shape_check(th, mode, x)
            assert got == jutils.same_pad_shape_check(jh, mode, x)
            seen.add(got)
    assert seen == {True, False}


class _Op:
    def __init__(self, name, *srcs):
        self.name = name
        self.src = [(s, id(s), None, True) for s in srcs] + \
            [(None, 0, None, False)]


def test_post_order_recursive():
    """A tape with shared sources: every op once, each after its
    sources, in the JAX walker's order; a tape deeper than the recursion
    limit walks too."""
    a = _Op("a")
    b = _Op("b", a)
    c = _Op("c", a, b)
    d = _Op("d", c, b, a)
    order = {}
    for name, mod in (("jax", jutils), ("port", tutils)):
        seen = []
        mod.post_order_recursive(d, lambda op: seen.append(op.name))
        order[name] = seen
    assert order["port"] == order["jax"]
    assert sorted(order["port"]) == ["a", "b", "c", "d"]
    assert order["port"][-1] == "d" and order["port"][0] == "a"
    deep = _Op("0")
    for i in range(1, 5000):
        deep = _Op(str(i), deep)
    count = []
    tutils.post_order_recursive(deep, count.append)
    assert len(count) == 5000 and count[0].name == "0"


def test_update_progress_output(capsys):
    for p, info in ((0.0, ""), (0.333, "epoch 1"), (0.5, "x"),
                    (1.0, "done"), (1.7, ""), (-0.2, "neg")):
        jutils.update_progress(p, info)
        want = capsys.readouterr().out
        tutils.update_progress(p, info)
        assert capsys.readouterr().out == want
    tutils.update_progress(1.0)
    assert capsys.readouterr().out.endswith("Done.\n")


def test_force_completion_and_force_unicode():
    x = np.array([[2.5, -1.0], [3.0, 4.0]], np.float32)
    jt = jtensor.Tensor(data=x, device=jdevice.create_cpu_device())
    tt = ttensor.Tensor(data=x, device=tdevice.create_cpu_device())
    want = jutils.force_completion(jt.data)
    assert want == 2.5
    for arg in (tt, tt.data, [tt], {"loss": tt}, (torch.empty(0), tt)):
        assert tutils.force_completion(arg) == want
    bf = torch.tensor([1.0078125, 2.0], dtype=torch.bfloat16)
    assert tutils.force_completion(bf) == jutils.force_completion(
        jtensor.Tensor(data=np.array([1.0078125, 2.0], np.float32),
                       device=jdevice.create_cpu_device())
        .as_type("bfloat16").data)
    assert tutils.force_completion(torch.empty(0)) == 0.0
    assert tutils.force_completion(None) == 0.0
    for s in (b"caf\xc3\xa9", b"\xff", "text", 12):
        assert tutils.force_unicode(s) == jutils.force_unicode(s)


@pytest.fixture
def channel_dirs(tmp_path):
    """A directory per package for the default files; the modules'
    channel books emptied before and after."""
    dirs = {}
    for name, mod in (("jax", jchannel), ("port", tchannel)):
        mod._channels.clear()
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        mod.set_channel_directory(str(dirs[name]))
    yield dirs
    for mod in (jchannel, tchannel):
        mod._channels.clear()
        mod.set_channel_directory("")


# The JAX module's native sink keeps its channels by name for the whole
# process, beyond ``_channels``: names no other test uses keep this test's
# files out of theirs.
NAMES = {k: f"port_parity_{k}" for k in ("train", "quiet", "val")}


def _drive(mod, directory):
    """What a training script writes to its channels."""
    mod.InitChannel()
    train = mod.GetChannel(NAMES["train"])
    train.send("epoch 0, loss 1.25")
    train.send(0.5)
    assert mod.get_channel(NAMES["train"]) is train
    quiet = mod.get_channel(NAMES["quiet"])
    quiet.enable_dest_file(False)
    quiet.send("dropped")
    quiet.enable_dest_file(True)
    quiet.send("kept")
    val = mod.get_channel(NAMES["val"])
    val.set_dest_file_path(os.path.join(directory, "val_custom.log"))
    val.send("acc 0.91")
    mod.SetChannelDirectory(directory)


def test_channel_files_match(channel_dirs, capfd):
    for name, mod in (("jax", jchannel), ("port", tchannel)):
        _drive(mod, str(channel_dirs[name]))
    for f in list(NAMES.values()) + ["val_custom.log"]:
        want = (channel_dirs["jax"] / f).read_text()
        assert (channel_dirs["port"] / f).read_text() == want
    assert (channel_dirs["port"] / NAMES["train"]).read_text() == \
        "epoch 0, loss 1.25\n0.5\n"
    ch = tchannel.get_channel("port_parity_screen")
    ch.enable_dest_stderr(True)
    ch.send("hello")
    assert "hello" in capfd.readouterr().err
