"""The port's Tensor, device and initializer surface, on the CPU.

Mirrors ``tests/test_tensor.py``'s classes and holds each deterministic
result against the JAX package's on the same numpy inputs. Random fills
and initializers are held by their moments and by one device seed giving
one draw, not by the JAX package's values (it draws from ``jax.random``).
The in-place operators write into the tensor's storage (a parameter stays
its leaf); the methods that return a new tensor never hand out a view.
"""

import io
import contextlib

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import initializer as jinit
from singa_tpu import tensor as jtensor

from singa_tpu_torch import device, initializer, tensor
from singa_tpu_torch.tensor import Tensor

DEV = device.create_cpu_device()
JDEV = jdevice.create_cpu_device()


def t(a):
    return tensor.from_numpy(np.asarray(a), DEV)


def jt(a):
    return jtensor.from_numpy(np.asarray(a), JDEV)


def same(got, want, **kw):
    w = want.numpy() if hasattr(want, "numpy") else np.asarray(want)
    g = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    assert np.asarray(g).shape == np.asarray(w).shape
    np.testing.assert_allclose(g, w, rtol=kw.get("rtol", 1e-6),
                               atol=kw.get("atol", 1e-6))


A = np.random.RandomState(0).randn(3, 4).astype(np.float32)
B = np.random.RandomState(1).randn(4, 5).astype(np.float32)


class TestCreation:
    def test_shape_ctor(self):
        x = Tensor(shape=(2, 3), device=DEV)
        assert x.shape == (2, 3) and x.size() == 6 and x.ndim == 2
        np.testing.assert_array_equal(x.numpy(), np.zeros((2, 3)))

    def test_from_numpy_keeps_32_bits(self):
        """f64 is stored as f32 and int64 as int32, as in the JAX
        package."""
        for a in (np.ones(3), np.arange(3), A):
            x, j = t(a), jt(a)
            assert tensor.dtype_name(x.dtype) == str(j.dtype)
            same(x, j)

    def test_zeros_ones_like(self):
        same(tensor.zeros((2, 2), device=DEV), np.zeros((2, 2)))
        same(tensor.ones((2, 2), device=DEV), np.ones((2, 2)))
        x = t(A)
        same(tensor.zeros_like(x), np.zeros_like(A))
        same(tensor.ones_like(x), np.ones_like(A))
        assert tensor.ones((2,), tensor.int32, DEV).dtype == torch.int32

    def test_astype(self):
        x = tensor.ones((2, 2), device=DEV)
        assert x.as_type(tensor.int32).dtype == torch.int32
        assert x.astype("bfloat16").dtype == torch.bfloat16
        assert x.as_type(np.float16).dtype == torch.float16

    def test_metadata(self):
        x = t(A)
        assert x.memsize() == A.nbytes and not x.is_empty()
        assert Tensor(shape=(0, 3), device=DEV).is_empty()
        assert not x.is_transpose() and x.ndim_() == 2 and len(x) == 3
        assert tensor.product((2, 3, 4)) == 24 and tensor.product(()) == 1
        assert tensor.sizeof(np.float32) == 4
        assert tensor.sizeof(tensor.bfloat16) == 2


class TestNumpyInterop:
    def test_copy_from_numpy_in_place(self):
        x = Tensor(shape=(2, 2), device=DEV)
        storage = x.data.data_ptr()
        x.copy_from_numpy(np.full((2, 2), 7.0, np.float32))
        np.testing.assert_array_equal(x.numpy(), 7.0)
        assert x.data.data_ptr() == storage

    def test_round_trips(self):
        a = np.random.randn(5).astype(np.float32)
        np.testing.assert_array_equal(tensor.to_numpy(t(a)), a)
        assert t(np.asarray(3.5, np.float32)).item() == 3.5
        assert t(A).tolist() == A.tolist()
        ts = tensor.from_raw_tensors([np.ones((2, 3), np.float32),
                                      np.zeros(4, np.float32)], DEV)
        assert [x.shape for x in ts] == [(2, 3), (4,)]
        np.testing.assert_array_equal(tensor.to_host_array(t(A)), A)
        host = tensor.to_host_tree({"a": t(A), "b": torch.ones(2)})
        np.testing.assert_array_equal(host["a"], A)
        np.testing.assert_array_equal(host["b"], [1.0, 1.0])

    def test_to_device_and_to_host(self):
        x = t(A)
        other = device.create_cpu_device()
        assert x.to_device(other) is x and x.device is other
        h = tensor.to_host(x)
        assert h.device is device.host_device() and h is not x
        same(h, A)


class TestMath:
    def test_operators_match_jax(self):
        a, b = np.array([1.0, 2.0], np.float32), np.array([3.0, 4.0],
                                                           np.float32)
        x, y, jx, jy = t(a), t(b), jt(a), jt(b)
        same(x + y, jx + jy)
        same(x - y, jx - jy)
        same(x * y, jx * jy)
        same(x / y, jx / jy)
        same(-x, -jx)
        same(x ** 2, jx ** 2)
        same(x + 1.0, jx + 1.0)
        same(1.0 + x, 1.0 + jx)
        same(5.0 - x, 5.0 - jx)
        same(2.0 * x, 2.0 * jx)
        same(1.0 / x, 1.0 / jx)
        for op in ("__lt__", "__le__", "__gt__", "__ge__"):
            got, want = getattr(x, op)(y), getattr(jx, op)(jy)
            assert got.dtype == torch.float32
            same(got, want)
        same(x < 1.5, jx < 1.5)

    def test_inplace_operators_write_in_place(self):
        """``+= -= *= /=`` write into the storage; a parameter stays the
        same leaf."""
        from singa_tpu_torch.autograd_base import register_param
        x = t(np.array([1.0, 2.0], np.float32))
        ptr = x.data.data_ptr()
        x += 1.0
        x *= 2.0
        x -= t(np.array([1.0, 1.0], np.float32))
        x /= 2.0
        np.testing.assert_array_equal(x.numpy(), [1.5, 2.5])
        assert x.data.data_ptr() == ptr
        p = Tensor(data=np.ones(3, np.float32), device=DEV,
                   requires_grad=True, stores_grad=True)
        register_param(p)
        leaf = p.data
        p += 2.0
        assert p.data is leaf and leaf.requires_grad
        np.testing.assert_array_equal(p.numpy(), [3.0, 3.0, 3.0])
        i = t(np.array([1, 2], np.int32))
        i /= 2.0          # a new dtype: rebound, as the JAX package does
        assert i.dtype == torch.float32

    def test_matmul_mult(self):
        x, y = t(A), t(B)
        same(tensor.mult(x, y), jtensor.mult(jt(A), jt(B)), rtol=1e-5)
        same(x @ y, A @ B, rtol=1e-5)
        C = t(np.ones((3, 5), np.float32))
        ptr = C.data.data_ptr()
        jC = jt(np.ones((3, 5), np.float32))
        tensor.mult(x, y, C, alpha=0.5, beta=2.0)
        jtensor.mult(jt(A), jt(B), jC, alpha=0.5, beta=2.0)
        same(C, jC, rtol=1e-5)
        assert C.data.data_ptr() == ptr

    def test_free_functions_match_jax(self):
        a = np.array([[1.0, -2.0], [3.0, 4.0]], np.float32)
        x, j = t(a), jt(a)
        assert tensor.sum(x) == jtensor.sum(j) == 6.0
        same(tensor.sum(x, axis=0), jtensor.sum(j, axis=0))
        assert tensor.average(x) == pytest.approx(jtensor.average(j))
        same(tensor.average(x, 1), jtensor.average(j, 1))
        same(tensor.softmax(x), jtensor.softmax(j))
        for name in ("abs", "exp", "ceil", "sign", "square", "tanh",
                     "sigmoid", "relu"):
            same(getattr(tensor, name)(x), getattr(jtensor, name)(j),
                 rtol=1e-6)
        pos = np.abs(a) + 0.5
        for name in ("log", "sqrt"):
            same(getattr(tensor, name)(t(pos)),
                 getattr(jtensor, name)(jt(pos)))
        same(tensor.pow(x, 2.0), jtensor.pow(j, 2.0))
        for name in ("lt", "le", "gt", "ge", "eq"):
            same(getattr(tensor, name)(x, 1.0),
                 getattr(jtensor, name)(j, 1.0))
        b = np.array([[0.5, 1.0], [2.0, -1.0]], np.float32)
        for name in ("add", "sub", "eltwise_mult", "div"):
            same(getattr(tensor, name)(x, t(b)),
                 getattr(jtensor, name)(j, jt(b)))
        out = Tensor(shape=(2, 2), device=DEV)
        assert tensor.add(x, t(b), out) is out
        same(out, a + b)
        o2 = Tensor(shape=(2, 2), device=DEV)
        assert tensor.sum(x, 0, o2) is o2
        same(o2[0], a.sum(0)[0])

    def test_axpy_and_row_column_helpers(self):
        x = t(np.array([1.0, 1.0], np.float32))
        y = t(np.array([1.0, 2.0], np.float32))
        ptr = y.data.data_ptr()
        tensor.axpy(2.0, x, y)
        np.testing.assert_array_equal(y.numpy(), [3, 4])
        assert y.data.data_ptr() == ptr
        M, jM = t(np.ones((2, 3), np.float32)), jt(np.ones((2, 3),
                                                          np.float32))
        v = np.array([1.0, 2.0, 3.0], np.float32)
        jv = jt(v)
        same(tensor.add_row(2.0, t(v), 0.5, M),
             jtensor.add_row(2.0, jv, 0.5, jM))
        c = np.array([1.0, -1.0], np.float32)
        same(tensor.add_column(1.5, t(c), 1.0, M),
             jtensor.add_column(1.5, jt(c), 1.0, jM))
        same(tensor.sum_rows(M), jtensor.sum_rows(jM))
        same(tensor.sum_columns(M), jtensor.sum_columns(jM))

    def test_einsum_tensordot_match_jax(self):
        same(tensor.einsum("ij,jk->ik", t(A), t(B)),
             jtensor.einsum("ij,jk->ik", jt(A), jt(B)), rtol=1e-5)
        same(tensor.einsum("ij->j", t(A)), jtensor.einsum("ij->j", jt(A)),
             rtol=1e-5)
        same(tensor.tensordot(t(A), t(B), axes=([1], [0])),
             jtensor.tensordot(jt(A), jt(B), axes=([1], [0])), rtol=1e-5)
        C = np.random.RandomState(2).randn(3, 4, 2).astype(np.float32)
        same(tensor.tensordot(t(A), t(C), axes=([0, 1], [0, 1])),
             jtensor.tensordot(jt(A), jt(C), axes=([0, 1], [0, 1])),
             rtol=1e-5)

    def test_norms(self):
        a = t(np.array([3.0, 4.0], np.float32))
        assert a.l2() == pytest.approx(jt(np.array([3.0, 4.0])).l2())
        assert a.l1() == pytest.approx(3.5)


class TestShape:
    def test_reshape_transpose_flatten_match_jax(self):
        a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        x, j = t(a), jt(a)
        same(x.reshape((4, 6)), j.reshape((4, 6)))
        same(x.transpose(), j.transpose())
        same(x.T(), j.T())
        same(x.transpose((1, 0, 2)), j.transpose((1, 0, 2)))
        same(tensor.transpose(x, (2, 0, 1)), jtensor.transpose(j, (2, 0, 1)))
        same(x.flatten(), j.flatten())
        same(tensor.reshape(x, (24,)), jtensor.reshape(j, (24,)))

    def test_repeat_is_numpys(self):
        """``repeat`` repeats each element (numpy's meaning), it does not
        tile."""
        a = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
        for reps, axis in ((2, 0), (3, 1), (2, None)):
            same(tensor.repeat(t(a), reps, axis),
                 jtensor.repeat(jt(a), reps, axis))
            same(t(a).repeat(reps, axis), np.repeat(a, reps, axis))
        same(t(a).repeat([1, 2], 0), np.repeat(a, [1, 2], 0))

    def test_getitem_concatenate(self):
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        x, j = t(a), jt(a)
        for key in (0, (slice(None), 1), (slice(0, 3, 2), slice(1, None)),
                    -1):
            same(x[key], j[key])
        same(tensor.concatenate([x, x], axis=1),
             jtensor.concatenate([j, j], axis=1))

    def test_new_tensors_are_not_views(self):
        """An in-place write to a tensor never shows in one made from it
        (a JAX array is never a view of another)."""
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        x = t(a)
        made = [x.clone(), x.reshape((3, 2)), x.transpose(), x[0],
                x.flatten(), x.deepcopy(), tensor.contiguous(x),
                x.as_type(np.float32)]
        before = [m.numpy().copy() for m in made]
        x += 100.0
        for m, b in zip(made, before):
            np.testing.assert_array_equal(m.numpy(), b)
        assert x.clone().name == x.name


class TestRandomFills:
    def test_gaussian_uniform_bernoulli_moments(self):
        x = Tensor(shape=(20000,), device=DEV)
        v = x.gaussian(1.0, 2.0).numpy()
        assert abs(v.mean() - 1.0) < 0.05 and abs(v.std() - 2.0) < 0.05
        v = x.uniform(-1.0, 1.0).numpy()
        assert v.min() >= -1.0 and v.max() <= 1.0 and abs(v.mean()) < 0.03
        v = tensor.bernoulli(0.3, x).numpy()
        assert set(np.unique(v)) <= {0.0, 1.0} and abs(v.mean() - 0.3) < 0.02
        v = tensor.gaussian(0.0, 0.5, x).numpy()
        assert abs(v.std() - 0.5) < 0.02
        v = tensor.uniform(2.0, 3.0, x).numpy()
        assert v.min() >= 2.0 and v.max() <= 3.0
        v = tensor.random((5000,), device=DEV).numpy()
        assert v.min() >= 0.0 and v.max() < 1.0

    def test_set_value_reset_like_copy_data(self):
        x = Tensor(shape=(2, 3), device=DEV)
        ptr = x.data.data_ptr()
        x.set_value(2.5)
        np.testing.assert_array_equal(x.numpy(), 2.5)
        x.copy_data(t(np.arange(6, dtype=np.float32)))
        np.testing.assert_array_equal(x.numpy().ravel(), np.arange(6))
        assert x.data.data_ptr() == ptr
        y = t(np.ones(4, np.float32))
        tensor.copy_data_to_from(y, t(np.array([7.0, 8.0], np.float32)), 2)
        np.testing.assert_array_equal(y.numpy(), [7, 8, 1, 1])
        x.reset_like(Tensor(shape=(4,), device=DEV, dtype=np.int32))
        assert x.shape == (4,) and x.dtype == torch.int32

    def test_seed_reproducible_and_global_generator_unread(self):
        def draw(seed):
            DEV.SetRandSeed(seed)
            torch.manual_seed(seed * 13)        # never read
            x = Tensor(shape=(10,), device=DEV)
            return x.gaussian(0, 1).numpy(), x.bernoulli(0.5).numpy()
        a, b = draw(7), draw(7)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert not np.array_equal(draw(8)[0], a[0])
        g = torch.Generator().manual_seed(3)
        x = Tensor(shape=(5,), device=DEV).uniform(generator=g)
        g.manual_seed(3)
        same(x, Tensor(shape=(5,), device=DEV).uniform(generator=g))


class TestDevice:
    def test_platform_and_factories(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert device.get_num_gpus() == device.Platform.GetNumGPUs() == 0
        assert device.device_query(0) == "no device 0"
        for make in (lambda: device.create_cuda_gpu_on(0),
                     lambda: device.create_cuda_gpus(1),
                     lambda: device.create_cuda_gpus_on([0])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        assert device.enable_lazy_alloc(True) is None

    def test_flags_sync_and_profile(self):
        d = device.create_cpu_device()
        assert (d.lang, d.verbosity, d.skip_iteration) == ("kCpp", 0, 5)
        d.EnableGraph(True)
        assert d.graph_enabled
        d.RunGraph()
        d.ResetGraph()
        d.Sync()
        d.SetSkipIteration(2)
        d.SetVerbosity(1)
        assert (d.skip_iteration, d.verbosity) == (2, 1)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            d.SetVerbosity(2)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            d.PrintTimeProfiling()
        assert "No time profiling data" in out.getvalue()
        d._record_time("train_one_batch", 0.25)
        d._record_time("train_one_batch", 0.75)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            d.PrintTimeProfiling()
        assert "train_one_batch" in out.getvalue() and \
            "500.000" in out.getvalue()
        d.ResetTimeProfiling()
        assert d.time_profiling == {}
        d.set_rand_seed(3)

    def test_model_records_steps_after_skip_iteration(self):
        """At verbosity 1 a model's train calls after ``skip_iteration``
        are timed as ``train_one_batch``, eager and in graph mode."""
        from singa_tpu_torch import layer, model, opt

        class Net(model.Model):
            def __init__(self):
                super().__init__()
                self.fc = layer.Linear(3)
                self.loss = layer.SoftMaxCrossEntropy()

            def forward(self, x):
                return self.fc(x)

            def train_one_batch(self, x, y):
                out = self.forward(x)
                loss = self.loss(out, y)
                self.optimizer(loss)
                return out, loss
        for graph in (False, True):
            d = device.create_cpu_device()
            d.SetVerbosity(1)
            d.SetSkipIteration(2)
            m = Net()
            m.set_optimizer(opt.SGD(lr=0.1))
            x = Tensor(data=A, device=d)
            y = Tensor(data=np.eye(3, dtype=np.float32)[[0, 1, 2]], device=d)
            m.compile([x], is_train=True, use_graph=graph)
            for _ in range(5):
                m(x, y)
            count, total = d.time_profiling["train_one_batch"]
            assert count == 3 and total > 0


class TestInitializers:
    SHAPES = [(400, 300), (64, 32, 3, 3)]

    @pytest.mark.parametrize("name", ["lecun_uniform", "lecun_normal",
                                      "glorot_uniform", "glorot_normal",
                                      "he_uniform", "he_normal", "xavier",
                                      "glorot", "msra"])
    def test_scaled_fillers_moments(self, name):
        """Each filler's standard deviation is the JAX package's rule's
        (``_compute_fans``), its mean 0, uniform ones inside their
        limit."""
        for shape in self.SHAPES:
            fan_in, fan_out = jinit._compute_fans(shape)
            scale, mode, dist = {
                "lecun_uniform": (1, fan_in, "u"),
                "lecun_normal": (1, fan_in, "n"),
                "glorot_uniform": (1, (fan_in + fan_out) / 2, "u"),
                "xavier": (1, (fan_in + fan_out) / 2, "u"),
                "glorot_normal": (1, (fan_in + fan_out) / 2, "n"),
                "glorot": (1, (fan_in + fan_out) / 2, "n"),
                "he_uniform": (2, fan_in, "u"),
                "he_normal": (2, fan_in, "n"),
                "msra": (2, fan_in, "n")}[name]
            std = np.sqrt(scale / mode)
            assert initializer._compute_fans(shape) == (fan_in, fan_out)
            x = Tensor(shape=shape, device=DEV)
            v = getattr(initializer, name)(x).numpy()
            assert abs(v.std() / std - 1) < 0.03, (shape, v.std(), std)
            assert abs(v.mean()) < 0.03 * std
            if dist == "u":
                assert np.abs(v).max() <= np.sqrt(3) * std + 1e-6

    @pytest.mark.parametrize("fans", [(30, 20), (50, 0), (0, 8)])
    def test_reference_gaussian_and_uniform(self, fans):
        x = Tensor(shape=(200, 100), device=DEV)
        x_in, x_out = fans
        avg, n = (1, x_in + x_out) if x_in * x_out else (2, max(fans))
        std = np.sqrt(avg / n)
        v = initializer.gaussian(x, *fans).numpy()
        assert abs(v.std() / std - 1) < 0.03
        v = initializer.uniform(x, *fans).numpy()
        assert abs(v.std() / std - 1) < 0.03
        assert np.abs(v).max() <= np.sqrt(3) * std + 1e-6

    def test_eye_and_orthogonal_match_jax_structure(self):
        for shape in ((4, 6), (6, 4), (5, 5)):
            x = Tensor(shape=shape, device=DEV)
            j = jtensor.Tensor(shape=shape, device=JDEV)
            same(initializer.eye(x), jinit.eye(j))
            q = initializer.orthogonal(Tensor(shape=shape, device=DEV))
            q = q.numpy()
            small = min(shape)
            gram = q.T @ q if shape[0] >= shape[1] else q @ q.T
            np.testing.assert_allclose(gram, np.eye(small), atol=1e-5)
        with pytest.raises(ValueError):
            initializer.eye(Tensor(shape=(2, 2, 2), device=DEV))

    def test_same_seed_same_draw_and_explicit_generator(self):
        for name in ("he_normal", "glorot_uniform", "orthogonal"):
            fn = getattr(initializer, name)
            DEV.SetRandSeed(11)
            a = fn(Tensor(shape=(8, 8), device=DEV)).numpy()
            DEV.SetRandSeed(11)
            b = fn(Tensor(shape=(8, 8), device=DEV)).numpy()
            np.testing.assert_array_equal(a, b)
            g = torch.Generator().manual_seed(5)
            c = fn(Tensor(shape=(8, 8), device=DEV), generator=g).numpy()
            g.manual_seed(5)
            d = fn(Tensor(shape=(8, 8), device=DEV), generator=g).numpy()
            np.testing.assert_array_equal(c, d)
            assert not np.array_equal(a, c)
