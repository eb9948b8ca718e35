"""The port's stateless serving engine (``singa_tpu_torch/serving``): the
background loop, stop, admission and its typed rejections, deadlines, a
tick that fails, the counters the engine keeps, and ``build_engine``'s
declines. A one-layer model on the CPU keeps every case fast; the ResNet
path through the same engine is ``tests/test_torch_resnet_serving.py``."""

import time

import numpy as np
import pytest

from singa_tpu_torch import device, layer, model
from singa_tpu_torch.observability.metrics import Registry
from singa_tpu_torch.serving import scheduler

SHAPE = (3,)


class Tiny(model.Model):
    def __init__(self):
        super().__init__()
        self.fc = layer.Linear(4)
        self.fail = False

    def forward(self, x):
        if self.fail:
            raise RuntimeError("injected forward failure")
        return self.fc(x)


def _engine(batch=2, capacity=8, policy=None):
    m = Tiny()
    m.eval()
    reg = Registry()
    eng = m.compile_serving(input_shape=SHAPE, batch=batch,
                            device=device.create_cpu_device(),
                            queue_capacity=capacity, registry=reg,
                            policy=policy)
    return m, eng, reg


def _expected(m, xs):
    w = m.fc.W.to_numpy()
    b = m.fc.b.to_numpy()
    return np.stack(xs) @ w + b


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(n)]


def _outcome(reg, status):
    return reg.counter("serve_requests_total", labels=("status",)) \
        .value(status=status)


def test_background_loop_serves_then_stop_rejects():
    m, eng, reg = _engine()
    xs = _inputs(5)
    eng.start()
    try:
        futs = [eng.submit(x) for x in xs]
        got = np.stack([f.result(timeout=30) for f in futs])
    finally:
        eng.stop()
    np.testing.assert_allclose(got, _expected(m, xs), rtol=1e-6, atol=1e-6)
    assert eng.ticks >= 3                       # 5 requests at batch 2
    with pytest.raises(scheduler.EngineDraining):
        eng.submit(xs[0])
    assert _outcome(reg, "completed") == 5
    assert _outcome(reg, "rejected") == 1
    assert eng.ttft_stats()["count"] == 5
    assert eng.tick_stats()["count"] == eng.ticks
    assert reg.gauge("serve_queue_depth").value() == 0


def test_step_refused_while_the_loop_runs():
    _, eng, _ = _engine()
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="synchronous"):
            eng.step()
    finally:
        eng.stop()


def test_full_queue_and_wrong_shape_are_rejected_and_counted():
    _, eng, reg = _engine(capacity=2)
    xs = _inputs(3)
    eng.submit(xs[0])
    eng.submit(xs[1])
    with pytest.raises(scheduler.QueueFull):
        eng.submit(xs[2])
    with pytest.raises(scheduler.ServingError, match="input shape"):
        eng.submit(np.zeros((4,), np.float32))
    assert _outcome(reg, "rejected") == 2
    assert eng.run_until_idle() == 1
    assert _outcome(reg, "completed") == 2


def test_stop_fails_what_is_still_queued():
    _, eng, reg = _engine()
    futs = [eng.submit(x) for x in _inputs(3)]
    assert eng.stop() == 3
    for f in futs:
        with pytest.raises(scheduler.EngineDraining):
            f.result(timeout=1)
    assert _outcome(reg, "failed") == 3


def test_expired_request_times_out_without_a_row():
    m, eng, reg = _engine()
    xs = _inputs(2)
    late = eng.submit(xs[0], timeout=0.0)
    time.sleep(0.01)
    ok = eng.submit(xs[1])
    eng.run_until_idle()
    with pytest.raises(scheduler.RequestTimeout):
        late.result(timeout=1)
    np.testing.assert_allclose(ok.result(), _expected(m, [xs[1]])[0],
                               rtol=1e-6, atol=1e-6)
    assert _outcome(reg, "timed_out") == 1


def test_failed_tick_fails_its_batch_and_crashes_the_loop():
    m, eng, reg = _engine()
    m.fail = True
    eng.start()
    try:
        fut = eng.submit(_inputs(1)[0])
        with pytest.raises(scheduler.ReplicaCrashed):
            fut.result(timeout=30)
        deadline = time.monotonic() + 30
        while eng._crashed is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(scheduler.ReplicaCrashed):
            eng.submit(_inputs(1)[0])
    finally:
        eng.stop()
    assert _outcome(reg, "failed") == 1
    assert fut.deliveries == 1


def test_bf16_mixed_policy_serves_f32_logits():
    m, eng, _ = _engine(policy="bf16_mixed")
    xs = _inputs(2)
    futs = [eng.submit(x) for x in xs]
    eng.run_until_idle()
    got = np.stack([f.result() for f in futs])
    assert got.dtype == np.float32
    # bf16 operands keep 8 significant bits
    np.testing.assert_allclose(got, _expected(m, xs), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kw,err", [
    ({"input_shape": SHAPE, "faults": object()}, NotImplementedError),
    ({"input_shape": SHAPE, "policy": "int8_weight_only"},
     NotImplementedError),
    ({}, TypeError),
    ({"input_shape": SHAPE, "slots": 4}, TypeError),
])
def test_build_engine_declines(kw, err):
    m = Tiny()
    with pytest.raises(err):
        m.compile_serving(device=device.create_cpu_device(), **kw)


def test_autoregressive_models_are_not_ported_yet():
    """Autoregressive serving is ported (``tests/test_torch_lm_serving.py``);
    what it leaves to later slices still raises naming ROADMAP.md, before
    the model's ``decode_adapter`` is asked for: the options of slice D2
    (sharded serving, the spill tier, KV snapshots) and of slice E (fault
    injection, telemetry, profiled ticks, AOT)."""
    m = Tiny()
    m.decode_adapter = object()
    for option in ("mesh", "model_shards", "spill_bytes", "snapshot_every",
                   "faults", "max_retries", "telemetry_dir",
                   "trace_requests", "profile_every", "aot_store"):
        with pytest.raises(NotImplementedError, match="ROADMAP.*slice"):
            m.compile_serving(slots=2, **{option: 1})
