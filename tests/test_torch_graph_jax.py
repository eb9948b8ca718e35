"""Graph mode (``Model.compile(use_graph=True)``) held against the JAX
package's compiled step, on the setups and within the bounds of the files
that hold the eager port against it:

- ``test_torch_resnet_training.py``: a ResNet(Bottleneck, [1, 1, 1, 1]) at
  224 px, batch 2, the same numpy weights and batch, ``SGD(lr=0.1,
  momentum=0.9, weight_decay=1e-5, fused=True)``, the JAX package's Pallas
  kernel in interpret mode and the port's plain version on the CPU;
  losses within rtol 1e-3 / atol 1e-4, states within 5e-3 and momenta
  within 5e-2 of their norms;
- ``test_torch_transformer.py``: the small LM, ``SGD(lr=0.1,
  momentum=0.9)``, the JAX package's flash kernels in interpret mode;
  losses within rtol 1e-5, states and momenta within 1e-4 of their norms.

On the CPU a ``StepGraph`` runs the step on its static buffers; a fresh
pair of input Tensors each step goes through the copy into them. These
have a file of their own, apart from ``test_torch_graph_mode.py``, because
the JAX package's compiles take most of their time (the ResNet's about a
minute on one core).
"""

import numpy as np

from test_torch_graph_mode import LM, _lm_batches, _lm_kw, _port
from test_torch_resnet_training import (  # noqa: F401 (the fixture)
    ATOL, MOMENTUM_TOL, RTOL, STATE_TOL, STEPS, _batch, _close, _jax_run,
    _port_eval_after, _port_model)

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtransformer
from singa_tpu.ops import attention_mod as JA

from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.model import load_numpy_states


def test_graphed_resnet_matches_the_compiled_jax_step(tmp_path_factory):
    """4 steps on one batch (the JAX run's 3, its save, and a 4th)."""
    ref = _jax_run("NCHW", tmp_path_factory)
    x, y = _batch()
    m, dev = _port_model("NCHW", x)
    assert m.graph_mode
    load_numpy_states(m, ref["init"])
    losses = []
    for step in range(1, STEPS + 2):
        _, loss = m(ttensor.Tensor(data=x.copy(), device=dev),
                    ttensor.Tensor(data=y.copy(), device=dev))
        losses.append(float(loss.data.detach()))
        if step == STEPS:
            states = {k: v.to_numpy().copy()
                      for k, v in m.get_states().items()}
            # copies: on the CPU to_numpy shares the live tensors' memory
            ostates = {k: np.array(v)
                       for k, v in m.optimizer.get_states().items()}
    assert [s for s in m.graph_stats().values()] == [
        {"n_captures": 1, "n_replays": STEPS}]
    np.testing.assert_allclose(losses, ref["losses"], rtol=RTOL, atol=ATOL)
    assert sorted(states) == sorted(ref["states"])
    for k, want in ref["states"].items():
        _close(states[k], want, STATE_TOL, k)
    assert sorted(ostates) == sorted(ref["ostates"])
    assert float(ostates["step_counter"]) == STEPS
    for k, want in ref["ostates"].items():
        _close(np.asarray(ostates[k]), want, MOMENTUM_TOL, k)


def test_graphed_lm_matches_the_compiled_jax_step():
    """3 steps on one batch."""
    ids, tgt = _lm_batches(1)[0]
    m, dev = _port("lm", topt.SGD(lr=0.1, momentum=0.9), True)
    init = {k: v.to_numpy().copy() for k, v in m.get_states().items()}
    tx, ty = (ttensor.Tensor(data=a, device=dev) for a in (ids, tgt))
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(3)]
    assert [s for s in m.graph_stats().values()] == [
        {"n_captures": 1, "n_replays": 2}]
    prev = JA.FORCE_PALLAS_INTERPRET
    JA.FORCE_PALLAS_INTERPRET = True
    try:
        jdev = jdevice.create_cpu_device()
        jm = jtransformer.TransformerLM(LM["vocab"], **_lm_kw())
        jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
        jx, jy = (jtensor.Tensor(data=a, device=jdev, requires_grad=False)
                  for a in (ids, tgt))
        jm.compile([jx], is_train=True, use_graph=True)
        live = jm.get_states()
        for k, v in init.items():
            live[k].copy_from_numpy(v)
        want = [float(np.asarray(jm(jx, jy)[1].data)) for _ in range(3)]
        jstates = {k: np.asarray(v.data) for k, v in jm.get_states().items()}
        jstates.update({f"optimizer/{k}": np.asarray(v) for k, v in
                        jm.optimizer.get_states().items()})
    finally:
        JA.FORCE_PALLAS_INTERPRET = prev
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    mine = {k: v.to_numpy() for k, v in m.get_states().items()}
    mine.update({f"optimizer/{k}": np.asarray(v) for k, v in
                 m.optimizer.get_states().items()})
    assert sorted(mine) == sorted(jstates)
    for k, w in jstates.items():
        _close(mine[k], w, 1e-4, k)
