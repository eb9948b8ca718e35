"""What the port's LM-on-a-mesh tests share: the data and the seeded
weights, the inputs of ``tests/torch_dist_ranks.py``'s ``lm_mesh`` case,
the JAX package's runs of the same meshes and the port's dense run.

The shapes are ``tests/test_transformer.py``'s: d_model 32, 2 heads, 2
layers, max_len 64, vocab 31 (32 where the vocab ends shard), B8 S16,
``SGD(lr=0.3, momentum=0.9)``, 8 steps. The weights come from a numpy
seed and are carried into both packages by name. The JAX runs go over
the first devices of the 8-device CPU mesh (``tests/conftest.py``), a
``DistOpt`` with the mesh set, as ``tests/test_transformer.py::train``
builds them; each is made once per process (``jax_run``).
"""

from __future__ import annotations

import numpy as np

import torch_dist_ranks as ranks

VOCABS = (31, 32)
STEPS = ranks.LM_STEPS
_JAX = {}
_DENSE = {}


def lm_data(vocab, B=8, S=16, seed=0):
    """``tests/test_transformer.py::lm_data``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.float32)
    return ids, np.roll(ids, -1, axis=1)


def seeded(vocab, seed=11, **kw):
    """Every state of the LM of ``vocab`` (and ``kw``: ``moe``,
    ``d_model``), by name, from a numpy seed."""
    from singa_tpu_torch import device, tensor
    dev = device.create_cpu_device()
    m = ranks._lm_model(vocab, **kw)
    m(tensor.Tensor(data=lm_data(vocab)[0], device=dev))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(m.get_states().items()):
        shape = tuple(v.shape)
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "W":
            a = rng.randn(*shape) * np.sqrt(1.0 / shape[0])
        elif leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


def inputs(runs, workdir):
    """The ``lm_mesh`` case's inputs for the ``LM_RUNS`` named."""
    out = {"workdir": np.asarray(str(workdir)), "runs": np.asarray(runs)}
    for v in VOCABS:
        out[f"ids{v}"], out[f"tgt{v}"] = lm_data(v)
    for name in runs:
        run = ranks.LM_RUNS[name]
        prefix = ranks.init_prefix(run)
        if not any(k.startswith(prefix) for k in out):
            for k, a in seeded(run["vocab"], **_model_kw(run)).items():
                out[f"{prefix}{k}"] = a
    return out


def _model_kw(run):
    """The settings of ``run`` that make other states: the experts and
    the width."""
    return {k: run[k] for k in ("moe", "d_model") if k in run}


def _cfg(name):
    cfg = dict(ranks.LM_RUNS[name])
    vocab = cfg.pop("vocab")
    degrees = {a: cfg.pop(a) for a in ("model", "seq", "expert")
               if a in cfg}
    return vocab, degrees, cfg


def jax_run(name):
    """Losses, states and optimizer states of the JAX package's run of
    ``LM_RUNS[name]`` (``tests/test_transformer.py::train`` from the
    seeded weights), without remat."""
    if name in _JAX:
        return _JAX[name]
    import jax
    from jax.sharding import PartitionSpec as JP
    from singa_tpu import device, opt, tensor
    from singa_tpu.models import transformer
    from singa_tpu.parallel import mesh as mesh_mod
    from singa_tpu.parallel.communicator import set_mesh
    vocab, degrees, cfg = _cfg(name)
    # rematerialisation leaves every value as it is; the JAX package's
    # remat of a ring-attention block fails in its backward (ROADMAP.md
    # Queue 3), so its run of a remat mesh is the plain one
    cfg.pop("remat", None)
    seq = "seq_axis" in cfg
    ep = "expert" in degrees
    dev = device.create_cpu_device()
    dev.SetRandSeed(5)
    ids, tgt = lm_data(vocab)
    tx = tensor.Tensor(data=ids, device=dev, requires_grad=False)
    ty = tensor.Tensor(data=tgt, device=dev, requires_grad=False)
    m = transformer.TransformerLM(vocab, tp=True,
                                  **dict(ranks.LM_KW, **cfg))
    d = opt.DistOpt(opt.SGD(lr=0.3, momentum=0.9),
                    reduce_axes=("data", "seq") if seq else
                    ("data", "expert") if ep else None)
    msh = mesh_mod.make_mesh(jax.devices("cpu"),
                             mesh_mod.MeshConfig(**degrees))
    d.communicator.mesh = msh
    set_mesh(msh)
    m.set_optimizer(d)
    if seq:
        m.input_specs = [JP("data", "seq"), JP("data", "seq")]
        m.output_specs = [JP("data", "seq"), JP()]
    if ep:
        m.input_specs = [JP(("data", "expert")), JP(("data", "expert"))]
    try:
        m.compile([tx], is_train=True, use_graph=True)
        live = m.get_states()
        for k, v in seeded(vocab, **_model_kw(cfg)).items():
            live[k].copy_from_numpy(v)
        losses = [float(np.asarray(m(tx, ty)[1].data)) for _ in range(STEPS)]
        states = {k: np.asarray(v.data) for k, v in m.get_states().items()}
        ostates = {k: np.asarray(v) for k, v in
                   m.optimizer.get_states().items()}
    finally:
        set_mesh(None)
    _JAX[name] = dict(losses=np.asarray(losses), states=states,
                      ostates=ostates, model=m)
    return _JAX[name]


def dense_run(name):
    """Losses and states of the port's run of ``LM_RUNS[name]``'s model
    on one process, no mesh: the same global batch, weights and SGD."""
    vocab, _degrees, cfg = _cfg(name)
    cfg.pop("seq_axis", None)
    cfg.pop("seq_mode", None)
    key = (vocab, tuple(sorted(cfg.items())))
    if key in _DENSE:
        return _DENSE[key]
    from singa_tpu_torch import device, opt, tensor
    from singa_tpu_torch.model import load_numpy_states
    dev = device.create_cpu_device()
    ids, tgt = lm_data(vocab)
    tx = tensor.Tensor(data=ids, device=dev)
    ty = tensor.Tensor(data=tgt, device=dev)
    m = ranks._lm_model(vocab, **cfg)
    m.set_optimizer(opt.SGD(lr=0.3, momentum=0.9))
    m.compile([tx], is_train=True, use_graph=True)
    load_numpy_states(m, seeded(vocab, **_model_kw(cfg)))
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(STEPS)]
    states = {k: np.array(v.to_numpy()) for k, v in m.get_states().items()}
    m.eval()
    _DENSE[key] = dict(losses=np.asarray(losses), states=states, model=m)
    return _DENSE[key]


def close(got, want, tol, what):
    """``|got - want| <= tol * |want|`` (Frobenius)."""
    got = np.asarray(got, np.float64)
    err = float(np.linalg.norm(got - want))
    assert err <= tol * float(np.linalg.norm(want)) + 1e-7, \
        f"{what}: |got - want| = {err:.3g}, |want| = " \
        f"{float(np.linalg.norm(want)):.3g}"


EXAMPLE_ARGV = ["--cpu", "--bs", "4", "--seq", "16", "--d-model", "32",
                "--heads", "2", "--layers", "2", "--vocab", "32", "--steps",
                "3", "--generate", "2"]


def example_one_process(capsys):
    """``train_transformer.main`` with ``EXAMPLE_ARGV`` in this process:
    its training losses (``Model.__call__`` recorded), the model, and what
    it printed."""
    import runpy
    from singa_tpu_torch import model as model_mod
    from pathlib import Path
    script = Path(ranks.ROOT) / "singa_tpu_torch" / "examples" / \
        "train_transformer.py"
    main = runpy.run_path(str(script), run_name="train_transformer")["main"]
    losses = []
    call = model_mod.Model.__call__

    def recorded(self, *a, **kw):
        result = call(self, *a, **kw)
        if self._train:
            losses.append(float(result[1].data.detach()))
        return result

    model_mod.Model.__call__ = recorded
    try:
        m = main(EXAMPLE_ARGV)
    finally:
        model_mod.Model.__call__ = call
    return np.asarray(losses), m, capsys.readouterr().out


def example_ranks(flag, tmp_path):
    """The same run under torchrun's variables at two ranks with
    ``flag 2`` (``--tp`` or ``--sp``)."""
    outs, logs = ranks.launch(
        "example", 2, {"script": np.asarray("train_transformer"),
                       "argv": np.asarray(EXAMPLE_ARGV + [flag, "2"])},
        tmp_path, torchrun_env=True)
    return outs, logs
