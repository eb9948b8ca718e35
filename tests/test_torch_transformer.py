"""The port's Transformer LM slice as a whole, held against the JAX package.

A ``TransformerLM`` (vocab 64, d_model 32, 2 layers, max_len 32) built in
``singa_tpu`` and one built in ``singa_tpu_torch`` get the same weights,
made with numpy from a seed and carried across by ``load_numpy_states``,
and the same batch of 2 sequences of 32 token ids. The JAX package runs
with ``FORCE_PALLAS_INTERPRET = True``, so its attention goes through the
Pallas kernels K3/K4 in interpret mode; the port runs on the CPU, where
the kernels' plain versions stand in. Both run f32, and both train with
the JAX package's LM optimizer, ``SGD(lr=0.1, momentum=0.9)``.

Tolerances, each from the order of f32 sums (XLA's dots and the Pallas
kernels' per-block accumulation against PyTorch's matmuls and the
scan): eval logits within 1e-5 of the largest |logit|; per-step losses
within rtol 1e-5; every parameter and momentum after 3 steps within 1e-4
of its norm (Frobenius, ``|got - want| <= tol * |want|``). Under
``compute_dtype=bfloat16`` the stack computes in bf16 and the two
frameworks round at different points, so the forward is held within 5e-2
of the largest |logit|.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtransformer
from singa_tpu.ops import attention_mod as JA

from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.autograd_base import CTX as TCTX
from singa_tpu_torch.model import load_numpy_states
from singa_tpu_torch.models import transformer as ttransformer
from singa_tpu_torch.ops import attention as TA

VOCAB, D_MODEL, LAYERS, B, S = 64, 32, 2, 2, 32
STEPS = 3
LOGIT_TOL, LOSS_RTOL, STATE_TOL, BF16_TOL = 1e-5, 1e-5, 1e-4, 5e-2
SCRIPT = Path(__file__).resolve().parents[1] / "singa_tpu_torch" / \
    "examples" / "train_transformer.py"

_JAX = {}


@pytest.fixture(autouse=True)
def _eval_after():
    yield
    TCTX.training = False


def _data(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, S)).astype(np.float32)
    return ids, np.roll(ids, -1, axis=1)


def _states_from_seed(names_shapes, seed=11):
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in names_shapes:
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "W":
            v = rng.randn(*shape) * np.sqrt(1.0 / shape[0])
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.randn(*shape) * 0.1
        out[k] = v.astype(np.float32)
    return out


def _kw(heads, chunk, bf16=False, torch_side=True):
    dt = (torch.bfloat16 if torch_side else jnp.bfloat16) if bf16 else None
    return dict(d_model=D_MODEL, n_heads=heads, n_layers=LAYERS, max_len=S,
                tp=False, fused_head_chunk=chunk, compute_dtype=dt)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    err = float(np.linalg.norm(got - want))
    assert err <= tol * float(np.linalg.norm(want)) + 1e-7, \
        f"{what}: |got - want| = {err:.3g}, |want| = " \
        f"{float(np.linalg.norm(want)):.3g}"


def _jax_model(heads, chunk, bf16=False, train=True):
    dev = jdevice.create_cpu_device()
    ids, _ = _data()
    m = jtransformer.TransformerLM(VOCAB, **_kw(heads, chunk, bf16, False))
    m.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    m.compile([jtensor.Tensor(data=ids, device=dev, requires_grad=False)],
              is_train=train, use_graph=True)
    return m, dev


def _jax_run(heads, chunk, tmp_path_factory):
    """Eval logits, per-step losses, states and optimizer states after
    ``STEPS`` steps, and a save_states zip; built once per setting."""
    key = (heads, chunk)
    if key in _JAX:
        return _JAX[key]
    ids, tgt = _data()
    prev = JA.FORCE_PALLAS_INTERPRET
    JA.FORCE_PALLAS_INTERPRET = True
    try:
        m, dev = _jax_model(heads, chunk)
        live = m.get_states()
        init = _states_from_seed(sorted((k, tuple(v.shape))
                                        for k, v in live.items()))
        for k, v in init.items():
            live[k].copy_from_numpy(v)
        tx = jtensor.Tensor(data=ids, device=dev, requires_grad=False)
        ty = jtensor.Tensor(data=tgt, device=dev, requires_grad=False)
        m.eval()
        logits = np.asarray(m(tx).data)
        m.train()
        losses = [float(np.asarray(m(tx, ty)[1].data)) for _ in range(STEPS)]
        states = {k: np.asarray(v.data) for k, v in m.get_states().items()}
        ostates = {k: np.asarray(v) for k, v in
                   m.optimizer.get_states().items()}
        zpath = tmp_path_factory.mktemp("jax-lm") / f"lm-{heads}-{chunk}.zip"
        m.save_states(str(zpath))
    finally:
        JA.FORCE_PALLAS_INTERPRET = prev
    _JAX[key] = dict(init=init, logits=logits, losses=losses, states=states,
                     ostates=ostates, zip=zpath)
    return _JAX[key]


def _port_model(heads, chunk, bf16=False, optimizer=None):
    dev = tdevice.create_cpu_device()
    ids, _ = _data()
    m = ttransformer.TransformerLM(VOCAB, **_kw(heads, chunk, bf16))
    m.set_optimizer(optimizer or topt.SGD(lr=0.1, momentum=0.9))
    m.compile([ttensor.Tensor(data=ids, device=dev)], is_train=True,
              use_graph=True)
    return m, dev


def _port_tensors(dev):
    ids, tgt = _data()
    return (ttensor.Tensor(data=ids, device=dev),
            ttensor.Tensor(data=tgt, device=dev))


def test_state_names_and_shapes_match_the_jax_package(tmp_path_factory):
    ref = _jax_run(2, None, tmp_path_factory)
    tm, _ = _port_model(2, None)
    js = {k: tuple(v.shape) for k, v in ref["states"].items()}
    ts = {k: tuple(v.shape) for k, v in tm.get_states().items()}
    assert ts == js
    assert len(ts) == 16 * LAYERS + 6
    assert "TransformerLM.blocks.1.attn.q_proj.W" in ts
    assert "TransformerLM.blocks.0.mlp.up.W" in ts
    assert "TransformerLM.tok_emb.W" in ts


@pytest.mark.parametrize("heads,chunk", [(2, None), (4, 24)],
                         ids=["heads-2", "heads-4"])
def test_eval_logits_match(heads, chunk, tmp_path_factory):
    """The eval forward (full logits whatever the training loss path)."""
    ref = _jax_run(heads, chunk, tmp_path_factory)
    m, dev = _port_model(heads, chunk)
    load_numpy_states(m, ref["init"])
    m.eval()
    tx, _ = _port_tensors(dev)
    TA.reset_counts()
    got = m(tx).to_numpy()
    assert got.shape == (B, S, VOCAB)
    assert TA.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}      # the plain version
    scale = float(np.abs(ref["logits"]).max())
    assert float(np.abs(got - ref["logits"]).max()) <= LOGIT_TOL * scale


@pytest.mark.parametrize("heads,chunk", [(2, None), (2, 16), (4, 24)],
                         ids=["full-logits", "fused-16", "fused-24"])
def test_three_sgd_steps_match(heads, chunk, tmp_path_factory):
    """Both loss paths: full logits + one-hot + softmax CE, and the fused
    chunked CE head (16 divides the vocab; 24 does not, so the last chunk
    is padded)."""
    ref = _jax_run(heads, chunk, tmp_path_factory)
    m, dev = _port_model(heads, chunk)
    load_numpy_states(m, ref["init"])
    m.train()
    tx, ty = _port_tensors(dev)
    losses = [float(m(tx, ty)[1].data.detach()) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    for k, v in m.get_states().items():
        _close(v.to_numpy(), ref["states"][k], STATE_TOL, k)
    ostates = m.optimizer.get_states()
    assert sorted(ostates) == sorted(ref["ostates"])
    for k, v in ostates.items():
        _close(v, ref["ostates"][k], STATE_TOL, f"optimizer/{k}")


def test_bf16_forward_matches():
    """``compute_dtype=bfloat16``: the stack's parameters are bf16, the
    embeddings f32, and the logits agree with the JAX package's."""
    jm, jdev = _jax_model(2, None, bf16=True, train=False)
    init = _states_from_seed(sorted((k, tuple(v.shape))
                                    for k, v in jm.get_states().items()))
    for k, v in jm.get_states().items():
        v.copy_from_numpy(init[k])
    ids, _ = _data()
    prev = JA.FORCE_PALLAS_INTERPRET
    JA.FORCE_PALLAS_INTERPRET = True
    try:
        want = np.asarray(jnp.asarray(jm(jtensor.Tensor(
            data=ids, device=jdev, requires_grad=False)).data, jnp.float32))
    finally:
        JA.FORCE_PALLAS_INTERPRET = prev
    tm, dev = _port_model(2, None, bf16=True)
    load_numpy_states(tm, init)
    tm.eval()
    got = tm(_port_tensors(dev)[0])
    assert got.dtype == torch.bfloat16
    assert tm.blocks[0].attn.q_proj.W.dtype == torch.bfloat16
    assert tm.blocks[0].mlp.up.W.dtype == torch.bfloat16
    assert tm.tok_emb.W.dtype == torch.float32
    assert tm.blocks[0].ln1.scale.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got.to_numpy() - want).max()) <= BF16_TOL * scale


@pytest.mark.parametrize("chunk", [None, 16])
def test_bf16_training_runs(chunk):
    tm, dev = _port_model(2, chunk, bf16=True)
    tm.train()
    tx, ty = _port_tensors(dev)
    losses = [float(tm(tx, ty)[1].data.detach()) for _ in range(3)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    mom = tm.optimizer.get_states()
    assert any(k.endswith("q_proj.W:momentum") for k in mom)


def test_checkpoints_cross_the_packages_both_ways(tmp_path,
                                                  tmp_path_factory):
    """The JAX package's ``save_states`` zip (after 3 steps, with the
    momenta) loads into the port, and the port's loads back into the JAX
    package: the same states, the same next-step loss."""
    ref = _jax_run(2, None, tmp_path_factory)
    m, dev = _port_model(2, None)
    m.load_states(str(ref["zip"]))
    for k, v in m.get_states().items():
        np.testing.assert_array_equal(v.to_numpy(), ref["states"][k])
    for k, v in m.optimizer.get_states().items():
        np.testing.assert_array_equal(v, ref["ostates"][k])

    path = tmp_path / "port.zip"
    m.save_states(str(path))
    prev = JA.FORCE_PALLAS_INTERPRET
    JA.FORCE_PALLAS_INTERPRET = True
    try:
        jm, jdev = _jax_model(2, None)
        jm.load_states(str(path))
        for k, v in jm.get_states().items():
            np.testing.assert_array_equal(np.asarray(v.data),
                                          ref["states"][k])
        ids, tgt = _data()
        jloss = float(np.asarray(jm(
            jtensor.Tensor(data=ids, device=jdev, requires_grad=False),
            jtensor.Tensor(data=tgt, device=jdev, requires_grad=False))[1]
            .data))
    finally:
        JA.FORCE_PALLAS_INTERPRET = prev
    m.train()
    tx, ty = _port_tensors(dev)
    loss = float(m(tx, ty)[1].data.detach())
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)


def _tiny_pair(**kw):
    """A port and a JAX ``TransformerLM`` of the small settings with
    ``kw``, the same seeded weights, and the batch as both packages'
    Tensors."""
    ids, _ = _data()
    tdev, jdev = tdevice.create_cpu_device(), jdevice.create_cpu_device()
    tx = ttensor.Tensor(data=ids, device=tdev)
    jx = jtensor.Tensor(data=ids, device=jdev, requires_grad=False)
    tm = ttransformer.TransformerLM(VOCAB, **_kw(2, None), **kw)
    jm = jtransformer.TransformerLM(VOCAB, **_kw(2, None, torch_side=False),
                                    **kw)
    tm(tx)
    jm(jx)
    init = _states_from_seed(sorted((k, tuple(v.shape))
                                    for k, v in tm.get_states().items()))
    load_numpy_states(tm, init)
    for k, t in jm.get_states().items():
        t.copy_from_numpy(init[k])
    return tm, jm, tx, jx


@pytest.mark.parametrize("kw", [dict(remat=True), dict(moe=2),
                                dict(seq_axis="seq")], ids=str)
def test_what_is_not_ported_names_the_roadmap(kw):
    """Each of these was once refused naming ROADMAP.md and is ported now:
    ``remat`` (its training runs: ``tests/test_torch_remat.py``),
    ``seq_axis`` (``tests/test_torch_lm_sp.py``, ring and Ulysses over a
    mesh) and ``moe`` (``tests/test_torch_lm_moe.py``: the MoE FFN of
    ``parallel/moe.py``); each case is a tiny eval forward against the JAX
    package's model of the same settings and weights (outside an active
    mesh axis ``seq_axis`` is plain flash attention in both, and the MoE
    FFN the dense one), within ``LOGIT_TOL`` of the largest |logit|."""
    tm, jm, tx, jx = _tiny_pair(**kw)
    got, want = tm(tx).to_numpy(), np.asarray(jm(jx).data)
    assert got.shape == (B, S, VOCAB)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= LOGIT_TOL * scale


def test_generate_and_decode_adapter_name_the_roadmap():
    """``decode_adapter`` (LM serving, slice D) is still refused naming
    ROADMAP.md. ``generate`` is ported (``tests/test_torch_decode.py``):
    here a tiny greedy decode equals the JAX package's from the same
    weights."""
    tm, jm, _, _ = _tiny_pair()
    prompt = _data()[0][:, :6]
    np.testing.assert_array_equal(tm.generate(prompt, 3, temperature=0),
                                  jm.generate(prompt, 3, temperature=0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.decode_adapter()


@pytest.fixture
def example():
    spec = importlib.util.spec_from_file_location("port_train_transformer",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--fused-head-chunk", "24", "--bf16"]],
                         ids=["full-logits", "fused-bf16"])
def test_example_trains_on_the_cpu(example, capsys, extra):
    model = example.main(["--cpu", "--bs", "2", "--seq", "16", "--d-model",
                          "32", "--heads", "2", "--layers", "1", "--vocab",
                          "48", "--steps", "3", "--fused-optim"] + extra)
    out = capsys.readouterr().out
    assert "device: cpu" in out and "step 0: loss" in out
    assert "tokens/s" in out
    assert float(model.optimizer.get_states()["step_counter"]) == 4


@pytest.mark.parametrize("argv", [["--tp", "2"], ["--sp", "2"],
                                  ["--ep", "2"], ["--moe", "2"],
                                  ["--generate", "4"]], ids=str)
def test_example_refuses_what_is_not_ported(example, argv, capsys):
    """Each of these flags was once refused naming ROADMAP.md and is
    ported now. ``--tp``, ``--sp`` and ``--ep`` take torchrun's ranks
    (their runs at two gloo ranks: ``tests/test_torch_lm_tp.py``,
    ``tests/test_torch_lm_sp.py``, ``tests/test_torch_lm_moe.py``; one
    process exits naming torchrun). ``--generate`` decodes greedily after
    training, and ``--moe`` trains the MoE LM (here with ``--generate``
    too): on the CPU the tokens are those of the JAX package's
    ``generate`` from the trained weights."""
    if argv[0] in ("--tp", "--sp", "--ep"):
        with pytest.raises(SystemExit, match="torchrun"):
            example.main(argv + ["--cpu"])
        return
    moe = argv if argv[0] == "--moe" else []
    extra = ["--generate", "4"] if moe else argv
    model = example.main(moe + extra + [
        "--cpu", "--bs", "2", "--seq", "8", "--d-model", "32", "--heads",
        "2", "--layers", "1", "--vocab", "48", "--steps", "2"])
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("generated:")]
    assert len(line) == 1
    got = [int(t) for t in line[0].split("[")[1].rstrip("]").split(",")]
    assert float(model.optimizer.get_states()["step_counter"]) == 3
    jm = jtransformer.TransformerLM(48, d_model=32, n_heads=2, n_layers=1,
                                    max_len=12, tp=False,
                                    moe=int(moe[1]) if moe else None)
    ids = np.random.RandomState(0).randint(0, 48, (2, 8)).astype(np.float32)
    jm(jtensor.Tensor(data=ids, device=jdevice.create_cpu_device(),
                      requires_grad=False))
    states = {k: v.to_numpy() for k, v in model.get_states().items()}
    for k, t in jm.get_states().items():
        t.copy_from_numpy(states[k])
    want = jm.generate(ids[:1], max_new_tokens=4, temperature=0)
    assert got == want[0, -4:].tolist()
