"""The port's mesh: the differentiable collectives of ``parallel/ops.py``,
ring and Ulysses attention, and the mesh's rank layout, held against the
JAX package.

Gloo ranks of ``tests/torch_dist_ranks.py`` (``mesh_ops`` case), launched
at two and at four ranks for the module:

- each of the six collectives (``AllReduce``, ``CopyToParallel``,
  ``AllGather``, ``ReduceScatter``, ``PMean``, ``AllToAll``) forward and
  backward over a ``model`` axis of every rank, on the rank's slice of
  seeded inputs and cotangents, against ``singa_tpu/parallel/ops.py``'s
  same op under ``shard_map`` over as many CPU devices: within 1e-6 (the
  sums run in another order; measured: equal); the backward through
  torch autograd equals the op's own backward, bitwise; the ring shift
  moves each rank's block to the next rank;
- ring and Ulysses attention (``ops.attention.attention(seq_axis="seq")``)
  on the rank's sequence block of (B2, H4, S16, D8) q, k, v, causal and
  full, their outputs and q, k, v gradients gathered along the sequence,
  against dense flash attention on the whole sequence, the port's and the
  JAX package's: rtol 2e-5 / atol 2e-5 for the output and 1e-4 / 1e-5 for
  the gradients, ``tests/test_attention.py``'s bounds; Ulysses with 2
  heads over 4 ranks warns and falls back to ring.

In this process: the ring hop's plain version (``_scan_flash_fwd`` with
``pos_delta``) against the JAX package's ``_ring_partials_scan`` and
against K3's Pallas kernel in interpret mode at a position delta of 0,
+-S_local and +-2 S_local (the hop fully in the causal future included:
there the kernel and the plain version write out 0 and lse -1e30, where
the JAX scan writes the masked average; the merge gives that hop no
weight either way, and no NaN); and rank r's coordinates on a
``make_mesh`` mesh against JAX device r's position in the JAX package's
mesh of the same config.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

from singa_tpu.model import _shard_map_compat_kwargs, shard_map
from singa_tpu.ops import attention_mod as JA
from singa_tpu.parallel import mesh as jmesh
from singa_tpu.parallel import ops as jops
from singa_tpu.parallel.communicator import collective_context as jctx

from singa_tpu_torch.ops import attention as TA
from singa_tpu_torch.parallel import ops as tops

import torch_dist_ranks as ranks
import torch_threads  # noqa: F401  (bounds torch's CPU threads)

OP_TOL = 1e-6
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, H, S, D = 2, 4, 16, 8


def _shapes(name, world):
    """(x, dy) shapes of one rank's slice for the op ``name``."""
    if name == "all_to_all":
        return (2 * world, 3), (2, 3 * world)
    x = (4, 4 * world)
    return x, {"all_gather": (4, 4 * world * world),
               "reduce_scatter": (4, 4)}.get(name, x)


def _inputs(world, workdir):
    rng = np.random.RandomState(world)
    out = {"workdir": np.asarray(str(workdir))}
    for name in ranks.MESH_OPS:
        xs, ys = _shapes(name, world)
        out[f"op/{name}/x"] = rng.randn(world, *xs).astype(np.float32)
        out[f"op/{name}/dy"] = rng.randn(world, *ys).astype(np.float32)
    for h2 in (False, True):
        for n in "qkvg":
            out[f"attn/{h2}/{n}"] = rng.randn(
                B, 2 if h2 else H, S, D).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    res = {}
    for world in (2, 4):
        work = tmp_path_factory.mktemp(f"mesh-ops{world}")
        inputs = _inputs(world, work)
        outs, _ = ranks.launch("mesh_ops", world, inputs, work)
        res[world] = (inputs, outs)
    return res


def _jax_op(name, world, xs, dys):
    cls, args = ranks.MESH_OPS[name]
    mesh = Mesh(np.array(jax.devices("cpu")[:world]), ("model",))

    def body(x, dy):
        with jctx("model"):
            op = getattr(jops, cls)("model", *args)
            y = op.forward(x[0])
            dx = op.backward(dy[0])
        return y[None], dx[None]

    f = shard_map(body, mesh=mesh, in_specs=(JP("model"), JP("model")),
                  out_specs=(JP("model"), JP("model")),
                  **_shard_map_compat_kwargs())
    y, dx = f(jnp.asarray(xs), jnp.asarray(dys))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ranks.MESH_OPS))
def test_collective_matches_the_jax_op(ranked, name, world):
    inputs, outs = ranked[world]
    y, dx = _jax_op(name, world, inputs[f"op/{name}/x"],
                    inputs[f"op/{name}/dy"])
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{name}/y"], y[r], rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=f"{name} y r{r}")
        np.testing.assert_allclose(out[f"{name}/dx"], dx[r], rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=f"{name} dx r{r}")
        np.testing.assert_array_equal(out[f"{name}/dx_autograd"],
                                      out[f"{name}/dx"])


@pytest.mark.parametrize("world", [2, 4])
def test_ring_shift_moves_each_block_one_rank_on(ranked, world):
    _, outs = ranked[world]
    for r, out in enumerate(outs):
        src = (r - 1) % world
        np.testing.assert_array_equal(
            out["shift"], np.arange(6.0).reshape(2, 3) + src)
        counts = dict(zip(tops.KINDS, out["shift_counts"].tolist()))
        assert counts["send_recv"] == 1


def _dense(inputs, h2, causal):
    """The port's dense flash attention on the whole sequence (the plain
    version) and its q, k, v gradients, and the JAX package's."""
    q, k, v, g = (torch.from_numpy(inputs[f"attn/{h2}/{n}"]) for n in "qkvg")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = TA.flash_attention(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, g)
    jq, jk, jv, jg = (jnp.asarray(inputs[f"attn/{h2}/{n}"]) for n in "qkvg")
    jout, vjp = jax.vjp(lambda a, b, c: JA.flash_attention(
        a, b, c, causal=causal), jq, jk, jv)
    jgrads = vjp(jg)
    return out.detach().numpy(), [t.numpy() for t in grads], \
        np.asarray(jout), [np.asarray(t) for t in jgrads]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["ring_causal", "ring_full",
                                  "ulysses_causal", "ulysses_full",
                                  "ulysses_h2"])
def test_sequence_parallel_attention_matches_dense(ranked, world, case):
    inputs, outs = ranked[world]
    how = case.split("_")[1]
    out, grads, jout, jgrads = _dense(inputs, how == "h2", how != "full")
    got = np.concatenate([o[f"{case}/out"] for o in outs], 2)
    np.testing.assert_allclose(got, out, **OUT_TOL)
    np.testing.assert_allclose(got, jout, **OUT_TOL)
    for n, want, jwant in zip("qkv", grads, jgrads):
        g = np.concatenate([o[f"{case}/d{n}"] for o in outs], 2)
        np.testing.assert_allclose(g, want, **GRAD_TOL, err_msg=n)
        np.testing.assert_allclose(g, jwant, **GRAD_TOL, err_msg=n)
    # 2 heads divide over 2 ranks, not over 4: there Ulysses warns once
    # per process and runs the ring
    warned = case == "ulysses_h2" and world == 4
    assert bool(outs[0][f"{case}/warned"]) is warned


@pytest.mark.parametrize("hop", [-2, -1, 0, 1, 2])
def test_ring_hop_plain_version_matches_jax(hop):
    """One ring hop at ``pos_delta = hop * S_local`` (S_local 8): hop 1
    and 2 see keys wholly in the past, hop -1 and -2 wholly in the future
    (every row masked)."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(1, 2, 8, 8).astype(np.float32) for _ in range(3))
    delta, scale = hop * 8, 1.0 / np.sqrt(8)
    out, lse = TA._scan_flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  True, scale, pos_delta=delta)
    jout, jlse = JA._ring_partials_scan(*(jnp.asarray(a) for a in (q, k, v)),
                                        delta, True, scale, 512)
    prev = JA.FORCE_PALLAS_INTERPRET
    JA.FORCE_PALLAS_INTERPRET = True
    try:
        pout, plse = JA._pallas_flash_fwd(
            *(jnp.asarray(a) for a in (q, k, v)), True, scale, block_q=8,
            block_k=8, pos_delta=delta)
    finally:
        JA.FORCE_PALLAS_INTERPRET = prev
    out, lse = out.numpy(), lse.numpy()
    np.testing.assert_allclose(out, np.asarray(pout), **OUT_TOL)
    np.testing.assert_allclose(lse, np.asarray(plse), rtol=1e-6)
    np.testing.assert_allclose(lse, np.asarray(jlse), rtol=1e-6)
    if hop < 0:
        assert np.all(out == 0) and np.all(lse <= -1e29)
        # the merge into a real partial: this hop gets weight exp(-1e30 -
        # m) = 0 and no NaN appears
        m = np.zeros_like(lse)
        w = np.exp(np.maximum(lse - np.maximum(m, lse), -1e30))
        assert np.all(w == 0)
    else:
        np.testing.assert_allclose(out, np.asarray(jout), **OUT_TOL)


def test_ring_merge_of_a_masked_hop_gives_no_nan():
    """The merge of ``ring_attention`` when a hop is fully masked: the
    accumulator keeps the real partial, its weight stays 1."""
    real_o = torch.randn(1, 1, 4, 2)
    real_l = torch.randn(1, 1, 4)
    masked_o = torch.zeros(1, 1, 4, 2)
    masked_l = torch.full((1, 1, 4), -1e30)
    m_new = torch.maximum(real_l, masked_l)
    a1, a2 = torch.exp(real_l - m_new), torch.exp(masked_l - m_new)
    out = real_o * a1[..., None] + masked_o * a2[..., None]
    assert torch.isfinite(out).all() and torch.equal(out, real_o)
    assert torch.equal(a1 + a2, torch.ones_like(a1))


@pytest.mark.parametrize("world", [2, 4])
def test_rank_layout_is_the_jax_meshs(ranked, world):
    """Rank r's coordinate on each axis of the port's mesh is the position
    of JAX device r in the JAX package's mesh of the same config (row-major,
    ``model`` innermost): weights carry across shard for shard."""
    _, outs = ranked[world]
    cfg = ranks.MESH_LAYOUTS[world]
    jm = jmesh.make_mesh(jax.devices("cpu")[:world], jmesh.MeshConfig(**cfg))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r, out in enumerate(outs):
        pos = dict(zip(jm.axis_names,
                       (int(i) for i in np.argwhere(ids == r)[0])))
        got = dict(zip(out["coords/names"].tolist(),
                       out["coords/values"].tolist()))
        assert got == {a: pos[a] for a in got}, (r, got, pos)
        assert set(got) == {"data"} | set(cfg)
