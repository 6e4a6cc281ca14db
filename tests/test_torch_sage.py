"""GraphSAGE on PyTorch against the JAX package, and its aggregation kernel.

  * ``sage_aggregate_plain`` (the kernel's plain version, which the
    wrapper runs on CPU tensors) against the oracle
    ``repro.kernels.ref.sage_aggregate_ref`` and against the Pallas kernel
    ``repro.kernels.ops.sage_aggregate`` in interpret mode, on the sweep
    of ``tests/test_kernels.py``: fp32 within 1e-5 (XLA may sum the K
    rows in another order than the j-ordered walk), bf16 within 3e-2
    (one bf16 rounding of the output);
  * the autograd backward and ``sage_aggregate_backward_plain`` against
    ``jax.grad`` of the oracle (1e-5), and the plain backward against a
    serial loop in ascending flat position (bit for bit: the order in
    which the backward kernels add on a card);
  * ``forward_plan``: the access width and tile the forward takes at the
    main path's shapes, odd widths and misaligned pointers, and the C
    signatures the wrapper declares to ctypes;
  * ``GraphSAGE`` logits, loss and every gradient against
    ``repro.models.gnn.sage_loss`` on the same weights (carried across
    with ``sage_from_reference``) within 1e-5, and five SGD steps whose
    losses track JAX's within 1e-4 (fp32 products summed in another
    order, compounded over the steps);
  * the port's twin of ``test_gnn_example_learns``.

The CUDA kernel against its plain version, and the model on a card
against the CPU, are in ``tests/test_torch_cuda.py`` (no JAX there).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.data.graph import sample_blocks, synthetic_graph
from repro.kernels import ops
from repro.kernels.ref import sage_aggregate_ref
from repro.models import gnn as ref_gnn
from repro_torch.convert import sage_from_reference
from repro_torch.data import graph as port_graph
from repro_torch.kernels.sage_aggregate import (
    THREADS,
    forward_plan,
    long_plan,
    sage_aggregate,
    sage_aggregate_backward,
    sage_aggregate_backward_plain,
    sage_aggregate_plain,
)
from repro_torch.models import GraphSAGE, SageConfig, batch_to, sage_loss, sgd_step

SWEEP = [(500, 64, 128, 8), (300, 128, 64, 16)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(seed, n, f, m, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    idx = rng.integers(-1, n, (m, k)).astype(np.int32)
    idx[1] = -1  # an all-padding row
    return x, idx


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f,m,k", SWEEP)
def test_plain_matches_reference(n, f, m, k, dtype):
    x, idx = _inputs(12, n, f, m, k)
    want = np.asarray(
        sage_aggregate_ref(jnp.asarray(x).astype(dtype), jnp.asarray(idx))
        .astype(jnp.float32)
    )
    got = sage_aggregate_plain(_torch_x(x, dtype), torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(got.float().numpy() - want).max() < TOL[dtype]
    assert (got[1] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f,m,k", SWEEP)
def test_plain_matches_pallas(n, f, m, k, dtype):
    x, idx = _inputs(13, n, f, m, k)
    want = np.asarray(
        ops.sage_aggregate(jnp.asarray(x).astype(dtype), jnp.asarray(idx), bm=64)
        .astype(jnp.float32)
    )
    # the CPU wrapper takes the plain version and launches nothing
    before = sage_aggregate.launches
    got = sage_aggregate(_torch_x(x, dtype), torch.from_numpy(idx))
    assert sage_aggregate.launches == before
    assert np.abs(got.float().numpy() - want).max() < TOL[dtype]


def test_all_padding_rows_give_zero():
    x, _ = _inputs(14, 32, 16, 8, 4)
    idx = np.full((8, 4), -1, np.int32)
    want = np.asarray(ops.sage_aggregate(jnp.asarray(x), jnp.asarray(idx), bm=8))
    got = sage_aggregate(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert (want == 0).all() and (got == 0).all()


def test_wrapper_validates_inputs():
    x, idx = (torch.from_numpy(a) for a in _inputs(0, 20, 8, 6, 3))
    with pytest.raises(TypeError, match="idx"):
        sage_aggregate(x, idx.long())
    with pytest.raises(TypeError, match="x must be"):
        sage_aggregate(x.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        sage_aggregate(x.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="2-D"):
        sage_aggregate(x[0], idx)
    # a tensor on neither the CPU nor a card raises: no fallback
    with pytest.raises(ValueError, match="no sage_aggregate kernel"):
        sage_aggregate(x.to("meta"), idx.to("meta"))


@pytest.mark.parametrize("n,f,m,k", SWEEP + [(40, 8, 30, 6)])
def test_backward_matches_jax_grad(n, f, m, k):
    x, idx = _inputs(15, n, f, m, k)
    idx[2] = 3  # one id repeated across a whole row
    w = np.random.default_rng(16).standard_normal((m, f)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda xx: (sage_aggregate_ref(xx, jnp.asarray(idx)) * w).sum()
    )(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (sage_aggregate(xt, torch.from_numpy(idx)) * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == torch.float32
    assert np.abs(xt.grad.numpy() - want).max() < 1e-5


def _backward_case(seed, n, f, m, k):
    """grad_out and idx with a repeated id, all-padding rows and rows that
    no id names."""
    x, idx = _inputs(seed, n, f, m, k)
    idx[2] = 3  # one id repeated across a whole row
    idx[4:m:5, 1] = 0  # and one id named by many rows
    idx[idx >= n - 5] = -1  # the last 5 rows are named by no id
    go = np.random.default_rng(seed + 1).standard_normal((m, f)).astype(np.float32)
    return idx, go


@pytest.mark.parametrize("n,f,m,k", SWEEP + [(40, 8, 30, 6)])
def test_backward_plain_matches_jax_grad(n, f, m, k):
    idx, go = _backward_case(17, n, f, m, k)
    x = np.zeros((n, f), np.float32)
    want = np.asarray(jax.grad(
        lambda xx: (sage_aggregate_ref(xx, jnp.asarray(idx)) * jnp.asarray(go)).sum()
    )(jnp.asarray(x)))
    got = sage_aggregate_backward_plain(torch.from_numpy(go), torch.from_numpy(idx), n)
    assert got.dtype == torch.float32 and got.shape == (n, f)
    assert np.abs(got.numpy() - want).max() < 1e-5
    assert (got[n - 5:] == 0).all()


@pytest.mark.parametrize("n,f,m,k", SWEEP + [(40, 8, 30, 6)])
def test_backward_plain_is_serial_ascending(n, f, m, k):
    """The plain backward adds in ascending flat position m * K + j, one
    term at a time from 0: a serial loop gives the same bits."""
    idx, go = _backward_case(18, n, f, m, k)
    got = sage_aggregate_backward_plain(torch.from_numpy(go), torch.from_numpy(idx), n)
    cnt = np.maximum((idx >= 0).sum(1), 1).astype(np.float32)
    want = np.zeros((n, f), np.float32)
    for p, r in enumerate(idx.reshape(-1)):
        if r >= 0:
            want[r] = want[r] + go[p // k] / cnt[p // k]
    assert np.array_equal(got.numpy(), want)
    # the CPU wrapper takes the plain version and launches nothing
    before = sage_aggregate.backward_launches
    same = sage_aggregate_backward(torch.from_numpy(go), torch.from_numpy(idx), n)
    assert sage_aggregate.backward_launches == before
    assert torch.equal(same, got)


def test_backward_wrapper_validates_inputs():
    idx, go = (torch.from_numpy(a) for a in _backward_case(19, 20, 8, 12, 3))
    with pytest.raises(ValueError, match="does not match"):
        sage_aggregate_backward(go[:5], idx, 20)
    with pytest.raises(ValueError, match="no sage_aggregate kernel"):
        sage_aggregate_backward(go.to("meta"), idx.to("meta"), 20)


@pytest.mark.parametrize("bad,err,match", [
    (lambda i: i.long(), TypeError, "int32"),
    (lambda i: i.t().contiguous().t(), ValueError, "contiguous"),
    (lambda i: i.reshape(-1), ValueError, "2-D"),
])
def test_backward_wrapper_validates_idx(bad, err, match):
    """An idx the kernels would misread (int64, strided, 1-D) raises on
    every device, before any launch."""
    idx, go = (torch.from_numpy(a) for a in _backward_case(20, 20, 8, 12, 3))
    before = sage_aggregate.backward_launches
    for dev in ("cpu", "meta"):
        with pytest.raises(err, match=match):
            sage_aggregate_backward(go.to(dev), bad(idx).to(dev), 20)
    assert sage_aggregate.backward_launches == before


@pytest.mark.parametrize("f,elt,vec,w,r", [
    (100, 4, 16, 100, 10),  # layer 0 in fp32: 250 of 256 threads gather
    (256, 4, 16, 256, 4),  # layers 1 and 2
    (100, 2, 8, 100, 10),  # bf16 F = 100: 200-byte rows, 8 bytes a lane
    (256, 2, 16, 256, 8),
    (7, 4, 4, 7, 36),
    (30, 4, 8, 30, 17),
    (3, 2, 2, 3, 85),
    (1100, 4, 16, 1024, 1),  # chunks of 256 accesses and a short last
])
def test_forward_plan(f, elt, vec, w, r):
    plan = forward_plan(f, elt)
    assert (plan.vec_bytes, plan.W, plan.R) == (vec, w, r)
    assert plan.R * (plan.W * elt // plan.vec_bytes) <= THREADS


def test_ctypes_signatures_match_the_source():
    """Every exported function of csrc/sage_aggregate.cu is declared to
    ctypes with its C parameters (a pointer as void*, an int as int): a
    missing or extra argument shifts every later one on the card."""
    import ctypes
    import re

    from repro_torch.kernels import sage_aggregate as sa

    text = sa.SOURCE.read_text()
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong}
    found = {}
    for name, params in re.findall(r"^int (repro_\w+)\(([^)]*)\)", text, re.M):
        found[name] = [kinds[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert found == sa.SIGNATURES


@pytest.mark.parametrize("f,mk,depth,bitmap", [
    (256, 67160, 48, True),  # layer 1: 48 rows of 1 KB a stage
    (100, 376065, 122, True),  # layer 0
    (7, 840000, 128, False),  # too many positions for the bitmap
    (2048, 1000, 12, True),  # columns staged 1024 at a time
])
def test_long_plan(f, mk, depth, bitmap):
    """bwd_long's ring depth and whether its bitmap fits in shared memory."""
    assert long_plan(f, mk) == (depth, bitmap)


def test_forward_plan_alignment():
    """A pointer off 16 bytes takes the widest access both pointers and
    the row allow."""
    assert forward_plan(256, 4, x_ptr=4).vec_bytes == 4
    assert forward_plan(256, 4, x_ptr=8).vec_bytes == 8
    assert forward_plan(256, 2, out_ptr=2).vec_bytes == 2
    assert forward_plan(256, 4, x_ptr=4, out_ptr=8).vec_bytes == 4


def _params(cfg, seed=0):
    """The reference's init_sage weights as float32 numpy arrays."""
    p = ref_gnn.init_sage(jax.random.key(seed), cfg)
    return {k: np.asarray(v, dtype=np.float32) for k, v in p.items()}


def _batches(n_batches, batch, fanouts, seed=0):
    g = synthetic_graph(n_nodes=3000, n_parts=4, seed=0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        seeds = rng.choice(g.train_nodes, batch, replace=False)
        feats, blocks, labels, _ = sample_blocks(g, seeds, fanouts, rng)
        out.append((feats, blocks, labels))
    return out


def _jax_batch(feats, blocks, labels):
    return {
        "feats": jnp.asarray(feats),
        "blocks": [jnp.asarray(b) for b in blocks],
        "labels": jnp.asarray(labels),
    }


def _as_reference(model, grad=False):
    """The model's weights (or their gradients) in the reference's layout."""
    get = (lambda p: p.grad.numpy()) if grad else (lambda p: p.detach().numpy())
    out = {}
    for l, lin in enumerate(model.layers):
        out[f"w{l}"] = get(lin.weight).T
        out[f"b{l}"] = get(lin.bias)
    out["head"] = get(model.head.weight).T
    return out


@pytest.mark.parametrize("n_layers,fanouts", [(2, (5, 5)), (3, (5, 10, 15))])
def test_graphsage_matches_jax(n_layers, fanouts):
    cfg = ref_gnn.SageConfig(in_dim=100, hidden=32, n_classes=47, n_layers=n_layers)
    params = _params(cfg)
    (feats, blocks, labels), = _batches(1, 128, fanouts)
    jb = _jax_batch(feats, blocks, labels)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want_logits = np.asarray(ref_gnn.sage_forward(jparams, jb["feats"], jb["blocks"], cfg))
    want_grads, want_m = jax.grad(
        functools.partial(ref_gnn.sage_loss, cfg=cfg), has_aux=True
    )(jparams, jb)

    model = sage_from_reference(params, cfg, device="cpu")
    batch = batch_to(feats, blocks, labels, device="cpu")
    logits = model(batch["feats"], batch["blocks"])
    assert logits.shape == (128, 47)
    assert np.abs(logits.detach().numpy() - want_logits).max() < 1e-5
    loss, m = sage_loss(model, batch)
    loss.backward()
    assert abs(loss.item() - float(want_m["loss"])) < 1e-5, (
        loss.item(), float(want_m["loss"]))
    assert m["acc"].item() == pytest.approx(float(want_m["acc"]))
    got = _as_reference(model, grad=True)
    assert set(got) == set(want_grads)
    for k, v in want_grads.items():
        assert got[k].shape == v.shape, k
        assert np.abs(got[k] - np.asarray(v)).max() < 1e-5, k


def test_sgd_steps_track_jax():
    cfg = ref_gnn.SageConfig(in_dim=100, hidden=32, n_classes=47, n_layers=2)
    params = _params(cfg, seed=1)
    batches = _batches(5, 128, (5, 5), seed=1)
    grad_fn = jax.grad(functools.partial(ref_gnn.sage_loss, cfg=cfg), has_aux=True)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    model = sage_from_reference(params, cfg, device="cpu")
    want, got = [], []
    for feats, blocks, labels in batches:
        grads, m = grad_fn(jparams, _jax_batch(feats, blocks, labels))
        jparams = jax.tree.map(lambda p, gg: p - 0.1 * gg, jparams, grads)
        want.append(float(m["loss"]))
        loss, _ = sage_loss(model, batch_to(feats, blocks, labels, device="cpu"))
        loss.backward()
        sgd_step(model, lr=0.1)
        got.append(loss.item())
    assert np.abs(np.array(got) - np.array(want)).max() < 1e-4
    assert got[-1] < got[0]
    final = _as_reference(model)
    for k, v in jparams.items():
        assert np.abs(final[k] - np.asarray(v)).max() < 1e-4, k


def test_sage_from_reference_layout():
    cfg = ref_gnn.SageConfig(in_dim=10, hidden=6, n_classes=3, n_layers=2)
    params = _params(cfg)
    model = sage_from_reference(params, cfg, device="cpu")
    assert model.cfg == SageConfig(10, 6, 3, 2)
    assert tuple(model.layers[0].weight.shape) == (6, 20)
    assert tuple(model.layers[1].weight.shape) == (6, 12)
    assert tuple(model.head.weight.shape) == (3, 6)
    assert model.head.bias is None
    assert np.array_equal(_as_reference(model)["w1"], params["w1"])


def test_port_init_matches_reference_scale():
    """The port draws its own weights (torch.Generator), at the
    reference's scales: biases zero, weights ~N(0, 1/(2 d_l))."""
    cfg = SageConfig(in_dim=100, hidden=256, n_classes=47, n_layers=3)
    a = GraphSAGE(cfg, device="cpu", seed=0)
    b = GraphSAGE(cfg, device="cpu", seed=0)
    c = GraphSAGE(cfg, device="cpu", seed=1)
    assert torch.equal(a.layers[0].weight, b.layers[0].weight)
    assert not torch.equal(a.layers[0].weight, c.layers[0].weight)
    for l, lin in enumerate(a.layers):
        d = 100 if l == 0 else 256
        assert (lin.bias == 0).all()
        assert lin.weight.std().item() == pytest.approx((2 * d) ** -0.5, rel=0.05)
    assert a.head.weight.std().item() == pytest.approx(256 ** -0.5, rel=0.05)


def test_gnn_example_learns_torch():
    """The port's twin of tests/test_system.py::test_gnn_example_learns."""
    g = port_graph.synthetic_graph(n_nodes=3000, n_parts=4, seed=0)
    model = GraphSAGE(SageConfig(in_dim=100, hidden=64, n_classes=47, n_layers=2),
                      device="cpu", seed=0)
    rng = np.random.default_rng(0)
    first = last = None
    for _ in range(25):
        seeds = rng.choice(g.train_nodes, 128, replace=False)
        feats, blocks, labels, _ = port_graph.sample_blocks(g, seeds, (5, 5), rng)
        loss, m = sage_loss(model, batch_to(feats, blocks, labels, device="cpu"))
        loss.backward()
        sgd_step(model, lr=0.1)
        first = first if first is not None else loss.item()
        last = loss.item()
    assert last < first - 0.4, (first, last)
