"""The port's attention against the JAX package's, and its CUDA kernel.

  * ``flash_attention_plain`` (the kernel's plain version, which the
    wrapper runs on CPU tensors) against the oracle
    ``repro.kernels.ref.flash_attention_ref`` and against the Pallas kernel
    ``repro.kernels.flash_attention.flash_attention`` in interpret mode
    (bq = bk = 64): causal, window + softcap, non-causal, decode (Sq = 1
    at q_offset 77) and grouped KV heads (the JAX side gets K and V
    repeated to H heads); fp32 within 2e-5, bf16 within 2e-2 (the
    tolerances of ``tests/test_kernels.py``);
  * ``causal_mask`` against ``repro.models.layers.causal_mask``;
  * the wrapper's checks, and no route for a tensor on neither the CPU
    nor a card; the route a CUDA call takes, by dtype, Sq and D, and the
    wgmma route's alignment check;
  * marked ``cuda``: the kernel against its plain version on a card, at
    the sweep shapes and llama4-scout's grouping of 5 query heads a KV
    head, a decode against a strided cache, and rows with no
    valid key; the bf16 wgmma route at ragged shapes (Sq and Sk not
    multiples of the 64-row tiles, q_offset > 0, window, softcap, 5:1
    grouping, D 64 and 128, rows with no valid key), on views of
    [B, S, N, D] tensors.  They skip without a card; run them there with
    ``python -m pytest -m cuda tests/test_torch_flash.py``.

JAX is imported only by the tests that compare with it, so the card's
tests run where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (
    _check_tma,
    causal_mask,
    flash_attention,
    flash_attention_plain,
    route,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (b, h, kv, sq, sk, d, causal, window, softcap, q_offset)
CASES = {
    "causal": (1, 2, 2, 256, 256, 64, True, None, None, 0),
    "window_softcap": (2, 2, 2, 192, 192, 32, True, 64, 30.0, 0),
    "non_causal": (1, 1, 1, 128, 128, 64, False, None, None, 0),
    "decode": (2, 4, 4, 1, 128, 64, True, None, None, 77),
    "gqa": (2, 4, 2, 128, 128, 32, True, None, None, 0),
}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import flash_attention as pallas
    from repro.kernels import ref

    return jax.numpy, pallas.flash_attention, ref.flash_attention_ref


def _inputs(seed, b, h, kv, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    return q, k, v


def _jax_side(jnp, q, k, v, dtype):
    """q, k, v for the JAX kernels: K and V repeated to H heads."""
    g = q.shape[1] // k.shape[1]
    return tuple(jnp.asarray(a).astype(dtype)
                 for a in (q, np.repeat(k, g, 1), np.repeat(v, g, 1)))


def _plain(q, k, v, dtype, causal, window, softcap, q_offset):
    dt = getattr(torch, dtype)
    return flash_attention_plain(
        *(torch.from_numpy(a).to(dt) for a in (q, k, v)),
        causal=causal, window=window, softcap=softcap, q_offset=q_offset,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference(jx, case, dtype):
    jnp, _, ref = jx
    b, h, kv, sq, sk, d, causal, window, softcap, off = CASES[case]
    q, k, v = _inputs(1, b, h, kv, sq, sk, d)
    want = np.asarray(ref(*_jax_side(jnp, q, k, v, dtype), causal=causal,
                          window=window, softcap=softcap, q_offset=off)
                      .astype(jnp.float32))
    got = _plain(q, k, v, dtype, causal, window, softcap, off)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, sq, d)
    assert np.abs(got.float().numpy() - want).max() < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas(jx, case, dtype):
    jnp, pallas, _ = jx
    b, h, kv, sq, sk, d, causal, window, softcap, off = CASES[case]
    q, k, v = _inputs(2, b, h, kv, sq, sk, d)
    want = np.asarray(pallas(*_jax_side(jnp, q, k, v, dtype), causal=causal,
                             window=window, softcap=softcap, q_offset=off,
                             bq=64, bk=64, interpret=True)
                      .astype(jnp.float32))
    # the CPU wrapper takes the plain version and launches nothing
    before = flash_attention.launches
    dt = getattr(torch, dtype)
    got = flash_attention(*(torch.from_numpy(a).to(dt) for a in (q, k, v)),
                          causal=causal, window=window, softcap=softcap,
                          q_offset=off)
    assert flash_attention.launches == before
    assert np.abs(got.float().numpy() - want).max() < TOL[dtype]


@pytest.mark.parametrize("sq,sk,window,offset", [
    (8, 8, None, 0), (6, 10, 3, 4), (1, 16, None, 9), (1, 16, 5, 15),
])
def test_causal_mask_matches_reference(jx, sq, sk, window, offset):
    from repro.models.layers import causal_mask as ref_mask

    want = np.asarray(ref_mask(sq, sk, window, offset))[0, 0, 0]
    assert np.array_equal(causal_mask(sq, sk, window, offset).numpy(), want)


def test_wrapper_validates_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, 8, 8, 16))
    with pytest.raises(TypeError, match="q must be"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="k is"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="group"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(q.requires_grad_(True), k, v)
    # a tensor on neither the CPU nor a card raises: no fallback
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        flash_attention(*(t.detach().to("meta") for t in (q, k, v)))


def test_masked_rows_average_every_key():
    """A row that sees no key gets the mean of v over all keys, as the
    TPU kernel's -1e30 fill gives (window 2 at q_offset 20 over 8 keys)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 2, 2, 3, 8, 16))
    out = flash_attention(q, k, v, window=2, q_offset=20)
    assert torch.allclose(out, v.mean(2, keepdim=True).expand_as(out), atol=1e-6)


@pytest.mark.parametrize("dtype,sq,d,want", [
    ("bfloat16", 2048, 128, "wgmma"), ("bfloat16", 2, 64, "wgmma"),
    ("bfloat16", 200, 96, "fma"), ("bfloat16", 40, 16, "fma"),
    ("float32", 2048, 128, "fma"), ("float32", 70, 64, "fma"),
    ("bfloat16", 1, 128, "decode"), ("float32", 1, 96, "decode"),
    ("bfloat16", 1, 32, "fma"),
])
def test_route_by_dtype_sq_and_head_dim(dtype, sq, d, want):
    """bf16 prefill at D 64 or 128 takes the tensor cores, Sq == 1 the
    decode kernel where its head dims allow, everything else the FMA
    kernel; the choice reads nothing but the three arguments."""
    assert route(getattr(torch, dtype), sq, d) == want


def test_wgmma_route_needs_16_byte_alignment():
    """TMA reads 16-byte aligned addresses and strides: a view one
    element off, or a row stride of an odd number of elements, is refused
    before any launch; the model's [B, S, N, D] views pass."""
    base = torch.zeros(2 * 5 * 4 * 64 + 1, dtype=torch.bfloat16)
    view = base[:-1].view(2, 5, 4, 64).transpose(1, 2)
    _check_tma(q=view)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_tma(q=base[1:].view(2, 5, 4, 64))
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_tma(k=torch.zeros(2, 4, 5, 65, dtype=torch.bfloat16)[..., :64])


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES) + ["hd16", "hd96_g3", "ragged",
                                                 "g5_decode", "g5_prefill"])
def test_kernel_matches_plain(cuda, case, dtype):
    # g5: llama4-scout's grouping (5 query heads a KV head), whose decode
    # runs the 4-head group and a partial second group of 1
    shapes = dict(CASES, hd16=(2, 4, 2, 40, 40, 16, True, None, None, 0),
                  hd96_g3=(1, 6, 2, 1, 300, 96, True, 100, 20.0, 250),
                  g5_decode=(2, 10, 2, 1, 300, 128, True, None, None, 250),
                  g5_prefill=(1, 10, 2, 70, 70, 128, True, None, None, 0),
                  ragged=(1, 2, 1, 77, 93, 128, True, 50, None, 16))
    b, h, kv, sq, sk, d, causal, window, softcap, off = shapes[case]
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt)
               for a in _inputs(5, b, h, kv, sq, sk, d))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=off)
    assert got.dtype == dt and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 63, 255])
def test_kernel_decode_reads_strided_cache(cuda, pos):
    """Decode as the model calls it: q a view of [B, 1, H, D], k and v
    views of a [B, Smax, KV, D] cache, output in q's layout."""
    rng = np.random.default_rng(6)
    B, H, KV, Smax, D = 3, 8, 2, 256, 128
    qs = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32)).to(cuda)
    ck = torch.from_numpy(rng.standard_normal((B, Smax, KV, D)).astype(np.float32)).to(cuda)
    cv = torch.from_numpy(rng.standard_normal((B, Smax, KV, D)).astype(np.float32)).to(cuda)
    args = (qs.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2))
    got = flash_attention(*args, q_offset=pos)
    want = flash_attention_plain(*(a.contiguous() for a in args), q_offset=pos)
    assert got.transpose(1, 2).is_contiguous()
    assert (got - want).abs().max().item() < TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,offset", [(1, 80), (70, 0)])
def test_kernel_masked_rows_average_every_key(cuda, sq, offset):
    """Rows that see no key (query positions 67-69 at window 4 over 64
    keys, or every row at offset 80) beside rows that do."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _inputs(7, 1, 2, 2, sq, 64, 64))
    got = flash_attention(q, k, v, window=4, q_offset=offset)
    want = flash_attention_plain(q, k, v, window=4, q_offset=offset)
    assert (got - want).abs().max().item() < TOL["float32"]


# (b, h, kv, sq, sk, d, causal, window, softcap, q_offset)
WGMMA_CASES = {
    "ragged_offset_d128": (1, 2, 2, 200, 333, 128, True, None, None, 133),
    "ragged_noncausal_d64": (2, 2, 1, 200, 333, 64, False, None, None, 0),
    "window_softcap_d128": (1, 4, 2, 333, 333, 128, True, 100, 30.0, 0),
    "group5_d128": (1, 10, 2, 200, 200, 128, True, None, None, 0),
    "offset_window_d64": (1, 2, 2, 130, 200, 64, True, 50, None, 70),
    "empty_rows_d64": (1, 2, 2, 70, 64, 64, True, 4, None, 0),
    "empty_rows_d128": (1, 2, 1, 100, 64, 128, True, 8, None, 30),
    "two_rows_d128": (2, 2, 2, 2, 77, 128, True, None, None, 75),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_wgmma_route_matches_plain(cuda, case):
    """The bf16 prefill kernel on the tensor cores against the plain
    version within 2e-2, q, k and v given as views of [B, S, N, D]
    tensors (the model's layout), the output in q's layout."""
    b, h, kv, sq, sk, d, causal, window, softcap, off = WGMMA_CASES[case]
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16).transpose(1, 2).contiguous()
               .transpose(1, 2) for a in _inputs(11, b, h, kv, sq, sk, d))
    assert route(q.dtype, sq, d) == "wgmma"
    before = flash_attention.launches_by_route["wgmma"]
    got = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route["wgmma"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=off)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() < TOL["bfloat16"]
