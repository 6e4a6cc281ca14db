"""The port's attention against the JAX package's, and its CUDA kernel.

  * ``flash_attention_plain`` (the kernel's plain version, which the
    wrapper runs on CPU tensors) against the oracle
    ``repro.kernels.ref.flash_attention_ref`` and against the Pallas kernel
    ``repro.kernels.flash_attention.flash_attention`` in interpret mode
    (bq = bk = 64): causal, window + softcap, non-causal, decode (Sq = 1
    at q_offset 77) and grouped KV heads (the JAX side gets K and V
    repeated to H heads), and head dims 80 and 112 (hubert-xlarge's, and
    kimi-k2's and zamba2-7b's) in prefill and decode; fp32 within 2e-5,
    bf16 within 2e-2 (the tolerances of ``tests/test_kernels.py``);
  * ``causal_mask`` against ``repro.models.layers.causal_mask``;
  * the wrapper's checks, and no route for a tensor on neither the CPU
    nor a card; the route a CUDA call takes, by dtype, Sq and D, and the
    alignment check of the wgmma and decode routes; every registered
    arch's head dim on every route; the host's key range and the decode
    kernel's split of it into chunks;
  * marked ``cuda``: the kernel against its plain version on a card, at
    the sweep shapes and llama4-scout's grouping of 5 query heads a KV
    head, a decode against a strided cache, and rows with no
    valid key; the bf16 wgmma route at ragged shapes (Sq and Sk not
    multiples of the 64-row tiles, q_offset > 0, window, softcap, 5:1
    grouping, D 64, 80, 96, 112 and 128, rows with no valid key), on views of
    [B, S, N, D] tensors; the split-key decode kernel on a strided cache
    at positions on both sides of a chunk edge, 1, 2, 5, 8 and 12 query
    heads a KV head, a window inside one chunk and across chunks, softcap,
    a row with no valid key over several chunks, D 64-128, each giving
    the same bits on two runs, and its logsumexp (``return_lse``, for a
    merge over key shards) against the plain one's, also past the keys
    (q_offset >= Sk).  They skip without a card; run them there with
    ``python -m pytest -m cuda tests/test_torch_flash.py``.

  * gradients: on the CPU the wrapper's inputs that need a gradient get
    autograd through the plain version, equal to ``jax.grad`` of the
    oracle (K and V's gradients summed over each group); the plain
    forward's logsumexp (``return_lse``) against JAX's logsumexp of the
    oracle's masked, softcapped scores (also a decode at q_offset >= 0,
    past the keys, and a row with no key), and the explicit plain backward
    from (o, lse) against autograd and ``jax.grad`` (fp32, 1e-5 of the
    largest gradient), over the backward's cases; the backward's route
    by dtype and the logsumexp's padded stride.  Marked ``cuda``: the
    forward kernels' logsumexp against the plain one, serving's output
    the same bits with and without it; the backward kernels
    (``csrc/flash_attention_bwd.cu``, bf16 on the "wgmma" route) against
    autograd through the plain version on the card over causal, window,
    softcap, non-causal, 1:1, 2:1 and 5:1 grouping, D 64, 80, 96, 112 and
    128, ragged lengths, fp32 within 1e-4 and bf16 within 2e-2 of the
    largest gradient, on views of [B, S, N, D] tensors, each giving the
    same bits on two runs; and the refusal of what they do not compute
    (q_offset > 0, a decode, Sq != Sk, D 32), before any launch.

JAX is imported only by the tests that compare with it, so the card's
tests run where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (
    DECODE_HEAD_DIMS,
    DECODE_ONE_CHUNK,
    HEAD_DIMS,
    WGMMA_HEAD_DIMS,
    _check_aligned,
    causal_mask,
    decode_plan,
    decode_scratch_floats,
    LSE_ROWS,
    backward_route,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_plain,
    key_range,
    lse_stride,
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
    # head dims 80 (hubert-xlarge) and 112 (kimi-k2, zamba2-7b)
    "hd80": (1, 2, 2, 128, 128, 80, True, None, 30.0, 0),
    "hd80_decode": (2, 4, 2, 1, 128, 80, True, None, None, 100),
    "hd112": (2, 4, 2, 128, 128, 112, True, 64, None, 0),
    "hd112_decode": (2, 8, 1, 1, 128, 112, True, 50, None, 120),
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
    ("bfloat16", 200, 96, "wgmma"), ("bfloat16", 40, 16, "fma"),
    ("float32", 2048, 128, "fma"), ("float32", 70, 64, "fma"),
    ("bfloat16", 1, 128, "decode"), ("float32", 1, 96, "decode"),
    ("bfloat16", 1, 32, "fma"),
    ("bfloat16", 2048, 112, "wgmma"), ("bfloat16", 300, 80, "wgmma"),
    ("float32", 2048, 112, "fma"), ("float32", 70, 80, "fma"),
    ("bfloat16", 1, 112, "decode"), ("float32", 1, 112, "decode"),
    ("bfloat16", 1, 80, "decode"), ("float32", 1, 80, "decode"),
])
def test_route_by_dtype_sq_and_head_dim(dtype, sq, d, want):
    """bf16 prefill at D 64, 80, 96, 112 or 128 takes the tensor cores, Sq == 1
    the decode kernel where its head dims allow, everything else the FMA
    kernel; the choice reads nothing but the three arguments."""
    assert route(getattr(torch, dtype), sq, d) == want


def test_every_arch_head_dim_runs_on_every_route():
    """Each registered arch that attends has its head dim in the kernels'
    lists at full width: the FMA, decode and wgmma routes all take it (no
    registered config raises on the card for its head dim)."""
    from repro_torch import configs

    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        if cfg.block_pattern == "mamba2":
            continue  # attention-free
        assert cfg.hd in HEAD_DIMS, arch
        assert cfg.hd in DECODE_HEAD_DIMS, arch
        assert cfg.hd in WGMMA_HEAD_DIMS, arch
    assert set(DECODE_HEAD_DIMS) <= set(HEAD_DIMS)
    assert set(WGMMA_HEAD_DIMS) <= set(HEAD_DIMS)


@pytest.mark.parametrize("sk,pos,causal,window", [
    (16, 9, True, 0), (16, 9, True, 5), (16, 15, True, 16), (16, 30, True, 4),
    (16, 3, False, 0), (16, 12, False, 4), (2048, 2047, True, 0), (600, 700, True, 4),
    (600, 599, True, 600), (1, 0, True, 0),
])
def test_key_range_matches_mask(sk, pos, causal, window):
    """The host's key range of one query is the span of the keys its mask
    lets through (which are all of [lo, hi]), or every key when it lets
    none through (the row whose output is the mean of v)."""
    lo, hi = key_range(sk, pos, pos, causal, window)
    seen = causal_mask(1, sk, window or None, pos, causal)[0].nonzero()[:, 0].tolist()
    if seen:
        assert (lo, hi) == (seen[0], seen[-1]) and seen == list(range(lo, hi + 1))
    else:
        assert (lo, hi) == (0, sk - 1)


@pytest.mark.parametrize("b,h,kv,sk,pos,window", [
    (8, 16, 8, 2048, 0, 0), (8, 16, 8, 2048, 255, 0), (8, 16, 8, 2048, 256, 0),
    (8, 16, 8, 2048, 1023, 0), (8, 16, 8, 2048, 2047, 0), (8, 40, 8, 2048, 2047, 0),
    (8, 64, 8, 2048, 2047, 0), (1, 2, 1, 4096, 4095, 0), (64, 32, 32, 2048, 2047, 0),
    (2, 10, 2, 2048, 1500, 700), (1, 8, 1, 600, 700, 4),
])
def test_decode_plan_tiles_the_key_range(b, h, kv, sk, pos, window):
    """The decode kernel's chunks cover the key range exactly, in chunks
    of equal length but the last; one chunk (and no scratch) for at most
    DECODE_ONE_CHUNK keys, several chunks of at least 128 keys above it,
    and more chunks for fewer (batch, KV head) pairs."""
    lo, hi, chunk, n = decode_plan(b, h, kv, sk, pos, True, window)
    assert (lo, hi) == key_range(sk, pos, pos, True, window)
    n_keys = hi - lo + 1
    assert n >= 1 and (n - 1) * chunk < n_keys <= n * chunk
    if n_keys <= DECODE_ONE_CHUNK:
        assert n == 1 and decode_scratch_floats(b, h, 128, n) == 0
    else:
        assert n >= 2 and chunk >= 128 and chunk % 64 == 0
        assert decode_scratch_floats(b, h, 112, n) == b * h * n * 114
    if (b, kv, pos) == (8, 8, 2047):  # internlm2, llama4, kimi at the full cache
        assert (chunk, n) == (512, 4)


def test_wgmma_route_needs_16_byte_alignment():
    """TMA reads 16-byte aligned addresses and strides: a view one
    element off, or a row stride of an odd number of elements, is refused
    before any launch; the model's [B, S, N, D] views pass."""
    base = torch.zeros(2 * 5 * 4 * 64 + 1, dtype=torch.bfloat16)
    view = base[:-1].view(2, 5, 4, 64).transpose(1, 2)
    _check_aligned("wgmma", q=view)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_aligned("wgmma", q=base[1:].view(2, 5, 4, 64))
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_aligned("wgmma", k=torch.zeros(2, 4, 5, 65, dtype=torch.bfloat16)[..., :64])


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES) + ["hd16", "hd96_g3", "ragged",
                                                 "g5_decode", "g5_prefill", "g8_hd112_decode",
                                                 "g8_hd112_prefill"])
def test_kernel_matches_plain(cuda, case, dtype):
    # g5: llama4-scout's grouping (5 query heads a KV head), whose decode
    # runs the 4-head group and a partial second group of 1
    shapes = dict(CASES, hd16=(2, 4, 2, 40, 40, 16, True, None, None, 0),
                  hd96_g3=(1, 6, 2, 1, 300, 96, True, 100, 20.0, 250),
                  g5_decode=(2, 10, 2, 1, 300, 128, True, None, None, 250),
                  g5_prefill=(1, 10, 2, 70, 70, 128, True, None, None, 0),
                  g8_hd112_decode=(2, 16, 2, 1, 700, 112, True, None, None, 650),
                  g8_hd112_prefill=(1, 16, 2, 200, 200, 112, True, None, None, 0),
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
    "ragged_offset_d80": (1, 2, 2, 200, 333, 80, True, None, None, 133),
    "window_softcap_d112": (1, 4, 2, 333, 333, 112, True, 100, 30.0, 0),
    "group8_d112": (1, 16, 2, 200, 200, 112, True, None, None, 0),
    "empty_rows_d80": (1, 2, 2, 70, 64, 80, True, 4, None, 0),
    "group3_d96": (1, 6, 2, 150, 150, 96, True, None, None, 0),
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


# (b, h, kv, smax, d, pos, window, softcap): the split-key decode kernel
DECODE_CASES = {
    "one_chunk_pos255_g1": (2, 2, 2, 1024, 128, 255, None, None),
    "two_chunks_pos256_g2": (2, 4, 2, 1024, 128, 256, None, None),
    "chunk_edge_pos383_g2": (2, 4, 2, 1024, 64, 383, None, None),
    "chunk_edge_pos384_g2": (2, 4, 2, 1024, 64, 384, None, None),
    "g5_pos1023": (2, 10, 2, 2048, 128, 1023, None, None),
    "g8_d112_pos2047": (2, 16, 2, 2048, 112, 2047, None, None),
    "g8_d80_softcap": (1, 8, 1, 2048, 80, 1500, None, 30.0),
    "g12_two_head_groups": (1, 24, 2, 512, 128, 400, None, None),
    "window_in_one_chunk": (2, 4, 2, 2048, 64, 1800, 100, None),
    "window_over_chunks": (1, 6, 2, 2048, 96, 1900, 700, 20.0),
    "no_valid_key_over_chunks": (1, 4, 2, 600, 128, 700, 4, None),
    "past_the_keys_one_chunk": (1, 4, 2, 200, 64, 300, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain(cuda, case, dtype):
    """The split-key decode kernel as the model calls it (q a view of [B,
    1, H, D], k and v views of a [B, Smax, KV, D] cache) against the plain
    version, and the same bits on a second run."""
    b, h, kv, smax, d, pos, window, softcap = DECODE_CASES[case]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    qs = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32)).to(cuda, dt)
    ck, cv = (torch.from_numpy(rng.standard_normal((b, smax, kv, d)).astype(np.float32))
              .to(cuda, dt) for _ in range(2))
    args = (qs.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2))
    kw = dict(window=window, softcap=softcap, q_offset=pos)
    assert route(dt, 1, d) == "decode"
    before = flash_attention.launches_by_route["decode"]
    got = flash_attention(*args, **kw)
    again = flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route["decode"] == before + 2
    want = flash_attention_plain(*args, **kw)
    assert got.dtype == dt and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() < TOL[dtype]
    assert torch.equal(got, again)


LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}  # of the largest |lse|


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_lse_matches_plain(cuda, case, dtype):
    """The decode kernels' logsumexp (``return_lse``: the one-chunk
    block's, or the merge's over several chunks) against the plain
    version's, a row with no key exactly -1e30; the output has the same
    bits with and without it, so serving, which does not ask, is
    unchanged; two runs give the same bits."""
    b, h, kv, smax, d, pos, window, softcap = DECODE_CASES[case]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    qs = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32)).to(cuda, dt)
    ck, cv = (torch.from_numpy(rng.standard_normal((b, smax, kv, d)).astype(np.float32))
              .to(cuda, dt) for _ in range(2))
    args = (qs.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2))
    kw = dict(window=window, softcap=softcap, q_offset=pos)
    before = flash_attention.launches_by_route["decode"]
    o, lse = flash_attention(*args, return_lse=True, **kw)
    o2, lse2 = flash_attention(*args, return_lse=True, **kw)
    served = flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route["decode"] == before + 3
    assert lse.shape == (b, h, 1) and lse.dtype == torch.float32
    assert torch.equal(o, served) and torch.equal(o, o2) and torch.equal(lse, lse2)
    _, want = flash_attention_plain(*args, return_lse=True, **kw)
    _lse_close(lse.cpu().numpy(), want.cpu().numpy(), LSE_TOL[dtype])


@pytest.mark.cuda
def test_decode_kernel_refuses_unaligned_cache(cuda):
    """The decode kernel reads K and V rows in 16-byte vectors: a cache
    view whose rows are not 16-byte aligned is refused before any launch."""
    q = torch.zeros(1, 2, 1, 64, device=cuda)
    k = torch.zeros(1, 2, 9, 65, device=cuda)[..., 1:]
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned for the decode route"):
        flash_attention(q, k, k, q_offset=8)
    assert flash_attention.launches == before


# ------------------------------------------------------------- gradients
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of the largest gradient


def _grads(fn, q, k, v, w):
    """Gradients of sum(fn(q, k, v) * w) with respect to q, k and v."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    (fn(q, k, v).float() * w).sum().backward()
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_gradients_match_jax_grad(jx, case):
    """CPU inputs that need a gradient take the plain version, which
    autograd differentiates: equal to ``jax.grad`` of the oracle."""
    import jax

    jnp, _, ref = jx
    b, h, kv, sq, sk, d, causal, window, softcap, off = CASES[case]
    q, k, v = _inputs(3, b, h, kv, sq, sk, d)
    w = np.random.default_rng(4).standard_normal((b, h, sq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)

    def loss(qj, kj, vj):
        return (ref(qj, kj, vj, **kw).astype(jnp.float32) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax_side(jnp, q, k, v, "float32"))
    g = h // kv
    want = [np.asarray(want[0])] + [np.asarray(x).reshape(b, kv, g, sk, d).sum(2)
                                    for x in want[1:]]
    before = flash_attention.launches
    got = _grads(lambda *t: flash_attention(*t, **kw),
                 *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(w))
    assert flash_attention.launches == before
    for name, gt, wt in zip("qkv", got, want):
        assert gt.shape == wt.shape, name
        assert np.abs(gt.numpy() - wt).max() <= 1e-4 * np.abs(wt).max(), name


# (b, h, kv, s, d, causal, window, softcap)
BWD_CASES = {
    "causal": (2, 2, 2, 128, 64, True, None, None),
    "gqa": (2, 4, 2, 160, 128, True, None, None),
    "g5_ragged": (1, 10, 2, 77, 128, True, None, None),
    "window_softcap": (1, 4, 2, 200, 128, True, 64, 30.0),
    "non_causal_hd80": (2, 2, 1, 150, 80, False, None, None),
    "hd96_window": (1, 2, 2, 130, 96, True, 40, None),
    "hd112": (1, 4, 1, 96, 112, True, None, 20.0),
    "non_causal_window": (1, 2, 2, 100, 64, False, 30, None),
}


def _bwd_inputs(device, dtype, b, h, kv, s, d, seed=6):
    """q, k, v as views of [B, S, N, D] tensors (the model's layout) and
    the output gradient's weights."""
    gen = torch.Generator().manual_seed(seed)

    def draw(n):
        return torch.randn(b, s, n, d, generator=gen).to(device, dtype).transpose(1, 2)

    w = torch.randn(b, h, s, d, generator=gen).to(device)
    return draw(h), draw(kv), draw(kv), w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_kernel_matches_plain_autograd(cuda, case, dtype):
    b, h, kv, s, d, causal, window, softcap = BWD_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, w = _bwd_inputs(cuda, dt, b, h, kv, s, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_attention.backward_launches
    by_route = dict(flash_attention.backward_launches_by_route)
    got = _grads(lambda *t: flash_attention(*t, **kw), q, k, v, w)
    again = _grads(lambda *t: flash_attention(*t, **kw), q, k, v, w)
    torch.cuda.synchronize()
    assert flash_attention.backward_launches == before + 2
    r = "wgmma" if dtype == "bfloat16" else "fma"
    assert flash_attention.backward_launches_by_route[r] == by_route[r] + 2
    want = _grads(lambda *t: flash_attention_plain(*t, **kw), q, k, v, w)
    for name, g, g2, wt in zip("qkv", got, again, want):
        assert g.dtype == dt and g.shape == wt.shape, name
        err = (g.float() - wt.float()).abs().max().item()
        assert err <= GRAD_TOL[dtype] * wt.float().abs().max().item(), (name, err)
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_backward_refuses_what_it_does_not_compute(cuda):
    """A call needing a gradient that the backward kernels do not compute
    raises before the forward launches: no fallback."""
    q = torch.zeros(1, 2, 8, 64, device=cuda, requires_grad=True)
    k = torch.zeros(1, 2, 8, 64, device=cuda)
    before = (flash_attention.launches, flash_attention.backward_launches)
    for args, kw in (((q, k, k), dict(q_offset=3)),
                     ((q[:, :, :1], k, k), dict(q_offset=7)),
                     ((q, k[:, :, :6], k[:, :, :6]), {}),
                     ((q[..., :32], k[..., :32], k[..., :32]), {})):
        with pytest.raises(NotImplementedError, match="backward kernel"):
            flash_attention(*args, **kw)
    assert (flash_attention.launches, flash_attention.backward_launches) == before
    # without grad mode the same forward runs
    with torch.no_grad():
        flash_attention(q, k, k, q_offset=3)


def _jax_lse(jnp, q, k, causal, window, softcap, q_offset=0):
    """JAX's logsumexp over keys of the oracle's scores (its formula:
    scaled, softcapped, masked to -1e30), K repeated to H heads, query i at
    position i + q_offset."""
    import jax

    g = q.shape[1] // k.shape[1]
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(np.repeat(k, g, 1)),
                   preferred_element_type=jnp.float32) * q.shape[-1] ** -0.5
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    iq = jnp.arange(q.shape[2])[:, None] + q_offset
    jk = jnp.arange(k.shape[2])[None, :]
    mask = jnp.ones((q.shape[2], k.shape[2]), bool)
    if causal:
        mask &= jk <= iq
    if window is not None:
        mask &= jk > iq - window
    return np.asarray(jax.nn.logsumexp(jnp.where(mask[None, None], s, -1e30), axis=-1))


# (b, h, kv, sk, d, pos, window, softcap): one decode query at q_offset
# pos, as a rank of a cache sharded by positions asks for it (pos >= Sk:
# the query lies past the shard)
LSE_DECODE_CASES = {
    "decode_pos77": (2, 4, 2, 128, 64, 77, None, None),
    "decode_window": (2, 4, 2, 128, 64, 100, 16, None),
    "decode_softcap_hd80": (1, 4, 4, 128, 80, 90, None, 30.0),
    "decode_past_the_keys": (1, 4, 2, 64, 64, 100, None, None),
    "decode_past_the_keys_window": (2, 6, 2, 64, 112, 70, 10, 20.0),
    "decode_no_key": (1, 2, 1, 64, 64, 100, 8, None),
}


def _lse_close(lse, want, rtol):
    """A row that sees a key within ``rtol`` of the largest such |lse|
    (or 1); a row that sees none exactly -1e30, as JAX's rounds in fp32."""
    none = want <= -1e29
    assert np.array_equal(lse[none], want[none]) and (want[none] == np.float32(-1e30)).all()
    seen = ~none
    if seen.any():
        err = np.abs(lse[seen] - want[seen]).max()
        assert err <= rtol * max(np.abs(want[seen]).max(), 1.0), err


@pytest.mark.parametrize("case", sorted(BWD_CASES) + sorted(LSE_DECODE_CASES))
def test_plain_lse_matches_jax_logsumexp(jx, case):
    """``flash_attention_plain(..., return_lse=True)``'s logsumexp, what the
    forward kernels keep for the backward and the decode kernels give a
    merge over key shards, against JAX's over the oracle's scores, also at
    q_offset >= Sk, with a window, a softcap and a row with no key; its
    output is the plain output, and ``flash_attention(..., return_lse=True)``
    gives the same pair on CPU tensors."""
    jnp = jx[0]
    if case in BWD_CASES:
        b, h, kv, s, d, causal, window, softcap = BWD_CASES[case]
        sq, sk, pos = s, s, 0
    else:
        b, h, kv, sk, d, pos, window, softcap = LSE_DECODE_CASES[case]
        sq, causal = 1, True
    q, k, v = _inputs(5, b, h, kv, sq, sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=pos)
    o, lse = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   return_lse=True, **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert torch.equal(o, _plain(q, k, v, "float32", causal, window, softcap, pos))
    o2, lse2 = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), return_lse=True, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _lse_close(lse.numpy(), _jax_lse(jnp, q, k, causal, window, softcap, pos), 1e-5)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_autograd_and_jax_grad(jx, case):
    """The explicit plain backward from (o, lse), the backward kernels'
    plain version, against autograd through ``flash_attention_plain`` and
    ``jax.grad`` of the oracle, fp32 within 1e-5 of the largest
    gradient."""
    import jax

    jnp, _, ref = jx
    b, h, kv, s, d, causal, window, softcap = BWD_CASES[case]
    q, k, v = _inputs(7, b, h, kv, s, s, d)
    w = np.random.default_rng(8).standard_normal((b, h, s, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    qt, kt, vt, wt = (torch.from_numpy(a) for a in (q, k, v, w))
    o, lse = flash_attention_plain(qt, kt, vt, return_lse=True, **kw)
    got = flash_attention_backward_plain(qt, kt, vt, o, lse, wt, **kw)
    auto = _grads(lambda *t: flash_attention_plain(*t, **kw), qt, kt, vt, wt)

    def loss(qj, kj, vj):
        return (ref(qj, kj, vj, **kw).astype(jnp.float32) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax_side(jnp, q, k, v, "float32"))
    g = h // kv
    want = [np.asarray(want[0])] + [np.asarray(x).reshape(b, kv, g, s, d).sum(2)
                                    for x in want[1:]]
    for name, gt, at, jt in zip("qkv", got, auto, want):
        assert gt.shape == jt.shape and gt.dtype == torch.float32, name
        tol = 1e-5 * np.abs(jt).max()
        assert np.abs(gt.numpy() - at.numpy()).max() <= tol, name
        assert np.abs(gt.numpy() - jt).max() <= tol, name


def test_backward_route_and_lse_stride():
    """bf16 takes the wgmma backward, fp32 the FMA one; a head's logsumexp
    rows are padded to a multiple of 64."""
    assert backward_route(torch.bfloat16) == "wgmma"
    assert backward_route(torch.float32) == "fma"
    assert LSE_ROWS == 64
    assert [lse_stride(s) for s in (2, 64, 65, 77, 1500, 2048)] == [64, 64, 128, 128, 1536, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_forward_kernel_lse_matches_plain(cuda, case, dtype):
    """The forward kernel's logsumexp (the fp32 tiled kernel's and the
    bf16 wgmma kernel's) against the plain version's on the same inputs;
    asked for or not, the output has the same bits, so serving, which
    does not ask, is unchanged."""
    from repro_torch.kernels.flash_attention import _launch

    b, h, kv, s, d, causal, window, softcap = BWD_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, _ = _bwd_inputs(cuda, dt, b, h, kv, s, d, seed=9)
    scale = d ** -0.5
    win = window if window is not None and window <= s else 0
    o, lse = _launch(q, k, v, causal, win, softcap, scale, 0, want_lse=True)
    o2 = _launch(q, k, v, causal, win, softcap, scale, 0)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, lse_stride(s))
    assert torch.equal(o, o2)
    _, want = flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                                    return_lse=True)
    err = (lse[..., :s] - want).abs().max().item()
    assert err <= 1e-5 * max(want.abs().max().item(), 1.0), err
