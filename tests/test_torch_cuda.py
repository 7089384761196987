"""The port's CUDA kernels on the card, held against their plain PyTorch
versions (``repro_torch.kernels.ref``) on the same inputs: the paged
kernels (ragged, paged decode), the slot-contiguous ones (flash, decode)
and the WKV6 recurrence, and the engines (both layouts; granite, rwkv,
qwen2-moe, jamba and llava's image prefixes) and whisper's prefill and
decode against the CPU; the attention kernels also at whisper-small's
shapes (hd 64 at GQA group 1, non-causal over 1,500 keys, one query row
over them) and llava-next-34b's (GQA group 7). Every test needs
a CUDA card (marker ``cuda``) and skips without one. The file imports
neither JAX nor the reference package, so it runs where only the port's
dependencies are installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Inputs come from numpy seeds; the paged ones in the serving runner's
ragged layout (tile-aligned spans, pad tokens at pos -1, pages at
scattered ids). The four attention kernels have two bodies each, counted
apart (``ops.body_counts``): bf16/fp16 operands (and int8 pages under a
bf16 q) take the tensor cores, float32 the CUDA cores; the bf16 cases
check which ran. The decode kernels' tensor-core bodies split each row's
keys over blocks of ``SPLIT_KEYS`` positions, so their cases cross split
boundaries.
Tolerances: float32 atol = rtol = 1e-5 with TF32 off (both sides sum the
same float32 terms in another order); a bf16 output row (token, head)
within 2^-7 of its largest |value| plus 1e-4 (one bf16 rounding moves a
value by at most 2^-8 of it; the rest is float32 order). Pad rows must be
exactly 0. A WKV6 state from bf16 inputs is float32 arithmetic on the same
rounded values: rtol 1e-4 (sums over T steps in another order). The WKV6
kernel splits a head's value columns over blocks, stages its rows in tiles
of ``STEPS_PER_TILE`` steps and sums a launch of fewer steps over other
lanes (``row_lanes``), so its cases cross tile boundaries on both sides and
hold a row's bits equal alone and inside a batch.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_attention, flash_attention, ops,
                                 ragged_attention, wkv6)
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import SPLIT_KEYS as KPS
from repro_torch.kernels.ragged_attention import TILE_Q

F32_TOL = dict(atol=1e-5, rtol=1e-5)
ROW_REL, ROW_ATOL = 2.0 ** -7, 1e-4

# (history, new tokens) per request: decode rows, prefill chunks with and
# without history, a row with no history at all
MIXED = [(9, 1), (0, 11), (24, 1), (8, 8), (31, 3), (0, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(rng, n_pages, bs, hkv, hd):
    return [torch.from_numpy(rng.randn(n_pages, bs, hkv, hd)
                             .astype(np.float32)) for _ in range(2)]


def _assert_rows_close(got, want):
    """bf16 ``got`` against float32 ``want``, each output row held by its
    own size."""
    d = (got.float() - want).abs().amax(-1)
    lim = ROW_REL * want.abs().amax(-1) + ROW_ATOL
    assert bool((d <= lim).all()), float((d / lim).max())


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def _check(got, want, dtype):
    """f32 outputs at F32_TOL; bf16/fp16 outputs row by row against the
    float32 plain version."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    else:
        assert got.dtype == dtype
        _assert_rows_close(got, want)


def _ragged(specs, hq, hkv, hd, bs, seed=0):
    rng = np.random.RandomState(seed)
    nb = max(-(-(h + n) // bs) for h, n in specs) + 1
    n_pages = len(specs) * nb + 1                      # + the trash page
    tables = rng.permutation(n_pages - 1).astype(np.int32).reshape(
        len(specs), nb)
    rows, poss = [], []
    for r, (h, n) in enumerate(specs):
        na = -(-n // TILE_Q) * TILE_Q
        rows += [r] * na
        poss += list(range(h, h + n)) + [-1] * (na - n)
    rows += [0] * TILE_Q                               # an all-pad tile
    poss += [-1] * TILE_Q
    k, v = _pool(rng, n_pages, bs, hkv, hd)
    q = torch.from_numpy(rng.randn(len(rows), hq, hd).astype(np.float32))
    return (q, k, v, torch.from_numpy(tables),
            torch.tensor(rows, dtype=torch.int32),
            torch.tensor(poss, dtype=torch.int32))


def _decode(lens, hq, hkv, hd, bs, seed=0):
    rng = np.random.RandomState(seed)
    b = len(lens)
    nb = -(-max(lens) // bs) + 1
    n_pages = b * nb + 1
    tables = rng.permutation(n_pages - 1)[:b * nb].astype(np.int32)
    k, v = _pool(rng, n_pages, bs, hkv, hd)
    q = torch.from_numpy(rng.randn(b, 1, hq, hd).astype(np.float32))
    return (q, k, v, torch.from_numpy(tables.reshape(b, nb)),
            torch.tensor(lens, dtype=torch.int32))


def _to(dev, args):
    return [a.to(dev) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,bs", [(16, 4), (16, 16), (64, 8), (128, 16),
                                   (128, 32)])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_cuda_ragged_f32_matches_plain(cuda, group, hd, bs):
    """(128, 32) f32 pages hold more vectors than the loader keeps in
    flight, so its tail load runs too."""
    args = _to(cuda, _ragged(MIXED, 2 * group, 2, hd, bs))
    ops.reset_launch_counts()
    got = ragged_attention.ragged_paged_attention(*args)
    assert ops.launch_counts()["ragged_paged_attention"] == 1
    want = ref.ragged_paged_attention_reference(*args)
    torch.testing.assert_close(got, want, **F32_TOL)
    assert bool((got[args[5] < 0] == 0).all())


# longer histories than MIXED: several 64-key stages, decode tiles that
# split each stage's keys four ways, and a chunk whose tiles reach past 64
LONG = [(130, 1), (0, 37), (70, 20), (63, 1), (64, 1), (0, 1)]


def _bodies(name):
    counts = ops.body_counts()
    return counts[f"{name}/tensor_core"], counts[f"{name}/cuda_core"]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp16"])
@pytest.mark.parametrize("hd,bs", [(16, 4), (32, 16), (64, 8), (128, 16)])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("specs", [MIXED, LONG], ids=["mixed", "long"])
def test_cuda_ragged_bf16_matches_plain(cuda, specs, group, hd, bs,
                                        kv_dtype):
    """A bf16 q over bf16 pages takes the tensor-core body, over fp16 pages
    the CUDA-core one; each output row within its limit of the float32
    plain version, pad rows exactly 0. hd 128 runs granite's 8 kv heads.
    A full tile at group 1 or 2 splits each stage's keys four ways, at 3
    or 4 two ways, at 8 not at all; a decode tile always four ways."""
    hkv = 8 if hd == 128 else 2
    q, k, v, tb, row, pos = _to(cuda, _ragged(specs, hkv * group, hkv, hd,
                                              bs, seed=hd + group))
    q, k, v = q.bfloat16(), k.to(DTYPES[kv_dtype]), v.to(DTYPES[kv_dtype])
    ops.reset_launch_counts()
    got = ragged_attention.ragged_paged_attention(q, k, v, tb, row, pos)
    assert got.dtype == torch.bfloat16
    assert _bodies("ragged_paged_attention") == (
        (1, 0) if kv_dtype == "bf16" else (0, 1))
    want = ref.ragged_paged_attention_reference(q.float(), k.float(),
                                                v.float(), tb, row, pos)
    _assert_rows_close(got, want)
    assert bool((got[pos < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd,bs", [(16, 4), (64, 16), (128, 16)])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("specs", [MIXED, LONG], ids=["mixed", "long"])
def test_cuda_ragged_int8_matches_plain(cuda, specs, group, hd, bs,
                                        q_dtype):
    """int8 pages under a float32 q take the CUDA-core body, held to
    1e-5; under a bf16 q the tensor-core body (scale and zero factored out
    of both products), each output row within its limit of the float32
    plain version. Pad rows exactly 0."""
    q, k, v, tb, row, pos = _to(cuda, _ragged(specs, 2 * group, 2, hd, bs,
                                              seed=2))
    kq, ks, kz = ref.quantize_kv(k)
    vq, vs, vz = ref.quantize_kv(v)
    quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
    q = q.to(DTYPES[q_dtype])
    ops.reset_launch_counts()
    got = ragged_attention.ragged_paged_attention(q, kq, vq, tb, row, pos,
                                                  kv_quant=quant)
    assert ops.launch_counts()["ragged_paged_attention_q8"] == 1
    assert _bodies("ragged_paged_attention_q8") == (
        (0, 1) if q_dtype == "f32" else (1, 0))
    want = ref.ragged_paged_attention_reference(q.float(), kq, vq, tb, row,
                                                pos, kv_quant=quant)
    _check(got, want, q.dtype)
    assert bool((got[pos < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hd,bs", [(16, 4), (64, 16), (128, 16)])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_cuda_paged_decode_matches_plain(cuda, group, hd, bs):
    args = _to(cuda, _decode([37, 1, 0, 50, 16], 2 * group, 2, hd, bs))
    ops.reset_launch_counts()
    got = decode_attention.paged_decode_attention(*args)
    assert ops.launch_counts()["paged_decode_attention"] == 1
    want = ref.paged_decode_attention_reference(*args)
    torch.testing.assert_close(got, want, **F32_TOL)
    assert bool((got[2] == 0).all())                  # kv_len 0


# decode kv_len sets: the main path's, and one on either side of a split
# boundary (an empty row, one key, one whole split, a split and one key)
SPLIT_LENS = [[1024, 777, 300, 1], [0, 1, KPS, KPS + 1, 1024]]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp16"])
@pytest.mark.parametrize("lens", SPLIT_LENS, ids=["main", "edges"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_cuda_paged_decode_bf16_matches_plain(cuda, group, hd, lens,
                                              kv_dtype):
    """A bf16 q over bf16 pages takes the tensor-core body split over keys,
    over fp16 pages the CUDA-core one; each output row within its limit of
    the float32 plain version, a kv_len 0 row exactly 0. hd 128 runs
    granite's 8 kv heads."""
    hkv = 8 if hd == 128 else 2
    q, k, v, tb, kl = _to(cuda, _decode(lens, hkv * group, hkv, hd, 16,
                                        seed=hd + group))
    q, k, v = q.bfloat16(), k.to(DTYPES[kv_dtype]), v.to(DTYPES[kv_dtype])
    ops.reset_launch_counts()
    got = decode_attention.paged_decode_attention(q, k, v, tb, kl)
    assert _bodies("paged_decode_attention") == (
        (1, 0) if kv_dtype == "bf16" else (0, 1))
    want = ref.paged_decode_attention_reference(q.float(), k.float(),
                                                v.float(), tb, kl)
    _assert_rows_close(got, want)
    assert bool((got[kl == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_split_is_deterministic(cuda, layout):
    """The tensor-core decode bodies give the same bits on a second call and
    with the table's width (paged: extra entries naming random pages) or
    the cache's S doubled: a key's split depends on its position alone."""
    lens = [1024, 777, 300, 1, 0, KPS, KPS + 1]
    torch.manual_seed(0)
    if layout == "paged":
        q, k, v, tb, kl = _decode(lens, 32, 8, 128, 16, seed=21)
        wide = torch.cat([tb, torch.randint(0, k.shape[0], tb.shape,
                                            dtype=torch.int32)], 1)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        q, k, v, tb, wide, kl = _to(cuda, (q, k, v, tb, wide, kl))
        runs = [decode_attention.paged_decode_attention(q, k, v, t, kl)
                for t in (tb, tb, wide)]
    else:
        q, k, v, kl = _contig_decode(lens, 1040, 32, 8, 128, seed=22)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        kw, vw = (torch.cat([a, torch.randn(a.shape).bfloat16()], 1)
                  for a in (k, v))
        q, k, v, kw, vw, kl = _to(cuda, (q, k, v, kw, vw, kl))
        runs = [decode_attention.decode_attention(q, kk, vv, kl)
                for kk, vv in ((k, v), (k, v), (kw, vw))]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], runs[2])


@pytest.mark.cuda
def test_cuda_masked_keys_never_reach_the_sum(cuda):
    """NaN past every token's span (the trash page, the rest of a last
    page) must not leak: masked keys are skipped, not multiplied by 0."""
    q, k, v, tb, row, pos = _ragged(MIXED, 4, 2, 16, 4)
    v[-1] = float("nan")
    for r, (h, n) in enumerate(MIXED):                # the rest of each page
        last = h + n - 1
        k[tb[r, last // 4], last % 4 + 1:] = float("nan")
        v[tb[r, last // 4], last % 4 + 1:] = float("nan")
    out = ragged_attention.ragged_paged_attention(
        *_to(cuda, (q, k, v, tb, row, pos)))
    assert bool(torch.isfinite(out).all())
    q, k, v, tb, kl = _decode([5, 9], 4, 2, 16, 4)
    for b, n in enumerate(kl.tolist()):               # the rest of each page
        k[tb[b, n // 4], n % 4:] = float("nan")
        v[tb[b, n // 4], n % 4:] = float("nan")
    out = decode_attention.paged_decode_attention(*_to(cuda, (q, k, v, tb,
                                                              kl)))
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_cuda_body_counts_follow_the_dtypes(cuda):
    """Each launch counts once in ``launch_counts`` and once under the body
    the C entry point chose: the tensor cores for 16-bit operands (and int8
    pages under a bf16 q), the CUDA cores for float32 and for fp16 pages
    under a bf16 q."""
    q, k, v, tb, row, pos = _to(cuda, _ragged(MIXED, 4, 2, 16, 4))
    kq, ks, kz = ref.quantize_kv(k)
    vq, vs, vz = ref.quantize_kv(v)
    quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
    ops.reset_launch_counts()
    for qq, kk, vv, kvq in ((q, k, v, None), (q.bfloat16(), k.bfloat16(),
                                              v.bfloat16(), None),
                            (q.bfloat16(), k.half(), v.half(), None),
                            (q, kq, vq, quant), (q.bfloat16(), kq, vq, quant),
                            (q.bfloat16(), kq, vq, quant)):
        ops.ragged_paged_attention(qq, kk, vv, tb, row, pos, kv_quant=kvq)
    fq, fk, fv = _to(cuda, _qkv(1, 9, 9, 4, 2, 16))
    for dt in (torch.float32, torch.bfloat16, torch.float16,
               torch.bfloat16):
        ops.flash_attention(fq.to(dt), fk.to(dt), fv.to(dt))
    dq, dk, dv, dtb, dkl = _to(cuda, _decode([5, 9], 4, 2, 16, 4))
    for qq, kk, vv in ((dq, dk, dv), (dq.bfloat16(), dk.bfloat16(),
                                      dv.bfloat16()),
                       (dq.bfloat16(), dk.half(), dv.half())):
        ops.paged_decode_attention(qq, kk, vv, dtb, dkl)
    cq, ck, cv, ckl = _to(cuda, _contig_decode([5, 9], 16, 4, 2, 16))
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        ops.decode_attention(cq.to(dt), ck.to(dt), cv.to(dt), ckl)
    counts = ops.launch_counts()
    assert counts["ragged_paged_attention"] == 3
    assert counts["ragged_paged_attention_q8"] == 3
    assert counts["flash_attention"] == 4
    assert counts["paged_decode_attention"] == 3
    assert counts["decode_attention"] == 3
    assert ops.body_counts() == {
        "ragged_paged_attention/tensor_core": 1,
        "ragged_paged_attention/cuda_core": 2,
        "ragged_paged_attention_q8/tensor_core": 2,
        "ragged_paged_attention_q8/cuda_core": 1,
        "paged_decode_attention/tensor_core": 1,
        "paged_decode_attention/cuda_core": 2,
        "decode_attention/tensor_core": 2,
        "decode_attention/cuda_core": 1,
        "flash_attention/tensor_core": 3,
        "flash_attention/cuda_core": 1}
    ops.reset_launch_counts()
    assert not any(ops.body_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_cuda_masked_keys_never_reach_the_sum_bf16(cuda, pages):
    """The tensor-core body multiplies whole tiles, so NaN past every
    token's span (the trash page, the rest of each last page; for int8
    pages their scales and zeros too) must be kept out by the zero-filled
    loads: no output turns non-finite, and pad rows stay exactly 0."""
    q, k, v, tb, row, pos = _ragged(LONG, 8, 2, 64, 16, seed=11)
    quant = None
    if pages == "int8":
        k, ks, kz = ref.quantize_kv(k)
        v, vs, vz = ref.quantize_kv(v)
        quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
        poisoned = list(quant.values())
    else:
        k, v = k.bfloat16(), v.bfloat16()
        poisoned = [k, v]
    for a in poisoned:
        a[-1] = float("nan")                          # the trash page
        for r, (h, n) in enumerate(LONG):             # the rest of each page
            last = h + n - 1
            a[tb[r, last // 16], last % 16 + 1:] = float("nan")
            for blk in range(last // 16 + 1, tb.shape[1]):
                a[tb[r, blk]] = float("nan")          # pages past the span
    q, k, v, tb, row, pos = _to(cuda, (q.bfloat16(), k, v, tb, row, pos))
    if quant is not None:
        quant = {n: a.to(cuda) for n, a in quant.items()}
    ops.reset_launch_counts()
    out = ragged_attention.ragged_paged_attention(q, k, v, tb, row, pos,
                                                  kv_quant=quant)
    name = ("ragged_paged_attention_q8" if quant
            else "ragged_paged_attention")
    assert _bodies(name) == (1, 0)
    assert bool(torch.isfinite(out).all())
    assert bool((out[pos < 0] == 0).all())
    fq, fk, fv = _qkv(1, 70, 150, 8, 2, 64, seed=12)
    fk[:, 70:] = float("nan")                         # past causal row 69
    fv[:, 70:] = float("nan")
    out = flash_attention.flash_attention(
        *[a.to(cuda, torch.bfloat16) for a in (fq, fk, fv)], causal=True)
    assert bool(torch.isfinite(out).all())
    if pages == "int8":
        return
    # the decode kernels' splits: the rest of each last page, whole pages
    # past each span, cache rows at or past kv_len
    lens = [5, 9, KPS + 2, 64, 1]
    q, k, v, tb, kl = _decode(lens, 8, 2, 64, 16, seed=13)
    k, v = k.bfloat16(), v.bfloat16()
    for a in (k, v):
        a[-1] = float("nan")
        for b, n in enumerate(lens):
            a[tb[b, n // 16], n % 16:] = float("nan")
            for blk in range(n // 16 + 1, tb.shape[1]):
                a[tb[b, blk]] = float("nan")
    ops.reset_launch_counts()
    out = decode_attention.paged_decode_attention(
        *_to(cuda, (q.bfloat16(), k, v, tb, kl)))
    assert _bodies("paged_decode_attention") == (1, 0)
    assert bool(torch.isfinite(out).all())
    q, k, v, kl = _contig_decode([5, 33, 0, 64, KPS + 2], 2 * KPS, 8, 2, 64,
                                 seed=14)
    for b, n in enumerate(kl.tolist()):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    out = decode_attention.decode_attention(
        *_to(cuda, (q.bfloat16(), k.bfloat16(), v.bfloat16(), kl)))
    assert _bodies("decode_attention") == (1, 0)
    assert bool(torch.isfinite(out).all())
    assert bool((out[2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged-int8"])
def test_cuda_bf16_model_prefill_matches_plain_kernels(cuda, monkeypatch,
                                                       layout):
    """A bf16 smoke-width model's prefill through the tensor-core bodies
    against the same call on the card with ``ops`` patched to the plain
    versions: last-token logits within 2^-5 of their largest |value| (the
    kernels round P to bf16 and their sums run in another order; the
    difference is carried through the layers' bf16 activations)."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(smoke_variant(get_config("granite-3-8b")),
                              dtype="bfloat16")
    m = Model(cfg)
    params = m.init(torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 75)).astype(np.int32)).to(cuda)
    kw = dict(paged=layout != "contiguous",
              kv_dtype="int8" if layout == "paged-int8" else None)
    ops.reset_launch_counts()
    got, _ = m.prefill(params, tokens, 128, **kw)
    kernel = ("flash_attention" if layout == "contiguous"
              else "ragged_paged_attention_q8" if layout == "paged-int8"
              else "ragged_paged_attention")
    assert _bodies(kernel) == (cfg.n_layers, 0)
    monkeypatch.setattr(ops, "flash_attention", ref.mha_reference)
    monkeypatch.setattr(ops, "ragged_paged_attention",
                        ref.ragged_paged_attention_reference)
    want, _ = m.prefill(params, tokens, 128, **kw)
    assert got.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs().amax(-1)
    lim = 2.0 ** -5 * want.float().abs().amax(-1)
    assert bool((d <= lim).all()), float((d / lim).max())


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v, tb, row, pos = _to(cuda, _ragged([(3, 1)], 4, 2, 16, 4))
    with pytest.raises(ValueError, match="head_dim"):
        ragged_attention.ragged_paged_attention(q[..., :8].contiguous(),
                                                k[..., :8].contiguous(),
                                                v[..., :8].contiguous(), tb,
                                                row, pos)
    with pytest.raises(ValueError, match="kv_quant"):
        ragged_attention.ragged_paged_attention(q, k.to(torch.int8),
                                                v.to(torch.int8), tb, row,
                                                pos)
    odd = torch.empty(k.numel() + 1, device=cuda)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ragged_attention.ragged_paged_attention(q, odd, v, tb, row, pos)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention.paged_decode_attention(
            q[:1, None].transpose(2, 3), k, v, tb,
            torch.ones(1, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cuda_model_prefill_matches_cpu(cuda, kv_dtype):
    """``Model.prefill`` through the kernels on the card against the same
    call on the CPU (plain versions), one sequence, float32 smoke model."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    m = Model(smoke_variant(get_config("granite-3-8b")))
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, m.cfg.vocab, (1, 13)).astype(np.int32))
    want, _ = m.prefill(params, tokens, 32, page_size=4, kv_dtype=kv_dtype)
    ops.reset_launch_counts()
    got, _ = m.prefill({k: _tree_to(v, cuda) for k, v in params.items()},
                       tokens.to(cuda), 32, page_size=4, kv_dtype=kv_dtype)
    assert sum(ops.launch_counts().values()) == m.cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# the slot-contiguous kernels: flash (prefill) and decode attention
# ---------------------------------------------------------------------------

def _qkv(b, sq, sk, hq, hkv, hd, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, n, h, hd).astype(np.float32))
            for n, h in ((sq, hq), (sk, hkv), (sk, hkv))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_cuda_flash_matches_plain(cuda, group, hd, dtype):
    """Causal prefill (Sq = Sk, not a multiple of any tile) at batch 2."""
    dt = DTYPES[dtype]
    q, k, v = [a.to(cuda, dt) for a in _qkv(2, 45, 45, 2 * group, 2, hd)]
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=True)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.mha_reference(q.float(), k.float(), v.float(), causal=True)
    _check(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,q_offset,sq,sk", [
    (True, 0, 300, 300), (True, 17, 40, 57), (True, 70, 9, 33),
    (False, 0, 13, 77), (False, 5, 64, 1)],
    ids=["causal-300", "causal-offset", "causal-offset-past-sk",
         "noncausal", "noncausal-sk1"])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_flash_offsets_and_edges(cuda, dtype, group, causal, q_offset,
                                      sq, sk):
    """float32 through the CUDA-core body (1e-5), bf16 through the
    tensor-core body (each output row within its limit)."""
    dt = DTYPES[dtype]
    q, k, v = [a.to(cuda, dt) for a in _qkv(1, sq, sk, 2 * group, 2, 64,
                                            seed=4)]
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          q_offset=q_offset)
    assert _bodies("flash_attention") == ((0, 1) if dtype == "f32"
                                          else (1, 0))
    want = ref.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                             q_offset=q_offset)
    _check(got, want, dt)


def _contig_decode(lens, s, hq, hkv, hd, seed=0):
    q, k, v = _qkv(len(lens), 1, s, hq, hkv, hd, seed)
    return q, k, v, torch.tensor(lens, dtype=torch.int32)


# (kv_len, S) of the contiguous decode cases: a short strip, and the split
# boundaries of SPLIT_LENS over an S that is no multiple of a split
CONTIG_LENS = [([37, 1, 100, 64, 0], 100), (SPLIT_LENS[1], 1040)]


@pytest.mark.cuda
@pytest.mark.parametrize("lens,s", CONTIG_LENS, ids=["short", "edges"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_cuda_decode_matches_plain(cuda, group, hd, dtype, lens, s):
    """float32 through the CUDA-core body (1e-5); bf16 and fp16 through the
    tensor-core body split over keys (each output row within its limit).
    A kv_len 0 row is exactly 0."""
    dt = DTYPES[dtype]
    q, k, v, kl = _contig_decode(lens, s, 2 * group, 2, hd)
    q, k, v, kl = q.to(cuda, dt), k.to(cuda, dt), v.to(cuda, dt), kl.to(cuda)
    ops.reset_launch_counts()
    got = decode_attention.decode_attention(q, k, v, kl)
    assert ops.launch_counts()["decode_attention"] == 1
    assert _bodies("decode_attention") == ((0, 1) if dtype == "f32"
                                           else (1, 0))
    want = ref.decode_attention_reference(q.float(), k.float(), v.float(),
                                          kl)
    _check(got, want, dt)
    assert bool((got[kl == 0] == 0).all())            # kv_len 0: exactly 0


@pytest.mark.cuda
def test_cuda_contiguous_kernels_never_read_past_the_mask(cuda):
    """NaN in every cache row at or past kv_len, and in every key past the
    causal edge of the last query: no output may turn non-finite."""
    q, k, v, kl = _contig_decode([5, 33, 0, 64], 64, 8, 2, 128, seed=5)
    for b, n in enumerate(kl.tolist()):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    out = decode_attention.decode_attention(*_to(cuda, (q, k, v, kl)))
    assert bool(torch.isfinite(out).all())
    assert bool((out[2] == 0).all())
    q, k, v = _qkv(1, 20, 50, 8, 2, 64, seed=6)
    k[:, 20:] = float("nan")                          # past causal row 19
    v[:, 20:] = float("nan")
    out = flash_attention.flash_attention(*_to(cuda, (q, k, v)), causal=True)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_cuda_contiguous_wrappers_refuse(cuda):
    q, k, v = _to(cuda, _qkv(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(q[..., :8].contiguous(),
                                        k[..., :8].contiguous(),
                                        v[..., :8].contiguous())
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, kv_len=torch.ones(
            1, dtype=torch.int32, device=cuda))
    kl = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention.decode_attention(q[:, :1].contiguous(), k, v,
                                          kl.long())
    with pytest.raises(ValueError, match="one query token"):
        decode_attention.decode_attention(q, k, v, kl)
    with pytest.raises(ValueError, match="dtypes"):
        decode_attention.decode_attention(q[:, :1].contiguous(), k.half(),
                                          v.half(), kl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attention.decode_attention(q[:, :1].contiguous(), k.cpu(), v,
                                          kl)


@pytest.mark.cuda
def test_cuda_contiguous_engine_matches_cpu(cuda):
    """``Engine(paged=False)`` on the card (flash + decode kernels) against
    the same engine on the CPU (plain versions): equal greedy tokens on the
    float32 smoke model, and both kernels launched."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine
    cfg = smoke_variant(get_config("granite-3-8b"))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5], [3, 1, 4, 1, 5]]
    streams = []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, [_tree_to(params, dev)], max_batch=2, max_seq=32,
                     paged=False, device=dev)
        reqs = [eng.submit(p, SamplingParams(max_new=5)) for p in prompts]
        ops.reset_launch_counts()
        eng.run()
        streams.append([list(r.generated) for r in reqs])
    counts = ops.launch_counts()
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    assert counts["ragged_paged_attention"] == 0
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# the WKV6 recurrence (rwkv's time mix)
# ---------------------------------------------------------------------------

STATE_TOL = dict(atol=1e-5, rtol=1e-4)


def _wkv(b, t, h, hd, seed=0):
    """float32 r, k, v, w (B,T,H,hd), u (H,hd) and a state (B,H,hd,hd)."""
    rng = np.random.RandomState(seed)
    r, k, v, w = (torch.from_numpy(rng.randn(b, t, h, hd).astype(np.float32)
                                   * 0.5) for _ in range(4))
    u = torch.from_numpy(rng.randn(h, hd).astype(np.float32) * 0.5)
    s0 = torch.from_numpy(rng.randn(b, h, hd, hd).astype(np.float32) * 0.1)
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True], ids=["zero", "given"])
@pytest.mark.parametrize("t", [1, 33, 100, 412])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_cuda_wkv6_matches_plain(cuda, hd, dtype, t, state):
    """r/k/v in float32 or bf16 with float32 w and u, T below, at and past
    the kernel's 16-step staging, with and without an initial state."""
    r, k, v, w, u, s0 = _wkv(2, t, 2, hd, seed=t + hd)
    dt = DTYPES[dtype]
    r, k, v = (x.to(dt) for x in (r, k, v))
    s0 = s0 if state else None
    want_y, want_s = ref.wkv6_reference(r.float(), k.float(), v.float(), w,
                                        u, s0)
    args = [None if x is None else x.to(cuda) for x in (r, k, v, w, u, s0)]
    y, s_t = ops.wkv6(*args)
    torch.cuda.synchronize()
    _check(y.cpu(), want_y, dt)
    torch.testing.assert_close(s_t.cpu(), want_s,
                               **(F32_TOL if dt == torch.float32
                                  else STATE_TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
def test_cuda_wkv6_full_width_head_and_decay_dtypes(cuda, w_dtype):
    """hd 128 (the kernel's widest) and w in r's own dtype."""
    r, k, v, w, u, s0 = _wkv(1, 40, 2, 128, seed=9)
    r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    w = w.to(DTYPES[w_dtype])
    want_y, want_s = ref.wkv6_reference(r.float(), k.float(), v.float(),
                                        w.float(), u, s0)
    y, s_t = wkv6.wkv6(*(x.to(cuda) for x in (r, k, v, w, u, s0)))
    _check(y.cpu(), want_y, torch.bfloat16)
    torch.testing.assert_close(s_t.cpu(), want_s, **STATE_TOL)


@pytest.mark.cuda
def test_cuda_wkv6_state_in_place_and_padded_steps(cuda):
    """The final state written over the initial one (a cache view updated
    in place) equals a fresh output; steps with w = -1e9 and k = 0 leave
    the state bit for bit as it was."""
    r, k, v, w, u, s0 = (x.to(cuda) for x in _wkv(4, 1, 3, 64, seed=2))
    y_new, s_new = wkv6.wkv6(r, k, v, w, u, s0)
    s = s0.clone()
    y, out = wkv6.wkv6(r, k, v, w, u, s, out_state=s)
    torch.cuda.synchronize()
    assert out is s
    assert torch.equal(y, y_new) and torch.equal(s, s_new)
    r, k, v, w, u, s0 = (x.to(cuda) for x in _wkv(2, 21, 2, 32, seed=4))
    _, s_t = wkv6.wkv6(r, torch.zeros_like(k), v, torch.full_like(w, -1e9),
                       u, s0)
    torch.cuda.synchronize()
    assert torch.equal(s_t, s0)


CT = wkv6.STEPS_PER_TILE


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0, 1, CT - 1, CT, CT + 1, 2 * CT + 1, 412])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_cuda_wkv6_tile_boundaries(cuda, hd, t):
    """float32 from a given state, T on both sides of the staging ring's
    tile boundaries (no step, a partial last tile, exactly one and two
    tiles, one step past), every head width: y and the state to 1e-5."""
    r, k, v, w, u, s0 = _wkv(2, t, 2, hd, seed=7 * t + hd)
    want_y, want_s = ref.wkv6_reference(r, k, v, w, u, s0)
    y, s_t = wkv6.wkv6(*(x.to(cuda) for x in (r, k, v, w, u, s0)))
    torch.cuda.synchronize()
    torch.testing.assert_close(y.cpu(), want_y, **F32_TOL)
    torch.testing.assert_close(s_t.cpu(), want_s, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2 * CT + 5], ids=["decode", "tiles"])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_cuda_wkv6_rows_batch_invariant(cuda, hd, t):
    """Each batch row's y and final state are the same bits launched alone
    as inside a batch of 4 (bf16 r/k/v, float32 w, a given state; a decode
    step, and T past two tiles): a column's sum never meets another
    row's."""
    r, k, v, w, u, s0 = (x.to(cuda) for x in _wkv(4, t, 3, hd,
                                                  seed=13 + hd + t))
    r, k, v = (x.bfloat16() for x in (r, k, v))
    y, s_t = wkv6.wkv6(r, k, v, w, u, s0)
    for b in range(4):
        one = [x[b:b + 1] for x in (r, k, v, w)]
        y1, s1 = wkv6.wkv6(*one, u, s0[b:b + 1])
        torch.cuda.synchronize()
        assert torch.equal(y1, y[b:b + 1]) and torch.equal(s1, s_t[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_wkv6_in_place_over_column_blocks(cuda, hd):
    """hd / COLUMNS_PER_BLOCK blocks a head each read their columns of the
    state before writing them back in place: the same bits as a fresh
    output, over several tiles."""
    assert hd // wkv6.COLUMNS_PER_BLOCK > 1
    r, k, v, w, u, s0 = (x.to(cuda) for x in _wkv(2, 3 * CT + 2, 4, hd,
                                                  seed=hd))
    y_new, s_new = wkv6.wkv6(r, k, v, w, u, s0)
    s = s0.clone()
    y, out = wkv6.wkv6(r, k, v, w, u, s, out_state=s)
    torch.cuda.synchronize()
    assert out is s
    assert torch.equal(y, y_new) and torch.equal(s, s_new)


@pytest.mark.cuda
def test_cuda_wkv6_wrapper_refuses(cuda):
    r, k, v, w, u, s0 = (x.to(cuda) for x in _wkv(1, 5, 2, 16))
    with pytest.raises(ValueError, match="w dtype"):
        wkv6.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w.half(), u)
    with pytest.raises(ValueError, match="u must be"):
        wkv6.wkv6(r, k, v, w, u.bfloat16())
    with pytest.raises(ValueError, match="head_dim"):
        wkv6.wkv6(*(x[..., :8].contiguous() for x in (r, k, v, w)),
                  u[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        wkv6.wkv6(r.transpose(1, 2), k, v, w, u)
    big = torch.zeros(2 * 16 * 16 + 8, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        wkv6.wkv6(r, k, v, w, u, big[:512].view(1, 2, 16, 16),
                  out_state=big[8:].view(1, 2, 16, 16))
    shifted = torch.zeros(r.numel() + 1, device=cuda)[1:].view_as(r)
    with pytest.raises(ValueError, match="16-byte"):
        wkv6.wkv6(shifted, k, v, w, u)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_cuda_rwkv_engine_matches_cpu(cuda, paged):
    """The rwkv smoke model served on the card (WKV6 kernel) against the
    same engine on the CPU (plain version): equal greedy tokens, with slots
    reused, on either layout; only the WKV6 kernel launched."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine
    cfg = smoke_variant(get_config("rwkv6-1.6b"))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5], [3, 1, 4, 1, 5]]
    streams = []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, [_tree_to(params, dev)], max_batch=2, max_seq=32,
                     paged=paged, device=dev)
        reqs = [eng.submit(p, SamplingParams(max_new=5)) for p in prompts]
        ops.reset_launch_counts()
        eng.run()
        streams.append([list(r.generated) for r in reqs])
    counts = ops.launch_counts()
    assert counts["wkv6"] > 0
    assert sum(counts.values()) == counts["wkv6"]
    assert streams[0] == streams[1]


# (arch, engine options, the kernels its path launches)
FAMILY_ENGINES = [
    ("qwen2-moe-a2.7b", dict(paged=True),
     ("ragged_paged_attention", "paged_decode_attention")),
    ("qwen2-moe-a2.7b", dict(paged=True, fused=True),
     ("ragged_paged_attention",)),
    ("qwen2-moe-a2.7b", dict(paged=True, kv_dtype="int8"),
     ("ragged_paged_attention_q8",)),
    ("qwen2-moe-a2.7b", dict(paged=False),
     ("flash_attention", "decode_attention")),
    ("jamba-v0.1-52b", dict(paged=True),
     ("flash_attention", "paged_decode_attention")),
    ("jamba-v0.1-52b", dict(paged=False),
     ("flash_attention", "decode_attention")),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "arch,kw,kernels", FAMILY_ENGINES,
    ids=["moe-paged", "moe-fused", "moe-int8", "moe-contiguous",
         "jamba-paged", "jamba-contiguous"])
def test_cuda_moe_and_hybrid_engines_match_cpu(cuda, arch, kw, kernels):
    """The qwen2-moe and jamba smoke models (jamba at 16 layers: attention
    twice, mamba 14 times, MoE 8 times) served on the card against the
    same engine on the CPU: equal greedy tokens, with slots reused, and
    only the path's attention kernels launched. jamba's paged prefill
    writes its K/V into the pools and runs the flash kernel."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine
    cfg = smoke_variant(get_config(arch))
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(cfg, n_layers=16)
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5], [3, 1, 4, 1, 5]]
    streams = []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, [_tree_to(params, dev)], max_batch=2, max_seq=32,
                     block_size=8, device=dev, **kw)
        reqs = [eng.submit(p, SamplingParams(max_new=5)) for p in prompts]
        ops.reset_launch_counts()
        eng.run()
        streams.append([list(r.generated) for r in reqs])
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in kernels), counts
    assert sum(counts.values()) == sum(counts[k] for k in kernels), counts
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ragged", "paged_decode", "flash",
                                    "decode"])
def test_cuda_attention_kernels_at_qwen2_moe_geometry(cuda, kernel):
    """qwen2-moe-a2.7b's attention: 16 q and 16 kv heads (GQA group 1), hd
    128, bf16, page 16. Each kernel takes its tensor-core body and holds
    every output row within its limit of the float32 plain version."""
    hq = hkv = 16
    hd = 128
    ops.reset_launch_counts()
    if kernel == "ragged":
        q, k, v, tb, row, pos = _to(cuda, _ragged(LONG, hq, hkv, hd, 16,
                                                  seed=11))
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got = ragged_attention.ragged_paged_attention(q, k, v, tb, row, pos)
        want = ref.ragged_paged_attention_reference(
            q.float(), k.float(), v.float(), tb, row, pos)
        name = "ragged_paged_attention"
    elif kernel == "paged_decode":
        q, k, v, tb, kl = _to(cuda, _decode(SPLIT_LENS[0], hq, hkv, hd, 16,
                                            seed=12))
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got = decode_attention.paged_decode_attention(q, k, v, tb, kl)
        want = ref.paged_decode_attention_reference(
            q.float(), k.float(), v.float(), tb, kl)
        name = "paged_decode_attention"
    elif kernel == "flash":
        q, k, v = [a.to(cuda, torch.bfloat16)
                   for a in _qkv(1, 300, 300, hq, hkv, hd, seed=13)]
        got = flash_attention.flash_attention(q, k, v)
        want = ref.mha_reference(q.float(), k.float(), v.float())
        name = "flash_attention"
    else:
        q, k, v, kl = _contig_decode(SPLIT_LENS[0], 1024, hq, hkv, hd,
                                     seed=14)
        q, k, v = [a.to(cuda, torch.bfloat16) for a in (q, k, v)]
        kl = kl.to(cuda)
        got = decode_attention.decode_attention(q, k, v, kl)
        want = ref.decode_attention_reference(q.float(), k.float(),
                                              v.float(), kl)
        name = "decode_attention"
    assert _bodies(name) == (1, 0)
    _assert_rows_close(got, want)


# ---------------------------------------------------------------------------
# KV tiers and the sanitizer on the card
# ---------------------------------------------------------------------------

def _bf16_engine(dev, **kw):
    """The granite smoke model in bfloat16 (bf16 pages, or int8 ones with
    ``kv_dtype``) on ``dev``, weights from a seeded generator."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    cfg = dataclasses.replace(smoke_variant(get_config("granite-3-8b")),
                              dtype="bfloat16")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    return Engine(cfg, [_tree_to(params, dev)], max_batch=2, max_seq=32,
                  block_size=8, paged=True, prefix_cache=True, device=dev,
                  **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_cuda_block_spill_restore_bit_exact(cuda, kv_dtype):
    """Two committed blocks are read to the host, demoted through the
    serialized segment tier, taken back and written into two free blocks of
    the card's pool: every pool leaf's bits are the originals', and the
    ragged kernel's output over the restored blocks equals its output over
    the original ones exactly."""
    from repro_torch.router import KVBlockStore
    from repro_torch.serving.api import SamplingParams
    eng = _bf16_engine(cuda, kv_dtype=kv_dtype)
    eng.submit(list(range(1, 18)), SamplingParams(max_new=2))
    eng.run()
    bm, runner = eng.block_mgr, eng.runner
    src = [bm._index[h] for h in bm.indexed_hashes()][:2]
    dst = [b for b in range(bm.n_blocks) if bm.refcount(b) == 0
           and b not in src and b not in bm._cached][:2]
    assert len(src) == len(dst) == 2
    tier = KVBlockStore(host_capacity_blocks=0)      # demote at once
    for i, blk in enumerate(src):
        payload = runner.read_pages(blk)
        assert all(t.device.type == "cpu" for e in payload for t in e[1:3])
        tier.put(bytes([i]), payload)
    assert tier.demotions == 2 and len(tier.segments) == 2
    for i, blk in enumerate(dst):
        payload, _ = tier.take(bytes([i]))
        runner.write_pages(blk, payload)
    torch.cuda.synchronize()
    cache = runner.workers[0].cache
    for sub in cache.values():
        for arr in sub.values():
            for s, d in zip(src, dst):
                assert torch.equal(arr[:, s].view(torch.uint8),
                                   arr[:, d].view(torch.uint8))
    sub = cache["slot00"]
    quant = ({k: sub[k][0] for k in ("k_scale", "k_zero", "v_scale",
                                     "v_zero")} if kv_dtype else None)
    hq, hd = eng.cfg.n_heads, eng.cfg.head_dim
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(16, hq, hd, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    row = torch.zeros(16, dtype=torch.int32, device=cuda)
    pos = torch.arange(16, dtype=torch.int32, device=cuda)
    outs = []
    ops.reset_launch_counts()
    for blocks in (src, dst):
        tables = torch.tensor([blocks], dtype=torch.int32, device=cuda)
        outs.append(ops.ragged_paged_attention(
            q, sub["k_pages"][0], sub["v_pages"][0], tables, row, pos,
            kv_quant=quant))
    torch.cuda.synchronize()
    name = "ragged_paged_attention_q8" if kv_dtype else \
        "ragged_paged_attention"
    assert ops.launch_counts()[name] == 2
    assert ops.body_counts()[f"{name}/tensor_core"] == 2
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["paged", "fused"])
def test_cuda_sanitized_tiered_engine_clean(cuda, fused):
    """A paged engine on the card with the sanitizer, dispatch's contract
    checks and a tight KV tier: spills, restores, a clean audit, and the
    greedy streams of the same engine with neither."""
    from repro_torch.router import KVBlockStore
    from repro_torch.serving.api import SamplingParams
    prompts = [list(range(1, 18)), [9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8],
               [(5 * i) % 97 + 1 for i in range(20)]]
    churn = [[(31 * j + i) % 500 + 1 for i in range(24)] for j in range(6)]
    streams, tiers = [], []
    for on in (False, True):
        tier = KVBlockStore(host_capacity_blocks=4)
        eng = _bf16_engine(cuda, kv_tier=tier, sanitize=on, fused=fused)
        ops.set_sanitize_mode(on)
        try:
            got = []
            for p in prompts + churn + prompts:
                got.append([ev.token for ev in
                            eng.generate(p, SamplingParams(max_new=4))])
        finally:
            ops.set_sanitize_mode(False)
        streams.append(got)
        tiers.append(tier.stats())
        if on:
            assert eng.sanitizer.events > 0
            assert not eng.sanitizer.check_idle(), eng.sanitizer.report()
    assert tiers[0] == tiers[1]
    assert tiers[1]["spills"] > 0 and tiers[1]["restores"] > 0
    assert tiers[1]["demotions"] > 0
    assert streams[0] == streams[1]
    assert streams[1][:3] == streams[1][-3:]       # restored == first serve


@pytest.mark.cuda
def test_cuda_kernelcheck_refuses_out_of_pool_page_before_launch(cuda):
    """In sanitize mode a page id outside the pool raises the contract
    error on the host, and nothing is launched."""
    from repro_torch.analysis.kernelcheck import KernelContractError
    q = torch.zeros(2, 1, 4, 16, dtype=torch.bfloat16, device=cuda)
    pages = torch.zeros(5, 8, 2, 16, dtype=torch.bfloat16, device=cuda)
    tables = torch.tensor([[0, 1], [2, 5]], dtype=torch.int32, device=cuda)
    kv_len = torch.tensor([9, 12], dtype=torch.int32, device=cuda)
    qr = torch.zeros(8, 4, 16, dtype=torch.bfloat16, device=cuda)
    row = torch.zeros(8, dtype=torch.int32, device=cuda)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    ops.set_sanitize_mode(True)
    try:
        with pytest.raises(KernelContractError, match="page ids outside"):
            ops.paged_decode_attention(q, pages, pages, tables, kv_len)
        with pytest.raises(KernelContractError, match="page ids outside"):
            ops.ragged_paged_attention(qr, pages, pages, tables, row, pos)
    finally:
        ops.set_sanitize_mode(False)
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# the fleet on the card
# ---------------------------------------------------------------------------

def _fleet_round_trip(dev, params):
    """The fleet's scale-to-zero round trip at the smoke widths on ``dev``:
    a routed granite (paged, prefix cache, KV tier, 2-stage cold starts)
    and a slot-contiguous rwkv6 on four servers, P1, P2 and R1 at t=0,
    then again at t=200 after the keepalive reaped both, drained to zero.
    Returns (streams, cold-start log, restored tokens of the second P1)."""
    from repro_torch.core import GB, Gbps, ModelProfile, ServerSpec, SLO
    from repro_torch.core import TimingProfile
    from repro_torch.fleet import FleetFrontend, FleetPolicy
    from repro_torch.serving.api import SamplingParams
    servers = [ServerSpec(f"srv{i}", 16 * Gbps, 12e9, 80 * GB)
               for i in range(4)]
    ff = FleetFrontend(servers, FleetPolicy(keepalive_s=30.0,
                                            proactive_placement=True,
                                            placement_interval_s=10.0,
                                            placement_top_k=2),
                       source_bw=1e5, device=dev)
    timing = TimingProfile(t_cc=0.2, t_l=0.2, t_cu=0.1)
    (gcfg, gp), (rcfg, rp) = params
    ff.register(gcfg, ModelProfile("granite", 8 * GB, timing, SLO(7.5, 0.2)),
                params=gp, routing="kv_affinity", kv_tier_blocks=64,
                block_size=8, max_batch=4, max_seq=64, min_stages=2)
    ff.register(rcfg, ModelProfile("rwkv", 2 * GB, timing, SLO(7.5, 0.2)),
                params=rp, paged=False, max_batch=4, max_seq=64)
    rng = np.random.RandomState(0)
    p1, p2, r1 = (rng.randint(0, 512, n).tolist() for n in (30, 26, 41))
    sp = SamplingParams(max_new=6)
    trace = [(m, t, p, sp) for t in (0.0, 200.0)
             for m, p in (("granite", p1), ("granite", p2), ("rwkv", r1))]
    reqs = ff.run_trace(trace, drain_to=400.0)
    assert all(not mm.slots for mm in ff.models.values())
    return ([r.output for r in reqs], ff.cold_start_log,
            reqs[3].restored_tokens)


@pytest.mark.cuda
def test_cuda_fleet_scale_to_zero_matches_cpu(cuda):
    """The fleet's round trip on the card equals the same fleet's on the
    CPU: streams, cold starts; re-warmed streams equal the first ones; a
    second round trip on the card gives the first's results and leaves no
    more memory allocated than the first did."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    params = []
    for arch in ("granite-3-8b", "rwkv6-1.6b"):
        cfg = smoke_variant(get_config(arch))
        params.append((cfg, Model(cfg).init(torch.Generator().manual_seed(0),
                                            device="cpu")))
    cpu = _fleet_round_trip("cpu", params)
    ops.reset_launch_counts()
    card = _fleet_round_trip("cuda", params)
    counts = ops.launch_counts()
    # a second round trip leaves the card's allocated memory where the
    # first left it (the first also allocates the GEMM library's workspace)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert _fleet_round_trip("cuda", params) == card
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before <= 1 << 20
    for k in ("ragged_paged_attention", "paged_decode_attention", "wkv6"):
        assert counts[k] > 0, counts
    streams, log, restored = card
    assert streams == cpu[0]
    assert streams[3:] == streams[:3]
    assert restored > 0 and restored == cpu[2]
    assert len(log) == 4 and [c["tier"] for c in log[2:]] == ["peer"] * 2
    assert [(c["model"], c["duration"], c["s"]) for c in log] == \
        [(c["model"], c["duration"], c["s"]) for c in cpu[1]]


# ---------------------------------------------------------------------------
# whisper-small's and llava-next-34b's shapes: head dim 64 at GQA group 1,
# non-causal over 1,500 keys (the last 64-key stage holds 28), one query
# row over them (cross-attention at decode), and GQA group 7 (Hq 56 over
# Hkv 8), which is no power of two
# ---------------------------------------------------------------------------

# (batch, Sq, Sk, Hq, Hkv, hd, causal)
ENCDEC_VLM_FLASH = {
    "whisper-encoder": (2, 1500, 1500, 12, 12, 64, False),
    "whisper-cross": (2, 300, 1500, 12, 12, 64, False),
    "whisper-cross-decode": (4, 1, 1500, 12, 12, 64, False),
    "whisper-decoder": (1, 412, 412, 12, 12, 64, True),
    "llava-prefix-prefill": (1, 988, 988, 56, 8, 128, True),
    "g7-hd64-offset-rows": (2, 45, 77, 14, 2, 64, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(ENCDEC_VLM_FLASH))
def test_cuda_flash_at_encdec_and_vlm_shapes(cuda, shape):
    """bf16 flash on the tensor-core body at whisper's and llava's shapes,
    each output row within its limit of the float32 plain version."""
    b, sq, sk, hq, hkv, hd, causal = ENCDEC_VLM_FLASH[shape]
    q, k, v = [a.to(cuda, torch.bfloat16)
               for a in _qkv(b, sq, sk, hq, hkv, hd, seed=7)]
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    assert _bodies("flash_attention") == (1, 0)
    want = ref.mha_reference(q.float(), k.float(), v.float(), causal=causal)
    _assert_rows_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(12, 12, 64), (56, 8, 128)],
                         ids=["whisper", "llava"])
@pytest.mark.parametrize("lens", SPLIT_LENS, ids=["main", "edges"])
def test_cuda_decode_kernels_at_encdec_and_vlm_shapes(cuda, geometry, lens):
    """Both decode kernels (bf16, tensor-core bodies split over keys) at
    whisper's self-attention (hd 64, G 1) and llava's (G 7) geometry: each
    output row within its limit, a kv_len 0 row exactly 0."""
    hq, hkv, hd = geometry
    q, k, v, kl = _to(cuda, _contig_decode(lens, 1040, hq, hkv, hd, seed=8))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ops.reset_launch_counts()
    got = decode_attention.decode_attention(q, k, v, kl)
    assert _bodies("decode_attention") == (1, 0)
    _assert_rows_close(got, ref.decode_attention_reference(
        q.float(), k.float(), v.float(), kl))
    assert bool((got[kl == 0] == 0).all())
    q, k, v, tb, kl = _to(cuda, _decode(lens, hq, hkv, hd, 16, seed=9))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = decode_attention.paged_decode_attention(q, k, v, tb, kl)
    assert _bodies("paged_decode_attention") == (1, 0)
    _assert_rows_close(got, ref.paged_decode_attention_reference(
        q.float(), k.float(), v.float(), tb, kl))
    assert bool((got[kl == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("specs", [MIXED, LONG], ids=["mixed", "long"])
def test_cuda_ragged_at_group_7(cuda, specs, pages):
    """The ragged kernel at llava's GQA group 7 (Hq 56 over Hkv 8, hd 128)
    on its tensor-core body, a bf16 q over bf16 or int8 pages: each output
    row within its limit of the float32 plain version, pad rows exactly
    0."""
    q, k, v, tb, row, pos = _to(cuda, _ragged(specs, 56, 8, 128, 16,
                                              seed=10))
    q = q.bfloat16()
    quant = None
    name = "ragged_paged_attention"
    if pages == "int8":
        k, ks, kz = ref.quantize_kv(k)
        v, vs, vz = ref.quantize_kv(v)
        quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
        name += "_q8"
    else:
        k, v = k.bfloat16(), v.bfloat16()
    ops.reset_launch_counts()
    got = ragged_attention.ragged_paged_attention(q, k, v, tb, row, pos,
                                                  kv_quant=quant)
    assert _bodies(name) == (1, 0)
    want = ref.ragged_paged_attention_reference(
        q.float(), k if quant else k.float(), v if quant else v.float(), tb,
        row, pos, kv_quant=quant)
    _assert_rows_close(got, want)
    assert bool((got[pos < 0] == 0).all())


@pytest.mark.cuda
def test_cuda_encdec_and_vlm_prefix_match_cpu(cuda):
    """Whisper's and llava's smoke variants in float32 on the card (the
    kernels' CUDA-core bodies) against the CPU (plain versions): whisper's
    prefill and two decode steps to 1e-5 of the CPU logits, flash and
    contiguous decode launched; llava prefix requests beside text-only ones
    through engines of both layouts give the CPU's greedy streams."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine
    cfg = smoke_variant(get_config("whisper-small"))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(11)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 9)).astype(
        np.int32))
    frames = torch.from_numpy((rng.standard_normal(
        (2, cfg.n_audio_frames, cfg.d_model)) * 0.02).astype(np.float32))
    logits = []
    ops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        m, p = Model(cfg), _tree_to(params, dev)
        lg, cache = m.prefill(p, toks.to(dev), 16, frames=frames.to(dev),
                              paged=False)
        out = [lg]
        for n in range(2):
            tok = lg.argmax(-1)[:, None].to(torch.int32)
            lg, cache = m.decode_step(p, cache, tok, torch.full(
                (2, 1), 9 + n, dtype=torch.int32, device=dev))
            out.append(lg)
        logits.append([x.cpu() for x in out])
    counts = ops.launch_counts()
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    for got, want in zip(logits[1], logits[0]):
        torch.testing.assert_close(got, want, atol=1e-5 * float(
            want.abs().max()), rtol=0)

    cfg = smoke_variant(get_config("llava-next-34b"))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prefix = (torch.randn((cfg.n_image_tokens, cfg.d_model),
                          generator=torch.Generator().manual_seed(1)) * 0.02)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5], [3, 1, 4, 1, 5]]
    for paged in (False, True):
        streams = []
        for dev in ("cpu", "cuda"):
            eng = Engine(cfg, [_tree_to(params, dev)], max_batch=2,
                         max_seq=32, block_size=8, paged=paged, device=dev)
            reqs = [eng.submit(p, SamplingParams(max_new=5),
                               prefix_embeds=prefix if i != 1 else None)
                    for i, p in enumerate(prompts)]
            eng.run()
            streams.append([list(r.generated) for r in reqs])
        assert streams[0] == streams[1], paged
