"""The port's CUDA kernels on the card, held against their plain PyTorch
versions (``repro_torch.kernels.ref``) on the same inputs: the paged
kernels (ragged, paged decode), the slot-contiguous ones (flash, decode)
and the WKV6 recurrence, and the engines (both layouts; granite, rwkv,
qwen2-moe, jamba and llava's image prefixes) and whisper's prefill and
decode against the CPU; the attention kernels also at whisper-small's
shapes (hd 64 at GQA group 1, non-causal over 1,500 keys, one query row
over them) and llava-next-34b's (GQA group 7); the manual-TP and pipelined
prefills on a one-rank NCCL group against the CPU; a cold start's stage
loaded through the loader's ring of pinned slots against the CPU's
per-leaf copies, bit for bit. Every test needs
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
keys over blocks of ``SPLIT_KEYS`` positions, a cluster of up to 8 blocks
a (sequence, kv head) in one launch, so their cases cross split and
cluster boundaries, vary the cluster size and hold the two layouts' bits
equal. The ragged kernel splits
its decode runs over the same blocks (in two kernels), and their bf16
rows must equal paged decode's bit for bit, while its prefill spans run on
``wgmma`` with pages by TMA (64 or 128 rows a block, as the launch
reports), so its cases also put NaN past every row's limit, mix runs
inside a span, and replay a launch from a CUDA graph.
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

Gradients (the training slice): a flash call whose inputs require grad
goes through ``ops._FlashFn`` (the kernel forward, the plain version's
autodiff backward), so its gradients are the plain autograd's on the same
inputs: float32 at 1e-5 and bf16 within one bf16 rounding of the largest
|value| of each gradient (2^-8, both sides round the same float32 sums);
the other four kernels refuse an input that requires grad. A smoke train
step on the card equals the CPU's to 1e-4 of each gradient's largest
|value| (float32, TF32 off), under each remat mode.

The reference's modes: under ``causal_skip`` flash still launches its
kernel on the card (no plain version runs); the ``append`` decode step
(plain torch over the old rows, the new token merged in closed form) is
held against the contiguous decode kernel, and a smoke engine under it
against scatter and the CPU.
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


# the spans' edges: a decode row over 9 splits, a chunk whose keys wrap
# the two-stage ring twice (5 stages), decode tiles beside prefill tiles
# and two chunks meeting inside one span (spans of 2 tiles at G 3 or 4, 4
# at G 2, 8 at G 1), a full tile of a chunk with no history
EDGES = [(1100, 1), (5, 11), (300, 13), (40, 1), (0, 8), (70, 6)]
SPECS = [MIXED, LONG, EDGES]
SPEC_IDS = ["mixed", "long", "edges"]


def _poison(pools, tables, specs, bs):
    """NaN in every page slot past each request's last position (the rest
    of its last page, its pages after that) and in the trash page (the
    pool's last, which no table names): keys past every row's limit."""
    for a in pools:
        a[-1] = float("nan")
        for r, (h, n) in enumerate(specs):
            last = h + n - 1
            a[tables[r, last // bs], last % bs + 1:] = float("nan")
            for blk in range(last // bs + 1, tables.shape[1]):
                a[tables[r, blk]] = float("nan")


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp16"])
@pytest.mark.parametrize("hd,bs", [(16, 4), (32, 16), (64, 8), (128, 16)])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("specs", SPECS, ids=SPEC_IDS)
def test_cuda_ragged_bf16_matches_plain(cuda, specs, group, hd, bs,
                                        kv_dtype):
    """A bf16 q over bf16 pages takes the tensor-core body (decode runs
    split over keys, the rest in spans on wgmma), over fp16 pages the
    CUDA-core one; each output row within its limit of the float32 plain
    version, pad rows exactly 0. hd 128 runs granite's 8 kv heads. At G 3
    and 7 a warpgroup's 64 rows hold spare rows; ``edges`` puts NaN past
    every row's limit and in the trash page, after the plain version ran
    on the clean pages."""
    hkv = 8 if hd == 128 else 2
    q, k, v, tb, row, pos = _ragged(specs, hkv * group, hkv, hd, bs,
                                    seed=hd + group)
    q, k, v = q.bfloat16(), k.to(DTYPES[kv_dtype]), v.to(DTYPES[kv_dtype])
    want = ref.ragged_paged_attention_reference(
        *_to(cuda, (q.float(), k.float(), v.float(), tb, row, pos)))
    if specs is EDGES:
        _poison([k, v], tb, specs, bs)
    q, k, v, tb, row, pos = _to(cuda, (q, k, v, tb, row, pos))
    ops.reset_launch_counts()
    got = ragged_attention.ragged_paged_attention(q, k, v, tb, row, pos)
    assert got.dtype == torch.bfloat16
    assert _bodies("ragged_paged_attention") == (
        (1, 0) if kv_dtype == "bf16" else (0, 1))
    _assert_rows_close(got, want)
    assert bool((got[pos < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd,bs", [(16, 4), (32, 8), (64, 16), (128, 16)])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("specs", SPECS, ids=SPEC_IDS)
def test_cuda_ragged_int8_matches_plain(cuda, specs, group, hd, bs,
                                        q_dtype):
    """int8 pages under a float32 q take the CUDA-core body, held to
    1e-5; under a bf16 q the tensor-core body (scale and zero factored out
    of both products, in the decode runs' split and in the spans alike),
    each output row within its limit of the float32 plain version. Pad
    rows exactly 0. ``edges`` puts NaN in the scale/zero pools past every
    row's limit and in the trash page, after the plain version ran."""
    q, k, v, tb, row, pos = _ragged(specs, 2 * group, 2, hd, bs, seed=2)
    kq, ks, kz = ref.quantize_kv(k)
    vq, vs, vz = ref.quantize_kv(v)
    quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
    q = q.to(DTYPES[q_dtype])
    want = ref.ragged_paged_attention_reference(
        *_to(cuda, (q.float(), kq, vq, tb, row, pos)),
        kv_quant={n: a.to(cuda) for n, a in quant.items()})
    if specs is EDGES:
        _poison(list(quant.values()), tb, specs, bs)
    q, kq, vq, tb, row, pos = _to(cuda, (q, kq, vq, tb, row, pos))
    quant = {n: a.to(cuda) for n, a in quant.items()}
    ops.reset_launch_counts()
    got = ragged_attention.ragged_paged_attention(q, kq, vq, tb, row, pos,
                                                  kv_quant=quant)
    assert ops.launch_counts()["ragged_paged_attention_q8"] == 1
    assert _bodies("ragged_paged_attention_q8") == (
        (0, 1) if q_dtype == "f32" else (1, 0))
    _check(got, want, q.dtype)
    assert bool((got[pos < 0] == 0).all())


def _ragged_int8(args):
    """(q, k, v, tables, row, pos) with k and v quantized: the int8 pages
    and their kv_quant pools."""
    q, k, v, tb, row, pos = args
    kq, ks, kz = ref.quantize_kv(k)
    vq, vs, vz = ref.quantize_kv(v)
    return (q, kq, vq, tb, row, pos), {"k_scale": ks, "k_zero": kz,
                                       "v_scale": vs, "v_zero": vz}


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("tile", [64, 128])
def test_cuda_ragged_span_tile_is_reported(cuda, tile, pages):
    """The entry point launches its spans at 64 query rows a block (one
    consumer warpgroup) or 128 (two) and reports which; each holds the
    plain version. granite's attention (Hq 32, Hkv 8, hd 128): a 412-token
    chunk beside two decode rows takes 64 rows, a 1,100-token one 128."""
    n = 412 if tile == 64 else 1100
    args = _ragged([(0, n), (300, 1), (30, 1)], 32, 8, 128, 16, seed=tile)
    quant = None
    if pages == "int8":
        args, quant = _ragged_int8(args)
        quant = {k: a.to(cuda) for k, a in quant.items()}
    q, k, v, tb, row, pos = _to(cuda, args)
    q = q.bfloat16()
    if pages == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    ops.reset_launch_counts()
    got = ragged_attention.ragged_paged_attention(q, k, v, tb, row, pos,
                                                  kv_quant=quant)
    assert ragged_attention.TILE_LAUNCHES == {64: int(tile == 64),
                                              128: int(tile == 128)}
    want = ref.ragged_paged_attention_reference(
        q.float(), k if quant else k.float(), v if quant else v.float(), tb,
        row, pos, kv_quant=quant)
    _assert_rows_close(got, want)
    assert bool((got[pos < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_cuda_ragged_without_split_matches_plain(cuda, pages, monkeypatch):
    """Where the split's workspace would pass ``SPLIT_WORKSPACE_BYTES`` the
    launch runs no split and the spans walk the decode runs too: the same
    function, each row within its limit, pad rows 0."""
    monkeypatch.setattr(ragged_attention, "SPLIT_WORKSPACE_BYTES", 0)
    args = _ragged(EDGES, 8, 2, 64, 8, seed=7)
    quant = None
    if pages == "int8":
        args, quant = _ragged_int8(args)
        quant = {k: a.to(cuda) for k, a in quant.items()}
    q, k, v, tb, row, pos = _to(cuda, args)
    q = q.bfloat16()
    if pages == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    got = ragged_attention.ragged_paged_attention(q, k, v, tb, row, pos,
                                                  kv_quant=quant)
    want = ref.ragged_paged_attention_reference(
        q.float(), k if quant else k.float(), v if quant else v.float(), tb,
        row, pos, kv_quant=quant)
    _assert_rows_close(got, want)
    assert bool((got[pos < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_cuda_ragged_decode_rows_equal_paged_decode(cuda, group, hd):
    """Over bf16 pages a decode row (the one real token of its run) takes
    the paged decode kernel's split body and combine: its output equals
    ``paged_decode_attention``'s bit for bit on the same pages, table rows
    and lengths, with a 20-token chunk in the same launch (held to the
    plain version) and pads exactly 0."""
    lens = [1024, 777, 300, 1, KPS, KPS + 1]
    hkv = 8 if hd == 128 else 2
    q, k, v, tb, kl = _decode(lens, hkv * group, hkv, hd, 16,
                              seed=31 + group)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    rng = np.random.RandomState(group)
    hq = hkv * group
    # tiles: decode row 0, a chunk on row 3 (3 tiles), decode rows 1 .. 5
    # (row 3's decode tile is two runs away from its chunk), a pad tile
    qs, rows, poss, at = [], [], [], {}
    for b in [0, "chunk", 1, 2, 3, 4, 5, "pad"]:
        if b == "chunk":
            qs.append(torch.from_numpy(rng.randn(24, hq, hd).astype(
                np.float32)).bfloat16())
            rows += [3] * 24
            poss += list(range(100, 120)) + [-1] * 4
            continue
        tile = torch.from_numpy(rng.randn(TILE_Q, hq, hd).astype(
            np.float32)).bfloat16()
        rows += [0 if b == "pad" else b] * TILE_Q
        if b == "pad":
            poss += [-1] * TILE_Q
        else:
            at[b] = sum(x.shape[0] for x in qs)
            tile[0] = q[b, 0]
            poss += [lens[b] - 1] + [-1] * (TILE_Q - 1)
        qs.append(tile)
    rq = torch.cat(qs)
    row = torch.tensor(rows, dtype=torch.int32)
    pos = torch.tensor(poss, dtype=torch.int32)
    q, k, v, tb, kl, rq, row, pos = _to(cuda, (q, k, v, tb, kl, rq, row,
                                               pos))
    paged = decode_attention.paged_decode_attention(q, k, v, tb, kl)
    ops.reset_launch_counts()
    got = ragged_attention.ragged_paged_attention(rq, k, v, tb, row, pos)
    assert _bodies("ragged_paged_attention") == (1, 0)
    for b, t in at.items():
        assert torch.equal(got[t], paged[b, 0]), b
    want = ref.ragged_paged_attention_reference(rq.float(), k.float(),
                                                v.float(), tb, row, pos)
    _assert_rows_close(got, want)
    assert bool((got[pos < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_cuda_ragged_graph_replay(cuda, pages):
    """The wrapper reads no device data, so one ragged launch can be
    captured in a ``torch.cuda.CUDAGraph``; replayed on new inputs copied
    into the captured buffers, it equals an eager launch on them bit for
    bit, and the plain version within each row's limit."""
    sets = [_ragged(EDGES, 8, 2, 64, 16, seed=s) for s in (41, 42)]
    quants = [None, None]
    if pages == "int8":
        sets, quants = zip(*[_ragged_int8(a) for a in sets])
    sets = [_to(cuda, a) for a in sets]
    for a in sets:
        a[0] = a[0].bfloat16()
        if pages == "bf16":
            a[1], a[2] = a[1].bfloat16(), a[2].bfloat16()
    quants = [None if qn is None else {k: a.to(cuda) for k, a in qn.items()}
              for qn in quants]
    static, squant = sets[0], quants[0]

    def launch():
        return ragged_attention.ragged_paged_attention(*static,
                                                       kv_quant=squant)

    launch()                                          # build, configure
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch()
    for dst, src in zip(static, sets[1]):
        dst.copy_(src)
    for k in squant or {}:
        squant[k].copy_(quants[1][k])
    graph.replay()
    torch.cuda.synchronize()
    eager = launch()
    assert torch.equal(out, eager)
    q, k, v, tb, row, pos = static
    want = ref.ragged_paged_attention_reference(
        q.float(), k if squant else k.float(), v if squant else v.float(),
        tb, row, pos, kv_quant=squant)
    _assert_rows_close(out, want)
    assert bool((out[pos < 0] == 0).all())


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


def _as_strips(pages, tables, s):
    """Each row's first s positions gathered through its table: the same
    keys as slot-contiguous caches (B, s, Hkv, hd)."""
    return torch.stack([pages[t].reshape(-1, *pages.shape[2:])[:s]
                        for t in tables.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 7])
def test_cuda_contiguous_decode_equals_paged_decode(cuda, group, hd):
    """The two decode kernels run one split and combine: the same keys laid
    out as pages under a table and as cache strips (S = the table's
    width) give the same bits, each row within its limit of the plain
    version, a kv_len 0 row exactly 0."""
    lens = [1024, 777, 300, 1, 0, KPS, KPS + 1]
    hkv = 8 if hd == 128 else 2
    q, k, v, tb, kl = _decode(lens, hkv * group, hkv, hd, 16,
                              seed=41 + group)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kc, vc = (_as_strips(a, tb, tb.shape[1] * 16) for a in (k, v))
    q, k, v, tb, kl, kc, vc = _to(cuda, (q, k, v, tb, kl, kc, vc))
    ops.reset_launch_counts()
    paged = decode_attention.paged_decode_attention(q, k, v, tb, kl)
    contig = decode_attention.decode_attention(q, kc, vc, kl)
    assert _bodies("paged_decode_attention") == (1, 0)
    assert _bodies("decode_attention") == (1, 0)
    assert torch.equal(paged, contig)
    _assert_rows_close(contig, ref.decode_attention_reference(
        q.float(), kc.float(), vc.float(), kl))
    assert bool((contig[kl == 0] == 0).all())


# lengths at the cluster's edges: one key, one split, a split and a key,
# one split a block of a cluster of 8, one more (a block walks two), and
# a row that no power of two divides
EDGE_LENS = [1, KPS, KPS + 1, 8 * KPS, 8 * KPS + 1, 4097]


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_LENS)
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_split_is_deterministic_at_cluster_edges(cuda, layout,
                                                             n):
    """A row of n keys beside a row of none, under a table (or a cache S)
    as narrow as the row and under one 4,096 positions wider: the cluster
    size and the splits each block walks change with the width (C =
    min(8, n_split)), the bits do not; the row is within its limit of the
    plain version and the empty row exactly 0."""
    hq, hkv, hd, bs = 32, 8, 128, 16
    lens = [n, 0]
    rng = np.random.RandomState(n)
    if layout == "paged":
        q, k, v, tb, kl = _decode(lens, hq, hkv, hd, bs, seed=n)
        narrow = tb[:, :-(-n // bs)].contiguous()
        wide = torch.cat([narrow, torch.from_numpy(rng.randint(
            0, k.shape[0], (2, 4096 // bs)).astype(np.int32))], 1)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        q, k, v, narrow, wide, kl = _to(cuda, (q, k, v, narrow, wide, kl))
        runs = [decode_attention.paged_decode_attention(q, k, v, t, kl)
                for t in (narrow, wide)]
        want = ref.paged_decode_attention_reference(q.float(), k.float(),
                                                    v.float(), narrow, kl)
        caps = [narrow.shape[1] * bs, wide.shape[1] * bs]
        name = "paged_decode_attention"
    else:
        q, k, v, kl = _contig_decode(lens, n, hq, hkv, hd, seed=n)
        kw, vw = (torch.cat([a, torch.from_numpy(rng.randn(
            2, 4096, hkv, hd).astype(np.float32))], 1) for a in (k, v))
        q, k, v, kw, vw = (a.bfloat16() for a in (q, k, v, kw, vw))
        q, k, v, kw, vw, kl = _to(cuda, (q, k, v, kw, vw, kl))
        runs = []
        for kk, vv in ((k, v), (kw, vw)):
            runs.append(decode_attention.decode_attention(q, kk, vv, kl))
        want = ref.decode_attention_reference(q.float(), k.float(),
                                              v.float(), kl)
        caps = [n, n + 4096]
        name = "decode_attention"
    launch = decode_attention.LAST_LAUNCH[name]
    assert launch["cluster"] == decode_attention.cluster_size(
        decode_attention.split_count(caps[1])) == 8
    assert torch.equal(runs[0], runs[1])
    _assert_rows_close(runs[0], want)
    assert bool((runs[0][1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_kv_len_zero_reads_nothing(cuda, layout):
    """Rows of no key come back exactly 0 from every block of their
    cluster, and nothing of theirs is read: every page and cache row holds
    NaN."""
    lens = [0, 0, 0]
    if layout == "paged":
        q, k, v, tb, kl = _decode([1040] * 3, 32, 8, 128, 16, seed=3)
        k[:], v[:] = float("nan"), float("nan")
        q, k, v, tb = _to(cuda, (q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 tb))
        kl = torch.tensor(lens, dtype=torch.int32, device=cuda)
        out = decode_attention.paged_decode_attention(q, k, v, tb, kl)
    else:
        q, k, v, kl = _contig_decode(lens, 1040, 32, 8, 128, seed=3)
        k[:], v[:] = float("nan"), float("nan")
        q, k, v, kl = _to(cuda, (q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 kl))
        out = decode_attention.decode_attention(q, k, v, kl)
    assert bool((out == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_refuses_a_cluster_the_card_cannot_hold(
        cuda, layout, monkeypatch):
    """A launch whose clusters fail the occupancy check (16 blocks, past
    the portable 8, without the non-portable attribute) raises and counts
    no launch: no other launch stands in for it. At the portable size the
    same call runs."""
    lens = [2100, 5]
    q, k, v, tb, kl = _decode(lens, 32, 8, 128, 16, seed=9)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    if layout == "paged":
        args = _to(cuda, (q, k, v, tb, kl))
        fn, name = decode_attention.paged_decode_attention, \
            "paged_decode_attention"
        want = ref.paged_decode_attention_reference(
            *[a.float() if a.is_floating_point() else a for a in args])
    else:
        kc, vc = (_as_strips(a, tb, tb.shape[1] * 16) for a in (k, v))
        args = _to(cuda, (q, kc, vc, kl))
        fn, name = decode_attention.decode_attention, "decode_attention"
        want = ref.decode_attention_reference(
            *[a.float() if a.is_floating_point() else a for a in args])
    monkeypatch.setattr(decode_attention, "CLUSTER_MAX", 16)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        fn(*args)
    assert ops.launch_counts()[name] == 0
    monkeypatch.setattr(decode_attention, "CLUSTER_MAX", 8)
    out = fn(*args)
    torch.cuda.synchronize()
    assert decode_attention.LAST_LAUNCH[name]["cluster"] == 8
    _assert_rows_close(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 64])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_bits_do_not_depend_on_the_cluster_size(
        cuda, layout, group, monkeypatch):
    """Clusters of 1, 2, 4 or 8 blocks a (sequence, kv head) walk the same
    splits in other blocks and combine them in the same order: the same
    bits, each row within its limit of the plain version. The launch never
    takes more blocks than asked (``LAST_LAUNCH``); G 64 fills a block's
    row groups (no key split), G 1 at 8 kv heads leaves most rows empty."""
    hkv = 1 if group == 64 else 8
    q, k, v, tb, kl = _decode([1024, 777, 300, 1, 0], hkv * group, hkv, 128,
                              16, seed=group)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    if layout == "paged":
        args = _to(cuda, (q, k, v, tb, kl))
        fn, name = decode_attention.paged_decode_attention, \
            "paged_decode_attention"
        want = ref.paged_decode_attention_reference(
            *[a.float() if a.is_floating_point() else a for a in args])
    else:
        kc, vc = (_as_strips(a, tb, tb.shape[1] * 16) for a in (k, v))
        args = _to(cuda, (q, kc, vc, kl))
        fn, name = decode_attention.decode_attention, "decode_attention"
        want = ref.decode_attention_reference(
            *[a.float() if a.is_floating_point() else a for a in args])
    outs = []
    for most in (1, 2, 4, 8):
        monkeypatch.setattr(decode_attention, "CLUSTER_MAX", most)
        outs.append(fn(*args))
        launch = decode_attention.LAST_LAUNCH[name]
        assert 1 <= launch["cluster"] <= most
        assert launch["partials"] == "workspace"
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    _assert_rows_close(outs[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,bs", [(16, 5), (16, 6), (16, 12), (32, 5),
                                   (32, 6), (64, 12), (128, 12), (128, 80)])
def test_cuda_paged_decode_any_page_size(cuda, hd, bs):
    """Pages of any size: the tensor-core body's TMA boxes are the largest
    power of two that divides the page (so none crosses a page), each on
    128 bytes of shared memory even where a row is 32 bytes. The output
    equals the contiguous kernel's on the same keys bit for bit and is
    within each row's limit of the plain version."""
    lens = [300, KPS + 1, 1, 0, 8 * KPS + 3]
    hkv = 2
    q, k, v, tb, kl = _decode(lens, 4 * hkv, hkv, hd, bs, seed=bs + hd)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kc, vc = (_as_strips(a, tb, tb.shape[1] * bs) for a in (k, v))
    q, k, v, tb, kl, kc, vc = _to(cuda, (q, k, v, tb, kl, kc, vc))
    ops.reset_launch_counts()
    got = decode_attention.paged_decode_attention(q, k, v, tb, kl)
    assert _bodies("paged_decode_attention") == (1, 0)
    assert torch.equal(got, decode_attention.decode_attention(q, kc, vc, kl))
    _assert_rows_close(got, ref.paged_decode_attention_reference(
        q.float(), k.float(), v.float(), tb, kl))
    assert bool((got[kl == 0] == 0).all())


@pytest.mark.cuda
def test_cuda_engine_refuses_a_page_size_its_prefill_cannot_take(cuda):
    """A bf16 paged engine of an attention-only model on the card (its
    prefills, and under ``fused`` or int8 pages its decode rows, go through
    the ragged kernel's tensor-core body) refuses ``block_size=12`` with
    ``ValueError`` at construction, before anything is built or admitted;
    at 16 it serves. A float32 engine (the CUDA-core bodies) takes 12 and
    serves the CPU's stream."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine
    cfg = smoke_variant(get_config("granite-3-8b"))
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = _tree_to(Model(bf).init(torch.Generator().manual_seed(0),
                                      device="cpu"), cuda)
    for kw in ({}, {"fused": True}, {"kv_dtype": "int8"}):
        with pytest.raises(ValueError, match="page size 12"):
            Engine(bf, [bparams], max_batch=2, max_seq=32, block_size=12,
                   device=cuda, **kw)
    prompt = [1, 2, 3, 4, 5, 6, 7]
    eng = Engine(bf, [bparams], max_batch=2, max_seq=32, block_size=16,
                 device=cuda)
    req = eng.submit(prompt, SamplingParams(max_new=4))
    eng.run()
    assert len(req.generated) == 4
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    streams = []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, [_tree_to(params, dev)], max_batch=2, max_seq=32,
                     block_size=12, device=dev)
        req = eng.submit(prompt, SamplingParams(max_new=5))
        eng.run()
        streams.append(list(req.generated))
    assert streams[0] == streams[1]


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
        "flash_attention/cuda_core": 1,
        "flash_attention/backward_plain": 0}
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
@pytest.mark.parametrize("group", [1, 2, 3, 4, 7, 8])
def test_cuda_flash_matches_plain(cuda, group, hd, dtype):
    """Causal prefill (Sq = Sk, not a multiple of any tile) at batch 2; G 7
    leaves a spare row in the tensor-core body's 64-row tile."""
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
    (False, 0, 13, 77), (False, 5, 64, 1), (True, 0, 600, 600),
    (True, 130, 40, 170), (False, 0, 300, 1500)],
    ids=["causal-300", "causal-offset", "causal-offset-past-sk",
         "noncausal", "noncausal-sk1", "causal-ring-wraps",
         "causal-offset-past-a-stage", "noncausal-sk1500"])
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


# (B, Sq, Sk, Hq, Hkv, hd, causal, q_offset, tile) of the tensor-core
# body's cases at each tile: G 7's spare rows (one in a 64-row tile, two in
# a 128-row one), the K/V ring wrapping (stages of 64 keys in the 64-row
# tile, 128 in the 128-row one), batch 2 with Sk no multiple of a stage,
# q_offset past a stage boundary, non-causal over 1,500 keys at hd 64
FLASH_TILE_CASES = {
    "64-g7-spare-row": (2, 45, 77, 14, 2, 64, True, 0, 64),
    "64-ring-wraps": (1, 600, 600, 4, 2, 128, True, 0, 64),
    "64-offset-past-a-stage": (1, 40, 170, 8, 2, 64, True, 130, 64),
    "64-noncausal-sk1500": (1, 300, 1500, 12, 12, 64, False, 0, 64),
    "128-g7-spare-rows": (2, 600, 600, 14, 2, 128, True, 0, 128),
    "128-b2-sk-not-a-stage": (2, 1100, 1100, 8, 2, 128, True, 0, 128),
    "128-offset-past-a-stage": (2, 600, 900, 16, 4, 64, True, 300, 128),
    "128-noncausal-sk1500": (2, 700, 1500, 12, 12, 64, False, 0, 128),
}


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _tile_of(launch):
    """``launch()``'s output and the tile (query rows a block) that the
    entry point reports its one flash launch took."""
    before = dict(flash_attention.TILE_LAUNCHES)
    out = launch()
    took = [t for t, n in flash_attention.TILE_LAUNCHES.items()
            if n != before[t]]
    assert len(took) == 1, took
    return out, took[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(FLASH_TILE_CASES))
def test_cuda_flash_tensor_core_tiles(cuda, case, dtype):
    """The tensor-core body at each of its two tiles (the tile the shape
    takes is asserted), each output row within its limit of the float32
    plain version."""
    b, sq, sk, hq, hkv, hd, causal, q_offset, tile = FLASH_TILE_CASES[case]
    dt = DTYPES[dtype]
    q, k, v = [a.to(cuda, dt) for a in _qkv(b, sq, sk, hq, hkv, hd,
                                            seed=8)]
    ops.reset_launch_counts()
    got, took = _tile_of(lambda: flash_attention.flash_attention(
        q, k, v, causal=causal, q_offset=q_offset))
    assert _bodies("flash_attention") == (1, 0)
    assert took == tile
    want = ref.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                             q_offset=q_offset)
    _check(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 128])
def test_cuda_flash_never_reads_past_the_edge_on_either_tile(cuda, tile):
    """NaN in every K/V row past the causal edge of the last query (the
    stage that crosses the edge holds both kinds): no output may turn
    non-finite, and every row equals the plain version over the finite
    keys."""
    b, hq, hkv = (1, 8, 2) if tile == 64 else (2, 32, 8)
    sq, sk = 300, 700
    q, k, v = _qkv(b, sq, sk, hq, hkv, 128, seed=9)
    k[:, sq:] = float("nan")
    v[:, sq:] = float("nan")
    q, k, v = [a.to(cuda, torch.bfloat16) for a in (q, k, v)]
    out, took = _tile_of(lambda: flash_attention.flash_attention(
        q, k, v, causal=True))
    assert took == tile
    assert bool(torch.isfinite(out).all())
    want = ref.mha_reference(q.float(), k[:, :sq].float(), v[:, :sq].float(),
                             causal=True)
    _assert_rows_close(out, want)


# (B, Sq, Hq, Hkv) -> the flash tile on a 132-SM H100: granite-3-8b's
# serving prefill, train step and 32k prefills; llava's prefix (G 7, two
# spare rows a 128-row tile); whisper's encoder and decoder prefills and a
# cross-attention decode row; G 64 (one position a 64-row tile) on either
# side of 132 blocks
FLASH_TILES = [((1, 412, 32, 8), 64), ((1, 4096, 32, 8), 128),
               ((2, 32768, 32, 8), 128), ((1, 8192, 16, 16), 128),
               ((1, 988, 56, 8), 128), ((1, 1500, 12, 12), 128),
               ((1, 412, 12, 12), 64), ((4, 1, 12, 12), 64),
               ((1, 262, 64, 1), 64), ((1, 263, 64, 1), 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile", FLASH_TILES,
                         ids=["x".join(map(str, s)) for s, _ in FLASH_TILES])
def test_flash_tile_rows_follow_the_grid(cuda, shape, tile):
    """The tile a launch reports: 128 rows unless that grid, ceil(Sq /
    (128 // G)) * Hkv * B blocks, is smaller than the card's SMs; then
    64."""
    b, sq, hq, hkv = shape
    q = torch.zeros((b, sq, hq, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((b, sq, hkv, 64), device=cuda, dtype=torch.bfloat16)
    _, took = _tile_of(lambda: flash_attention.flash_attention(q, k, k))
    torch.cuda.synchronize(cuda)
    blocks = -(-sq // (128 // (hq // hkv))) * hkv * b
    assert (took == 128) == (blocks >= _sms(cuda))
    if _sms(cuda) == 132:
        assert took == tile


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_cold_start_streams_through_the_ring(cuda, monkeypatch, dtype):
    """A cold start on the card sends its stage's bytes through the
    loader's ring of page-locked slots, here of 3,001 bytes: the largest
    leaf spans many fills, norms share one, elements cross a slot's edge.
    Its leaves equal the CPU path's bit for bit, ``load.staged_bytes``
    moves as ``load.bytes`` does (the CPU's moves neither ring counter), a
    second cold start reuses the ring and its pinned slots, and the
    endpoint serves the greedy tokens of one on the card built from the
    CPU path's leaves."""
    import dataclasses
    from repro_torch import telemetry
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core import (GB, Gbps, ModelProfile, SLO, ServerSpec,
                                  TimingProfile)
    from repro_torch.models.model import Model
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.endpoint import (ServerlessFrontend,
                                              ServingEndpoint)
    from repro_torch.serving.engine import Engine
    from repro_torch.store import ModelStore, loader
    from repro_torch.store.manifest import flatten_with_paths
    monkeypatch.setattr(loader, "SLOT_BYTES", 3001)
    monkeypatch.setattr(loader, "_RINGS", {})
    cfg = dataclasses.replace(smoke_variant(get_config("granite-3-8b")),
                              dtype=dtype)
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    store = ModelStore.from_params(Model(cfg), params)
    kw = dict(max_batch=2, max_seq=32, block_size=8)

    def cold_start(dev):
        front = ServerlessFrontend(
            {"srv0": ServerSpec("srv0", 16 * Gbps, 12e9, 24 * GB)},
            device=dev)
        front.deploy(cfg, params, ModelProfile(cfg.name, GB,
                                               TimingProfile(),
                                               SLO(60.0, 1.0)), store=store)
        c0 = telemetry.counters()
        pend = front.begin_cold_start(cfg.name, **kw)
        ep = pend.finish()
        c1 = telemetry.counters()
        n = pend.n_stages
        assert max(sc.length for i in range(n)
                   for sc in store.stage_plan(n, i)) > loader.SLOT_BYTES
        moved = {k: c1[k] - c0[k] for k in c0}
        assert moved["load.bytes"] == sum(store.stage_bytes(n, i)
                                          for i in range(n))
        return ep, moved

    card, moved = cold_start(cuda)
    assert moved["load.staged_bytes"] == moved["load.bytes"]
    (ring,) = loader._RINGS.values()
    ptrs = [s.data_ptr() for s in ring.slots]
    host, moved = cold_start("cpu")
    assert moved["load.staged_bytes"] == moved["load.slot_waits"] == 0
    again, moved = cold_start(cuda)
    assert moved["load.staged_bytes"] == moved["load.bytes"]
    assert list(loader._RINGS.values()) == [ring]
    assert [s.data_ptr() for s in ring.slots] == ptrs

    stages = [flatten_with_paths(w.params) for w in card.engine.workers]
    want = [flatten_with_paths(w.params) for w in host.engine.workers]
    assert [s.keys() for s in stages] == [s.keys() for s in want]
    for got, cpu_leaves in zip(stages, want):
        for path, t in got.items():
            w = cpu_leaves[path]
            assert t.device.type == "cuda" and t.dtype == w.dtype
            assert t.shape == w.shape
            assert torch.equal(t.cpu().reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8))
    moved_ep = ServingEndpoint(Engine(
        cfg, [_tree_to(w.params, cuda) for w in host.engine.workers],
        device=cuda, **kw))
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5]]
    streams = []
    for ep in (card, moved_ep):
        reqs = [ep.submit(p, SamplingParams(max_new=5)) for p in prompts]
        ep.run()
        streams.append([list(r.generated) for r in reqs])
    assert streams[0] == streams[1]


@pytest.fixture
def modes():
    """The port's attention and decode modes, put back after the test."""
    saved = ops.attention_mode(), ops.decode_mode()
    yield
    ops.set_attention_mode(saved[0])
    ops.set_decode_mode(saved[1])


def _refuse(*a, **kw):
    raise AssertionError("a plain version ran on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["masked_full", "causal_skip"])
@pytest.mark.parametrize("sq", [300, 1040], ids=["short", "past-switch"])
def test_cuda_flash_launches_under_causal_skip(cuda, modes, monkeypatch,
                                               mode, sq):
    """In either attention mode ``ops.flash_attention`` on CUDA tensors
    launches the kernel (tensor-core body), past the CPU's 2^20 switch
    too, and runs no plain version."""
    q, k, v = [a.to(cuda, torch.bfloat16) for a in _qkv(1, sq, sq, 8, 2,
                                                        64, seed=9)]
    want = ref.mha_reference(q.float(), k.float(), v.float(), causal=True)
    ops.set_attention_mode(mode)
    for name in ("mha_reference", "flash_attention_blocked",
                 "flash_attention_blocked_skip"):
        monkeypatch.setattr(ref, name, _refuse)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    assert _bodies("flash_attention") == (1, 0)
    assert ops.launch_counts()["flash_attention"] == 1
    _check(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_append_attention_matches_decode_kernel(cuda, dtype):
    """The append mode's step on the card (plain torch over the old rows,
    the new token merged in closed form) against the float32 plain decode
    over the strips with the new token at ``pos`` (``_check``'s limits),
    and against the contiguous decode kernel there: float32 at 1e-5, bf16
    each row within twice the row limit (each side within one of the
    float32 sum). The stats' normalised output over the old rows likewise
    against the kernel over them."""
    from repro_torch.models.attention import append_attention
    dt = DTYPES[dtype]
    lens = [316, 273, 1, 0]
    q, k, v, kl = _contig_decode(lens, 430, 8, 2, 128, seed=10)
    q, k, v = q.to(cuda, dt), k.to(cuda, dt), v.to(cuda, dt)
    pos = kl.to(cuda)
    rows = torch.arange(len(lens), device=cuda)
    k_new, v_new = k[rows, pos.long()][:, None], v[rows, pos.long()][:, None]
    got = append_attention(q, k_new, v_new, k, v, pos)
    _check(got, ref.decode_attention_reference(q.float(), k.float(),
                                               v.float(), pos + 1), dt)
    ops.reset_launch_counts()
    kernel = decode_attention.decode_attention(q, k, v, pos + 1)
    assert ops.launch_counts()["decode_attention"] == 1
    out, m, l = ref.decode_attention_with_stats(q, k, v, pos)
    live = pos > 0
    old = decode_attention.decode_attention(q, k, v, pos)
    for a, b in ((got, kernel), ((out / l[:, None, :, None])[live],
                                 old[live])):
        if dtype == "f32":
            torch.testing.assert_close(a, b, **F32_TOL)
        else:
            d = (a.float() - b.float()).abs().amax(-1)
            lim = 2 * (ROW_REL * b.float().abs().amax(-1) + ROW_ATOL)
            assert bool((d <= lim).all()), float((d / lim).max())
    assert bool((l[~live] == 0).all()) and bool(torch.isfinite(m).all())


@pytest.mark.cuda
def test_cuda_append_mode_engine_matches_scatter_and_cpu(cuda, modes):
    """``Engine(paged=False)`` under the append mode on the card: the same
    greedy tokens as under scatter on the card and as on the CPU (float32
    smoke model); the decode kernel is not launched under append."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.model import Model
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine
    cfg = smoke_variant(get_config("granite-3-8b"))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5], [3, 1, 4, 1, 5]]
    streams, counts = {}, {}
    for dev, mode in (("cpu", "append"), ("cuda", "scatter"),
                      ("cuda", "append")):
        ops.set_decode_mode(mode)
        eng = Engine(cfg, [_tree_to(params, dev)], max_batch=2, max_seq=32,
                     paged=False, device=dev)
        reqs = [eng.submit(p, SamplingParams(max_new=5)) for p in prompts]
        ops.reset_launch_counts()
        eng.run()
        streams[dev, mode] = [list(r.generated) for r in reqs]
        counts[dev, mode] = ops.launch_counts()
    assert streams["cuda", "append"] == streams["cuda", "scatter"] \
        == streams["cpu", "append"]
    assert counts["cuda", "scatter"]["decode_attention"] > 0
    assert counts["cuda", "append"]["decode_attention"] == 0
    assert counts["cuda", "append"]["flash_attention"] > 0


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


# ---------------------------------------------------------------------------
# gradients through the kernels (the training slice)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_fn_gradients_equal_plain_autograd(cuda, causal, group,
                                                      hd, dtype):
    dt = DTYPES[dtype]
    q, k, v = [a.to(cuda, dt).requires_grad_()
               for a in _qkv(2, 45, 45, 2 * group, 2, hd, seed=3)]
    dout = torch.from_numpy(np.random.RandomState(4).randn(
        *q.shape).astype(np.float32)).to(cuda, dt)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    counts, bodies = ops.launch_counts(), ops.body_counts()
    assert counts["flash_attention"] == 1
    assert bodies["flash_attention/backward_plain"] == 1
    body = "cuda_core" if dt == torch.float32 else "tensor_core"
    assert bodies[f"flash_attention/{body}"] == 1
    want_out = ref.mha_reference(q, k, v, causal=causal)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    _check(out.detach(), ref.mha_reference(q.detach().float(),
                                           k.detach().float(),
                                           v.detach().float(),
                                           causal=causal), dt)
    for a, b in zip(got, want):
        assert a.dtype == dt and a.shape == b.shape
        if dt == torch.float32:
            torch.testing.assert_close(a, b, **F32_TOL)
        else:
            lim = 2.0 ** -8 * float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) <= lim


@pytest.mark.cuda
def test_cuda_serving_kernels_refuse_inputs_that_require_grad(cuda):
    """No kernel call that requires grad comes back without a gradient:
    the four serving kernels raise (under ``no_grad`` they serve)."""
    q, k, v, tb, row, pos = _to(cuda, _ragged(MIXED, 4, 2, 16, 4))
    dq, dk, dv, dtb, dkl = _to(cuda, _decode([5, 9], 4, 2, 16, 4))
    cq, ck, cv, ckl = _to(cuda, _contig_decode([5, 9], 16, 4, 2, 16))
    x = torch.randn(1, 5, 2, 16, device=cuda)
    u = torch.randn(2, 16, device=cuda)
    calls = [
        (lambda a: ops.ragged_paged_attention(a, k, v, tb, row, pos), q),
        (lambda a: ops.paged_decode_attention(a, dk, dv, dtb, dkl), dq),
        (lambda a: ops.decode_attention(a, ck, cv, ckl), cq),
        (lambda a: ops.wkv6(a, x, x, x, u)[0], x),
    ]
    ops.reset_launch_counts()
    for fn, a in calls:
        with pytest.raises(ValueError, match="requires grad"):
            fn(a.clone().requires_grad_())
    assert not any(ops.launch_counts().values())
    with torch.no_grad():
        for fn, a in calls:
            fn(a.clone().requires_grad_())
    assert all(n == 1 for k_, n in ops.launch_counts().items()
               if k_ != "flash_attention" and not k_.endswith("_q8"))


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_cuda_train_step_matches_cpu(cuda, remat):
    """A smoke granite's loss and gradients on the card (flash through
    ``_FlashFn``) equal the CPU's plain path, and a whole train step moves
    the params alike; ``"full"`` launches flash twice a layer."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import Model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticTokens
    from repro_torch.training.train_step import (loss_and_grads,
                                                 make_train_step)
    cfg = smoke_variant(get_config("granite-3-8b"))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = next(iter(SyntheticTokens(cfg, 2, 40, seed=0)))
    lc, _, gc = loss_and_grads(model, params, batch, remat=remat)
    ops.reset_launch_counts()
    lg, _, gg = loss_and_grads(model, _tree_to(params, cuda), batch,
                               remat=remat)
    n = cfg.n_layers
    assert ops.launch_counts()["flash_attention"] == \
        (2 * n if remat != "none" else n)
    assert ops.body_counts()["flash_attention/backward_plain"] == n
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        lim = 1e-4 * float(b.abs().max()) + 1e-12
        assert float((a.cpu() - b).abs().max()) <= lim
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    step = make_train_step(model, acfg, remat=remat, grad_dtype=None)
    pc, _, _ = step(params, opt.init_state(params), batch)
    pg_, sg, mg = step(_tree_to(params, cuda), opt.init_state(
        _tree_to(params, cuda)), batch)
    assert sg["step"].device.type == "cuda"
    lr1 = float(opt._schedule(acfg, torch.tensor(1)))
    for a, b in zip(tree_leaves(pg_), tree_leaves(pc)):
        assert float((a.cpu() - b).abs().max()) <= 2 * lr1 + 1e-6


# ---------------------------------------------------------------------------
# the distributed prefills on a one-rank NCCL group
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl(cuda):
    """A one-rank NCCL process group on the card for the test."""
    import socket
    from datetime import timedelta
    import torch.distributed as dist
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    yield cuda
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen1.5-32b"])
@pytest.mark.parametrize("path", ["manual_tp", "pipeline"])
def test_cuda_dist_prefills_match_cpu(nccl, arch, path):
    """The manual-TP prefill at tp 1 and the pipelined prefill at one stage
    (2 micro-batches) on the card, through the flash kernel, equal the
    CPU's plain forward (``Model.prefill``, slot-contiguous) on the same
    float32 smoke params: logits over the real vocab and the manual-TP K/V
    within 1e-4 of their largest |value| (TF32 off)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.distributed import manual_tp, pp_spmd
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import Model
    cfg = smoke_variant(get_config(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    want, wcache = model.prefill(params, tokens, 32, paged=False)
    card = tree_map(lambda t: t.cuda(), params)
    ops.reset_launch_counts()
    if path == "manual_tp":
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        fn = manual_tp.make_manual_prefill(cfg, mesh, 4, 32, tp=1)[0]
        got, cache = fn(manual_tp.shard_params(cfg, card, 0, 1),
                        tokens.cuda())
        for name in ("k", "v"):
            w = wcache["slot00"][name]
            assert (cache[name].cpu() - w).abs().max() <= \
                1e-4 * w.abs().max()
        flash = cfg.n_layers
    else:
        mesh = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("stage", "data", "model"))
        fn = pp_spmd.make_pp_prefill(cfg, mesh, 4, 32, n_stages=1,
                                     n_micro=2)[0]
        got = fn(model.slice_stage_params(card, 1, 0), tokens.cuda())
        flash = 2 * cfg.n_layers
    v = cfg.vocab
    assert (got[:, :v].cpu() - want[:, :v]).abs().max() <= \
        1e-4 * want[:, :v].abs().max()
    assert ops.launch_counts()["flash_attention"] == flash
    assert sum(ops.launch_counts().values()) == flash
