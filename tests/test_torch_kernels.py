"""The port's kernel layer held against the reference on the CPU.

The plain PyTorch versions of the CUDA kernels (``repro_torch.kernels
.ref``, reached through ``ops`` on CPU tensors) must match the JAX oracles
and the Pallas kernel bodies run in interpret mode: the paged kernels over
GQA group 1/2/4, page size 4/16, and mixed ragged batches of prefill chunks
with history, decode rows and pad rows; flash attention causal and not,
with ``q_offset`` and Sq != Sk; contiguous decode at kv_len 0, 1 and S;
the WKV6 recurrence over T below, at and not a multiple of the chunk, with
and without an initial state. Tolerance: atol = rtol = 1e-5 in float32
(both sides sum the same float32 terms in another order); a bf16 WKV6
output row within 2^-7 of its largest |value| plus 1e-4 (the two sides
round their float32 sums to bf16 apart). Pad rows and empty rows are
exactly 0, padded WKV6 steps leave the state exactly as it was, and int8
quantization matches byte for byte.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
(marker ``cuda``) holds them against these plain versions and skips here;
``chip_smoke.py`` does so at the main path's shapes. The last section
emulates the tensor-core bodies' rounding points in plain torch at
granite-3-8b's attention widths and holds them to the row limit the card
tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro.kernels import ragged_attention as jra
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ragged_attention import TILE_Q

HD = 16
TOL = dict(atol=1e-5, rtol=1e-5)

# the JAX oracles, compiled whole (eager dispatch compiles op by op)
j_ragged = jax.jit(jref.ragged_paged_attention_reference)
j_decode = jax.jit(jref.paged_decode_attention_reference)


def _ragged(specs, hkv, group, bs, seed=0):
    """specs: per request (hist, new): `new` query tokens at positions
    [hist, hist+new) over a pool holding all hist+new rows. numpy arrays
    in the runner's layout (tile-aligned spans, pos -1 pads, a trailing
    all-pad tile), pages at scattered ids."""
    rng = np.random.RandomState(seed)
    hq = hkv * group
    nb = max(-(-(h + n) // bs) for h, n in specs) + 1
    n_pages = len(specs) * nb + 1
    perm = rng.permutation(n_pages - 1).astype(np.int32)
    tables = perm.reshape(len(specs), nb)
    rows, poss = [], []
    for r, (h, n) in enumerate(specs):
        na = -(-n // TILE_Q) * TILE_Q
        rows += [r] * na
        poss += list(range(h, h + n)) + [-1] * (na - n)
    rows += [0] * TILE_Q
    poss += [-1] * TILE_Q
    t = len(rows)
    return dict(
        q=rng.randn(t, hq, HD).astype(np.float32),
        k=rng.randn(n_pages, bs, hkv, HD).astype(np.float32),
        v=rng.randn(n_pages, bs, hkv, HD).astype(np.float32),
        tables=tables, row=np.asarray(rows, np.int32),
        pos=np.asarray(poss, np.int32))


MATRIX = [
    ("decode-only", [(9, 1), (17, 1), (3, 1)]),
    ("decode-hist0", [(0, 1), (0, 1)]),
    ("chunk-only", [(0, 8), (0, 13)]),
    ("chunk-hist", [(8, 8), (16, 5)]),
    ("mixed", [(9, 1), (0, 11), (24, 1), (8, 8), (31, 3)]),
]


def _torch(a):
    return torch.from_numpy(np.array(a))


def _port_ragged(d, kv_quant=None, k="k", v="v"):
    quant = None if kv_quant is None else {
        n: _torch(a) for n, a in kv_quant.items()}
    return ops.ragged_paged_attention(
        _torch(d["q"]), _torch(d[k]), _torch(d[v]), _torch(d["tables"]),
        _torch(d["row"]), _torch(d["pos"]), kv_quant=quant).numpy()


# every batch shape at GQA group 2 / page 4, and the mixed batch over the
# whole group x page-size grid
CASES = ([(name, specs, 2, 4) for name, specs in MATRIX[:-1]]
         + [(MATRIX[-1][0], MATRIX[-1][1], g, bs)
            for g in (1, 2, 4) for bs in (4, 16)])


@pytest.mark.parametrize("name,specs,group,bs", CASES,
                         ids=[f"{c[0]}-g{c[2]}-bs{c[3]}" for c in CASES])
def test_ragged_plain_matches_jax_oracle(name, specs, group, bs):
    d = _ragged(specs, 2, group, bs)
    want = np.asarray(j_ragged(
        *(jnp.asarray(d[n]) for n in ("q", "k", "v", "tables", "row",
                                      "pos"))))
    got = _port_ragged(d)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[d["pos"] < 0] == 0.0)


@pytest.mark.parametrize("name,specs", [MATRIX[0], MATRIX[4]],
                         ids=["decode-only", "mixed"])
@pytest.mark.parametrize("group", [1, 4])
def test_ragged_plain_matches_pallas_interpret(name, specs, group):
    d = _ragged(specs, 2, group, 4)
    want = np.asarray(jra.ragged_paged_attention(
        *(jnp.asarray(d[n]) for n in ("q", "k", "v", "tables", "row",
                                      "pos")), interpret=True))
    np.testing.assert_allclose(_port_ragged(d), want, **TOL)


def test_quantize_kv_byte_for_byte():
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 8, 2, HD) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                              # a constant row
    jq, js, jz = (np.asarray(a) for a in jref.quantize_kv(jnp.asarray(x)))
    tq, ts, tz = (a.numpy() for a in tref.quantize_kv(_torch(x)))
    assert tq.dtype == np.int8 and np.array_equal(tq, jq)
    assert np.array_equal(ts, js) and np.array_equal(tz, jz)
    back = tref.dequantize_kv(_torch(tq), _torch(ts), _torch(tz)).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jref.dequantize_kv(jnp.asarray(jq),
                                            jnp.asarray(js),
                                            jnp.asarray(jz))))


@pytest.mark.parametrize("group", [1, 4])
def test_ragged_int8_matches_jax(group):
    d = _ragged(MATRIX[4][1], 2, group, 4)
    kq, ks, kz = (np.asarray(a) for a in jref.quantize_kv(jnp.asarray(d["k"])))
    vq, vs, vz = (np.asarray(a) for a in jref.quantize_kv(jnp.asarray(d["v"])))
    d.update(kq=kq, vq=vq)
    quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
    jargs = [jnp.asarray(d[n]) for n in ("q", "kq", "vq", "tables", "row",
                                         "pos")]
    jquant = {n: jnp.asarray(a) for n, a in quant.items()}
    want = np.asarray(j_ragged(
        *jargs, kv_quant=jquant))
    got = _port_ragged(d, kv_quant=quant, k="kq", v="vq")
    np.testing.assert_allclose(got, want, **TOL)
    interp = np.asarray(jra.ragged_paged_attention(*jargs, kv_quant=jquant,
                                                   interpret=True))
    np.testing.assert_allclose(got, interp, **TOL)
    assert np.all(got[d["pos"] < 0] == 0.0)


def _decode(lens, hkv, group, bs, seed=0):
    rng = np.random.RandomState(seed)
    b = len(lens)
    nb = -(-max(lens) // bs) + 1
    n_pages = b * nb + 1
    tables = rng.permutation(n_pages - 1)[:b * nb].reshape(b, nb)
    return dict(
        q=rng.randn(b, 1, hkv * group, HD).astype(np.float32),
        k=rng.randn(n_pages, bs, hkv, HD).astype(np.float32),
        v=rng.randn(n_pages, bs, hkv, HD).astype(np.float32),
        tables=tables.astype(np.int32),
        kv_len=np.asarray(lens, np.int32))


@pytest.mark.parametrize("group,bs", [(1, 4), (2, 16), (4, 4)])
def test_paged_decode_plain_matches_jax(group, bs):
    d = _decode([37, 1, 16, 50], 2, group, bs)
    args = [d[n] for n in ("q", "k", "v", "tables", "kv_len")]
    got = ops.paged_decode_attention(*map(_torch, args)).numpy()
    want = np.asarray(j_decode(
        *map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, **TOL)
    if bs == 4:
        interp = np.asarray(jda.paged_decode_attention(
            *map(jnp.asarray, args), interpret=True))
        np.testing.assert_allclose(got, interp, **TOL)


def test_paged_decode_empty_row_is_zero():
    d = _decode([0, 5], 2, 2, 4)
    args = [d[n] for n in ("q", "k", "v", "tables", "kv_len")]
    got = ops.paged_decode_attention(*map(_torch, args)).numpy()
    assert np.all(got[0] == 0.0)
    want = np.asarray(j_decode(
        *map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, **TOL)


def test_masked_keys_never_reach_the_sum():
    """NaN in a pool row past every token's span must not leak into any
    output: masked keys are dropped, not multiplied by p = 0."""
    d = _ragged(MATRIX[4][1], 2, 2, 4)
    d["v"] = d["v"].copy()
    d["v"][-1] = np.nan                           # the trash page
    got = _port_ragged(d)
    assert np.isfinite(got).all()
    dd = _decode([5, 9], 2, 2, 4)
    dd["v"][-1] = np.nan
    args = [dd[n] for n in ("q", "k", "v", "tables", "kv_len")]
    out = ops.paged_decode_attention(*map(_torch, args))
    assert bool(torch.isfinite(out).all())


def test_ops_counts_only_kernel_launches():
    """The CPU path is the plain version: no kernel launch is counted."""
    ops.reset_launch_counts()
    d = _ragged(MATRIX[0][1], 2, 2, 4)
    _port_ragged(d)
    assert all(v == 0 for v in ops.launch_counts().values())
    d = _contig([2, 5], 8, 2)
    ops.decode_attention(*map(_torch, d))
    ops.flash_attention(*map(_torch, _qkv(1, 4, 4, 2, 2)))
    ops.wkv6(*map(_torch, _wkv(1, 5, 2, 16)))
    assert all(v == 0 for v in ops.launch_counts().values())
    assert set(ops.launch_counts()) == {"ragged_paged_attention",
                                        "ragged_paged_attention_q8",
                                        "paged_decode_attention",
                                        "flash_attention",
                                        "decode_attention", "wkv6"}


# ---------------------------------------------------------------------------
# the slot-contiguous kernels' plain versions: flash (prefill) and decode
# ---------------------------------------------------------------------------

from repro.kernels import flash_attention as jfa  # noqa: E402

j_mha = jax.jit(jref.mha_reference,
                static_argnames=("causal", "q_offset"))


def _qkv(b, sq, sk, hkv, group, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, h, HD).astype(np.float32)
            for n, h in ((sq, hkv * group), (sk, hkv), (sk, hkv))]


FLASH = [  # (causal, q_offset, Sq, Sk)
    (True, 0, 13, 13),
    (True, 6, 9, 15),
    (True, 20, 5, 12),             # every query past the last key
    (False, 0, 7, 19),
    (False, 3, 16, 5),
]


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal,q_offset,sq,sk", FLASH,
                         ids=[f"{'causal' if c else 'full'}-off{o}-"
                              f"q{a}k{b}" for c, o, a, b in FLASH])
def test_flash_plain_matches_jax_and_pallas(group, causal, q_offset, sq,
                                            sk):
    q, k, v = _qkv(2, sq, sk, 2, group)
    got = ops.flash_attention(*map(_torch, (q, k, v)), causal=causal,
                              q_offset=q_offset).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(j_mha(*jargs, causal=causal, q_offset=q_offset))
    np.testing.assert_allclose(got, want, **TOL)
    interp = np.asarray(jfa.flash_attention(*jargs, causal=causal,
                                            q_offset=q_offset,
                                            interpret=True))
    np.testing.assert_allclose(got, interp, **TOL)


def test_flash_plain_kv_len_masks_keys():
    """``kv_len`` (the plain version's only, as in the reference) masks
    keys per batch row, equal to the reference oracle with the same
    mask."""
    q, k, v = _qkv(2, 6, 10, 2, 2, seed=3)
    kl = np.asarray([4, 10], np.int32)
    got = ops.flash_attention(*map(_torch, (q, k, v)), causal=False,
                              kv_len=_torch(kl)).numpy()
    want = np.asarray(jref.mha_reference(*map(jnp.asarray, (q, k, v)),
                                         causal=False,
                                         kv_len=jnp.asarray(kl)))
    np.testing.assert_allclose(got, want, **TOL)


def _contig(lens, s, group, seed=0):
    q, k, v = _qkv(len(lens), 1, s, 2, group, seed)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_decode_plain_matches_jax_and_pallas(group):
    """kv_len 0, 1 and S in one batch: the kernel body (interpret mode)
    gives exactly 0 for the empty row, as the plain version does; the
    reference's oracle averages uniformly there, so it is held on the
    other rows."""
    d = _contig([0, 1, 24, 11], 24, group)
    got = ops.decode_attention(*map(_torch, d)).numpy()
    jargs = [jnp.asarray(a) for a in d]
    interp = np.asarray(jda.decode_attention(*jargs, kv_block=8,
                                             interpret=True))
    np.testing.assert_allclose(got, interp, **TOL)
    assert np.all(got[0] == 0.0)
    want = np.asarray(jax.jit(jref.decode_attention_reference)(*jargs))
    np.testing.assert_allclose(got[1:], want[1:], **TOL)


def test_decode_plain_ignores_rows_past_kv_len():
    q, k, v, kl = _contig([3, 9], 16, 2, seed=4)
    ref_out = ops.decode_attention(*map(_torch, (q, k, v, kl))).numpy()
    for b, n in enumerate(kl):
        k[b, n:] = 1e4                  # anything past kv_len: no effect
        v[b, n:] = -1e4
    got = ops.decode_attention(*map(_torch, (q, k, v, kl))).numpy()
    np.testing.assert_array_equal(got, ref_out)


# ---------------------------------------------------------------------------
# the WKV6 recurrence's plain versions (rwkv's time mix)
# ---------------------------------------------------------------------------

from repro.kernels.wkv6 import wkv6 as j_wkv6  # noqa: E402

ROW_REL, ROW_ATOL = 2.0 ** -7, 1e-4


def _wkv(b, t, h, n, seed=0, state=True):
    """r, k, v, w (B,T,H,hd) and u (H,hd) at the scales of the reference's
    ``tests/test_kernels.py``, and an initial state (B,H,hd,hd) or None."""
    rng = np.random.RandomState(seed)
    r, k, v, w = (rng.randn(b, t, h, n).astype(np.float32) * 0.5
                  for _ in range(4))
    u = rng.randn(h, n).astype(np.float32) * 0.5
    s0 = (rng.randn(b, h, n, n).astype(np.float32) * 0.1 if state
          else None)
    return r, k, v, w, u, s0


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return None if a is None else _torch(a)


@pytest.mark.parametrize("b,t,h,n,chunk,state", [
    (2, 64, 2, 32, 16, True),
    (1, 100, 4, 64, 32, True),       # T not a multiple of the chunk
    (2, 33, 1, 16, 8, True),
    (1, 16, 2, 64, 64, True),        # T < chunk
    (2, 45, 2, 16, 16, False),       # no initial state
])
def test_wkv6_plain_matches_jax_and_pallas(b, t, h, n, chunk, state):
    args = _wkv(b, t, h, n, seed=t, state=state)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    want = [jref.wkv6_reference(*jargs),
            j_wkv6(*jargs, chunk=chunk, interpret=True)]
    got = [tref.wkv6_reference(*map(_t, args)),
           ops.wkv6(*map(_t, args), chunk=chunk)]
    for y, s in got:
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        for wy, ws in want:
            np.testing.assert_allclose(y.numpy(), _np(wy), **TOL)
            np.testing.assert_allclose(s.numpy(), _np(ws), **TOL)


def test_wkv6_bf16_rkv_with_f32_decay_matches_jax():
    """rwkv's own mix of dtypes: bf16 r/k/v, float32 w and u. y comes back
    in bf16, each (token, head) row within 2^-7 of its largest |value|
    plus 1e-4 of JAX's; the float32 state to 1e-5."""
    r, k, v, w, u, s0 = _wkv(2, 70, 2, 32, seed=3)
    rkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    jrkv = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
            for a in rkv]
    jw, ju, js = jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0)
    y, s = ops.wkv6(*rkv, _torch(w), _torch(u), _torch(s0), chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    for wy, ws in (jref.wkv6_reference(*jrkv, jw, ju, js),
                   j_wkv6(*jrkv, jw, ju, js, chunk=32, interpret=True)):
        want = _np(wy.astype(jnp.float32))
        d = np.abs(y.float().numpy() - want).max(-1)
        lim = ROW_REL * np.abs(want).max(-1) + ROW_ATOL
        assert (d <= lim).all(), float((d / lim).max())
        np.testing.assert_allclose(s.numpy(), _np(ws), **TOL)


def test_wkv6_padded_steps_leave_the_state_unchanged():
    """A step with w = -1e9 and k = 0 (the plain version's padding) decays
    by exp(-exp(-1e9)) = 1 and adds nothing: the state comes back bit for
    bit; and the chunked form over a padded T equals the unchunked one."""
    r, k, v, w, u, s0 = map(_torch, _wkv(2, 7, 2, 16, seed=5))
    w = torch.full_like(w, -1e9)
    k = torch.zeros_like(k)
    _, s = tref.wkv6_reference(r, k, v, w, u, s0)
    assert torch.equal(s, s0)
    args = list(map(_torch, _wkv(1, 37, 2, 16, seed=6)))
    y1, s1 = tref.wkv6_reference(*args)
    y2, s2 = tref.wkv6_chunked(*args, chunk=16)
    torch.testing.assert_close(y2, y1, **TOL)
    torch.testing.assert_close(s2, s1, **TOL)


def test_wkv6_out_state_is_written_in_place():
    """``out_state`` receives the final state, and may be the initial state
    itself (the rwkv cache's ``wkv`` view updated in place)."""
    args = list(map(_torch, _wkv(2, 9, 2, 16, seed=7)))
    want_y, want_s = ops.wkv6(*args)
    s = args[-1].clone()
    y, out = ops.wkv6(*args[:-1], s, out_state=s)
    assert out is s
    torch.testing.assert_close(y, want_y, atol=0, rtol=0)
    torch.testing.assert_close(s, want_s, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the WKV6 kernel's summation order (csrc/wkv6.cu), emulated
# ---------------------------------------------------------------------------

import re  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.kernels import wkv6 as twkv  # noqa: E402


def _fmaf(a, b, c):
    """fmaf in float32: the product of two float32 values is exact in
    float64, and the sum is rounded to float32 once more."""
    return (a.double() * b.double() + c.double()).float()


def _wkv6_split(r, k, v, w, u, s0=None, jc=twkv.COLUMNS_PER_BLOCK, ig=None):
    """The WKV6 kernel's arithmetic in plain torch. The value columns go in
    groups of ``jc`` (a block each); in a group, lane g of a column holds
    key rows g, g + ig, ... (``ig`` the kernel's ``row_lanes(T)`` unless
    given) and forms its partial y as fmaf(r_i, fmaf(u_i k_i, v_j, S_ij),
    acc) over its rows in row order; the ig partials are added as the
    shuffle tree adds them (xor 1, then 2, 4, ...: the kernel's per-step
    tree and its per-tile reduce-scatter give these same sums), and lane
    0's sum is y. Each state entry becomes fmaf(d_i, S_ij, k_i v_j), d_i =
    exp(-exp(w_i)). Returns (y in r's dtype, the final state)."""
    ig = twkv.row_lanes(r.shape[1]) if ig is None else ig
    b, t, h, n = r.shape
    f32 = torch.float32
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uk = u.to(f32)[None, None] * kf
    d = torch.exp(-torch.exp(wf))
    S = (torch.zeros(b, h, n, n) if s0 is None else s0.to(f32).clone())
    y = torch.empty(b, t, h, n)
    jb = min(jc, n)

    def lanes(x):                      # (B,H,n) -> (B,H,n/ig,ig,1): [m, g]
        return x.reshape(b, h, n // ig, ig, 1)

    for j0 in range(0, n, jb):
        cols = slice(j0, j0 + jb)
        sg = S[..., cols].reshape(b, h, n // ig, ig, jb)   # [m, g, column]
        for step in range(t):
            vj = vf[:, step, :, cols][:, :, None, None]     # (B,H,1,1,jb)
            rs, uks, ks, ds = (lanes(x[:, step]) for x in (rf, uk, kf, d))
            acc = torch.zeros(b, h, ig, jb)
            for m in range(n // ig):
                acc = _fmaf(rs[:, :, m], _fmaf(uks[:, :, m], vj[:, :, 0],
                                               sg[:, :, m]), acc)
            off = 1
            while off < ig:
                acc = acc + acc[:, :, [g ^ off for g in range(ig)]]
                off *= 2
            y[:, step, :, cols] = acc[:, :, 0]
            sg = _fmaf(ds, sg, ks * vj)
        S[..., cols] = sg.reshape(b, h, n, jb)
    return y.to(r.dtype), S


@pytest.mark.parametrize("state", [True, False], ids=["state", "zero"])
@pytest.mark.parametrize("t", [1, 17, 100])
@pytest.mark.parametrize("n", [16, 64])
def test_wkv6_split_order_matches_plain_and_jax(n, t, state):
    """The kernel's order of y's sum (row groups over ``row_lanes(T)``
    lanes: 8 at T 1, 16 at T 17 and 100; partials added in the shuffles'
    order) against the plain version and the JAX package's wkv6 (its
    oracle and its Pallas kernel in interpret mode): float32 y to 1e-5, the
    state to rtol 1e-4."""
    args = _wkv(2, t, 2, n, seed=3 * t + n, state=state)
    got_y, got_s = _wkv6_split(*map(_t, args))
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    wants = [tref.wkv6_reference(*map(_t, args)),
             jref.wkv6_reference(*jargs),
             j_wkv6(*jargs, chunk=16, interpret=True)]
    for wy, ws in wants:
        np.testing.assert_allclose(got_y.numpy(), _np(wy), **TOL)
        np.testing.assert_allclose(got_s.numpy(), _np(ws), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("t", [1, 23])
def test_wkv6_split_bits_ignore_column_groups_and_batch(t):
    """A column's y and state depend on its own lanes alone: any column
    group width, and a row served alone or inside a batch, give the same
    bits; the state's bits do not depend on the lanes either."""
    args = list(map(_t, _wkv(4, t, 2, 64, seed=11)))
    y, s = _wkv6_split(*args)
    for jc in (8, 32):
        y2, s2 = _wkv6_split(*args, jc=jc)
        assert torch.equal(y, y2) and torch.equal(s, s2)
    one = [x[2:3] for x in args[:4]] + [args[4], args[5][2:3]]
    y1, s1 = _wkv6_split(*one)
    assert torch.equal(y1, y[2:3]) and torch.equal(s1, s[2:3])
    _, s3 = _wkv6_split(*args, ig=4)
    assert torch.equal(s3, s)


def test_wkv6_split_bf16_rows_hold_the_row_limit():
    """At rwkv6-1.6b's head (hd 64) over a 412-step prefill from a random
    state, bf16 r/k/v and float32 w: the emulated kernel's y, rounded to
    bf16, keeps every (token, head) row within 2^-7 of its largest |value|
    plus 1e-4 of the float32 plain version, and the state within 1e-4 of
    its largest |value|."""
    r, k, v, w, u, s0 = (_t(a) for a in _wkv(1, 412, 2, 64, seed=12))
    r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    y, s = _wkv6_split(r, k, v, w, u, s0)
    want_y, want_s = tref.wkv6_reference(r.float(), k.float(), v.float(), w,
                                         u, s0)
    assert y.dtype == torch.bfloat16
    _rows_within_limit(y.float(), want_y)
    assert float((s - want_s).abs().max()) <= 1e-4 * float(
        want_s.abs().max())


def test_wkv6_constants_match_the_source():
    """The wrapper's STEPS_PER_TILE, COLUMNS_PER_BLOCK, ROW_LANES and
    SHORT_ROW_LANES are the kernel's CT, JC, IG and IG_SHORT, which the
    card tests and the emulation above read; ``row_lanes`` picks as the
    kernel's launcher does (whole tiles at T >= CT)."""
    src = (Path(twkv.__file__).resolve().parents[1] / "csrc"
           / "wkv6.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("CT") == twkv.STEPS_PER_TILE
    assert const("JC") == twkv.COLUMNS_PER_BLOCK
    assert const("IG") == twkv.ROW_LANES
    assert const("IG_SHORT") == twkv.SHORT_ROW_LANES
    assert "if (T_ >= CT)\n    return launch_as<T, TW, HD, IG, NJ>" in src
    ct = twkv.STEPS_PER_TILE
    assert [twkv.row_lanes(t) for t in (1, ct - 1, ct, 412)] == [
        twkv.SHORT_ROW_LANES, twkv.SHORT_ROW_LANES, twkv.ROW_LANES,
        twkv.ROW_LANES]


from repro_torch.kernels import flash_attention as tfa  # noqa: E402


@pytest.mark.parametrize("q_dtype,kv_dtype,bs,refused", [
    (torch.bfloat16, torch.bfloat16, 6, True),
    (torch.bfloat16, torch.int8, 2, True),
    (torch.bfloat16, torch.bfloat16, 8, False),
    (torch.float32, torch.float32, 6, False),
    (torch.bfloat16, torch.float16, 6, False)])
def test_ragged_operands_refuse_page_sizes_the_tensor_cores_do_not_take(
        q_dtype, kv_dtype, bs, refused):
    """The ragged kernel's tensor-core body (bf16 q over bf16 or int8 pages)
    takes pages of a power of two >= 4 rows; the wrapper refuses any other
    page size for it, and the CUDA-core body takes any."""
    from repro_torch.kernels import ragged_attention as tra
    q = torch.zeros((8, 4, 16), dtype=q_dtype)
    pages = torch.zeros((3, bs, 2, 16), dtype=kv_dtype)
    quant = ({k: torch.zeros((3, bs, 2)) for k in
              ("k_scale", "k_zero", "v_scale", "v_zero")}
             if kv_dtype == torch.int8 else None)
    args = (q, pages, pages, torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32))
    if refused:
        with pytest.raises(ValueError, match="page size"):
            tra.check_operands(*args, kv_quant=quant)
    else:
        tra.check_operands(*args, kv_quant=quant)


def test_reset_launch_counts_clears_flash_tiles():
    """``reset_launch_counts`` zeroes flash's launches by tile with the
    other counts, so a window reads only its own launches' tiles."""
    tfa.TILE_LAUNCHES.update({64: 3, 128: 5})
    tfa.LAUNCHES["flash_attention"] = 8
    ops.reset_launch_counts()
    assert tfa.TILE_LAUNCHES == {64: 0, 128: 0}
    assert ops.launch_counts()["flash_attention"] == 0


# ---------------------------------------------------------------------------
# the tensor-core bodies' rounding points, emulated in plain torch
# ---------------------------------------------------------------------------

# (history, new tokens) per request: chip_smoke.py's mixed ragged batch
MIXED_FULL = [(300, 256), (100, 203), (1023, 1), (776, 1), (299, 1), (0, 1)]
FULL = dict(hq=32, hkv=8, hd=128, bs=16)   # granite-3-8b's attention


def _emulate_mma(qs, kf, vf, mask, quant=None, rounded=True):
    """The tensor-core bodies' arithmetic (``csrc/mma_attention.cuh``, and
    the ``wgmma`` bodies of flash and the ragged kernel's spans, which round
    at the same points) with the
    softmax taken whole: qs (Hkv,G,tr,hd), kf/vf (Hkv,1,n,hd) float
    holding bf16 values or int8 codes, mask (tr,n). 16-bit pages: P rounded
    to bf16, l summed from the rounded P. int8 pages (``quant`` = scale and
    zero (Hkv,1,1,n) each of K and V): scale and zero factored out of both
    products, the PV operand p * v_scale rounded to fp16, l summed from the
    f32 P. ``rounded=False`` keeps every value in f32."""
    scale = tref.softmax_scale(qs.shape[-1])
    s = qs @ kf.transpose(-1, -2)
    if quant is not None:
        ks, kz, vs, vz = quant
        s = ks * s + kz * qs.sum(-1, keepdim=True)
    s = torch.where(mask, s * scale, torch.full_like(s, tref.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    if quant is None:
        if rounded:
            p = p.to(torch.bfloat16).float()
        num = p @ vf
    else:
        a = p * vs
        if rounded:
            a = a.to(torch.float16).float()
        num = a @ vf + (p * vz).sum(-1, keepdim=True)
    return num / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)


def _emulate_ragged(q, kp, vp, tables, row, pos, quant=None, rounded=True):
    """``_emulate_mma`` over a ragged batch, gathered as the plain version
    gathers it. q (T,Hq,hd) float; pages as stored."""
    t, hq, hd = q.shape
    hkv = kp.shape[2]
    out = torch.zeros((t, hq, hd))
    live = pos >= 0
    for r in torch.unique(row[live]).tolist():
        sel = torch.nonzero(live & (row == r)).flatten()
        n = int(pos[sel].max()) + 1

        def rows(a):
            return tref._gather_rows(a, tables[r], n).float()

        kf = rows(kp).permute(1, 0, 2)[:, None]
        vf = rows(vp).permute(1, 0, 2)[:, None]
        qn = None if quant is None else [
            rows(quant[k]).permute(1, 0)[:, None, None]
            for k in ("k_scale", "k_zero", "v_scale", "v_zero")]
        qs = q[sel].reshape(-1, hkv, hq // hkv, hd).permute(1, 2, 0, 3)
        mask = torch.arange(n)[None, :] <= pos[sel][:, None]
        o = _emulate_mma(qs, kf, vf, mask, qn, rounded)
        out[sel] = o.permute(2, 0, 1, 3).reshape(-1, hq, hd)
    return out


def _full_ragged(seed):
    d = _ragged(MIXED_FULL, FULL["hkv"], FULL["hq"] // FULL["hkv"],
                FULL["bs"], seed=seed)
    rng = np.random.RandomState(seed + 100)
    shape = d["k"].shape[:-1] + (FULL["hd"],)
    t = len(d["row"])
    return dict(d, q=rng.randn(t, FULL["hq"], FULL["hd"]).astype(np.float32),
                k=rng.randn(*shape).astype(np.float32),
                v=rng.randn(*shape).astype(np.float32))


def _rows_within_limit(got, want):
    d = (got - want).abs().amax(-1)
    lim = ROW_REL * want.abs().amax(-1) + ROW_ATOL
    ratio = float((d / lim).max())
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("case", ["flash-300", "flash-412", "ragged-bf16",
                                  "ragged-int8"])
def test_mma_rounding_holds_the_row_limit(case):
    """At granite-3-8b's attention (Hq 32, Hkv 8, hd 128), the tensor-core
    bodies' rounding points (bf16 P with l from the rounded P; for int8
    pages the factorised products with an fp16 PV operand) followed by the
    output's own bf16 rounding keep every output row within 2^-7 of its
    largest |value| plus 1e-4 of the float32 plain version, the limit
    ``chip_smoke.py`` and ``test_torch_cuda.py`` hold the kernels to."""
    bf = torch.bfloat16
    if case.startswith("flash"):
        sq = int(case.split("-")[1])
        rng = np.random.RandomState(sq)
        q, k, v = (torch.from_numpy(rng.randn(1, sq, h, FULL["hd"])
                                    .astype(np.float32)).to(bf).float()
                   for h in (FULL["hq"], FULL["hkv"], FULL["hkv"]))
        want = tref.mha_reference(q, k, v)
        g = FULL["hq"] // FULL["hkv"]
        qs = q[0].reshape(sq, FULL["hkv"], g, -1).permute(1, 2, 0, 3)
        mask = torch.arange(sq)[None, :] <= torch.arange(sq)[:, None]
        o = _emulate_mma(qs, k[0].permute(1, 0, 2)[:, None],
                         v[0].permute(1, 0, 2)[:, None], mask)
        got = o.permute(2, 0, 1, 3).reshape(1, sq, FULL["hq"], -1)
    else:
        d = _full_ragged(seed=2)
        q = _torch(d["q"]).to(bf).float()
        tb, row, pos = (_torch(d[n]) for n in ("tables", "row", "pos"))
        if case == "ragged-bf16":
            k, v = (_torch(d[n]).to(bf).float() for n in ("k", "v"))
            quant = None
            want = tref.ragged_paged_attention_reference(q, k, v, tb, row,
                                                         pos)
            got = _emulate_ragged(q, k, v, tb, row, pos)
        else:
            k, ks, kz = tref.quantize_kv(_torch(d["k"]))
            v, vs, vz = tref.quantize_kv(_torch(d["v"]))
            quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs,
                     "v_zero": vz}
            want = tref.ragged_paged_attention_reference(
                q, k, v, tb, row, pos, kv_quant=quant)
            got = _emulate_ragged(q, k, v, tb, row, pos, quant)
        assert bool((got[pos < 0] == 0).all())
    _rows_within_limit(got.to(bf).float(), want)


@pytest.mark.parametrize("specs", [MATRIX[0][1], MATRIX[4][1]],
                         ids=["decode-only", "mixed"])
@pytest.mark.parametrize("group", [1, 4])
def test_int8_factorisation_equals_the_dequantized_product(specs, group):
    """In float32 (no rounding), scale and zero factored out of both
    products equal the plain version's dequantize-then-multiply to
    1e-5."""
    d = _ragged(specs, 2, group, 4, seed=9)
    k, ks, kz = tref.quantize_kv(_torch(d["k"]))
    v, vs, vz = tref.quantize_kv(_torch(d["v"]))
    quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
    q, tb, row, pos = (_torch(d[n]) for n in ("q", "tables", "row", "pos"))
    want = tref.ragged_paged_attention_reference(q, k, v, tb, row, pos,
                                                 kv_quant=quant)
    got = _emulate_ragged(q, k, v, tb, row, pos, quant, rounded=False)
    torch.testing.assert_close(got, want, **TOL)
    assert bool((got[pos < 0] == 0).all())


# ---------------------------------------------------------------------------
# the decode kernels' split over keys (csrc/decode_split.cuh), emulated
# ---------------------------------------------------------------------------

from types import SimpleNamespace  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402

KPS = tda.SPLIT_KEYS
LOG2E = 1.4426950408889634


def _split_decode(q, k, v, kv_len, rounded=False):
    """The tensor-core decode bodies' arithmetic in plain torch. q
    (B,1,Hq,hd) float; k, v (B,L,Hkv,hd) each row's kv positions in order
    (a paged row gathered through its table, or a cache strip); kv_len
    (B,). Split s holds positions [s KPS, (s + 1) KPS) below the row's
    length (the kernel zero-fills and masks the rest, which adds exact
    zeros): base-2 scores, the split's max m, p = 2^(x - m) (bf16 with
    ``rounded``, l summed from the rounded p), o = p v. The combine takes
    the max M over the row's ceil(len / KPS) splits and sums o 2^(m - M)
    and l 2^(m - M) in split order; a row with no split is 0."""
    b, _, hq, hd = q.shape
    n_keys, hkv = k.shape[1], k.shape[2]
    scale2 = tref.softmax_scale(hd) * LOG2E
    qs = q[:, 0].reshape(b, hkv, hq // hkv, hd)
    out = torch.zeros(b, hq, hd)
    for i, n in enumerate(kv_len.clamp(0, n_keys).tolist()):
        parts = []
        for k0 in range(0, n, KPS):
            ks = k[i, k0:min(n, k0 + KPS)].permute(1, 2, 0)   # (Hkv,hd,n)
            vs = v[i, k0:min(n, k0 + KPS)].permute(1, 0, 2)   # (Hkv,n,hd)
            x = (qs[i] @ ks) * scale2
            m = x.amax(-1, keepdim=True)
            p = torch.exp2(x - m)
            if rounded:
                p = p.to(torch.bfloat16).float()
            parts.append((m, p.sum(-1, keepdim=True), p @ vs))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = torch.zeros_like(parts[0][2]), torch.zeros_like(mx)
        for m, l, o in parts:
            c = torch.exp2(m - mx)
            num, den = num + o * c, den + l * c
        out[i] = (num / den.clamp_min(1e-30)).reshape(hq, hd)
    return out[:, None]


def _gathered(k_pages, tables):
    """Every row's nb * bs kv positions gathered through its table."""
    n = tables.shape[1] * k_pages.shape[1]
    return torch.stack([tref._gather_rows(k_pages, t, n) for t in tables])


SPLIT_LEN_SETS = [[0, 1, KPS, KPS + 1, 1024], [37, 1, 16, 50]]


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("lens", SPLIT_LEN_SETS, ids=["edges", "short"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_decode_split_combine_matches_plain(layout, lens, group):
    """In float32, the split over keys and its combine in split order equal
    the plain version and the JAX oracle to 1e-5, kv_len 0 rows exactly
    0 (the contiguous oracle averages uniformly there, so it is held on
    the other rows)."""
    kl = np.asarray(lens, np.int32)
    if layout == "paged":
        d = _decode(lens, 2, group, 16)
        args = [d[n] for n in ("q", "k", "v", "tables", "kv_len")]
        q, k, v, tb, tkl = map(_torch, args)
        got = _split_decode(q, _gathered(k, tb), _gathered(v, tb), tkl)
        want = ops.paged_decode_attention(q, k, v, tb, tkl)
        oracle = np.asarray(j_decode(*map(jnp.asarray, args)))
    else:
        d = _contig(lens, max(lens) + 9, group)
        q, k, v, tkl = map(_torch, d)
        got = _split_decode(q, k, v, tkl)
        want = ops.decode_attention(q, k, v, tkl)
        oracle = np.asarray(jax.jit(jref.decode_attention_reference)(
            *map(jnp.asarray, d)))
    torch.testing.assert_close(got, want, **TOL)
    live = kl > 0
    np.testing.assert_allclose(got.numpy()[live], oracle[live], **TOL)
    assert bool((got[torch.from_numpy(~live)] == 0).all())


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_decode_split_bits_ignore_table_width(layout, group):
    """A key's split depends on its position alone and splits past a row's
    end are never read: the same K/V under a table twice as wide (the extra
    entries naming random pages) or a cache with S doubled give the same
    bits."""
    lens = [0, 1, KPS, KPS + 1, 1024]
    rng = np.random.RandomState(5)
    if layout == "paged":
        d = _decode(lens, 2, group, 16, seed=5)
        q, k, v, tb, kl = map(_torch, [d[n] for n in ("q", "k", "v",
                                                      "tables", "kv_len")])
        wide = torch.cat([tb, torch.from_numpy(rng.randint(
            0, k.shape[0], tb.shape).astype(np.int32))], 1)
        a = _split_decode(q, _gathered(k, tb), _gathered(v, tb), kl)
        b = _split_decode(q, _gathered(k, wide), _gathered(v, wide), kl)
    else:
        q, k, v, kl = map(_torch, _contig(lens, 1040, group, seed=5))
        kw, vw = (torch.cat([x, torch.from_numpy(rng.randn(*x.shape).astype(
            np.float32))], 1) for x in (k, v))
        a = _split_decode(q, k, v, kl)
        b = _split_decode(q, kw, vw, kl)
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_decode_split_rounding_holds_the_row_limit(layout):
    """At granite-3-8b's attention (Hq 32, Hkv 8, hd 128) and the main
    path's kv_len 1024/777/300/1, the split bodies' rounding points (bf16 P
    with l from the rounded P, each split against its own max) followed by
    the output's bf16 rounding keep every output row within 2^-7 of its
    largest |value| plus 1e-4 of the float32 plain version."""
    lens = [1024, 777, 300, 1]
    rng = np.random.RandomState(7)
    b, hq, hkv, hd = len(lens), FULL["hq"], FULL["hkv"], FULL["hd"]
    kl = torch.tensor(lens, dtype=torch.int32)

    def bf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(
            np.float32)).to(torch.bfloat16).float()

    q = bf(b, 1, hq, hd)
    if layout == "paged":
        bs = FULL["bs"]
        nb = 1024 // bs + 1
        tb = torch.from_numpy(rng.permutation(b * nb + 1)[:b * nb].reshape(
            b, nb).astype(np.int32))
        k, v = bf(b * nb + 1, bs, hkv, hd), bf(b * nb + 1, bs, hkv, hd)
        want = tref.paged_decode_attention_reference(q, k, v, tb, kl)
        got = _split_decode(q, _gathered(k, tb), _gathered(v, tb), kl,
                            rounded=True)
    else:
        k, v = bf(b, 1024, hkv, hd), bf(b, 1024, hkv, hd)
        want = tref.decode_attention_reference(q, k, v, kl)
        got = _split_decode(q, k, v, kl, rounded=True)
    _rows_within_limit(got.to(torch.bfloat16).float(), want)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_decode_wrappers_size_the_split_from_shapes(monkeypatch, layout):
    """The wrappers' host side, on the CPU with the C entry point stubbed:
    the workspace holds B Hq n_split (hd + 2) floats, n_split = ceil(nb bs /
    SPLIT_KEYS) or ceil(S / SPLIT_KEYS), and each launch counts once under
    the body the entry point reports. kv_len lies on the meta device, where
    any read of its values raises: the wrappers never read it on the host,
    so a call holds no sync."""
    calls = []

    def entry(name, argtypes):
        def fn(*args):
            calls.append((name, args))
            args[-1]._obj.value = 1               # the tensor cores
            return 0
        return fn

    monkeypatch.setattr(_build, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "check_aligned", lambda *a, **k: None)
    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    seen = []
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        seen.append(t)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    b, hq, hkv, hd = 3, 8, 2, 32
    kl = torch.zeros(b, dtype=torch.int32, device="meta")
    q = torch.zeros(b, 1, hq, hd, dtype=torch.bfloat16)
    # the entry points' argument positions of the workspace and n_split
    ws_at, split_at = (6, 13) if layout == "paged" else (5, 11)
    ops.reset_launch_counts()
    for n_keys, want_split in ((1, 1), (KPS, 1), (KPS + 1, 2),
                               (1040, 9), (2080, 17)):
        seen.clear()
        if layout == "paged":
            bs = 16 if n_keys % 16 == 0 else 1
            pages = torch.zeros(4, bs, hkv, hd, dtype=torch.bfloat16)
            tb = torch.zeros(b, n_keys // bs, dtype=torch.int32)
            tda.paged_decode_attention(q, pages, pages, tb, kl)
        else:
            cache = torch.zeros(b, n_keys, hkv, hd, dtype=torch.bfloat16)
            tda.decode_attention(q, cache, cache, kl)
        assert tda.split_count(n_keys) == want_split
        _, args = calls[-1]
        assert args[split_at] == want_split
        (ws,) = seen
        assert ws.dtype == torch.float32
        assert ws.numel() == b * hq * want_split * (hd + 2)
        assert args[ws_at] == ws.data_ptr()
    name = ("paged_decode_attention" if layout == "paged"
            else "decode_attention")
    assert ops.launch_counts()[name] == 5
    assert ops.body_counts()[f"{name}/tensor_core"] == 5
    ops.reset_launch_counts()
