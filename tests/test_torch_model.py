"""The port's model layer held against the reference on the CPU, on the
same weights (``convert.params_from_numpy`` of the JAX init).

Tolerances: the converter is exact (bit for bit); prefill and decode
logits agree to atol 1e-4 in float32 (the port prefills through the
ragged paged path, the reference through its contiguous path, so the sums
run in another order); a 2-stage pipeline gives the same logits as the
1-stage one exactly (same operations on the same tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.models.model import build_model as jax_model
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import Model
from repro_torch.serving.runner import ModelRunner


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def granite():
    jcfg = smoke("granite-3-8b")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tcfg = smoke_variant(get_config("granite-3-8b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def test_config_copy_matches_reference():
    from repro.configs import get_config as jget
    for name in ("granite-3-8b", "rwkv6-1.6b"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget(name))
        assert dataclasses.asdict(smoke_variant(get_config(name))) == \
            dataclasses.asdict(smoke(name))
    full = get_config("granite-3-8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.padded_vocab) == \
        (40, 4096, 32, 8, 128, 12800, 49408)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trips_every_leaf_exactly(dtype):
    jcfg = dataclasses.replace(smoke("granite-3-8b"), dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jax_model(jcfg).init(jax.random.PRNGKey(1)))
    tparams = params_from_numpy(jparams, "cpu")
    want, got = _flat(jparams), _flat(tparams)
    assert want.keys() == got.keys()
    for k, a in want.items():
        t = got[k]
        assert tuple(t.shape) == a.shape, k
        assert str(t.dtype) == f"torch.{dtype}", k
        raw = t.view(torch.int16) if dtype == "bfloat16" else t
        ref = a.view(np.int16) if dtype == "bfloat16" else a
        assert np.array_equal(raw.numpy(), ref), k


def test_defs_and_stage_accounting_match_reference(granite):
    jcfg, _, tcfg, _ = granite
    jm, tm = jax_model(jcfg), Model(tcfg)
    jdefs = _flat(jax.tree.map(lambda d: d, jm.defs,
                               is_leaf=lambda x: hasattr(x, "axes")))
    tdefs = _flat(tm.defs)
    assert {k: (d.shape, d.init) for k, d in jdefs.items()} == \
        {k: (d.shape, d.init) for k, d in tdefs.items()}
    assert tm.bytes() == jm.bytes()
    for s in (1, 2):
        assert tm.stage_ranges(s) == jm.stage_ranges(s)
        for i in range(s):
            assert tm.stage_bytes(s, i) == jm.stage_bytes(s, i)


def test_init_follows_the_std_rule():
    cfg = dataclasses.replace(smoke_variant(get_config("granite-3-8b")),
                              d_model=256, d_ff=512)
    p = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    w = p["blocks"]["slot00"]["mlp"]["w_up"]          # fan_in = d_model
    assert abs(float(w.std()) * 256 ** 0.5 - 1.0) < 0.02
    assert torch.equal(p["final_norm"], torch.ones(256))
    q = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(q)))


def test_prefill_and_decode_logits_match_reference(granite):
    jcfg, jparams, tcfg, tparams = granite
    rng = np.random.RandomState(0)
    b, s, steps = 2, 11, 3
    tokens = rng.randint(0, jcfg.vocab, (b, s)).astype(np.int32)
    jm, tm = jax_model(jcfg), Model(tcfg)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                            max_seq=s + steps + 1)
    tl, tcache = tm.prefill(tparams, torch.from_numpy(tokens),
                            max_seq=s + steps + 1, page_size=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        pos = np.full((b, 1), s + i, np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    # padded vocab entries never win
    assert int(tl.argmax(-1).max()) < tcfg.vocab


def test_stage_params_are_views(granite):
    _, _, tcfg, tparams = granite
    m = Model(tcfg)
    stages = [m.slice_stage_params(tparams, 2, i) for i in range(2)]
    full = tparams["blocks"]["slot00"]["mixer"]["w_q"]
    for st in stages:
        part = st["blocks"]["slot00"]["mixer"]["w_q"]
        assert part.untyped_storage().data_ptr() == \
            full.untyped_storage().data_ptr()
    assert stages[0]["embed"]["tok"] is tparams["embed"]["tok"]
    assert "lm_head" in stages[1] and "lm_head" not in stages[0]


def test_two_stage_pipeline_gives_the_same_logits(granite):
    _, _, tcfg, tparams = granite
    m = Model(tcfg)
    runners = []
    for n in (1, 2):
        sp = [m.slice_stage_params(tparams, n, i) for i in range(n)]
        r = ModelRunner(tcfg, sp, 3, 64, paged=True, n_blocks=24,
                        block_size=8, device="cpu")
        r.set_row(0, [0, 1, 2])
        r.set_row(1, [3, 4])
        runners.append(r)
    segs = [(0, list(range(1, 20)), 0), (1, [7, 8, 9], 0)]
    a, b = (r.forward_batch(segs) for r in runners)
    assert torch.equal(a, b)
    segs = [(0, [5], 19), (1, [6, 7, 8, 9], 3)]
    a, b = (r.forward_batch(segs) for r in runners)
    assert torch.equal(a, b)
    for r in runners:
        r.set_row(0, [0, 1, 2])
    reqs = [type("R", (), dict(slot=0, generated=[4], pos_next=20))(),
            type("R", (), dict(slot=1, generated=[3], pos_next=7))()]
    a, b = (r.decode(reqs) for r in runners)
    assert torch.equal(a, b)
    assert torch.isfinite(a[:2]).all()


def test_int8_prefill_matches_the_int8_runner(granite):
    """``Model.prefill(kv_dtype="int8")`` stores quantized pools and gives
    the logits the serving runner's int8 ragged step gives for the same
    prompt (float32; the two lay the batch out with different padding)."""
    _, _, tcfg, tparams = granite
    m = Model(tcfg)
    tokens = np.random.RandomState(1).randint(0, tcfg.vocab, 13).tolist()
    tl, tcache = m.prefill(tparams, torch.tensor([tokens]), max_seq=32,
                           page_size=4, kv_dtype="int8")
    pool = tcache["pools"]["slot00"]
    assert pool["k_pages"].dtype == torch.int8 and "v_zero" in pool
    r = ModelRunner(tcfg, [tparams], 2, 32, paged=True, n_blocks=16,
                    block_size=4, kv_dtype="int8", device="cpu")
    r.set_row(0, [0, 1, 2, 3])
    want = r.forward_batch([(0, tokens, 0)])[0]
    torch.testing.assert_close(tl[0], want, atol=1e-5, rtol=1e-5)


def test_contiguous_prefill_and_decode_match_reference(granite):
    """``Model.prefill(paged=False)`` (flash attention into fresh
    slot-contiguous slabs) and ``decode_step`` on those slabs against the
    reference's contiguous ``Model.prefill``/``decode_step``: logits to
    atol 1e-4 and the K/V slabs to 1e-5 (float32, sums in another
    order)."""
    jcfg, jparams, tcfg, tparams = granite
    jm, tm = jax_model(jcfg), Model(tcfg)
    toks = np.random.RandomState(0).randint(0, tcfg.vocab, (2, 9)).astype(
        np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks), 32, paged=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name in jc:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tc[name][leaf].numpy(),
                                       np.asarray(jc[name][leaf]), atol=1e-5)
    nxt = np.asarray([[3], [4]], np.int32)
    pos = np.asarray([[9], [9]], np.int32)
    jl2, _ = jm.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(pos))
    tl2, _ = tm.decode_step(tparams, tc, torch.from_numpy(nxt),
                            torch.from_numpy(pos))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4)


def test_contiguous_worker_prefills_its_slot_and_clears_it(granite):
    """A slot-contiguous prefill writes only the prompt rows of its slot's
    strips and leaves the rows after as they were (no kernel reads them);
    ``clear_slot`` zeroes the strip."""
    from repro_torch.serving.worker import StageWorker
    _, _, tcfg, tparams = granite
    w = StageWorker(tcfg, tparams, 1, 0, 3, 16, paged=False, device="cpu")
    k = w.cache["slot00"]["k"]
    k[:, 2] = 7.0                          # a stale strip in another slot
    k[:, 1] = 5.0                          # stale rows of the target slot
    toks = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32)
    out = w.prefill_slot(toks, 1, torch.arange(5, dtype=torch.int32)[None])
    assert out.shape == (1, 1, tcfg.padded_vocab)
    assert bool((k[:, 1, :5] != 5.0).any())
    assert bool((k[:, 1, 5:] == 5.0).all())
    assert bool((k[:, 2] == 7.0).all()) and not bool(k[:, 0].any())
    w.clear_slot(1)
    assert not bool(w.cache["slot00"]["k"][:, 1].any())
    assert bool((k[:, 2] == 7.0).all())
    with pytest.raises(ValueError, match="paged layout"):
        StageWorker(tcfg, tparams, 1, 0, 3, 16, paged=False,
                    kv_dtype="int8", device="cpu")


# ---------------------------------------------------------------------------
# rwkv6-1.6b: the WKV6 time mix and its recurrent caches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rwkv():
    """The smoke variant (2 layers, d 64, 4 heads of 16, float32) on the
    JAX init's weights."""
    jcfg = smoke("rwkv6-1.6b")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tcfg = smoke_variant(get_config("rwkv6-1.6b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def test_rwkv_defs_and_stage_accounting_match_reference(rwkv):
    jcfg, _, tcfg, _ = rwkv
    jm, tm = jax_model(jcfg), Model(tcfg)
    jdefs = _flat(jax.tree.map(lambda d: d, jm.defs,
                               is_leaf=lambda x: hasattr(x, "axes")))
    assert {k: (d.shape, d.init) for k, d in jdefs.items()} == \
        {k: (d.shape, d.init) for k, d in _flat(tm.defs).items()}
    assert tm.bytes() == jm.bytes()
    for i in range(2):
        assert tm.stage_bytes(2, i) == jm.stage_bytes(2, i)
    full = get_config("rwkv6-1.6b")
    assert (full.n_layers, full.d_model, full.n_heads, full.head_dim,
            full.d_ff, full.padded_vocab) == (24, 2048, 32, 64, 7168, 65536)


def test_rwkv_prefill_and_decode_match_reference(rwkv):
    """``Model.prefill(paged=False)`` and three ``decode_step``s against the
    reference's: logits to atol 1e-4, the recurrent ``shift``/``wkv``
    caches to 1e-5 (float32, sums in another order)."""
    jcfg, jparams, tcfg, tparams = rwkv
    jm, tm = jax_model(jcfg), Model(tcfg)
    toks = np.random.RandomState(0).randint(0, tcfg.vocab, (2, 11)).astype(
        np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks), 32, paged=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for step in range(3):
        for name in jc:
            assert set(tc[name]) == set(jc[name]) == {"shift", "wkv"}
            for leaf in ("shift", "wkv"):
                np.testing.assert_allclose(tc[name][leaf].numpy(),
                                           np.asarray(jc[name][leaf]),
                                           atol=1e-5)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        pos = np.full((2, 1), 11 + step, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_rwkv_prefill_then_decode_equals_the_full_forward(rwkv):
    """Prefill of S tokens then one decode step gives the logits of the
    full forward over S + 1 tokens at its last position
    (``tests/test_consistency.py``): the recurrent caches carry exactly the
    state the next token needs."""
    from repro_torch.models import transformer
    _, _, tcfg, tparams = rwkv
    m = Model(tcfg)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, tcfg.vocab, (2, 11)).astype(np.int32))
    pos = torch.arange(11, dtype=torch.int32)[None].expand(2, 11)
    x = transformer.embed(tcfg, tparams, toks, pos, dtype=m.dtype)
    x, _, _ = transformer.run_blocks(tcfg, tparams["blocks"], x, pos)
    full = transformer.head(tcfg, tparams, x)[:, -1]
    _, cache = m.prefill(tparams, toks[:, :10], 16, paged=False)
    dec, _ = m.decode_step(tparams, cache, toks[:, 10:],
                           torch.full((2, 1), 10, dtype=torch.int32))
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)


def test_rwkv_paged_prefill_is_refused(rwkv):
    """The ragged route is attention-only (the reference's
    ``serving/runner.py`` sends a recurrent model elsewhere): a recurrent
    model's paged prefill runs outside it, and int8 pages, which only the
    ragged step serves, are refused."""
    _, _, tcfg, tparams = rwkv
    toks = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="attention-only"):
        Model(tcfg).prefill(tparams, toks, 16, kv_dtype="int8")
    paged, _ = Model(tcfg).prefill(tparams, toks, 16)
    contiguous, _ = Model(tcfg).prefill(tparams, toks, 16, paged=False)
    torch.testing.assert_close(paged, contiguous, atol=0, rtol=0)


@pytest.mark.parametrize("paged", [False, True])
def test_rwkv_worker_prefill_starts_the_slot_from_zero(rwkv, paged):
    """A slot's recurrent states drift under idle decode steps; a prefill
    into it must start from zero, as the reference's fresh batch-1 cache
    does: the logits and the states equal those of a fresh worker, and the
    other slots keep theirs."""
    from repro_torch.serving.worker import StageWorker
    _, _, tcfg, tparams = rwkv
    kw = dict(paged=paged, n_pages=9 if paged else None,
              page_size=8 if paged else None, device="cpu")
    fresh = StageWorker(tcfg, tparams, 1, 0, 3, 32, **kw)
    stale = StageWorker(tcfg, tparams, 1, 0, 3, 32, **kw)
    for leaf in stale.cache["slot00"].values():
        leaf.normal_(generator=torch.Generator().manual_seed(0))
    other = {k: v[:, 2].clone() for k, v in stale.cache["slot00"].items()}
    toks = torch.tensor([[5, 6, 7, 8]], dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None]
    want = fresh.prefill_slot(toks, 1, pos)
    got = stale.prefill_slot(toks, 1, pos)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for k, v in stale.cache["slot00"].items():
        torch.testing.assert_close(v[:, 1], fresh.cache["slot00"][k][:, 1],
                                   atol=0, rtol=0)
        assert torch.equal(v[:, 2], other[k])
    stale.clear_slot(1)
    assert not any(bool(v[:, 1].any())
                   for v in stale.cache["slot00"].values())
