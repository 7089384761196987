"""The port's Mamba mixer and the hybrid jamba-v0.1-52b (attention at one
slot of eight, mamba elsewhere, sparse experts on odd slots) held against
the reference on the CPU, on the same weights (``convert.params_from_numpy``
of the JAX init) and inputs drawn from a numpy seed, in float32. The
smoke variant runs 16 layers (two periods of eight), so a 2-stage pipeline
gives each stage one period.

Tolerances: ``mamba_mixer``'s output and both cache leaves (the conv
history, the float32 SSM state) agree to 1e-5 of their largest |value|
(the reference scans chunks of 64 steps with ``lax.scan``, the port loops
over the steps; the sums run in another order); the paged prefill's
attention output and its pools (the projected K/V) agree to 1e-5 of their
largest |value|; prefill and decode logits and every mamba state agree to
1e-5 of their largest |value| at the reference's smoke depth (8 layers,
one period: through 16 the float32 drift comes to 1e-5 itself), and a
prefill then a decode step gives the full forward's logits to 1e-5 of
theirs; greedy token streams are equal exactly, on both layouts, at 1 and
2 stages and across consolidation; the converter and the chunked store
carry every leaf bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import mamba as jmamba
from repro.models.model import build_model as jax_model
from repro.serving.api import SamplingParams as JSP
from repro.serving.endpoint import ServingEndpoint as JEndpoint
from repro.serving.engine import Engine as JEngine
from repro.store import ModelStore as JStore
from repro.store import save_model as jax_save
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.core import Gbps
from repro_torch.models import attention as tattn
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServingEndpoint
from repro_torch.serving.engine import Engine
from repro_torch.serving.worker import StageWorker
from repro_torch.store import (FetchSchedule, ModelStore,
                               StreamedStageLoader, load_manifest,
                               save_model)
from test_torch_coldstart import (_assert_spans_close, _assert_trees_equal,
                                  _quickstart)

ARCH = "jamba-v0.1-52b"
REL = 1e-5
PROMPTS = [
    [1, 2, 3, 4, 5, 6, 7],
    [9, 8, 7, 6, 5],
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
    [11, 12, 13],
]
KW = dict(max_batch=3, max_seq=64, block_size=8)


def _cfgs(n_layers=16, **overrides):
    """The reference's serving config (``conftest.smoke``: no MoE drop) at
    ``n_layers``, and the port's copy."""
    jcfg = smoke(ARCH, n_layers=n_layers, **overrides)
    tcfg = dataclasses.replace(smoke_variant(get_config(ARCH)),
                               n_layers=n_layers,
                               capacity_factor=jcfg.capacity_factor,
                               **overrides)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _pair(n_layers):
    jcfg, tcfg = _cfgs(n_layers)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def jamba():
    """Two periods: the engines' and the stores' model."""
    return _pair(16)


@pytest.fixture(scope="module")
def jamba8():
    """One period (the reference's smoke depth): the logits' and states'
    model, where float32 drift through 16 layers would reach the 1e-5
    tolerance."""
    return _pair(8)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


def _period(tree, i=0):
    return {k: (_period(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# mamba_mixer against the reference's
# ---------------------------------------------------------------------------

# (tokens of a first forward, tokens of a second one on the carried cache)
MAMBA_CASES = {"full-70": (70, None), "short-10": (10, None),
               "carried-2": (9, 2), "decode": (9, 1)}


@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_mamba_mixer_equals_reference(jamba, case):
    """A full sequence of 70 steps (not a multiple of the reference's chunk
    of 64), one shorter than the chunk, a forward of 2 steps on a carried
    history (shorter than d_conv - 1 = 3, so part of the old history stays)
    and a decode step: outputs and both cache leaves."""
    jcfg, jparams, tcfg, tparams = jamba
    jp = _period(jparams["blocks"]["slot00"]["mixer"])
    tp = _period(tparams["blocks"]["slot00"]["mixer"])
    first, second = MAMBA_CASES[case]
    rng = np.random.RandomState(len(case))
    jc = jmamba.init_mamba_cache(jcfg, 2, jnp.float32)
    tc = _period(tmamba.init_mamba_cache(tcfg, 1, 2, torch.float32))
    for n, decode in ((first, False), (second, second == 1)):
        if n is None:
            break
        x = rng.standard_normal((2, n, tcfg.d_model)).astype(np.float32)
        jy, jc = jmamba.mamba_mixer(jcfg, jp, jnp.asarray(x), cache=jc,
                                    decode=decode)
        ty = tmamba.mamba_mixer(tcfg, tp, torch.from_numpy(x), cache=tc)
        _close(ty.numpy(), jy)
        for leaf in ("conv", "h"):
            _close(tc[leaf].numpy(), jc[leaf])
    d_in = tcfg.mamba_expand * tcfg.d_model
    assert tc["conv"].shape == (2, tcfg.mamba_d_conv - 1, d_in)
    assert tc["h"].shape == (2, d_in, tcfg.mamba_d_state)
    assert tc["h"].dtype == torch.float32


def test_mamba_without_a_cache_starts_from_zero(jamba):
    _, _, tcfg, tparams = jamba
    tp = _period(tparams["blocks"]["slot00"]["mixer"])
    x = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (1, 12, tcfg.d_model)).astype(np.float32))
    zero = _period(tmamba.init_mamba_cache(tcfg, 1, 1, torch.float32))
    torch.testing.assert_close(tmamba.mamba_mixer(tcfg, tp, x),
                               tmamba.mamba_mixer(tcfg, tp, x, cache=zero),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# self_attention's paged prefill (outside the ragged step)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hist_len", [0, 13])
def test_paged_prefill_attention_equals_reference(jamba, hist_len):
    """K/V written into the pools through scattered block tables, then
    flash attention over the chunk (``hist_len`` 0) or over the rows
    gathered back from the pools with ``q_offset`` (``hist_len`` 13, the
    first 13 rows written by an earlier chunk)."""
    jcfg, jparams, tcfg, tparams = jamba
    jp = _period(jparams["blocks"]["slot04"]["mixer"])
    tp = _period(tparams["blocks"]["slot04"]["mixer"])
    rng = np.random.RandomState(7)
    b, s, bs, nb = 2, 11, 4, 8
    tables = rng.permutation(b * nb).reshape(b, nb).astype(np.int32)
    shp = (b * nb + 1, bs, tcfg.n_kv_heads, tcfg.head_dim)
    jk, jv = jnp.zeros(shp), jnp.zeros(shp)
    tk, tv = torch.zeros(shp), torch.zeros(shp)
    for start, n in ((0, hist_len), (hist_len, s)):
        if n == 0:
            continue
        x = rng.standard_normal((b, n, tcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                              (b, n))
        jy, (jk, jv) = jattn.self_attention(
            jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
            kv_cache=(jk, jv), block_tables=jnp.asarray(tables),
            hist_len=start)
        ty, _ = tattn.self_attention(
            tcfg, tp, torch.from_numpy(x), positions=torch.from_numpy(
                pos.copy()), kv_cache=(tk, tv),
            block_tables=torch.from_numpy(tables), hist_len=start)
        _close(ty.numpy(), jy)
        _close(tk.numpy(), jk)
        _close(tv.numpy(), jv)
    # the gather itself is exact: the same pool gives the same rows
    got = tattn.paged_kv_gather(tk, torch.from_numpy(tables), hist_len + s)
    want = jattn.paged_kv_gather(jnp.asarray(tk.numpy()),
                                 jnp.asarray(tables), hist_len + s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_prefill_refusals(jamba):
    _, _, tcfg, tparams = jamba
    tp = _period(tparams["blocks"]["slot04"]["mixer"])
    x = torch.zeros(1, 3, tcfg.d_model)
    pos = torch.arange(3, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="hist_len"):
        tattn.self_attention(tcfg, tp, x, positions=pos, hist_len=2)
    m = Model(tcfg)
    with pytest.raises(ValueError, match="attention-only"):
        m.prefill(tparams, torch.tensor([[1, 2, 3]]), 16, kv_dtype="int8")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_hybrid_defs_and_stage_accounting_match_reference(jamba):
    jcfg, _, tcfg, _ = jamba
    jm, tm = jax_model(jcfg), Model(tcfg)
    jdefs = _flat(jax.tree.map(lambda d: d, jm.defs,
                               is_leaf=lambda x: hasattr(x, "axes")))
    assert {k: (d.shape, d.init) for k, d in jdefs.items()} == \
        {k: (d.shape, d.init) for k, d in _flat(tm.defs).items()}
    assert tm.bytes() == jm.bytes()
    for i in range(2):
        assert tm.stage_bytes(2, i) == jm.stage_bytes(2, i)
    full = get_config(ARCH)
    assert Model(full).bytes() == jax_model(jget(ARCH)).bytes()
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.n_experts, full.top_k, full.expert_d_ff, full.mamba_d_state,
            full.mamba_d_conv, full.padded_vocab) == \
        (32, 4096, 32, 8, 16, 2, 14336, 16, 4, 65536)
    # the reference's dt_rank: d_in // 16 = 512 (the public config's
    # mamba_dt_rank is 256; the port copies the reference)
    dt_w = Model(full).defs["blocks"]["slot00"]["mixer"]["dt_w"]
    assert dt_w.shape[1:] == (512, 8192)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_convert_round_trips_every_leaf_exactly(dtype):
    """``params_from_numpy`` carries the router, ``A_log``, ``conv_w`` and
    the expert stacks (every leaf) bit for bit."""
    jcfg, _ = _cfgs(dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jax_model(jcfg).init(jax.random.PRNGKey(1)))
    tparams = params_from_numpy(jparams, "cpu")
    want, got = _flat(jparams), _flat(tparams)
    assert want.keys() == got.keys()
    for key in ("/blocks/slot01/mlp/router", "/blocks/slot00/mixer/A_log",
                "/blocks/slot00/mixer/conv_w", "/blocks/slot01/mlp/w_gate"):
        assert key in got
    for k, a in want.items():
        t = got[k]
        assert tuple(t.shape) == a.shape, k
        raw = t.view(torch.int16) if dtype == "bfloat16" else t
        ref = a.view(np.int16) if dtype == "bfloat16" else a
        assert np.array_equal(raw.numpy(), ref), k


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_hybrid_prefill_and_decode_match_reference(jamba8, paged):
    """``Model.prefill`` (contiguous; paged: K/V into the pools, flash over
    the prompt) and three ``decode_step``s against the reference's
    contiguous ones: logits, and every mamba slot's cache leaves."""
    jcfg, jparams, tcfg, tparams = jamba8
    jm, tm = jax_model(jcfg), Model(tcfg)
    toks = np.random.RandomState(0).randint(0, tcfg.vocab, (2, 11)).astype(
        np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks), 32, page_size=8,
                        paged=paged)
    states = tc["pools"] if paged else tc
    if paged:
        assert set(states["slot04"]) == {"k_pages", "v_pages"}
    for step in range(4):
        _close(tl.numpy(), jl)
        for name in ("slot00", "slot03", "slot07"):
            for leaf in ("conv", "h"):
                _close(states[name][leaf].numpy(), jc[name][leaf])
        if step == 3:
            break
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok[:, 0])
        pos = np.full((2, 1), 11 + step, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_hybrid_prefill_then_decode_equals_the_full_forward(jamba, paged):
    """``tests/test_consistency.py`` on the port, at 16 layers: the conv
    history, the SSM state and the K/V carry exactly what the next token
    needs."""
    _, _, tcfg, tparams = jamba
    m = Model(tcfg)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, tcfg.vocab, (2, 11)).astype(np.int32))
    pos = torch.arange(11, dtype=torch.int32)[None].expand(2, 11)
    x = transformer.embed(tcfg, tparams, toks, pos, dtype=m.dtype)
    x, _ = transformer.run_blocks(tcfg, tparams["blocks"], x, pos)
    full = transformer.head(tcfg, tparams, x)[:, -1]
    _, cache = m.prefill(tparams, toks[:, :10], 16, page_size=8,
                         paged=paged)
    dec, _ = m.decode_step(tparams, cache, toks[:, 10:],
                           torch.full((2, 1), 10, dtype=torch.int32))
    _close(dec.numpy(), full.numpy())


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_hybrid_worker_prefill_starts_the_slot_from_zero(jamba, paged):
    """A slot's mamba states drift under idle decode steps; a prefill into
    it starts them from zero (the reference's fresh batch-1 cache), its
    attention K/V go to the pools through the slot's table row (paged) or
    its strip, and the other slots keep theirs. A paged prefill without
    the table row is refused."""
    _, _, tcfg, tparams = jamba
    kw = dict(paged=paged, n_pages=25 if paged else None,
              page_size=8 if paged else None, device="cpu")
    fresh = StageWorker(tcfg, tparams, 1, 0, 3, 64, **kw)
    stale = StageWorker(tcfg, tparams, 1, 0, 3, 64, **kw)
    gen = torch.Generator().manual_seed(0)
    for leaf in stale.cache["slot00"].values():
        leaf.normal_(generator=gen)
    other = {k: v[:, 2].clone() for k, v in stale.cache["slot00"].items()}
    toks = torch.tensor([[5, 6, 7, 8]], dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None]
    bt = torch.tensor([[3, 9, 24, 24, 24, 24, 24, 24, 24]],
                      dtype=torch.int32) if paged else None
    if paged:
        with pytest.raises(ValueError, match="block_tables"):
            stale.prefill_slot(toks, 1, pos)
    want = fresh.prefill_slot(toks, 1, pos, block_tables=bt)
    got = stale.prefill_slot(toks, 1, pos, block_tables=bt)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for k, v in stale.cache["slot00"].items():
        torch.testing.assert_close(v[:, 1], fresh.cache["slot00"][k][:, 1],
                                   atol=0, rtol=0)
        assert torch.equal(v[:, 2], other[k])
    if paged:
        pool = stale.cache["slot04"]["k_pages"]
        assert bool(pool[:, 3].any()) and not bool(pool[:, 9].any())
        assert not bool(pool[:, :3].any())


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _serve(E, SP, ep_cls, cfg, stage_params, full, kw, extra=None):
    ep = ep_cls(E(cfg, stage_params, **KW, **kw, **(extra or {})))
    reqs = [ep.submit(p, SP(max_new=6)) for p in PROMPTS]
    if len(stage_params) > 1:
        for _ in range(3):
            ep.step()
        ep.consolidate(full)
        assert ep.n_stages == 1
    ep.run()
    return [list(r.generated) for r in reqs], ep


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_hybrid_engine_streams_equal_reference(jamba, paged, stages):
    """Greedy streams equal the reference engine's on the same weights; the
    2-stage endpoints are consolidated after 3 steps, the mamba states
    moving whole with the attention pages, and the migrated KV bytes are
    equal (only page-pool bytes count)."""
    jcfg, jparams, tcfg, tparams = jamba
    jm, tm = jax_model(jcfg), Model(tcfg)
    jsp = [jm.slice_stage_params(jparams, stages, i) for i in range(stages)]
    tsp = [tm.slice_stage_params(tparams, stages, i) for i in range(stages)]
    kw = dict(paged=paged)
    want, jep = _serve(JEngine, JSP, JEndpoint, jcfg, jsp, jparams, kw)
    got, tep = _serve(Engine, SamplingParams, ServingEndpoint, tcfg, tsp,
                      tparams, kw, extra={"device": "cpu"})
    assert got == want
    assert all(len(s) == 6 for s in got)
    assert tep.last_migration_bytes == jep.last_migration_bytes
    if stages == 2:
        assert (tep.last_migration_bytes > 0) if paged else \
            tep.last_migration_bytes is None
    cache = tep.engine.workers[0].cache
    assert cache["slot00"]["h"].shape[0] == tcfg.n_periods
    assert ("k_pages" if paged else "k") in cache["slot04"]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_hybrid_slots_reused_after_idle_decode_equal_reference(jamba,
                                                               paged):
    jcfg, jparams, tcfg, tparams = jamba
    prompts = PROMPTS + [[7, 7, 2], [5, 4, 3, 2, 1, 9]]
    runs = []
    for E, SP, cfg, p, extra in ((JEngine, JSP, jcfg, jparams, {}),
                                 (Engine, SamplingParams, tcfg, tparams,
                                  {"device": "cpu"})):
        eng = E(cfg, [p], **KW, paged=paged, **extra)
        reqs = [eng.submit(q, SP(max_new=4 + i))
                for i, q in enumerate(prompts[:2])]
        for _ in range(4):
            eng.step()
        reqs += [eng.submit(q, SP(max_new=3 + i % 3))
                 for i, q in enumerate(prompts[2:])]
        eng.run()
        runs.append([list(r.generated) for r in reqs])
    assert runs[0] == runs[1]


def test_hybrid_refuses_attention_only_options(jamba):
    jcfg, jparams, tcfg, tparams = jamba
    for kw in ({"prefix_cache": True}, {"prefill_chunk": 4},
               {"fused": True}, {"kv_dtype": "int8"}):
        with pytest.raises(ValueError):
            JEngine(jcfg, [jparams], **KW, paged=True, **kw)
        with pytest.raises(ValueError,
                           match="attention-only|recurrent|fused"):
            Engine(tcfg, [tparams], **KW, paged=True, device="cpu", **kw)


@pytest.mark.parametrize("stages", [1, 2])
def test_hybrid_n_attn_layers_equal_reference(jamba, stages):
    jcfg, jparams, tcfg, tparams = jamba
    jm, tm = jax_model(jcfg), Model(tcfg)
    jeng = JEngine(jcfg, [jm.slice_stage_params(jparams, stages, i)
                          for i in range(stages)], **KW, paged=True)
    teng = Engine(tcfg, [tm.slice_stage_params(tparams, stages, i)
                         for i in range(stages)], **KW, paged=True,
                  device="cpu")
    for migrated_only in (False, True):
        assert teng.n_attn_layers(migrated_only=migrated_only) == \
            jeng.n_attn_layers(migrated_only=migrated_only)
    assert teng.n_attn_layers() == 2            # one a period


# ---------------------------------------------------------------------------
# the quickstart twin and the chunked store
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jamba_quickstarts(jamba):
    jcfg, jparams, tcfg, tparams = jamba
    cfgs = (jcfg, tcfg)
    return (cfgs, jparams, tparams,
            _quickstart("jax", jparams, cfgs=cfgs),
            _quickstart("port", tparams, cfgs=cfgs))


def test_hybrid_quickstart_equals_reference(jamba_quickstarts):
    """Alg. 1's scheme, the simulated timeline (to 1e-9 s) and the stream
    across the consolidation through ``full_params`` equal the
    reference's."""
    _, _, _, j, t = jamba_quickstarts
    assert dataclasses.asdict(t["ep"].scheme) == \
        dataclasses.asdict(j["ep"].scheme)
    assert t["ep"].cold_start_timeline.s == 2
    _assert_spans_close(t["ep"].cold_start_timeline.to_json(),
                        j["ep"].cold_start_timeline.to_json())
    assert t["before"] == j["before"] and len(t["before"]) == 6
    assert list(t["req"].generated) == list(j["req"].generated)
    assert len(t["req"].generated) == 12
    assert t["ep"].n_stages == 1
    assert "h" in t["ep"].engine.workers[0].cache["slot00"]


def test_hybrid_stores_cross_load_both_ways(jamba_quickstarts, tmp_path):
    """Each package's store of the 8-slot period-stacked tree: equal
    manifests and chunk bytes, stage bytes equal ``Model.stage_bytes``,
    each store read back by the other package, and a cold deploy from the
    other package's store serves the same stream."""
    cfgs, jparams, tparams, j, t = jamba_quickstarts
    jcfg, tcfg = cfgs
    save_model(str(tmp_path / "port"), Model(tcfg), tparams)
    jax_save(str(tmp_path / "jax"), jax_model(jcfg), jparams)
    man = load_manifest(str(tmp_path / "port"))
    assert man.to_json() == load_manifest(str(tmp_path / "jax")).to_json()
    for s in man.degrees:
        for i in range(s):
            assert man.stage_bytes(s, i) == Model(tcfg).stage_bytes(s, i)
    jstore = JStore.open(str(tmp_path / "port"))
    want = {tuple(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jparams)[0]}
    for c in jstore.manifest.chunks:
        assert jstore.read_range(c, 0, c.nbytes).tobytes() == \
            want[c.path].tobytes(), c.key
    tstore = ModelStore.open(str(tmp_path / "jax"))
    loader = StreamedStageLoader(tstore, FetchSchedule.single(16 * Gbps),
                                 device="cpu")
    full, _ = loader.load_stage(1, 0)
    _assert_trees_equal(full, tparams)
    port = _quickstart("port", None, store_dir=str(tmp_path / "jax"),
                       cold=True, cfgs=cfgs)
    jax_side = _quickstart("jax", None, store_dir=str(tmp_path / "port"),
                           cold=True, cfgs=cfgs)
    assert list(port["req"].generated) == list(j["req"].generated) == \
        list(jax_side["req"].generated) == list(t["req"].generated)


# ---------------------------------------------------------------------------
# every decoder family the reference registers
# ---------------------------------------------------------------------------

DECODERS = ["granite-3-8b", "internlm2-20b", "starcoder2-7b", "qwen1.5-32b",
            "qwen2-moe-a2.7b", "grok-1-314b", "llava-next-34b",
            "jamba-v0.1-52b", "rwkv6-1.6b"]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", DECODERS)
def test_every_decoder_family_prefill_matches_reference(name, paged):
    """Each registered decoder's smoke variant (the reference's serving
    config) prefills on either layout to the reference's logits, to 1e-5
    of their largest |value| (whisper, the encoder-decoder, has its own:
    ``tests/test_torch_encdec.py``)."""
    jcfg = smoke(name)
    tcfg = dataclasses.replace(smoke_variant(get_config(name)),
                               capacity_factor=jcfg.capacity_factor)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.RandomState(0).randint(0, tcfg.vocab, (2, 11)).astype(
        np.int32)
    jl, _ = jax_model(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)},
                                    32)
    tl, _ = Model(tcfg).prefill(tparams, torch.from_numpy(toks), 32,
                                page_size=8, paged=paged)
    _close(tl.numpy(), jl)

