"""The port's sparse experts (qwen2-moe-a2.7b) held against the reference
on the CPU, on the same weights (``convert.params_from_numpy`` of the JAX
init) and inputs drawn from a numpy seed, in float32.

Tolerances: ``moe_mlp``'s output and load-balancing loss agree to 1e-5 of
the output's largest |value| (the expert products and the combine add in
another order; the routing, the sort and the drop rule are the same);
prefill and decode logits agree to 1e-5 of their largest |value|; a
prefill then a decode step gives the full forward's logits to 1e-5 of
theirs; greedy token streams are equal exactly, on both layouts, for the
paged, fused and int8 fused steps, at 1 and 2 stages and across
consolidation. The engines run the reference's serving config
(``conftest.smoke``: capacity factor = experts, no drop) as its own
engine tests do; ``moe_mlp`` runs the published capacity factor 1.25 in
three regimes: no drop (t 4: rows 8, capacity = rows), drop (t 20: one
group, rows 40, capacity 12) and grouped (t 256: 16 groups of 32 rows,
capacity 10, dropping inside groups).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs import get_config as jget
from repro.configs import smoke_variant as jsmoke
from repro.models import mlp as jmlp
from repro.models.model import build_model as jax_model
from repro.serving.api import SamplingParams as JSP
from repro.serving.endpoint import ServingEndpoint as JEndpoint
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServingEndpoint
from repro_torch.serving.engine import Engine

ARCH = "qwen2-moe-a2.7b"
REL = 1e-5
PROMPTS = [
    [1, 2, 3, 4, 5, 6, 7],
    [9, 8, 7, 6, 5],
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
    [11, 12, 13],
]
KW = dict(max_batch=3, max_seq=64, block_size=8)


def _pair(**overrides):
    """The reference's serving config (no drop) and the port's copy, the
    JAX init's params on both sides."""
    jcfg = smoke(ARCH, **overrides)
    tcfg = dataclasses.replace(smoke_variant(get_config(ARCH)), **{
        **overrides, "capacity_factor": jcfg.capacity_factor})
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def qwen():
    return _pair()


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# moe_mlp against the reference's, in its three regimes
# ---------------------------------------------------------------------------

# t rows of x -> (groups, rows a group, capacity) at capacity factor 1.25,
# 4 experts, top-2
REGIMES = {"no-drop": (4, 1, 8, 8), "drop": (20, 1, 40, 12),
           "grouped": (256, 16, 32, 10)}


def _skewed(rng, shape, router):
    """Standard normal rows pushed toward expert 0 (its router column, 4
    logits' worth), so routing is as uneven as real traffic makes it and
    the capacity binds."""
    x = rng.standard_normal(shape)
    col = router[:, 0] / np.linalg.norm(router[:, 0]) ** 2
    return (x + 4.0 * col).astype(np.float32)


@pytest.mark.parametrize("shared", [1, 0], ids=["shared", "no-shared"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_moe_mlp_equals_reference(regime, shared):
    t, groups, rows, capacity = REGIMES[regime]
    jcfg = dataclasses.replace(jsmoke(jget(ARCH)), n_shared_experts=shared)
    tcfg = dataclasses.replace(smoke_variant(get_config(ARCH)),
                               n_shared_experts=shared)
    assert jcfg.capacity_factor == tcfg.capacity_factor == 1.25
    jp = jax.tree.map(lambda a: a[0], jax_model(jcfg).init(
        jax.random.PRNGKey(3))["blocks"]["slot00"]["mlp"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert ("shared_gate" in tp) == bool(shared)
    x = _skewed(np.random.RandomState(t), (2, t // 2, tcfg.d_model),
                np.asarray(jp["router"]))
    assert tmlp.moe_groups(t) == groups
    assert tmlp.moe_capacity(tcfg, rows) == capacity
    # the drop regimes really drop: some expert of some group is routed
    # more rows than it keeps
    probs = torch.softmax(torch.from_numpy(x).reshape(groups, -1,
                                                      tcfg.d_model)
                          @ tp["router"], -1)
    top = torch.topk(probs, tcfg.top_k, -1).indices.reshape(groups, -1)
    most = max(int(torch.bincount(g, minlength=tcfg.n_experts).max())
               for g in top)
    assert (most > capacity) == (regime != "no-drop")
    jy, jaux = jmlp.moe_mlp(jcfg, jp, jnp.asarray(x))
    ty, taux = tmlp.moe_mlp(tcfg, tp, torch.from_numpy(x))
    assert ty.shape == x.shape and taux.dtype == torch.float32
    _close(ty.numpy(), jy)
    assert abs(float(taux) - float(jaux)) <= REL * abs(float(jaux))


def _loop_moe(cfg, p, x):
    """The drop rule one routed row at a time: in each group, a token's
    k choices in order, each kept while its expert has taken fewer than
    ``capacity`` rows of the group (so a row's rank is its place among its
    expert's rows in (token, choice) order: the stable sort's)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = tmlp.moe_groups(b * s)
    xg = x.reshape(g, -1, d)
    tg = xg.shape[1]
    cap = tmlp.moe_capacity(cfg, tg * k)
    out = torch.zeros_like(xg)
    for gi in range(g):
        probs = torch.softmax(xg[gi] @ p["router"], -1)
        w, idx = torch.topk(probs, k, -1)
        w = w / w.sum(-1, keepdim=True)
        taken = [0] * e
        for tok in range(tg):
            for j in range(k):
                ex = int(idx[tok, j])
                if taken[ex] < cap:
                    h = tmlp.silu(xg[gi, tok] @ p["w_gate"][ex]) \
                        * (xg[gi, tok] @ p["w_up"][ex])
                    out[gi, tok] += w[tok, j] * (h @ p["w_down"][ex])
                taken[ex] += 1
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + tmlp.dense_mlp({"w_gate": p["shared_gate"],
                                    "w_up": p["shared_up"],
                                    "w_down": p["shared_down"]}, x)
    return out


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_moe_mlp_equals_the_drop_rule_row_by_row(regime):
    """The sorted dispatch, the capacity buffer and the un-sorted combine
    compute the drop rule: a dropped row contributes nothing (it lands on
    the buffer's sentinel slot, written by every dropped row and never
    read), a kept row its weighted expert output."""
    t = REGIMES[regime][0]
    tcfg = smoke_variant(get_config(ARCH))
    tp = Model(tcfg).init(torch.Generator().manual_seed(1), device="cpu")
    mp = {k: v[0] for k, v in tp["blocks"]["slot00"]["mlp"].items()}
    x = torch.from_numpy(_skewed(np.random.RandomState(5),
                                 (1, t, tcfg.d_model),
                                 mp["router"].numpy()))
    y, _ = tmlp.moe_mlp(tcfg, mp, x)
    _close(y.numpy(), _loop_moe(tcfg, mp, x).numpy())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_moe_defs_and_stage_accounting_match_reference(qwen):
    jcfg, _, tcfg, _ = qwen
    jm, tm = jax_model(jcfg), Model(tcfg)
    jdefs = _flat(jax.tree.map(lambda d: d, jm.defs,
                               is_leaf=lambda x: hasattr(x, "axes")))
    assert {k: (d.shape, d.init) for k, d in jdefs.items()} == \
        {k: (d.shape, d.init) for k, d in _flat(tm.defs).items()}
    assert tm.bytes() == jm.bytes()
    for i in range(2):
        assert tm.stage_bytes(2, i) == jm.stage_bytes(2, i)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.n_experts, full.top_k,
            full.n_shared_experts, full.expert_d_ff, full.padded_vocab) == \
        (24, 2048, 16, 16, 128, 60, 4, 4, 1408, 152064)
    assert Model(full).bytes() == jax_model(jget(ARCH)).bytes()


# ---------------------------------------------------------------------------
# the model: prefill, decode, and prefill + decode == the full forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_moe_prefill_and_decode_match_reference(qwen, paged):
    """``Model.prefill`` (contiguous: flash; paged: the ragged step, whose
    pad rows route too, so no-drop keeps the function the same) and three
    ``decode_step``s against the reference's contiguous ones."""
    jcfg, jparams, tcfg, tparams = qwen
    jm, tm = jax_model(jcfg), Model(tcfg)
    toks = np.random.RandomState(0).randint(0, tcfg.vocab, (2, 11)).astype(
        np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks), 32, page_size=8,
                        paged=paged)
    _close(tl.numpy(), jl)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok[:, 0])
        pos = np.full((2, 1), 11 + step, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        _close(tl.numpy(), jl)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_moe_prefill_then_decode_equals_the_full_forward(qwen, paged):
    """``tests/test_consistency.py`` on the port: prefill of S tokens, then
    one decode step, gives the full forward's logits at position S."""
    _, _, tcfg, tparams = qwen
    m = Model(tcfg)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, tcfg.vocab, (2, 11)).astype(np.int32))
    pos = torch.arange(11, dtype=torch.int32)[None].expand(2, 11)
    x = transformer.embed(tcfg, tparams, toks, pos, dtype=m.dtype)
    x, _, _ = transformer.run_blocks(tcfg, tparams["blocks"], x, pos)
    full = transformer.head(tcfg, tparams, x)[:, -1]
    _, cache = m.prefill(tparams, toks[:, :10], 16, page_size=8,
                         paged=paged)
    dec, _ = m.decode_step(tparams, cache, toks[:, 10:],
                           torch.full((2, 1), 10, dtype=torch.int32))
    _close(dec.numpy(), full.numpy())


# ---------------------------------------------------------------------------
# engines: every layout and step, 1 and 2 stages, consolidation
# ---------------------------------------------------------------------------

ENGINES = {"paged": dict(paged=True), "fused": dict(paged=True, fused=True),
           "int8": dict(paged=True, kv_dtype="int8"),
           "contiguous": dict(paged=False)}


def _serve(E, SP, ep_cls, cfg, stage_params, full, kw, consolidate_at=3,
           extra=None):
    ep = ep_cls(E(cfg, stage_params, **KW, **kw, **(extra or {})))
    reqs = [ep.submit(p, SP(max_new=6)) for p in PROMPTS]
    if len(stage_params) > 1:
        for _ in range(consolidate_at):
            ep.step()
        ep.consolidate(full)
        assert ep.n_stages == 1
    ep.run()
    return [list(r.generated) for r in reqs], ep


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_moe_engine_streams_equal_reference(qwen, engine, stages):
    """Greedy streams of the port's engine equal the reference engine's on
    the same weights, the 2-stage endpoints consolidated after 3 steps (4
    prompts over 3 slots: the fourth waits for a slot), and so do the
    migrated KV bytes."""
    jcfg, jparams, tcfg, tparams = qwen
    jm, tm = jax_model(jcfg), Model(tcfg)
    kw = ENGINES[engine]
    jsp = [jm.slice_stage_params(jparams, stages, i) for i in range(stages)]
    tsp = [tm.slice_stage_params(tparams, stages, i) for i in range(stages)]
    want, jep = _serve(JEngine, JSP, JEndpoint, jcfg, jsp, jparams, kw)
    got, tep = _serve(Engine, SamplingParams, ServingEndpoint, tcfg, tsp,
                      tparams, kw, extra={"device": "cpu"})
    assert got == want
    assert all(len(s) == 6 for s in got)
    assert tep.last_migration_bytes == jep.last_migration_bytes
    if stages == 2 and kw["paged"]:
        assert tep.last_migration_bytes > 0
    if kw["paged"]:
        bm = tep.engine.block_mgr
        assert bm.free_blocks == bm.n_blocks


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_moe_slots_reused_after_idle_decode_equal_reference(qwen, paged):
    """Two requests decode while a third slot idles, then more requests
    than slots arrive and reuse slots as they free: the streams equal the
    reference's (each decode step routes every slot's row, idle ones
    included, as the reference does)."""
    jcfg, jparams, tcfg, tparams = qwen
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


def test_moe_engine_with_the_published_capacity_equals_reference():
    """At the published capacity factor (1.25) a step's routing can drop
    rows, so a stream depends on each step's composition; both packages
    compose the steps alike, so the streams are still equal (paged, 2
    stages consolidated; contiguous, 1 stage)."""
    jcfg, jparams, tcfg, tparams = _pair(capacity_factor=1.25)
    jm, tm = jax_model(jcfg), Model(tcfg)
    for kw, stages in ((ENGINES["paged"], 2), (ENGINES["contiguous"], 1)):
        jsp = [jm.slice_stage_params(jparams, stages, i)
               for i in range(stages)]
        tsp = [tm.slice_stage_params(tparams, stages, i)
               for i in range(stages)]
        want, _ = _serve(JEngine, JSP, JEndpoint, jcfg, jsp, jparams, kw)
        got, _ = _serve(Engine, SamplingParams, ServingEndpoint, tcfg, tsp,
                        tparams, kw, extra={"device": "cpu"})
        assert got == want
