"""The port's serving engine held against the reference engine on the
CPU, on the same converted weights: greedy token streams must be equal
(exactly) for the paged step, the fused ragged step, fused int8 KV pages,
the prefix cache with chunked prefill, preemption under the priority
policy, and a 2-stage ServingEndpoint consolidated mid-stream, whose
``last_migration_bytes`` must also be equal; and for rwkv6-1.6b (the WKV6
recurrence, slot-indexed recurrent states) on both layouts, consolidated
and with slots reused after idle decode steps. Seeded sampled streams are
held within the port (its sampler cannot reproduce ``jax.random``): the
same across 1 vs 2 stages and across consolidation. The reference's
KV-lifecycle sanitizer attaches to the port's engine as it is and audits
it clean; ``n_attn_layers`` counts as the reference's does; and a
``prefix_embeds`` request refused by the fused step leaves the engine
serving the others."""

import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.analysis.sanitizer import KVSanitizer
from repro.models.model import build_model as jax_model
from repro.serving.api import SamplingParams as JSP
from repro.serving.endpoint import ServingEndpoint as JEndpoint
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import SLO
from repro_torch.models.attention import paged_kv_token_bytes
from repro_torch.models.model import Model
from repro_torch.serving.api import FinishReason, SamplingParams
from repro_torch.serving.endpoint import ServingEndpoint
from repro_torch.serving.engine import Engine

PROMPTS = [
    [1, 2, 3, 4, 5, 6, 7],
    [9, 8, 7, 6, 5],
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
    [11, 12, 13],
]
KW = dict(max_batch=3, max_seq=64, block_size=8, paged=True)


@pytest.fixture(scope="module")
def granite():
    jcfg = smoke("granite-3-8b")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tcfg = smoke_variant(get_config("granite-3-8b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_streams(jcfg, jparams, max_new=6, **kw):
    eng = JEngine(jcfg, [jparams], **KW, **kw)
    reqs = [eng.submit(p, JSP(max_new=max_new)) for p in PROMPTS]
    eng.run()
    return [list(r.generated) for r in reqs]


def _port(tcfg, sp, **kw):
    return Engine(tcfg, sp, **KW, device="cpu", **kw)


def _port_streams(tcfg, tparams, max_new=6, params=SamplingParams, **kw):
    eng = _port(tcfg, [tparams], **kw)
    reqs = [eng.submit(p, params(max_new=max_new)) for p in PROMPTS]
    eng.run()
    return [list(r.generated) for r in reqs], eng


@pytest.fixture(scope="module")
def jax_paged(granite):
    jcfg, jparams, _, _ = granite
    return _jax_streams(jcfg, jparams)


@pytest.mark.parametrize("kw", [
    {},
    {"fused": True},
    {"prefix_cache": True, "prefill_chunk": 4},
    {"fused": True, "prefix_cache": True, "prefill_chunk": 4},
    {"fused": True, "kv_dtype": "float16"},
], ids=["paged", "fused", "prefix-chunked", "fused-prefix-chunked",
        "fused-fp16"])
def test_greedy_streams_equal_reference(granite, jax_paged, kw):
    """The reference holds these engines bit-exact with its paged step
    (tests/test_fused_engine.py), so all compare with one JAX run."""
    _, _, tcfg, tparams = granite
    streams, eng = _port_streams(tcfg, tparams, **kw)
    assert streams == jax_paged
    assert eng.block_mgr.free_blocks == eng.block_mgr.n_blocks


def test_int8_greedy_streams_equal_reference(granite):
    jcfg, jparams, tcfg, tparams = granite
    want = _jax_streams(jcfg, jparams, kv_dtype="int8", prefill_chunk=4)
    got, eng = _port_streams(tcfg, tparams, kv_dtype="int8", prefill_chunk=4)
    assert got == want
    assert eng.fused, "int8 defaults the fused step on"
    assert eng.block_mgr.bytes_per_token == paged_kv_token_bytes(tcfg,
                                                                 "int8")


def test_two_stage_endpoint_consolidated_mid_stream(granite, jax_paged):
    jcfg, jparams, tcfg, tparams = granite
    jm, tm = jax_model(jcfg), Model(tcfg)
    jep = JEndpoint(JEngine(jcfg, [jm.slice_stage_params(jparams, 2, i)
                                   for i in range(2)], **KW,
                            prefill_chunk=4))
    tep = ServingEndpoint(_port(tcfg, [tm.slice_stage_params(tparams, 2, i)
                                       for i in range(2)], prefill_chunk=4))
    jr = [jep.submit(p, JSP(max_new=6)) for p in PROMPTS]
    tr = [tep.submit(p, SamplingParams(max_new=6)) for p in PROMPTS]
    for _ in range(4):
        jep.step()
        tep.step()
    old = tep.engine
    jep.consolidate(jparams)
    tep.consolidate(tparams)
    assert tep.n_stages == 1
    assert tep.last_migration_bytes == jep.last_migration_bytes > 0
    with pytest.raises(RuntimeError, match="retired"):
        old.step()
    jep.run()
    tep.run()
    assert [list(r.generated) for r in tr] == \
        [list(r.generated) for r in jr] == jax_paged


def test_preemption_and_policies_match_reference(granite):
    """Priority-policy preemption (with the prefix cache) and EDF over
    SLO budgets reorder the same way in both packages."""
    from repro.core.types import SLO as JSLO
    jcfg, jparams, tcfg, tparams = granite
    prios = [0, 0, 5, 1]
    slos = [None, (4, 2), (2, 1), (8, 3)]
    for policy in ("priority", "slo"):
        runs = []
        for E, SP, S, cfg, p in ((JEngine, JSP, JSLO, jcfg, jparams),
                                 (Engine, SamplingParams, SLO, tcfg,
                                  tparams)):
            extra = {} if E is JEngine else {"device": "cpu"}
            eng = E(cfg, [p], max_batch=2, max_seq=64, block_size=8,
                    paged=True, prefix_cache=True, policy=policy, **extra)
            reqs = []
            for i, prompt in enumerate(PROMPTS):
                slo = S(*slos[i]) if slos[i] else None
                reqs.append(eng.submit(prompt, SP(max_new=5,
                                                  priority=prios[i],
                                                  slo=slo)))
                eng.step()
            eng.preempt(next(r for r in reqs if not r.done and r.slot
                             is not None))
            eng.run()
            runs.append(([list(r.generated) for r in reqs],
                         [r.metrics.preemptions for r in reqs],
                         eng.scheduler.n_preemptions))
        assert runs[0] == runs[1], policy
        assert runs[1][2] > 0, f"{policy}: nothing was preempted"


def test_sampled_streams_invariant_across_stages_and_consolidation(granite):
    _, _, tcfg, tparams = granite
    m = Model(tcfg)

    def sp(i):
        return SamplingParams(max_new=8, temperature=0.8, top_k=20,
                              seed=100 + i)

    one = _port(tcfg, [tparams])
    ra = [one.submit(p, sp(i)) for i, p in enumerate(PROMPTS)]
    one.run()
    two = ServingEndpoint(_port(tcfg, [m.slice_stage_params(tparams, 2, i)
                                       for i in range(2)]))
    rb = [two.submit(p, sp(i)) for i, p in enumerate(PROMPTS)]
    for _ in range(3):
        two.step()
    two.consolidate(tparams)
    two.run()
    a = [list(r.generated) for r in ra]
    assert a == [list(r.generated) for r in rb]
    greedy, _ = _port_streams(tcfg, tparams, max_new=8)
    assert a != greedy                    # sampling did sample


def test_eos_and_stop_token_finish_reasons(granite):
    """eos and stop tokens are picked where they first occur in the greedy
    stream, so the stop lands exactly there."""
    _, _, tcfg, tparams = granite
    greedy, _ = _port_streams(tcfg, tparams, max_new=10)
    stream = greedy[0]
    firsts = [i for i, t in enumerate(stream) if t not in stream[:i]]
    i_eos, i_stop = firsts[1], firsts[-1]

    def one(params):
        eng = _port(tcfg, [tparams])
        r = eng.submit(PROMPTS[0], params)
        eng.run()
        return r

    eos = one(SamplingParams(max_new=10, eos_token=stream[i_eos]))
    assert eos.generated == stream[:i_eos + 1]
    assert eos.finish_reason is FinishReason.EOS
    stop = one(SamplingParams(max_new=10, stop_tokens=(stream[i_stop],)))
    assert stop.generated == stream[:i_stop + 1]
    assert stop.finish_reason is FinishReason.STOP_TOKEN
    length = one(SamplingParams(max_new=10))
    assert length.finish_reason is FinishReason.LENGTH
    assert length.output().token_ids == tuple(stream)


def test_scale_up_and_knob_validation(granite):
    _, _, tcfg, tparams = granite
    m = Model(tcfg)
    eng = _port(tcfg, [m.slice_stage_params(tparams, 2, i)
                       for i in range(2)])
    r = eng.submit(PROMPTS[0], SamplingParams(max_new=6))
    eng.step()
    eps = ServingEndpoint(eng).scale_up(tparams)
    assert len(eps) == 2 and all(e.n_stages == 1 for e in eps)
    eps[0].run()
    greedy, _ = _port_streams(tcfg, tparams)
    assert list(r.generated) == greedy[0]
    assert not eps[1].has_work()
    with pytest.raises(ValueError, match="fused"):
        _port(tcfg, [tparams], kv_dtype="int8", fused=False)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _port(tcfg, [tparams], prefill_chunk=0)
    with pytest.raises(ValueError, match="max_seq"):
        _port(tcfg, [tparams]).submit([1] * 60, SamplingParams(max_new=8))
    with pytest.raises(ValueError, match="prefix_embeds"):
        _port(tcfg, [tparams], fused=True).submit(
            [1, 2], SamplingParams(max_new=2),
            prefix_embeds=torch.zeros(2, tcfg.d_model))


# ---------------------------------------------------------------------------
# the slot-contiguous layout (paged=False): flash prefill, decode kernel
# ---------------------------------------------------------------------------

CKW = dict(KW, paged=False)


@pytest.fixture(scope="module")
def jax_contiguous(granite):
    jcfg, jparams, _, _ = granite
    eng = JEngine(jcfg, [jparams], **CKW)
    assert not eng.paged
    reqs = [eng.submit(p, JSP(max_new=6)) for p in PROMPTS]
    eng.run()
    return [list(r.generated) for r in reqs]


def test_contiguous_greedy_streams_equal_reference(granite, jax_contiguous,
                                                   jax_paged):
    """Plain serving on the slot-contiguous layout: the port's streams
    equal the reference's contiguous engine's, and the port's own paged
    engine's."""
    _, _, tcfg, tparams = granite
    eng = Engine(tcfg, [tparams], **CKW, device="cpu")
    reqs = [eng.submit(p, SamplingParams(max_new=6)) for p in PROMPTS]
    eng.run()
    assert not eng.paged and "k" in eng.workers[0].cache["slot00"]
    assert [list(r.generated) for r in reqs] == jax_contiguous == jax_paged


def test_contiguous_two_stage_consolidated_mid_stream(granite,
                                                      jax_contiguous):
    jcfg, jparams, tcfg, tparams = granite
    jm, tm = jax_model(jcfg), Model(tcfg)
    jep = JEndpoint(JEngine(jcfg, [jm.slice_stage_params(jparams, 2, i)
                                   for i in range(2)], **CKW))
    tep = ServingEndpoint(Engine(tcfg, [tm.slice_stage_params(tparams, 2, i)
                                        for i in range(2)], **CKW,
                                 device="cpu"))
    jr = [jep.submit(p, JSP(max_new=6)) for p in PROMPTS]
    tr = [tep.submit(p, SamplingParams(max_new=6)) for p in PROMPTS]
    for _ in range(4):
        jep.step()
        tep.step()
    jep.consolidate(jparams)
    tep.consolidate(tparams)
    assert tep.n_stages == 1
    assert tep.last_migration_bytes is None
    assert jep.last_migration_bytes is None
    assert tep.engine.workers[0].cache["slot00"]["k"].shape[0] == \
        tcfg.n_periods
    jep.run()
    tep.run()
    assert [list(r.generated) for r in tr] == \
        [list(r.generated) for r in jr] == jax_contiguous


def test_contiguous_preemption_matches_reference(granite):
    """Priority-policy preemption on the contiguous layout: the victim
    re-prefills its whole chain, and both packages stream, count
    preemptions and finish alike."""
    jcfg, jparams, tcfg, tparams = granite
    prios = [0, 0, 5, 1]
    runs = []
    for E, SP, cfg, p, extra in ((JEngine, JSP, jcfg, jparams, {}),
                                 (Engine, SamplingParams, tcfg, tparams,
                                  {"device": "cpu"})):
        eng = E(cfg, [p], max_batch=2, max_seq=64, block_size=8,
                paged=False, policy="priority", **extra)
        reqs = []
        for i, prompt in enumerate(PROMPTS):
            reqs.append(eng.submit(prompt, SP(max_new=5, priority=prios[i])))
            eng.step()
        eng.preempt(next(r for r in reqs if not r.done and r.slot
                         is not None))
        eng.run()
        runs.append(([list(r.generated) for r in reqs],
                     [r.metrics.preemptions for r in reqs],
                     eng.scheduler.n_preemptions))
    assert runs[0] == runs[1]
    assert runs[1][2] > 0, "nothing was preempted"


def test_contiguous_refuses_paged_only_options(granite):
    _, _, tcfg, tparams = granite
    for kw, msg in (({"prefix_cache": True}, "paged"),
                    ({"prefill_chunk": 4}, "paged"),
                    ({"kv_dtype": "float16"}, "paged"),
                    ({"fused": True}, "paged")):
        with pytest.raises(ValueError, match=msg):
            Engine(tcfg, [tparams], **CKW, device="cpu", **kw)
    assert Engine(tcfg, [tparams], max_seq=32, device="cpu").paged, \
        "the port's paged=None is the paged layout"


# ---------------------------------------------------------------------------
# rwkv6-1.6b: recurrent states through worker, runner, engine, migration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rwkv():
    jcfg = smoke("rwkv6-1.6b")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tcfg = smoke_variant(get_config("rwkv6-1.6b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_rwkv_two_stage_consolidated_equals_reference(rwkv, paged):
    """A 2-stage endpoint consolidated after 3 steps, then run to the end:
    streams equal the reference's, and so do the migrated bytes (the
    reference counts only page-pool bytes: 0 on the paged layout of an
    attention-free model, None on the contiguous one)."""
    jcfg, jparams, tcfg, tparams = rwkv
    jm, tm = jax_model(jcfg), Model(tcfg)
    kw = dict(KW, paged=paged)
    jep = JEndpoint(JEngine(jcfg, [jm.slice_stage_params(jparams, 2, i)
                                   for i in range(2)], **kw))
    tep = ServingEndpoint(Engine(tcfg, [tm.slice_stage_params(tparams, 2, i)
                                        for i in range(2)], **kw,
                                 device="cpu"))
    jr = [jep.submit(p, JSP(max_new=6)) for p in PROMPTS]
    tr = [tep.submit(p, SamplingParams(max_new=6)) for p in PROMPTS]
    for _ in range(3):
        jep.step()
        tep.step()
    jep.consolidate(jparams)
    tep.consolidate(tparams)
    assert tep.n_stages == 1 and tep.paged == paged
    assert tep.last_migration_bytes == jep.last_migration_bytes
    assert tep.last_migration_bytes == (0 if paged else None)
    assert tep.engine.workers[0].cache["slot00"]["wkv"].shape[0] == \
        tcfg.n_periods
    jep.run()
    tep.run()
    got = [list(r.generated) for r in tr]
    assert got == [list(r.generated) for r in jr]
    assert all(len(g) == 6 for g in got)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_rwkv_slots_reused_after_idle_decode_equal_reference(rwkv, paged):
    """Two requests decode while a third slot idles (its states drift under
    the idle rows of every decode step); more requests than slots then
    arrive and reuse slots as they free. Streams equal the reference's,
    whose prefills start from a fresh cache."""
    jcfg, jparams, tcfg, tparams = rwkv
    prompts = PROMPTS + [[7, 7, 2], [5, 4, 3, 2, 1, 9]]
    runs = []
    for E, SP, cfg, p, extra in ((JEngine, JSP, jcfg, jparams, {}),
                                 (Engine, SamplingParams, tcfg, tparams,
                                  {"device": "cpu"})):
        eng = E(cfg, [p], max_batch=3, max_seq=64, block_size=8,
                paged=paged, **extra)
        reqs = [eng.submit(q, SP(max_new=4 + i))
                for i, q in enumerate(prompts[:2])]
        for _ in range(4):
            eng.step()
        reqs += [eng.submit(q, SP(max_new=3 + i % 3))
                 for i, q in enumerate(prompts[2:])]
        eng.run()
        runs.append([list(r.generated) for r in reqs])
    assert runs[0] == runs[1]


def test_rwkv_refuses_attention_only_options(rwkv):
    """The reference's refusals: a recurrent state is neither
    block-shareable (prefix cache, chunked prefill) nor on one token axis
    (the fused ragged step, which int8 pages need)."""
    jcfg, jparams, tcfg, tparams = rwkv
    for kw in ({"prefix_cache": True}, {"prefill_chunk": 4},
               {"fused": True}, {"kv_dtype": "int8"}):
        with pytest.raises(ValueError):
            JEngine(jcfg, [jparams], **KW, **kw)
        with pytest.raises(ValueError,
                           match="attention-only|recurrent|fused"):
            Engine(tcfg, [tparams], **KW, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the reference's engine surface: sanitizer attachment, n_attn_layers, and
# the prefix_embeds refusal
# ---------------------------------------------------------------------------


def test_reference_sanitizer_audits_the_port_engine_clean(granite,
                                                          jax_paged):
    """``KVSanitizer.install`` (the reference's, unchanged) attaches to a
    paged port engine with the prefix cache and chunked prefill; the smoke
    prompts, then a second round whose prompts extend the first's (prefix
    hits: shared and copied-on-write blocks), audit clean through the
    quiescence check, and the first round's streams are the reference's."""
    _, _, tcfg, tparams = granite
    eng = _port(tcfg, [tparams], prefix_cache=True, prefill_chunk=4)
    assert eng.kv_tier is None
    san = KVSanitizer.install(eng)
    assert eng.block_mgr.tracer is san and eng.runner.tracer is san
    reqs = [eng.submit(p, SamplingParams(max_new=6)) for p in PROMPTS]
    assert list(eng.queue) == reqs
    eng.run()
    assert [list(r.generated) for r in reqs] == jax_paged
    again = [eng.submit(p + list(r.generated[:2]), SamplingParams(max_new=3))
             for p, r in zip(PROMPTS, reqs)]
    eng.run()
    assert all(r.done for r in again)
    assert eng.block_mgr.n_cached > 0
    assert san.events > 0
    assert not san.check_idle(), san.report()
    san.raise_if_findings()
    assert san.report().startswith("kv-sanitizer: clean")


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("model", ["granite", "rwkv"])
def test_n_attn_layers_equal_reference(request, model, stages):
    """Attention mixers per period times the periods of every worker (or
    of every worker but the first, ``migrated_only``): the reference's
    count, 0 for the attention-free rwkv."""
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(model)
    jm, tm = jax_model(jcfg), Model(tcfg)
    jsp = ([jparams] if stages == 1 else
           [jm.slice_stage_params(jparams, 2, i) for i in range(2)])
    tsp = ([tparams] if stages == 1 else
           [tm.slice_stage_params(tparams, 2, i) for i in range(2)])
    jeng = JEngine(jcfg, jsp, **KW)
    teng = Engine(tcfg, tsp, **KW, device="cpu")
    for migrated_only in (False, True):
        want = jeng.n_attn_layers(migrated_only=migrated_only)
        assert teng.n_attn_layers(migrated_only=migrated_only) == want
    if model == "rwkv":
        assert teng.n_attn_layers() == 0
    else:
        assert teng.n_attn_layers() == tcfg.n_layers
        assert teng.n_attn_layers(migrated_only=True) == (
            0 if stages == 1 else tcfg.n_layers - tcfg.n_layers // 2)


@pytest.mark.parametrize("kv_dtype", [None, "int8"],
                         ids=["fused", "fused_int8"])
def test_prefix_embeds_refused_without_admitting(granite, kv_dtype):
    """The fused ragged step (over pages of the model's dtype or int8)
    refuses ``prefix_embeds`` at ``submit``, as the reference's does
    (``test_fused_engine.py::test_engine_knob_validation``), mid-stream,
    before anything is admitted: no request id is taken, the queues are as
    they were, and the residents finish with the streams of an engine that
    never saw the refused request. Non-fused engines serve prefixes
    (``tests/test_torch_vlm.py``)."""
    _, _, tcfg, tparams = granite

    def serve(refuse):
        eng = Engine(tcfg, [tparams], **KW, fused=True, kv_dtype=kv_dtype,
                     device="cpu")
        assert eng.fused
        reqs = [eng.submit(p, SamplingParams(max_new=6))
                for p in PROMPTS[:2]]
        eng.step()
        if refuse:
            before = eng.stats()
            with pytest.raises(ValueError, match="prefix_embeds"):
                eng.submit([1, 2], SamplingParams(max_new=2),
                           prefix_embeds=torch.zeros(2, tcfg.d_model))
            with pytest.raises(ValueError, match="prefix_embeds"):
                eng.generate([1, 2], SamplingParams(max_new=2),
                             prefix_embeds=torch.zeros(2, tcfg.d_model))
            assert eng.stats() == before
            assert not eng.queue
        reqs.append(eng.submit(PROMPTS[2], SamplingParams(max_new=6)))
        eng.run()
        assert not eng.has_work()
        return [r.rid for r in reqs], [list(r.generated) for r in reqs]

    assert serve(True) == serve(False)


@pytest.mark.parametrize("kw", [{}, {"fused": True}, {"kv_dtype": "int8"}],
                         ids=["paged", "fused", "int8"])
def test_any_block_size_serves_on_the_cpu_as_the_reference(granite, kw):
    """On the CPU the port's engine takes any ``block_size``, as the
    reference's does (its ragged kernel checks only T): at pages of 12 rows
    (no power of two, so the card's bf16 engines refuse it at
    construction) the greedy streams equal the reference's at the same
    page size, and every block comes back."""
    jcfg, jparams, tcfg, tparams = granite
    knobs = {**KW, "block_size": 12}
    jeng = JEngine(jcfg, [jparams], **knobs, **kw)
    jreqs = [jeng.submit(p, JSP(max_new=6)) for p in PROMPTS]
    jeng.run()
    eng = Engine(tcfg, [tparams], **knobs, device="cpu", **kw)
    reqs = [eng.submit(p, SamplingParams(max_new=6)) for p in PROMPTS]
    eng.run()
    assert eng.block_mgr.block_size == 12
    assert [list(r.generated) for r in reqs] == [list(r.generated)
                                                 for r in jreqs]
    assert eng.block_mgr.free_blocks == eng.block_mgr.n_blocks


@pytest.mark.parametrize("bs", [1, 2, 3, 4, 6, 8, 12, 16, 64])
@pytest.mark.parametrize("group", [1, 4, 8, 9])
def test_page_size_rule(bs, group):
    """``check_page_size``: the ragged kernel's tensor-core body (a bf16 q
    over bf16 or int8 pages, a GQA group of at most ``TC_GROUP``) takes
    pages of a power of two >= 4 rows, and ``check_operands`` applies the
    same rule; float32 and fp16 pages, a float32 q and larger groups take
    any size."""
    from repro_torch.kernels import ragged_attention as ra
    bf, i8 = torch.bfloat16, torch.int8
    ok = bs >= 4 and bs & (bs - 1) == 0
    for q_dtype, page_dtype in ((bf, bf), (bf, i8), (bf, torch.float16),
                                (torch.float32, torch.float32),
                                (torch.float32, i8)):
        refused = (q_dtype == bf and page_dtype in (bf, i8)
                   and group <= ra.TC_GROUP and not ok)
        if refused:
            with pytest.raises(ValueError, match="page size"):
                ra.check_page_size(bs, q_dtype, page_dtype, group)
        else:
            ra.check_page_size(bs, q_dtype, page_dtype, group)
    hkv, hd = 2, 16
    q = torch.zeros(ra.TILE_Q, group * hkv, hd, dtype=bf)
    pages = torch.zeros(3, bs, hkv, hd, dtype=bf)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    idx = torch.zeros(ra.TILE_Q, dtype=torch.int32)
    if ok or group > ra.TC_GROUP:
        ra.check_operands(q, pages, pages, tables, idx, idx)
    else:
        with pytest.raises(ValueError, match="page size"):
            ra.check_operands(q, pages, pages, tables, idx, idx)
