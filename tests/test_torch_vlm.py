"""The port's image-prefix path (llava-next-34b's smoke variant: 2 layers,
d 64, 4 q / 2 kv heads of 16, 4 image-patch rows) held against the
reference on the CPU, on the same weights (``convert.params_from_numpy``
of the JAX init), with prefixes and prompts drawn from a numpy seed, in
float32.

Tolerances: a prefix prefill's logits, and decode steps after it, agree
with the reference's to 1e-5 of their largest |value| on both layouts
(the same products in another library); greedy token streams are equal
exactly: on both layouts, at 1 and 2 stages, across consolidation, with
prefix and text-only requests in one batch, and beside the prefix cache
and chunked prefill, which a prefix request bypasses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.models.model import build_model as jax_model
from repro.serving.api import SamplingParams as JSP
from repro.serving.endpoint import ServingEndpoint as JEndpoint
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServingEndpoint
from repro_torch.serving.engine import Engine
from repro_torch.serving.kvcache import KVInvariantError
from repro_torch.serving.scheduler import PrefillAssignment

ARCH = "llava-next-34b"
REL = 1e-5
PROMPTS = [
    [1, 2, 3, 4, 5, 6, 7],
    [9, 8, 7, 6, 5],
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
    [11, 12, 13],
]
WITH_PREFIX = (True, False, True, False)    # requests 0 and 2 carry images
KW = dict(max_batch=3, max_seq=64, block_size=8)
MAX_NEW = 6
LAYOUTS = pytest.mark.parametrize("paged", [False, True],
                                  ids=["contiguous", "paged"])


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def llava():
    jcfg = smoke(ARCH)
    tcfg = smoke_variant(get_config(ARCH))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_image_tokens == 4 and tcfg.n_periods == 2
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _prefixes(cfg, n=len(PROMPTS), seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((cfg.n_image_tokens, cfg.d_model))
             * 0.02).astype(np.float32) for _ in range(n)]


def _submit(ep, sp, prefixes, mask=WITH_PREFIX, max_new=MAX_NEW):
    return [ep.submit(p, sp(max_new=max_new),
                      prefix_embeds=pre if use else None)
            for p, pre, use in zip(PROMPTS, prefixes, mask)]


def _jax_streams(jcfg, jparams, prefixes, paged, n_stages=1, **kw):
    m = jax_model(jcfg)
    sp = ([jparams] if n_stages == 1 else
          [m.slice_stage_params(jparams, n_stages, i)
           for i in range(n_stages)])
    ep = JEndpoint(JEngine(jcfg, sp, **KW, paged=paged, **kw))
    reqs = _submit(ep, JSP, prefixes)
    ep.run()
    return [list(r.generated) for r in reqs]


def _port_endpoint(tcfg, tparams, paged, n_stages=1, **kw):
    m = Model(tcfg)
    sp = ([tparams] if n_stages == 1 else
          [m.slice_stage_params(tparams, n_stages, i)
           for i in range(n_stages)])
    return ServingEndpoint(Engine(tcfg, sp, **KW, paged=paged,
                                  device="cpu", **kw))


@LAYOUTS
def test_prefix_prefill_and_decode_match_reference(llava, paged):
    """``Model.prefill(prefix_embeds=...)`` (the reference's
    ``patch_embeds``) then three decode steps at positions P + S + n: the
    logits of each to 1e-5 of the reference's, on either layout."""
    jcfg, jparams, tcfg, tparams = llava
    rng = np.random.RandomState(1)
    b, s, p = 2, 9, tcfg.n_image_tokens
    toks = rng.randint(0, tcfg.vocab, (b, s)).astype(np.int32)
    pre = (rng.standard_normal((b, p, tcfg.d_model)) * 0.02).astype(
        np.float32)
    jm, tm = jax_model(jcfg), Model(tcfg)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                      "patch_embeds": jnp.asarray(pre)},
                            max_seq=32)
    tl, tcache = tm.prefill(tparams, torch.from_numpy(toks), 32,
                            prefix_embeds=torch.from_numpy(pre),
                            page_size=8, paged=paged)
    _close(tl.numpy(), jl)
    assert ("pools" in tcache) == paged
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for n in range(3):
        pos = np.full((b, 1), p + s + n, np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        _close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("n_stages", [1, 2])
@LAYOUTS
def test_mixed_batch_streams_equal_reference(llava, paged, n_stages):
    """Two prefix requests and two text-only ones in one batch (max_batch
    3: the fourth waits for a slot): the port's greedy streams equal the
    reference engine's exactly, at 1 and 2 stages."""
    jcfg, jparams, tcfg, tparams = llava
    prefixes = _prefixes(tcfg)
    want = _jax_streams(jcfg, jparams, prefixes, paged, n_stages)
    ep = _port_endpoint(tcfg, tparams, paged, n_stages)
    reqs = _submit(ep, SamplingParams, prefixes)
    ep.run()
    assert [list(r.generated) for r in reqs] == want
    assert all(len(r.generated) == MAX_NEW for r in reqs)
    assert ep.engine.block_mgr.free_blocks == ep.engine.block_mgr.n_blocks


@LAYOUTS
def test_consolidation_carries_prefix_kv(llava, paged):
    """A 2-stage endpoint consolidated after three steps (the prefix rows'
    K/V migrate with the rest) serves the 1-stage streams, the reference
    endpoint's across its own consolidation, and moves the reference's
    KV bytes on the paged layout."""
    jcfg, jparams, tcfg, tparams = llava
    prefixes = _prefixes(tcfg, seed=2)
    jm = jax_model(jcfg)
    jep = JEndpoint(JEngine(jcfg, [jm.slice_stage_params(jparams, 2, i)
                                   for i in range(2)], **KW, paged=paged))
    jreqs = _submit(jep, JSP, prefixes)
    tep = _port_endpoint(tcfg, tparams, paged, 2)
    treqs = _submit(tep, SamplingParams, prefixes)
    for _ in range(3):
        jep.step()
        tep.step()
    jep.consolidate(jparams)
    tep.consolidate(tparams)
    assert tep.n_stages == 1
    jep.run()
    tep.run()
    got = [list(r.generated) for r in treqs]
    assert got == [list(r.generated) for r in jreqs]
    assert got == _jax_streams(jcfg, jparams, prefixes, paged)
    assert tep.last_migration_bytes == jep.last_migration_bytes
    if paged:
        assert tep.last_migration_bytes > 0


def test_prefix_bypasses_prefix_cache_and_chunking(llava):
    """With the prefix cache and 4-token prefill chunks, a prefix request
    prefills whole in one forward (P + S rows) and never enters the
    prefix index: served twice, it hits nothing the second time, while a
    text-only prompt served twice does hit. Streams equal the reference
    engine's under the same options."""
    jcfg, jparams, tcfg, tparams = llava
    pre = _prefixes(tcfg, n=1, seed=3)[0]
    opts = dict(paged=True, prefix_cache=True, prefill_chunk=4)
    text = list(range(1, 18))                   # two full blocks of 8
    order = [(PROMPTS[2], pre), (PROMPTS[2], pre), (text, None),
             (text, None)]

    def serve(eng, sp):
        out = []
        for prompt, prefix in order:
            r = eng.submit(prompt, sp(max_new=MAX_NEW), prefix_embeds=prefix)
            steps = []
            while eng.has_work():
                steps.append(eng.step().prefill_tokens)
            out.append((r, steps))
        return out

    jout = serve(JEngine(jcfg, [jparams], **dict(KW, **opts)), JSP)
    tout = serve(Engine(tcfg, [tparams], **KW, **opts, device="cpu"),
                 SamplingParams)
    assert [list(r.generated) for r, _ in tout] == \
        [list(r.generated) for r, _ in jout]
    total = tcfg.n_image_tokens + len(PROMPTS[2])
    for r, steps in tout[:2]:
        assert steps[0] == total > 4            # whole, past the chunk
        assert r.metrics.cached_tokens == 0
    assert tout[3][0].metrics.cached_tokens == 16
    assert [r.metrics.cached_tokens for r, _ in tout] == \
        [r.metrics.cached_tokens for r, _ in jout]


def test_vlm_prefix_serving(llava):
    """``test_engine.py::test_vlm_prefix_serving`` on the port: one prefix
    request through an endpoint of ``max_batch`` 2, ``max_seq`` 64, on
    the same prefix; the stream equals the reference's (whose engine
    defaults to the slot-contiguous layout: the port is asked for it)."""
    jcfg, jparams, tcfg, tparams = llava
    prefix = np.random.default_rng(0).standard_normal(
        (tcfg.n_image_tokens, tcfg.d_model)).astype(np.float32) * 0.02
    jep = JEndpoint(JEngine(jcfg, [jparams], max_batch=2, max_seq=64))
    jr = jep.submit([3, 5, 7], JSP(max_new=5), prefix_embeds=prefix)
    jep.run()
    ep = ServingEndpoint(Engine(tcfg, [tparams], max_batch=2, max_seq=64,
                                paged=False, device="cpu"))
    r = ep.submit([3, 5, 7], SamplingParams(max_new=5), prefix_embeds=prefix)
    ep.run()
    assert r.done and len(r.generated) == 5
    assert list(r.generated) == list(jr.generated)
    assert r.metrics.n_tokens == 5


def test_prefix_request_not_preemptible_and_whole(llava):
    """A prefix request is never preempted (its rows are not re-prefillable
    from a token chain), and an assignment that would prefill it in part
    raises ``KVInvariantError``, as in the reference."""
    _, _, tcfg, tparams = llava
    eng = Engine(tcfg, [tparams], **KW, paged=True, device="cpu")
    pre = _prefixes(tcfg, n=1, seed=4)[0]
    r = eng.submit(PROMPTS[0], SamplingParams(max_new=4), prefix_embeds=pre)
    eng.step()
    with pytest.raises(ValueError, match="prefix-embed"):
        eng.scheduler.force_preempt(r)
    r2 = eng.submit(PROMPTS[1], SamplingParams(max_new=4), prefix_embeds=pre)
    eng.scheduler.waiting.remove(r2)
    r2.slot = 1
    with pytest.raises(KVInvariantError, match="whole prompt"):
        eng._exec_prefill(PrefillAssignment(r2, 0, 3), [])
    eng.run()
    assert r.done and len(r.generated) == 4


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf", "int8"])
def test_fused_engine_serves_text_and_refuses_prefix(llava, kv_dtype):
    """llava's text-only requests on the fused ragged step (float32 and
    int8 pages) equal the reference's fused engine's streams; a prefix
    request is refused at ``submit`` before admission."""
    jcfg, jparams, tcfg, tparams = llava
    opts = dict(paged=True, fused=True, kv_dtype=kv_dtype)
    jeng = JEngine(jcfg, [jparams], **KW, **opts)
    teng = Engine(tcfg, [tparams], **KW, **opts, device="cpu")
    pre = _prefixes(tcfg, n=1)[0]
    for eng, sp in ((jeng, JSP), (teng, SamplingParams)):
        with pytest.raises(ValueError, match="prefix_embeds"):
            eng.submit([1, 2], sp(max_new=2), prefix_embeds=pre)
        assert not eng.queue and not eng.has_work()
    want, got = [], []
    for eng, sp, out in ((jeng, JSP, want), (teng, SamplingParams, got)):
        reqs = [eng.submit(p, sp(max_new=MAX_NEW)) for p in PROMPTS]
        eng.run()
        out.extend(list(r.generated) for r in reqs)
    assert got == want
