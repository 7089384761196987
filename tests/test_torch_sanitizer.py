"""The port's KV-lifecycle sanitizer (``repro_torch.analysis.sanitizer``)
held against the reference's on the CPU, on the same converted weights
(mirrors ``tests/test_sanitizer.py``).

The randomized session under ``Engine(sanitize=True)`` with a tight KV
tier, over float32, float16 and int8 pages, audits clean, covers spill,
restore and preemption, and passes the quiescence audit; its greedy streams
equal the sanitize-off port run and the reference's session of the same
seed exactly, its tier counters and restore flows equal the reference's,
and every spilled payload's leaves equal the reference's (float32 leaves to
1e-5; float16 pages to one float16 rounding at the leaf's largest |value|,
2^-10 of it, plus 1e-5, since a page an earlier layer rounded the other way
carries into later layers' values at that scale; int8 codes to one code).
Each seeded fault gives the reference's finding kind; consolidation carries
the sanitizer; sanitize mode runs dispatch's contract checks over whole
sessions without changing a stream.
"""

import random

import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.models.model import build_model as jax_model
from repro.router import KVBlockStore as JTier
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.router import KVBlockStore
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.serving.kvcache import KVInvariantError

PROMPTS = [
    [1, 2, 3, 4, 5, 6, 7],
    [9, 8, 7, 6, 5],
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
    [11, 12, 13],
]
F16_STEP = 2.0 ** -10        # one float16 rounding, relative


@pytest.fixture(scope="module")
def granite():
    jcfg = smoke("granite-3-8b")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tcfg = smoke_variant(get_config("granite-3-8b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _pkg(granite, port):
    """(Engine, SamplingParams, KVBlockStore, cfg, params, extra kwargs) of
    the port or of the reference."""
    jcfg, jparams, tcfg, tparams = granite
    if port:
        return Engine, SamplingParams, KVBlockStore, tcfg, tparams, \
            {"device": "cpu"}
    return JEngine, JSP, JTier, jcfg, jparams, {}


def _engine(granite, port, *, sanitize, tier=None, **kw):
    E, _, _, cfg, params, dev = _pkg(granite, port)
    return E(cfg, [params], max_batch=2, max_seq=32, block_size=8,
             paged=True, prefix_cache=True, kv_tier=tier,
             sanitize=sanitize, **dev, **kw)


def _fuzz_session(granite, port, *, sanitize, kv_dtype, seed):
    """``tests/test_sanitizer.py``'s randomized multi-turn session, on
    either package: fresh prompts, continuations and verbatim revisits
    through a 10-block pool and a tight host tier (spills and restores),
    then a forced preemption mid-decode."""
    _, SP, Tier, _, _, _ = _pkg(granite, port)
    tier = Tier(host_capacity_blocks=32)
    eng = _engine(granite, port, sanitize=sanitize, tier=tier,
                  kv_dtype=kv_dtype)
    rng = random.Random(seed)
    convs = []
    streams = []
    for _ in range(16):
        roll = rng.random()
        if convs and roll < 0.30:
            base, reply = rng.choice(convs)
            prompt = (base + reply + [rng.randrange(1, 400)])[:20]
        elif convs and roll < 0.45:
            prompt = list(rng.choice(convs)[0])
        else:
            prompt = [rng.randrange(1, 400)
                      for _ in range(rng.randrange(12, 17))]
        toks = [ev.token for ev in
                eng.generate(prompt, SP(max_new=rng.randrange(2, 6)))]
        convs.append((prompt, toks))
        streams.append(toks)
    for base, _ in convs[:3]:
        streams.append([ev.token for ev in
                        eng.generate(base, SP(max_new=4))])
    a = eng.submit([7] * 12, SP(max_new=6))
    b = eng.submit([9] * 12, SP(max_new=6))
    for _ in range(3):
        eng.step()
    eng.preempt(a)
    eng.run()
    streams += [list(a.generated), list(b.generated)]
    return streams, eng, tier


def _assert_leaf_close(got, want, what):
    got = got.float().numpy() if got.dtype != torch.int8 else got.numpy()
    want = np.asarray(want)
    if want.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, f"{what}: int8 codes apart by {diff.max()}"
    elif str(want.dtype) == "float16":
        want = want.astype(np.float32)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=F16_STEP * np.abs(want).max() + 1e-5,
            err_msg=what)
    else:
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5,
                                   atol=1e-5, err_msg=what)


@pytest.mark.parametrize("kv_dtype", ["float32", "float16", "int8"])
def test_fuzz_clean_and_bit_exact(granite, kv_dtype):
    on, eng, tier = _fuzz_session(granite, True, sanitize=True,
                                  kv_dtype=kv_dtype, seed=1234)
    assert eng.sanitizer is not None
    assert eng.block_mgr.evictions > 0 and tier.spills > 0
    assert tier.restores > 0
    assert eng.scheduler.n_preemptions > 0
    assert eng.sanitizer.events > 0
    eng.sanitizer.check_idle()
    eng.sanitizer.raise_if_findings()

    off, eng_off, tier_off = _fuzz_session(granite, True, sanitize=False,
                                           kv_dtype=kv_dtype, seed=1234)
    assert off == on
    assert eng_off.sanitizer is None
    assert tier_off.stats() == tier.stats()

    ref, _, jtier = _fuzz_session(granite, False, sanitize=True,
                                  kv_dtype=kv_dtype, seed=1234)
    assert on == ref
    assert tier.stats() == jtier.stats()
    assert [f.seconds for f in tier.restore_flows] == pytest.approx(
        [f.seconds for f in jtier.restore_flows], abs=1e-9)
    assert list(tier._host) == list(jtier._host)
    for h, payload in tier._host.items():
        for got, want in zip(payload, jtier._host[h]):
            assert got[0] == want[0]
            _assert_leaf_close(got[1], want[1], f"{got[0]} k")
            _assert_leaf_close(got[2], want[2], f"{got[0]} v")
            assert len(got) == len(want)
            if len(got) > 3:
                assert sorted(got[3]) == sorted(want[3])
                for leaf in got[3]:
                    _assert_leaf_close(got[3][leaf], want[3][leaf], leaf)


def test_sanitize_off_leaves_no_instrumentation(granite):
    tier = KVBlockStore(host_capacity_blocks=4)
    eng = _engine(granite, True, sanitize=False, tier=tier)
    assert eng.sanitizer is None
    assert eng.block_mgr.tracer is None
    assert eng.runner.tracer is None
    assert all(w.tracer is None for w in eng.runner.workers)
    assert tier.tracer is None


def test_env_mode_enables_and_paged_required(granite):
    _, _, tcfg, tparams = granite
    ops.set_sanitize_mode(True)
    try:
        eng = Engine(tcfg, [tparams], max_batch=2, max_seq=32, block_size=8,
                     paged=True, device="cpu")
        assert eng.sanitizer is not None
        legacy = Engine(tcfg, [tparams], max_batch=2, max_seq=32,
                        paged=False, device="cpu")
        assert legacy.sanitizer is None
    finally:
        ops.set_sanitize_mode(False)
    with pytest.raises(ValueError, match="paged"):
        Engine(tcfg, [tparams], paged=False, sanitize=True, device="cpu")


def test_consolidation_carries_sanitizer_clean(granite):
    """§6.2 scale-down mid-flight with a preempted request: the successor
    adopts the sanitizer, the gather is byte-checked against the
    BlockManager's quote, and the streams are the reference's."""
    jcfg, jparams, tcfg, tparams = granite
    ref = JEngine(jcfg, [jparams], max_batch=2, max_seq=32, block_size=8,
                  paged=True, prefix_cache=True)
    want = [ref.submit(p, JSP(max_new=6)) for p in PROMPTS[:2]]
    ref.run()

    m = Model(tcfg)
    sp = [m.slice_stage_params(tparams, 2, i) for i in range(2)]
    eng = Engine(tcfg, sp, max_batch=2, max_seq=32, block_size=8,
                 paged=True, prefix_cache=True, sanitize=True,
                 prefill_chunk=4, device="cpu")
    a = eng.submit(PROMPTS[0], SamplingParams(max_new=6))
    b = eng.submit(PROMPTS[1], SamplingParams(max_new=6))
    for _ in range(3):
        eng.step()
    eng.preempt(a)
    san = eng.sanitizer
    n_checks = san.events
    eng2 = eng.consolidated(tparams)
    assert eng2.sanitizer is san
    assert eng2.block_mgr.tracer is san and eng2.runner.tracer is san
    assert all(w.tracer is san for w in eng2.runner.workers)
    assert san.last_migration is not None and san.events > n_checks
    eng2.run()
    assert [list(a.generated), list(b.generated)] == \
        [list(r.generated) for r in want]
    san.check_idle()
    san.raise_if_findings()


# ---------------------------------------------------------------------------
# seeded faults: each gives the reference's finding kind
# ---------------------------------------------------------------------------


def _silent_evictions(eng):
    """The evict-before-notify bug: an eviction that drops the index entry
    and reuses the block id without firing the evict hook."""
    bm = eng.block_mgr

    def silent_take():
        if bm._free:
            return bm._free.pop()
        blk, _ = bm._cached.popitem(last=False)
        h = bm._hash_of.pop(blk)
        if bm._index.get(h) == blk:
            del bm._index[h]
        bm.evictions += 1
        return blk

    bm._take_block = silent_take
    sp = JSP if isinstance(eng, JEngine) else SamplingParams
    for i in range(8):
        eng.submit([10 * i + j + 1 for j in range(16)], sp(max_new=8))
        eng.run()


def _double_free(eng):
    sp = JSP if isinstance(eng, JEngine) else SamplingParams
    r = eng.submit(PROMPTS[0], sp(max_new=3))
    eng.run()
    eng.block_mgr.free(r.rid)


def _uncommitted_read(eng):
    t = eng.block_mgr.allocate(999, 8, tokens=list(range(100, 108)))
    eng.runner.read_pages(t.blocks[0])


@pytest.mark.parametrize("fault, kind", [
    (_silent_evictions, "evict-before-notify"),
    (_double_free, "double-free"),
    (_uncommitted_read, "uncommitted-read"),
], ids=["evict-before-notify", "double-free", "uncommitted-read"])
def test_seeded_fault_detected_as_reference(granite, fault, kind):
    kinds = []
    for port in (True, False):
        eng = _engine(granite, port, sanitize=True)
        fault(eng)
        kinds.append({f.kind for f in eng.sanitizer.findings})
    assert kind in kinds[0], kinds
    assert kinds[0] == kinds[1]


def test_strict_mode_raises_at_first_finding(granite):
    eng = _engine(granite, True, sanitize=True)
    eng.sanitizer.strict = True
    with pytest.raises(KVInvariantError, match="free-unknown"):
        eng.block_mgr.free(31337)
    assert [f.kind for f in eng.sanitizer.findings] == ["free-unknown"]


def test_sanitized_engine_runs_the_checks_clean(granite):
    """Sanitize mode over a whole fused and a non-fused paged session: every
    ragged and paged decode call of the engine meets its contract, and the
    streams are the unsanitized engine's."""
    _, _, tcfg, tparams = granite
    streams = []
    for on in (False, True):
        for fused in (False, True):
            ops.set_sanitize_mode(on)
            try:
                eng = Engine(tcfg, [tparams], max_batch=3, max_seq=64,
                             block_size=8, paged=True, fused=fused,
                             prefix_cache=True, prefill_chunk=4,
                             device="cpu")
                reqs = [eng.submit(p, SamplingParams(max_new=5))
                        for p in PROMPTS]
                eng.run()
            finally:
                ops.set_sanitize_mode(False)
            assert (eng.sanitizer is not None) == on
            streams.append([list(r.generated) for r in reqs])
            if on:
                eng.sanitizer.check_idle()
                eng.sanitizer.raise_if_findings()
    assert streams[0] == streams[1] == streams[2] == streams[3]
