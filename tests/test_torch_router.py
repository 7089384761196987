"""The port's KV tiers and routing (``repro_torch.router``,
``repro_torch.store.kvsegment``) held against the reference's on the CPU,
on the same converted weights (mirrors ``tests/test_router.py`` and
``tests/test_fused_engine.py::test_int8_spill_restore_bytes_exact``).

* Eviction notifications fire before a block id is reused, so the spill
  hook reads the bytes the evicted hash names.
* ``ResidencyIndex`` mirrors each engine's prefix index under churn and
  across consolidation; the warm and restorable blocks it reports to the
  router are the reference's.
* Spilled blocks round-trip through the host and segment tiers bit for bit
  (bfloat16 too), into the same engine or another replica, with greedy
  streams equal to the reference's; on the same workload each restore is a
  flow whose seconds equal the reference's to 1e-9, and the tier counters
  are the reference's. (Each spilled payload's leaves are held against the
  reference's in ``tests/test_torch_sanitizer.py``.)
* The policies and the router decide as the reference's do on the same
  ``ReplicaView``s and the same prompt sequence; ``stats()`` have the
  reference's keys.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import build_model as jax_model
from repro.router import (KVAffinityPolicy as JAffinity,
                          KVBlockStore as JTier,
                          LeastLoadedPolicy as JLeastLoaded,
                          ReplicaView as JView,
                          ResidencyIndex as JResidency,
                          RoundRobinPolicy as JRoundRobin,
                          Router as JRouter)
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Engine as JEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models.attention import paged_kv_token_bytes
from repro_torch.models.model import Model
from repro_torch.router import (KVAffinityPolicy, KVBlockStore,
                                LeastLoadedPolicy, ReplicaView,
                                ResidencyIndex, RoundRobinPolicy, Router,
                                make_routing_policy)
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.serving.kvcache import BlockManager
from repro_torch.store import KVSegmentStore

VOCAB = 128
PREFIX = list(range(1, 17))                      # 2 blocks at block_size=8
TINY = dict(name="router-tiny", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=4, d_ff=64, vocab=VOCAB, dtype="float32",
            max_pp=2)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(**TINY)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, ModelConfig(**TINY), tparams


@pytest.fixture(scope="module")
def ref_stream(tiny):
    """The reference's greedy stream of PREFIX (6 tokens) on a fresh
    engine: every restore below must reproduce it."""
    ref = _Pkg(tiny, False)
    return list(ref.serve(ref.engine(), PREFIX, 6).generated)


class _Pkg:
    """One package's engine, tier, residency index and sampling params."""

    def __init__(self, tiny, port):
        jcfg, jparams, tcfg, tparams = tiny
        self.port = port
        self.cfg, self.params = (tcfg, tparams) if port else (jcfg, jparams)
        self.Tier = KVBlockStore if port else JTier
        self.Residency = ResidencyIndex if port else JResidency
        self.SP = SamplingParams if port else JSP

    def engine(self, stage_params=None, **kw):
        kw.setdefault("max_batch", 2)
        kw.setdefault("max_seq", 64)
        kw.setdefault("block_size", 8)
        kw.setdefault("paged", True)
        kw.setdefault("prefix_cache", True)
        if self.port:
            kw["device"] = "cpu"
        E = Engine if self.port else JEngine
        return E(self.cfg, stage_params or [self.params], **kw)

    def stage_params(self, n):
        m = Model(self.cfg) if self.port else jax_model(self.cfg)
        return [m.slice_stage_params(self.params, n, i) for i in range(n)]

    def churn(self, eng, seed, n=1):
        """Distinct throwaway prompts that push the LRU cache out."""
        for i in range(n):
            eng.submit([(seed + 13 * i + j) % VOCAB for j in range(24)],
                       self.SP(max_new=2))
            eng.run()

    def serve(self, eng, prompt, max_new):
        r = eng.submit(prompt, self.SP(max_new=max_new))
        eng.run()
        return r


def _both(tiny):
    return _Pkg(tiny, True), _Pkg(tiny, False)


def _spill_prefix(pkg, eng, res, name, seed):
    """Churn ``eng`` until PREFIX has no warm block left."""
    i = 0
    while res.match(name, PREFIX)[0] > 0:
        pkg.churn(eng, seed=seed + 29 * i)
        i += 1
        assert i < 60
    return i


# ---------------------------------------------------------------------------
# BlockManager notifications
# ---------------------------------------------------------------------------

def test_evict_hook_fires_before_block_reuse():
    bm = BlockManager(n_blocks=4, block_size=4, bytes_per_token=2,
                      prefix_cache=True)
    events = []

    def on_evict(blk, h):
        events.append(("evict", blk, h))
        assert h not in bm._index
        assert bm._ref[blk] == 0

    bm.evict_hooks.append(on_evict)
    bm.commit_hooks.append(lambda blk, h: events.append(("commit", blk, h)))
    t1 = bm.allocate(1, 16, list(range(16)))
    for i in range(4):
        bm.commit(1, (i + 1) * 4)
    bm.free(1)
    assert [e[0] for e in events] == ["commit"] * 4
    committed = {e[1]: e[2] for e in events}
    t2 = bm.allocate(2, 16, list(range(100, 116)))
    evicts = [e for e in events if e[0] == "evict"]
    assert {e[1] for e in evicts} == set(committed)
    assert {e[2] for e in evicts} == set(committed.values())
    assert set(t2.blocks) <= {e[1] for e in evicts}
    assert t1 is not None and t2 is not None


def test_spill_hook_reads_pre_reuse_content(tiny):
    """The spilled payload is the page content at commit time, held on the
    host tier as CPU tensors, even though the block is reused by the very
    allocation that evicted it."""
    port, _ = _both(tiny)
    tier = KVBlockStore()
    eng = port.engine(kv_tier=tier)
    port.serve(eng, PREFIX, 2)
    bm = eng.block_mgr
    want = {h: eng.runner.read_pages(bm._index[h])
            for h in bm.indexed_hashes()}
    port.churn(eng, seed=50, n=12)
    for h, ref_payload in want.items():
        assert tier.has(h), "committed block vanished without spilling"
        for (n1, k1, v1), (n2, k2, v2) in zip(tier._host[h], ref_payload):
            assert n1 == n2
            assert k1.device.type == "cpu" and v1.device.type == "cpu"
            assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_drop_unreferenced_cache_spills(tiny):
    port, _ = _both(tiny)
    tier = KVBlockStore()
    eng = port.engine(kv_tier=tier)
    port.serve(eng, PREFIX, 2)
    n_cached = eng.block_mgr.n_cached
    assert n_cached >= 2
    eng.block_mgr.drop_unreferenced_cache()
    assert tier.host_blocks == n_cached


# ---------------------------------------------------------------------------
# Residency index
# ---------------------------------------------------------------------------

def test_residency_exact_under_churn(tiny):
    port, _ = _both(tiny)
    tier = KVBlockStore()
    eng = port.engine(kv_tier=tier)
    res = ResidencyIndex(kv_tier=tier)
    res.attach("r0", eng.block_mgr)
    rng = np.random.default_rng(3)
    for i in range(10):
        n = int(rng.integers(4, 30))
        port.serve(eng, [int(x) for x in rng.integers(0, VOCAB, n)], 2)
        assert res.resident_hashes("r0") == \
            set(eng.block_mgr.indexed_hashes()), f"diverged at round {i}"


def test_residency_match_counts_warm_and_restorable(tiny):
    port, _ = _both(tiny)
    tier = KVBlockStore()
    eng = port.engine(kv_tier=tier)
    res = ResidencyIndex(kv_tier=tier)
    res.attach("r0", eng.block_mgr)
    port.serve(eng, PREFIX, 2)
    assert res.match("r0", PREFIX) == (2, 0)
    _spill_prefix(port, eng, res, "r0", 200)
    assert res.match("r0", PREFIX) == (0, 2)
    res.detach("r0")
    port.churn(eng, seed=900)
    res2 = ResidencyIndex(kv_tier=tier)
    res2.attach("r0", eng.block_mgr)
    assert res2.resident_hashes("r0") == set(eng.block_mgr.indexed_hashes())


def test_residency_survives_consolidation(tiny, ref_stream):
    """§6.2 swaps the engine but carries the BlockManager; the successor's
    evictions spill through its own runner, and the restored stream is the
    reference's."""
    port, _ = _both(tiny)
    tier = KVBlockStore()
    eng = port.engine(port.stage_params(2), kv_tier=tier)
    res = ResidencyIndex(kv_tier=tier)
    res.attach("r0", eng.block_mgr)
    assert list(port.serve(eng, PREFIX, 4).generated) == ref_stream[:4]
    eng2 = eng.consolidated(port.params)
    assert res.resident_hashes("r0") == set(eng2.block_mgr.indexed_hashes())
    port.churn(eng2, seed=400, n=12)
    assert res.resident_hashes("r0") == set(eng2.block_mgr.indexed_hashes())
    r2 = port.serve(eng2, PREFIX, 4)
    assert list(r2.generated) == ref_stream[:4]
    assert r2.metrics.restored_tokens > 0


# ---------------------------------------------------------------------------
# Spill / restore
# ---------------------------------------------------------------------------

def test_spill_restore_bit_exact_same_engine(tiny, ref_stream):
    port, _ = _both(tiny)
    tier = KVBlockStore()
    eng = port.engine(kv_tier=tier)
    res = ResidencyIndex(kv_tier=tier)
    res.attach("r0", eng.block_mgr)
    assert list(port.serve(eng, PREFIX, 6).generated) == ref_stream
    _spill_prefix(port, eng, res, "r0", 600)
    r2 = port.serve(eng, PREFIX, 6)
    assert list(r2.generated) == ref_stream
    assert r2.metrics.restored_tokens > 0
    assert r2.metrics.restore_seconds > 0.0
    assert tier.restores > 0 and tier.restored_bytes > 0


def test_spill_restore_bit_exact_cross_replica(tiny, ref_stream):
    """Content-addressed payloads restore into another replica's pool
    (a fresh engine on the same weights, a shared tier)."""
    port, _ = _both(tiny)
    tier = KVBlockStore()
    eng = port.engine(kv_tier=tier)
    res = ResidencyIndex(kv_tier=tier)
    res.attach("a", eng.block_mgr)
    assert list(port.serve(eng, PREFIX, 6).generated) == ref_stream
    _spill_prefix(port, eng, res, "a", 700)
    r2 = port.serve(port.engine(kv_tier=tier), PREFIX, 6)
    assert list(r2.generated) == ref_stream
    assert r2.metrics.restored_tokens > 0


def test_host_capacity_demotes_to_segment_tier(tiny, ref_stream):
    """A bounded host tier pushes its LRU overflow into the serialized
    segment store; a segment restore is bit-exact and charged at the
    segment tier's slower bandwidth."""
    port, _ = _both(tiny)
    tier = KVBlockStore(host_capacity_blocks=1)
    eng = port.engine(kv_tier=tier)
    res = ResidencyIndex(kv_tier=tier)
    res.attach("r0", eng.block_mgr)
    port.serve(eng, PREFIX, 2)
    _spill_prefix(port, eng, res, "r0", 800)
    assert tier.demotions > 0 and tier.host_blocks <= 1
    seg = [h for h in res.chain_hashes("r0", PREFIX)
           if tier.tier_of(h) == "segment"]
    assert seg
    assert tier.restore_rate(seg[0]) <= tier.segments.bandwidth < tier.host_bw
    assert list(port.serve(eng, PREFIX, 6).generated) == ref_stream
    assert min(f.cap for f in tier.restore_flows) == tier.segments.bandwidth


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "int8"])
def test_segment_round_trip_bit_exact(dtype):
    """A payload demoted to the segment store comes back bit for bit, as
    CPU tensors of its dtype (bfloat16 has no numpy dtype: raw words), with
    int8 pools' scale/zero leaves."""
    g = torch.Generator().manual_seed(0)
    shape = (3, 8, 2, 16)
    dt = getattr(torch, dtype)
    if dt == torch.int8:
        k, v = (torch.randint(-128, 128, shape, generator=g,
                              dtype=torch.int8) for _ in range(2))
        aux = {l: torch.randn(shape[:-1], generator=g)
               for l in ("k_scale", "k_zero", "v_scale", "v_zero")}
        payload = [("slot00", k, v, aux)]
    else:
        k, v = (torch.randn(shape, generator=g).to(dt) for _ in range(2))
        payload = [("slot00", k, v), ("slot01", v.clone(), k.clone())]
    seg = KVSegmentStore()
    seg.put(b"h", payload)
    nbytes = sum(e[1].nbytes + e[2].nbytes
                 + sum(a.nbytes for a in (e[3].values() if len(e) > 3
                                          else ())) for e in payload)
    assert seg.bytes_of(b"h") == seg.total_bytes == nbytes
    back = seg.pop(b"h")
    assert not seg.has(b"h") and len(seg) == 0
    for got, want in zip(back, payload):
        assert got[0] == want[0] and len(got) == len(want)
        for a, b in zip(got[1:3], want[1:3]):
            assert a.dtype == b.dtype and a.device.type == "cpu"
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        if len(want) > 3:
            for leaf, b in want[3].items():
                assert torch.equal(got[3][leaf], b)


def test_restore_accounted_as_measured_flow(tiny):
    """Each restore is a flow on the shared schedule whose measured seconds
    match the quote under no contention, and whose bytes are the tier's."""
    port, _ = _both(tiny)
    tier = KVBlockStore()
    eng = port.engine(kv_tier=tier)
    res = ResidencyIndex(kv_tier=tier)
    res.attach("r0", eng.block_mgr)
    port.serve(eng, PREFIX, 2)
    _spill_prefix(port, eng, res, "r0", 340)
    quote = tier.restore_estimate(res.chain_hashes("r0", PREFIX), now=0.0)
    assert 0.0 < quote < float("inf")
    port.serve(eng, PREFIX, 1)
    assert sum(f.seconds for f in tier.restore_flows) == \
        pytest.approx(quote, rel=0.05)
    assert sum(f.size for f in tier.restore_flows) == tier.restored_bytes


def test_int8_spill_restore_bytes_exact(tiny):
    """Every spilled and restored int8 block (int8 pages plus the f32
    scale/zero leaves) measures block_size * paged_kv_token_bytes(int8) *
    n_attn_layers, through the segment tier too, and the restored stream is
    the warm one."""
    port, _ = _both(tiny)
    tier = KVBlockStore(host_capacity_blocks=2)
    eng = port.engine(kv_tier=tier, kv_dtype="int8")
    r0 = port.serve(eng, PREFIX, 2)
    port.churn(eng, seed=50, n=12)
    per_block = (eng.block_mgr.block_size
                 * paged_kv_token_bytes(port.cfg, "int8")
                 * eng.n_attn_layers())
    assert tier.spills > 0 and tier.demotions > 0
    assert tier.spilled_bytes == tier.spills * per_block
    for h in list(tier._host):
        assert tier.bytes_of(h) == per_block
    r1 = port.serve(eng, PREFIX, 2)
    assert tier.restores > 0
    assert tier.restored_bytes == tier.restores * per_block
    assert r1.generated == r0.generated


# ---------------------------------------------------------------------------
# Routing policies and the router
# ---------------------------------------------------------------------------

def _views(View, spec):
    return [View(name, warm, restorable, 8,
                 {"waiting": waiting, "preempted": 0, "running": running},
                 pending=pending)
            for name, warm, restorable, waiting, running, pending in spec]


# (policy, its kwargs, replica specs (name, warm, restorable, waiting,
# running, pending), the expected choices over four calls)
POLICY_CASES = [
    ("kv_affinity", {}, [("a", 4, 0, 0, 0, False), ("b", 0, 0, 0, 0, False)],
     ["a"] * 4),
    ("round_robin", {}, [("a", 4, 0, 0, 0, False), ("b", 0, 0, 0, 0, False)],
     ["a", "b", "a", "b"]),
    ("kv_affinity", {"restore_frac": 0.5},
     [("w", 2, 0, 0, 0, False), ("r", 0, 3, 0, 0, False)], ["w"] * 4),
    ("kv_affinity", {"restore_frac": 0.5},
     [("r", 0, 3, 0, 0, False), ("z", 0, 0, 0, 0, False)], ["r"] * 4),
    ("kv_affinity", {"saturation_queue": 4},
     [("hot", 8, 0, 4, 0, False), ("idle", 0, 0, 0, 0, False)],
     ["idle"] * 4),
    ("kv_affinity", {"saturation_queue": 4},
     [("hot", 8, 0, 3, 0, False), ("idle", 0, 0, 0, 0, False)],
     ["hot"] * 4),
    ("kv_affinity", {"saturation_queue": 4},
     [("hot", 8, 0, 4, 0, False), ("busy", 0, 0, 5, 2, False)],
     ["hot"] * 4),
    ("kv_affinity", {}, [("pend", 8, 0, 0, 0, True),
                         ("idle", 0, 0, 0, 0, False)], ["idle"] * 4),
    ("least_loaded", {}, [("a", 0, 0, 2, 0, False), ("b", 0, 0, 0, 1, False)],
     ["b"] * 4),
    ("round_robin", {}, [("p", 0, 0, 0, 0, True), ("q", 0, 0, 0, 0, False),
                         ("r", 0, 0, 0, 0, False)], ["q", "r", "q", "r"]),
]


@pytest.mark.parametrize("policy, kw, spec, want", POLICY_CASES)
def test_policy_choices_equal_reference(policy, kw, spec, want):
    from repro.router import make_routing_policy as jmake
    port, ref = make_routing_policy(policy, **kw), jmake(policy, **kw)
    got = [port.choose(_views(ReplicaView, spec)).name for _ in range(4)]
    assert got == want
    assert [ref.choose(_views(JView, spec)).name for _ in range(4)] == got
    if policy == "kv_affinity":
        assert [port.score(v) for v in _views(ReplicaView, spec)] == \
            [ref.score(v) for v in _views(JView, spec)]


def test_policy_factory():
    assert isinstance(make_routing_policy("kv_affinity"), KVAffinityPolicy)
    assert isinstance(make_routing_policy("round_robin"), RoundRobinPolicy)
    assert isinstance(make_routing_policy("least_loaded"), LeastLoadedPolicy)
    custom = KVAffinityPolicy(saturation_queue=9)
    assert make_routing_policy(custom) is custom
    with pytest.raises(ValueError, match="unknown routing policy"):
        make_routing_policy("warmest_first")
    assert {JAffinity.name, JRoundRobin.name, JLeastLoaded.name} == \
        {KVAffinityPolicy.name, RoundRobinPolicy.name, LeastLoadedPolicy.name}


class _Ep:                                       # endpoint shim
    def __init__(self, eng):
        self.engine = eng

    def stats(self):
        return self.engine.stats()


def test_router_decisions_and_flows_equal_reference(tiny):
    """Two replicas behind one tier. PREFIX is served on ``a``, routed
    there warm, churned out of ``a``'s pool to the tier, then routed again
    (restorable on both replicas) and once more (warm where it landed): the
    decisions, the streams, the restore quote and every restore flow's
    seconds (to 1e-9), bytes and cap, and the tier counters are the
    reference's."""
    out = []
    for pkg in _both(tiny):
        tier = pkg.Tier(host_capacity_blocks=4)
        router = (Router if pkg.port else JRouter)("kv_affinity",
                                                  kv_tier=tier)
        engines = {n: pkg.engine(kv_tier=tier) for n in ("a", "b")}
        for n, e in engines.items():
            router.register(n, _Ep(e))
        streams = [list(pkg.serve(engines["a"], PREFIX, 3).generated)]

        def routed(prompt):
            d = router.route(prompt)
            streams.append(list(pkg.serve(engines[d.name], prompt,
                                          3).generated))
            return d

        assert routed(PREFIX).warm_blocks == 2
        pkg.churn(engines["a"], seed=500, n=12)
        quote = tier.restore_estimate(
            router.residency.chain_hashes("a", PREFIX), now=0.0)
        d = routed(PREFIX)
        assert (d.warm_blocks, d.restorable_blocks) == (0, 2)
        assert routed(PREFIX).warm_blocks == 2
        routed([99, 98, 97, 96, 95, 94, 93, 92])
        decisions = [(d.name, d.policy, d.warm_blocks, d.restorable_blocks,
                      d.score, d.overflowed) for d in router.decisions]
        s = router.stats()
        assert s["policy"] == "kv_affinity" and s["decisions"] == 4
        assert s["replicas"] == ["a", "b"]
        router.unregister("b")
        assert router.replicas() == ["a"]
        flows = [(f.seconds, f.size, f.cap) for f in tier.restore_flows]
        assert sum(f[0] for f in flows) == pytest.approx(quote, rel=0.05)
        out.append((decisions, streams, s, tier.stats(), quote, flows))
    assert out[0][:4] == out[1][:4]
    assert out[0][4] == pytest.approx(out[1][4], abs=1e-9)
    assert [f[1:] for f in out[0][5]] == [f[1:] for f in out[1][5]]
    assert [f[0] for f in out[0][5]] == \
        pytest.approx([f[0] for f in out[1][5]], abs=1e-9)


def test_stats_keys_equal_reference(tiny):
    port, ref = _both(tiny)
    engs = [p.engine(kv_tier=p.Tier()) for p in (port, ref)]
    assert set(engs[0].stats()) == set(engs[1].stats())
    assert set(engs[0].kv_tier.stats()) == set(engs[1].kv_tier.stats())
    routers = [Router(), JRouter()]
    for r, e in zip(routers, engs):
        r.register("a", _Ep(e))
    assert set(routers[0].stats()) == set(routers[1].stats())


def test_engine_stats_shape(tiny):
    port, _ = _both(tiny)
    eng = port.engine()
    r = eng.submit(PREFIX, SamplingParams(max_new=3))
    s0 = eng.stats()
    assert s0["waiting"] == 1 and s0["running"] == 0
    eng.run()
    s1 = eng.stats()
    assert s1["waiting"] == 0 and s1["running"] == 0
    assert s1["steps"] > 0 and s1["free_slots"] == 2
    assert s1["total_blocks"] >= s1["free_blocks"] > 0
    assert r.done
