"""The port's fleet control plane held against the reference's on the CPU
(mirrors ``tests/test_fleet.py`` and the tier-placement cases of
``tests/test_store.py``).

* Policy units: the port's ``FleetController`` and ``CentralController``
  give the reference's decisions on the same arrival sequences, and each
  reference test's property holds on the port's decisions.
* Real-engine twins: the reference's ``FleetFrontend`` and the port's
  (``device="cpu"``) drive the same trace on the same weights (the JAX
  init, converted with ``params_from_numpy``, or one on-disk store read by
  both). Generated tokens are equal exactly; request waits and TTFTs, the
  cold-start and placement logs and the fleet's metrics are equal, floats
  to 1e-9.
* The slice as a whole: the trace of ``chip_smoke.py``'s ``FLEET`` phase at
  the smoke widths (a routed granite, a slot-contiguous rwkv6), on both
  sides, with the phase's checks.
* Store placement: ``AliasTier`` reads, retuning and drop rules.

Unrouted models pass ``paged`` explicitly: the port's ``paged=None`` is the
paged layout, the reference's the slot-contiguous one."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs.base import ModelConfig as JConfig
from repro.core import types as jtypes
from repro.core.controller import CentralController as JCentral
from repro.fleet import FleetFrontend as JFleet
from repro.fleet.controller import FleetController as JFleetCtl
from repro.fleet.controller import FleetPolicy as JPolicy
from repro.models import build_model as jax_model
from repro.serving.api import SamplingParams as JSP
from repro.store.store import ModelStore as JStore
from repro.store.store import PEER_BW as JPEER
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import types as ttypes
from repro_torch.core.controller import CentralController
from repro_torch.fleet import FleetController, FleetFrontend, FleetPolicy
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.store import AliasTier, FetchSchedule, StreamedStageLoader
from repro_torch.store.store import ModelStore, PEER_BW

TOL = 1e-9
TIMINGS = dict(t_cc=0.2, t_l=0.2, t_cu=0.1)

REF = types.SimpleNamespace(
    name="ref", T=jtypes, Central=JCentral, FleetCtl=JFleetCtl,
    Policy=JPolicy, Fleet=JFleet, SP=JSP, PEER=JPEER, fleet_kw={})
PORT = types.SimpleNamespace(
    name="port", T=ttypes, Central=CentralController,
    FleetCtl=FleetController, Policy=FleetPolicy, Fleet=FleetFrontend,
    SP=SamplingParams, PEER=PEER_BW, fleet_kw={"device": "cpu"})


def _both(fn):
    return fn(REF), fn(PORT)


def assert_close(got, want, path="$"):
    """Equal, floats to ``TOL``; containers compared member by member."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= TOL, f"{path}: {got} != {want}"
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            f"{path}: keys {sorted(got)} != {sorted(want)}"
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            f"{path}: {got} != {want}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    else:
        assert got == want, f"{path}: {got} != {want}"


# ---------------------------------------------------------------------------
# policy decisions (tests/test_fleet.py: policy units, Alg. 1 distribution)
# ---------------------------------------------------------------------------


def _servers(S, n=2, nic=None, hbm=None):
    T = S.T
    nic = 16 * T.Gbps if nic is None else nic
    hbm = 24 * T.GB if hbm is None else hbm
    return {f"s{i}": T.ServerSpec(f"s{i}", nic, 12e9, hbm, 1)
            for i in range(n)}


def _profile(S, name="m", size=None, max_pp=4):
    T = S.T
    return T.ModelProfile(name, 4 * T.GB if size is None else size,
                          T.TimingProfile(**TIMINGS), T.SLO(10.0, 0.5),
                          max_pp=max_pp, kv_bytes_per_token=1024)


def _burst(fc, model, at, n=3, gap=0.5):
    for k in range(n):
        fc.record_arrival(model, at + k * gap)


def _fc(S, policy, n=2, **kw):
    return S.FleetCtl(S.Central(_servers(S, n), **kw), policy)


def _episode_period(S):
    fc = _fc(S, S.Policy.proactive())
    for t0 in (0.0, 100.0, 200.0):
        _burst(fc, "m", t0)
    return (fc.predicted_next_episode("m", 210.0),
            fc.predicted_next_episode("m", 310.0),
            fc.predicted_next_episode("none", 10.0))


def _keepalive_delayed(S):
    naive = _fc(S, S.Policy.naive(keepalive_s=30.0))
    naive.record_arrival("m", 0.0)
    fc = _fc(S, S.Policy.proactive(keepalive_s=30.0,
                                   downscale_extend_s=60.0))
    fc.record_arrival("m", 0.0)
    return (naive.keepalive("m", 5.0), fc.keepalive("m", 5.0),
            fc.keepalive("m", 500.0))


def _keepalive_stretch(S):
    fc = _fc(S, S.Policy.proactive(keepalive_s=10.0,
                                   downscale_extend_s=100.0))
    for t0 in (0.0, 60.0):
        _burst(fc, "m", t0)
    return fc.keepalive("m", 100.0)


def _plans(plans):
    return [(p.model, p.n_groups, p.mode, p.reason) for p in plans]


def _prewarm_once(S):
    fc = _fc(S, S.Policy.proactive(prewarm_lead_s=10.0))
    for t0 in (0.0, 100.0, 200.0):
        _burst(fc, "m", t0)
    at_zero = lambda m: True
    return [_plans(fc.prewarm_due(t, at_zero))
            for t in (280.0, 292.0, 293.0, 392.0)]


def _prewarm_at_zero(S):
    fc = _fc(S, S.Policy.proactive(prewarm_lead_s=10.0))
    for t0 in (0.0, 100.0):
        _burst(fc, "m", t0)
    return _plans(fc.prewarm_due(195.0, lambda m: False))


def _cold_start_plan(S):
    c = S.Central(_servers(S))
    c.register_model(_profile(S))
    fc = S.FleetCtl(c, S.Policy.naive())
    return _plans([fc.cold_start_plan("m", 0, 0, 0, 1.0),
                   fc.cold_start_plan("m", 4, 8, 1, 1.0),
                   fc.cold_start_plan("m", 5, 0, 0, 1.0)])


def _demand_rank(S):
    fc = _fc(S, S.Policy.proactive())
    _burst(fc, "cold", 0.0, n=1)
    _burst(fc, "hot", 0.0, n=8)
    return fc.demand_rank(1.0)


def _distribution(S):
    T = S.T
    servers = {
        "fat": T.ServerSpec("fat", 32 * T.Gbps, 12e9, 24 * T.GB, 1),
        "mid": T.ServerSpec("mid", 16 * T.Gbps, 12e9, 24 * T.GB, 1),
        "thin": T.ServerSpec("thin", 8 * T.Gbps, 12e9, 24 * T.GB, 1),
    }
    c = S.Central(servers)
    new = c.plan_distribution(["a"], fanout=2)
    for m, sid in new:
        c.record_placement(m, sid)
    return new, c.plan_distribution(["a", "b"], fanout=3)


def _prefer(S):
    T = S.T
    c = S.Central(_servers(S, 4))
    c.register_model(_profile(S, max_pp=2))
    scheme = c.plan_cold_start("m", prefer=["s2", "s3"])
    tiny = {"s0": T.ServerSpec("s0", 16 * T.Gbps, 12e9, 24 * T.GB, 1),
            "s1": T.ServerSpec("s1", 16 * T.Gbps, 12e9, 1, 1)}
    c2 = S.Central(tiny)
    c2.register_model(_profile(S, max_pp=1))
    scheme2 = c2.plan_cold_start("m", prefer=["s1"])
    return (scheme.s, scheme.w, tuple(scheme.servers), scheme.predicted_ttft,
            tuple(scheme2.servers))


def _episode_props(r):
    assert r[0] == pytest.approx(300.0) and r[1] == pytest.approx(400.0)
    assert r[2] is None


def _keepalive_props(r):
    assert r == (30.0, 90.0, 30.0)


def _stretch_props(r):
    assert 20.0 <= r <= 110.0


def _prewarm_props(r):
    assert r[0] == [] and r[2] == [] and r[3] == []
    assert len(r[1]) == 1 and r[1][0][0] == "m" and r[1][0][3] == "prewarm"


def _plan_props(r):
    assert r[0][1] == 0 and r[1][1] == 0
    assert r[2][1] >= 1 and r[2][3] == "demand"


def _rank_props(r):
    assert r.index("hot") < r.index("cold")


def _distribution_props(r):
    new, new2 = r
    assert new == [("a", "fat"), ("a", "mid")]
    assert ("a", "thin") in new2 and ("a", "fat") not in new2
    assert {sid for m, sid in new2 if m == "b"} == {"fat", "mid", "thin"}


def _prefer_props(r):
    assert set(r[2]) <= {"s2", "s3"}
    assert r[4] == ("s0",)


POLICY_CASES = {
    "episode_period_learning": (_episode_period, _episode_props),
    "keepalive_delayed_downscale": (_keepalive_delayed, _keepalive_props),
    "keepalive_stretches_to_predicted_episode": (_keepalive_stretch,
                                                 _stretch_props),
    "prewarm_fires_once_then_goes_stale": (_prewarm_once, _prewarm_props),
    "prewarm_respects_at_zero": (_prewarm_at_zero, lambda r: r == []),
    "cold_start_plan_gates_on_capacity": (_cold_start_plan, _plan_props),
    "demand_rank_orders_hottest_first": (_demand_rank, _rank_props),
    "plan_distribution_fanout_and_skip_seeded": (_distribution,
                                                 _distribution_props),
    "plan_cold_start_prefers_seeded_servers": (_prefer, _prefer_props),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_decisions_equal_reference(case):
    run, props = POLICY_CASES[case]
    want, got = _both(run)
    assert_close(got, want)
    assert props(got) is not False


def test_placement_round_equals_reference():
    """Rounds on the interval only, the hottest ``placement_top_k`` seeded
    onto ``placement_fanout`` servers, recorded under the policy's tier and
    fed back through ``preferred_servers``."""
    def run(S):
        fc = _fc(S, S.Policy(proactive_placement=True, placement_top_k=2,
                             placement_interval_s=10.0), n=4)
        for m, n in (("a", 5), ("b", 3), ("c", 1)):
            _burst(fc, m, 0.0, n=n)
        acts = [[(a.model, a.server_id, a.tier)
                 for a in fc.placement_round(t)]
                for t in (1.0, 5.0, 11.0, 12.0, 21.5)]
        return acts, {m: fc.preferred_servers(m) for m in "abc"}

    want, got = _both(run)
    assert got == want
    acts, prefer = got
    assert acts[1] == [] and acts[3] == []
    assert {m for m, _, _ in acts[0]} == {"a", "b"}
    assert all(t == "peer" for r in acts for _, _, t in r)
    assert prefer["c"] == [] and len(prefer["a"]) == 2


# ---------------------------------------------------------------------------
# real engines (tests/test_fleet.py: the real-JAX fleet frontend)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """The reference's ``tiny_cfg`` on both sides, with the JAX init's
    weights converted for the port."""
    kw = dict(name="fleet-tiny", family="dense", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=4, d_ff=64, vocab=128, dtype="float32",
              max_pp=2)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return {"ref": (jcfg, jparams), "port": (tcfg, tparams)}


def _fleet(S, policy, n_servers=2, nic=None, **kw):
    T = S.T
    nic = 10 * T.Gbps if nic is None else nic
    servers = [T.ServerSpec(f"s{i}", nic, 12e9, 2 * T.GB, 1)
               for i in range(n_servers)]
    return S.Fleet(servers, policy, **kw, **S.fleet_kw)


def _register(S, ff, name, cfg, params=None, size=2 * 1024 * 1024, **kw):
    T = S.T
    prof = T.ModelProfile(name, size, T.TimingProfile(**TIMINGS),
                          T.SLO(10.0, 0.5), max_pp=2, kv_bytes_per_token=256)
    if "routing" not in kw:
        kw.setdefault("paged", False)
    return ff.register(cfg, prof, params=params, max_batch=2, max_seq=64,
                       **kw)


def _reqs(reqs):
    return [{"model": r.model, "arrival": r.arrival, "output": r.output,
             "wait": r.wait, "ttft": r.ttft, "slo_ok": r.slo_ok,
             "cold": r.cold, "replica": r.replica,
             "cached_tokens": r.cached_tokens,
             "restored_tokens": r.restored_tokens,
             "restore_seconds": r.restore_seconds} for r in reqs]


def _record(ff, reqs):
    return {"requests": _reqs(reqs), "cold_start_log": ff.cold_start_log,
            "placement_log": ff.placement_log, "metrics": ff.metrics(),
            "now": ff.now}


def _twin(tiny, run):
    """``run(S, cfg, params)`` on both sides: the records must be equal.
    Returns the port's (fleet, requests)."""
    (jff, jreqs), (ff, reqs) = _both(lambda S: run(S, *tiny[S.name]))
    assert_close(_record(ff, reqs), _record(jff, jreqs))
    return ff, reqs


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_fleet_scale_to_zero_bit_exact(tiny, paged):
    def run(S, cfg, params):
        ff = _fleet(S, S.Policy.naive(keepalive_s=15.0))
        for i in range(2):
            _register(S, ff, f"m{i}", cfg, params, paged=paged)
        trace = [(f"m{i}", t, [3 + i, 5, 7]) for i in range(2)
                 for t in (0.0, 60.0)]
        return ff, ff.run_trace(trace, drain_to=110.0)

    ff, reqs = _twin(tiny, run)
    first = {r.model: r.output for r in reqs if r.arrival == 0.0}
    for r in reqs:
        assert r.output, f"{r.model}@{r.arrival} never served"
        if r.arrival == 60.0:
            assert r.output == first[r.model], "re-warm diverged"
    assert ff.metrics()["cold_starts"] == 4
    assert all(not mm.slots for mm in ff.models.values())


def test_fleet_queued_requests_flush_at_ready(tiny):
    def run(S, cfg, params):
        ff = _fleet(S, S.Policy.naive(keepalive_s=30.0))
        _register(S, ff, "m0", cfg, params)
        r1 = ff.submit("m0", [3, 5], now=0.0)
        dur = ff.cold_start_log[0]["duration"]
        r2 = ff.submit("m0", [3, 5], now=dur / 2)
        ff.advance(dur + 1.0)
        return ff, [r1, r2]

    ff, (r1, r2) = _twin(tiny, run)
    dur = ff.cold_start_log[0]["duration"]
    assert dur > 0.1 and len(ff.cold_start_log) == 1
    assert r1.cold and r2.cold
    assert r1.wait == pytest.approx(dur, rel=0.1)
    assert r2.wait == pytest.approx(dur / 2, rel=0.2)
    assert r2.output == r1.output


def test_fleet_concurrent_cold_starts_contend(tiny):
    """Two models launched the same instant on one thin NIC finish later
    than a model launched alone: their stage fetches share it."""
    def solo(S, cfg, params):
        ff = _fleet(S, S.Policy.naive(), n_servers=1, nic=1e5)
        _register(S, ff, "m0", cfg, params)
        return ff, ff.run_trace([("m0", 0.0, [3, 5])])

    def both(S, cfg, params):
        ff = _fleet(S, S.Policy.naive(), n_servers=1, nic=1e5)
        for i in range(2):
            _register(S, ff, f"m{i}", cfg, params)
        return ff, ff.run_trace([("m0", 0.0, [3, 5]), ("m1", 0.0, [4, 6])])

    alone = _twin(tiny, solo)[0].cold_start_log[0]["duration"]
    ff, _ = _twin(tiny, both)
    durs = sorted(c["duration"] for c in ff.cold_start_log)
    assert len(durs) == 2
    assert durs[-1] > alone * 1.2


def test_fleet_cold_deploy_from_disk(tiny, tmp_path):
    """A fleet that never held the weights serves from an on-disk store:
    the port's own store, and the reference's (cross-loaded), both give
    the live fleet's tokens."""
    jcfg, jparams = tiny["ref"]
    tcfg, tparams = tiny["port"]
    JStore.save(str(tmp_path / "ref"), jax_model(jcfg), jparams,
                peer_bw=None, remote_bw=None)
    ModelStore.save(str(tmp_path / "port"), Model(tcfg), tparams,
                    peer_bw=None, remote_bw=None)

    def live(S, cfg, params):
        ff = _fleet(S, S.Policy.naive())
        _register(S, ff, "m0", cfg, params)
        return ff, ff.run_trace([("m0", 0.0, [3, 5, 7])])

    def cold(store_dir):
        def run(S, cfg, params):
            ff = _fleet(S, S.Policy.naive())
            _register(S, ff, "m0", cfg, params=None,
                      store_dir=str(tmp_path / store_dir))
            return ff, ff.run_trace([("m0", 0.0, [3, 5, 7])])
        return run

    a = _twin(tiny, live)[1]
    for d in ("ref", "port"):
        ff, b = _twin(tiny, cold(d))
        assert b[0].output == a[0].output
        assert ff.frontend._deployed["m0"].model is None


def test_fleet_placement_accelerates_cold_start(tiny):
    """After an Alg. 1 placement round the next cold start fetches from the
    placed fast tier instead of the slow source registry."""
    def run(S, cfg, params):
        policy = S.Policy(keepalive_s=5.0, proactive_placement=True,
                          placement_interval_s=10.0, placement_top_k=2)
        ff = _fleet(S, policy, source_bw=1e4, placement_bw=1e9)
        _register(S, ff, "m0", cfg, params)
        r1 = ff.submit("m0", [3, 5], now=0.0)
        ff.advance(ff.cold_start_log[0]["ready"] + 20.0)
        assert not ff.models["m0"].slots
        r2 = ff.submit("m0", [3, 5], now=ff.now)
        ff.advance(ff.now + ff.cold_start_log[-1]["duration"] + 1.0)
        return ff, [r1, r2]

    ff, (r1, r2) = _twin(tiny, run)
    slow, fast = ff.cold_start_log[0], ff.cold_start_log[-1]
    assert ff.placement_log, "placement round never ran"
    assert fast["tier"] == ff.policy.placement_tier == "peer"
    assert slow["tier"] == ff.models["m0"].base_tier
    assert fast["duration"] < slow["duration"] / 10
    assert r2.output == r1.output
    store = ff.frontend.store_of("m0")
    assert isinstance(store.tier("peer"), AliasTier)


def _session_trace(n_sessions=3, turns=3, vocab=128):
    out = []
    for s in range(n_sessions):
        base = [(s * 17 + j) % vocab for j in range(16)]
        for k in range(turns):
            out.append(base + [(s * 31 + 7 * k + j) % vocab
                               for j in range(8 * k)])
    return out


def _routed(routing, n_replicas):
    def run(S, cfg, params):
        ff = _fleet(S, S.Policy.naive(keepalive_s=1e6))
        _register(S, ff, "m0", cfg, params, block_size=8, routing=routing)
        ff.scale_to("m0", n_replicas, now=0.0)
        mm = ff.models["m0"]
        t = max(s.ready_at for s in mm.slots) + 1.0
        reqs = []
        for prompt in _session_trace():
            reqs.append(ff.submit("m0", prompt, S.SP(max_new=3), now=t))
            t += 0.5
        ff.advance(t + 5.0)
        return ff, reqs
    return run


@pytest.fixture(scope="module")
def routed_runs(tiny):
    return {(r, n): _twin(tiny, _routed(r, n))
            for r, n in (("kv_affinity", 1), ("round_robin", 2),
                         ("kv_affinity", 2))}


@pytest.mark.parametrize("routing, n", [("kv_affinity", 1),
                                        ("round_robin", 2),
                                        ("kv_affinity", 2)])
def test_fleet_routed_equals_reference(routed_runs, routing, n):
    """Each routed fleet (the comparison inside ``_twin``) gives every
    request a replica and the policy's decisions."""
    ff, reqs = routed_runs[(routing, n)]
    m = ff.metrics()["per_model"]["m0"]
    assert all(r.replica for r in reqs)
    assert m["router"]["policy"] == routing
    assert m["router"]["decisions"] == len(reqs)
    assert set(m["endpoints"]) == {f"m0/r{i}" for i in range(n)}


def test_fleet_routed_outputs_bit_exact_and_affinity_wins(routed_runs):
    ref = routed_runs[("kv_affinity", 1)]
    rr_ff, rr = routed_runs[("round_robin", 2)]
    aff_ff, aff = routed_runs[("kv_affinity", 2)]
    want = [r.output for r in ref[1]]
    assert [r.output for r in rr] == want
    assert [r.output for r in aff] == want
    rr_m = rr_ff.metrics()["per_model"]["m0"]
    aff_m = aff_ff.metrics()["per_model"]["m0"]
    assert aff_m["cached_tokens"] > rr_m["cached_tokens"]
    assert aff_m["cached_ratio"] > rr_m["cached_ratio"]
    p99 = lambda reqs: sorted(r.ttft for r in reqs)[-1]
    assert p99(aff) < p99(rr)
    assert "host_blocks" in aff_m["kv_tier"]


def test_fleet_scale_to_zero_spills_and_restores(tiny):
    """Reaping a routed model demotes its prefix cache to the host tier;
    the next cold start restores it instead of re-prefilling, bit-exact
    with the first pass."""
    def run(S, cfg, params):
        ff = _fleet(S, S.Policy.naive(keepalive_s=1e6))
        _register(S, ff, "m0", cfg, params, block_size=8,
                  routing="kv_affinity")
        ff.scale_to("m0", 1, now=0.0)
        mm = ff.models["m0"]
        ready = max(s.ready_at for s in mm.slots)
        P = list(range(1, 17))
        r1 = ff.submit("m0", P, S.SP(max_new=4), now=ready + 1.0)
        ff.fleet.policy.keepalive_s = 1.0
        ff.advance(ready + 400.0)
        assert not mm.slots, "keepalive reap never fired"
        host_blocks = mm.kv_tier.host_blocks
        r2 = ff.submit("m0", P, S.SP(max_new=4), now=ready + 500.0)
        ff.advance(ready + 900.0)
        return ff, [r1, r2, host_blocks]

    (jff, (j1, j2, jhost)), (ff, (r1, r2, host)) = _both(
        lambda S: run(S, *tiny[S.name]))
    assert_close(_record(ff, [r1, r2]), _record(jff, [j1, j2]))
    assert host == jhost and host > 0
    assert r2.output == r1.output
    assert r2.restored_tokens > 0 and r2.restore_seconds > 0.0
    mm = ff.models["m0"]
    assert mm.kv_tier.restores > 0
    assert mm.kv_tier.stats() == jff.models["m0"].kv_tier.stats()


def test_fleet_frontend_defaults_to_the_card(monkeypatch):
    """Without CUDA the default raises: the fleet never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    servers = [ttypes.ServerSpec("s0", 1e9, 12e9, 1 << 30, 1)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetFrontend(servers)
    ff = FleetFrontend(servers, device="cpu")
    assert ff.frontend.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the slice as a whole: chip_smoke.py's FLEET trace at the smoke widths
# ---------------------------------------------------------------------------

FLEET_NEW = 6


@pytest.fixture(scope="module")
def smoke_models():
    """granite-3-8b and rwkv6-1.6b at the smoke widths, the JAX init on
    both sides."""
    out = {}
    for arch in ("granite-3-8b", "rwkv6-1.6b"):
        jcfg = smoke(arch)
        tcfg = smoke_variant(get_config(arch))
        jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        out[arch] = {"ref": (jcfg, jparams), "port": (tcfg, tparams)}
    return out


def _fleet_phase(S, models):
    """The ``FLEET`` phase's trace: granite (routed, 2-stage cold starts)
    and rwkv6 (slot-contiguous) on four servers; P1, P2 and R1 at t=0,
    P1 warm at granite's ready + 5 s, past the keepalive (placement rounds,
    idle consolidation, reap), then P1 and R1 cold again, drained to zero.
    A thin source tier stands in for the full-width fetch."""
    T = S.T
    servers = [T.ServerSpec(f"srv{i}", 16 * T.Gbps, 12e9, 80 * T.GB)
               for i in range(4)]
    policy = S.Policy(keepalive_s=30.0, proactive_placement=True,
                      placement_interval_s=10.0, placement_top_k=2)
    ff = S.Fleet(servers, policy, source_bw=1e5, placement_bw=S.PEER,
                 **S.fleet_kw)
    gcfg, gparams = models["granite-3-8b"][S.name]
    rcfg, rparams = models["rwkv6-1.6b"][S.name]
    timing = T.TimingProfile(**TIMINGS)
    ff.register(gcfg, T.ModelProfile("granite", 8 * T.GB, timing,
                                     T.SLO(7.5, 0.2)),
                params=gparams, routing="kv_affinity", kv_tier_blocks=64,
                block_size=16, max_batch=4, max_seq=128, min_stages=2)
    ff.register(rcfg, T.ModelProfile("rwkv", 2 * T.GB, timing,
                                     T.SLO(7.5, 0.2)),
                params=rparams, paged=False, max_batch=4, max_seq=128)
    rng = np.random.RandomState(0)
    p1, p2, r1 = (rng.randint(0, 512, n).tolist() for n in (30, 26, 41))
    sp = S.SP(max_new=FLEET_NEW)
    reqs = ff.run_trace([("granite", 0.0, p1, sp), ("granite", 0.0, p2, sp),
                         ("rwkv", 0.0, r1, sp)])
    t_warm = ff.cold_start_log[0]["ready"] + 5.0
    reqs.append(ff.submit("granite", p1, sp, now=t_warm))
    consolidated = []
    t = t_warm
    while ff.models["granite"].slots or ff.models["rwkv"].slots:
        t += 1.0
        ff.advance(t)
        consolidated += [s.name for mm in ff.models.values()
                         for s in mm.slots if s.consolidated
                         and s.name not in consolidated]
    host_blocks = ff.models["granite"].kv_tier.host_blocks
    reqs += ff.run_trace([("granite", t + 1.0, p1, sp),
                          ("rwkv", t + 1.0, r1, sp)])
    while ff.models["granite"].slots or ff.models["rwkv"].slots:
        t += 1.0
        ff.advance(t)
    return ff, reqs, {"consolidated": consolidated,
                      "host_blocks": host_blocks}


def test_fleet_phase_equals_reference(smoke_models):
    (jff, jreqs, jinfo), (ff, reqs, info) = _both(
        lambda S: _fleet_phase(S, smoke_models))
    assert_close(_record(ff, reqs), _record(jff, jreqs))
    assert info == jinfo
    p1, p2, r1, w1, p1b, r1b = reqs
    # streams: re-warmed == first, warm prefix hit == cold (f32)
    assert p1b.output == p1.output and r1b.output == r1.output
    assert w1.output == p1.output and w1.cached_tokens > 0
    # cold starts: 4, the second pair from the placed tier, granite's
    # second shorter
    log = ff.cold_start_log
    assert len(log) == 4 and ff.placement_log
    first = {c["model"]: c for c in log[:2]}
    second = {c["model"]: c for c in log[2:]}
    assert set(first) == set(second) == {"granite", "rwkv"}
    for c in second.values():
        assert c["tier"] == ff.policy.placement_tier == "peer"
    assert second["granite"]["duration"] < first["granite"]["duration"]
    assert first["granite"]["s"] == 2
    # consolidation, the spill at reap and the restore
    assert info["consolidated"] and info["host_blocks"] > 0
    assert p1b.restored_tokens > 0
    assert all(not mm.slots for mm in ff.models.values())


def test_fleet_phase_streams_equal_one_stage_engines(smoke_models):
    """The phase's first streams equal a 1-stage engine's on the same
    weights: paged for granite, slot-contiguous for rwkv."""
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine
    ff, reqs, _ = _fleet_phase(PORT, smoke_models)
    for arch, req, paged in (("granite-3-8b", reqs[0], True),
                             ("rwkv6-1.6b", reqs[2], False)):
        cfg, params = smoke_models[arch]["port"]
        ep = ServingEndpoint(Engine(cfg, [params], max_batch=4, max_seq=128,
                                    paged=paged, device="cpu"))
        h = ep.submit(req.prompt, SamplingParams(max_new=FLEET_NEW))
        ep.run()
        assert list(h.generated) == req.output


# ---------------------------------------------------------------------------
# store placement (tests/test_store.py: tier placement)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite_store(tmp_path_factory):
    cfg = dataclasses.replace(smoke_variant(get_config("granite-3-8b")),
                              n_layers=4)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return model, params, tmp_path_factory


def _fresh_store(granite_store, **bw):
    model, params, tmp = granite_store
    return ModelStore.save(str(tmp.mktemp("store")), model, params,
                           **{"peer_bw": None, "remote_bw": None, **bw})


def test_place_alias_tier_reads_identical(granite_store):
    store = _fresh_store(granite_store)
    placed = store.place("seed", 256 * ttypes.Gbps)
    assert store.has_tier("seed") and isinstance(placed, AliasTier)
    assert store.fastest_tier() is placed
    assert store.tier(None) is placed
    for sc in store.stage_plan(1, 0)[:4]:
        a = store.tier("local").read(sc.chunk, 0, sc.length)
        b = store.tier("seed").read(sc.chunk, 0, sc.length)
        assert bytes(a) == bytes(b)
    # over a memory tier the alias hands back the base's uint8 view
    model, params, _ = granite_store
    mem = ModelStore.from_params(model, params, bandwidth=1e6)
    mem.place("seed", 1e9)
    c = mem.manifest.chunks[0]
    got = mem.tier("seed").read(c, 0, c.nbytes)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.tobytes() == mem.tier("memory").read(c, 0, c.nbytes).tobytes()


def test_place_retunes_and_drop_rules(granite_store):
    store = _fresh_store(granite_store)
    t1 = store.place("seed", 1e9)
    t2 = store.place("seed", 8e9)
    assert t1 is t2 and t2.bandwidth == 8e9
    with pytest.raises(ValueError):
        store.drop_tier("local")
    with pytest.raises(ValueError, match="already exists"):
        store.add_tier(AliasTier("seed", store.tier("local"), 1.0))
    store.drop_tier("seed")
    assert not store.has_tier("seed")
    with pytest.raises(ValueError):
        store.drop_tier("local")


def test_placed_tier_speeds_up_fetch(granite_store):
    store = _fresh_store(granite_store, local_bw=1e6)
    store.place("seed", 1e9)

    def fetch_span(tier):
        loader = StreamedStageLoader(store, FetchSchedule.single(16 * 1e9 / 8),
                                     ttypes.TimingProfile(**TIMINGS),
                                     load_bytes_per_s=12e9, tier=tier,
                                     device="cpu")
        _, rec = loader.load_stage(1, 0, worker_id=f"pt-{tier}")
        s = rec.timeline.spans["fetch"]
        return s[1] - s[0]

    assert fetch_span("seed") < fetch_span("local") / 100


def test_placement_equals_reference_on_a_shared_store(granite_store):
    """The reference's store and the port's, opened on one directory and
    placed alike, order their tiers alike and give a placed-tier loader
    the same spans."""
    from repro.core.coldstart import OverlapFlags as JFlags
    from repro.store import FetchSchedule as JSched
    from repro.store import StreamedStageLoader as JLoader
    store = _fresh_store(granite_store, local_bw=1e6)
    root = store.tier("local").root
    jstore = JStore.open(root, peer_bw=None, remote_bw=None, local_bw=1e6)
    for s in (store, jstore):
        s.place("seed", 1e9)
        s.place("near", 4e8, source="local")
    assert [(t.name, t.bandwidth) for t in store.tiers] == \
        [(t.name, t.bandwidth) for t in jstore.tiers]
    jl = JLoader(jstore, JSched.single(2e9), jtypes.TimingProfile(**TIMINGS),
                 JFlags(True, True, True), load_bytes_per_s=12e9,
                 tier="near")
    tl = StreamedStageLoader(store, FetchSchedule.single(2e9),
                             ttypes.TimingProfile(**TIMINGS),
                             load_bytes_per_s=12e9, tier="near",
                             device="cpu")
    _, jrec = jl.load_stage(1, 0)
    _, trec = tl.load_stage(1, 0)
    assert_close(trec.to_json(), jrec.to_json())


# ---------------------------------------------------------------------------
# the port's lint over the new modules
# ---------------------------------------------------------------------------

FLEET_MODULES = ["fleet/frontend.py", "fleet/controller.py",
                 "cluster/cluster.py", "cluster/sim.py",
                 "serving/simulation.py"]


@pytest.mark.parametrize("rel", FLEET_MODULES)
def test_lint_covers_the_fleet_modules(tmp_path, rel):
    """Each simulation/fleet module lints clean, the baseline stays empty,
    and a wall-clock read added to it is flagged (the module is in the
    ``wallclock-in-sim`` rule's scope)."""
    import json
    from pathlib import Path
    from repro_torch.analysis import lint
    path = Path(lint.__file__).resolve().parents[1] / rel
    assert lint.lint_file(str(path), rel) == []
    with open(lint.default_baseline_path()) as f:
        assert json.load(f) == {}
    bad = tmp_path / "m.py"
    bad.write_text(path.read_text() + "\nimport time\nT0 = time.time()\n")
    assert [f.rule for f in lint.lint_file(str(bad), rel)] == \
        ["wallclock-in-sim"]
