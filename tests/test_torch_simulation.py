"""The port's discrete-event simulator, cluster and workloads held against
the reference's on the CPU (mirrors ``tests/test_simulation.py``,
``tests/test_workloads.py``, ``tests/test_network.py`` and the simulator
cases of ``tests/test_fleet.py``).

Both sides run the same Python on the same seeded inputs, so what they give
is held exactly: ``ServerlessSim.metrics()`` for the three systems under the
naive and the proactive fleet policy, request timings, traces and flow
completion times. Each twin also asserts the property its reference test
asserts, on the port's result."""

import math

import numpy as np
import pytest

from repro.cluster.cluster import Cluster as JCluster
from repro.cluster.sim import EventSim as JEventSim
from repro.core import types as jtypes
from repro.fleet.controller import FleetPolicy as JPolicy
from repro.serving.simulation import ServerlessSim as JSim
from repro.workloads import applications as japps
from repro.workloads import generator as jgen
from repro_torch.cluster import Cluster, EventSim
from repro_torch.core import types as ttypes
from repro_torch.fleet import FleetPolicy
from repro_torch.serving.simulation import ServerlessSim
from repro_torch.workloads import applications as tapps
from repro_torch.workloads import generator as tgen

SIDES = {
    "ref": dict(types=jtypes, Sim=JSim, Policy=JPolicy, apps=japps,
                gen=jgen, Cluster=JCluster, EventSim=JEventSim),
    "port": dict(types=ttypes, Sim=ServerlessSim, Policy=FleetPolicy,
                 apps=tapps, gen=tgen, Cluster=Cluster, EventSim=EventSim),
}


def _servers(S):
    T = S["types"]
    return ([T.ServerSpec(f"a10-{i}", 16 * T.Gbps, 12e9, 24 * T.GB, 1)
             for i in range(4)]
            + [T.ServerSpec(f"v100-{i}", 16 * T.Gbps, 12e9, 32 * T.GB, 4)
               for i in range(4)])


def _profiles(S):
    T, A = S["types"], S["apps"]
    return {n: T.ModelProfile(n, w.size_bytes, A.timings_for(n),
                              T.SLO(7.5, 0.2),
                              kv_bytes_per_token=A.kv_bytes_for(n))
            for n, w in A.WARM.items()}


def _req_record(reqs):
    return [(r.model, r.arrival, r.prompt_tokens, r.output_tokens,
             r.first_token, r.completion, r.cold) for r in reqs]


def _both(fn):
    return fn(SIDES["ref"]), fn(SIDES["port"])


# ---------------------------------------------------------------------------
# ServerlessSim: three systems x two fleet policies, metrics exactly equal
# ---------------------------------------------------------------------------

POLICIES = {
    "naive": lambda P: P.naive(keepalive_s=20.0),
    "proactive": lambda P: P.proactive(keepalive_s=20.0,
                                       downscale_extend_s=30.0,
                                       placement_interval_s=20.0),
}


def _policy_run(S, system, policy):
    insts = S["gen"].make_instances(S["apps"].APPLICATIONS[:2], 2)
    sim = S["Sim"](_servers(S), _profiles(S), insts, system=system,
                   keepalive_s=20.0, policy=POLICIES[policy](S["Policy"]))
    reqs = S["gen"].periodic_bursts(insts, 90.0, 4, 2, stagger=3.0, seed=1)
    sim.submit(reqs)
    sim.run(until=90.0 * 6)
    return sim, reqs


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("system", ["hydra", "vllm", "serverlessllm"])
def test_sim_metrics_equal_reference(system, policy):
    (jsim, jreqs), (tsim, treqs) = _both(
        lambda S: _policy_run(S, system, policy))
    m = tsim.metrics()
    assert m == jsim.metrics()
    assert m["n"] == len(treqs)
    assert _req_record(treqs) == _req_record(jreqs)
    assert tsim.cold_start_log == jsim.cold_start_log
    assert tsim.placement_log == jsim.placement_log
    if policy == "naive":
        assert m["prewarms"] == 0 and m["placements"] == 0


def test_sim_proactive_policy_prewarms_and_improves():
    naive = _policy_run(SIDES["port"], "hydra", "naive")[0].metrics()
    pro = _policy_run(SIDES["port"], "hydra", "proactive")[0].metrics()
    assert pro["prewarms"] > 0 and pro["placements"] > 0
    assert pro["cold_requests"] < naive["cold_requests"]


# ---------------------------------------------------------------------------
# tests/test_simulation.py
# ---------------------------------------------------------------------------


def _run(S, system, **kw):
    insts = S["gen"].make_instances(S["apps"].APPLICATIONS, 8)
    sim = S["Sim"](_servers(S), _profiles(S), insts, system=system, **kw)
    reqs = S["gen"].generate(insts, rps=0.4, cv=8.0, duration=400, seed=0)
    sim.submit(reqs)
    sim.run(until=5000)
    return sim, reqs


@pytest.fixture(scope="module")
def runs():
    """Each system's run of the paper workload, on both sides."""
    return {system: _both(lambda S: _run(S, system))
            for system in ("vllm", "serverlessllm", "hydra")}


@pytest.mark.parametrize("system", ["vllm", "serverlessllm", "hydra"])
def test_all_requests_complete(runs, system):
    (jsim, jreqs), (tsim, treqs) = runs[system]
    assert len(tsim.finished) == len(treqs)
    for r in tsim.finished:
        assert r.first_token is not None and r.completion is not None
        assert r.completion >= r.first_token >= r.arrival
    assert _req_record(treqs) == _req_record(jreqs)
    assert tsim.metrics() == jsim.metrics()


def test_hydra_beats_vllm_on_cold_ttft(runs):
    v = runs["vllm"][1][0].metrics()
    h = runs["hydra"][1][0].metrics()
    assert h["ttft_mean"] < v["ttft_mean"]
    assert h["ttft_p99"] < v["ttft_p99"]


def test_tpot_attainment_stays_high(runs):
    assert runs["hydra"][1][0].metrics()["tpot_attainment"] > 0.85


def test_single_cold_start_matches_predictor():
    """Measured single cold start ~= Eq.5 + prefill terms (idle cluster),
    and the same on both sides."""
    def one(S):
        insts = S["gen"].make_instances(S["apps"].APPLICATIONS[:1], 1,
                                        slo_scale=100.0)
        sim = S["Sim"](_servers(S), _profiles(S), insts, system="hydra",
                       force_s=1)
        reqs = S["gen"].burst(insts[0], 1)
        sim.submit(reqs)
        sim.run(until=600)
        return insts, reqs

    (_, jreqs), (insts, reqs) = _both(one)
    assert reqs[0].ttft == jreqs[0].ttft
    prof = _profiles(SIDES["port"])["llama2-7b"]
    t = prof.timings
    fetch = prof.size_bytes / (16 * ttypes.Gbps)
    load = prof.size_bytes / 12e9
    ready = max(t.t_cc + t.t_cu + max(load, t.t_l), fetch)
    prefill = t.t_p * insts[0].mean_prompt / 1024.0
    assert abs(reqs[0].ttft - (ready + prefill)) < 0.2


def test_failure_recovery():
    def one(S):
        insts = S["gen"].make_instances(S["apps"].APPLICATIONS[:1], 1,
                                        slo_scale=100.0)
        sim = S["Sim"](_servers(S), _profiles(S), insts, system="hydra")
        reqs = S["gen"].burst(insts[0], 4)
        sim.submit(reqs)
        sim.sim.at(12.0, lambda: sim.inject_failure(insts[0].name))
        sim.run(until=2000)
        return sim, reqs

    (jsim, jreqs), (sim, reqs) = _both(one)
    assert sim.failures_injected == 1
    assert all(r.completion is not None for r in reqs)
    assert _req_record(reqs) == _req_record(jreqs)


def test_keepalive_frees_hbm():
    def one(S):
        insts = S["gen"].make_instances(S["apps"].APPLICATIONS[:1], 1,
                                        slo_scale=100.0)
        sim = S["Sim"](_servers(S), _profiles(S), insts, system="hydra",
                       keepalive_s=30.0)
        reqs = S["gen"].burst(insts[0], 1)
        sim.submit(reqs)
        sim.run(until=3000)
        return sim, reqs

    (jsim, jreqs), (sim, reqs) = _both(one)
    total_free = sum(d.hbm_free for s in sim.cluster.servers.values()
                     for d in s.devices)
    total = sum(d.hbm_total for s in sim.cluster.servers.values()
                for d in s.devices)
    assert total_free == total
    assert _req_record(reqs) == _req_record(jreqs)
    assert sim.cold_start_log == jsim.cold_start_log


# ---------------------------------------------------------------------------
# tests/test_workloads.py
# ---------------------------------------------------------------------------


def _trace(reqs):
    return [(r.model, r.arrival, r.prompt_tokens, r.output_tokens)
            for r in reqs]


def test_instance_creation():
    def one(S):
        A, G = S["apps"], S["gen"]
        return G.make_instances(A.APPLICATIONS, 4), \
            G.make_instances(A.APPLICATIONS, 1, slo_scale=2.0)

    (ja, jb), (insts, scaled) = _both(one)
    assert len(insts) == 4 * len(tapps.APPLICATIONS)
    assert len({i.name for i in insts}) == len(insts)
    assert scaled[0].slo_ttft == 2 * tapps.APPLICATIONS[0].slo.ttft
    key = lambda xs: [(i.name, i.base_model, i.slo_ttft, i.slo_tpot,
                       i.mean_prompt, i.mean_output) for i in xs]
    assert key(insts) == key(ja) and key(scaled) == key(jb)


def test_rate_and_cv():
    def one(S):
        insts = S["gen"].make_instances(S["apps"].APPLICATIONS, 8)
        return S["gen"].generate(insts, rps=2.0, cv=4.0, duration=2000,
                                 seed=0)

    jreqs, reqs = _both(one)
    assert _trace(reqs) == _trace(jreqs)
    arr = np.array([r.arrival for r in reqs])
    inter = np.diff(arr)
    assert 1.6 < len(reqs) / 2000 < 2.4
    assert 3.0 < inter.std() / inter.mean() < 5.0


def test_determinism():
    insts = tgen.make_instances(tapps.APPLICATIONS, 4)
    a = tgen.generate(insts, 1.0, 2.0, 200, seed=5)
    b = tgen.generate(insts, 1.0, 2.0, 200, seed=5)
    assert _trace(a) == _trace(b)


def test_popularity_is_skewed():
    def one(S):
        insts = S["gen"].make_instances(S["apps"].APPLICATIONS, 16)
        return S["gen"].generate(insts, rps=2.0, cv=2.0, duration=2000,
                                 seed=1)

    jreqs, reqs = _both(one)
    assert _trace(reqs) == _trace(jreqs)
    counts = {}
    for r in reqs:
        counts[r.model] = counts.get(r.model, 0) + 1
    ordered = sorted(counts.values(), reverse=True)
    assert ordered[0] > 5 * max(ordered[len(ordered) // 2], 1)


def test_burst():
    insts = tgen.make_instances(tapps.APPLICATIONS, 1)
    reqs = tgen.burst(insts[0], 30, at=3.0)
    assert len(reqs) == 30
    assert all(r.arrival == 3.0 for r in reqs)
    jinsts = jgen.make_instances(japps.APPLICATIONS, 1)
    assert _trace(reqs) == _trace(jgen.burst(jinsts[0], 30, at=3.0))


def test_periodic_bursts_equal_reference():
    def one(S):
        insts = S["gen"].make_instances(S["apps"].APPLICATIONS[:3], 2)
        return S["gen"].periodic_bursts(insts, 60.0, 5, 3, stagger=2.0,
                                        jitter=1.5, seed=4)

    jreqs, reqs = _both(one)
    assert reqs and _trace(reqs) == _trace(jreqs)
    assert [r.cold for r in reqs] == [r.cold for r in jreqs]


def test_multi_turn_sessions():
    def one(S):
        inst = S["gen"].make_instances(S["apps"].APPLICATIONS, 1)[0]
        return S["gen"].multi_turn_sessions(inst, n_sessions=5, turns=4,
                                            first_prompt=24, turn_tokens=8,
                                            vocab=100, seed=7)

    jreqs, reqs = _both(one)
    rec = lambda rs: [(r.session, r.turn, r.arrival, r.prompt_ids)
                      for r in rs]
    assert rec(reqs) == rec(jreqs)
    assert len(reqs) == 5 * 4
    assert [r.arrival for r in reqs] == sorted(r.arrival for r in reqs)
    by_session = {}
    for r in reqs:
        by_session.setdefault(r.session, []).append(r)
    assert set(by_session) == set(range(5))
    for rs in by_session.values():
        rs.sort(key=lambda r: r.turn)
        assert [r.turn for r in rs] == [0, 1, 2, 3]
        assert len(rs[0].prompt_ids) == 24
        for prev, nxt in zip(rs, rs[1:]):
            assert nxt.arrival > prev.arrival
            assert nxt.prompt_ids[:len(prev.prompt_ids)] == prev.prompt_ids
            assert len(nxt.prompt_ids) == len(prev.prompt_ids) + 8
        for r in rs:
            assert r.prompt_tokens == len(r.prompt_ids)
            assert all(0 <= t < 100 for t in r.prompt_ids)


def test_kv_bytes_per_token_from_geometry():
    """The port's paper-model configs give the reference's per-token KV
    bytes, and a geometry-less profile is refused at registration."""
    for n in tapps.WARM:
        assert tapps.kv_bytes_for(n) == japps.kv_bytes_for(n)
        assert tapps.timings_for(n) == ttypes.TimingProfile(
            **vars(japps.timings_for(n)))
    assert tapps.kv_bytes_for("llama2-7b") == 512 * 1024
    assert tapps.kv_bytes_for("llama2-13b") == 2 * 40 * 40 * 128 * 2

    T = ttypes
    servers = [T.ServerSpec("s0", 2e9, 12e9, 64 * T.GB, 1)]
    insts = tgen.make_instances(tapps.APPLICATIONS, 2)
    profiles = {n: T.ModelProfile(
        n, w.size_bytes, tapps.timings_for(n), T.SLO(7.5, 0.2),
        kv_bytes_per_token=None if n == "opt-6.7b"
        else tapps.kv_bytes_for(n))
        for n, w in tapps.WARM.items()}
    with pytest.raises(ValueError, match="kv_bytes_per_token"):
        ServerlessSim(servers, profiles, insts)
    sim = ServerlessSim(servers, _profiles(SIDES["port"]), insts)
    for inst in insts:
        assert sim._kv_bytes_per_token(inst.name) == \
            tapps.kv_bytes_for(inst.base_model)


def test_paper_configs_equal_reference():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    for n in ("llama2-7b", "llama2-13b", "opt-6.7b"):
        assert vars(get_config(n)) == vars(jget(n))


# ---------------------------------------------------------------------------
# tests/test_network.py: the fair-share NIC fluid model
# ---------------------------------------------------------------------------


def _net(S, script):
    sim = S["EventSim"]()
    cl = S["Cluster"](sim, [S["types"].ServerSpec("s0", 2e9, 12e9,
                                                  24 * S["types"].GB)])
    done = {}

    def fetch(name, nbytes, **kw):
        return cl.start_fetch("s0", nbytes,
                              lambda: done.__setitem__(name, sim.now), **kw)

    script(sim, cl, fetch)
    sim.run()
    return done


NET_CASES = {
    "single_flow": (lambda sim, cl, f: f("a", 10e9), {"a": 5.0}),
    "two_flows_fair_share": (
        lambda sim, cl, f: (f("a", 10e9), f("b", 10e9)),
        {"a": 10.0, "b": 10.0}),
    "late_joiner": (
        lambda sim, cl, f: (f("a", 10e9), sim.at(2.5, lambda: f("b", 10e9))),
        {"a": 7.5, "b": 10.0}),
    "cancel_releases_bandwidth": (
        lambda sim, cl, f: (lambda fa: (f("b", 10e9),
                                        sim.at(1.0,
                                               lambda: cl.cancel_fetch(fa))))
        (f("a", 100e9)),
        {"b": 5.5}),
    "zero_byte_completes_immediately": (lambda sim, cl, f: f("a", 0),
                                        {"a": 0.0}),
}


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_network_flows(case):
    script, want = NET_CASES[case]
    jdone, done = _both(lambda S: _net(S, script))
    assert done == jdone
    assert set(done) == set(want)
    for k, v in want.items():
        assert math.isclose(done[k], v, rel_tol=1e-6, abs_tol=1e-12)


def test_weighted_priority():
    def script(sim, cl, f):
        f("hi", 6e9, weight=2.0)
        f("lo", 6e9, weight=1.0)

    jdone, done = _both(lambda S: _net(S, script))
    assert done == jdone
    assert done["hi"] < done["lo"]
