"""The port's cold-start data plane held against the reference on the CPU:
the chunked model store, the streamed stage loader, the measured-vs-
analytic cross-check and the ``ServerlessFrontend`` quickstart path
(mirrors ``tests/test_store.py``, ``tests/test_coldstart.py`` and
``tests/test_system.py``).

Exactness, not tolerance, wherever both sides compute the same thing:
manifests, chunk bytes and stage byte counts are equal; the simulated
cold-start timelines are equal to 1e-9 s; greedy token streams are equal.
The quickstart runs twice: on granite-3-8b and on rwkv6-1.6b, whose
recurrent states ride the cold start, the stage loads and consolidation.
The loader's spans against the analytic ``worker_timeline`` are held
within the reference's 5% (``validate.DEFAULT_TOL``)."""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.core.types import GB as JGB, Gbps as JGbps
from repro.core.types import ModelProfile as JProfile
from repro.core.types import ServerSpec as JServer
from repro.core.types import SLO as JSLO
from repro.core.types import TimingProfile as JTimings
from repro.models import build_model as jax_model
from repro.serving.api import SamplingParams as JSP
from repro.serving.endpoint import ServerlessFrontend as JFrontend
from repro.store import ModelStore as JStore
from repro.store import save_model as jax_save
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.core import (GB, Gbps, ModelProfile, OverlapFlags,
                              ServerSpec, SLO, TimingProfile)
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServerlessFrontend
from repro_torch.store import (FetchSchedule, ModelStore,
                               StreamedStageLoader, assert_within,
                               build_manifest, crosscheck_stages,
                               load_manifest, save_model)

SRC = Path(__file__).resolve().parents[1] / "src"
T = dict(t_cc=2.0, t_l=2.5, t_cu=0.5, t_n=0.01, t_p=1.5, t_d=0.042)
SPAN_TOL = 1e-9
PROMPT = [11, 42, 7, 13, 5]


def _cfgs(n_layers=4, dtype="float32", arch="granite-3-8b"):
    jcfg = dataclasses.replace(smoke(arch), n_layers=n_layers, dtype=dtype)
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)),
                               n_layers=n_layers, dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def granite4():
    """4 periods (pipeline degrees up to 4), float32, the same weights on
    both sides."""
    jcfg, tcfg = _cfgs()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def port_store(granite4, tmp_path_factory):
    _, _, tcfg, tparams = granite4
    d = tmp_path_factory.mktemp("port_store")
    return ModelStore.save(str(d), Model(tcfg), tparams)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], path + (key,)).items()}
    return {path: tree}


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert list(g) == list(w)
    for k in g:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


# ================================================================ manifest
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manifest_and_chunks_equal_reference(dtype):
    """Same chunk order, paths, file names, dtype strings, shapes, roles,
    stage ranges and bytes as the reference's ``build_manifest``."""
    from repro.store import build_manifest as jax_build
    jcfg, tcfg = _cfgs(dtype=dtype)
    jm = jax_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jman, jarr = jax_build(jm, jparams)
    tman, tarr = build_manifest(Model(tcfg), tparams)
    assert tman.to_json() == jman.to_json()
    assert list(tarr) == list(jarr)
    for f in jarr:
        assert tarr[f].tobytes() == np.asarray(jarr[f]).tobytes(), f
    if dtype == "bfloat16":
        assert {c.dtype for c in tman.chunks} == {"bfloat16"}


def test_manifest_stage_ranges_and_bytes(port_store, granite4):
    _, _, tcfg, _ = granite4
    m = Model(tcfg)
    man = port_store.manifest
    assert man.n_periods == tcfg.n_periods
    assert man.degrees == list(range(1, tcfg.n_periods + 1))
    for s in man.degrees:
        assert man.stage_ranges[s] == m.stage_ranges(s)
        for i in range(s):
            assert port_store.stage_bytes(s, i) == m.stage_bytes(s, i)
    assert load_manifest(port_store.tier("local").root).to_json() == \
        man.to_json()


@pytest.mark.parametrize("s", [1, 2, 4])
def test_loader_matches_slice_stage_params(port_store, granite4, s):
    _, _, tcfg, tparams = granite4
    m = Model(tcfg)
    loader = StreamedStageLoader(port_store, FetchSchedule.single(16 * Gbps),
                                 TimingProfile(**T), device="cpu")
    for i in range(s):
        got, rec = loader.load_stage(s, i, worker_id=f"w{s}-{i}")
        _assert_trees_equal(got, m.slice_stage_params(tparams, s, i))
        assert rec.fetched_bytes == port_store.stage_bytes(s, i)


def test_memory_tier_reads_equal_disk(port_store, granite4):
    _, _, tcfg, tparams = granite4
    mem = ModelStore.from_params(Model(tcfg), tparams)
    assert mem.manifest.to_json() == port_store.manifest.to_json()
    for c in mem.manifest.chunks:
        a = mem.read_range(c, 0, c.nbytes)
        b = port_store.read_range(c, 0, c.nbytes)
        assert a.tobytes() == b.tobytes(), c.key
    # a memory-tier read is a view: no param aliases the live tensors
    first = mem.manifest.chunks[0]
    assert mem.read_range(first, 0, first.nbytes).ctypes.data != \
        tparams["blocks"]["slot00"]["mixer"]["norm"].data_ptr()


# ============================================================ cross-check
FLAG_MATRIX = [OverlapFlags(p, st, ov) for p in (False, True)
               for st in (False, True) for ov in (False, True)]


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("flags", FLAG_MATRIX,
                         ids=[f"p{int(f.prefetch)}s{int(f.stream)}"
                              f"o{int(f.overlap_load)}" for f in FLAG_MATRIX])
def test_measured_spans_match_analytic(port_store, flags, s):
    checks = crosscheck_stages(port_store, s, timings=TimingProfile(**T),
                               flags=flags, nic_bytes_per_s=16 * Gbps,
                               load_bytes_per_s=12e9, device="cpu")
    assert len(checks) == s
    assert assert_within(checks) <= 0.05


@pytest.mark.parametrize("s", [1, 2])
def test_loader_timeline_equals_reference(port_store, granite4, tmp_path, s):
    """The same store read by both loaders on one-server schedules: the
    per-stage spans and per-tensor records are equal."""
    from repro.core.coldstart import OverlapFlags as JFlags
    from repro.store import FetchSchedule as JSched
    from repro.store import StreamedStageLoader as JLoader
    jstore = JStore.open(port_store.tier("local").root)
    for i in range(s):
        jl = JLoader(jstore, JSched.single(16 * JGbps), JTimings(**T),
                     JFlags(True, True, True), load_bytes_per_s=12e9)
        tl = StreamedStageLoader(port_store, FetchSchedule.single(16 * Gbps),
                                 TimingProfile(**T), OverlapFlags.all(),
                                 load_bytes_per_s=12e9, device="cpu")
        _, jrec = jl.load_stage(s, i, now=1.5)
        _, trec = tl.load_stage(s, i, now=1.5)
        _assert_spans_close(trec.to_json(), jrec.to_json())
        assert [(a.key, a.nbytes) for a in trec.tensors] == \
            [(a.key, a.nbytes) for a in jrec.tensors]
        for a, b in zip(trec.tensors, jrec.tensors):
            for f in ("fetch_start", "fetch_end", "load_start", "load_end"):
                assert abs(getattr(a, f) - getattr(b, f)) <= SPAN_TOL


def _assert_spans_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k == "spans":
            assert set(g) == set(w)
            for name in w:
                assert all(abs(x - y) <= SPAN_TOL
                           for x, y in zip(g[name], w[name])), name
        elif isinstance(w, float):
            assert abs(g - w) <= SPAN_TOL, k
        elif k == "stages":
            assert len(g) == len(w)
            for a, b in zip(g, w):
                _assert_spans_close(a, b)
        else:
            assert g == w, k


# =============================================== the quickstart, both sides
def _servers(S, gbps, gb, n=4):
    return {f"srv{i}": S(f"srv{i}", 16 * gbps, 12e9, 24 * gb)
            for i in range(n)}


def _quickstart(side, params, *, store_dir=None, cold=False,
                cfgs=None):
    """``examples/quickstart.py`` on one side, ``paged=False`` passed
    explicitly: Alg. 1 cold start to 2 stages, 5 steps, consolidation
    through ``full_params``, run to the end. ``cfgs`` is the (JAX, port)
    pair of configs (default: 4-layer granite)."""
    cfgs = cfgs or _cfgs()
    if side == "jax":
        cfg = cfgs[0]
        front = JFrontend(_servers(JServer, JGbps, JGB))
        prof = JProfile(cfg.name, int(12.5 * JGB), JTimings(),
                        JSLO(ttft=7.5, tpot=0.2))
        sp = JSP
    else:
        cfg = cfgs[1]
        front = ServerlessFrontend(_servers(ServerSpec, Gbps, GB),
                                   device="cpu")
        prof = ModelProfile(cfg.name, int(12.5 * GB), TimingProfile(),
                            SLO(ttft=7.5, tpot=0.2))
        sp = SamplingParams
    store = front.deploy(cfg, None if cold else params, prof,
                         store_dir=store_dir)
    ep = front.cold_start(cfg.name, min_stages=2, max_batch=2, max_seq=64,
                          paged=False)
    req = ep.submit(PROMPT, sp(max_new=12))
    for _ in range(5):
        ep.step()
    before = list(req.generated)
    ep.consolidate(front.full_params(cfg.name))
    ep.run()
    return dict(ep=ep, req=req, before=before, front=front, store=store)


@pytest.fixture(scope="module")
def quickstarts(granite4):
    _, jparams, _, tparams = granite4
    return _quickstart("jax", jparams), _quickstart("port", tparams)


def test_quickstart_scheme_and_stage_bytes_equal_reference(quickstarts):
    j, t = quickstarts
    assert dataclasses.asdict(t["ep"].scheme) == \
        dataclasses.asdict(j["ep"].scheme)
    assert t["ep"].n_stages == 1 and j["ep"].n_stages == 1
    s = t["ep"].cold_start_timeline.s
    assert s == j["ep"].cold_start_timeline.s == 2
    for i in range(s):
        assert t["store"].stage_bytes(s, i) == j["store"].stage_bytes(s, i)
    assert [r.fetched_bytes for r in t["ep"].cold_start_timeline.stages] \
        == [r.fetched_bytes for r in j["ep"].cold_start_timeline.stages]


def test_quickstart_timeline_equals_reference(quickstarts):
    j, t = quickstarts
    _assert_spans_close(t["ep"].cold_start_timeline.to_json(),
                        j["ep"].cold_start_timeline.to_json())
    _assert_spans_close(t["front"].last_full_fetch.to_json(),
                        j["front"].last_full_fetch.to_json())


def test_quickstart_tokens_equal_reference_across_consolidation(
        quickstarts):
    j, t = quickstarts
    assert t["before"] == j["before"] and len(t["before"]) == 6
    assert list(t["req"].generated) == list(j["req"].generated)
    assert len(t["req"].generated) == 12
    assert t["ep"].last_migration_bytes is None
    assert j["ep"].last_migration_bytes is None
    assert t["ep"].last_migration_flow is None
    assert not t["ep"].paged


# ============================================ the quickstart on rwkv6-1.6b
@pytest.fixture(scope="module")
def rwkv_quickstarts():
    """The rwkv smoke variant (2 layers, float32), the same weights on both
    sides, through each side's quickstart."""
    cfgs = _cfgs(n_layers=2, arch="rwkv6-1.6b")
    jparams = jax_model(cfgs[0]).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return (cfgs, jparams, tparams,
            _quickstart("jax", jparams, cfgs=cfgs),
            _quickstart("port", tparams, cfgs=cfgs))


def test_rwkv_quickstart_equals_reference(rwkv_quickstarts):
    """The frontend, the store and the loader are generic over the param
    tree: Alg. 1's scheme, the simulated timeline (to 1e-9 s) and the
    streams across consolidation equal the reference's."""
    _, _, _, j, t = rwkv_quickstarts
    assert dataclasses.asdict(t["ep"].scheme) == \
        dataclasses.asdict(j["ep"].scheme)
    assert t["ep"].cold_start_timeline.s == 2
    _assert_spans_close(t["ep"].cold_start_timeline.to_json(),
                        j["ep"].cold_start_timeline.to_json())
    _assert_spans_close(t["front"].last_full_fetch.to_json(),
                        j["front"].last_full_fetch.to_json())
    assert t["before"] == j["before"] and len(t["before"]) == 6
    assert list(t["req"].generated) == list(j["req"].generated)
    assert len(t["req"].generated) == 12
    assert t["ep"].n_stages == 1 and not t["ep"].paged
    assert t["ep"].last_migration_bytes is None
    assert "wkv" in t["ep"].engine.workers[0].cache["slot00"]


def test_rwkv_stores_cross_load_both_ways(rwkv_quickstarts, tmp_path):
    """Each package's store of the rwkv weights: equal manifests and chunk
    bytes, each read back by the other package, and a cold deploy from the
    other package's store serves the same stream."""
    cfgs, jparams, tparams, j, t = rwkv_quickstarts
    jcfg, tcfg = cfgs
    save_model(str(tmp_path / "port"), Model(tcfg), tparams)
    jax_save(str(tmp_path / "jax"), jax_model(jcfg), jparams)
    assert load_manifest(str(tmp_path / "port")).to_json() == \
        load_manifest(str(tmp_path / "jax")).to_json()
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


# =================================================== stores cross-loaded
def test_reference_store_cold_deployed_by_port(granite4, quickstarts,
                                               tmp_path):
    """A store written by JAX ``save_model`` is cold-deployed
    (``params=None``) by the port: the bytes it reads are the tensors the
    JAX side wrote, and it serves the reference's stream."""
    jcfg, jparams, _, tparams = granite4
    jax_save(str(tmp_path), jax_model(jcfg), jparams)
    port = _quickstart("port", None, store_dir=str(tmp_path), cold=True)
    store = port["store"]
    loader = StreamedStageLoader(store, FetchSchedule.single(16 * Gbps),
                                 device="cpu")
    full, _ = loader.load_stage(1, 0)
    _assert_trees_equal(full, tparams)
    j, _ = quickstarts
    assert list(port["req"].generated) == list(j["req"].generated)


def test_port_store_opened_by_reference(granite4, quickstarts, tmp_path):
    """A store the port wrote is opened by JAX ``ModelStore.open``: every
    chunk reads back the bytes of the JAX params, and a JAX cold deploy
    from it serves the port's stream."""
    jcfg, jparams, tcfg, tparams = granite4
    save_model(str(tmp_path), Model(tcfg), tparams)
    jstore = JStore.open(str(tmp_path))
    want = {tuple(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jparams)[0]}
    for c in jstore.manifest.chunks:
        got = jstore.read_range(c, 0, c.nbytes)
        assert got.tobytes() == want[c.path].tobytes(), c.key
    jax_side = _quickstart("jax", None, store_dir=str(tmp_path), cold=True)
    _, t = quickstarts
    assert list(jax_side["req"].generated) == list(t["req"].generated)


def test_bfloat16_store_cross_reads(tmp_path):
    """bf16 chunks are raw 16-bit words both ways: the port's store reads
    back as the reference's bfloat16 arrays, and the reference's as the
    port's bfloat16 tensors."""
    jcfg, tcfg = _cfgs(n_layers=2, dtype="bfloat16")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(2))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    save_model(str(tmp_path / "port"), Model(tcfg), tparams)
    jax_save(str(tmp_path / "jax"), jax_model(jcfg), jparams)
    jstore = JStore.open(str(tmp_path / "port"))
    c = jstore.manifest.chunks[1]
    a = jstore.read_range(c, 0, c.nbytes)
    assert str(a.dtype) == "bfloat16"
    tstore = ModelStore.open(str(tmp_path / "jax"))
    loader = StreamedStageLoader(tstore, FetchSchedule.single(16 * Gbps),
                                 device="cpu")
    got, _ = loader.load_stage(1, 0)
    _assert_trees_equal(got, tparams)


# ======================================================= frontend details
def test_cold_deploy_needs_a_store(granite4):
    _, _, tcfg, _ = granite4
    front = ServerlessFrontend(_servers(ServerSpec, Gbps, GB), device="cpu")
    with pytest.raises(ValueError, match="cold deploy"):
        front.deploy(tcfg, None, ModelProfile(tcfg.name, GB,
                                              TimingProfile(), SLO(7.5, 0.2)))


def test_concurrent_cold_starts_contend_on_one_server(granite4):
    """Two cold starts begun before either finishes, both forced onto
    srv0: each fetch takes twice its idle time, as in the reference's
    fluid model."""
    _, _, tcfg, tparams = granite4
    front = ServerlessFrontend({"srv0": ServerSpec("srv0", 16 * Gbps, 12e9,
                                                   24 * GB)}, device="cpu")
    names = []
    for i in range(2):
        cfg = dataclasses.replace(tcfg, name=f"m{i}")
        front.deploy(cfg, tparams, ModelProfile(cfg.name, int(0.5 * GB),
                                                TimingProfile(**T),
                                                SLO(60.0, 1.0)))
        names.append(cfg.name)
    pend = [front.begin_cold_start(n, paged=False, max_seq=32)
            for n in names]
    eps = [p.finish() for p in pend]
    nbytes = front.store_of("m0").total_bytes
    idle = nbytes / (16 * Gbps)
    for ep in eps:
        f0, f1 = ep.cold_start_timeline.stages[0].timeline.spans["fetch"]
        assert math.isclose(f1 - f0, 2 * idle, rel_tol=1e-6)


def test_endpoint_and_store_import_without_jax():
    """A fresh interpreter importing the frontend and the store loads no
    module of JAX or of the reference."""
    code = ("import sys\n"
            "import repro_torch.serving.endpoint, repro_torch.store\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
