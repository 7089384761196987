"""The reference's two optional modes in the port, held against the
reference on the CPU: the ``causal_skip`` attention mode with the blocked
oracles it dispatches to, and the ``append`` decode mode with
``decode_attention_with_stats``.

* The three oracles (``flash_attention_blocked``, ``_skip``,
  ``decode_attention_with_stats``) against the reference's on the same
  seeded numpy inputs, float32 to 1e-5; ``ops.flash_attention``'s plain
  path past the 2^20 switch, in both modes, against the reference's
  ``ops.flash_attention`` (``ref`` backend) to 1e-5.
* The ``append`` mode at the smoke configs: decode logits against the
  reference's under ``set_decode_mode("append")`` (1e-4, the tolerance of
  ``tests/test_torch_model.py``), the caches it writes after the layers,
  and greedy streams of the slot-contiguous engine, exactly.
* ``causal_skip``: a prefill of 2,100 tokens (past the switch and one
  2,048-key block) and the greedy stream after it, against the
  reference's under ``set_attention_mode("causal_skip")``, also with the
  ``append`` mode.
* Within the port: ``append`` and ``scatter`` give the same streams and
  caches, exactly; the knobs are read from the environment at import.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.model import build_model as jax_model
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServingEndpoint
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LOGIT_TOL = 1e-4
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [11, 12, 13]]
KW = dict(max_batch=3, max_seq=32, paged=False)


def _qkv(seed, b, sq, sk, hq, hkv, hd):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, hd).astype(np.float32),
            rng.randn(b, sk, hkv, hd).astype(np.float32),
            rng.randn(b, sk, hkv, hd).astype(np.float32))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------

# (causal, q_offset, kv_len or None): Sq 1,100 over Sk = Sq + q_offset, so
# q * k passes 2^20 and the reference's blocks pad both axes
BLOCKED = [(True, 0, None), (True, 64, (1164, 1000)), (False, 0, None),
           (False, 0, (700, 1100))]
BLOCKED_IDS = ["causal", "causal-offset-kvlen", "full", "full-kvlen"]


@pytest.mark.parametrize("causal,q_offset,kv_len", BLOCKED, ids=BLOCKED_IDS)
def test_flash_attention_blocked_matches_reference(causal, q_offset, kv_len):
    arrays = _qkv(0, 2, 1100, 1100 + q_offset, 4, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = jref.flash_attention_blocked(jq, jk, jv, causal=causal,
                                        q_offset=q_offset, kv_len=jl)
    got = ref.flash_attention_blocked(tq, tk, tv, causal=causal,
                                      q_offset=q_offset, kv_len=tl)
    _close(got, want)


# (q_offset, kv_len, q_block, kv_block): small blocks so that query block i
# walks i + 1 (+ offset) key blocks of several, and the defaults
SKIP = [(0, None, 256, 256), (64, (1164, 900), 256, 128),
        (0, None, 2048, 2048), (40, (1140, 1140), 512, 1024)]
SKIP_IDS = ["blocks-256", "offset-kvlen-256x128", "defaults",
            "offset-512x1024"]


@pytest.mark.parametrize("q_offset,kv_len,q_block,kv_block", SKIP,
                         ids=SKIP_IDS)
def test_flash_attention_blocked_skip_matches_reference(q_offset, kv_len,
                                                        q_block, kv_block):
    arrays = _qkv(1, 2, 1100, 1100 + q_offset, 4, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = jref.flash_attention_blocked_skip(
        jq, jk, jv, q_offset=q_offset, kv_len=jl, q_block=q_block,
        kv_block=kv_block)
    got = ref.flash_attention_blocked_skip(
        tq, tk, tv, q_offset=q_offset, kv_len=tl, q_block=q_block,
        kv_block=kv_block)
    _close(got, want)
    # the skip leaves out only fully masked blocks: the masked walk agrees
    full = ref.flash_attention_blocked(tq, tk, tv, causal=True,
                                       q_offset=q_offset, kv_len=tl,
                                       q_block=q_block, kv_block=kv_block)
    _close(got, full.numpy())


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (6, 2)])
def test_decode_attention_with_stats_matches_reference(hq, hkv):
    q, k, v = _qkv(2, 4, 1, 40, hq, hkv, 16)
    kv_len = np.array([40, 17, 0, 1], np.int32)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both([q, k, v, kv_len])
    want = jref.decode_attention_with_stats(jq, jk, jv, jl)
    got = ref.decode_attention_with_stats(tq, tk, tv, tl)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)
    out, m, l = got
    assert torch.all(out[2] == 0) and torch.all(l[2] == 0)
    assert torch.all(m[2] == ref.NEG_INF)
    # normalised, it is the decode oracle
    live = torch.tensor([0, 1, 3])
    _close((out / l[:, None, :, None])[live],
           ref.decode_attention_reference(tq, tk, tv, tl)[live].numpy())


@pytest.fixture
def modes():
    """Both packages' modes, put back after the test."""
    saved = (ops.attention_mode(), ops.decode_mode(),
             jops.attention_mode(), jops.decode_mode())
    yield
    ops.set_attention_mode(saved[0])
    ops.set_decode_mode(saved[1])
    jops.set_attention_mode(saved[2])
    jops.set_decode_mode(saved[3])


@pytest.mark.parametrize("mode", ["masked_full", "causal_skip"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ops_flash_plain_path_matches_reference_dispatch(mode, causal,
                                                         modes):
    """Past the 2^20 switch both packages' CPU paths take the blocked
    oracles, the skip one for a causal call under ``causal_skip``."""
    assert jops.backend() == "ref"
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 1, 1040, 1040, 4, 2, 16))
    assert tq.shape[1] * tk.shape[1] > ops.BLOCKED_PAIRS
    ops.set_attention_mode(mode)
    jops.set_attention_mode(mode)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    _close(got, want)
    expect = (ref.flash_attention_blocked_skip(tq, tk, tv)
              if causal and mode == "causal_skip"
              else ref.flash_attention_blocked(tq, tk, tv, causal=causal))
    assert torch.equal(got, expect)


def test_ops_modes_refuse_unknown_values(modes):
    before = ops.attention_mode(), ops.decode_mode()
    with pytest.raises(ValueError, match="masked_full"):
        ops.set_attention_mode("bogus")
    with pytest.raises(ValueError, match="append"):
        ops.set_decode_mode("bogus")
    # the reference's "paged" picks its engines' layout: Engine(paged=...)
    with pytest.raises(ValueError, match=r"Engine\(paged=\.\.\.\)"):
        ops.set_decode_mode("paged")
    assert ops.DECODE_MODES == tuple(m for m in jops.DECODE_MODES
                                     if m != "paged")
    assert (ops.attention_mode(), ops.decode_mode()) == before


@pytest.mark.parametrize("env,want", [
    ({}, "masked_full scatter"),
    ({"REPRO_ATTN_MODE": "causal_skip", "REPRO_DECODE_MODE": "append"},
     "causal_skip append"),
    ({"REPRO_DECODE_MODE": "bogus"}, "REPRO_DECODE_MODE='bogus'"),
], ids=["defaults", "set", "refused"])
def test_ops_modes_read_the_environment_at_import(env, want, tmp_path):
    base = {k: v for k, v in os.environ.items()
            if k not in ("REPRO_ATTN_MODE", "REPRO_DECODE_MODE")}
    p = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels import ops; "
         "print(ops.attention_mode(), ops.decode_mode())"],
        env={**base, **env, "PYTHONPATH": str(ROOT / "src"),
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)},
        capture_output=True, text=True, timeout=120)
    assert want in (p.stdout + p.stderr)
    assert (p.returncode == 0) == ("bogus" not in str(env))


# ---------------------------------------------------------------------------
# the append decode mode at the smoke configs
# ---------------------------------------------------------------------------


def _models(arch):
    jcfg = smoke(arch)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    # the MoE's no-drop capacity, as conftest.smoke gives the reference
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)),
                               capacity_factor=jcfg.capacity_factor)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def granite():
    return _models("granite-3-8b")


@pytest.fixture(scope="module")
def jamba():
    return _models("jamba-v0.1-52b")


def _arch(request, name):
    return request.getfixturevalue(
        "granite" if name == "granite-3-8b" else "jamba")


def _kv_leaves(cache):
    return {(slot, leaf): a for slot, sub in cache.items()
            for leaf, a in sub.items() if leaf in ("k", "v")}


@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-v0.1-52b"])
def test_append_decode_logits_and_cache_match_reference(arch, request,
                                                        modes):
    jcfg, jparams, tcfg, tparams = _arch(request, arch)
    rng = np.random.RandomState(4)
    b, s, steps = 2, 9, 4
    tokens = rng.randint(0, jcfg.vocab, (b, s)).astype(np.int32)
    jm, tm = jax_model(jcfg), Model(tcfg)
    jops.set_decode_mode("append")
    ops.set_decode_mode("append")
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                            max_seq=s + steps)
    tl, tcache = tm.prefill(tparams, torch.from_numpy(tokens),
                            max_seq=s + steps, paged=False)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).reshape(b, 1).astype(np.int32)
        assert np.array_equal(tok, tl.argmax(-1).reshape(b, 1).numpy())
        pos = np.full((b, 1), s + i, np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        _close(tl, np.asarray(jl).reshape(tl.shape), LOGIT_TOL)
    jkv = {k: np.asarray(v) for k, v in _kv_leaves(jcache).items()}
    tkv = _kv_leaves(tcache)
    assert jkv.keys() == tkv.keys() and tkv
    for key, a in tkv.items():
        _close(a, jkv[key], TOL)


def _jax_streams(jcfg, jparams, max_new, prompts, **kw):
    eng = JEngine(jcfg, [jparams], **{**KW, **kw})
    reqs = [eng.submit(p, JSP(max_new=max_new)) for p in prompts]
    eng.run()
    return [list(r.generated) for r in reqs]


def _port_streams(tcfg, params, max_new, prompts, stages=1, **kw):
    model = Model(tcfg)
    sp = ([params] if stages == 1 else
          [model.slice_stage_params(params, stages, i)
           for i in range(stages)])
    ep = ServingEndpoint(Engine(tcfg, sp, device="cpu", **{**KW, **kw}))
    reqs = [ep.submit(p, SamplingParams(max_new=max_new)) for p in prompts]
    while ep.has_work():
        if stages > 1 and ep.n_stages > 1 and all(
                len(r.generated) >= 3 for r in reqs):
            ep.consolidate(params)
        ep.step()
    return [list(r.generated) for r in reqs], ep.engine


@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-v0.1-52b"])
def test_append_greedy_streams_equal_reference(arch, request, modes):
    jcfg, jparams, tcfg, tparams = _arch(request, arch)
    jops.set_decode_mode("append")
    ops.set_decode_mode("append")
    want = _jax_streams(jcfg, jparams, 8, PROMPTS)
    got, _ = _port_streams(tcfg, tparams, 8, PROMPTS)
    assert got == want


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-v0.1-52b"])
def test_append_equals_scatter_within_the_port(arch, stages, request,
                                               modes):
    """The port writes its caches in place, so the mode moves no token and
    leaves the same strips: held here, not assumed."""
    _, _, tcfg, tparams = _arch(request, arch)
    out = {}
    for mode in ("scatter", "append"):
        ops.set_decode_mode(mode)
        out[mode] = _port_streams(tcfg, tparams, 8, PROMPTS, stages=stages)
    (s_streams, s_eng), (a_streams, a_eng) = out["scatter"], out["append"]
    assert a_streams == s_streams
    assert all(len(s) == 8 for s in s_streams)
    s_kv = _kv_leaves(s_eng.workers[0].cache)
    a_kv = _kv_leaves(a_eng.workers[0].cache)
    assert s_kv.keys() == a_kv.keys() and s_kv
    for key, a in a_kv.items():
        assert torch.equal(a, s_kv[key]), key


def test_append_on_an_empty_history(granite, modes):
    """pos 0: no earlier row; the merge reduces to the token attending
    itself (the stats' l = 0 edge)."""
    _, _, tcfg, tparams = granite
    m = Model(tcfg)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    logits, caches = {}, {}
    for mode in ("append", "scatter"):
        ops.set_decode_mode(mode)
        logits[mode], caches[mode] = m.decode_step(
            tparams, m.init_cache(2, 8, device="cpu"), tok, pos)
    assert torch.isfinite(logits["append"]).all()
    _close(logits["append"], logits["scatter"].numpy(), LOGIT_TOL)
    k = caches["append"]["slot00"]["k"]
    assert torch.equal(k, caches["scatter"]["slot00"]["k"])
    assert k[:, :, 0].abs().sum() > 0 and k[:, :, 1:].abs().sum() == 0


# ---------------------------------------------------------------------------
# causal_skip at a prefill past the switch
# ---------------------------------------------------------------------------

LONG = 2100     # past the switch, and past one 2,048-key block of the skip


@pytest.mark.parametrize("attn_mode,decode_mode", [
    ("masked_full", "scatter"), ("causal_skip", "scatter"),
    ("causal_skip", "append")])
def test_long_prefill_and_stream_match_reference(granite, attn_mode,
                                                 decode_mode, modes):
    jcfg, jparams, tcfg, tparams = granite
    prompt = np.random.RandomState(5).randint(0, jcfg.vocab, LONG).tolist()
    ops.set_attention_mode(attn_mode)
    jops.set_attention_mode(attn_mode)
    ops.set_decode_mode(decode_mode)
    jops.set_decode_mode(decode_mode)
    jl, _ = jax_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray([prompt], jnp.int32)},
        max_seq=LONG + 4)
    tl, _ = Model(tcfg).prefill(tparams, torch.tensor([prompt]),
                                max_seq=LONG + 4, paged=False)
    _close(tl, np.asarray(jl).reshape(tl.shape), LOGIT_TOL)
    kw = dict(max_batch=1, max_seq=LONG + 8)
    want = _jax_streams(jcfg, jparams, 4, [prompt], **kw)
    got, _ = _port_streams(tcfg, tparams, 4, [prompt], **kw)
    assert got == want
