"""The port's encoder-decoder (whisper-small's smoke variant: 2 encoder
and 2 decoder layers, d 64, 4 q / 2 kv heads of 16, 8 frames, learned
positions) held against the reference on the CPU, on the same weights
(``convert.params_from_numpy`` of the JAX init) and inputs drawn from a
numpy seed, in float32.

Tolerances: ``encode``'s memory, ``precompute_cross_kv``'s K/V, one
layer's ``cross_attention`` and the prefill and decode logits agree with
the reference's to 1e-5 of their largest |value| (the same products in
another library; the sums run in another order); a prefill then a decode
step gives the full decoder forward's logits to 1e-5 of theirs (the
reference's ``test_consistency.py`` holds its own to 2e-3); stage bytes
and stage slices are equal exactly, and the chunked store carries every
leaf bit for bit both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.model import build_model as jax_model
from repro.serving.engine import Engine as JEngine
from repro.store import ModelStore as JStore
from repro.store import save_model as jax_save
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.core import Gbps
from repro_torch.models import attention as tattn
from repro_torch.models import encdec
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.worker import StageWorker
from repro_torch.store import (FetchSchedule, ModelStore,
                               StreamedStageLoader, load_manifest,
                               save_model)
from test_torch_coldstart import _assert_trees_equal

ARCH = "whisper-small"
REL = 1e-5
B, S = 2, 10


def _close(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


def _cfgs(**overrides):
    jcfg = smoke(ARCH, **overrides)
    tcfg = dataclasses.replace(smoke_variant(get_config(ARCH)), **overrides)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _pair(**overrides):
    jcfg, tcfg = _cfgs(**overrides)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def whisper():
    return _pair()


def _inputs(cfg, seed=0, seq=S):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, seq)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model))
              * 0.02).astype(np.float32)
    return toks, frames


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_defs_match_reference(whisper):
    """The port's ParamDef tree has the reference's keys, shapes, axes and
    init rules, and the stage defs split it alike."""
    jcfg, _, tcfg, _ = whisper
    jm, tm = jax_model(jcfg), Model(tcfg)

    def flat(defs):
        return {p: (tuple(d.shape), tuple(d.axes), d.init, d.scale)
                for p, d in jax.tree_util.tree_flatten_with_path(
                    defs, is_leaf=lambda x: hasattr(x, "axes"))[0]}

    assert set(tm.defs) == {"embed", "encoder", "enc_final_norm", "blocks",
                            "final_norm", "lm_head"}
    assert flat(tm.defs) == flat(jm.defs)
    assert tm.bytes() == jm.bytes()


def test_encode_matches_reference(whisper):
    jcfg, jparams, tcfg, tparams = whisper
    _, frames = _inputs(tcfg)
    want = jencdec.encode(jcfg, jparams, jnp.asarray(frames))
    got = encdec.encode(tcfg, tparams, torch.from_numpy(frames))
    assert got.shape == (B, tcfg.n_audio_frames, tcfg.d_model)
    _close(got.numpy(), want)


def test_precompute_cross_kv_matches_reference(whisper):
    jcfg, jparams, tcfg, tparams = whisper
    _, frames = _inputs(tcfg, seed=1)
    mem = np.array(jencdec.encode(jcfg, jparams, jnp.asarray(frames)))
    want = jencdec.precompute_cross_kv(jcfg, jparams, jnp.asarray(mem))
    got = encdec.precompute_cross_kv(tcfg, tparams, torch.from_numpy(mem))
    shp = (tcfg.n_layers, B, tcfg.n_audio_frames, tcfg.n_kv_heads,
           tcfg.head_dim)
    for leaf in ("k", "v"):
        assert tuple(got[leaf].shape) == shp
        _close(got[leaf].numpy(), want[leaf])


@pytest.mark.parametrize("sq", [S, 1], ids=["chunk", "decode_row"])
def test_cross_attention_matches_reference(whisper, sq):
    """One decoder layer's cross-attention (Sq = a chunk, or 1 as at a
    decode step, over Sk = the frames) over precomputed memory K/V."""
    jcfg, jparams, tcfg, tparams = whisper
    rng = np.random.RandomState(2)
    x = rng.standard_normal((B, sq, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, tcfg.n_audio_frames,
                               tcfg.d_model)).astype(np.float32)
    jp = _layer(jparams["blocks"], 1)["cross"]
    tp = {k: v[1] for k, v in tparams["blocks"]["cross"].items()}
    jk, jv = jattn.precompute_cross_kv(jcfg, jp, jnp.asarray(mem))
    tk, tv = tattn.precompute_cross_kv(tcfg, tp, torch.from_numpy(mem))
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)
    want = jattn.cross_attention(jcfg, jp, jnp.asarray(x), mem_kv=(jk, jv))
    got = tattn.cross_attention(tcfg, tp, torch.from_numpy(x), (tk, tv))
    assert got.shape == (B, sq, tcfg.d_model)
    _close(got.numpy(), want)


@pytest.fixture()
def prefilled(whisper):
    jcfg, jparams, tcfg, tparams = whisper
    toks, frames = _inputs(tcfg, seed=3)
    jl, jcache = jax_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
        max_seq=S + 8)
    tl, tcache = Model(tcfg).prefill(tparams, torch.from_numpy(toks), S + 8,
                                     frames=torch.from_numpy(frames),
                                     paged=False)
    return toks, frames, jl, jcache, tl, tcache


def test_prefill_matches_reference(whisper, prefilled):
    """Prefill logits and both caches: the decoder's self-attention slabs
    (rows [0, S) written, the rest zero) and the encoder memory's K/V."""
    _, _, tcfg, _ = whisper
    _, _, jl, jcache, tl, tcache = prefilled
    assert tl.shape == (B, tcfg.padded_vocab)
    _close(tl.numpy(), jl)
    assert set(tcache) == {"self", "cross"}
    for part in ("self", "cross"):
        for leaf in ("k", "v"):
            want = np.asarray(jcache[part][leaf])
            assert tuple(tcache[part][leaf].shape) == want.shape
            _close(tcache[part][leaf].numpy(), want)


def test_decode_steps_match_reference(whisper, prefilled):
    """Four greedy decode steps after the prefill: each step's logits to
    1e-5 of the reference's, and the same tokens chosen."""
    jcfg, jparams, tcfg, tparams = whisper
    _, _, jl, jcache, tl, tcache = prefilled
    jm, tm = jax_model(jcfg), Model(tcfg)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for n in range(4):
        pos = np.full((B, 1), S + n, np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        _close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert (tl.argmax(-1).numpy() == tok[:, 0]).all()


def test_decode_matches_full_forward(whisper):
    """``test_consistency.py``'s whisper case on the port: a prefill of S
    tokens then one decode step at position S gives the logits of one
    decoder forward over S + 1 tokens at its last row."""
    _, _, tcfg, tparams = whisper
    toks, frames = _inputs(tcfg, seed=4, seq=S + 1)
    tm = Model(tcfg)
    t = torch.from_numpy(toks)
    f = torch.from_numpy(frames)
    mem = encdec.encode(tcfg, tparams, f)
    ckv = encdec.precompute_cross_kv(tcfg, tparams, mem)
    pos = torch.arange(S + 1, dtype=torch.int32)[None].expand(B, S + 1)
    h, _ = encdec.decoder(tcfg, tparams, t, pos, cross_kv=ckv)
    full = encdec.head(tcfg, tparams, h)[:, S]
    _, cache = tm.prefill(tparams, t[:, :S], S + 4, frames=f, paged=False)
    dec, _ = tm.decode_step(tparams, cache, t[:, S:S + 1],
                            torch.full((B, 1), S, dtype=torch.int32))
    _close(dec.numpy(), full.numpy())


@pytest.mark.parametrize("n_stages", [1, 2])
def test_stage_bytes_and_slices_match_reference(whisper, n_stages):
    """Stage 0 fetches the embeddings and the whole encoder, the last stage
    the head; the stage slices are the reference's, leaf for leaf, and
    views of the full weights."""
    jcfg, jparams, tcfg, tparams = whisper
    jm, tm = jax_model(jcfg), Model(tcfg)
    assert sum(tm.stage_bytes(n_stages, i) for i in range(n_stages)) \
        == tm.bytes()
    for i in range(n_stages):
        assert tm.stage_bytes(n_stages, i) == jm.stage_bytes(n_stages, i)
        got = tm.slice_stage_params(tparams, n_stages, i)
        want = jm.slice_stage_params(jparams, n_stages, i)
        _assert_trees_equal(got, params_from_numpy(
            jax.tree.map(np.asarray, want), "cpu"))
        if i == 0:
            assert got["encoder"]["attn"]["w_q"].data_ptr() == \
                tparams["encoder"]["attn"]["w_q"].data_ptr()
        else:
            assert "encoder" not in got and "enc_final_norm" not in got


def test_store_cross_loads_whisper_both_ways(whisper, tmp_path):
    """Each package's store of the whisper weights: equal manifests and
    chunk bytes, each read back by the other package, and the port's
    loader restores the reference's store leaf for leaf at 1 and 2
    stages."""
    jcfg, jparams, tcfg, tparams = whisper
    save_model(str(tmp_path / "port"), Model(tcfg), tparams)
    jax_save(str(tmp_path / "jax"), jax_model(jcfg), jparams)
    assert load_manifest(str(tmp_path / "port")).to_json() == \
        load_manifest(str(tmp_path / "jax")).to_json()
    jstore = JStore.open(str(tmp_path / "port"))
    want = {tuple(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jparams)[0]}
    assert {c.path for c in jstore.manifest.chunks} == set(want)
    for c in jstore.manifest.chunks:
        assert jstore.read_range(c, 0, c.nbytes).tobytes() == \
            want[c.path].tobytes(), c.key
    tstore = ModelStore.open(str(tmp_path / "jax"))
    loader = StreamedStageLoader(tstore, FetchSchedule.single(16 * Gbps),
                                 device="cpu")
    full, _ = loader.load_stage(1, 0)
    _assert_trees_equal(full, tparams)
    for i in range(2):
        stage, _ = loader.load_stage(2, i)
        _assert_trees_equal(stage, Model(tcfg).slice_stage_params(
            tparams, 2, i))


def test_paged_prefill_and_engine_refuse_encdec(whisper):
    """No paged encoder-decoder exists in the reference: ``paged=True``
    raises. No engine serves whisper: the reference's refuses it past one
    stage (``StageWorker``: "enc-dec serves single-worker") and at one
    stage builds, takes the request and fails at its first prefill (its
    worker runs the decoder-only blocks over whisper's ``self``/``cross``
    blocks: ``KeyError: 'slot00'``); the port refuses it at both, with a
    ``ValueError`` at construction."""
    jcfg, jparams, tcfg, tparams = whisper
    toks, frames = _inputs(tcfg)
    with pytest.raises(ValueError, match="slot-contiguous"):
        Model(tcfg).prefill(tparams, torch.from_numpy(toks), S + 4,
                            frames=torch.from_numpy(frames))
    with pytest.raises(ValueError, match="frames"):
        Model(tcfg).prefill(tparams, torch.from_numpy(toks), S + 4,
                            paged=False)
    jeng = JEngine(jcfg, [jparams], max_batch=2, max_seq=32)
    jeng.submit([1, 2, 3], 2)
    with pytest.raises(KeyError, match="slot00"):
        jeng.run()
    tm = Model(tcfg)
    for paged in (False, True):
        with pytest.raises(ValueError, match="encoder-decoder"):
            Engine(tcfg, [tparams], max_batch=2, max_seq=32, paged=paged,
                   device="cpu")
    stages = [tm.slice_stage_params(tparams, 2, i) for i in range(2)]
    with pytest.raises(ValueError, match="single-worker"):
        Engine(tcfg, stages, max_batch=2, max_seq=32, paged=False,
               device="cpu")
    with pytest.raises(ValueError, match="single-worker"):
        StageWorker(tcfg, stages[0], 2, 0, 2, 32, paged=False, device="cpu")


def test_padded_vocab_is_masked():
    """``test_models_smoke.py``'s padded-vocab check, at a vocabulary that
    pads (500 of 512 rows): the pad logits are -1e30 after the prefill and
    a decode step, on both packages, and never win the argmax."""
    jcfg, jparams, tcfg, tparams = _pair(vocab=500)
    assert tcfg.padded_vocab == 512
    toks, frames = _inputs(tcfg, seed=5, seq=12)
    jl, jcache = jax_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
        max_seq=20)
    tl, tcache = Model(tcfg).prefill(tparams, torch.from_numpy(toks), 20,
                                     frames=torch.from_numpy(frames),
                                     paged=False)
    tok = tl.argmax(-1)[:, None].to(torch.int32)
    tl2, _ = Model(tcfg).decode_step(tparams, tcache, tok,
                                     torch.full((B, 1), 12, dtype=torch.int32))
    jl2, _ = jax_model(jcfg).decode_step(
        jparams, jcache, jnp.asarray(tok.numpy()),
        jnp.full((B, 1), 12, jnp.int32))
    for got, want in ((tl, jl), (tl2, jl2)):
        assert got.shape == (B, 512)
        assert bool(torch.isfinite(got).all())
        assert (got[:, 500:] == -1e30).all()
        assert int(got.argmax(-1).max()) < tcfg.vocab
        _close(got[:, :500].numpy(), np.asarray(want)[:, :500])

