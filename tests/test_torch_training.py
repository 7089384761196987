"""The port's training (``repro_torch.training``, ``Model.loss``) on the
CPU: the reference's ``tests/test_training.py`` mirrored at its tiny config
(the loss falls, bf16 compression still learns, remat gives the same
gradients, a checkpoint resume is bit-exact, the ZeRO-1 specs divide), and
the port held against the reference on the same params (the JAX
``init(PRNGKey(0))``, converted) and the same ``SyntheticTokens`` batch.

Tolerances, float32: ``Model.loss`` to 1e-5 relative; every gradient leaf
to 1e-4 of that leaf's largest |value| (the products and reductions add in
another order); ``apply_updates`` on identical gradients to 1e-6 relative
of each leaf's largest |value| (the same float32 formula, one fused
reduction for the norm); the params after one whole train step to
2·lr₁ + 1e-6 absolute, lr₁ the schedule's lr at step 1: AdamW's first step
moves each component by about sign(g)·lr₁, so a component whose gradient
is near 0 may move the other way in the other framework. ``SyntheticTokens``
batches equal the reference's exactly (the same numpy generator). Remat
variants agree to 1e-5 absolute, as the reference's test holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs import get_config as jget
from repro.models.model import build_model as jax_model
from repro.training import optimizer as jopt
from repro.training.data import SyntheticTokens as JTokens
from repro.training.train_step import make_train_step as jmake_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticTokens
from repro_torch.training.train_step import (loss_and_grads,
                                             make_eval_step,
                                             make_train_step)

CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                  dtype="float32")

FAMILIES = {"dense": "granite-3-8b", "moe": "qwen2-moe-a2.7b",
            "vlm": "llava-next-34b", "encdec": "whisper-small",
            "rwkv": "rwkv6-1.6b", "hybrid": "jamba-v0.1-52b"}

LOSS_REL = 1e-5
GRAD_REL = 1e-4
UPDATE_REL = 1e-6


def _init(seed=0):
    model = Model(CFG)
    return model, model.init(torch.Generator().manual_seed(seed),
                             device="cpu")


def _pair(name):
    """The reference's smoke config (the serving one: MoE without drops) and
    the port's copy, the JAX init's params on both sides."""
    jcfg = smoke(name)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# mirrors of tests/test_training.py
# ---------------------------------------------------------------------------


def test_loss_decreases():
    model, params = _init()
    state = opt.init_state(params)
    step = make_train_step(
        model, opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60),
        remat="none", grad_dtype=None)
    data = iter(SyntheticTokens(CFG, 4, 32, seed=0))
    first = None
    for _ in range(40):
        params, state, metrics = step(params, state, next(data))
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < 0.7 * first


def test_bf16_grad_compression_still_learns():
    model, params = _init()
    state = opt.init_state(params)
    step = make_train_step(
        model, opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60),
        remat="none", grad_dtype="bfloat16")
    data = iter(SyntheticTokens(CFG, 4, 32, seed=0))
    first = None
    for _ in range(30):
        params, state, metrics = step(params, state, next(data))
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < 0.8 * first


def test_remat_matches_no_remat():
    model, params = _init(1)
    batch = next(iter(SyntheticTokens(CFG, 2, 16, seed=1)))
    _, _, g1 = loss_and_grads(model, params, batch, remat="none")
    for remat in ("full", "dots"):
        _, _, g2 = loss_and_grads(model, params, batch, remat=remat)
        for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
            assert float((a - b).abs().max()) < 1e-5, remat


def test_checkpoint_resume_bitexact(tmp_path):
    model, params = _init()
    state = opt.init_state(params)
    step = make_train_step(model, opt.AdamWConfig(lr=1e-3), remat="none",
                           grad_dtype=None)
    data = list(SyntheticTokens(CFG, 2, 16, seed=2).__next__()
                for _ in range(6))
    # straight run
    p1, s1 = params, state
    for b in data:
        p1, s1, _ = step(p1, s1, b)
    # run with save/restore in the middle
    mgr = CheckpointManager(str(tmp_path))
    p2, s2 = params, state
    for b in data[:3]:
        p2, s2, _ = step(p2, s2, b)
    mgr.save(3, (p2, s2))
    (p2, s2), _ = mgr.restore((p2, s2))
    for b in data[3:]:
        p2, s2, _ = step(p2, s2, b)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert float((a - b).abs().max()) == 0.0
    assert int(s2["step"]) == 6


def test_zero1_state_specs_divisible():
    """Every ZeRO-1 sharded dim must divide 32 (pod x data)."""
    for arch in ("granite-3-8b", "grok-1-314b", "jamba-v0.1-52b"):
        model = Model(get_config(arch))
        specs = opt.state_specs(model.defs, zero1=True)
        defs, mu = tree_leaves(model.defs), tree_leaves(specs["mu"])
        assert len(defs) == len(mu)
        for d, s in zip(defs, mu):
            parts = list(s) + [None] * (len(d.shape) - len(s))
            for dim, part in zip(d.shape, parts):
                names = () if part is None else (
                    (part,) if isinstance(part, str) else part)
                if "data" in names or "pod" in names:
                    assert dim % 32 == 0, (arch, d.shape, s)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-8b", "llava-next-34b",
                                  "whisper-small", "qwen2-moe-a2.7b"])
def test_synthetic_tokens_equal_reference(arch):
    jcfg = smoke(arch)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    j, t = iter(JTokens(jcfg, 3, 17, seed=5)), iter(SyntheticTokens(
        tcfg, 3, 17, seed=5))
    for _ in range(3):
        a, b = next(j), next(t)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_reference(family):
    """``Model.loss`` and every gradient leaf on the reference's params and
    batch; the port with remat (``"full"``), the reference without (the
    remat variants give the same gradients)."""
    jcfg, jparams, tcfg, tparams = _pair(FAMILIES[family])
    batch = next(iter(JTokens(jcfg, 2, 12, seed=3)))
    jm = jax_model(jcfg)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jparams)
    tl, tmet, tg = loss_and_grads(Model(tcfg), tparams, batch, remat="full")
    _close(float(tl), float(jl), LOSS_REL, "loss")
    _close(float(tmet["ce"]), float(jmet["ce"]), LOSS_REL, "ce")
    if family in ("moe", "hybrid"):
        assert float(jmet["aux"]) > 0
        _close(float(tmet["aux"]), float(jmet["aux"]), LOSS_REL, "aux")
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape), path
        _close(b.numpy(), np.asarray(a), GRAD_REL, jax.tree_util.keystr(path))


def test_apply_updates_matches_reference():
    jcfg, jparams, tcfg, tparams = _pair("granite-3-8b")
    rng = np.random.RandomState(0)
    jgrads = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 0.05).astype(np.float32), jparams)
    tgrads = params_from_numpy(jgrads, "cpu")
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, grad_clip=1.0)
    jstate, tstate = jopt.init_state(jparams), opt.init_state(tparams)
    jp, tp = jparams, tparams
    for _ in range(4):       # warmup, then the cosine; the clip engages
        jp, jstate, jm = jopt.apply_updates(jopt.AdamWConfig(**cfg), jp,
                                            jgrads, jstate)
        tp, tstate, tm = opt.apply_updates(opt.AdamWConfig(**cfg), tp,
                                           tgrads, tstate)
        _close(float(tm["lr"]), float(jm["lr"]), UPDATE_REL, "lr")
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]), UPDATE_REL,
               "grad_norm")
    assert float(jm["grad_norm"]) > 1.0
    for tree_j, tree_t in ((jp, tp), (jstate["mu"], tstate["mu"]),
                           (jstate["nu"], tstate["nu"])):
        for a, b in zip(jax.tree.leaves(tree_j), tree_leaves(tree_t)):
            _close(b.numpy(), np.asarray(a), UPDATE_REL)
    assert int(tstate["step"]) == int(jstate["step"]) == 4


@pytest.mark.parametrize("grad_dtype", [None, "bfloat16"])
def test_train_step_matches_reference(grad_dtype):
    jcfg, jparams, tcfg, tparams = _pair("granite-3-8b")
    acfg = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    batch = next(iter(JTokens(jcfg, 2, 12, seed=4)))
    jstep = jmake_train_step(jax_model(jcfg), jopt.AdamWConfig(**acfg),
                             remat="none", grad_dtype=grad_dtype)
    tstep = make_train_step(Model(tcfg), opt.AdamWConfig(**acfg),
                            remat="dots", grad_dtype=grad_dtype)
    jp, _, jm = jstep(jparams, jopt.init_state(jparams), batch)
    tp, ts, tm = tstep(tparams, opt.init_state(tparams), batch)
    lr1 = float(opt._schedule(opt.AdamWConfig(**acfg),
                              torch.tensor(1, dtype=torch.int32)))
    assert lr1 == pytest.approx(5e-4)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert float(np.abs(b.numpy() - np.asarray(a)).max()) <= \
            2 * lr1 + 1e-6
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        _close(float(tm[k]), float(jm[k]), GRAD_REL, k)
    assert int(ts["step"]) == 1
    # the caller's params and state are left as they were
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tparams), tree_leaves(params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu"))))


def test_eval_step_matches_loss():
    jcfg, jparams, tcfg, tparams = _pair("granite-3-8b")
    batch = next(iter(JTokens(jcfg, 2, 12, seed=6)))
    out = make_eval_step(Model(tcfg))(tparams, batch)
    jl, _ = jax_model(jcfg).loss(jparams, batch)
    _close(float(out["loss"]), float(jl), LOSS_REL)
    assert not out["loss"].requires_grad


def test_remat_refuses_a_cache_and_unknown_modes():
    from repro_torch.models import transformer
    model, params = _init()
    x = torch.zeros(1, 3, CFG.d_model)
    pos = torch.arange(3, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="remat"):
        transformer.run_blocks(CFG, params["blocks"], x, pos, remat="some")
    cache = transformer.init_cache(CFG, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="no cache"):
        transformer.run_blocks(CFG, params["blocks"], x, pos, cache=cache,
                               remat="full")


def test_input_structs_and_dummy_inputs():
    for arch in ("llava-next-34b", "whisper-small", "granite-3-8b"):
        jcfg = smoke(arch)
        tm, jm = Model(ModelConfig(**dataclasses.asdict(jcfg))), \
            jax_model(jcfg)
        ts, js = tm.input_structs(2, 9), jm.input_structs(2, 9)
        assert sorted(ts) == sorted(js)
        for k in js:
            assert tuple(ts[k].shape) == tuple(js[k].shape)
            assert ts[k].device.type == "meta"
            assert str(ts[k].dtype).split(".")[-1] == \
                str(jnp.dtype(js[k].dtype))
        d = tm.dummy_inputs(torch.Generator().manual_seed(0), 2, 9)
        assert {k: tuple(v.shape) for k, v in d.items()} == \
            {k: tuple(v.shape) for k, v in ts.items()}
        assert int(d["tokens"].max()) < jcfg.vocab
        loss, _ = tm.loss(tm.init(torch.Generator().manual_seed(0),
                                  device="cpu"), d)
        assert bool(torch.isfinite(loss))


def test_model_specs_equal_reference():
    from repro.distributed.sharding import use_mesh as juse_mesh
    from repro_torch.distributed.sharding import use_mesh
    for arch in ("granite-3-8b", "jamba-v0.1-52b", "whisper-small"):
        jm, tm = jax_model(jget(arch)), Model(get_config(arch))
        rules = {"act_seq": "model", "kv_seq": "model"}
        for r in (None, rules):
            with juse_mesh(None, r), use_mesh(None, r):
                js = jax.tree.leaves(jm.specs(),
                                     is_leaf=lambda x: x is None or
                                     type(x).__name__ == "PartitionSpec")
                ts = tree_leaves(tm.specs())
            assert [tuple(s) for s in js] == [tuple(s) for s in ts], arch


def test_train_small_twin_runs_then_resumes(tmp_path, capsys):
    """The twin's 3 steps on the CPU (a short batch), then a second call
    resumes from its checkpoint at step 3 and runs steps 3 and 4."""
    from repro_torch.examples import train_small
    kw = dict(batch=2, seq=16, device="cpu", ckpt_dir=str(tmp_path / "ck"))
    first = train_small.main(steps=3, fresh=True, **kw)
    assert sorted(first) == [0, 1, 2]
    assert float(first[2]["loss"]) < float(first[0]["loss"])
    second = train_small.main(steps=5, **kw)
    out = capsys.readouterr().out
    assert "restored checkpoint at step 3" in out
    assert sorted(second) == [3, 4]
    assert all(bool(torch.isfinite(m["loss"])) for m in second.values())
    assert train_small.CKPT_DIR != "/tmp/repro_train_small"
