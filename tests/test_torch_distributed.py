"""The port's distributed prefills (``repro_torch.distributed.manual_tp``,
``pp_spmd``) on ``torch.distributed`` with gloo on the CPU, held against
the reference's ``shard_map`` programs on the same params (the JAX
``init(PRNGKey(0))``, converted) and the same tokens (numpy, seeded).

One rank (tp 1, one stage) runs in this process on a one-rank gloo group,
beside the reference on a one-device mesh. Two ranks (tp 2, two stages)
run as two port processes on a gloo group over a ``FileStore``, and the
reference's side in a subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``); both write numpy
files. Every process has a time limit and is killed after it; each group
times out in 60 s.

Tolerance: float32 smoke configs; logits and each manual-TP K/V layer
within 1e-4 of their largest |value| (sums in another order, float32).
"""

import dataclasses
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import smoke
from repro.configs import list_configs as jlist
from repro.distributed import manual_tp as jtp
from repro.distributed import pp_spmd as jpp
from repro.models.model import build_model as jax_model
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import manual_tp, pp_spmd
from repro_torch.models.model import Model

REL = 1e-4
B, S = 4, 32
TP_ARCHS = ["granite-3-8b", "qwen1.5-32b"]          # qwen1.5 has qkv_bias
PP_CASES = [("granite-3-8b", 2), ("granite-3-8b", 4),
            ("qwen2-moe-a2.7b", 2), ("llava-next-34b", 2)]
ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 180


def _cfgs(arch):
    jcfg = smoke(arch)
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)),
                               capacity_factor=jcfg.capacity_factor)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _tokens(cfg):
    return np.random.default_rng(7).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)


def _jparams(jcfg):
    return jax.tree.map(np.asarray, jax_model(jcfg).init(
        jax.random.PRNGKey(0)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _unflat(flat):
    out = {}
    for key, a in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= REL * np.max(np.abs(want)), (what, err)


# ---------------------------------------------------------------------------
# the reference's runs
# ---------------------------------------------------------------------------


def _jmesh(shape, names):
    """A mesh of ``Auto`` axes: on JAX 0.9's default ``Explicit`` axes the
    reference's pipeline refuses its GQA ``jnp.repeat``."""
    from jax.sharding import AxisType
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(
        shape))


def reference_tp(arch, tp):
    """The reference's manual-TP prefill on a (1, tp) mesh, jitted with its
    shardings (its ``shard_map`` refuses an eager call on JAX 0.9's
    meshes): logits (B, V) and the cache {"k", "v"} (L, B, S, Hkv, hd), as
    numpy."""
    jcfg, _ = _cfgs(arch)
    mesh = _jmesh((1, tp), ("data", "model"))
    fn, _, in_sh, out_sh, _ = jtp.make_manual_prefill(jcfg, mesh, B, S,
                                                      tp=tp)
    logits, cache = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
        _jparams(jcfg), _tokens(jcfg))
    return np.asarray(logits), {k: np.asarray(v) for k, v in cache.items()}


def reference_pp(arch, n_stages, n_micro):
    jcfg, _ = _cfgs(arch)
    mesh = _jmesh((n_stages, 1, 1), ("stage", "data", "model"))
    fn, _, in_sh, out_sh, _ = jpp.make_pp_prefill(
        jcfg, mesh, B, S, n_stages=n_stages, n_micro=n_micro)
    return np.asarray(jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
        _jparams(jcfg), _tokens(jcfg)))


def _reference_main(out_dir):
    """Every two-rank case of the reference, into ``out_dir``."""
    out = {}
    for arch in TP_ARCHS:
        logits, cache = reference_tp(arch, 2)
        out[f"tp/{arch}/logits"] = logits
        out[f"tp/{arch}/k"], out[f"tp/{arch}/v"] = cache["k"], cache["v"]
    for arch, n_micro in PP_CASES:
        out[f"pp/{arch}/{n_micro}"] = reference_pp(arch, 2, n_micro)
    np.savez(os.path.join(out_dir, "reference.npz"), **out)


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------


def port_tp(arch, tp, rank, params):
    from torch.distributed.device_mesh import init_device_mesh
    _, tcfg = _cfgs(arch)
    mesh = init_device_mesh("cpu", (1, tp), mesh_dim_names=("data", "model"))
    fn = manual_tp.make_manual_prefill(tcfg, mesh, B, S, tp=tp)[0]
    with torch.no_grad():
        logits, cache = fn(manual_tp.shard_params(tcfg, params, rank, tp),
                           torch.from_numpy(_tokens(tcfg)))
    return logits.numpy(), {k: v.numpy() for k, v in cache.items()}


def port_pp(arch, n_stages, n_micro, stage, params):
    from torch.distributed.device_mesh import init_device_mesh
    _, tcfg = _cfgs(arch)
    mesh = init_device_mesh("cpu", (n_stages, 1, 1),
                            mesh_dim_names=("stage", "data", "model"))
    fn = pp_spmd.make_pp_prefill(tcfg, mesh, B, S, n_stages=n_stages,
                                 n_micro=n_micro)[0]
    with torch.no_grad():
        return fn(Model(tcfg).slice_stage_params(params, n_stages, stage),
                  torch.from_numpy(_tokens(tcfg))).numpy()


def _port_main(rank, world, store, out_dir):
    """One of two port ranks: every two-rank case, into ``out_dir``."""
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        params = {}
        for arch in sorted(set(TP_ARCHS) | {a for a, _ in PP_CASES}):
            flat = dict(np.load(os.path.join(out_dir, f"{arch}.npz")))
            params[arch] = params_from_numpy(_unflat(flat), "cpu")
        out = {}
        for arch in TP_ARCHS:
            logits, cache = port_tp(arch, world, rank, params[arch])
            out[f"tp/{arch}/logits"] = logits
            out[f"tp/{arch}/k"], out[f"tp/{arch}/v"] = cache["k"], cache["v"]
        for arch, n_micro in PP_CASES:
            out[f"pp/{arch}/{n_micro}"] = port_pp(arch, world, n_micro, rank,
                                                  params[arch])
        np.savez(os.path.join(out_dir, f"port{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(args, env):
    return subprocess.Popen([sys.executable, __file__] + args, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The reference's and the port's two-rank runs, started together:
    (the reference's arrays, [rank 0's, rank 1's])."""
    out = tmp_path_factory.mktemp("two_ranks")
    for arch in sorted(set(TP_ARCHS) | {a for a, _ in PP_CASES}):
        np.savez(out / f"{arch}.npz", **_flat(_jparams(_cfgs(arch)[0])))
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "HOME": str(out), "TMPDIR": str(out),
           "REPRO_KERNEL_BACKEND": "ref"}
    procs = [_spawn(["reference", str(out)], dict(
        env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))]
    procs += [_spawn(["port", str(r), "2", str(out / "store"), str(out)],
                     env) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return (dict(np.load(out / "reference.npz")),
            [dict(np.load(out / f"port{r}.npz")) for r in range(2)])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process, torn down after the module."""
    store = tmp_path_factory.mktemp("one_rank") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _tparams(arch):
    return params_from_numpy(_jparams(_cfgs(arch)[0]), "cpu")


# ---------------------------------------------------------------------------
# manual TP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_manual_tp_one_rank_equals_reference(arch, one_rank):
    logits, cache = port_tp(arch, 1, 0, _tparams(arch))
    want_logits, want_cache = reference_tp(arch, 1)
    close(logits, want_logits, "logits")
    for name in ("k", "v"):
        for layer in range(want_cache[name].shape[0]):
            close(cache[name][layer], want_cache[name][layer],
                  f"{name}[{layer}]")


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_manual_tp_one_rank_equals_model_prefill(arch, one_rank):
    """tp 1 is the plain forward: the logits of ``Model.prefill`` on the
    slot-contiguous layout (over the real vocab; the manual head masks no
    padded column, as the reference's), and its cache."""
    _, tcfg = _cfgs(arch)
    params = _tparams(arch)
    logits, cache = port_tp(arch, 1, 0, params)
    with torch.no_grad():
        want, wcache = Model(tcfg).prefill(
            params, torch.from_numpy(_tokens(tcfg)), S, paged=False)
    close(logits[:, :tcfg.vocab], want[:, :tcfg.vocab].numpy(), "logits")
    close(cache["k"], wcache["slot00"]["k"].numpy(), "k")
    close(cache["v"], wcache["slot00"]["v"].numpy(), "v")


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_manual_tp_two_ranks_equal_reference(arch, two_ranks):
    ref, ranks = two_ranks
    logits = np.concatenate([r[f"tp/{arch}/logits"] for r in ranks], axis=1)
    close(logits, ref[f"tp/{arch}/logits"], "logits")
    for name in ("k", "v"):
        got = np.concatenate([r[f"tp/{arch}/{name}"] for r in ranks], axis=2)
        want = ref[f"tp/{arch}/{name}"]
        assert ranks[0][f"tp/{arch}/{name}"].shape[2] == S // 2
        for layer in range(want.shape[0]):
            close(got[layer], want[layer], f"{name}[{layer}]")


@pytest.mark.parametrize("tp", [16, 2])
def test_manual_tp_supports_equals_reference(tp):
    for name, jcfg in sorted(jlist().items()):
        assert manual_tp.supports(get_config(name), tp) == \
            jtp.supports(jcfg, tp), name


def test_manual_tp_refuses_uneven_shards():
    _, tcfg = _cfgs("granite-3-8b")
    with pytest.raises(ValueError, match="seq"):
        manual_tp.check(tcfg, 33, 2)
    three = dataclasses.replace(tcfg, n_heads=6, n_kv_heads=3, d_model=96,
                                d_ff=192)
    assert manual_tp.supports(three, 3)
    with pytest.raises(ValueError, match="padded_vocab"):
        manual_tp.check(three, 33, 3)         # 512 rows over 3 ranks
    with pytest.raises(ValueError, match="not supported"):
        manual_tp.check(tcfg, 32, 8)          # 4 heads over 8 ranks
    manual_tp.check(tcfg, 32, 2)


def test_manual_tp_shards_follow_the_specs():
    """Each shard is the rank's slice of the dim its spec names."""
    _, tcfg = _cfgs("qwen1.5-32b")
    params = _tparams("qwen1.5-32b")
    sh = manual_tp.shard_params(tcfg, params, 1, 2)
    wq = params["blocks"]["slot00"]["mixer"]["w_q"]
    assert torch.equal(sh["blocks"]["slot00"]["mixer"]["w_q"],
                       wq[..., wq.shape[-1] // 2:])
    tok = params["embed"]["tok"]
    assert torch.equal(sh["embed"]["tok"], tok[tok.shape[0] // 2:])
    assert sh["final_norm"] is params["final_norm"]
    assert sh["blocks"]["slot00"]["mixer"]["b_k"].shape[-1] == \
        params["blocks"]["slot00"]["mixer"]["b_k"].shape[-1] // 2


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_micro", PP_CASES)
def test_pp_one_stage_equals_reference(arch, n_micro, one_rank):
    logits = port_pp(arch, 1, n_micro, 0, _tparams(arch))
    close(logits, reference_pp(arch, 1, n_micro), "logits")


@pytest.mark.parametrize("arch,n_micro", PP_CASES)
def test_pp_two_stages_equal_reference(arch, n_micro, two_ranks):
    ref, ranks = two_ranks
    for r in ranks:                 # the last stage's logits on every stage
        close(r[f"pp/{arch}/{n_micro}"], ref[f"pp/{arch}/{n_micro}"],
              "logits")


@pytest.mark.parametrize("n_stages", [4, 2])
def test_pp_supports_equals_reference(n_stages):
    for name, jcfg in sorted(jlist().items()):
        assert pp_spmd.supports(get_config(name), n_stages) == \
            jpp.supports(jcfg, n_stages), name


def test_pp_refuses_what_it_cannot_split(one_rank):
    from torch.distributed.device_mesh import init_device_mesh
    _, tcfg = _cfgs("granite-3-8b")
    mesh = init_device_mesh("cpu", (1, 1, 1),
                            mesh_dim_names=("stage", "data", "model"))
    with pytest.raises(ValueError, match="micro-batches"):
        pp_spmd.make_pp_prefill(tcfg, mesh, 3, S, n_stages=1, n_micro=2)
    with pytest.raises(ValueError, match="stage axis"):
        pp_spmd.make_pp_prefill(tcfg, mesh, B, S, n_stages=2, n_micro=2)
    _, whisper = _cfgs("whisper-small")
    with pytest.raises(ValueError, match="not supported"):
        pp_spmd.make_pp_prefill(whisper, mesh, B, S, n_stages=1, n_micro=2)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference_main(sys.argv[2])
    else:
        _port_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
