"""The port's kernel contract checker and lint (``repro_torch.analysis``)
held against the reference's on the CPU.

* The kernel contract checker (mirrors ``tests/test_kernelcheck.py``): its
  parametrised mutations carry over; the TPU alignment severity becomes
  the Hopper rules (head dim outside ``HEAD_DIMS``, a pool off a 16-byte
  boundary, non-int32 indices: errors on the card, warnings on the CPU);
  dispatch runs the checks in sanitize mode and skips them when it is off.
* The port's lint (mirrors ``tests/test_lint.py``): each rule it keeps
  gives the reference's findings on the same sources, the rule it dropped
  (``jit-static-shape``) gives none, and the port's package lints clean
  against its own baseline.
* ``repro_torch.analysis`` and ``repro_torch.router`` import without JAX
  or the reference package.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import lint as jlint
from repro_torch.analysis import lint
from repro_torch.analysis.kernelcheck import (KernelContractError,
                                              check_paged_decode,
                                              check_ragged_paged)
from repro_torch.kernels import ops

SRC = Path(__file__).resolve().parents[1] / "src"


# ---------------------------------------------------------------------------
# kernel contracts (tests/test_kernelcheck.py)
# ---------------------------------------------------------------------------

HD = 128
BS = 8


def _pool(n_pages=6, hkv=2, dtype=torch.float32):
    k = torch.zeros(n_pages, BS, hkv, HD, dtype=dtype)
    return k, k.clone()


def _ragged_args(t=16, hq=4, b=2, nb=4):
    q = torch.zeros(t, hq, HD)
    k, v = _pool()
    tables = torch.zeros(b, nb, dtype=torch.int32)
    row = torch.from_numpy(np.repeat(np.arange(t // 8) % b, 8)
                           .astype(np.int32))
    pos = torch.from_numpy(np.where(np.arange(t) % 8 < 5, np.arange(t) % 8,
                                    -1).astype(np.int32))
    return q, k, v, tables, row, pos


def _decode_args(b=2, hq=4, nb=4):
    q = torch.zeros(b, 1, hq, HD)
    k, v = _pool()
    tables = torch.zeros(b, nb, dtype=torch.int32)
    kv_len = torch.tensor([9, 17][:b], dtype=torch.int32)
    return q, k, v, tables, kv_len


def test_good_launches_pass():
    check_ragged_paged(*_ragged_args())
    check_paged_decode(*_decode_args())
    # the card's rules hold for these operands too
    check_ragged_paged(*_ragged_args(), backend="cuda")
    check_paged_decode(*_decode_args(), backend="cuda")


@pytest.mark.parametrize("mutate, match", [
    (lambda a: (a[0][0], *a[1:]), "q must be"),                 # q rank 2
    (lambda a: (a[0][:12], *a[1:]), "tile_q"),                  # T % 8 != 0
    (lambda a: (a[0][:, :3], *a[1:]), "GQA"),                   # Hq % Hkv
    (lambda a: (a[0][:, :, :64], *a[1:]),
     "head_dim"),                                               # q hd mismatch
    (lambda a: (*a[:3], a[3][0], *a[4:]), "tables must be"),
    (lambda a: (*a[:4], a[4][:8], a[5]), "row must be"),
    (lambda a: (*a[:4], a[4].float(), a[5]), "integer"),
    (lambda a: (*a[:5], a[5].to(torch.uint8)), "signed"),       # pad -1
])
def test_ragged_shape_violations(mutate, match):
    with pytest.raises(KernelContractError, match=match):
        check_ragged_paged(*mutate(_ragged_args()))


def test_ragged_concrete_value_violations():
    q, k, v, tables, row, pos = _ragged_args()
    bad_tables = tables.clone()
    bad_tables[0, 0] = 99
    with pytest.raises(KernelContractError, match="page ids outside"):
        check_ragged_paged(q, k, v, bad_tables, row, pos)
    bad_row = row.clone()
    bad_row[3] = 1 - bad_row[3]
    with pytest.raises(KernelContractError, match="inside query tile"):
        check_ragged_paged(q, k, v, tables, bad_row, pos)
    bad_pos = pos.clone()
    bad_pos[0] = -2
    with pytest.raises(KernelContractError, match="pad marker"):
        check_ragged_paged(q, k, v, tables, row, bad_pos)


def test_quant_leaf_contract():
    q, k, v, tables, row, pos = _ragged_args()
    k8, v8 = k.to(torch.int8), v.to(torch.int8)
    good = {l: torch.zeros(k.shape[:-1])
            for l in ("k_scale", "k_zero", "v_scale", "v_zero")}
    check_ragged_paged(q, k8, v8, tables, row, pos, kv_quant=good)
    with pytest.raises(KernelContractError, match="missing leaves"):
        check_ragged_paged(q, k8, v8, tables, row, pos,
                           kv_quant={"k_scale": good["k_scale"]})
    bad = dict(good, k_zero=good["k_zero"][:, :4])
    with pytest.raises(KernelContractError, match="shape"):
        check_ragged_paged(q, k8, v8, tables, row, pos, kv_quant=bad)
    bad = dict(good, v_scale=good["v_scale"].half())
    with pytest.raises(KernelContractError, match="float32"):
        check_ragged_paged(q, k8, v8, tables, row, pos, kv_quant=bad)


@pytest.mark.parametrize("mutate, match", [
    (lambda a: (a[0][:, 0], *a[1:]), "q must be"),
    (lambda a: (a[0], a[1][0], *a[2:]), "k_pages must be"),
    (lambda a: (a[0], a[1], a[2].half(), *a[3:]), "dtype"),
    (lambda a: (*a[:3], a[3][:1], a[4]), "block_tables must be"),
    (lambda a: (*a[:4], a[4][:1]), "kv_len must be"),
])
def test_decode_shape_violations(mutate, match):
    with pytest.raises(KernelContractError, match=match):
        check_paged_decode(*mutate(_decode_args()))


def test_decode_concrete_value_violations():
    q, k, v, tables, kv_len = _decode_args()
    bad = tables.clone()
    bad[1, 2] = -1
    with pytest.raises(KernelContractError, match="page ids outside"):
        check_paged_decode(q, k, v, bad, kv_len)
    with pytest.raises(KernelContractError, match="exceeds the"):
        check_paged_decode(q, k, v, tables,
                           torch.tensor([9, 999], dtype=torch.int32))


def _misaligned(t):
    """``t``'s values in a tensor that starts 4 bytes past a 16-byte
    boundary (CPU allocations start on one)."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("case, match", [
    ("head_dim", "head dims"),
    ("misaligned", "16-byte"),
    ("int64_table", "int32"),
])
def test_hopper_rule_severity_by_backend(case, match):
    """What the CUDA kernels demand: an error for a launch on the card, a
    warning on the CPU, whose plain version takes the operand as it is."""
    q, k, v, tables, kv_len = _decode_args()
    if case == "head_dim":                   # 48 is no kernel's head dim
        q, k, v = q[..., :48], k[..., :48].contiguous(), \
            v[..., :48].contiguous()
    elif case == "misaligned":
        k = _misaligned(k)
        assert k.data_ptr() % 16
    else:
        tables = tables.long()
    with pytest.warns(UserWarning, match=match):
        check_paged_decode(q, k, v, tables, kv_len)           # CPU tensors
    with pytest.raises(KernelContractError, match=match):
        check_paged_decode(q, k, v, tables, kv_len, backend="cuda")
    qr, kr, vr, tr, row, pos = _ragged_args()
    if case == "head_dim":
        qr, kr, vr = qr[..., :48], k, v
    elif case == "misaligned":
        kr = k
    else:
        tr, row = tr.long(), row.long()
    with pytest.raises(KernelContractError, match=match):
        check_ragged_paged(qr, kr, vr, tr, row, pos, backend="cuda")


def test_null_page_required():
    q, k, v, tables, kv_len = _decode_args()
    solo = k[:1]
    with pytest.raises(KernelContractError, match="null/trash"):
        check_paged_decode(q, solo, solo.clone(),
                           torch.zeros(2, 4, dtype=torch.int32), kv_len)


def test_ops_dispatch_runs_checks_only_in_sanitize_mode(monkeypatch):
    """Sanitize mode: a malformed launch dies with the contract error before
    dispatch. Mode off: dispatch never calls the checker."""
    from repro_torch.analysis import kernelcheck
    q, k, v, tables, kv_len = _decode_args()
    bad_len = torch.tensor([9, 999], dtype=torch.int32)
    ops.set_sanitize_mode(True)
    try:
        with pytest.raises(KernelContractError, match="exceeds the"):
            ops.paged_decode_attention(q, k, v, tables, bad_len)
        qr, kr, vr, tr, row, pos = _ragged_args()
        with pytest.raises(KernelContractError, match="signed"):
            ops.ragged_paged_attention(qr, kr, vr, tr, row,
                                       pos.to(torch.uint8))
    finally:
        ops.set_sanitize_mode(False)
    calls = []
    monkeypatch.setattr(kernelcheck, "check_paged_decode",
                        lambda *a, **kw: calls.append("decode"))
    monkeypatch.setattr(kernelcheck, "check_ragged_paged",
                        lambda *a, **kw: calls.append("ragged"))
    out = ops.paged_decode_attention(q, k, v, tables, kv_len)
    assert out.shape == q.shape
    ops.ragged_paged_attention(*_ragged_args())
    assert calls == []
    ops.set_sanitize_mode(True)
    try:
        ops.paged_decode_attention(q, k, v, tables, kv_len)
        ops.ragged_paged_attention(*_ragged_args())
    finally:
        ops.set_sanitize_mode(False)
    assert calls == ["decode", "ragged"]


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

LINT_SOURCES = [
    ("n = 2 * cfg.n_kv_heads * cfg.head_dim * 4 * n_layers\n",
     "roofline/report.py"),
    ("n = 2 * cfg.n_kv_heads * cfg.head_dim * 4\n", "models/attention.py"),
    ("x = eng.block_mgr._free.pop()\ny = bm._index[h]\nz = self._free\n",
     "serving/engine.py"),
    ("t = time.time()\nr = random.random()\ng = random.Random(7)\n",
     "fleet/controller.py"),
    ("assert x > 0, 'invariant'\n", "router/kvtier.py"),
    ("try:\n    f()\nexcept Exception:\n    pass\n", "serving/worker.py"),
    ("f = jax.jit(step, static_argnums=(1,))\n", "models/model.py"),
    ("assert x  # repro-lint: allow[runtime-assert]\n", "store/kvsegment.py"),
]


@pytest.mark.parametrize("source, relpath", LINT_SOURCES,
                         ids=[r for _, r in LINT_SOURCES])
def test_lint_rules_equal_reference(tmp_path, source, relpath):
    """The port's rules find what the reference's same rules find."""
    p = tmp_path / "src.py"
    p.write_text(source)
    got = [(f.line, f.rule, f.message)
           for f in lint.lint_file(str(p), relpath)]
    want = [(f.line, f.rule, f.message)
            for f in jlint.lint_file(str(p), relpath)
            if f.rule in lint.RULES]
    assert got == want
    if relpath == "models/model.py":        # jax.jit: the reference only
        assert got == [] and jlint.lint_file(str(p), relpath)


def test_port_lints_clean_against_its_baseline(capsys):
    root = SRC / "repro_torch"
    assert lint.main([str(root), "--baseline",
                      lint.default_baseline_path()]) == 0
    assert "new finding" not in capsys.readouterr().out
    with open(lint.default_baseline_path()) as f:
        baseline = json.load(f)
    counts = {}
    for f in lint.lint_tree(str(root)):
        key = f"{f.path}::{f.rule}"
        counts[key] = counts.get(key, 0) + 1
    assert counts == baseline
    assert Path(lint.default_baseline_path()).parent == \
        root / "analysis"


def test_analysis_and_router_import_without_jax_or_reference():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.sanitizer\n"
            "import repro_torch.analysis.kernelcheck\n"
            "import repro_torch.analysis.lint, repro_torch.router\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
