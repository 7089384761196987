"""Repo-specific AST lint (stdlib-only; no new dependencies).

The port's copy of ``src/repro/analysis/lint.py``, trimmed to the rules
that can fire on the port (``RULES``: the reference's ``jit-static-shape``
guards ``jax.jit``, which the port never calls), keyed on the relative
paths (``serving/kvcache.py``, ``router/kvtier.py``, ...) that
``src/repro_torch`` mirrors, and run over the port's package against a
baseline of its own (``lint_baseline.json`` beside this file).
``wallclock-in-sim`` covers the port's ``fleet/``, ``cluster/`` and
``serving/simulation.py``.

Rules encode the invariants this codebase keeps re-fixing by hand:

  * ``kv-bytes-formula``  — KV byte arithmetic (the ``2 * n_kv_heads *
    head_dim * itemsize`` pattern) must route through
    ``models.attention.paged_kv_token_bytes`` /
    ``roofline.analytic.kv_token_bytes``; re-derived formulas drift the
    moment the layout changes (int8 scale/zero leaves did exactly
    that). Blessed definition sites: ``models/attention.py``,
    ``roofline/analytic.py``, ``core/types.py``.
  * ``private-blockmanager`` — no access to ``BlockManager`` private
    state (``_ref``, ``_index``, ``_hash_of``, ``_cached``, ``_free``,
    ``_take_block``, …) outside ``serving/kvcache.py``; everything else
    goes through the public API (``refcount``, ``free_blocks``,
    ``indexed_hashes``, hooks).
  * ``wallclock-in-sim``  — no wall-clock (``time.time`` & friends,
    ``datetime.now``) or global-RNG (``random.*``, ``np.random.*``)
    calls in the simulation/fleet modules (``fleet/``, ``cluster/``,
    ``serving/simulation.py``): those layers take an injected clock /
    seeded generator so runs replay deterministically.
  * ``runtime-assert``    — no bare ``assert`` guarding runtime
    invariants in the KV-lifecycle modules (``serving/kvcache.py``,
    ``runner.py``, ``worker.py``, ``engine.py``, ``migration.py``,
    ``scheduler.py``, ``router/kvtier.py``, ``store/kvsegment.py``):
    ``python -O`` strips asserts, so invariant guards raise
    ``KVInvariantError`` / ``ValueError`` explicitly.
  * ``blanket-except``    — no ``except Exception`` (or bare
    ``except:``) whose handler neither re-raises nor records the error
    (logging / traceback / print / structured error capture).

Suppress a finding with a same-line comment::

    something_flagged()   # repro-lint: allow[rule-name]

The checked-in baseline (``lint_baseline.json``, per-file per-rule
counts) ratchets: runs fail on findings above the baseline and report
when the baseline itself can be tightened.

Run: ``python -m repro_torch.analysis.lint`` (default: the
``repro_torch`` package root).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["RULES", "LintFinding", "lint_file", "lint_tree", "main"]

RULES = ("kv-bytes-formula", "private-blockmanager", "wallclock-in-sim",
         "runtime-assert", "blanket-except")

_ALLOW_RE = re.compile(r"#\s*repro-lint:\s*allow\[([a-z0-9_,\- ]+)\]")

# rule scopes, as path suffixes relative to the package root
KV_BYTES_BLESSED = ("models/attention.py", "roofline/analytic.py",
                    "core/types.py")
BLOCKMGR_HOME = ("serving/kvcache.py",)
BLOCKMGR_PRIVATE = frozenset({
    "_ref", "_index", "_hash_of", "_cached", "_free", "_take_block",
    "_ref_block", "_unref_block", "_fire_commit", "_fire_evict",
    "_n_hashed", "_chain",
})
SIM_SCOPE = ("fleet/", "cluster/", "serving/simulation.py")
RUNTIME_ASSERT_SCOPE = (
    "serving/kvcache.py", "serving/runner.py", "serving/worker.py",
    "serving/engine.py", "serving/migration.py", "serving/scheduler.py",
    "router/kvtier.py", "store/kvsegment.py",
)
WALLCLOCK_CALLS = {
    ("time", "time"), ("time", "monotonic"), ("time", "perf_counter"),
    ("time", "time_ns"), ("time", "monotonic_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("date", "today"),
}
# global-RNG factories that are fine: they *construct* seeded generators
RNG_ALLOWED = {"default_rng", "Generator", "PRNGKey", "Random", "seed"}


@dataclass(frozen=True)
class LintFinding:
    path: str       # repo-relative
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _suffix_match(relpath: str, suffixes) -> bool:
    rp = relpath.replace(os.sep, "/")
    return any(rp.endswith(s) or f"/{s}" in rp or rp.startswith(s)
               for s in suffixes)


def _allowed_rules(source_lines: List[str], lineno: int) -> frozenset:
    """Rules waived by a ``# repro-lint: allow[...]`` comment on the
    finding's line (or the line above, for wrapped statements)."""
    out = set()
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(source_lines):
            m = _ALLOW_RE.search(source_lines[ln - 1])
            if m:
                out.update(p.strip() for p in m.group(1).split(","))
    return frozenset(out)


def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('np', 'random', 'rand') for ``np.random.rand`` — None if the
    chain has non-name parts."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


class _Checker(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.lines = source.splitlines()
        self.findings: List[LintFinding] = []
        self.in_sim = _suffix_match(relpath, SIM_SCOPE)
        self.kv_blessed = _suffix_match(relpath, KV_BYTES_BLESSED)
        self.bm_home = _suffix_match(relpath, BLOCKMGR_HOME)
        self.assert_scope = _suffix_match(relpath, RUNTIME_ASSERT_SCOPE)
        self._kv_seen: set = set()   # inner Mult nodes already reported

    def _emit(self, node: ast.AST, rule: str, message: str):
        line = getattr(node, "lineno", 1)
        if rule in _allowed_rules(self.lines, line):
            return
        self.findings.append(LintFinding(self.relpath, line, rule, message))

    # ---------------------------------------------------- kv-bytes-formula
    def _mult_names(self, node: ast.AST, names: set):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            self._mult_names(node.left, names)
            self._mult_names(node.right, names)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Name):
            names.add(node.id)

    def visit_BinOp(self, node: ast.BinOp):
        if (isinstance(node.op, ast.Mult) and not self.kv_blessed
                and id(node) not in self._kv_seen):
            names: set = set()
            self._mult_names(node, names)
            if "n_kv_heads" in names and "head_dim" in names:
                self._emit(node, "kv-bytes-formula",
                           "KV bytes re-derived from n_kv_heads*head_dim: "
                           "route through attention.paged_kv_token_bytes / "
                           "analytic.kv_token_bytes (int8 pools carry "
                           "scale/zero bytes this formula misses)")
                # one finding per multiply chain, not per inner node
                for sub in ast.walk(node):
                    if isinstance(sub, ast.BinOp):
                        self._kv_seen.add(id(sub))
        self.generic_visit(node)

    # ------------------------------------------------ private-blockmanager
    def visit_Attribute(self, node: ast.Attribute):
        if not self.bm_home and node.attr in BLOCKMGR_PRIVATE:
            base = _dotted(node.value)
            # self._free etc. on *other* classes is fine unless the base
            # looks like a block manager handle
            if base is not None and (
                    base[-1] in ("block_mgr", "bm", "block_manager",
                                 "blockmgr")
                    or (len(base) > 1 and base[-1] in BLOCKMGR_PRIVATE)):
                self._emit(node, "private-blockmanager",
                           f"access to BlockManager private state "
                           f"'.{node.attr}' outside serving/kvcache.py — "
                           f"use the public API (refcount, free_blocks, "
                           f"indexed_hashes, hooks)")
        self.generic_visit(node)

    # --------------------------------------------------- wallclock-in-sim
    def visit_Call(self, node: ast.Call):
        d = _dotted(node.func)
        if self.in_sim and d is not None:
            if (d[-2:] in WALLCLOCK_CALLS
                    or (len(d) >= 2 and d[-2] == "random"
                        and d[-1] not in RNG_ALLOWED)
                    or (d[0] == "random" and len(d) == 2
                        and d[-1] not in RNG_ALLOWED)):
                self._emit(node, "wallclock-in-sim",
                           f"'{'.'.join(d)}' in a simulation/fleet module: "
                           f"inject the clock / a seeded generator so runs "
                           f"replay deterministically")
        self.generic_visit(node)

    # ------------------------------------------------------ runtime-assert
    def visit_Assert(self, node: ast.Assert):
        if self.assert_scope:
            self._emit(node, "runtime-assert",
                       "bare assert guards a runtime invariant here but "
                       "python -O strips it — raise KVInvariantError / "
                       "ValueError explicitly")
        self.generic_visit(node)

    # ------------------------------------------------------ blanket-except
    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        blanket = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException"))
        if blanket and not self._handler_accounts(node):
            self._emit(node, "blanket-except",
                       "blanket 'except Exception' that neither re-raises "
                       "nor records the error — narrow the types or log / "
                       "re-raise")
        self.generic_visit(node)

    @staticmethod
    def _handler_accounts(node: ast.ExceptHandler) -> bool:
        """Handler re-raises, logs, prints, or captures the error."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Raise):
                return True
            if isinstance(sub, ast.Call):
                d = _dotted(sub.func)
                if d is None:
                    continue
                if d[-1] in ("print", "print_exc", "exception", "warning",
                             "warn", "error", "critical", "format_exc",
                             "log"):
                    return True
            # `rec = {... "error": str(e)}`-style capture
            if isinstance(sub, ast.Dict):
                for k in sub.keys:
                    if isinstance(k, ast.Constant) and k.value in (
                            "error", "exception", "err"):
                        return True
        return False


def lint_file(path: str, relpath: Optional[str] = None) -> List[LintFinding]:
    relpath = relpath or path
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [LintFinding(relpath, e.lineno or 1, "syntax-error", str(e))]
    checker = _Checker(relpath, source)
    checker.visit(tree)
    return checker.findings


def lint_tree(root: str) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            findings.extend(lint_file(full, os.path.relpath(full,
                                                            root)))
    return findings


# ------------------------------------------------------------- baseline
def _counts(findings: List[LintFinding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        key = f"{f.path.replace(os.sep, '/')}::{f.rule}"
        out[key] = out.get(key, 0) + 1
    return out


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_baseline.json")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-lint",
        description="Repo-specific AST lint with a ratcheting baseline.")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: the "
                         "repro_torch package root)")
    ap.add_argument("--baseline", default=default_baseline_path())
    ap.add_argument("--write-baseline", action="store_true",
                    help="freeze the current findings as the new baseline")
    args = ap.parse_args(argv)

    roots = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]       # src/repro_torch
    findings: List[LintFinding] = []
    for r in roots:
        if os.path.isdir(r):
            findings.extend(lint_tree(r))
        else:
            findings.extend(lint_file(r, os.path.basename(r)))

    if args.write_baseline:
        with open(args.baseline, "w", encoding="utf-8") as f:
            json.dump(_counts(findings), f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"repro-lint: baseline frozen with {len(findings)} "
              f"finding(s) -> {args.baseline}")
        return 0

    baseline: Dict[str, int] = {}
    if os.path.exists(args.baseline):
        with open(args.baseline, encoding="utf-8") as f:
            baseline = json.load(f)

    counts = _counts(findings)
    new = {k: c - baseline.get(k, 0) for k, c in counts.items()
           if c > baseline.get(k, 0)}
    fixed = {k: baseline[k] - counts.get(k, 0) for k in baseline
             if counts.get(k, 0) < baseline[k]}

    if new:
        allowed = dict(baseline)
        for f in findings:
            key = f"{f.path.replace(os.sep, '/')}::{f.rule}"
            if allowed.get(key, 0) > 0:
                allowed[key] -= 1          # covered by the baseline
                continue
            print(str(f))
        print(f"repro-lint: {sum(new.values())} new finding(s) above the "
              f"baseline")
        return 1
    if fixed:
        print(f"repro-lint: clean; baseline can ratchet down "
              f"({sum(fixed.values())} stale allowance(s): "
              f"{', '.join(sorted(fixed))}) — rerun with --write-baseline")
    else:
        print(f"repro-lint: clean ({len(findings)} baselined finding(s))"
              if findings else "repro-lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
