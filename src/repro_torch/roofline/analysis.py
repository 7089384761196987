"""Roofline terms of one step on the NVIDIA H100, and the loop-aware HLO
collective parser.

  compute term    = FLOPs_total          / (chips * 989 TFLOP/s bf16)
  memory term     = HBM_bytes_per_device / 3.35 TB/s
  collective term = link_bytes_per_device / 450 GB/s

The peaks are the H100 SXM data sheet's (dense rates, no sparsity, at the
full 700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them, 3.35 TB/s of HBM3. The collective term uses NVLink 4
as the same data sheet gives it: 900 GB/s per GPU over its 18 links, both
directions counted, so 450 GB/s each way; a per-device byte count moved in
one direction is charged at that rate.

Sources of the terms:
  * FLOPs / HBM bytes: the analytic model in ``roofline/analytic.py``.
  * collective bytes: a loop-aware parse of partitioned HLO text (the
    reference's dry-run artifact): collective ops' local result-shape
    bytes, multiplied by the trip counts of enclosing while loops. The
    parser is text in, bytes out; the port itself emits no HLO.

``analyze`` takes the port's own ``cost`` and ``mem`` dicts where the
reference read XLA's ``cost_analysis()`` and ``memory_analysis()``:
``cost`` {"flops", "bytes accessed"} (recorded as ``xla_*``, not used in
the terms) and ``mem`` {"temp_bytes", "argument_bytes"}; a ``temp_bytes``
of None (no compiler to ask, as in the port's dry run) leaves the peak
memory unknown (None). ``coll_bytes`` (bytes by collective kind, e.g. from
``analytic.collective_bytes_per_device``) stands in for the HLO parse.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.roofline import analytic

BF16_FLOPS = 989e12            # dense bf16 tensor-core FLOP/s, one card
F32_FLOPS = 67e12              # float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3 bytes/s, one card
LINK_BYTES_PER_S = 450e9       # NVLink 4 bytes/s, one direction, one card

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"\b([a-z]+\d*)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[\d,]*\][^\s]*))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_COMP_RE = re.compile(
    r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.+\{\s*$")
_WHILE_RE = re.compile(
    r"while\(.*?\),\s*condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)")
_CALL_RE = re.compile(r"(?:call|fusion)\(.*?to_apply=%?([\w.\-]+)")
_CONST_RE = re.compile(r"s32\[\]\s+constant\((\d+)\)")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _split_computations(hlo_text: str) -> Dict[str, list]:
    comps: Dict[str, list] = {}
    entry: Optional[str] = None
    cur = None
    for line in hlo_text.splitlines():
        m = _COMP_RE.match(line.strip())
        if m and line.rstrip().endswith("{"):
            cur = m.group(1)
            comps[cur] = []
            if line.lstrip().startswith("ENTRY"):
                entry = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is not None:
            comps[cur].append(line)
    if entry is None and comps:
        entry = list(comps)[-1]
    comps["__entry__"] = [entry]          # type: ignore[list-item]
    return comps


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Loop-aware per-device collective bytes by kind."""
    comps = _split_computations(hlo_text)
    entry = comps.pop("__entry__")[0]

    info = {}
    for name, lines in comps.items():
        colls, whiles, calls, consts = [], [], [], [0]
        for line in lines:
            if "-done(" in line:
                continue
            m = _OP_RE.search(line)
            if m:
                colls.append((m.group(2), _shape_bytes(m.group(1))))
            w = _WHILE_RE.search(line)
            if w:
                whiles.append((w.group(1), w.group(2)))
            c = _CALL_RE.search(line)
            if c:
                calls.append(c.group(1))
            for k in _CONST_RE.findall(line):
                consts.append(int(k))
        info[name] = (colls, whiles, calls, max(consts))

    mult = {name: 0.0 for name in info}
    if entry in mult:
        mult[entry] = 1.0
    # propagate multipliers to fixpoint (HLO computation graph is acyclic)
    for _ in range(len(info)):
        changed = False
        new = dict(mult)
        for name, (colls, whiles, calls, _) in info.items():
            m = mult.get(name, 0.0)
            if m <= 0:
                continue
            for cond, body in whiles:
                trip = info.get(cond, ([], [], [], 1))[3] or 1
                want = m * max(trip, 1)
                if new.get(body, 0.0) < want:
                    new[body] = want
                    changed = True
            for callee in calls:
                if new.get(callee, 0.0) < m:
                    new[callee] = m
                    changed = True
        mult = new
        if not changed:
            break

    out = {k: 0 for k in _COLLECTIVES}
    for name, (colls, _, _, _) in info.items():
        m = mult.get(name, 0.0)
        if m <= 0:
            continue
        for kind, nbytes in colls:
            out[kind] += int(nbytes * m)
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_total: float              # analytic, whole step
    bytes_per_device: float         # analytic HBM traffic
    coll_bytes_per_device: Dict[str, int]   # from HLO, or given
    peak_memory_per_device: Optional[float]
    model_flops_total: float
    xla_flops_per_device: float = 0.0
    xla_bytes_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_total / (self.chips * BF16_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return sum(self.coll_bytes_per_device.values()) / LINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return (self.model_flops_total / self.flops_total
                if self.flops_total else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """useful FLOPs / (chips*peak*dominant-term-time): the score."""
        denom = self.chips * BF16_FLOPS * self.bound_s
        return self.model_flops_total / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops_total,
            "flops_total": self.flops_total,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_gb": (None if self.peak_memory_per_device is None
                            else self.peak_memory_per_device / (1 << 30)),
            "coll_bytes": dict(self.coll_bytes_per_device),
            "xla_flops_dev": self.xla_flops_per_device,
            "xla_bytes_dev": self.xla_bytes_per_device,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D prefill, 2*N*B decode;
    N = active params for MoE."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def analyze(arch: str, shape, mesh_name: str, chips: int, cost: dict,
            mem: dict, hlo_text: str, cfg,
            policy: str = "baseline", kv_dtype=None,
            coll_bytes: Optional[Dict[str, int]] = None) -> Roofline:
    """``kv_dtype`` parameterizes the analytic KV-traffic term on the KV
    pool storage dtype (serving engines with quantized pages); ``None``
    keeps the legacy bf16 assumption. ``cost``, ``mem`` and ``coll_bytes``
    are as the module docstring says; ``hlo_text`` may be empty (no
    collectives), and is not read when ``coll_bytes`` is given."""
    train_mult = 4.0 if shape.kind == "train" else 1.0  # fwd+remat+bwd
    flops = analytic.step_flops(cfg, shape,
                                causal_skip="skip" in policy) * train_mult
    pbytes = cfg.size_bytes()
    hbm = analytic.hbm_bytes_per_device(cfg, shape, chips, pbytes,
                                        train_mult, kv_dtype=kv_dtype)
    coll = (dict(coll_bytes) if coll_bytes is not None
            else collective_bytes(hlo_text))
    temp = mem.get("temp_bytes", 0)
    peak_mem = (None if temp is None
                else temp + mem.get("argument_bytes", 0))
    return Roofline(
        arch, shape.name, mesh_name, chips, flops, hbm, coll, peak_mem,
        model_flops(cfg, shape),
        xla_flops_per_device=float(cost.get("flops", 0.0)),
        xla_bytes_per_device=float(cost.get("bytes accessed", 0.0)))
