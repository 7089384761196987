"""One run of one cell: set-up, the window, the memory peak, the program's
state freed, the comparison with the reference, and the metrics read from
the record by each metric's own reader."""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Callable

import torch

from bench.harness import check as C
from bench.harness import traffic as T
from bench.harness import weights as W
from bench.harness.calls import CallCounter
from bench.harness.drive import Loop, cold_bursts, open_loop, release
from bench.harness.record import Record
from bench.harness.spec import Cell, port_config
from bench.harness.trace import Tracer, breakdown


def engine_kw(arch: dict) -> dict:
    e = arch["engine"]
    return {k: e[k] for k in ("max_batch", "max_seq", "block_size", "paged",
                              "prefill_chunk") if k in e}


def _warm(ep, loop_params, traffic: dict, arch: dict, seed: int):
    """Every prefill bucket the mix reaches and the decode step, once, with
    their own prompts (outside the record)."""
    import numpy as np
    rng = np.random.default_rng((int(seed) + 1) % (1 << 63))
    chunk = arch["engine"].get("prefill_chunk") or arch["engine"]["max_seq"]
    for n in T.warm_lengths(traffic, chunk):
        ep.submit([int(x) for x in rng.integers(0, arch["vocab_size"], n)],
                  loop_params(max_new=2))
    while ep.has_work():
        ep.step()


def _settle():
    """Set-up's garbage collected and frozen out of later collections, so
    that the window's collections walk only what the window makes."""
    gc.collect()
    gc.freeze()


def _materialize_timer(rec):
    def timed(pend, cr):
        for st in pend.stages:
            def run(orig=st.materialize):
                torch.cuda.synchronize()
                a = time.perf_counter()
                sp, r = orig()
                torch.cuda.synchronize()
                b = time.perf_counter()
                cr.materialize_s += b - a
                cr.bytes += sum(t.numel() * t.element_size()
                                for t in W.flat(sp).values())
                rec.spans.append(("materialize", a, b))
                return sp, r
            st.materialize = run
    return timed


def _landed(ep, arch, seed, device):
    """Leaves of the endpoint's stage parameters that differ from the
    seed's weights, drawn again; returns (count, the weights drawn)."""
    full = {}
    bad = 0
    stages = [(w.periods, W.flat(w.params)) for w in ep.engine.workers]
    for path, t in W.leaves(arch, seed, device):
        full[path] = t
        for (p0, p1), leaves in stages:
            if path not in leaves:
                continue
            want = t[p0:p1] if path[0] == "blocks" else t
            got = leaves[path]
            if got.shape != want.shape or got.dtype != want.dtype \
                    or not torch.equal(got, want):
                bad += 1
    return bad, W.nest(full)


@contextlib.contextmanager
def _window(trace: bool, counter, tracer):
    """The traced run's call counting around the window; a profile left
    open by a failure is closed before the failure goes on."""
    if not trace:
        yield
        return
    try:
        with counter.ops_wrapped():
            yield
    except BaseException:
        tracer.abort()
        raise


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, guard: Callable[[], None], keep: bool = False):
    """Returns (record, checks, device info, kept): ``kept`` holds the
    checked sample, its prompts and the reference's weights when
    ``keep`` (the control's readings take them), else None."""
    from repro_torch.serving.api import SamplingParams
    arch = cell.arch
    cfg = port_config(arch)
    rec = Record(t_start)
    loop = Loop(rec, SamplingParams)
    tracer = Tracer(device) if trace else None
    counter = CallCounter(arch, rec) if trace else None
    own = cell.own
    kind = cell.traffic["kind"]

    def on_open():
        if trace:
            counter.on = True
            tracer.start()

    if kind == "open_loop":
        from repro_torch.serving.engine import Engine
        from repro_torch.serving.endpoint import ServingEndpoint
        weights = W.make(arch, seed, device)
        ep = ServingEndpoint(Engine(cfg, [weights], device=device,
                                    fused=arch["engine"].get("fused", False),
                                    **engine_kw(arch)))
        _warm(ep, SamplingParams, cell.traffic, arch, seed)
        guard()
        if trace:
            counter.wrap_runner(ep.engine.runner)
            tracer.warm()
        sched = T.open_loop(cell.traffic, float(own["rate_per_s"]), seconds,
                            seed, arch["vocab_size"])
        _settle()
        rec.t_open = time.perf_counter() + float(cell.traffic["ramp_s"])
        rec.t_close = rec.t_open + seconds
        with _window(trace, counter, tracer):
            open_loop(ep, loop, sched, rec.t_open, seconds, on_open)
        bad_leaves = None
    elif kind == "cold_bursts":
        from repro_torch.core.types import (Gbps, GB, ModelProfile, SLO,
                                            ServerSpec, TimingProfile)
        from repro_torch.serving.endpoint import ServerlessFrontend
        srv = cell.traffic["server"]
        front = ServerlessFrontend(
            {srv["id"]: ServerSpec(srv["id"], srv["nic_gbps"] * Gbps,
                                   float(srv["pcie_bytes_per_s"]),
                                   int(srv["hbm_gb"] * GB))}, device=device)
        slo = cell.traffic["slo"]
        size = sum(2 * math.prod(s)
                   for s, _, _ in W.layout(arch).values())
        front.deploy(cfg, W.make(arch, seed, device),
                     ModelProfile(cfg.name, size, TimingProfile(),
                                  SLO(slo["ttft_s"], slo["tpot_s"])))
        release()
        kw = engine_kw(arch)
        ep = front.begin_cold_start(cfg.name, **kw).finish()
        _warm(ep, SamplingParams, cell.traffic, arch, seed)
        ep = None
        release()
        guard()
        if trace:
            tracer.warm()
        bursts = T.cold_bursts(cell.traffic, seed, arch["vocab_size"])
        _settle()
        rec.t_open = time.perf_counter()
        rec.t_close = rec.t_open + seconds
        with _window(trace, counter, tracer):
            ep = cold_bursts(front, cfg.name, kw, loop, bursts, rec.t_open,
                             seconds, on_open,
                             timed=_materialize_timer(rec) if trace else None,
                             on_endpoint=((lambda e: counter.wrap_runner(
                                 e.engine.runner)) if trace else None))
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")

    if trace:
        counter.on = False
        tracer.stop(rec)
        rec.extra["trace_in_window"] = float(len(rec.device_events))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dev_info = device_info(device)
    guard()

    finished = [r for r in rec.requests
                if r.done_at is not None and r.done_at < rec.t_close]
    if kind == "cold_bursts":
        if ep is None:          # the window closed between two bursts
            ep = front.begin_cold_start(cfg.name, **kw).finish()
        bad_leaves, weights = _landed(ep, arch, seed, device)
    rec.memory = memory_held(arch, rec, ep.stats()["total_blocks"])
    ep = None
    release()
    picked = C.sample(finished, int(own["correct"]["sample"]), seed)
    checks = C.judge(arch, weights, picked, loop.prompts, own["correct"])
    if bad_leaves is not None:
        checks["weights_mismatched_leaves"] = {"value": bad_leaves,
                                               "limit": 0}
    kept = dict(picked=picked, prompts=loop.prompts,
                weights=weights) if keep else None
    return rec, checks, dev_info, kept


def memory_held(arch: dict, rec: Record, pool_blocks: int) -> dict:
    """The weights' bytes, the KV pool's as reserved, and the K/V bytes of
    the most pages held after any step of the window: the memory the
    deployment really holds, beside the allocator's peak, which counts the
    whole pool."""
    itemsize = W.dtype_of(arch).itemsize
    hkv = arch["num_key_value_heads"]
    hd = arch.get("head_dim") or (arch["hidden_size"]
                                  // arch["num_attention_heads"])
    block = (arch["engine"]["block_size"] * 2 * hkv * hd * itemsize
             * arch["num_hidden_layers"])
    held = max((s.kv_blocks for s in rec.steps if rec.in_window(s.t0)),
               default=0)
    return {"weights_bytes": sum(itemsize * math.prod(shape) for shape, _, _
                                 in W.layout(arch).values()),
            "kv_pool_bytes": pool_blocks * block,
            "kv_live_peak_bytes": held * block}


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def result(cell: Cell, rec: Record, checks: dict, dev_info: dict,
           trace: bool) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(rec)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    device = dict(dev_info)
    out = {"correct": C.passed(checks),
           "attempted": sum(1 for r in rec.requests
                            if rec.in_window(r.arrival)),
           "failed": sum(1 for r in rec.requests
                         if rec.in_window(r.arrival) and r.failed),
           "metrics": metrics, "device": device}
    if trace and rec.traced:
        device["busy_s"] = sum(b - a for a, b in rec.busy)
        device["window_s"] = rec.window_s
        out["breakdown"] = breakdown(rec)
    if rec.memory:
        out["memory"] = rec.memory
    out["checks"] = checks
    return out
