"""With the timed path broken underneath, a run's ``correct`` comes out
false: once for each fault a served cell can have (a step that leaves its
state unchanged: the K/V writes dropped; half of the decode batch left
out; a token altered where it is produced). One card: no exchange
between chips to leave out."""

import pytest

from bench.harness import cell_run
from bench.tests.fixture import make_root
from bench.tests.test_bench_rehearsal import run_cpu


def _no_kv_write(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "ragged_kv_write",
                        lambda pages, *a, **k: pages)
    monkeypatch.setattr(attention, "paged_kv_write",
                        lambda pages, *a, **k: pages)


def _half_batch(monkeypatch):
    from repro_torch.kernels import ops
    orig = ops.paged_decode_attention

    def half(q, *a, **k):
        out = orig(q, *a, **k).clone()
        out[0::2] = 0           # every other row, slot 0 among them
        return out
    monkeypatch.setattr(ops, "paged_decode_attention", half)


def _altered_token(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.sample_token
    monkeypatch.setattr(engine, "sample_token",
                        lambda logits, p, i: (orig(logits, p, i) + 1)
                        % logits.shape[-1])


@pytest.mark.parametrize("fault", [_no_kv_write, _half_batch,
                                   _altered_token],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
@pytest.mark.parametrize("cell", ["tiny-dense.tiny-chat",
                                  "tiny-moe.tiny-chat",
                                  "tiny-dense.tiny-cold"])
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, fault, cell):
    root = make_root(tmp_path)
    fault(monkeypatch)
    c, rec, checks, dev, _ = run_cpu(root, cell)
    out = cell_run.result(c, rec, checks, dev, False)
    assert out["correct"] is False, checks
