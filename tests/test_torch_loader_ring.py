"""The card's copy leg of the stage loader, on the CPU: ``ring_plan`` maps
a stage's chunk ranges onto the fills of the ring of page-locked slots.
Replayed byte by byte through one buffer a fill, the plan must put every
byte of every range through exactly once and in order, pack the fills
from their first byte, let a range longer than a slot span consecutive
fills, and let short ranges share one; at slots smaller than the largest
range, equal to it, and larger than the whole stage."""

import numpy as np
import pytest

from repro_torch.store.loader import ring_plan

# a stage's range lengths: a large leaf, norms and biases, an empty leaf,
# leaves that cross a slot's edge
LENGTHS = [4096, 24, 8, 10_000, 0, 16, 16, 3000, 1, 2500]
LARGEST = max(LENGTHS)


@pytest.mark.parametrize("slot", [1000, LARGEST, sum(LENGTHS) + 1],
                         ids=["below-largest", "largest", "above-stage"])
def test_ring_plan_puts_every_byte_through_once_in_order(slot):
    plan = ring_plan(LENGTHS, slot)
    assert len(plan) == len(LENGTHS)
    stream = [(r, p) for r, pieces in enumerate(plan) for p in pieces]

    # in stream order: fills 0, 1, 2, ... each packed from its first byte,
    # full but for the last, and each range's offsets ascending
    fills = [f for _, (f, _, _, _) in stream]
    assert fills == sorted(fills)
    assert sorted(set(fills)) == list(range(fills[-1] + 1))
    used = {}
    for _, (f, at, _, n) in stream:
        assert n > 0 and at == used.get(f, 0) and at + n <= slot
        used[f] = at + n
    assert all(used[f] == slot for f in range(fills[-1]))
    for r, pieces in enumerate(plan):
        offs = [off for _, _, off, _ in pieces]
        sizes = [n for _, _, _, n in pieces]
        assert offs == [sum(sizes[:i]) for i in range(len(sizes))]
        assert sum(sizes) == LENGTHS[r]

    # replayed: host fill into the fill's buffer, DMA out of it
    rng = np.random.default_rng(0)
    src = [rng.integers(0, 256, n, dtype=np.uint8) for n in LENGTHS]
    bufs = {f: np.zeros(slot, np.uint8) for f in set(fills)}
    dst = [np.zeros(n, np.uint8) for n in LENGTHS]
    hits = [np.zeros(n, np.int64) for n in LENGTHS]
    for r, (f, at, off, n) in stream:
        bufs[f][at:at + n] = src[r][off:off + n]
        dst[r][off:off + n] = bufs[f][at:at + n]
        hits[r][off:off + n] += 1
    for r in range(len(LENGTHS)):
        assert np.array_equal(dst[r], src[r])
        assert (hits[r] == 1).all()

    # a range longer than a slot spans consecutive fills; short ranges
    # share one
    for r, pieces in enumerate(plan):
        own = [f for f, _, _, _ in pieces]
        assert not own or own == list(range(own[0], own[0] + len(own)))
        if LENGTHS[r] > slot:
            assert len(own) >= 2
    ranges_a_fill = {f: {r for r, (g, *_) in stream if g == f}
                     for f in set(fills)}
    assert max(len(rs) for rs in ranges_a_fill.values()) >= 3
    if slot > sum(LENGTHS):
        assert set(fills) == {0}
