"""The traffic generator: deterministic by seed, the same work for every seed
in another order, and the coverage and line lengths each mix states."""

from collections import Counter

import pytest
import torch

from perfbench import generator
from perfbench.tests.conftest import TEST_TIMELINES

TIMELINES = list(TEST_TIMELINES)
BIG_SEED = 2**31 + 12345  # seeds run past 32 signed bits


def test_frame_pool_is_deterministic():
    mix = dict(generator.load_mix("band_1080p"), width=64, height=36, pool_frames=5)
    a, b = (generator.frame_pool(mix, BIG_SEED, "cpu", slice_frames=2) for _ in range(2))
    c = generator.frame_pool(mix, BIG_SEED + 1, "cpu", slice_frames=2)
    assert len(a) == 5 and a[0].shape == (36, 64, 3) and a[0].dtype.name == "uint8"
    assert all((x == y).all() for x, y in zip(a, b))
    assert not all((x == y).all() for x, y in zip(a, c))


def test_selection_box_is_the_default_area():
    assert generator.selection_box(generator.load_mix("band_1080p")) == (288, 1632, 950, 1069)


@pytest.mark.parametrize("name", TIMELINES)
def test_timeline_is_deterministic_by_seed(name):
    mix = TEST_TIMELINES[name]
    a = generator.timeline_lines(mix, BIG_SEED, 5000)
    assert a == generator.timeline_lines(mix, BIG_SEED, 5000)
    assert a != generator.timeline_lines(mix, BIG_SEED + 1, 5000)


@pytest.mark.parametrize("name", TIMELINES)
def test_every_seed_gets_the_same_work(name):
    """One period holds the same lengths, gaps and rows for every seed."""
    mix = TEST_TIMELINES[name]
    k = mix["lines_per_period"]

    def period(seed):
        lines = generator.timeline_lines(mix, seed, 1)[:k]
        return (Counter(e - s + 1 for s, e, _ in lines), Counter(len(b) for *_, b in lines),
                lines[-1][1])

    assert period(1) == period(BIG_SEED) == period(7)


@pytest.mark.parametrize("name,lo,hi,coverage", [
    ("lines_dense", 40, 120, 80 / 92), ("lines_sparse", 10, 30, 20 / 60)])
def test_timeline_lengths_and_coverage(name, lo, hi, coverage):
    mix = TEST_TIMELINES[name]
    lines = generator.timeline_lines(mix, BIG_SEED, mix["horizon_frames"])
    boxes = generator.boxes_by_frame(lines)
    lengths = [e - s + 1 for s, e, _ in lines]
    assert lo <= min(lengths) and max(lengths) <= hi
    assert len(boxes) / lines[-1][1] == pytest.approx(coverage, abs=0.02)
    assert lines[-1][1] >= mix["horizon_frames"]
    W, H = mix["width"], mix["height"]
    for _, _, bxs in lines:
        assert 1 <= len(bxs) <= 2
        for xmin, xmax, ymin, ymax in bxs:
            assert 0 <= xmin < xmax < W and int(0.88 * H) <= ymin < ymax < int(0.99 * H)
    gaps = [b[0] - a[1] - 1 for a, b in zip(lines, lines[1:])]
    assert min(gaps) >= mix["gap_frames"][0] and max(gaps) <= mix["gap_frames"][1]


def test_pool_made_on_the_given_device():
    mix = dict(generator.load_mix("band_1080p"), width=8, height=4, pool_frames=3)
    pool = generator.frame_pool(mix, 3, torch.device("cpu"))
    assert len(pool) == 3
