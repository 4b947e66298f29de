"""The numbers compared: a leaf or a loss that is not finite, or a leaf
the program lacks, fails every limit."""
import math

import pytest

from hopaas_bench.reference import compare

REF = {"a": 1.0, "b": 2.0, "c": 4.0}


def test_gaps_are_relative_to_the_leaf_or_the_median_leaf():
    prog = {"a": 1.1, "b": 2.0, "c": 4.1}
    worst, name = compare.worst_leaf_gap(prog, REF)
    assert name == "a" and worst == pytest.approx(0.05)   # 0.1 / median 2
    assert compare.median_leaf_gap(prog, REF) == pytest.approx(0.025)
    worst, name = compare.worst_leaf_gap(prog, REF, frozenset("a"))
    assert name == "c" and worst == pytest.approx(0.025)  # 0.1 / 4


@pytest.mark.parametrize("bad", [math.nan, math.inf, None])
@pytest.mark.parametrize("leaf", ["a", "c"])
def test_a_leaf_not_finite_or_missing_fails(bad, leaf):
    prog = dict(REF)
    if bad is None:
        del prog[leaf]
    else:
        prog[leaf] = bad
    worst, name = compare.worst_leaf_gap(prog, REF)
    assert worst == math.inf and name == leaf
    assert compare.median_leaf_gap({**prog, "b": math.nan}, REF) == math.inf
    ok, checks = compare.judge({"gap": worst}, {"gap": {"limit": 1e9}})
    assert not ok and checks["gap"]["value"] == math.inf


def test_widest_gap_sees_a_nan_anywhere():
    assert compare.widest([0.1, math.nan, 0.2]) == math.inf
    assert compare.widest([0.1, 0.3, 0.2]) == 0.3
    assert compare.widest([]) == math.inf


def test_judge_fails_a_missing_or_nan_number():
    limits = {"x": {"limit": 1.0}, "y": {"limit": 0}}
    assert compare.judge({"x": 0.5, "y": 0.0}, limits)[0]
    assert not compare.judge({"x": 0.5}, limits)[0]
    assert not compare.judge({"x": math.nan, "y": 0.0}, limits)[0]
    assert not compare.judge({"x": 1.5, "y": 0.0}, limits)[0]
