"""The work counts and the roofline arithmetic against sums by hand at a
small shape."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import roofline  # noqa: E402
from perfbench.work import maxcall_mega, put_fusedpath, put_mega  # noqa: E402

sys.path.remove(str(ROOT))

PUT = {"n_paths": 8, "n_steps": 4, "regression": {"degree": 1}}
BASKET = {"n_paths": 8, "n_steps": 3, "regression": {"degree": 1},
          "market": {"S0": [100.0, 100.0]}, "product": {"exercise_from_step": 1}}


def test_put_mega_by_hand():
    # k = 2 columns: 3 Gram pairs + 2 rhs = 5 products a path-step
    assert put_mega.work(PUT) == {
        "pathgen": {"bytes": 5 * 8 * 4, "f32": 6 * 4 * 8},
        "induction": {"bytes": 5 * 8 * 4 + 4 * 5 * 4, "f32": 4 * 8 * (5 + 3), "f64": 4 * 8 * 5},
    }


def test_put_fusedpath_by_hand():
    assert put_fusedpath.work(PUT) == {
        "induction": {"bytes": 4 * 5 * 4 + 8, "f32": 4 * 8 * (50 + 8 + 3 + 4 + 5 + 3),
                      "f64": 4 * 8 * 5}}


def test_maxcall_mega_by_hand():
    # 2 assets, degree 1: columns 1, x1, x2 (m = 3), 6 pairs + 3 rhs = 9
    assert maxcall_mega.work(BASKET) == {
        "pathgen": {"bytes": 4 * 8 * 2 * 4, "f32": 6 * 3 * 8 * 2},
        "induction": {"bytes": 4 * 8 * 2 * 4, "f32": 8 * (3 * 9 + 2 * 5), "f64": 3 * 8 * 9},
    }


def test_the_flagship_path_array_bound_matches_its_bytes():
    # 1,048,576 x 101 f32 written once at 3.35 TB/s: 0.1265 ms
    w = put_mega.work({"n_paths": 1_048_576, "n_steps": 100, "regression": {"degree": 4}})
    assert roofline.bound_s(w["pathgen"]) == pytest.approx(101 * 1_048_576 * 4 / 3.35e12)


def test_bound_takes_the_larger_of_bytes_and_operations():
    peaks = {"hbm_bytes_per_s": 10.0, "f32_ops_per_s": 4.0, "f64_ops_per_s": 2.0}
    assert roofline.bound_s({"bytes": 30, "f32": 4, "f64": 2}, peaks) == 3.0
    assert roofline.bound_s({"bytes": 10, "f32": 8, "f64": 6}, peaks) == 5.0


def test_share_reads_nothing_without_a_span_or_a_layer():
    ctx = {"work": {"pathgen": {"bytes": 3.35e9}}, "spans": {"pathgen": 0.002}}
    assert roofline.share_pct(ctx, "pathgen") == pytest.approx(50.0)
    assert roofline.share_pct(ctx, "induction") is None
    assert roofline.share_pct({"work": ctx["work"], "spans": {}}, "pathgen") is None
