"""The port's C++ host module (``deft_tpu_torch/native``): ``lapjv`` against
scipy's assignment (the port's default) on random and degenerate costs with
equal optimal objectives, ``iou_matrix`` against ``ops/iou.py`` to 1e-12,
``warp_affine`` against ``ops/warp.py::warp_affine_uint8`` to within one
grey level, the ``DEFT_USE_NATIVE=1`` route of ``linear_assignment``, and a
failed build raising with the compiler's output.  The library is built
with g++ at first use into ``build/native/``, as on the card's machine.
"""

import numpy as np
import pytest

from deft_tpu_torch import native
from deft_tpu_torch.ops.iou import pairwise_iou
from deft_tpu_torch.ops.warp import warp_affine_uint8
from deft_tpu_torch.tracking import assignment
from deft_tpu_torch.tracking.assignment import linear_assignment


def objective(cost, matches, thresh):
    """lap.lapjv's extended objective: matched costs plus thresh/2 per
    unmatched row and column (finite, so comparable across solvers)."""
    n, m = cost.shape
    k = len(matches)
    return (sum(cost[i, j] for i, j in matches)
            + (n - k + m - k) * thresh / 2.0)


def check_same_optimum(cost, thresh):
    want, wr, wc = linear_assignment(cost, thresh)
    got, gr, gc = native.lapjv(cost, thresh)
    n, m = cost.shape
    assert len(got) + len(gr) == n and len(got) + len(gc) == m
    assert all(cost[i, j] <= thresh for i, j in got)
    clean = np.nan_to_num(cost, nan=1e9, posinf=1e9)
    assert abs(objective(clean, got, thresh)
               - objective(clean, want, thresh)) < 1e-9
    return got, want


def test_library_builds_into_build_native():
    lib = native.library()
    assert native.LIBRARY.exists() and native.LIBRARY.parent.name == "native"
    assert native.LIBRARY.parent.parent.name == "build"
    assert not native.is_stale(native.LIBRARY, [native.SOURCE])
    assert lib is native.library()


def test_lapjv_matches_scipy_objective():
    rng = np.random.RandomState(0)
    for _ in range(80):
        n, m = rng.randint(1, 40), rng.randint(1, 40)
        cost = rng.rand(n, m)
        thresh = float(rng.choice([0.0, 0.3, 0.9, 2.0]))
        got, want = check_same_optimum(cost, thresh)
        assert len(got) == len(want)


def test_lapjv_unique_optimum_same_pairs():
    """Where the optimum is unique (distinct random costs, a generous
    limit) both solvers pick the same pairs."""
    rng = np.random.RandomState(1)
    for _ in range(20):
        cost = rng.rand(12, 17)
        got, want = check_same_optimum(cost, 10.0)
        assert sorted(map(tuple, got)) == sorted(map(tuple, want))


@pytest.mark.parametrize("case", ["empty_rows", "empty_cols", "1xN", "Nx1",
                                  "above_limit", "nan_inf", "ties"])
def test_lapjv_degenerate(case):
    rng = np.random.RandomState(2)
    cost = {"empty_rows": np.zeros((0, 5)), "empty_cols": np.zeros((4, 0)),
            "1xN": rng.rand(1, 9), "Nx1": rng.rand(9, 1),
            "above_limit": rng.rand(6, 7) + 1.0,
            "nan_inf": rng.rand(7, 6), "ties": np.full((5, 5), 0.25)}[case]
    if case == "nan_inf":
        cost[0, :] = np.inf
        cost[:, 2] = np.nan
        cost[3, 4] = np.inf
    got, want = check_same_optimum(cost, 0.8)
    if case == "above_limit":
        assert len(got) == 0
    if case == "nan_inf":
        assert 0 not in got[:, 0] and 2 not in got[:, 1]
    if case.startswith("empty"):
        assert got.shape == (0, 2)


def test_iou_matrix_matches_ops_iou():
    rng = np.random.RandomState(3)
    a = rng.rand(15, 4) * 80
    b = rng.rand(25, 4) * 80
    a[:, 2:] += a[:, :2] + 1
    b[:, 2:] += b[:, :2] + 1
    b[0] = a[0]                                       # an exact overlap
    np.testing.assert_allclose(native.iou_matrix(a, b), pairwise_iou(a, b),
                               rtol=1e-12, atol=1e-12)
    assert native.iou_matrix(a[:0], b).shape == (0, 25)


@pytest.mark.parametrize("channels", [3, 1])
def test_warp_affine_matches_warp_affine_uint8(channels):
    rng = np.random.RandomState(4)
    img = (rng.rand(80, 120, channels) * 255).astype(np.uint8)
    if channels == 1:
        img = img[..., 0]
    M = np.array([[0.7, 0.05, 3.0], [-0.02, 0.8, 2.0]])
    got = native.warp_affine(img, M, (100, 70))
    want = warp_affine_uint8(img, M, 100, 70)
    assert got.shape == want.shape == (70, 100) + img.shape[2:]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_linear_assignment_native_route(monkeypatch):
    """``DEFT_USE_NATIVE=1`` sends every call to the C++ solver (read at
    each call), which the cascade then uses."""
    calls = []
    real = native.lapjv

    def counted(cost, thresh):
        calls.append(cost.shape)
        return real(cost, thresh)

    monkeypatch.setattr(native, "lapjv", counted)
    rng = np.random.RandomState(5)
    cost = rng.rand(6, 8)
    monkeypatch.delenv("DEFT_USE_NATIVE", raising=False)
    want = assignment.linear_assignment(cost, 0.5)
    assert calls == []
    monkeypatch.setenv("DEFT_USE_NATIVE", "1")
    got = assignment.linear_assignment(cost, 0.5)
    assert calls == [(6, 8)]
    assert abs(objective(cost, got[0], 0.5)
               - objective(cost, want[0], 0.5)) < 1e-12


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compile error raises with g++'s message; nothing falls back."""
    bad = tmp_path / "deft_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "build" / "lib.so")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.lapjv(np.ones((2, 2)), 0.5)
    monkeypatch.setenv("DEFT_USE_NATIVE", "1")
    with pytest.raises(RuntimeError, match="error"):
        linear_assignment(np.ones((2, 2)), 0.5)
