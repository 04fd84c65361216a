"""The scan pool and the restart schedule: a function of the seed and the
step index, with the churn mix's restarts at their mean."""

import numpy as np
import pytest

from portbench.traffic import streams as gen

PARAMS = {"generator": "streams", "pool_sequences": 3, "pool_frames": 20,
          "people": [2, 5], "scan_hz": 15, "restart_mean_scans": None}


def _walk(params, b, seed, steps):
    s = gen.make(params, b, 450, seed, "cpu")
    rows, restarts = [], []
    for k in range(steps):
        r, rs = s.advance(k)
        rows.append(r.copy())
        restarts.append(rs.copy())
    return s, np.stack(rows), restarts


def test_pool_repeats_from_seed():
    a = gen.make_pool(PARAMS, 450, 2 ** 31 + 7, "cpu")
    b = gen.make_pool(PARAMS, 450, 2 ** 31 + 7, "cpu")
    c = gen.make_pool(PARAMS, 450, 2 ** 31 + 8, "cpu")
    assert a.shape == (60, 450)
    assert bool((a == b).all()) and not bool((a == c).all())
    assert float(a.min()) > 0.0 and float(a.max()) <= 29.99 + 1e-6
    # people and walls: not every beam at the maximum range
    assert float((a < 29.0).float().mean()) > 0.5


def test_consecutive_scans_are_consecutive_frames():
    s, rows, _ = _walk(PARAMS, 4, 3, 60)
    frames = rows % PARAMS["pool_frames"]
    step = np.abs(np.diff(frames, axis=0))
    assert set(np.unique(step)) <= {0, 1}  # 0 where a sequence turns back
    assert bool((rows // PARAMS["pool_frames"] == rows[0] //
                 PARAMS["pool_frames"]).all())


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 12])
def test_churn_schedule_repeats_and_holds_its_mean(seed):
    churn = dict(PARAMS, restart_mean_scans=1000)
    _, rows_a, rs_a = _walk(churn, 384, seed, 1000)
    _, rows_b, rs_b = _walk(churn, 384, seed, 1000)
    assert (rows_a == rows_b).all()
    assert all((x == y).all() for x, y in zip(rs_a, rs_b))
    n_steps = sum(1 for r in rs_a[1:] if r.size)
    n_restarts = sum(r.size for r in rs_a)
    # 1 - (1 - 1/1000)^384 = 0.319 of the steps; 384/1000 restarts a step
    assert 310 <= n_steps <= 320
    assert 375 <= n_restarts <= 384
    # every seed: the same counts, in another order
    _, _, rs_c = _walk(churn, 384, seed + 1, 1000)
    assert [r.size for r in rs_c].count(0) == [r.size for r in rs_a].count(0)
    assert [r.size for r in rs_c] != [r.size for r in rs_a]


def test_restarted_stream_moves_to_a_new_segment():
    churn = dict(PARAMS, restart_mean_scans=4)
    _, rows, rs = _walk(churn, 3, 11, 40)
    seen = 0
    for k in range(1, 40):
        for i in rs[k]:
            seen += 1
            assert rs[k].size <= 3
    assert seen > 0


def test_steady_never_restarts():
    _, _, rs = _walk(PARAMS, 8, 5, 300)
    assert sum(r.size for r in rs) == 0
