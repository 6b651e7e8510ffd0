"""Background mapping/loop worker (pipeline/async_mapping.py).

The reference runs LocalMapping/LoopClosing on dedicated threads
(System.cc:195-214); these tests check the background worker: keyframe
mapping off the frame path, the map-update lock keeping both threads
consistent, flush semantics, and end-to-end trajectory quality with the
worker enabled.
"""

import numpy as np
import pytest

from orb_slam3_study_kr_tpu.evaluation import ate_rmse
from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackState


def test_async_worker_unit():
    """Queue/flush/event mechanics without a pipeline."""
    from orb_slam3_study_kr_tpu.pipeline.async_mapping import AsyncMapping

    w = AsyncMapping(max_pending=2)
    hits = []
    for i in range(5):
        w.submit(lambda i=i: hits.append(i))
    w.flush()
    assert hits == [0, 1, 2, 3, 4]
    assert not w.busy
    w.post_event("loop", 7)
    assert w.drain_events() == [("loop", 7)]
    assert w.drain_events() == []
    # A crashing task surfaces at flush, not silently.
    w.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        w.flush()
    w.shutdown()


@pytest.mark.slow
def test_async_mono_pipeline():
    """Mono end-to-end with the background worker: tracking must stay OK,
    the worker must actually process keyframes, mapping results (new
    landmarks, BA) must land, and the trajectory must match ground truth
    about as well as the synchronous configuration does."""
    n_frames = 40
    rng = np.random.default_rng(5)
    world = synthetic.make_textured_world(rng)
    R, t = synthetic.lateral_trajectory(n_frames, x_span=1.0)
    slam = SlamSystem(SystemConfig(sensor="mono", async_mapping=True))
    ts = np.arange(n_frames) * 0.05
    for i in range(n_frames):
        img = synthetic.render_textured(world, R[i], t[i], rng=rng)
        slam.track_monocular(img, ts[i])
    slam.flush()
    assert slam.state == TrackState.OK
    assert slam.async_map.stats["n_processed"] > 0
    st = slam.stats()
    assert st["n_kf"] >= 4
    assert slam.local_mapper.stats["n_created"] > 0, "no triangulation ran"
    assert slam.local_mapper.stats["n_ba"] > 0, "no local BA ran"
    rows = slam.trajectory()
    cen = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)
    rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4], ts, cen,
                           with_scale=True)
    assert nm > 25
    assert rmse < 0.4, f"async-mode scaled ATE {rmse:.3f}"
    slam.shutdown()
