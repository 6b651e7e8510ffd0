"""Multi-chip scale-out (new capability — the reference is single-process,
SURVEY.md section 2.4): keyframe/landmark blocks sharded over a
jax.sharding Mesh, with the reduced camera system of bundle adjustment
psum-reduced across the cards.
"""

from orb_slam3_study_kr_tpu.parallel.dist_ba import (
    distributed_bundle_adjust, make_ba_mesh,
)
