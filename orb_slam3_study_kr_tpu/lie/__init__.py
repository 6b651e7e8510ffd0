"""Batched Lie-group library (SO3 / SE3 / Sim3) in pure jax.numpy.

Replacement for the reference's header-only Sophus dependency
(/root/reference/Thirdparty/Sophus: se3.hpp, so3.hpp, sim3.hpp) and the IMU
Lie helpers (/root/reference/include/ImuTypes.h:254-260).

Rotations are stored as (..., 3, 3) matrices; rigid transforms as a pair
(R, t) with t of shape (..., 3); similarities as (R, t, s).  Every function
is batch-polymorphic over leading axes and differentiable, so Jacobians of
residuals through these maps come from jax autodiff, while the
right-Jacobian closed forms needed by IMU preintegration are provided
explicitly.
"""

from orb_slam3_study_kr_tpu.lie import so3, se3, sim3
from orb_slam3_study_kr_tpu.lie.so3 import (
    hat, vee, exp_so3, log_so3, left_jacobian_so3, right_jacobian_so3,
    right_jacobian_inv_so3, normalize_rotation,
)
from orb_slam3_study_kr_tpu.lie.se3 import (
    exp_se3, log_se3, se3_inverse, se3_compose, se3_apply, se3_matrix,
    se3_from_matrix, se3_identity,
)
from orb_slam3_study_kr_tpu.lie.sim3 import (
    exp_sim3, log_sim3, sim3_inverse, sim3_compose, sim3_apply, sim3_identity,
)
