"""Camera models: pinhole (+ radial-tangential distortion) and
Kannala-Brandt8 fisheye.

Array-program replacement for the reference's polymorphic GeometricCamera
hierarchy (/root/reference/include/CameraModels/GeometricCamera.h:61-86,
Pinhole.h, KannalaBrandt8.h).  Instead of C++ virtual dispatch, a camera is a
small pytree (`Camera`) whose `kind` is static metadata, so jit traces the
right projection code with no runtime branching; every function is batched
over points and differentiable (projection Jacobians via closed form where
hot, autodiff elsewhere).
"""

from orb_slam3_study_kr_tpu.cameras.camera import (
    Camera, CameraKind, make_pinhole, make_kb8, project, unproject,
    project_jac,
)
from orb_slam3_study_kr_tpu.cameras import pinhole, kb8
