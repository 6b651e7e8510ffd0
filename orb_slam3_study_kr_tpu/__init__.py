"""Visual / visual-inertial / multi-map SLAM engine in JAX.

A from-scratch re-design of the ORB-SLAM3 capability surface
(reference: hanseongbugi/ORB_SLAM3_Study_kr) as fixed-shape array programs
for one accelerator, an NVIDIA GPU:

- perception kernels (ORB pyramid / FAST / BRIEF, Hamming matching) as
  batched fixed-shape JAX programs,
- estimation (pose optimization, local/global bundle adjustment, Sim3 /
  4-DoF pose graphs, IMU preintegration) as dense-block Gauss-Newton /
  Levenberg-Marquardt solvers with Schur-complement landmark
  marginalization,
- the map (keyframes, landmarks, covisibility, Atlas) as structure-of-
  array device tables with masks instead of pointer graphs and mutexes,
- multi-card bundle adjustment via a jax.sharding Mesh + shard_map.

Layer map (mirrors SURVEY.md section 1 of the reference):
  lie/        L0  Lie groups (SO3/SE3/Sim3)           <- Thirdparty/Sophus
  solvers/    L1+L4 GN/LM, Schur BA, pose graphs      <- Thirdparty/g2o + src/Optimizer.cc
  bow/        L2  binary-descriptor place recognition <- Thirdparty/DBoW2
  ops/        L3  perception kernels                  <- src/ORBextractor.cc, ORBmatcher.cc
  cameras/    L3  camera models + two-view init       <- src/CameraModels, TwoViewReconstruction.cc
  imu/        L4  preintegration                      <- src/ImuTypes.cc
  slam_map/   L5  frames/keyframes/landmarks/Atlas    <- src/{Frame,KeyFrame,MapPoint,Map,Atlas}.cc
  pipeline/   L6-L7 tracking / mapping / loop closing / System
  io/         L9  dataset drivers, trajectory writers <- Examples/
  evaluation/ L10 ATE evaluation                      <- evaluation/
  parallel/   --  device-mesh sharding (new: reference is single-process)
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry accuracy is load-bearing: reduced-precision matmul inputs
# (bfloat16, or TF32 on the GPU) carry ~1e-3 relative error, which
# depth/baseline ratios (>20x in triangulation) amplify into percent-level
# 3-D error.  All dots in this package therefore default to full float32;
# products that are exact at low precision (descriptor-distance matrices of
# {0,1} operands) opt in to bfloat16 at the call site.
_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent XLA compilation cache: the pipeline's fixed-shape stages are
# bucketed, so each bucket's compile is paid once per checkout instead of
# once per process.  JAX itself reads JAX_COMPILATION_CACHE_DIR when it is
# set; otherwise the cache lives at one fixed path inside the checkout (the
# path is part of the cache key, so it must not move between runs).
# XLA:CPU AOT deserialization is unreliable (segfaults in
# compilation_cache.get_executable_and_time loading blobs whose
# prefer-no-scatter/-gather pseudo-features the host detector rejects), so
# a process whose default platform is the CPU persists nothing.
import os as _os

if (not _jax.config.jax_compilation_cache_dir
        and _os.environ.get("JAX_PLATFORMS", "").split(",")[0] != "cpu"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
