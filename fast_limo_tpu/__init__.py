"""fast_limo_tpu — a JAX LiDAR-inertial odometry & SLAM engine.

A from-scratch JAX/XLA re-design of the capabilities of fast_LIMO
(fetty31/fast_LIMO): iterated error-state Kalman filtering on manifolds,
motion-compensated deskewing, direct point-to-plane scan-to-map registration
against an incremental voxel-hash map, loop closure and pose-graph
optimization — all as fixed-shape, jit-compiled array programs that scale
over a `jax.sharding.Mesh`.

Reference parity notes cite `file:line` of the reference tree
(fetty31/fast_LIMO @ 2025-05-23).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# float32 operands must multiply in float32: on an H100 the default lets
# XLA run float32 matmuls in TF32 (about three decimal digits), which the
# filter's covariance algebra, plane fits, Jacobian products and the map's
# exact one-hot lane permutation (mapper._planarize) cannot take (the
# reference runs them in double).  The affected matmuls are tiny.
_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent compilation cache.  An explicit JAX_COMPILATION_CACHE_DIR wins
# (JAX reads it itself); otherwise the cache lives at a fixed path inside
# the checkout, so repeated runs of one checkout hit it.
CACHE_DIR = None
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    CACHE_DIR = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        "build", "jax_cache")
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from fast_limo_tpu.utils.config import Config  # noqa: E402,F401
