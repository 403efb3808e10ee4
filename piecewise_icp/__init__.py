"""piecewise_icp — a JAX 4D point-cloud registration framework.

A from-scratch JAX/XLA implementation of the Piecewise-ICP pipeline
(target-free fine registration of terrestrial-laser-scanning time series for
deformation monitoring) with the full capability surface of the reference
C++/PCL implementation: preprocessing, PCA normals, supervoxel segmentation
into planar patches, iterative stable/unstable patch classification under a
monotonically decreasing distance threshold with Level-of-Detection floor,
point-to-plane ICP on stable patch centroids, variance-covariance estimation,
transform chaining with rigorous covariance propagation, Kalman-filter
smoothing of the transform time series, and multi-chip/multi-host scaling via
``jax.sharding``.

Public entry points mirror the reference C ABI (Registration.h:36,49):

>>> import piecewise_icp as pwicp
>>> pwicp.piecewise_icp_pair_call("config_pair.txt", "results/PairReg/")
>>> pwicp.piecewise_icp_4d_call("config_4d.txt", start_epoch=0,
...                             epoch_num=20, pair_mode=-1, overlap_thd=0.75)
"""

from .config import ARC_TO_GON, ConfigError, PiecewiseICPConfig

__version__ = "0.1.0"

__all__ = [
    "ARC_TO_GON",
    "ConfigError",
    "PiecewiseICPConfig",
    "piecewise_icp_pair_call",
    "piecewise_icp_4d_call",
    "register_pair",
]


def __getattr__(name):
    # Lazy imports keep `import piecewise_icp` light (no JAX device
    # initialisation until a pipeline entry point is touched).
    if name in ("piecewise_icp_pair_call", "register_pair"):
        from .models import pairwise
        return getattr(pairwise, name)
    if name == "piecewise_icp_4d_call":
        from .models import four_d
        return four_d.piecewise_icp_4d_call
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
