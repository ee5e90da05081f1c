"""mcmh_localization — accelerator-native Monte Carlo / Metropolis-Hastings
localization.

A ground-up JAX/XLA re-design of the capabilities of
``gustavorvillela/mcmh_localization`` (a ROS1 + Numba particle-filter
localization package): six algorithm modes (MCL, AMCL, MHMCL, MHAMCL,
AMHMCL, AMHAMCL) built as ONE pure-functional filter step with three
orthogonal switches, running entirely on device with static shapes,
sharded over a ``jax.sharding.Mesh`` for multi-chip scale.

Layer map (mirrors SURVEY.md §1 of the reference):
  - ``maps``     : occupancy-grid map + Euclidean distance transform
                   (replaces map_server + scipy EDT at amcmh_localizer.py:124-177)
  - ``models``   : odometry motion model + sensor models
                   (replaces parallel_utils.py kernels)
  - ``ops``      : resampling (replaces the Numba @njit resamplers)
  - ``filter``   : FilterState pytree + the unified step function
                   (replaces the AMCMHLocalizer node, amcmh_localizer.py:15-631)
  - ``parallel`` : shard_map/pjit particle-axis sharding (new; reference is
                   single-host Numba prange only)
  - ``sim``      : synthetic TurtleBot3-style trajectory + scan simulator
                   (replaces the stripped evaluation rosbags)
  - ``eval``     : RMSE protocol byte-compatible with
                   evaluate_localization.py output formats
"""

__version__ = "0.1.0"

from mcmh_localization.config import FilterConfig, parse_mode
from mcmh_localization.maps.grid_map import GridMap, load_map

__all__ = [
    "FilterConfig",
    "parse_mode",
    "GridMap",
    "load_map",
    "__version__",
]
