"""Multi-device sharding: mesh helpers, sharded acquisition and tracking."""

from gps_sdr_tpu.parallel.mesh import make_mesh
from gps_sdr_tpu.parallel.acquisition import sharded_acquisition_power
from gps_sdr_tpu.parallel.tracking import sharded_track_scan
from gps_sdr_tpu.parallel.epoch import sharded_wls_normal_equations

__all__ = ["make_mesh", "sharded_acquisition_power", "sharded_track_scan",
           "sharded_wls_normal_equations"]
