from dicp_tpu_torch.utils.checkpoint import load_odometry_state, save_odometry_state
from dicp_tpu_torch.utils.profiling import benchmark, trace

# dicp_tpu.utils less the TPU clock (chained_rate, device_timing_is_trustworthy):
# the port times with CUDA events (utils/timing.py)
__all__ = ["benchmark", "trace", "save_odometry_state", "load_odometry_state"]
