from dicp_tpu_torch.io.native import (load_bin, native_available, range_filter,
                                save_bin, voxel_downsample_host)
from dicp_tpu_torch.io.dataset import ScanDataset, preprocess_scan

__all__ = [
    "ScanDataset",
    "load_bin",
    "native_available",
    "preprocess_scan",
    "range_filter",
    "save_bin",
    "voxel_downsample_host",
]
