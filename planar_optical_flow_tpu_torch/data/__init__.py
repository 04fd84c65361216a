"""Host data layer of the port: the DROW readers, the synthetic DROW
writer, the detection dataset and the batch loader."""

from planar_optical_flow_tpu_torch.data.drow_io import (
    list_sequences,
    load_detection_file,
    load_odometry_file,
    load_scan_file,
)
from planar_optical_flow_tpu_torch.data.drow_detection import (
    DrowDetectionDataset,
)
from planar_optical_flow_tpu_torch.data.loader import BatchLoader
from planar_optical_flow_tpu_torch.data.synthetic import (
    make_synthetic_drow_sequence,
    write_synthetic_drow_split,
)

__all__ = ["BatchLoader", "DrowDetectionDataset", "list_sequences",
           "load_detection_file", "load_odometry_file", "load_scan_file",
           "make_synthetic_drow_sequence", "write_synthetic_drow_split"]
