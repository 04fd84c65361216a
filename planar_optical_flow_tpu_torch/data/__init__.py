"""Host data layer of the port: the DROW, JRDB and PCD readers, the
synthetic DROW and JRDB writers, the detection, scan-pair flow and
box-regression datasets and the batch loader."""

from planar_optical_flow_tpu_torch.data.drow_io import (
    list_sequences,
    load_detection_file,
    load_diff_odometry_file,
    load_flow_file,
    load_odometry_file,
    load_scan_file,
)
from planar_optical_flow_tpu_torch.data.drow_detection import (
    DrowDetectionDataset,
)
from planar_optical_flow_tpu_torch.data.drow_flow import FlowScanPairDataset
from planar_optical_flow_tpu_torch.data.jrdb import (
    JrdbBoxRegressionDataset,
    JrdbHandle,
    write_synthetic_jrdb,
)
from planar_optical_flow_tpu_torch.data.loader import BatchLoader
from planar_optical_flow_tpu_torch.data.synthetic import (
    make_synthetic_drow_sequence,
    make_synthetic_jrdb,
    write_synthetic_drow_split,
)

__all__ = ["BatchLoader", "DrowDetectionDataset", "FlowScanPairDataset",
           "JrdbBoxRegressionDataset", "JrdbHandle", "list_sequences",
           "load_detection_file", "load_diff_odometry_file",
           "load_flow_file", "load_odometry_file", "load_scan_file",
           "make_synthetic_drow_sequence", "make_synthetic_jrdb",
           "write_synthetic_drow_split", "write_synthetic_jrdb"]
