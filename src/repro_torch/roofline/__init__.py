"""repro_torch.roofline — three-term roofline analysis from the dry run's walks."""

from repro_torch.roofline.analysis import HW_H100, Hardware, RooflineReport, analyze, collective_bytes
