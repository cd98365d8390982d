"""Capture I/O of the port: the reference's I/Q capture format."""

from dsdneo_tpu_torch.io.iq import IqMetadata, read_iq_capture, write_iq_capture

__all__ = ["IqMetadata", "read_iq_capture", "write_iq_capture"]
