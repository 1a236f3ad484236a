"""Dataset I/O: calibration registry, event readers, pose readers, writers,
the native event store."""
