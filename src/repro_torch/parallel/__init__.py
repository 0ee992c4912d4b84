"""Multi-device offload: sharded blinded matmuls across a device pool."""
