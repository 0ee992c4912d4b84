"""Fused blind + limb-encode kernel and its oracle."""
