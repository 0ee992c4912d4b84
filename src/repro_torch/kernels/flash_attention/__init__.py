"""Flash-attention forward kernel and its oracle."""
