"""Origami core of the port: PRNG, blinding, sealing, attestation,
integrity, the Slalom protocol, precompute, the plan IR and the executor."""
