"""RIRs, scenes, device resolution and conversion from the JAX package."""
