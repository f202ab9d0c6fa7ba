"""RIRs, scenes, device resolution and conversion from the JAX package;
the exports are the JAX package's ``utils``."""

from apvast_torch.utils.rir import from_vast_layout, load_reference_rirs, synthetic_rirs

__all__ = ["from_vast_layout", "load_reference_rirs", "synthetic_rirs"]
