"""Sensor layouts (copied from the JAX package)."""

from speech_decoding_tpu_torch.data.layout import ch_locations_2d

__all__ = ["ch_locations_2d"]
