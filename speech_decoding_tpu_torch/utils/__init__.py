"""Logging and device helpers."""

from speech_decoding_tpu_torch.utils.device import exact_f32, resolve_device
from speech_decoding_tpu_torch.utils.logging import cprint, get_logger

__all__ = ["cprint", "exact_f32", "get_logger", "resolve_device"]
