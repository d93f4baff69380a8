"""Logging and device helpers."""

from speech_decoding_tpu_torch.utils.device import resolve_device
from speech_decoding_tpu_torch.utils.logging import cprint, get_logger

__all__ = ["cprint", "get_logger", "resolve_device"]
