"""Runnable examples of the port (``python -m speech_decoding_tpu_torch.examples.<name>``)."""
