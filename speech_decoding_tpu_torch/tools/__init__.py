"""Measurement and validation tools of the port, run as modules
(``python -m speech_decoding_tpu_torch.tools.<name>``)."""
