"""PyTorch + CUDA port of ``speech_decoding_tpu`` for NVIDIA Hopper GPUs.

Same module names as the JAX package; imports torch, numpy and the standard
library only. Hand-written CUDA kernels live in ``csrc/`` and build at first
use (``ops/_build.py``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
