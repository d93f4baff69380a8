"""Serve a trained decoder over HTTP on the GPU (micro-batching; see
``speech_decoding_tpu_torch/serving.py`` for the endpoints and batching).

    # a checkpoint of the port's trainer (latest; eval.best=true for the
    # best-model one, eval.epoch=N for a given epoch)
    python -m speech_decoding_tpu_torch.serve outputs/<run>/config.yaml \
        checkpoint.dir=outputs/<run>/checkpoints serve.bank=bank.npz

    # reference-trained torch checkpoint
    python -m speech_decoding_tpu_torch.serve dataset=Gwilliams2022 \
        torch_checkpoint=model_last.pt serve.bank=bank.npz serve.port=8989

Port of ``tools/serve.py`` with the same ``serve.*`` keys. ``serve.bank`` is
an .npz holding ``bank`` (N, F, T), or a raw ``.npy``. Options: serve.host
(127.0.0.1), serve.port (8989), serve.max_batch (64), serve.max_wait_ms
(3.0), serve.bank_dtype ("float32" | "int8"), serve.segment_len (defaults to
the bank's T), serve.warmup_k (10; 0 skips the warm-up decode before
listening), serve.num_subjects (27, for ``checkpoint.dir``), serve.device
("cuda"; "cpu" only when asked). The model comes from ``torch_checkpoint=``
(a reference ``state_dict``) or from ``checkpoint.dir=`` (the port's
``training.CheckpointManager``; the encoder is built from the config, as it
was trained). Orbax directories of the JAX package are not read.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def build_decoder(args, device=None):
    """A ``SpeechDecoder`` from a reference torch checkpoint
    (``torch_checkpoint=``; the encoder computes in f32 whatever
    ``tpu.compute_dtype`` says, as ``tools/serve.py`` builds the JAX encoder
    with its default dtype) or from a checkpoint of the port's trainer
    (``checkpoint.dir=``, with ``eval.best`` and ``eval.epoch``; the encoder
    from the config, as it was trained)."""
    import torch

    from speech_decoding_tpu_torch.data.layout import ch_locations_2d
    from speech_decoding_tpu_torch.inference import SpeechDecoder
    from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from speech_decoding_tpu_torch.models.params_bridge import load_flax
    from speech_decoding_tpu_torch.models.torch_port import brain_encoder_from_torch

    torch_ckpt = args.select("torch_checkpoint", None)
    ckpt_dir = args.select("checkpoint.dir", None)
    if not (torch_ckpt or ckpt_dir):
        raise ValueError("pass checkpoint.dir=<dir> or torch_checkpoint=<model_last.pt>")
    loc = ch_locations_2d(args.dataset, args.root_dir)
    if not torch_ckpt:
        if not os.path.isabs(ckpt_dir):
            ckpt_dir = os.path.join(args.root_dir, ckpt_dir)
        encoder = BrainEncoder.from_config(args, loc, int(args.select("serve.num_subjects", 27)))
        epoch = args.select("eval.epoch", None)
        return SpeechDecoder.from_checkpoint(ckpt_dir, encoder, epoch=None if epoch is None else int(epoch),
                                             best=bool(args.select("eval.best", False)), device=device)
    sd = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
    params, batch_stats, dims = brain_encoder_from_torch(sd)
    encoder = BrainEncoder(
        num_subjects=dims["S"], loc=loc, D1=dims["D1"], D2=dims["D2"], F=dims["F"], K=dims["K"],
        compute_dtype=torch.float32,
    )
    load_flax(encoder, params, batch_stats)
    return SpeechDecoder(encoder, device=device)


def load_bank(path: str) -> np.ndarray:
    bank = np.load(path)["bank"] if path.endswith(".npz") else np.load(path)
    if bank.ndim != 3:
        raise ValueError(f"bank must be (N, F, T), got {bank.shape}")
    return bank


def main(argv=None) -> None:
    from speech_decoding_tpu_torch.config import load_config
    from speech_decoding_tpu_torch.serving import DecoderServer
    from speech_decoding_tpu_torch.utils.logging import cprint

    argv = list(sys.argv[1:] if argv is None else argv)
    config_path = None
    if argv and argv[0].endswith((".yaml", ".yml")):
        config_path, argv = argv[0], argv[1:]
    args = load_config(config_path, argv)
    if "root_dir" not in args:
        args.root_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    bank_path = args.select("serve.bank", None)
    if not bank_path:
        raise ValueError("pass serve.bank=<bank.npz|bank.npy> (array (N, F, T))")
    bank = load_bank(bank_path)
    decoder = build_decoder(args, device=str(args.select("serve.device", "cuda")))
    decoder.set_bank(bank, store_dtype=str(args.select("serve.bank_dtype", "float32")))

    seg_len = int(args.select("serve.segment_len", bank.shape[-1]))
    max_batch = int(args.select("serve.max_batch", 64))
    num_ch = decoder.encoder.loc.shape[0]

    # one decode at the dispatch shape before listening: builds the kernels
    # (nvcc at first use) and warms the allocator outside any client's request
    warmup_k = int(args.select("serve.warmup_k", 10))
    if warmup_k > 0:
        cprint(f"warming decode (B={max_batch}, k={warmup_k})...", "cyan")
        decoder.decode(
            np.zeros((max_batch, num_ch, seg_len), np.float32),
            np.zeros((max_batch,), np.int32),
            k=warmup_k,
        )

    server = DecoderServer(
        decoder,
        segment_shape=(num_ch, seg_len),
        host=str(args.select("serve.host", "127.0.0.1")),
        port=int(args.select("serve.port", 8989)),
        max_batch=max_batch,
        max_wait_ms=float(args.select("serve.max_wait_ms", 3.0)),
    )
    server.serve_forever()


if __name__ == "__main__":
    main()
