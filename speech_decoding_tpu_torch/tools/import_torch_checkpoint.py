"""Import a reference-trained PyTorch checkpoint as a checkpoint of the
port's trainer.

Port of the JAX package's ``tools/import_torch_checkpoint.py``. The
reference saves encoder weights only (``model_last.pt``, [ref: train.py:259]);
this tool maps them onto the port's ``BrainEncoder`` (``models/torch_port.py``
and ``models/params_bridge.py``), in f32, and writes ``epoch_0.pt`` through
``training.CheckpointManager`` (a fresh Adam state, the config's
temperature), which ``speech_decoding_tpu_torch.train`` resumes or
fine-tunes, ``tools/evaluate.py`` evaluates and
``SpeechDecoder.from_checkpoint`` serves.

    python -m speech_decoding_tpu_torch.tools.import_torch_checkpoint model_last.pt out_ckpt_dir \
        [dataset=Gwilliams2022] [root_dir=.] [d_drop=0.1] [init_temperature=5.1]

Architecture dims (D1, D2, F, K, num_subjects) come from the state_dict; the
sensor layout from the dataset's layout cache. For a checkpoint trained on
real data, the position-exact layout must be there, since the
spatial-attention bases are a function of sensor positions
[ref: models.py:36-40].
"""

from __future__ import annotations

import sys
from typing import Dict

import torch


def import_checkpoint(pt_path: str, out_dir: str, dataset: str = "Gwilliams2022", root_dir: str = ".",
                      d_drop: float = 0.1, init_temperature: float = 5.1, device=None) -> Dict[str, int]:
    """Write ``out_dir/epoch_0.pt`` from the reference state_dict at
    ``pt_path``; the state is built on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``). Returns the inferred dims."""
    from speech_decoding_tpu_torch.data.layout import ch_locations_2d
    from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from speech_decoding_tpu_torch.models.params_bridge import load_flax
    from speech_decoding_tpu_torch.models.torch_port import brain_encoder_from_torch
    from speech_decoding_tpu_torch.training.checkpoint import CheckpointManager
    from speech_decoding_tpu_torch.training.state import create_train_state

    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    params, batch_stats, dims = brain_encoder_from_torch(sd)
    loc = ch_locations_2d(dataset, root_dir=root_dir)
    # the torch model registers cos/sin bases as buffers keyed on channel
    # count [ref: models.py:36-40]; the layout must provide the same sensors
    cos = sd.get("subject_block.spatial_attention.cos")
    if cos is not None and loc.shape[0] != cos.shape[-1]:
        raise ValueError(f"layout has {loc.shape[0]} sensors, checkpoint expects {cos.shape[-1]}")
    encoder = BrainEncoder(num_subjects=dims["S"], loc=loc, D1=dims["D1"], D2=dims["D2"], F=dims["F"],
                           K=dims["K"], d_drop=d_drop, compute_dtype=torch.float32)
    load_flax(encoder, params, batch_stats)
    state = create_train_state(encoder, init_temperature=init_temperature, device=device)
    CheckpointManager(out_dir).save(0, state)
    return dims


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        raise SystemExit(__doc__)
    over = dict(kv.split("=", 1) for kv in argv[2:])
    dims = import_checkpoint(argv[0], argv[1], dataset=over.get("dataset", "Gwilliams2022"),
                             root_dir=over.get("root_dir", "."), d_drop=float(over.get("d_drop", 0.1)),
                             init_temperature=float(over.get("init_temperature", 5.1)))
    print(f"imported {argv[0]}: {dims}; wrote a checkpoint (epoch 0) to {argv[1]}")


if __name__ == "__main__":
    main()
