"""Data parallelism across processes: the "data" process group, host-local
batches, the collectives of the step, the sharded CLIP loss and retrieval,
and sharded brain preprocessing (``preproc_sharded``; port of
``speech_decoding_tpu/parallel``)."""

from speech_decoding_tpu_torch.parallel.clip_sharded import (
    accuracy_from_local_similarity,
    clip_loss_sharded,
    retrieval_metrics_sharded,
)
from speech_decoding_tpu_torch.parallel.mesh import DATA_AXIS, DataGroup, current_group, data_group, shard_batch

__all__ = [
    "DATA_AXIS",
    "DataGroup",
    "accuracy_from_local_similarity",
    "clip_loss_sharded",
    "current_group",
    "data_group",
    "retrieval_metrics_sharded",
    "shard_batch",
]
