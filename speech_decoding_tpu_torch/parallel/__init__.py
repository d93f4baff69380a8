"""Parallelism across processes: the "data" process group and the
("data", "model") grid, host-local batches, the collectives of the step,
the column-parallel encoder (``sharding_rules``), the sharded CLIP loss and
retrieval, and sharded brain preprocessing (``preproc_sharded``; port of
``speech_decoding_tpu/parallel``)."""

from speech_decoding_tpu_torch.parallel.clip_sharded import (
    accuracy_from_local_similarity,
    clip_loss_sharded,
    retrieval_metrics_sharded,
)
from speech_decoding_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataGroup,
    Grid,
    ModelGroup,
    current_group,
    data_group,
    make_grid,
    shard_batch,
)
from speech_decoding_tpu_torch.parallel.sharding_rules import (
    gather_encoder_params,
    gather_split,
    param_shardings,
    partition_encoder,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "DataGroup",
    "Grid",
    "ModelGroup",
    "accuracy_from_local_similarity",
    "clip_loss_sharded",
    "current_group",
    "data_group",
    "gather_encoder_params",
    "gather_split",
    "make_grid",
    "param_shardings",
    "partition_encoder",
    "retrieval_metrics_sharded",
    "shard_batch",
]
