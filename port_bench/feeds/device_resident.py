"""Gwilliams2022 batches gathered on the card: ``DeviceResidentGwilliams``
over the seed's MEG-MASC world, index batches drawn as ``train.py`` draws
them (``updates`` sampling: rows distinct within a batch, drawn anew for
each batch).

The batcher is built the way its constructor builds it, field by field,
from stacks drawn on the card: the constructor takes a dataset of host
arrays and would stage the 33 GiB world through host memory. Any change to
``DeviceResidentGwilliams.__init__`` has to be mirrored here;
``test_port_bench_harness.py`` compares the two.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from port_bench import reference, world
from port_bench.trace import span

DATASET = "Gwilliams2022"


def build_batcher(w: world.GwilliamsWorld, device):
    """(dataset, batcher) as a build leaves them, over the world's stacks."""
    from speech_decoding_tpu_torch.data.device_resident import DeviceResidentGwilliams
    from speech_decoding_tpu_torch.data.gwilliams2022 import Gwilliams2022DatasetBase

    ds = Gwilliams2022DatasetBase.__new__(Gwilliams2022DatasetBase)
    ds.X = {k: {} for k in w.session_keys}
    ds.num_segments_foreach_task = list(w.words)
    b = DeviceResidentGwilliams.__new__(DeviceResidentGwilliams)
    b.device, b.ds, b.channels_last, b.quantized, b.seq_len = device, ds, True, False, w.L
    b.keys, b.rec_index, b.subject_of_rec = list(w.session_keys), dict(w.rec_index), w.subject_of_rec
    b.X_stack, b.Y_stack, b.stats_stack, b.onsets_stack = w.X_stack, w.Y_stack, w.stats_stack, w.onsets_stack
    b.x_scale = b.y_scale = None
    b.seg_task_ids, b.seg_y_onsets = w.seg_task_ids, w.seg_y_onsets
    b._arange = torch.arange(w.L, device=device)
    return ds, b


class Feed:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from speech_decoding_tpu_torch.data.sampling import random_split

        if cfg["store_dtype"] != "float32":
            raise ValueError("the world is drawn in float32; other stores are not built")
        self.world = world.GwilliamsWorld(cfg, seed, device)
        self.ds, self.batcher = build_batcher(self.world, device)
        self.batch, self.seed, self.clamp_lim = int(traffic["batch"]), seed, cfg["clamp_lim"]
        self.train_pool, _ = random_split(self.world.n_segments, cfg["split_ratio"],
                                          np.random.default_rng(world.sub_seed(seed, 8)))
        self.drawn: List[tuple] = []

    @staticmethod
    def config_overrides(cfg: Dict) -> List[str]:
        return ["tpu.device_resident_data=true", "tpu.channels_last_io=true", f"tpu.data_dtype={cfg['store_dtype']}"]

    @staticmethod
    def collate(args):
        from speech_decoding_tpu_torch.train import build_collate

        return build_collate(args)

    def epoch(self, epoch: int, n_batches=None, deadline=None, counter=None, distinct=False,
              record=False) -> Iterator[Dict]:
        """Batches of epoch ``epoch`` until ``n_batches`` or ``deadline``;
        ``distinct``: rows that differ across the batches too (one
        permutation of the pool); ``record``: keep the draws for the
        reference."""
        from speech_decoding_tpu_torch.data.sampling import iter_updates_batches

        rng = np.random.default_rng(world.sub_seed(self.seed, 9, epoch))
        if distinct:
            ids_iter = iter(rng.permutation(self.train_pool)[: n_batches * self.batch].reshape(n_batches, -1))
        else:
            ids_iter = iter_updates_batches(self.train_pool, self.batch, n_batches or 10**9, rng)
        for ids in ids_iter:
            if deadline is not None and time.perf_counter() >= deadline:
                return
            with span("batch_fetch"):
                choices = self.ds.draw_choices(rng, len(ids))
                if record:
                    self.drawn.append((ids, choices))
                out = self.batcher.gather(self.batcher.make_index_batch(rng, ids, choices))
            if counter is not None:
                counter[0] += 1
            yield out

    def reference_batches(self, n: int) -> List[Dict]:
        """The reference's own gather of the first ``n`` recorded batches."""
        out = []
        for ids, choices in self.drawn[:n]:
            win = self.world.windows(ids, choices)
            out.append({"X": reference.collate(win["X"], win["stats"], self.clamp_lim), "Y": win["Y"],
                        "subject_idxs": win["subject_idxs"]})
        return out

    def close(self) -> None:
        """Frees the world and the batcher's stacks."""
        self.world = self.ds = self.batcher = None
