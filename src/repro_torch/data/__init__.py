"""Token pipelines (numpy; the port's own copy of ``repro.data``)."""

from repro_torch.data.pipeline import (FileCorpus, SyntheticLM,
                                      make_batch_specs, shard_for_rank)

__all__ = ["FileCorpus", "SyntheticLM", "make_batch_specs",
           "shard_for_rank"]
