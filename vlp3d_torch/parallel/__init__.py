"""Data parallel: the multi-process rendezvous and collectives
(:mod:`~vlp3d_torch.parallel.distributed`), device lists for the serving
predictors (:mod:`~vlp3d_torch.parallel.mesh`) and the global sums of a
sharded batch (:mod:`~vlp3d_torch.parallel.reduce`)."""

from vlp3d_torch.parallel.reduce import LOCAL, BatchShard

__all__ = ["LOCAL", "BatchShard"]
