"""The parallel modes. Data parallel: the multi-process rendezvous and
collectives (:mod:`~vlp3d_torch.parallel.distributed`), device lists for
the serving predictors (:mod:`~vlp3d_torch.parallel.mesh`) and the global
sums of a sharded batch (:mod:`~vlp3d_torch.parallel.reduce`). On a
(data, model) grid of subgroups: ZeRO-1 (:mod:`~vlp3d_torch.parallel.zero`),
tensor parallel (:mod:`~vlp3d_torch.parallel.tensor_parallel`), the
pipeline over the BERT text layers (:mod:`~vlp3d_torch.parallel.pipeline`)
and the point-axis ops (:mod:`~vlp3d_torch.parallel.point_parallel`)."""

from vlp3d_torch.parallel.reduce import LOCAL, BatchShard

__all__ = ["LOCAL", "BatchShard"]
