"""Multi-rank DR-NMF on ``torch.distributed`` (counterpart of
``drnmf_tpu/parallel``): the process group and layouts (``mesh``), sparse
NMF with frames split over ranks, and the tensor-parallel recurrence.
The JAX package's pipelined scans (``seqpipe``, ``layerpipe``) are not
ported yet; its ``_cache`` (compiled ``shard_map`` programs) has no
counterpart, since nothing is compiled a call."""

from .mesh import (Mesh, fsdp_param_sharding, fsdp_shard_params, init_group,
                   make_mesh, make_mesh_2d, replicate_params, run_ranks,
                   shard_batch, sparse_nmf_sharded)
from .tensor_parallel import (drnmf_apply_tp_dp, drnmf_scan_tp,
                              drnmf_scan_tp_train)

__all__ = [
    "Mesh",
    "init_group",
    "run_ranks",
    "make_mesh",
    "make_mesh_2d",
    "shard_batch",
    "replicate_params",
    "fsdp_param_sharding",
    "fsdp_shard_params",
    "sparse_nmf_sharded",
    "drnmf_scan_tp",
    "drnmf_scan_tp_train",
    "drnmf_apply_tp_dp",
]
