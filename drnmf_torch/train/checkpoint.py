"""Model checkpoints: the flat parameter dict as ``.npz``, with ``__meta_``
keys for metadata -- the same file the JAX package writes and reads, so a
checkpoint moves between the two packages as it is -- and, for parameters
sharded over ranks, a ``torch.distributed.checkpoint`` directory that each
rank writes its own blocks of (``save_checkpoint_sharded``)."""

import os

import numpy as np


def _to_numpy(v):
    if hasattr(v, "detach"):  # a torch tensor, on any device
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, params, meta=None):
    arrays = {k: _to_numpy(v) for k, v in params.items()}
    if meta:
        for k, v in meta.items():
            arrays[f"__meta_{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path):
    """-> (params: dict name -> np.ndarray, meta: dict name -> np.ndarray)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        params = {k: data[k] for k in data.files if not k.startswith("__meta_")}
        meta = {k[len("__meta_"):]: data[k]
                for k in data.files if k.startswith("__meta_")}
    return params, meta


# -- sharded checkpoints (torch.distributed.checkpoint) ----------------------

def save_checkpoint_sharded(path, params, meta=None, mesh=None, dims=None):
    """A ``torch.distributed.checkpoint`` directory of a parameter dict:
    the counterpart of the JAX package's orbax pair
    (``save_checkpoint_orbax`` / ``load_checkpoint_orbax``,
    ``drnmf_tpu/train/checkpoint.py:34-54``), named for what it does here.

    Without a mesh (or a mesh of one rank) one process writes every tensor,
    with no process group.  Under a mesh every rank calls this with its
    own FSDP blocks and their sharded dimensions (name -> dimension or
    None, over dp; ``parallel.fsdp_shard_params`` returns both), and each
    writes only its own blocks, as orbax writes each shard from its owning
    host; a tensor that is not sharded (``dims`` None: all of them) is
    written once.  ``meta``: name -> picklable value.  Writes from host
    copies, so the card's tensors need no backend support."""
    import torch
    import torch.distributed.checkpoint as dcp

    state = {"meta": dict(meta or {}),
             "params": {k: torch.as_tensor(_to_numpy(v))
                        for k, v in params.items()}}
    if mesh is None or mesh.world == 1:
        dcp.save(state, checkpoint_id=os.path.abspath(path), no_dist=True)
        return
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    layout = DeviceMesh("cpu", torch.arange(mesh.world).view(mesh.n_dp,
                                                              mesh.n_tp))
    for k, v in state["params"].items():
        dim = None if dims is None else dims[k]
        place = [Replicate() if dim is None else Shard(dim), Replicate()]
        state["params"][k] = DTensor.from_local(v.contiguous(), layout,
                                                place, run_check=False)
    dcp.save(state, checkpoint_id=os.path.abspath(path))


def load_checkpoint_sharded(path):
    """-> (params: name -> whole tensor on the CPU, meta) of a directory
    that :func:`save_checkpoint_sharded` wrote, in one process: the blocks
    every rank wrote are put back together."""
    import torch
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = os.path.abspath(path)
    state = {"params": {}, "meta": {}}
    for key, md in dcp.FileSystemReader(path).read_metadata() \
            .state_dict_metadata.items():
        group, name = key.split(".", 1)
        state[group][name] = (torch.empty(md.size, dtype=md.properties.dtype)
                              if isinstance(md, TensorStorageMetadata)
                              else None)
    dcp.load(state, checkpoint_id=path, no_dist=True)
    return state["params"], state["meta"]
