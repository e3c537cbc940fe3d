"""The parallel layer's public names, imported on first use: those of the JAX
package's ``multimodal_auv_tpu/parallel/__init__.py`` that have a torch
counterpart. Its ``jax.sharding`` helpers (``batch_sharding``,
``replicated``, ``shard_batch``, ``mc_sharding``) are not ported: the port
passes the ``Mesh`` itself (parallel/mesh.py)."""

from multimodal_auv_torch._lazy import lazy_exports

_EXPORTS = {
    "host_shard_indices": "multimodal_auv_torch.parallel.distributed",
    "initialize_distributed": "multimodal_auv_torch.parallel.distributed",
    "make_mesh": "multimodal_auv_torch.parallel.mesh",
    "posterior_sharding": "multimodal_auv_torch.parallel.mesh",
    "shard_state": "multimodal_auv_torch.parallel.mesh",
}
__all__, __getattr__ = lazy_exports(__name__, _EXPORTS)
