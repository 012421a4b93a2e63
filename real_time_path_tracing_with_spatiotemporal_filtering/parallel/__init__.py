"""Multi-device execution over a device mesh.

The reference is strictly single-GPU (its only multi-device hook, nvvk
device groups, is never enabled -- context.hpp:153, SURVEY.md section 2).
The scaling story here is image-space data parallelism: shard the pixel rows
of the frame across a 1-D ``jax.sharding.Mesh`` with ``shard_map``, exchange
a-trous stencil halos between row-neighbors with ``jax.lax.ppermute`` (NCCL
over NVLink on a GPU host, where every card reaches every other, so the mesh
is a plain row axis), and gather history rows for temporal reprojection
through a small halo window.
"""
