"""Data parallelism on ``torch.distributed``: one process per card under
``torchrun`` (replaces the JAX package's device mesh and the reference's
torch DDP / NCCL).  ``distributed`` starts the process group, ``mesh``
holds the data axis's helpers, ``dryrun`` the counterpart of
``__graft_entry__.dryrun_multichip`` and a small rank launcher."""
