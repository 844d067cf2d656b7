"""Multi-GPU training and serving: one process per GPU over
``torch.distributed`` (``multihost``, ``mesh``, ``council_shard``)."""
