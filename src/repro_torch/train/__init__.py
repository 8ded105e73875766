"""Training substrate (port of ``repro.train``): optimizers, atomic
checkpoints in the reference's on-disk format, the fault-tolerant loop,
int8 gradient compression on torch.distributed."""
