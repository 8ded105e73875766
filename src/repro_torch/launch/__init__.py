# Entry points (port of repro.launch): serve.py, OnAlgo-gated serving of
# the cloudlet LM; train.py, the fault-tolerant training loop; mesh.py,
# device meshes on torch.distributed.  dryrun.py is not ported yet
# (ROADMAP.md queue A item 13).
