# Entry points (port of repro.launch): serve.py, OnAlgo-gated serving of
# the cloudlet LM; mesh.py, device meshes on torch.distributed.  train.py
# and dryrun.py are not ported yet (ROADMAP.md queue A items 12-13).
