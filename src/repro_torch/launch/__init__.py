# Entry points (port of repro.launch): serve.py, OnAlgo-gated serving of
# the cloudlet LM.  train.py, dryrun.py and mesh.py are not ported yet
# (ROADMAP.md queue A items 11-13).
