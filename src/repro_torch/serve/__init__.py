# Service tier (port of repro.serve): quantization into the state space
# (admission.py), the lowering of a service run to the fleet-engine
# contract (compile.py) and the end-to-end simulator (simulator.py).
