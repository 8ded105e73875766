# Service tier (port of repro.serve): quantization into the state space
# (admission.py), the lowering of a service run to the fleet-engine
# contract (compile.py), the end-to-end simulator (simulator.py), the
# wave/bucket machinery and the LM engine (engine.py), and the live
# OnAlgo serving gateway (gateway.py: a tick a slot on the card, K3 once
# a tick, and the async pipelined host loop with SLO fallback).
