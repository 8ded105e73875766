"""Data substrate (port of ``repro.data``): the fleet traffic traces and
the offloading-gain predictor.

The synthetic datasets (``ClassifierPair``) and the LM tokens are not
ported yet (ROADMAP.md queue A item 12); ``predictor.calibrate`` takes
any pair with ``local_probs`` / ``cloud_probs``."""
