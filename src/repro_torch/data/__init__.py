"""Data substrate (port of ``repro.data``): the fleet traffic traces.

The synthetic datasets, the gain predictor and the LM tokens are not
ported yet (ROADMAP.md queue A items 9 and 12)."""
