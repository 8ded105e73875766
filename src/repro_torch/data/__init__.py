"""Data substrate (port of ``repro.data``): the fleet traffic traces, the
offloading-gain predictor, the synthetic classification datasets with
their trained classifier pairs, and the synthetic LM token stream."""
