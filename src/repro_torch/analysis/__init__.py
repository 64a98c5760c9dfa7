"""Static checks of the port: the registry lint and sm_90's shared-memory
and register budget of every kernel launch (``python -m
repro_torch.analysis.check``)."""
