"""The kinds of traffic mix: each mix file names one by its `kind`."""
