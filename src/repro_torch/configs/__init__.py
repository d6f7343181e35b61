"""One config module per ported architecture (counterpart of
``repro.configs``): exact dimensions, source tags in each docstring."""
