"""The port's command line, ``llmctl-torch`` (see main.py)."""
