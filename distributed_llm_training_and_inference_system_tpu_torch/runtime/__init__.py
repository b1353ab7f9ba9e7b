"""Training orchestration: the engine and its command-line entry point."""
