"""The port's entry points: ``run_net`` (CLI) and ``test_net``."""
