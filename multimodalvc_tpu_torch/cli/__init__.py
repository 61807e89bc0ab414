"""The command-line entry points: ``train``, ``eval`` and ``generate``."""
