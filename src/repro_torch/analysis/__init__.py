"""Runtime checks of the serving path (``RAVEN_ANALYSIS_ASSERTS``)."""
